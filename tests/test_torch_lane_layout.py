"""The narrow lane layout of ``csrc/ladder_proj.cu`` (a warp a lane) on
the CPU: pure-Python mirrors of the kernel's row buffers (``lane_stride``),
its persistent grid (``lane_grid``) and its lane-to-(CTA, warp)
assignment (``lane_order``), held to the source's constants and text. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k lane``).
"""
import re
from collections import Counter

import pytest

from repro_torch.kernels import bisect_proj

SOURCE = bisect_proj.build.CSRC / "ladder_proj.cu"
SMS = 132         # an H100 SXM's SMs; the grid is a pure function of them

# Mirrors of the narrow layout's constants: warps (lanes) a CTA and the
# CTAs an SM it is compiled for
LANE_CTA_WARPS = 8          # kLaneCtaWarps
LANE_MIN_CTAS = 4           # kLaneMinCtas
DEFAULT_SMEM = 48 * 1024    # dynamic shared memory a CTA gets unasked


def lane_stride(d: int) -> int:
    """Floats a row buffer of a narrow lane launch (``launch_narrow``): d
    rounded up to a float4."""
    return -(-d // 4) * 4


def lane_grid(B: int, sms: int, per_sm: int) -> int:
    """The CTAs of a narrow lane launch (``launch_narrow``): as many as the
    card holds at once (``per_sm`` CTAs an SM, the occupancy calculator's,
    on ``sms`` SMs), no more than the B lanes need."""
    return min(-(-B // LANE_CTA_WARPS), sms * per_sm)


def lane_order(B: int, ctas: int, warps: int) -> dict:
    """{(CTA, warp): [lanes]}: the lanes each warp of a narrow lane launch
    of ``ctas`` CTAs of ``warps`` warps takes, in order
    (``for_each_lane``: lane warp * ctas + cta first, then every ctas *
    warps further)."""
    order = {}
    for cta in range(ctas):
        for warp in range(warps):
            order[cta, warp] = list(range(warp * ctas + cta, B,
                                          ctas * warps))
    return order


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9 *]+);", SOURCE.read_text())
    assert m, name
    value = 1
    for factor in m.group(1).split("*"):
        value *= int(factor)
    return value


@pytest.mark.parametrize("name,value", [
    ("kLaneCtaWarps", LANE_CTA_WARPS),
    ("kLaneWarpMaxN", bisect_proj.LANE_WARP_MAX_N),
    ("kLaneMinCtas", LANE_MIN_CTAS)])
def test_lane_constants_mirror_the_source(name, value):
    assert _constant(name) == value


def test_the_source_takes_lanes_as_the_mirror_does():
    """for_each_lane's numbering and launch_narrow's grid, as lane_order
    and lane_grid read them."""
    src = SOURCE.read_text()
    assert "int b = warp * gridDim.x + blockIdx.x;" in src
    assert "const int total = gridDim.x * (blockDim.x >> 5);" in src
    assert ("const int need = (lanes + kLaneCtaWarps - 1) / kLaneCtaWarps;"
            in src)
    assert "const int full = seen[slot].per_sm * seen[slot].sms;" in src
    assert "need < full ? need : full" in src
    # two float4-rounded row buffers a warp, kLaneCtaWarps warps a CTA
    assert "const int stride = (n + 3) & ~3;" in src
    assert ("const int smem = kLaneCtaWarps * 2 * stride * (int)sizeof(float);"
            in src)
    assert "(size_t)warp * 2 * stride;" in src
    assert ("__launch_bounds__(kLaneCtaWarps * 32, kLaneMinCtas)"
            in src)
    # a warp a lane only up to kLaneWarpMaxN
    assert "threads == 32 && n <= kLaneWarpMaxN" in src
    # the rungs are ladder_round's in both layouts
    assert src.count("lo + (hi - lo) * (float)(b + 1) / (float)kRungs") == 2


@pytest.mark.parametrize("d,want", [
    (1, 4), (3, 4), (4, 4), (16, 16), (31, 32), (33, 36), (64, 64),
    (65, 68), (200, 200), (255, 256), (bisect_proj.LANE_WARP_MAX_N, 256)])
def test_lane_cta_follows_the_width(d, want):
    assert lane_stride(d) == want
    assert lane_stride(d) % 4 == 0 and lane_stride(d) >= d
    # the CTA's double-buffered rows fit the shared memory a CTA gets
    # without raising its limit (launch_narrow raises none)
    assert LANE_CTA_WARPS * 2 * lane_stride(d) * 4 <= DEFAULT_SMEM


@pytest.mark.parametrize("B", [1, 7, 31, 4_224, 10_000, 70_000])
@pytest.mark.parametrize("sms", [1, 114, SMS])
@pytest.mark.parametrize("per_sm", [1, LANE_MIN_CTAS, 8])
def test_every_lane_is_taken_once(B, sms, per_sm):
    """Every lane by exactly one warp, the warps' counts within one of
    each other, and no CTA without a lane."""
    ctas = lane_grid(B, sms, per_sm)
    order = lane_order(B, ctas, LANE_CTA_WARPS)
    seen = Counter(b for lanes in order.values() for b in lanes)
    assert sorted(seen) == list(range(B)) and set(seen.values()) == {1}
    sizes = [len(lanes) for lanes in order.values()]
    assert max(sizes) - min(sizes) <= 1
    assert all(order[cta, 0] for cta in range(ctas))


@pytest.mark.parametrize("B,per_sm,want", [
    # fleet_sq: every slot of the card (4 CTAs an SM at 64 registers)
    (10_000, LANE_MIN_CTAS, 528),
    (2_000, 4, 250),            # fleet_sq_wide: the lanes' CTAs
    (70_000, 6, 792), (7, 8, 1), (1, 8, 1), (1_000, 4, 125)])
def test_lane_grid_fills_the_card_and_no_more(B, per_sm, want):
    assert lane_grid(B, SMS, per_sm) == want


def test_lane_order_spreads_a_second_pass_over_every_cta():
    """Warp-major numbering: past one lane a warp, the next lanes go to
    the next warp of every CTA, not to the first CTAs."""
    order = lane_order(10_000, 528, 8)
    per_cta = Counter()
    for (cta, _), lanes in order.items():
        per_cta[cta] += len(lanes)
    assert set(per_cta.values()) == {18, 19}
    assert order[0, 0] == [0, 4_224, 8_448]
    assert order[0, 1] == [528, 4_752, 8_976]
