"""The grid the ``ladder_stats`` wrapper plans before its one launch.

``repro_torch.kernels.bisect_proj.stats_plan`` sizes the grid of
``csrc/ladder_stats.cu`` from n and the card's SM count alone (at most one
CTA an SM, each owning a contiguous slice of at least
``STATS_MIN_PER_CTA`` entries), so it is checked here on the CPU, with the
constants the wrapper mirrors from the source. CPU tensors take the plain
version, held against the JAX package's ladder kernel in
``tests/test_torch_kernels.py``.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import bisect_proj, build, ops, ref

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/csrc/ladder_stats.cu")
H100_SMS = 132


def test_max_rungs_mirrors_the_source():
    m = re.search(r"constexpr int kMaxRungs = (\d+);", SOURCE.read_text())
    assert int(m.group(1)) == bisect_proj.MAX_RUNGS


@pytest.mark.parametrize("n,ctas,per_cta", [
    (0, 1, 0),                         # one CTA of nothing: zeros
    (1, 1, 1),
    (512, 1, 512),
    (1_023, 1, 1_023),
    (1_024, 2, 512),
    (10_000, 19, 527),                 # the solver's Woodbury width
    (bisect_proj.MAX_N + 1, H100_SMS, 3_104),   # the composed path
    (1_100_003, H100_SMS, 8_334),      # two staged pieces a CTA
])
def test_stats_plan_at_the_path_shapes(n, ctas, per_cta):
    assert bisect_proj.stats_plan(n, H100_SMS) == (ctas, per_cta)


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("n", [0, 1, 5, 2_047, 4_097, 100_000, 409_601,
                               270_337, 10 ** 7 + 3])
def test_stats_plan_covers_n_once_with_no_empty_cta(n, sms):
    """The slices tile [0, n): every CTA but the last is full, the last
    holds at least one entry (n > 0), no CTA more than one an SM, and none
    below STATS_MIN_PER_CTA entries unless n is that small."""
    ctas, per_cta = bisect_proj.stats_plan(n, sms)
    assert 1 <= ctas <= sms
    if n == 0:
        assert per_cta == 0
        return
    assert (ctas - 1) * per_cta < n <= ctas * per_cta
    assert per_cta >= min(n, bisect_proj.STATS_MIN_PER_CTA) or ctas == 1


def test_stats_plan_refuses():
    with pytest.raises(ValueError):
        bisect_proj.stats_plan(-1, H100_SMS)
    with pytest.raises(ValueError):
        bisect_proj.stats_plan(10, 0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    az = torch.rand(5_000, generator=torch.Generator().manual_seed(0))
    th = torch.linspace(0.0, 1.0, 128)
    ops.reset_launch_counts()
    got = bisect_proj.ladder_stats(az, th)
    assert ops.launch_counts()["ladder_stats"] == 0
    assert not build.LAUNCHES["ladder_stats"]
    assert torch.equal(got, ref.ladder_stats_ref(az, th))
