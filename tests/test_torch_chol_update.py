"""``csrc/chol_update.cu``'s schedule, checked on the CPU.

The kernel cannot run here, so its design is held to the plain version
through a host model of it: :func:`wavefront` runs the same tiles (a
block of ``PANEL`` rows by a panel of ``PANEL`` columns), the same skewed
(column, rotation) wavefront, the same shared-memory rings of ``RING``
rotations staged ``CHUNK`` at a time, the same progress counts published
and waited on, and the same ticket order, with several CTAs interleaved at
random at every step. Every buffer the kernel leaves uninitialised starts
as NaN here, so a read of a rotation before it is published, or of a ring
slot after it was overwritten, shows in the result. The model must equal
``ref.chol_rank_update_ref`` bit for bit, ``ok`` included: numpy's f32
operations round each as the card does, and the plain version runs with
a correctly rounded ``torch.sqrt`` (:func:`plain`), as on the card (a CPU
build of torch may round its f32 square root otherwise, by an ulp). Also:
the constants mirror the source, the scratch sizes, and the CPU path
against the JAX package's ``chol_update`` / ``chol_downdate`` (rtol / atol
1e-5, as tests/test_torch_stream.py holds them).
"""
import re
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.stream import chol_downdate as jchol_downdate
from repro.stream import chol_update as jchol_update
from repro_torch.kernels import build, chol_update, ref

PANEL, CHUNK, RING = chol_update.PANEL, chol_update.CHUNK, chol_update.RING
F32 = np.float32
TINY = np.finfo(F32).tiny
_SQRT = torch.sqrt


def _nan_max(a, b):
    return np.where((a > b) | (a != a), a, b)


def wavefront(L, V, sign, ctas, seed):
    """(L', ok) through the kernel's schedule on the host: ``ctas`` CTAs
    take tiles from one ticket and run interleaved at random, one step at
    a time; a CTA waiting on a progress count does not run."""
    n, k = V.shape
    nb = -(-n // PANEL)
    npad = nb * PANEL
    Lp = np.zeros((npad, npad), F32)
    Lp[:n, :n] = L
    Vp = np.full((npad, k), np.nan, F32)
    Vp[:n] = V
    W = np.full((npad, k), np.nan, F32)
    cs = np.full((nb, k + PANEL - 1, PANEL, 2), np.nan, F32)  # by p + c
    prog = np.zeros((nb, nb), np.int64)
    tiles = [(P, Q) for P in range(nb) for Q in range(P, nb)]
    state = {"ticket": 0, "ok": True}
    sgn = F32(sign)
    r = np.arange(PANEL)[:, None]
    c = np.arange(PANEL)[None, :]

    def shifted(vo):          # __shfl_up_sync(vo, 1): lane c gets c - 1's
        return np.concatenate([vo[:, :1], vo[:, :-1]], axis=1)

    def tile(P, Q, csr, wr):
        diag = P == Q
        skew = 2 * (PANEL - 1) if diag else PANEL - 1
        i0, j0 = Q * PANEL, P * PANEL
        live = (i0 + r < n) & ((c <= r) if diag else True)
        lv = np.where(live, Lp[i0:i0 + PANEL, j0:j0 + PANEL], F32(0))
        vo = np.zeros((PANEL, PANEL), F32)
        src = Vp if P == 0 else W
        for s in range(k + skew):
            if s % CHUNK == 0:
                hi = min(s + CHUNK, k)
                # rotations finished by every row, or the diagonal's steps
                done = s if diag else min(max(s - skew, 0), k)
                if done > 0:
                    prog[Q, P] = done
                if P > 0 and s < k:
                    yield lambda: prog[Q, P - 1] >= hi
                if not diag:
                    yield lambda: prog[P, P] >= min(s + CHUNK + PANEL - 1,
                                                    k + 2 * (PANEL - 1))
                for p in range(s, hi):
                    wr[:, p % RING] = src[i0:i0 + PANEL, p]
                if not diag:
                    for q in range(s, min(s + CHUNK, k + PANEL - 1)):
                        csr[q % RING] = cs[P, q]
            p = s - c - (r if diag else 0) + np.zeros_like(r)
            act = (p >= 0) & (p < k) & live
            slot = p % RING
            vin = shifted(vo)
            first = act & (c == 0)
            vin[first] = wr[np.broadcast_to(r, p.shape)[first], slot[first]]
            if diag:          # the diagonal lanes write their c, s first
                dm = act & (c == r)
                ljj, v = lv[dm], vin[dm]
                r2 = ljj * ljj + (sgn * v) * v
                state["ok"] &= bool(np.all((r2 > 0) & (ljj > 0)))
                rt = np.sqrt(_nan_max(r2, TINY))
                den = _nan_max(ljj, TINY)
                pair = np.stack([rt / den, v / den], axis=-1)
                cols = np.broadcast_to(c, p.shape)[dm]
                csr[slot[dm], cols] = pair
                cs[P, p[dm] + cols, cols] = pair
                lv[dm] = rt
                act = act & (c != r)
            cols = np.broadcast_to(c, p.shape)[act]
            # the diagonal's own ring by rotation, the others' by step
            pair = csr[slot[act] if diag else s % RING, cols]
            cx, sy = pair[:, 0], pair[:, 1]
            v = vin[act]
            lnew = (lv[act] + (sgn * sy) * v) / cx
            vo[act] = cx * v - sy * lnew
            lv[act] = lnew
            if not diag:
                last = act[:, -1]
                W[i0 + np.flatnonzero(last), p[last, -1]] = vo[last, -1]
            yield None
        prog[Q, P] = k + skew if diag else k
        Lp[i0:i0 + PANEL, j0:j0 + PANEL] = np.where(
            live, lv, Lp[i0:i0 + PANEL, j0:j0 + PANEL])

    def cta():
        csr = np.full((RING, PANEL, 2), np.nan, F32)
        wr = np.full((PANEL, RING), np.nan, F32)
        while state["ticket"] < len(tiles):
            P, Q = tiles[state["ticket"]]
            state["ticket"] += 1
            yield from tile(P, Q, csr, wr)

    rng = np.random.default_rng(seed)
    running = [[cta(), None] for _ in range(ctas)]
    with np.errstate(all="ignore"):
        while running:
            ready = [e for e in running if e[1] is None or e[1]()]
            assert ready, "every CTA waits: the schedule deadlocked"
            e = ready[rng.integers(len(ready))]
            for _ in range(int(rng.integers(1, 40))):
                try:
                    e[1] = next(e[0])
                except StopIteration:
                    running.remove(e)
                    break
                if e[1] is not None and not e[1]():
                    break
    return Lp[:n, :n], state["ok"]


def _sqrt_rn(x):
    """The correctly rounded f32 square root (the f64 root of an f32 is
    exact enough that rounding it once more to f32 is the f32 root)."""
    return _SQRT(x.double()).to(x.dtype)


def plain(L, V, sign):
    """``ref.chol_rank_update_ref`` on numpy inputs, its square roots
    correctly rounded, as the card's are: (L', ok) in numpy."""
    with mock.patch.object(torch, "sqrt", _sqrt_rn):
        out, ok = ref.chol_rank_update_ref(torch.as_tensor(L),
                                           torch.as_tensor(V), sign)
    return out.numpy(), bool(ok)


def _factor(rng, n):
    a = rng.standard_normal((n + 8, n)).astype(F32)
    return np.linalg.cholesky(a.T @ a / n + np.eye(n, dtype=F32)).astype(F32)


def test_constants_mirror_the_cuda_source():
    src = (build.CSRC / "chol_update.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kB"]), int(consts["kRowWarps"]),
            int(consts["kChunk"]), int(consts["kRing"]),
            int(consts["kMaxK"])) == (
        chol_update.PANEL, chol_update.ROW_WARPS, chol_update.CHUNK,
        chol_update.RING, chol_update.MAX_K)
    assert "-fmad=false" in build.SOURCE_FLAGS["chol_update"]
    # the rings' sizes (the static_asserts of the source)
    assert RING >= CHUNK + PANEL - 1 and RING > PANEL - 1


@pytest.mark.parametrize("n,k,sizes", [
    (1, 1, (1, 32 * 64, 2)),
    (256, 16, (4_096, 8 * 47 * 64, 65)),
    (2_048, 256, (2_048 * 256, 64 * 287 * 64, 4_097)),
    (6_400, 800, (6_400 * 800, 200 * 831 * 64, 40_001)),
    (40, 1_100, (40 * 1_024, 2 * 1_055 * 64, 5)),   # two launches' worth
])
def test_scratch_sizes(n, k, sizes):
    assert chol_update.scratch_sizes(n, k) == sizes


# n below one panel, one past it, ragged n and k (not multiples of PANEL or
# CHUNK), k across several chunks and more than the ring, a full tile grid
@pytest.mark.parametrize("n,k", [(1, 1), (7, 5), (33, 20), (70, 45),
                                 (64, 3), (97, 81)])
@pytest.mark.parametrize("ctas", [1, 3, 8])
def test_wavefront_is_the_plain_version_bit_for_bit(n, k, ctas):
    rng = np.random.default_rng(n * 1_000 + k)
    L = _factor(rng, n)
    V = (0.3 * rng.standard_normal((n, k))).astype(F32)
    up_ref, ok_ref = plain(L, V, 1.0)
    up, ok = wavefront(L, V, 1.0, ctas, seed=ctas)
    assert ok and ok_ref
    np.testing.assert_array_equal(up, up_ref)
    down_ref, ok_ref = plain(up_ref, V, -1.0)
    down, ok = wavefront(up, V, -1.0, ctas, seed=ctas + 1)
    assert ok == ok_ref
    np.testing.assert_array_equal(down, down_ref)


@pytest.mark.parametrize("n", [5, 40])
def test_wavefront_flags_lost_definiteness_as_the_plain_version(n):
    """Twice the first column downdated: the first pivot goes negative, and
    ``ok`` says so in the model as in the plain version."""
    rng = np.random.default_rng(n)
    L = _factor(rng, n)
    bad = (2 * L[:, :1]).astype(F32)
    _, ok = wavefront(L, bad, -1.0, 3, seed=0)
    _, ok_ref = plain(L, bad, -1.0)
    assert not ok and not ok_ref


def test_cpu_path_matches_jax_across_panels():
    """On the CPU the wrapper is the plain version: at a shape of two
    panels, update and downdate within 1e-5 of the JAX package's."""
    rng = np.random.default_rng(5)
    n, k = 40, 6
    L = _factor(rng, n)
    V = (0.3 * rng.standard_normal((n, k))).astype(F32)
    up, ok = chol_update.chol_rank_update(torch.as_tensor(L),
                                          torch.as_tensor(V), 1.0)
    assert bool(ok)
    jup = np.asarray(jchol_update(jnp.asarray(L), jnp.asarray(V)))
    np.testing.assert_allclose(up.numpy(), jup, rtol=1e-5, atol=1e-5)
    down, ok = chol_update.chol_rank_update(up, torch.as_tensor(V), -1.0)
    jdown, jok = jchol_downdate(jnp.asarray(jup), jnp.asarray(V))
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(down.numpy(), np.asarray(jdown), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_refusals():
    L = torch.eye(3)
    with pytest.raises(ValueError):
        chol_update.chol_rank_update(L, torch.ones(3), 0.5)
    with pytest.raises(ValueError):
        chol_update.chol_rank_update(L.to("meta"),
                                     torch.ones(3, device="meta"), 1.0)
