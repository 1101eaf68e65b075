#!/usr/bin/env python3
"""Card probe of the kernels of the streaming / fp64-polish slice:

* ``csrc/ladder_proj.cu``'s f64-polish instantiations (``l1_proj_kernel``
  and ``l1_lanes_kernel`` with kF64): ptxas' registers and spills, and
  each held against its plain version (``kernels/ref.py``,
  ``polish64=True``) at n = 10,000 and on (10,000, 16) lanes, timed beside
  the f32 instantiation;
* ``csrc/chol_update.cu`` (``chol_rank_update``): bit for bit against its
  plain version at (n, k) = (256, 16), update and downdate, then at the
  streams' shapes (2,048, 256) and (6,400, 800) against an f64 Cholesky of
  the updated matrix, timed with CUDA events.

    python3 tools/chol_polish_probe.py          # on a machine with a card

Prints one line a check and exits non-zero on a disagreement.
"""
from __future__ import annotations

import os
import re
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bisect_proj, build, chol_update, ref
    t0 = time.perf_counter()
    info = build.build_all(("ladder_proj", "chol_update"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    entry = None
    for name in ("ladder_proj", "chol_update"):
        for ln in info[name]["log"].splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif entry and ("Used" in ln or "spill" in ln) and re.search(
                    r"l1_proj_kernel|l1_lanes_kernel|chol_rank", entry):
                print(f"  {name}: {entry[:60]}: {ln.split(':', 1)[-1].strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for nn in (10_000, 4_000, 1_000):
        z0 = torch.randn(nn, device=dev, generator=g)
        tz = (0.5 * z0.abs().sum()).reshape(())
        got = bisect_proj.l1_epigraph_proj(z0, tz, stats=True, polish64=True)
        want = ref.l1_epigraph_proj_ref(z0, tz, stats=True, polish64=True)
        f32 = bisect_proj.l1_epigraph_proj(z0, tz, stats=True)
        err = float((got[0] - want[0]).abs().max())
        ok = torch.allclose(got[0], want[0], rtol=1e-6,
                            atol=1e-6 * float(z0.abs().max()))
        bad += not ok
        print(f"l1 polish64 n={nn}: theta {float(got[2])!r} plain "
              f"{float(want[2])!r} f32 {float(f32[2])!r}; steps {int(got[3])}"
              f" / {want[3]} (f32 {int(f32[3])}); max abs err {err:.3e} "
              f"{'ok' if ok else 'DISAGREES'}; "
              f"{ms(torch, lambda: bisect_proj.l1_epigraph_proj(z0, tz, polish64=True)):.4f} ms "
              f"vs f32 {ms(torch, lambda: bisect_proj.l1_epigraph_proj(z0, tz)):.4f} ms")
    zl = torch.randn(10_000, 16, device=dev, generator=g)
    tl = 0.5 * zl.abs().sum(1)
    got = bisect_proj.l1_epigraph_proj_lanes(zl, tl, polish64=True)
    want = ref.l1_epigraph_proj_lanes_ref(zl, tl, polish64=True)
    ok = torch.allclose(got[0], want[0], rtol=1e-6, atol=1e-6 * 5)
    bad += not ok
    print(f"l1 lanes polish64 (10000, 16): max abs err "
          f"{float((got[0] - want[0]).abs().max()):.3e} "
          f"{'ok' if ok else 'DISAGREES'}; "
          f"{ms(torch, lambda: bisect_proj.l1_epigraph_proj_lanes(zl, tl, polish64=True)):.4f}"
          f" ms vs f32 "
          f"{ms(torch, lambda: bisect_proj.l1_epigraph_proj_lanes(zl, tl)):.4f} ms")

    for n, k in ((256, 16), (64, 3), (40, 805)):
        A = torch.randn(n + 8, n, device=dev, generator=g)
        M = A.T @ A + torch.eye(n, device=dev)
        L = torch.linalg.cholesky(M)
        V = torch.randn(n, k, device=dev, generator=g) * 0.3
        for sign in (1.0, -1.0):
            L0 = L if sign > 0 else torch.linalg.cholesky(M + V @ V.T)
            got, gok = chol_update.chol_rank_update(L0, V, sign)
            want, wok = ref.chol_rank_update_ref(L0, V, sign)
            same = torch.equal(got, want) and bool(gok) == bool(wok)
            bad += not same
            print(f"chol n={n} k={k} sign={sign:+.0f}: bit equal {same}, "
                  f"ok {bool(gok)}/{bool(wok)}")
    for n, k in ((2_048, 256), (6_400, 800)):
        A = torch.randn(n + 8, n, device=dev, generator=g)
        M = (A.T @ A).double() + n * torch.eye(n, device=dev,
                                                dtype=torch.float64)
        L = torch.linalg.cholesky(M).float()
        V = torch.randn(n, k, device=dev, generator=g)
        got, gok = chol_update.chol_rank_update(L, V, 1.0)
        Vd = V.double()
        want = torch.linalg.cholesky(M + Vd @ Vd.T)
        rel = float((got.double() - want).norm() / want.norm())
        t = ms(torch, lambda: chol_update.chol_rank_update(L, V, 1.0), reps=3)
        bound = 2 * n * n * 4 / 3.35e12 * 1e3
        print(f"chol n={n} k={k}: rel err vs f64 cholesky {rel:.3e}, ok "
              f"{bool(gok)}; {t:.2f} ms (bytes bound {bound:.4f} ms)")
        bad += not (rel < 1e-4 and bool(gok))
    print("ok" if not bad else f"FAIL: {bad} checks")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
