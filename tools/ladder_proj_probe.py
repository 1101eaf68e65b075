#!/usr/bin/env python3
"""Measurements of ``csrc/ladder_proj.cu`` on one NVIDIA GPU that
``chip_smoke.py`` does not make: bit identity against another version of
the kernel, a per-phase breakdown of one call, and the parity fits at each
cluster size.

    python3 tools/ladder_proj_probe.py --against OTHER.cu
    python3 tools/ladder_proj_probe.py --trace [SOURCE.cu ...]
    python3 tools/ladder_proj_probe.py --parity

``--against`` builds OTHER.cu with this tree's flags, checks that both
versions' entry points give bit-identical outputs (z, t, theta and the
step count; u_max, s* and the step count) over a grid of inputs — widths
1 to 409,600 at the plan's cluster size, five scales, tie-heavy vectors,
five t0 and four kappa a vector — and times both in turns (other,
current, current, other) by CUDA-graph replay. The parity fits' stopping
iterations follow every rounding of the projections, so a redesign that
is meant to keep them shows bit identity here first
(``git show <commit>:src/repro_torch/csrc/ladder_proj.cu > build/old.cu``).

``--trace`` builds each SOURCE.cu (by default this tree's) with
``-DLADDER_PROJ_TRACE``: thread 0 of CTA 0 then stamps ``clock64()`` at
each phase of a call (the source's ``Stamp`` codes). For both projections
at n = 1,000, 4,000, 10,000 and 12,000 (the plan's cluster size) it prints
the SM cycles spent reaching each kind of stamp, the median of 20 calls,
and the whole call's cycles beside the same call's device time by
CUDA-graph replay of the uninstrumented kernel.

``--parity`` runs ``chip_smoke.py``'s parity fits (``parity_fits``)
on the card with the projections forced to 1, 2, 4 and 8 CTAs in turn
(the registry's ``"cuda"`` rows with ``ctas`` bound), and prints their
iterations and status; ``chip_smoke.py`` holds the plan's run against the
CPU's.

Needs a card; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# csrc/ladder_proj.cu's Stamp codes, in order: each names what the thread
# did since the stamp before it
STAMPS = ("start", "load the CTA's slice of z into shared memory",
          "own pass over the slice before a reduction",
          "reduction: warp shuffles, the CTA's warps (__syncthreads)",
          "reduction: warp 0's sum, the cluster barrier",
          "reduction: read the CTAs' partials (DSMEM)",
          "before a round",
          "round: form the rungs (two __syncthreads)",
          "round: own share of the rung pass",
          "round: the eight groups' sums (__syncthreads)",
          "round: the cluster barrier",
          "round: the CTAs' rung sums, the crossing vote (__syncthreads)",
          "output pass (z or s*)", "the last cluster barrier")
TRACE_N = (1_000, 4_000, 10_000, 12_000)


def load(torch, src: str, name: str, *defines: str):
    """Build ``src`` with this tree's flags (and ``defines``) and bind it."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / f"probe_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", *build.SOURCE_FLAGS["ladder_proj"], *defines,
                    "-Xcompiler", "-fPIC", "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, F = build.P, build.I, build.F
    lib.l1_epigraph_proj_f32.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    lib.skappa_support_f32.argtypes = [P, F, P, P, P, I, I, I, I, P]
    if defines:
        lib.ladder_proj_trace.argtypes = [P, P, I]
    return lib


def calls(torch):
    """l1(lib, z, t0, ctas) and sk(lib, z, kappa, ctas) through a library's
    C entry points, every output (the step counts too) returned."""
    from repro_torch.kernels import build

    def empty(dev, *like):
        return tuple(torch.empty((), dtype=d, device=dev) for d in like)

    def l1(lib, z, t0, ctas):
        zo = torch.empty_like(z)
        t, th, k = empty(z.device, torch.float32, torch.float32, torch.int32)
        build.check(lib.l1_epigraph_proj_f32(
            z.data_ptr(), t0.data_ptr(), zo.data_ptr(), t.data_ptr(),
            th.data_ptr(), k.data_ptr(), z.shape[0], ctas, 2, 64,
            build.stream(z)), "l1")
        return zo, t, th, k

    def sk(lib, z, kappa, ctas):
        s = torch.empty_like(z)
        u, k = empty(z.device, torch.float32, torch.int32)
        build.check(lib.skappa_support_f32(
            z.data_ptr(), kappa, s.data_ptr(), u.data_ptr(), k.data_ptr(),
            z.shape[0], ctas, 2, 64, build.stream(z)), "skappa")
        return u, s, k

    return l1, sk


def graph_ms(torch, fn, reps=20, inner=10):
    """Median device ms of one ``fn()`` by CUDA-graph replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / inner


def against(torch, other: str) -> int:
    """Bit identity and time of this tree's ``csrc/ladder_proj.cu`` against
    ``other`` (module docstring)."""
    from repro_torch.kernels import bisect_proj, build

    libs = {"other": load(torch, other, "other"),
            "current": load(torch, str(build.CSRC / "ladder_proj.cu"),
                            "current")}
    l1, sk = calls(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    same = total = 0
    for n in (1, 7, 250, 1_000, 2_500, 4_000, 10_000, 12_000, 100_000,
              bisect_proj.MAX_N):
        ctas = bisect_proj.plan(n).ctas
        for rep in range(20):
            z = torch.randn(n, device=dev, generator=gen) * 10.0 ** (
                rep % 5 - 2)
            if rep % 4 == 3:
                z = torch.round(z * 4) / 4                  # ties
            for frac in (0.0, 0.05, 0.3, 0.7, 1.2):
                t0 = (frac * z.abs().sum()).reshape(())
                outs = [l1(libs[k], z, t0, ctas) for k in libs]
                total += 1
                same += all(map(torch.equal, *outs))
            for kappa in (0.5, n / 5, n / 5 + 0.25, n - 1.0):
                outs = [sk(libs[k], z, kappa, ctas) for k in libs]
                total += 1
                same += all(map(torch.equal, *outs))
    print(f"identity: {same} of {total} calls bit-identical", flush=True)
    for n in (4_000, 10_000, 12_000):
        ctas = bisect_proj.plan(n).ctas
        z = torch.randn(n, device=dev, generator=gen)
        t0 = (0.5 * z.abs().sum()).reshape(())
        for kind, fn in (("l1", lambda lib: l1(lib, z, t0, ctas)),
                         ("skappa", lambda lib: sk(lib, z, n / 5, ctas))):
            times = [(name, graph_ms(torch, lambda: fn(libs[name])))
                     for name in ("other", "current", "current", "other")]
            print(f"{kind} n={n} ({ctas} CTAs): " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in times) + " ms",
                flush=True)
    return 0 if same == total else 1


def trace(torch, sources: list[str]) -> int:
    """Per-phase SM cycles of one call (module docstring)."""
    from repro_torch.kernels import bisect_proj, build

    l1, sk = calls(torch)
    dev = torch.device("cuda")
    max_mhz = os.popen("nvidia-smi --query-gpu=clocks.max.sm "
                       "--format=csv,noheader,nounits").read().strip()
    print(f"max SM clock {max_mhz} MHz", flush=True)
    clocks = (ctypes.c_longlong * 4096)()
    codes = (ctypes.c_int * 4096)()
    for i, src in enumerate(sources or [str(build.CSRC / "ladder_proj.cu")]):
        lib = load(torch, src, f"trace{i}", "-DLADDER_PROJ_TRACE")
        plain = load(torch, src, f"untraced{i}")
        gen = torch.Generator(device=dev).manual_seed(0)
        for n in TRACE_N:
            ctas = bisect_proj.plan(n).ctas
            z = torch.randn(n, device=dev, generator=gen)
            t0 = (0.5 * z.abs().sum()).reshape(())
            for kind, fn in (("l1", lambda lib: l1(lib, z, t0, ctas)),
                             ("skappa",
                              lambda lib: sk(lib, z, n / 5, ctas))):
                per_code, whole, counts = [], [], None
                for _ in range(20):
                    fn(lib)
                    m = lib.ladder_proj_trace(clocks, codes, 4096)
                    if m < 2:
                        raise RuntimeError(f"trace: {m} stamps")
                    cyc = [0] * len(STAMPS)
                    cnt = [0] * len(STAMPS)
                    for j in range(1, m):
                        cyc[codes[j]] += clocks[j] - clocks[j - 1]
                        cnt[codes[j]] += 1
                    per_code.append(cyc)
                    whole.append(clocks[m - 1] - clocks[0])
                    counts = cnt
                med = [statistics.median(c[j] for c in per_code)
                       for j in range(len(STAMPS))]
                ms = graph_ms(torch, lambda: fn(plain))
                print(f"[{os.path.basename(src)}] {kind} n={n} ({ctas} "
                      f"CTAs): {statistics.median(whole):.0f} cycles from "
                      f"the first stamp to the last; {ms * 1e3:.2f} us by "
                      "graph replay (uninstrumented)", flush=True)
                for j in sorted(range(1, len(STAMPS)), key=lambda j: -med[j]):
                    if counts[j]:
                        print(f"    {med[j]:8.0f} cycles in {counts[j]:3d} x "
                              f"{STAMPS[j]}", flush=True)
    return 0


def parity(torch) -> int:
    """The parity fits' iterations at each cluster size (module
    docstring)."""
    import functools

    import chip_smoke
    from repro_torch import runtime
    from repro_torch.core.results import SolveStatus
    from repro_torch.kernels import bisect_proj

    rows = runtime.kernel_table()
    try:
        for ctas in (1, 2, 4, 8):
            for name in ("l1_epigraph_proj", "skappa_support"):
                runtime.register_kernel(name, "cuda", functools.partial(
                    getattr(bisect_proj, name), ctas=ctas))
            out = []
            for key, _, cls, kw, As, bs in chip_smoke.parity_fits():
                res = cls(**kw).fit(As, bs).result_
                out.append(f"{key} {int(res.iters)} "
                           f"{SolveStatus(int(res.status)).name}")
            print(f"parity at {ctas} CTAs: " + ", ".join(out), flush=True)
    finally:
        for name in ("l1_epigraph_proj", "skappa_support"):
            runtime.register_kernel(name, "cuda", rows[name]["cuda"])
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--against", metavar="OTHER.cu")
    mode.add_argument("--trace", nargs="*", metavar="SOURCE.cu")
    mode.add_argument("--parity", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    if args.against:
        return against(torch, args.against)
    if args.trace is not None:
        return trace(torch, args.trace)
    return parity(torch)


if __name__ == "__main__":
    sys.exit(main())
