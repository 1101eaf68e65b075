#!/usr/bin/env python3
"""Measurements of ``csrc/ladder_proj.cu`` on one NVIDIA GPU that
``chip_smoke.py`` does not make: bit identity against another version of
the kernel, a per-phase breakdown of one call, and the parity fits at each
cluster size.

    python3 tools/ladder_proj_probe.py --against OTHER.cu [--lanes]
    python3 tools/ladder_proj_probe.py --trace [SOURCE.cu ...] [--lanes]
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
The lane entry points (``l1_epigraph_proj_lanes_f32``, its f64-polish
twin, ``skappa_support_lanes_f32``) are held the same way: the fleet's
(10,000, 16) and (2,000, 64) with their layouts, then every width 1 to
256 at 32 threads a lane, some of them and 700 at 1,024 (the solo body),
and 1,000, 2,500 and 10,000 at their clusters of 4 and 8 CTAs a lane,
B = 37 rows with zeros, ties, NaN and inf. Then the lane calls are timed
in turns, widths 100 and 200 with OTHER.cu's lanes at 128 threads (its
layout there before the warp a lane), the cluster lanes at
(1,000, 10,000), and one fleet_sq fit (B = 10,000, 20 outer iterations,
``chip_smoke.fleet_window`` for its profiler window) with each build's
lane entry points in turns. ``--lanes`` skips the solo entry points. Each
build prints ptxas' registers and spills of its kernels.

``--trace`` builds each SOURCE.cu (by default this tree's) with
``-DLADDER_PROJ_TRACE``: thread 0 of CTA 0 then stamps ``clock64()`` at
each phase of a call (the source's ``Stamp`` codes). For both projections
at n = 1,000, 4,000, 10,000 and 12,000 (the plan's cluster size) it prints
the SM cycles spent reaching each kind of stamp, the median of 20 calls,
and the whole call's cycles beside the same call's device time by
CUDA-graph replay of the uninstrumented kernel. The lanes (``--lanes``
alone, or after the solo calls): fleet_sq's (10,000, 16), fleet_sq_wide's
(2,000, 64) and (10,000, 16) with the f64 polish, stamped by the thread
that starts lane 0 (a source without lane stamps, such as 95f5faf's, gets a
start and an end stamp around each lane of its lane kernels in its trace
build); the lane's cycles against the call's, read at the card's clock,
say how many lanes' time the call takes in a row (the waves).

``--parity`` runs ``chip_smoke.py``'s parity fits (``parity_fits``)
on the card with the projections forced to 1, 2, 4 and 8 CTAs in turn
(the registry's ``"cuda"`` rows with ``ctas`` bound), and prints their
iterations and status; ``chip_smoke.py`` holds the plan's run against the
CPU's.

Needs a card; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess
import sys
import time

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
          "output pass (z or s*)", "the last cluster barrier",
          # the narrow lane kernels (a warp a lane)
          "lane start",
          "wait for the lane's row (cp.async), __syncwarp",
          "own pass over the row before a reduction",
          "reduction: xor shuffles of the words read",
          "round: own rungs' pass",
          "round: the crossing vote (ballots)",
          "output pass (z or s*)", "lane end")
TRACE_N = (1_000, 4_000, 10_000, 12_000)
# (kind, B, d) of the lane trace and timing: fleet_sq, fleet_sq_wide, the
# fp64_polish_lanes phase
LANE_SHAPES = (("l1", 10_000, 16), ("skappa", 10_000, 16),
               ("l1", 2_000, 64), ("skappa", 2_000, 64),
               ("l1_f64", 10_000, 16))
# A source's one-CTA lane kernels (95f5faf's), given lane stamps in their
# trace build: a start before each lane and an end after it
LANE_STAMP_PATCH = (("    const size_t row = (size_t)b * n;\n",
                     "    stamp(kStart);\n"
                     "    const size_t row = (size_t)b * n;\n"),
                    ("smem4), sh);\n  }\n}", "smem4), sh);\n"
                     "    stamp(kEnd);\n  }\n}"))


def load_all(torch, specs) -> list:
    """Build every ``(src, name, trace)`` of ``specs`` with this tree's
    flags (``trace``: with -DLADDER_PROJ_TRACE), one nvcc each, all
    started together, and bind each (every entry point of
    ``bisect_proj``'s table it has); print their kernels' ptxas lines."""
    import chip_smoke
    from repro_torch.kernels import bisect_proj, build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, name, trace in specs:
        out = build.BUILD_DIR / f"probe_{name}.so"
        text = open(src).read()
        if trace and "lane_stamp" not in text:
            for old, new in LANE_STAMP_PATCH:
                text = text.replace(old, new)
        patched = build.BUILD_DIR / f"probe_{name}.cu"
        patched.write_text(text)
        flags = ["-DLADDER_PROJ_TRACE"] if trace else []
        procs.append((name, trace, out, subprocess.Popen(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", *build.SOURCE_FLAGS["ladder_proj"], *flags,
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
             str(patched)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, trace, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if not trace:
            for line in chip_smoke.ptxas_ladder_proj(log):
                print(f"  [{name}] {line}", flush=True)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in bisect_proj._PROJ_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if trace:
            lib.ladder_proj_trace.argtypes = [build.P, build.P, build.I]
        libs.append(lib)
    return libs


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


def lane_call(torch, lib, kind, z, per_lane, ctas, threads):
    """One lane launch of ``kind`` ("l1", "l1_f64" or "skappa") through a
    library's C entry point: every output (the step counts too)."""
    from repro_torch.kernels import build
    B, d = z.shape
    dev = z.device
    out = torch.empty_like(z)
    val = torch.empty(B, dtype=torch.float32, device=dev)
    k = torch.empty(B, dtype=torch.int32, device=dev)
    if kind == "skappa":
        rc = lib.skappa_support_lanes_f32(
            z.data_ptr(), per_lane.data_ptr(), out.data_ptr(),
            val.data_ptr(), k.data_ptr(), B, d, ctas, threads, 2, 64,
            build.stream(z))
        build.check(rc, "skappa lanes")
        return val, out, k
    th = torch.empty(B, dtype=torch.float32, device=dev)
    entry = (lib.l1_epigraph_proj_lanes_f32_polish64 if kind == "l1_f64"
             else lib.l1_epigraph_proj_lanes_f32)
    rc = entry(z.data_ptr(), per_lane.data_ptr(), out.data_ptr(),
               val.data_ptr(), th.data_ptr(), k.data_ptr(), B, d, ctas,
               threads, 2, 64, build.stream(z))
    build.check(rc, kind + " lanes")
    return out, val, th, k


def lane_data(torch, gen, B, d, special=False):
    """chip_smoke's lane operands: rows of scaled normals with zeros and a
    tie cluster, t0 (B,) from -0.3 to 0.7 of each row's l1 norm, kappa
    (B,) in 0 .. d + 1; ``special`` puts NaN, inf and -inf into some
    rows."""
    dev = gen.device
    z = (torch.randn(B, d, device=dev, generator=gen)
         * torch.rand(B, 1, device=dev, generator=gen))
    if d >= 8:
        z[::5, :3] = 0.0
        z[1::5, 2:6] = z[1::5, 2:3]
    t0 = (torch.rand(B, device=dev, generator=gen) - 0.3) * z.abs().sum(1)
    kap = torch.randint(0, d + 2, (B,), device=dev, generator=gen).float()
    if special and B >= 7:
        z[2, d // 2] = float("nan")
        z[3, 0] = float("inf")
        z[4, d - 1] = -float("inf")
        t0[5] = float("nan")
        t0[6] = float("inf")
    return z, t0, kap


def same_bits(torch, a, b) -> bool:
    """Equal, NaN for NaN (no payload compared)."""
    if a.dtype.is_floating_point:
        na, nb = a.isnan(), b.isnan()
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
    return torch.equal(a, b)


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


def lane_identity(torch, libs) -> tuple[int, int]:
    """(bit-identical, total) lane calls of ``libs``' two builds over the
    fleet shapes and the narrow widths (module docstring)."""
    from repro_torch.kernels import bisect_proj
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(B, d, *bisect_proj.lane_plan(d))
             for _, B, d in LANE_SHAPES[:4:2]]
    for d in range(1, bisect_proj.LANE_WARP_MAX_N + 1):
        cases.append((37, d, 1, 32))
        if d in (1, 16, 64, 200, 256):
            cases.append((37, d, 1, bisect_proj.THREADS))
    # the wide lanes: a 1,024-thread CTA, clusters of 4 and 8
    for d in (700, 1_000, 2_500, 10_000):
        cases.append((37, d, *bisect_proj.lane_plan(d)))
    same = total = 0
    for B, d, ctas, threads in cases:
        z, t0, kap = lane_data(torch, gen, B, d, special=B == 37)
        for kind, per in (("l1", t0), ("l1_f64", t0), ("skappa", kap)):
            outs = [lane_call(torch, lib, kind, z, per, ctas, threads)
                    for lib in libs.values()]
            ok = all(same_bits(torch, a, b) for out in outs[1:]
                     for a, b in zip(outs[0], out))
            total += 1
            same += ok
            if not ok:
                print(f"  lanes differ: {kind} B={B} d={d} ({ctas}, "
                      f"{threads})", flush=True)
    print(f"lane identity: {same} of {total} lane calls bit-identical",
          flush=True)
    return same, total


@contextlib.contextmanager
def lane_entries(lib):
    """``bisect_proj``'s lane wrappers on ``lib``'s entry points."""
    from repro_torch.kernels import bisect_proj, build
    real = build.library

    def pick(name, signatures):
        return lib if name == "ladder_proj" else real(name, signatures)

    bisect_proj.build.library = pick
    try:
        yield
    finally:
        bisect_proj.build.library = real


def lane_times(torch, libs) -> None:
    """The lane calls of both builds in turns, and fleet_sq with each
    build's lane entry points (module docstring)."""
    import chip_smoke
    from repro_torch.kernels import bisect_proj
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    order = (*libs, *reversed(libs))
    for kind, B, d in LANE_SHAPES:
        z, t0, kap = lane_data(torch, gen, B, d)
        per = kap if kind == "skappa" else t0
        lp = bisect_proj.lane_plan(d)
        times = [(name, graph_ms(torch, lambda: lane_call(
            torch, libs[name], kind, z, per, *lp))) for name in order]
        print(f"lanes {kind} ({B}, {d}) {tuple(lp)}: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times) + " ms", flush=True)
    # between d = 64 and 256 the other build's lanes were 128-thread CTAs
    for d in (100, 200):
        z, t0, kap = lane_data(torch, gen, 2_000, d)
        turns = [(name, 128 if name == "other" else 32) for name in order]
        for kind, per in (("l1", t0), ("skappa", kap)):
            times = [(f"{name}@{threads}", graph_ms(torch, lambda: lane_call(
                torch, libs[name], kind, z, per, 1, threads)))
                for name, threads in turns]
            print(f"lanes {kind} (2000, {d}) by threads a lane: " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in times) + " ms",
                flush=True)
    # the cluster lanes (8 CTAs a lane, as the path grid at n = 10,000
    # runs them), the solo body in both builds
    z, t0, kap = lane_data(torch, gen, 1_000, 10_000)
    lp = bisect_proj.lane_plan(10_000)
    for kind, per in (("l1", t0), ("skappa", kap)):
        times = [(name, graph_ms(torch, lambda: lane_call(
            torch, libs[name], kind, z, per, *lp))) for name in order]
        print(f"lanes {kind} (1000, 10000) {tuple(lp)}: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times) + " ms", flush=True)
    # fleet_sq, 20 outer iterations, with each build's lane entry points
    B, N, m, n = chip_smoke.FLEET_ROWS["fleet_sq"]
    As_np, bs_np = chip_smoke.fleet_data(B, N, m, n)
    As = torch.as_tensor(As_np, device=dev)
    bs = torch.as_tensor(bs_np, device=dev)
    from repro_torch import api
    problem = api.SparseProblem("squared", kappa=chip_smoke.FLEET_CFG["kappa"],
                                gamma=chip_smoke.FLEET_CFG["gamma"],
                                rho_c=chip_smoke.FLEET_CFG["rho_c"])
    opts = api.SolverOptions(device=dev, max_iter=20, tol=0.0)
    state = None
    for name in order:
        with lane_entries(libs[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.fit_many(problem, As, bs, options=opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trips = int(res.iters.max())
            state = res.state if state is None else state
            win = chip_smoke.fleet_window(torch, As, bs, state)
        print(f"fleet_sq ({B} lanes, {trips} outer iterations) on {name}'s "
              f"lanes: {wall:.3f} s, {wall / trips * 1e3:.2f} ms an outer "
              f"iteration; window of 2: {win['wall_ms']:.2f} ms (profiler "
              f"off), busy {win['busy_ms']:.2f} ms in {win['device_ops']} "
              f"ops, {win['host_syncs']} host syncs, idle share "
              f"{win['idle_share']:.3f}, lane kernels "
              f"{win['lane_ms']:.3f} ms ({win['lane_launches']} launches)",
              flush=True)


def against(torch, other: str, lanes_only: bool) -> int:
    """Bit identity and time of this tree's ``csrc/ladder_proj.cu`` against
    ``other`` (module docstring)."""
    from repro_torch.kernels import bisect_proj, build

    current = str(build.CSRC / "ladder_proj.cu")
    specs = {"other": (other, "other", False),
             "current": (current, "current", False)}
    libs = dict(zip(specs, load_all(torch, list(specs.values()))))
    same_l, total_l = lane_identity(torch, libs)
    same = total = 0
    if not lanes_only:
        l1, sk = calls(torch)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
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
                    outs = [l1(libs[k], z, t0, ctas)
                            for k in ("other", "current")]
                    total += 1
                    same += all(map(torch.equal, *outs))
                for kappa in (0.5, n / 5, n / 5 + 0.25, n - 1.0):
                    outs = [sk(libs[k], z, kappa, ctas)
                            for k in ("other", "current")]
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
                         for name in ("other", "current", "current",
                                      "other")]
                print(f"{kind} n={n} ({ctas} CTAs): " + ", ".join(
                    f"{name} {ms:.4f}" for name, ms in times) + " ms",
                    flush=True)
    lane_times(torch, libs)
    return 0 if same == total and same_l == total_l else 1


def stamps_of(lib, clocks, codes):
    """(cycles a kind of stamp, stamps a kind, whole) of the last call."""
    m = lib.ladder_proj_trace(clocks, codes, 4096)
    if m < 2:
        raise RuntimeError(f"trace: {m} stamps")
    cyc = [0] * len(STAMPS)
    cnt = [0] * len(STAMPS)
    for j in range(1, m):
        cyc[codes[j]] += clocks[j] - clocks[j - 1]
        cnt[codes[j]] += 1
    return cyc, cnt, clocks[m - 1] - clocks[0]


def print_trace(label, runs, ms, mhz=None):
    """The median cycles of each kind of stamp over ``runs``."""
    per_code = [r[0] for r in runs]
    whole = statistics.median(r[2] for r in runs)
    counts = runs[-1][1]
    med = [statistics.median(c[j] for c in per_code)
           for j in range(len(STAMPS))]
    waves = ""
    if mhz:
        waves = (f"; the call is {ms * 1e3 * mhz / whole:.2f} x the lane's "
                 f"cycles at {mhz:.0f} MHz")
    print(f"{label}: {whole:.0f} cycles from the first stamp to the last; "
          f"{ms * 1e3:.2f} us by graph replay (uninstrumented){waves}",
          flush=True)
    for j in sorted(range(1, len(STAMPS)), key=lambda j: -med[j]):
        if counts[j]:
            print(f"    {med[j]:8.0f} cycles in {counts[j]:3d} x "
                  f"{STAMPS[j]}", flush=True)


def trace(torch, sources: list[str], lanes_only: bool) -> int:
    """Per-phase SM cycles of one call (module docstring)."""
    from repro_torch.kernels import bisect_proj, build

    l1, sk = calls(torch)
    dev = torch.device("cuda")
    max_mhz = os.popen("nvidia-smi --query-gpu=clocks.max.sm "
                       "--format=csv,noheader,nounits").read().strip()
    print(f"max SM clock {max_mhz} MHz", flush=True)
    clocks = (ctypes.c_longlong * 4096)()
    codes = (ctypes.c_int * 4096)()
    sources = sources or [str(build.CSRC / "ladder_proj.cu")]
    built = load_all(torch, [spec for i, src in enumerate(sources)
                             for spec in ((src, f"trace{i}", True),
                                          (src, f"untraced{i}", False))])
    for i, src in enumerate(sources):
        lib, plain = built[2 * i], built[2 * i + 1]
        gen = torch.Generator(device=dev).manual_seed(0)
        base = os.path.basename(src)
        for n in () if lanes_only else TRACE_N:
            ctas = bisect_proj.plan(n).ctas
            z = torch.randn(n, device=dev, generator=gen)
            t0 = (0.5 * z.abs().sum()).reshape(())
            for kind, fn in (("l1", lambda lib: l1(lib, z, t0, ctas)),
                             ("skappa",
                              lambda lib: sk(lib, z, n / 5, ctas))):
                runs = []
                for _ in range(20):
                    fn(lib)
                    runs.append(stamps_of(lib, clocks, codes))
                print_trace(f"[{base}] {kind} n={n} ({ctas} CTAs)", runs,
                            graph_ms(torch, lambda: fn(plain)))
        for kind, B, d in LANE_SHAPES:
            z, t0, kap = lane_data(torch, gen, B, d)
            t0[0] = 0.5 * z[0].abs().sum()      # lane 0: rounds and polish
            kap[0] = d // 4                     # rounds and search
            per = kap if kind == "skappa" else t0
            lp = bisect_proj.lane_plan(d)
            runs = []
            for _ in range(20):
                lane_call(torch, lib, kind, z, per, *lp)
                runs.append(stamps_of(lib, clocks, codes))
            ms = graph_ms(torch, lambda: lane_call(torch, plain, kind, z,
                                                   per, *lp))
            mhz = float(os.popen(
                "nvidia-smi --query-gpu=clocks.sm --format=csv,noheader,"
                "nounits").read().strip() or 0) or float(max_mhz)
            print_trace(f"[{base}] lanes {kind} ({B}, {d}) {tuple(lp)}, "
                        "lane 0", runs, ms, float(max_mhz))
            print(f"    (SM clock read after the replays: {mhz:.0f} MHz)",
                  flush=True)
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
    parser.add_argument("--lanes", action="store_true",
                        help="the lane entry points only")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    if args.against:
        return against(torch, args.against, args.lanes)
    if args.trace is not None:
        return trace(torch, args.trace, args.lanes)
    return parity(torch)


if __name__ == "__main__":
    sys.exit(main())
