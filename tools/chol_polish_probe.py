#!/usr/bin/env python3
"""Card probe of the kernels of the streaming / fp64-polish slice:

* ``csrc/ladder_proj.cu``'s f64-polish instantiations (``l1_proj_kernel``
  and ``l1_lanes_kernel`` with kF64): ptxas' registers and spills, and
  each held against its plain version (``kernels/ref.py``,
  ``polish64=True``) at n = 10,000 and on (10,000, 16) lanes, timed beside
  the f32 instantiation (``--polish``);
* ``csrc/chol_update.cu`` (``chol_rank_update``): ptxas' report; bit for
  bit against its plain version (on the card) at small shapes, update and
  downdate; then a sweep of (n, k) over the streams' shapes (the dense
  absorb and evict at n = 2,048, the Woodbury evictions up to the largest
  window of 8,191 rows), each against an f64 Cholesky of the updated
  matrix and timed (CUDA-graph replays, ``chip_smoke.graph_ms``), beside
  one ``cholesky_ex`` of the updated matrix (``--chol``);
* ``--trace``: the kernel built with ``-DCHOL_UPDATE_TRACE`` records each
  tile's start, end, wait and SM; printed per shape: the diagonal tiles'
  and the others' busy time, wait and ns a step, how many tiles run at
  once, how far each panel's diagonal starts after the last one's (the
  pipeline's lag), and the traffic the tiles move through L2 — what bounds
  the kernel;
* ``--div-check``: the kernel's division (``div_by`` with the hoisted
  reciprocal, ``csrc/chol_update.cu``) against ``x / c`` on the card, bit
  for bit, on 2^32 pairs whose exponents span its fast range (|x| and c
  in [2^-60, 2^60)), and ``in_range`` at the range's edges;
* ``--variants``: copies of ``chol_update.cu`` with one change each
  (``VARIANTS``: the chunk, the CTAs an SM, the division as one multiply
  to time its share), built side by side, held bit for bit to the current
  kernel where the change keeps the bits, and timed in turns with it;
* ``--sass PATH``: the current library's SASS (``cuobjdump -sass``);
* ``--against OLD.cu``: an earlier ``chol_update.cu`` (PR 22's entry
  ``chol_rank_update_f32(L, V, n, k, ldv, sign, cs, ok, stream)``, at most
  800 rotations a launch), bit for bit against the current kernel at every
  shape of the sweep (both are the plain version's bits) and timed in
  turns with it (earlier, current, current, earlier)::

    git show ca22bf0:src/repro_torch/csrc/chol_update.cu > build/old_chol.cu
    python3 tools/chol_polish_probe.py --chol --div-check --trace \\
        --variants --against build/old_chol.cu [--report PATH]

With no option it runs ``--polish --chol``. Prints one line a check and
exits non-zero on a disagreement. Needs a card and ``nvcc``; it imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# (n, k): the bit checks' shapes (the plain version runs on the card, ~20
# launches a (vector, column) step) and the sweep's (the streams' shapes)
BIT_SHAPES = ((256, 16), (64, 3), (40, 805), (161, 33), (1_000, 72))
SWEEP = ((256, 16), (1_000, 72), (2_048, 16), (2_048, 256), (2_048, 800),
         (4_096, 256), (6_400, 256), (6_400, 800), (8_191, 800))
TRACE_SHAPES = ((256, 16), (2_048, 256), (6_400, 800))
OLD_MAX_K = 800
DIV_CHECK = r"""
#include "chol_update.cu"
namespace {
__device__ unsigned mix(unsigned long long z) {   // splitmix64, top bits
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return (unsigned)((z ^ (z >> 31)) >> 32);
}
// a float with a random 23-bit mantissa and an exponent in [-60, 60)
__device__ float draw(unsigned long long i, bool sign) {
  const unsigned m = mix(2 * i) & 0x7fffffu;
  const unsigned e = (mix(2 * i + 1) % 120u) + 127u - 60u;
  const unsigned sg = sign ? (mix(~i) & 0x80000000u) : 0u;
  return __uint_as_float(sg | (e << 23) | m);
}
__global__ void div_check(unsigned long long n, unsigned long long seed,
                          unsigned long long* bad, float* first) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = draw(seed + 3 * i, true), c = draw(seed + 3 * i + 1,
                                                       false);
    const float got = div_by(x, c, recip(c)), want = x / c;
    if (__float_as_uint(got) != __float_as_uint(want) || !in_range(x) ||
        !in_range(c)) {
      if (atomicAdd(bad, 1ull) == 0) { first[0] = x; first[1] = c; }
    }
  }
}
}  // namespace
extern "C" int chol_div_check(unsigned long long n, unsigned long long seed,
                              unsigned long long* bad, float* first) {
  div_check<<<132 * 8, 256>>>(n, seed, bad, first);
  return (int)cudaDeviceSynchronize();
}
// in_range at its edges: 2^-60 and the largest float below 2^60 are in,
// the floats next to them outside, zeros, subnormals, inf and NaN out
static bool host_in_range(unsigned bits) {
  return (bits & 0x7fffffffu) - kRangeLo < kRangeSpan;
}
extern "C" int chol_range_edges() {
  // 2^-60, -2^-60, the float below 2^60, 1, -3; then the float below
  // 2^-60, 2^60, -2^60, +-0, the least subnormal, inf, NaN
  const unsigned in[] = {0x21800000u, 0xa1800000u, 0x5d7fffffu,
                         0x3f800000u, 0xc0400000u};
  const unsigned out[] = {0x217fffffu, 0x5d800000u, 0xdd800000u, 0u,
                          0x80000000u, 0x00000001u, 0x7f800000u,
                          0x7fc00000u};
  int ok = 1;
  for (unsigned v : in) ok &= (int)host_in_range(v);
  for (unsigned v : out) ok &= (int)!host_in_range(v);
  return ok;
}
"""
# (name, [(text in csrc/chol_update.cu, its replacement)], keeps the bits)
VARIANTS = [
    ("chunk4", [("constexpr int kChunk = 8;", "constexpr int kChunk = 4;")],
     True),
    ("chunk16", [("constexpr int kChunk = 8;",
                  "constexpr int kChunk = 16;")], True),
    ("min_blocks4", [("constexpr int kMinBlocks = 3;",
                      "constexpr int kMinBlocks = 4;")], True),
    ("ctas2", [("if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;",
                "if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;"
                " if (per_sm > 2) per_sm = 2;")], True),
    ("fast_div", [("return __fmaf_rn(r1, __fmaf_rn(-c, q0, x), q0);",
                   "return q0;")], False),
]


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


def build_variants(variants: dict) -> dict:
    """{name: (source, defines)} built side by side with this tree's flags
    for chol_update.cu; returns {name: (CDLL, ptxas log)}."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, defines) in variants.items():
        out = build.BUILD_DIR / f"probe_chol_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             *build.SOURCE_FLAGS["chol_update"], *defines, "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def ptxas_lines(log: str, pattern: str):
    entry = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif entry and ("Used" in ln or "spill" in ln) and re.search(
                pattern, entry):
            yield f"{entry[:50]}: {ln.split(':', 1)[-1].strip()}"


def new_call(torch, lib):
    """fn(L, V, sign) -> (L', ok) through a current-layout library."""
    from repro_torch.kernels import build, chol_update
    P, I, F = build.P, build.I, build.F
    lib.chol_rank_update_f32.argtypes = [P, P, I, I, I, F, P, P, P, P, P]
    lib.chol_rank_update_f32.restype = ctypes.c_int

    def fn(L, V, sign):
        n, k = V.shape
        out = L.contiguous().clone()
        ok = torch.ones((), dtype=torch.int32, device=L.device)
        nw, ncs, nf = chol_update.scratch_sizes(n, k)
        W = torch.empty(nw, device=L.device)
        cs = torch.empty(ncs, device=L.device)
        flags = torch.empty(nf, dtype=torch.int32, device=L.device)
        for p0 in range(0, k, chol_update.MAX_K):
            build.check(lib.chol_rank_update_f32(
                out.data_ptr(), V.data_ptr() + 4 * p0, n,
                min(chol_update.MAX_K, k - p0), k, sign, W.data_ptr(),
                cs.data_ptr(), flags.data_ptr(), ok.data_ptr(),
                build.stream(L)), "chol probe")
        return out, ok
    return fn


def old_call(torch, lib):
    """fn(L, V, sign) -> (L', ok) through PR 22's cooperative kernel."""
    from repro_torch.kernels import build
    P, I, F = build.P, build.I, build.F
    lib.chol_rank_update_f32.argtypes = [P, P, I, I, I, F, P, P, P]
    lib.chol_rank_update_f32.restype = ctypes.c_int

    def fn(L, V, sign):
        n, k = V.shape
        out = L.contiguous().clone()
        ok = torch.ones((), dtype=torch.int32, device=L.device)
        cs = torch.empty(4 * min(k, OLD_MAX_K), device=L.device)
        for p0 in range(0, k, OLD_MAX_K):
            build.check(lib.chol_rank_update_f32(
                out.data_ptr(), V.data_ptr() + 4 * p0, n,
                min(OLD_MAX_K, k - p0), k, sign, cs.data_ptr(),
                ok.data_ptr(), build.stream(L)), "chol probe (earlier)")
        return out, ok
    return fn


def polish_checks(torch, dev, g) -> int:
    from repro_torch.kernels import bisect_proj, build, ref
    info = build.build_all(("ladder_proj",))
    for ln in ptxas_lines(info["ladder_proj"]["log"],
                          r"l1_proj_kernel|l1_lanes_kernel"):
        print(f"  ladder_proj: {ln}")
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
        t64 = ms(torch, lambda: bisect_proj.l1_epigraph_proj(
            z0, tz, polish64=True))
        t32 = ms(torch, lambda: bisect_proj.l1_epigraph_proj(z0, tz))
        print(f"l1 polish64 n={nn}: theta {float(got[2])!r} plain "
              f"{float(want[2])!r} f32 {float(f32[2])!r}; steps {int(got[3])}"
              f" / {want[3]} (f32 {int(f32[3])}); max abs err {err:.3e} "
              f"{'ok' if ok else 'DISAGREES'}; {t64:.4f} ms vs f32 "
              f"{t32:.4f} ms")
    zl = torch.randn(10_000, 16, device=dev, generator=g)
    tl = 0.5 * zl.abs().sum(1)
    got = bisect_proj.l1_epigraph_proj_lanes(zl, tl, polish64=True)
    want = ref.l1_epigraph_proj_lanes_ref(zl, tl, polish64=True)
    ok = torch.allclose(got[0], want[0], rtol=1e-6, atol=1e-6 * 5)
    bad += not ok
    t64 = ms(torch, lambda: bisect_proj.l1_epigraph_proj_lanes(
        zl, tl, polish64=True))
    t32 = ms(torch, lambda: bisect_proj.l1_epigraph_proj_lanes(zl, tl))
    print(f"l1 lanes polish64 (10000, 16): max abs err "
          f"{float((got[0] - want[0]).abs().max()):.3e} "
          f"{'ok' if ok else 'DISAGREES'}; {t64:.4f} ms vs f32 {t32:.4f} ms")
    return bad


def factor(torch, n, dev, g):
    """An SPD matrix M (f64) and its f32 lower factor."""
    A = torch.randn(n + 8, n, device=dev, generator=g)
    M = (A.T @ A).double() / n + torch.eye(n, device=dev,
                                           dtype=torch.float64)
    return M, torch.linalg.cholesky(M).float()


def trace_summary(rows, n, k) -> dict:
    """What the tile records of one call say: busy, wait and step times of
    the diagonal tiles and the others, concurrency, the panels' lag, the
    bytes the tiles move."""
    from repro_torch.kernels import chol_update
    b = chol_update.PANEL
    start = min(r[2] for r in rows)
    elapsed = max(r[3] for r in rows) - start
    kinds = {"diag": [r for r in rows if r[0] == r[1]],
             "off": [r for r in rows if r[0] != r[1]]}
    out = {"tiles": len(rows), "elapsed_ms": elapsed / 1e6,
           "sms": len({r[5] for r in rows}),
           "concurrency": sum(r[3] - r[2] for r in rows) / max(elapsed, 1)}
    for kind, rs in kinds.items():
        if not rs:
            continue
        steps = k + (2 if kind == "diag" else 1) * (b - 1)
        busy = [r[3] - r[2] for r in rs]
        wait = [r[4] for r in rs]
        out[kind] = {
            "tiles": len(rs), "busy_ms": sum(busy) / 1e6,
            "wait_ms": sum(wait) / 1e6,
            "ns_a_step": statistics.median(
                (x - w) / steps for x, w in zip(busy, wait)),
            "wait_share": sum(wait) / max(sum(busy), 1)}
    diag = sorted(kinds["diag"], key=lambda r: r[0])
    if len(diag) > 1:
        lags = [(diag[i + 1][2] - diag[i][2]) / 1e3
                for i in range(len(diag) - 1)]
        out["panel_lag_us"] = statistics.median(lags)
        out["last_diag_start_ms"] = (diag[-1][2] - start) / 1e6
    # through L2: W (or V) read and written once a tile (read only on the
    # diagonal), c, s read by every tile below the diagonal and written
    # once, L read and written once
    nb = -(-n // b)
    offs = nb * (nb - 1) // 2
    nbytes = (offs * (2 * b * k * 4 + b * k * 8)
              + nb * (b * k * 4 + b * k * 8) + 2 * 4 * n * (n + 1) // 2)
    out["l2_gb"] = nbytes / 1e9
    out["l2_gb_per_s"] = nbytes / max(elapsed, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--polish", action="store_true")
    ap.add_argument("--chol", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--div-check", action="store_true")
    ap.add_argument("--sass", help="write the kernel's SASS to PATH")
    ap.add_argument("--against", help="an earlier chol_update.cu")
    ap.add_argument("--report", help="write the results to PATH as JSON")
    args = ap.parse_args()
    if not (args.polish or args.chol or args.trace or args.against
            or args.variants or args.sass or args.div_check):
        args.polish = args.chol = True
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build, chol_update, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    report, bad = {}, 0
    t0 = time.perf_counter()
    src = str(build.CSRC / "chol_update.cu")
    variants = {}
    if args.trace:
        variants["trace"] = (src, ("-DCHOL_UPDATE_TRACE",))
    if args.against:
        variants["earlier"] = (args.against, ())
    if args.div_check:
        path = build.BUILD_DIR / "chol_div_check.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(DIV_CHECK)
        variants["div_check"] = (str(path), ("-I", str(build.CSRC)))
    if args.variants:
        text = (build.CSRC / "chol_update.cu").read_text()
        for name, edits, _ in VARIANTS:
            out = text
            for a, b in edits:
                if a not in out:
                    raise RuntimeError(f"variant {name}: {a!r} not found")
                out = out.replace(a, b)
            path = build.BUILD_DIR / f"chol_variant_{name}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(out)
            variants[name] = (str(path), ())
    info = build.build_all(("chol_update",))
    libs = build_variants(variants)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in ptxas_lines(info["chol_update"]["log"], r"chol"):
        print(f"  chol_update: {ln}")
    for name, (_, log) in libs.items():
        for ln in ptxas_lines(log, r"chol"):
            print(f"  {name}: {ln}")
    current = chol_update.chol_rank_update
    if args.sass:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([cuobjdump, "-sass",
                            str(build.library_path("chol_update"))],
                           stdout=f, stderr=subprocess.STDOUT, check=False)
        print(f"SASS written to {args.sass}")

    if args.polish:
        bad += polish_checks(torch, dev, g)

    if args.div_check:
        dlib = libs["div_check"][0]
        U64 = ctypes.c_ulonglong
        dlib.chol_div_check.argtypes = [U64, U64, build.P, build.P]
        nbad = torch.zeros((), dtype=torch.int64, device=dev)
        first = torch.zeros(2, device=dev)
        pairs = 1 << 32
        t = time.perf_counter()
        rc = dlib.chol_div_check(pairs, 12345, nbad.data_ptr(),
                                 first.data_ptr())
        edges = dlib.chol_range_edges()
        ok = rc == 0 and int(nbad) == 0 and edges == 1
        bad += not ok
        report["div_check"] = {"pairs": pairs, "mismatches": int(nbad),
                               "range_edges_ok": edges == 1}
        print(f"div check: {pairs} pairs, {int(nbad)} differ from x / c "
              f"(first {first.tolist()}), range edges "
              f"{'ok' if edges == 1 else 'WRONG'} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)

    if args.chol:
        for n, k in BIT_SHAPES:
            M, L = factor(torch, n, dev, g)
            V = torch.randn(n, k, device=dev, generator=g) * 0.3
            L0 = L
            for sign in (1.0, -1.0):
                got, gok = current(L0, V, sign)
                want, wok = ref.chol_rank_update_ref(L0, V, sign)
                same = torch.equal(got, want) and bool(gok) == bool(wok)
                bad += not same
                print(f"chol n={n} k={k} sign={sign:+.0f}: bit equal {same},"
                      f" ok {bool(gok)}/{bool(wok)}", flush=True)
                L0 = got
        report["sweep"] = {}
        for n, k in SWEEP:
            M, L = factor(torch, n, dev, g)
            V = torch.randn(n, k, device=dev, generator=g)
            got, gok = current(L, V, 1.0)
            Vd = V.double()
            Mu = M + Vd @ Vd.T
            want = torch.linalg.cholesky(Mu)
            rel = float((got.double() - want).norm() / want.norm())
            t = chip_smoke.graph_ms(torch, lambda: current(L, V, 1.0),
                                    reps=5, inner=2)
            Muf = Mu.float()
            lib_ms = ms(torch, lambda: torch.linalg.cholesky_ex(Muf), reps=5)
            bnd, by = chip_smoke.bound(2 * 4 * n * n + 4 * n * k,
                                       6.0 * n * n / 2 * k)
            report["sweep"][f"{n},{k}"] = {"ms": t, "rel_err": rel,
                                           "cholesky_ex_ms": lib_ms,
                                           "bound_ms": bnd, "bound_by": by}
            print(f"chol n={n} k={k}: rel err vs f64 cholesky {rel:.3e}, ok "
                  f"{bool(gok)}; {t:.4f} ms (bound {bnd:.4f} ms, {by}); "
                  f"cholesky_ex of the updated matrix {lib_ms:.4f} ms",
                  flush=True)
            bad += not (rel < 1e-4 and bool(gok))
            del M, Mu, Muf, want

    if args.against:
        old = old_call(torch, libs["earlier"][0])
        report["against"] = {}
        for n, k in SWEEP:
            M, L = factor(torch, n, dev, g)
            V = torch.randn(n, k, device=dev, generator=g)
            same = True
            for sign in (1.0, -1.0):
                L0 = L if sign > 0 else current(L, V, 1.0)[0]
                a, aok = current(L0, V, sign)
                b, bok = old(L0, V, sign)
                same &= torch.equal(a, b) and bool(aok) == bool(bok)
            bad += not same
            reps = 3 if n * n * k > 1e9 else 5
            times = {"earlier": [], "current": []}
            for who in ("earlier", "current", "current", "earlier"):
                fn = old if who == "earlier" else current
                times[who].append(ms(torch, lambda: fn(L, V, 1.0),
                                     reps=reps))
            row = {w: statistics.mean(v) for w, v in times.items()}
            row["bit_equal"] = same
            report["against"][f"{n},{k}"] = row
            print(f"against n={n} k={k}: earlier {row['earlier']:.4f} ms, "
                  f"current {row['current']:.4f} ms "
                  f"({row['earlier'] / row['current']:.1f}x); update and "
                  f"downdate bit equal {same}", flush=True)

    if args.variants:
        report["variants"] = {}
        for n, k in TRACE_SHAPES:
            M, L = factor(torch, n, dev, g)
            V = torch.randn(n, k, device=dev, generator=g)
            want = current(L, V, 1.0)[0]
            row = {}
            for name, _, keeps in VARIANTS:
                fn = new_call(torch, libs[name][0])
                same = torch.equal(fn(L, V, 1.0)[0], want)
                bad += keeps and not same
                t = {"current": [], name: []}
                for who in ("current", name, name, "current"):
                    f = current if who == "current" else fn
                    t[who].append(ms(torch, lambda: f(L, V, 1.0), reps=5))
                row[name] = {w: statistics.mean(v) for w, v in t.items()}
                row[name]["bit_equal"] = same
                print(f"variant {name} n={n} k={k}: "
                      f"{row[name][name]:.4f} ms against the current "
                      f"{row[name]['current']:.4f} ms; bit equal {same}",
                      flush=True)
            report["variants"][f"{n},{k}"] = row

    if args.trace:
        tlib = libs["trace"][0]
        traced = new_call(torch, tlib)
        tlib.chol_update_trace.argtypes = [build.P, build.I]
        tlib.chol_update_trace.restype = ctypes.c_int
        report["trace"] = {}
        for n, k in TRACE_SHAPES:
            M, L = factor(torch, n, dev, g)
            V = torch.randn(n, k, device=dev, generator=g)
            traced(L, V, 1.0)               # warm
            t = ms(torch, lambda: traced(L, V, 1.0), reps=1)
            nb = -(-n // chol_update.PANEL)
            cap = nb * (nb + 1) // 2
            buf = (ctypes.c_longlong * (6 * cap))()
            rows = tlib.chol_update_trace(buf, cap)
            if rows < 0:
                raise RuntimeError("chol_update_trace failed")
            recs = [tuple(buf[6 * i:6 * i + 6]) for i in range(rows)]
            s = trace_summary(recs, n, k)
            s["call_ms"] = t
            report["trace"][f"{n},{k}"] = s
            print(f"trace n={n} k={k}: call {t:.3f} ms, tiles {s['tiles']} "
                  f"on {s['sms']} SMs, {s['concurrency']:.1f} at once; "
                  + "; ".join(
                      f"{kind} busy {s[kind]['busy_ms']:.2f} ms, wait "
                      f"{s[kind]['wait_ms']:.2f} ms "
                      f"({s[kind]['wait_share']:.2f}), "
                      f"{s[kind]['ns_a_step']:.1f} ns a step"
                      for kind in ("diag", "off") if kind in s)
                  + (f"; panel lag {s['panel_lag_us']:.2f} us, last "
                     f"diagonal starts at {s['last_diag_start_ms']:.3f} ms"
                     if "panel_lag_us" in s else "")
                  + f"; L2 {s['l2_gb']:.3f} GB, {s['l2_gb_per_s']:.1f} GB/s",
                  flush=True)

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print("ok" if not bad else f"FAIL: {bad} checks")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
