#!/usr/bin/env python3
"""Probe of the port's ``csrc/gram.cu`` (the bf16 / fp16 path) and
``csrc/ladder_stats.cu`` on one NVIDIA GPU, against earlier sources.

    git show <commit>:src/repro_torch/csrc/gram.cu > build/old/gram.cu
    git show <commit>:src/repro_torch/csrc/ladder_stats.cu \\
        > build/old/ladder_stats.cu
    python3 tools/gram_ladder_probe.py --gram-against build/old/gram.cu \\
        --ladder-against build/old/ladder_stats.cu [--no-variants] \\
        [--report PATH]

The earlier ``gram.cu`` has the entries ``gram_xy_<f32|bf16|f16>(x, y, out,
n_outer, n_inner, m, nx, ny, 8 strides, symmetric, stream)``; the earlier
``ladder_stats.cu`` the two-pass ``ladder_stats_f32(az, th, psum, pcnt,
out, n, B, nblocks, stream)`` and ``ladder_chunk()``. Phases:

1. breakdown — the earlier ``ladder_stats``' two kernels (``ladder_partial``
   and ``ladder_reduce``) timed apart by ``torch.profiler`` at the composed
   path's n = 409,601, B = 128 and at n = 10,000, beside the current
   one-launch kernel;
2. identity  — the f32 Gram bit for bit (``torch.equal``) against the
   earlier kernel at the solver's shapes (A A^T of (8, 800, 10,000), A^T A
   of (8, 800, 1,000), an (N, M, m, nb) block view, the general path);
   the bf16 / fp16 Gram of the earlier f64 CUDA-core kernel against the
   FP64 tensor-core one (entries that differ, and by how many f32 ulps);
3. ab        — device times in turns (earlier, current, current, earlier)
   of the half-width Gram beside ``torch.matmul`` in f64 on operands
   widened before the clock and in the half type, of the f32 Gram, and of
   ``ladder_stats``;
4. variants  — copies of ``gram.cu`` with one design change each (the
   other DMMA shapes among them), built side by side, held to one f32
   rounding of the plain version (and compared bit for bit with the
   source as it is) and timed in turns with it.

Device times are ``chip_smoke.graph_ms`` (CUDA-graph replays, medians of
20). Needs a card and ``nvcc``; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_GRAM_SIG = [P, P, P, I, I, I, I, I, *[L] * 8, I, P]
# (name, what changes, [(text in csrc/gram.cu, its replacement)])
VARIANTS = [
    ("m8n8k4", "m8n8k4 DMMAs (16 a warp a 4-deep step)",
     [("constexpr int kMmaM = 16, kMmaK = 4;",
       "constexpr int kMmaM = 8, kMmaK = 4;")]),
    ("m16n8k8", "m16n8k8 DMMAs",
     [("constexpr int kMmaM = 16, kMmaK = 4;",
       "constexpr int kMmaM = 16, kMmaK = 8;")]),
    ("m16n8k16", "m16n8k16 DMMAs",
     [("constexpr int kMmaM = 16, kMmaK = 4;",
       "constexpr int kMmaM = 16, kMmaK = 16;")]),
    ("three_blocks", "the cp.async kernel at 3 blocks an SM (170 registers)",
     [("__launch_bounds__(kHalfThreads, VEC ? 4 : 3)",
       "__launch_bounds__(kHalfThreads, 3)")]),
    ("three_stages", "a ring of 3 k-slices",
     [("kHalfThreads = 128, kStages = 4;",
       "kHalfThreads = 128, kStages = 3;")]),
    ("int_widen", "bf16 widened to f64 by integer ops and one DMUL (no F2F)",
     [("  return static_cast<double>(from_bits<T>(s[at<KF>(k, c)]));",
       "  const unsigned u = s[at<KF>(k, c)];\n"
       "  if constexpr (sizeof(T) == 2 && !std::is_same<T, __half>::value)\n"
       "    return __hiloint2double((int)(((u & 0x7fffu) << 13)"
       " | ((u & 0x8000u) << 16)), 0) * 0x1p896;\n"
       "  return static_cast<double>(from_bits<T>(u));"),
      ("#include <cstdint>", "#include <cstdint>\n#include <type_traits>")]),
]
# the same for csrc/ladder_stats.cu, each timed at the plan's grid and at
# two CTAs an SM
LADDER_VARIANTS = [
    ("branch_free", "a pair as FSET, FFMA, FADD (no predicated adds), the "
     "piece padded with -FLT_MAX",
     [("s[i] = i < plen ? az[start + p0 + i] : -INFINITY;",
       "s[i] = i < plen ? az[start + p0 + i] : -FLT_MAX;"),
      ("#include <math.h>", "#include <math.h>\n#include <float.h>")]
     + [(f"if (v.{c} > tb) {{ s{i} += v.{c}; ++c{i}; }}",
         f"{{ const float p = v.{c} > tb ? 1.f : 0.f; "
         f"s{i} = fmaf(v.{c}, p, s{i}); f{i} += p; }}")
        for i, c in enumerate("xyzw")]
     + [("int c0 = 0, c1 = 0, c2 = 0, c3 = 0;",
         "float f0 = 0.f, f1 = 0.f, f2 = 0.f, f3 = 0.f;"),
        ("C += (c0 + c1) + (c2 + c3);",
         "C += (int)f0 + (int)f1 + (int)f2 + (int)f3;")]),
    ("two_ctas", "two CTAs an SM (32 registers a thread)",
     [("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")]),
]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_lib(build, src: str, out: str) -> subprocess.Popen:
    return subprocess.Popen(
        [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(build.CSRC),
         "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gram-against", required=True)
    ap.add_argument("--ladder-against", required=True)
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--report", help="write the results to PATH as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bisect_proj, build, gram, ref

    dev = torch.device("cuda")
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"gram_old": build_lib(build, os.path.abspath(args.gram_against),
                                  str(out_dir / "libgram_old.so")),
            "ladder_old": build_lib(build,
                                    os.path.abspath(args.ladder_against),
                                    str(out_dir / "libladder_old.so"))}
    src = (build.CSRC / "gram.cu").read_text()
    variants = [] if args.no_variants else VARIANTS
    for name, _, patches in variants:
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"FAIL: variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (out_dir / f"gram_{name}.cu").write_text(text)
        jobs[name] = build_lib(build, str(out_dir / f"gram_{name}.cu"),
                               str(out_dir / f"libgram_{name}.so"))
    lsrc = (build.CSRC / "ladder_stats.cu").read_text()
    ladder_variants = [] if args.no_variants else LADDER_VARIANTS
    for name, _, patches in ladder_variants:
        text = lsrc
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"FAIL: variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (out_dir / f"ladder_{name}.cu").write_text(text)
        jobs[f"ladder_{name}"] = build_lib(
            build, str(out_dir / f"ladder_{name}.cu"),
            str(out_dir / f"libladder_{name}.so"))
    libs, ptxas = {}, {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise SystemExit(f"FAIL: nvcc {name}:\n{log[-3000:]}")
        ptxas[name] = cs.ptxas_summary({name: {"log": log}})
        stem = (name if name.endswith("_old") or name.startswith("ladder_")
                else f"gram_{name}")
        lib = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
        if name.startswith("ladder_") and name != "ladder_old":
            lib.ladder_stats_f32.argtypes = bisect_proj._SIGNATURES[
                "ladder_stats_f32"]
        elif name == "gram_old":
            for e in ("gram_xy_f32", "gram_xy_bf16", "gram_xy_f16"):
                getattr(lib, e).argtypes = OLD_GRAM_SIG
        elif name == "ladder_old":
            lib.ladder_stats_f32.argtypes = [P, P, P, P, P, I, I, I, P]
        else:
            for e, sig in gram._SIGNATURES.items():
                getattr(lib, e).argtypes = sig
        libs[name] = lib
    cur = build.library("gram", gram._SIGNATURES)
    report = {"nvidia_smi": smi(), "ptxas": ptxas, "breakdown": {},
              "identity": {}, "ab": {}, "variants": {}}
    print(report["nvidia_smi"], flush=True)
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"  ptxas {ln}", flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc:
            raise SystemExit(f"FAIL: CUDA error {rc} at launch")

    def gram_with(lib, x, old=False):
        """x^T x through ``lib``'s entry for x's dtype."""
        args_ = gram.launch_args(x, x)
        out = torch.empty((*x.shape[:-2], x.shape[-1], x.shape[-1]),
                          dtype=torch.float32, device=dev)
        entry = gram._ENTRY[x.dtype]
        path = (() if old or x.dtype == torch.float32
                else (gram.half_path(x, x),))
        check(getattr(lib, entry)(x.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  *args_, *path, stream()))
        return out

    def gram_xy_old(x, y):
        args_ = gram.launch_args(x, y)
        out = torch.empty((*x.shape[:-2], x.shape[-1], y.shape[-1]),
                          dtype=torch.float32, device=dev)
        check(libs["gram_old"].gram_xy_f32(x.data_ptr(), y.data_ptr(),
                                           out.data_ptr(), *args_, stream()))
        return out

    old_ls = libs["ladder_old"]
    old_ls.ladder_chunk.argtypes = []
    chunk = old_ls.ladder_chunk()

    def ladder_old(az, th):
        n, B = az.shape[0], th.shape[0]
        nb = -(-n // chunk)
        psum = torch.empty((max(nb, 1), B), dtype=torch.float32, device=dev)
        pcnt = torch.empty((max(nb, 1), B), dtype=torch.int32, device=dev)
        out = torch.empty((2, B), dtype=torch.float32, device=dev)
        check(old_ls.ladder_stats_f32(az.data_ptr(), th.data_ptr(),
                                      psum.data_ptr(), pcnt.data_ptr(),
                                      out.data_ptr(), n, B, nb, stream()))
        return out

    def turns(label, cases):
        """cases: [(name, fn)]; times them forward, then backward."""
        times = {name: [] for name, _ in cases}
        for seq in (cases, cases[::-1]):
            for name, fn in seq:
                times[name].append(cs.graph_ms(torch, fn))
        print(f"  {label}: " + " | ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
            for n, ts in times.items()), flush=True)
        return times

    g = torch.Generator(device=dev).manual_seed(0)
    # 1. breakdown of the earlier ladder_stats, beside the current kernel
    ladders = {}
    for n in (bisect_proj.MAX_N + 1, 10_000):
        az = torch.randn(n, device=dev, generator=g).abs()
        th = az.max() * torch.arange(1, 129, device=dev,
                                     dtype=torch.float32) / 128
        ladders[n] = (az, th)
        want = ref.ladder_stats_ref(az, th)
        for fn in (ladder_old, bisect_proj.ladder_stats):
            got = fn(az, th)
            if not torch.equal(got[1], want[1]):
                raise SystemExit(f"FAIL: ladder_stats n={n}: counts differ")
            torch.testing.assert_close(got[0], want[0], rtol=1e-4,
                                       atol=1e-5 * float(az.sum()))
        for fn in (ladder_old, bisect_proj.ladder_stats):
            for _ in range(3):
                fn(az, th)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ladder_old(az, th)
                bisect_proj.ladder_stats(az, th)
            torch.cuda.synchronize()
        us = {ev.key.split("::")[-1].split("(")[0]:
              ev.self_device_time_total / ev.count
              for ev in prof.key_averages()
              if ev.count >= 20 and "ladder" in ev.key}
        report["breakdown"][f"n={n} B=128"] = us
        print(f"  breakdown n={n} B=128 (profiler, device us a call): "
              + ", ".join(f"{k} {v:.2f}" for k, v in us.items()),
              flush=True)

    # 2. identity
    A = torch.randn(8, 800, 10_000, device=dev, generator=g)
    An = torch.randn(8, 800, 1_000, device=dev, generator=g)
    Ab = torch.randn(2, 6_000, 1_000, device=dev, generator=g)
    view = Ab.unflatten(-1, (4, 250)).permute(0, 2, 1, 3)
    same = []
    for label, x in (("A A^T (8, 800, 10000)", A.mT),
                     ("A^T A (8, 800, 1000)", An),
                     ("block view (2, 4, 6000, 250)", view)):
        eq = torch.equal(gram_with(libs["gram_old"], x, old=True),
                         gram.gram(x))
        same.append(eq)
        report["identity"][f"f32 {label}"] = eq
        print(f"  identity f32 {label}: {'equal' if eq else 'DIFFERS'}",
              flush=True)
    B2 = torch.randn(A.shape, device=dev, generator=g)
    eq = torch.equal(gram_xy_old(A.mT, B2.mT), gram.gram_xy(A.mT, B2.mT))
    same.append(eq)
    report["identity"]["f32 gram_xy A^T B"] = eq
    print(f"  identity f32 gram_xy A^T B: {'equal' if eq else 'DIFFERS'}",
          flush=True)
    del B2
    halves = {}
    for dt, sfx in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        halves[sfx] = [(f"A^T A (8, 800, 1000) {sfx}", An.to(dt))]
        if dt == torch.bfloat16:
            halves[sfx].insert(0, (f"A A^T (8, 800, 10000) {sfx}",
                                   A.to(dt).mT))
        for label, x in halves[sfx]:
            old = gram_with(libs["gram_old"], x, old=True)
            new = gram.gram(x)
            diff = old != new
            ulps = (old.view(torch.int32) - new.view(torch.int32)).abs()
            rec = {"entries": old.numel(), "differ": int(diff.sum()),
                   "max_ulps": int(ulps.max())}
            report["identity"][f"earlier f64 vs DMMA {label}"] = rec
            print(f"  earlier f64 CUDA-core Gram vs DMMA, {label}: "
                  f"{rec['differ']} of {rec['entries']} entries differ, "
                  f"at most {rec['max_ulps']} ulp", flush=True)

    # 3. ab
    for sfx, cases in halves.items():
        for label, x in cases:
            xd = x.double()
            report["ab"][f"gram {label}"] = turns(
                f"ab gram {label}",
                [("earlier", lambda x=x: gram_with(libs["gram_old"], x,
                                                   old=True)),
                 ("current", lambda x=x: gram.gram(x)),
                 ("f64 matmul", lambda xd=xd: torch.matmul(xd.mT, xd)),
                 (f"{sfx} matmul", lambda x=x: torch.matmul(x.mT, x))])
            del xd
    for label, x in (("A A^T (8, 800, 10000) f32", A.mT),
                     ("A^T A (8, 800, 1000) f32", An)):
        report["ab"][f"gram {label}"] = turns(
            f"ab gram {label}",
            [("earlier", lambda x=x: gram_with(libs["gram_old"], x,
                                               old=True)),
             ("current", lambda x=x: gram.gram(x))])
    for n, (az, th) in ladders.items():
        report["ab"][f"ladder_stats n={n} B=128"] = turns(
            f"ab ladder_stats n={n} B=128",
            [("earlier", lambda az=az, th=th: ladder_old(az, th)),
             ("current", lambda az=az, th=th: bisect_proj.ladder_stats(az,
                                                                      th))])

    # ladder_stats' grid: the plan's against other CTA counts
    cur_ls = build.library("ladder_stats", bisect_proj._SIGNATURES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def ladder_grid(az, th, ctas, lib=cur_ls):
        n, B = az.shape[0], th.shape[0]
        per = -(-n // ctas)
        ticket, psum, pcnt = bisect_proj._scratch(dev, ctas * B)
        out = torch.empty((2, B), dtype=torch.float32, device=dev)
        check(lib.ladder_stats_f32(az.data_ptr(), th.data_ptr(), n, B,
                                      -(-n // per), per, psum.data_ptr(),
                                      pcnt.data_ptr(), ticket.data_ptr(),
                                      out.data_ptr(), stream()))
        return out

    for n, (az, th) in ladders.items():
        plan = bisect_proj.stats_plan(n, sms).ctas
        cands = sorted({plan, max(1, plan // 2), min(sms, 2 * plan), sms})
        report["ab"][f"ladder_stats grid n={n}"] = turns(
            f"ladder_stats grid n={n} B=128 (plan: {plan} CTAs)",
            [(f"{c} CTAs", lambda az=az, th=th, c=c: ladder_grid(az, th, c))
             for c in cands])

    for name, what, _ in ladder_variants:
        lib = libs[f"ladder_{name}"]
        rows = {}
        for n, (az, th) in ladders.items():
            plan = bisect_proj.stats_plan(n, sms).ctas
            want = ref.ladder_stats_ref(az, th)
            for c in (plan, min(2 * plan, 2 * sms)):
                got = ladder_grid(az, th, c, lib)
                if not torch.equal(got[1], want[1]):
                    raise SystemExit(f"FAIL: variant {name}: counts differ")
                torch.testing.assert_close(got[0], want[0], rtol=1e-4,
                                           atol=1e-5 * float(az.sum()))
            rows[f"n={n}"] = turns(
                f"variant {name} ({what}): ladder_stats n={n} B=128",
                [(f"as it is, {plan} CTAs",
                  lambda az=az, th=th, c=plan: ladder_grid(az, th, c)),
                 (f"{name}, {plan} CTAs",
                  lambda az=az, th=th, c=plan, lib=lib: ladder_grid(
                      az, th, c, lib)),
                 (f"{name}, {min(2 * plan, 2 * sms)} CTAs",
                  lambda az=az, th=th, c=min(2 * plan, 2 * sms), lib=lib:
                      ladder_grid(az, th, c, lib))])
        report["variants"][f"ladder {name}"] = rows

    # 4. variants, each against the source as it is
    for name, what, _ in variants:
        lib = libs[name]
        rows = {}
        for sfx, cases in halves.items():
            for label, x in cases:
                got = gram_with(lib, x)
                torch.testing.assert_close(got, ref.gram_ref(x),
                                           rtol=2.0 ** -23, atol=0.0,
                                           msg=f"variant {name}: {label}")
                same_bits = torch.equal(got, gram.gram(x))
                print(f"  variant {name}: {label} "
                      f"{'equal to' if same_bits else 'DIFFERS from'} the "
                      "source's bits", flush=True)
                rows[label] = turns(
                    f"variant {name} ({what}): {label}",
                    [("as it is", lambda x=x: gram_with(cur, x)),
                     (name, lambda x=x, lib=lib: gram_with(lib, x))])
        report["variants"][name] = rows

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
