#!/usr/bin/env python3
"""Probe of the port's ``csrc/matvec.cu`` on one NVIDIA GPU.

    git show <commit>:src/repro_torch/csrc/matvec.cu > build/matvec_old.cu
    python3 tools/matvec_probe.py --against build/matvec_old.cu \\
        [--normal-against build/normal_matvec_old.cu] [--identity-only] \\
        [--report PATH]

``--against`` names an earlier ``matvec.cu``: one whose C entry points are
``matvec_f32(A, X, out, N, m, n, K, vec, stream)`` and
``rmatvec_f32(A, Y, part, out, N, m, n, K, stream)`` with one partial per
128-row slice (the kernels before the redesign), or one with the current
f32 entries (``..., path, grid, stream)`` and ``..., vec, team, grid,
stream)``), launched with the current plan. ``--normal-against`` names an
earlier ``normal_matvec.cu`` with the current ``normal_matvec_f32`` entry.
``--identity-only`` runs phase 1 alone. Phases:

1. identity — ``matvec`` and ``rmatvec`` at K = 1 (and ``rmatvec`` at
   K = 3) through the wrapper, bit for bit (``torch.equal``) against the
   earlier kernels, at the solver path's shapes, with X also one float past
   16 bytes and 1-D; with ``--normal-against``, ``normal_matvec`` at the
   path's shapes with each shift form, bit for bit;
2. ab      — device times of the earlier and the current kernels in turns
   (earlier, current, current, earlier) and of ``torch.matmul``;
3. plan    — launches the wrapper's plan does not choose, through the C
   entry point: one launch against sliced ``rmatvec``, and its grids;
4. variants — copies of the source with one design change each, built side
   by side and timed in turns with the source as it is;
5. slices  — each kernel's device time in a sliced ``rmatvec`` call
   (``torch.profiler``).

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

P, I = ctypes.c_void_p, ctypes.c_int
# (name, what changes, [(text in csrc/matvec.cu, its replacement)])
VARIANTS = [
    ("rows_swapped", "matvec warps own 2 rows at K = 1 and 4 above",
     [("constexpr int kRowsPerWarp1 = 4;", "constexpr int kRowsPerWarp1 = 2;"),
      ("constexpr int kRowsPerWarpK = 2;",
       "constexpr int kRowsPerWarpK = 4;")]),
    ("plain_loads", "plain loads of A everywhere",
     [("if constexpr (kStream) return __ldcs(p);",
       "if constexpr (false) return __ldcs(p);")]),
    ("stream_team", "cache-streaming loads in the one-launch rmatvec too",
     [("slice_partial<V, KC, false>", "slice_partial<V, KC, true>")]),
    ("half_in_flight", "half the loads of A in flight a lane",
     [("if (P == kVec1) return 16 / R;", "if (P == kVec1) return 8 / R;"),
      ("return KC <= 2 ? 8 : KC <= 4 ? 4 : 2;",
       "return KC <= 2 ? 4 : KC <= 4 ? 2 : 1;")]),
    ("rmv_16_rows", "16 rows' loads in flight in rmatvec",
     [("return KC <= 2 ? 8 : KC <= 4 ? 4 : 2;",
       "return KC <= 2 ? 16 : KC <= 4 ? 8 : 2;")]),
    ("matvec_3_blocks", "matvec at 3 blocks an SM, half the loads in flight",
     [("__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)\n"
       "matvec_kernel(",
       "__global__ void __launch_bounds__(kWarps * 32, 3)\nmatvec_kernel("),
      ("if (P == kVec1) return 16 / R;", "if (P == kVec1) return 8 / R;")]),
]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_lib(build, src: str, out: str, extra=()) -> subprocess.Popen:
    return subprocess.Popen(
        [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", *extra, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="an earlier matvec.cu (the C interface above)")
    ap.add_argument("--normal-against",
                    help="an earlier normal_matvec.cu (the f32 entry above)")
    ap.add_argument("--identity-only", action="store_true",
                    help="run the identity phase alone")
    ap.add_argument("--report", help="write the results to PATH as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, matvec, ref

    dev = torch.device("cuda")
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "matvec.cu").read_text()
    old_current = "int path, int grid" in open(args.against).read()
    # the earlier sources include csrc's headers by name
    inc = ["-I", str(build.CSRC)]
    jobs = {"old": build_lib(build, os.path.abspath(args.against),
                             str(out_dir / "libmatvec_old.so"), inc)}
    if args.normal_against:
        jobs["normal_old"] = build_lib(
            build, os.path.abspath(args.normal_against),
            str(out_dir / "libnormal_old.so"), inc)
    for name, _, patches in ([] if args.identity_only else VARIANTS):
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"FAIL: variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (out_dir / f"matvec_{name}.cu").write_text(text)
        jobs[name] = build_lib(build, str(out_dir / f"matvec_{name}.cu"),
                               str(out_dir / f"libmatvec_{name}.so"), inc)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise SystemExit(f"FAIL: nvcc {name}:\n{log[-3000:]}")
        if name == "normal_old":
            lib = ctypes.CDLL(str(out_dir / "libnormal_old.so"))
            lib.normal_matvec_f32.argtypes = matvec._NM_SIGNATURES[
                "normal_matvec_f32"]
            libs[name] = lib
            continue
        lib = ctypes.CDLL(str(out_dir / f"libmatvec_{name}.so"))
        if name == "old" and not old_current:
            lib.matvec_f32.argtypes = [P, P, P, I, I, I, I, I, P]
            lib.rmatvec_f32.argtypes = [P, P, P, P, I, I, I, I, P]
        else:
            lib.matvec_f32.argtypes = matvec._SIGNATURES["matvec_f32"]
            lib.rmatvec_f32.argtypes = matvec._SIGNATURES["rmatvec_f32"]
        libs[name] = lib
    libs["current"] = cur = build.library("matvec", matvec._SIGNATURES)
    sms = matvec.sm_count(dev)
    report = {"nvidia_smi": smi(), "identity": {}, "ab": {}, "plan": {},
              "variants": {}, "slices": {}}
    print(report["nvidia_smi"], flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc:
            raise SystemExit(f"FAIL: CUDA error {rc} at launch")

    def old_mv(A, x):
        if old_current:
            return mv(libs["old"], A, x)
        N, m, n = A.shape
        out = torch.empty(N, m, x.shape[2], device=dev)
        vec = int(x.shape[2] == 1 and n % 4 == 0 and A.data_ptr() % 16 == 0
                  and x.data_ptr() % 16 == 0)
        check(libs["old"].matvec_f32(A.data_ptr(), x.data_ptr(),
                                     out.data_ptr(), N, m, n, x.shape[2],
                                     vec, stream()))
        return out

    def old_rmv(A, y):
        if old_current:
            return rmv(libs["old"], A, y)
        N, m, n = A.shape
        K, s = y.shape[2], -(-m // 128)
        out = torch.empty(N, n, K, device=dev)
        part = torch.empty((s, N, n, K) if s > 1 else (0,), device=dev)
        check(libs["old"].rmatvec_f32(A.data_ptr(), y.data_ptr(),
                                      part.data_ptr(), out.data_ptr(), N, m,
                                      n, K, stream()))
        return out

    def mv(lib, A, x):
        N, m, n = A.shape
        K = x.shape[2]
        p = matvec.plan(False, N, m, n, K, A.data_ptr() % 16 == 0,
                        x.data_ptr() % 16 == 0, sms)
        # a variant may own fewer rows a warp: one warp a row fits any
        grid = (p.grid if lib is cur or lib is libs["old"]
                else -(-N * m // matvec.WARPS))
        if p.align_x:
            x = x.clone()
        out = torch.empty(N, m, K, device=dev)
        check(lib.matvec_f32(A.data_ptr(), x.data_ptr(), out.data_ptr(), N,
                             m, n, K, matvec.MATVEC_PATHS.index(p.path),
                             grid, stream()))
        return out

    def rmv(lib, A, y, team=None, per_warp=None):
        N, m, n = A.shape
        K = y.shape[2]
        p = matvec.plan(True, N, m, n, K, True, True, sms)
        team = p.launches == 1 if team is None else team
        items = N * p.slices * -(-n // 128)
        grid = (p.grid if per_warp is None
                else -(-items // (matvec.WARPS * per_warp)))
        out = torch.empty(N, n, K, device=dev)
        part = torch.empty((0,) if team else (p.slices, N, n, K), device=dev)
        check(lib.rmatvec_f32(A.data_ptr(), y.data_ptr(), part.data_ptr(),
                              out.data_ptr(), N, m, n, K,
                              int(p.path == "vec"), int(team), grid,
                              stream()))
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn(8, 800, 10_000, device=dev, generator=g)
    shapes = {"(8, 800, 10000)": W, "(6400, 10000)": W.view(1, 6_400, 10_000),
              "(40000, 4000)": torch.randn(1, 40_000, 4_000, device=dev,
                                           generator=g),
              "(8, 800, 1000)": torch.randn(8, 800, 1_000, device=dev,
                                            generator=g),
              "(2, 200, 2500)": torch.randn(2, 200, 2_500, device=dev,
                                            generator=g),
              "(400, 250)": torch.randn(1, 400, 250, device=dev, generator=g),
              "(2, 3001, 1001)": torch.randn(2, 3_001, 1_001, device=dev,
                                             generator=g)}
    operands = {}
    for label, A in shapes.items():
        N, m, n = A.shape
        operands[label] = {K: (torch.randn(N, n, K, device=dev, generator=g),
                               torch.randn(N, m, K, device=dev, generator=g))
                           for K in (1, 3)}

    # 1. identity
    ident = report["identity"]
    for label, A in shapes.items():
        x, y = operands[label][1]
        ident[f"matvec {label}"] = torch.equal(matvec.matvec(A, x),
                                               old_mv(A, x))
        xs = torch.empty(x.numel() + 4, device=dev)
        xs = xs[1 + (-xs.data_ptr() // 4) % 4:][:x.numel()].view(x.shape)
        xs.copy_(x)
        ident[f"matvec {label}, X past 16 bytes"] = torch.equal(
            matvec.matvec(A, xs), old_mv(A, xs))
        ident[f"matvec {label}, 1-D"] = torch.equal(
            matvec.matvec(A, x[..., 0]), old_mv(A, x)[..., 0])
        ident[f"rmatvec {label}"] = torch.equal(matvec.rmatvec(A, y),
                                                old_rmv(A, y))
        y3 = operands[label][3][1]
        ident[f"rmatvec {label} K=3"] = torch.equal(matvec.rmatvec(A, y3),
                                                    old_rmv(A, y3))
    if args.normal_against:
        def old_normal(A, p, shift):
            a_ = matvec.normal_args(A, p, shift)
            pl = matvec.normal_plan(a_.N, a_.m, a_.n, None,
                                    A.data_ptr() % 16 == 0, sms)
            out = torch.empty(a_.N, a_.n, device=dev)
            part = torch.empty((a_.N, pl.ctas, a_.n) if pl.launches == 2
                               else (0,), device=dev)
            check(libs["normal_old"].normal_matvec_f32(
                A.data_ptr(), p.data_ptr(), a_.shift_ptr, a_.shift_val,
                a_.shift_kind, part.data_ptr(), out.data_ptr(), a_.N, a_.m,
                a_.n, matvec.NM_PATHS.index(pl.path), pl.vpt, pl.rows,
                pl.stages, pl.ctas, stream()))
            return out if A.ndim == 3 else out[0]

        F3 = torch.randn(8, 25_000, 4_000, device=dev, generator=g)
        for label, A in (("(6400, 10000)", W.view(6_400, 10_000)),
                         ("(8, 25000, 4000)", F3),
                         ("(200000, 4000)", F3.view(-1, 4_000)),
                         ("(2, 200, 2500)", shapes["(2, 200, 2500)"]),
                         ("(2, 3001, 1001)", shapes["(2, 3001, 1001)"])):
            n = A.shape[-1]
            p = torch.randn(A.shape[:-2] + (n,), device=dev, generator=g)
            for kind, shift in (("scalar", 4.1), ("0-d", torch.tensor(
                    2.5, device=dev)), ("vector", torch.rand(
                        n, device=dev, generator=g) + 1e-3)):
                ident[f"normal_matvec {label} {kind} shift"] = torch.equal(
                    matvec.normal_matvec(A, p, shift),
                    old_normal(A, p, shift))
        del F3
    same = sum(ident.values())
    print(f"identity: {same} of {len(ident)} bit-identical to the earlier "
          f"kernels" + "".join(f"\n  differs: {k}" for k, v in ident.items()
                               if not v), flush=True)

    if args.identity_only:
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                        exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1)
        return 0 if same == len(ident) else 1

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

    # 2. ab
    for label in ("(8, 800, 10000)", "(6400, 10000)", "(40000, 4000)"):
        A = shapes[label]
        A2 = A if A.shape[0] > 1 else A[0]
        for K in (1, 3):
            x, y = operands[label][K]
            x2, y2 = (x, y) if A.shape[0] > 1 else (x[0], y[0])
            for name, old, new, lib_fn in (
                    ("matvec", old_mv, matvec.matvec,
                     lambda: torch.matmul(A2, x2)),
                    ("rmatvec", old_rmv, matvec.rmatvec,
                     lambda: torch.matmul(A2.mT, y2))):
                v = x if name == "matvec" else y
                report["ab"][f"{name} {label} K={K}"] = turns(
                    f"ab {name} {label} K={K}",
                    [("earlier", lambda: old(A, v)),
                     ("current", lambda: new(A, v)),
                     ("matmul", lib_fn)])

    # 3. plan alternatives
    for label in ("(8, 800, 10000)", "(8, 800, 1000)"):
        A = shapes[label]
        y = operands[label][1][1]
        report["plan"][f"rmatvec one launch {label}"] = turns(
            f"plan rmatvec one launch or sliced {label} K=1",
            [("one launch", lambda: rmv(cur, A, y, team=True)),
             ("sliced", lambda: rmv(cur, A, y, team=False, per_warp=1))])
    for label in ("(6400, 10000)", "(40000, 4000)"):
        A = shapes[label]
        N, m, n = A.shape
        items = N * -(-m // 128) * -(-n // 128)
        wave = -(-items // (matvec.WARPS * matvec.MIN_BLOCKS * sms))
        for K in (1, 3):
            y = operands[label][K][1]
            report["plan"][f"rmatvec sliced grid {label} K={K}"] = turns(
                f"plan rmatvec sliced grid {label} K={K}",
                [("one item a warp", lambda: rmv(cur, A, y, per_warp=1)),
                 (f"one wave, {wave} a warp",
                  lambda: rmv(cur, A, y, per_warp=wave))])

    # 4. variants, each against the source as it is
    for name, what, _ in VARIANTS:
        lib = libs[name]
        rows = {}
        for label, kind, K in (("(8, 800, 10000)", "matvec", 1),
                               ("(8, 800, 10000)", "matvec", 3),
                               ("(40000, 4000)", "matvec", 3),
                               ("(8, 800, 10000)", "rmatvec", 1),
                               ("(6400, 10000)", "rmatvec", 1),
                               ("(40000, 4000)", "rmatvec", 1)):
            A = shapes[label]
            x, y = operands[label][K]
            f = mv if kind == "matvec" else rmv
            v = x if kind == "matvec" else y
            if not torch.equal(f(lib, A, v), f(cur, A, v)) and K == 1:
                raise SystemExit(f"FAIL: variant {name} changed a K = 1 sum")
            rows[f"{kind} {label} K={K}"] = turns(
                f"variant {name} ({what}): {kind} {label} K={K}",
                [("as it is", lambda: f(cur, A, v)),
                 (name, lambda: f(lib, A, v))])
        report["variants"][name] = rows

    # 5. the sliced rmatvec's two kernels
    from torch.profiler import ProfilerActivity, profile
    for label in ("(6400, 10000)", "(40000, 4000)"):
        A = shapes[label]
        for K in (1, 3):
            y = operands[label][K][1]
            for _ in range(3):
                matvec.rmatvec(A, y)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    matvec.rmatvec(A, y)
                torch.cuda.synchronize()
            us = {ev.key.split("::")[-1].split("<")[0].split("(")[0]:
                  ev.self_device_time_total / ev.count
                  for ev in prof.key_averages()
                  if ev.count >= 10 and "slices" in ev.key}
            report["slices"][f"{label} K={K}"] = us
            print(f"  slices {label} K={K}: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in us.items()), flush=True)

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if same == len(ident) else 1


if __name__ == "__main__":
    sys.exit(main())
