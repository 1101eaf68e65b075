#!/usr/bin/env python3
"""Card probe of ``csrc/block_matvec.cu`` and of the collectives the sharded
engine issues, on one NVIDIA GPU.

    python3 tools/block_matvec_probe.py [--against OLD.cu] [--variants]
        [--trace] [--collectives] [--report PATH]

* Every instantiation (f32, bf16, fp16) of ``block_matvec`` and
  ``block_rmatvec`` against its plain version (``kernels/ref.py``) at the
  sharded engine's per-rank shape (1, 25,000, 1,000) with K = 1 and 3,
  sharded_fp16's one-node block (1, 25,000, 4,000), the Fig. 3 point
  (8, 25,000, 4,000) with M = 4, the ragged (2, 3,000, 1,001) (the scalar
  route) and an odd-n view one element past 16 bytes; the bound is
  f32-accumulation error <= 1e-5 x scale + 1e-6, and two calls must agree
  bit for bit. Each timed as chip_smoke times a kernel (CUDA-graph
  replays), beside its bound, the plan (``block_plan``) and, where the
  blocks tile A, ``torch.matmul`` on the (N, M, m, nb) view.
* ``--against OLD.cu``: an earlier ``block_matvec.cu`` with the bf16 / f16
  entries and the ``V`` argument of commit b6a3c37 (``git show
  b6a3c37:src/repro_torch/csrc/block_matvec.cu``); the f32 instantiations
  must equal its kernels bit for bit at every shape above, and every
  instantiation is timed against its old one in turns (new, old, old, new)
  in this call.
* ``--variants``: the bf16 stream kernel through its C entry at other tile
  rows and rings than the plan's, at the path shapes, beside ``matmul`` on
  the half-width view, then the plan's choice over m at n = 1,000 and 4,000
  (a line through the times: its slope the streaming rate, its intercept
  the fixed cost of a call); ``--only-variants`` skips the rest.
* ``--trace``: the source built with ``-DBLOCK_STREAM_TRACE`` at the path
  shapes: the cycles of each tile's phases (wait, work, release) of
  consumer warps 0 and 1 of CTA 0, and every CTA's %globaltimer at its
  entry, first copy, first tile, loop end, last copy and result (min,
  median, max over the CTAs).
* ``--collectives``: two spawned ranks on a gloo group of the same card run
  ``all_reduce`` (SUM, MAX) and ``all_gather_into_tensor`` on CUDA tensors
  through the DeviceMesh groups the engine uses, on a mesh of device type
  "cuda" and one of "cpu", and time each.

Needs a card and ``nvcc``; imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..")]

P, I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"block_rmatvec_slices": [I, I, I, I, I]}
for _sfx in ("f32", "bf16", "f16"):
    OLD_SIGNATURES[f"block_matvec_{_sfx}"] = [P, P, P, I, I, I, I, I, I, P]
    OLD_SIGNATURES[f"block_rmatvec_{_sfx}"] = [P, P, P, P, I, I, I, I, I, I,
                                               I, P]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def collective_rank(rank: int, world: int, port: int, mesh_type: str,
                    queue) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(mesh_type, (1, world),
                                mesh_dim_names=("nodes", "feat"))
        g = mesh.get_group("feat")
        dev = torch.device("cuda")
        out = {"mesh_type": mesh_type, "rank": rank}
        x = torch.full((256,), float(rank + 1), device=dev)
        dist.all_reduce(x, group=g)
        out["sum_ok"] = bool((x == world * (world + 1) / 2).all())
        y = torch.tensor([float(rank)], device=dev)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
        out["max_ok"] = float(y) == world - 1
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        src = torch.arange(6, dtype=torch.float32, device=dev) + 10 * rank
        dst = torch.empty(6 * world, device=dev)
        gather(dst, src, group=g)
        want = torch.cat([torch.arange(6, dtype=torch.float32) + 10 * r
                          for r in range(world)])
        out["gather_ok"] = bool(torch.equal(dst.cpu(), want))
        for size in (2, 256, 25_000):
            z = torch.zeros(size, device=dev)
            for _ in range(5):
                dist.all_reduce(z, group=g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                dist.all_reduce(z, group=g)
            torch.cuda.synchronize()
            out[f"all_reduce_{size}_ms"] = (time.perf_counter() - t0) * 10
        queue.put(out)
    finally:
        dist.destroy_process_group()


def collectives() -> list:
    import socket
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = []
    for mesh_type in ("cuda", "cpu"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        queue = ctx.Queue()
        mp.spawn(collective_rank, args=(2, port, mesh_type, queue),
                 nprocs=2)
        results += [queue.get() for _ in range(2)]
    return results


def compile_lib(build, source, tag, flags, bm):
    """``source`` built like the package's library, with ``flags``."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libblock_matvec_{tag}.so"
    proc = subprocess.run(
        [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         *flags, "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o",
         str(lib_path), source], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"FAIL: nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in bm._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# the stamps' phases: a consumer warp waits for the stage, does its work on
# the tile (block_matvec: its items' dot products and outputs;
# block_rmatvec: its rows' column sums), then releases the stage
PHASES = ("wait", "work", "release")
# the CTA stamps (%globaltimer, every CTA): min, median, max over the CTAs,
# in us from the first CTA's entry
CTA_POINTS = ("entry", "first_copy", "first_tile", "loop_done",
              "producer_done", "result")


def ring_fits(bm, plan, adjoint, n, mb, rows, stages) -> bool:
    """Whether the stream entry takes this ring (its checks, in bytes)."""
    a = -(-rows * n * 2 // 16) * 16
    if adjoint:
        return stages * (a + -(-rows * mb * plan.kc * 4 // 16) * 16) \
            <= bm.RING_BYTES
    x = 0 if plan.vpt else -(-4 * n * plan.kc // 16) * 16
    return x + stages * a <= bm.RING_BYTES


def rows_around(plan, adjoint) -> list:
    """The plan's tile rows and its neighbours the kernel takes."""
    if adjoint:
        return [plan.groups * rg for rg in (1, 2, 4)]
    return sorted({max(1, plan.rows // 4), max(1, plan.rows // 2),
                   plan.rows, 2 * plan.rows})


def trace(torch, bm, build, dev, g) -> list:
    """Cycles of each phase of each tile of CTA 0 (lane 0 of consumer warps
    0 and 1), medians over the tiles, at the plan and at other tile rows
    and rings."""
    import statistics
    lib = compile_lib(build, str(build.CSRC / "block_matvec.cu"), "trace",
                      ["-DBLOCK_STREAM_TRACE"], bm)
    lib.block_stream_trace.argtypes = [ctypes.c_void_p]
    lib.block_stream_trace.restype = ctypes.c_int
    lib.block_stream_trace_ctas.argtypes = [ctypes.c_void_p]
    lib.block_stream_trace_ctas.restype = ctypes.c_int
    times = torch.zeros(1024 * len(CTA_POINTS), dtype=torch.int64)
    clocks = torch.zeros(2 * 1024 * (len(PHASES) + 1), dtype=torch.int64)
    out_rows = []
    for label, (N, m, n, M) in (("rank", (1, 25_000, 1_000, 1)),
                                ("node", (1, 25_000, 4_000, 1)),
                                ("fig3", (8, 25_000, 4_000, 4))):
        a = torch.randn(N, m, n, device=dev, generator=g).bfloat16()
        nb = -(-n // M)
        mb = -(-(n // 8) // (nb // 8))
        for adjoint in (False, True):
            v = torch.randn(N, M, m if adjoint else nb, 1, device=dev,
                            generator=g)
            plan = bm.plan_for(a, M, 1, adjoint=adjoint)
            for rows in (plan.rows,):
                for stages in sorted({2, plan.stages}):
                    if not ring_fits(bm, plan, adjoint, n, mb, rows, stages):
                        continue
                    ctas = min(plan.ctas, -(-m // rows))
                    outp = torch.empty((N, M, nb if adjoint else m, 1),
                                       device=dev)
                    part = torch.empty((N, ctas, M, nb, 1), device=dev)
                    for _ in range(3):
                        rc = lib.block_stream_bf16(
                            a.data_ptr(), v.data_ptr(), part.data_ptr(),
                            outp.data_ptr(), N, M, m, n, nb, 1,
                            int(adjoint), rows, stages, plan.wb,
                            plan.groups, plan.vpt, plan.kc, ctas,
                            torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise SystemExit(f"FAIL: trace: CUDA error {rc}")
                    lib.block_stream_trace(clocks.data_ptr())   # reset
                    lib.block_stream_trace_ctas(times.data_ptr())
                    rc = lib.block_stream_bf16(
                        a.data_ptr(), v.data_ptr(), part.data_ptr(),
                        outp.data_ptr(), N, M, m, n, nb, 1, int(adjoint),
                        rows, stages, plan.wb, plan.groups, plan.vpt,
                        plan.kc, ctas, torch.cuda.current_stream().cuda_stream)
                    nt = lib.block_stream_trace(clocks.data_ptr())
                    if lib.block_stream_trace_ctas(times.data_ptr()):
                        raise SystemExit("FAIL: trace: CTA stamps")
                    if rc or nt < 0:
                        raise SystemExit(f"FAIL: trace: CUDA error {rc}")
                    c = clocks.view(2, 1024, len(PHASES) + 1)[:, :min(nt, 1024)]
                    row = {"shape": f"{label} {(N, m, n)} M={M}",
                           "kernel": "block_rmatvec" if adjoint
                           else "block_matvec", "rows": rows,
                           "stages": stages, "tiles": nt}
                    for w in (0, 1):
                        cw = c[w][c[w][:, 0] != 0]   # the tiles it took
                        if len(cw) < 4:
                            continue
                        d = {ph: statistics.median(
                                 (cw[1:-1, i + 1] - cw[1:-1, i]).tolist())
                             for i, ph in enumerate(PHASES)}
                        d["tile"] = statistics.median(
                            (cw[2:-1, 0] - cw[1:-2, 0]).tolist())
                        d["tiles_taken"] = len(cw)
                        d["first_wait"] = int(cw[0, 1] - cw[0, 0])
                        d["all"] = int(cw[-1, -1] - cw[0, 0])
                        row[f"warp{w}"] = d
                    ct = times.view(1024, len(CTA_POINTS))[:N * ctas]
                    t0 = int(ct[:, 0].min())
                    row["cta_us"] = {
                        name: [round((float(x) - t0) / 1e3, 2) for x in (
                            col.min(), col.median(), col.max())]
                        for name, col in ((nm, ct[:, i][ct[:, i] > 0])
                                          for i, nm in enumerate(CTA_POINTS))
                        if len(col)}
                    print(json.dumps(row), flush=True)
                    out_rows.append(row)
        del a
    return out_rows


def variants(torch, bm, lib, cs, dev, g) -> list:
    """The bf16 stream kernel through its C entry at every (rows a group,
    stages, CTAs) around the plan's at the path shapes, beside matmul on
    the half-width view; then the plan's choice over m at n = 1,000 and
    4,000 (a line through the times: its slope is the streaming rate, its
    intercept the fixed cost of a call)."""
    rows_out = []

    def call(lib, a, v, M, adjoint, plan, rows, stages, ctas):
        N, m, n = a.shape
        nb, K = -(-n // M), v.shape[3]
        out = torch.empty((N, M, nb if adjoint else m, K), device=dev)
        part = torch.empty((N, ctas, M, nb, K) if adjoint and ctas > 1
                           else (0,), device=dev)
        rc = lib.block_stream_bf16(
            a.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(), N,
            M, m, n, nb, K, int(adjoint), rows, stages, plan.wb, plan.groups,
            plan.vpt, plan.kc, ctas, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"FAIL: variant: CUDA error {rc}")
        return out

    def yard(a, v, M, adjoint):
        N, m, n = a.shape
        view = a.view(N, m, M, n // M).transpose(1, 2)
        vh = v.to(a.dtype)
        return cs.graph_ms(torch, lambda: torch.matmul(
            view.mT if adjoint else view, vh))

    for label, (N, m, n, M), K in (("rank", (1, 25_000, 1_000, 1), 1),
                                   ("node", (1, 25_000, 4_000, 1), 1),
                                   ("fig3", (8, 25_000, 4_000, 4), 1)):
        a = torch.randn(N, m, n, device=dev, generator=g).bfloat16()
        nb = -(-n // M)
        for adjoint in (False, True):
            v = torch.randn(N, M, m if adjoint else nb, K, device=dev,
                            generator=g)
            plan = bm.plan_for(a, M, K, adjoint=adjoint)
            mb = -(-(n // 8) // (nb // 8))
            plain = bm.block_rmatvec_ref if adjoint else bm.block_matvec_ref
            want = plain(a, v, M)
            lim = 1e-5 * float(plain(a.float().abs(), v.abs(), M).max()) \
                + 1e-6
            times = {}
            for rows in rows_around(plan, adjoint):
                for stages in (2, 3, 4, 6, 8, 10, 12, 16):
                    if not ring_fits(bm, plan, adjoint, n, mb, rows,
                                     stages):
                        continue
                    ctas = min(plan.ctas, -(-m // rows))
                    got = call(lib, a, v, M, adjoint, plan, rows, stages,
                               ctas)
                    err = float((got - want).abs().max())
                    if not err <= lim:
                        raise SystemExit(f"FAIL: {label} rows "
                                         f"{rows} stages {stages}: err "
                                         f"{err}")
                    times[f"rows {rows} stages {stages}"] = cs.graph_ms(
                        torch, lambda: call(lib, a, v, M, adjoint, plan,
                                            rows, stages, ctas))
            best = min(times, key=times.get)
            row = {"shape": f"{label} {(N, m, n)} M={M} K={K}",
                   "kernel": "block_rmatvec" if adjoint
                   else "block_matvec", "plan": plan._asdict(),
                   "library_ms": yard(a, v, M, adjoint), "best": best,
                   "times": times}
            print(f"{row['shape']:34s} {row['kernel']:14s} "
                  f"lib {row['library_ms']:.4f} best {best} "
                  f"{times[best]:.4f} | " + " ".join(
                      f"{k.split()[1]}/{k.split()[3]}:{t * 1e3:.1f}"
                      for k, t in times.items()), flush=True)
            rows_out.append(row)
        del a
    for n in (1_000, 4_000):
        for m in (528, 2_112, 6_250, 12_500, 25_000, 50_000, 100_000):
            a = torch.randn(1, m, n, device=dev, generator=g).bfloat16()
            for adjoint in (False, True):
                v = torch.randn(1, 1, m if adjoint else n, 1, device=dev,
                                generator=g)
                fn = bm.block_rmatvec if adjoint else bm.block_matvec
                row = {"shape": f"scaling (1, {m}, {n})",
                       "kernel": fn.__name__, "mb": 2 * m * n / 1e6,
                       "ms": cs.graph_ms(torch, lambda: fn(a, v, 1)),
                       "library_ms": yard(a, v, 1, adjoint)}
                print(json.dumps(row), flush=True)
                rows_out.append(row)
            del a
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="an earlier block_matvec.cu")
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="time the stream kernel at other tiles, rings and "
                         "CTA counts than the plan's, and over m")
    ap.add_argument("--only-variants", action="store_true",
                    help="--variants without the checks and timings above")
    ap.add_argument("--trace", action="store_true",
                    help="stamp the stream kernel's phases (a build with "
                         "-DBLOCK_STREAM_TRACE) at the path shapes")
    ap.add_argument("--report", help="write the results to PATH as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import block_matvec as bm
    from repro_torch.kernels import build, ref

    report = {"nvidia_smi": smi(), "rows": [], "identity": {}}
    print(report["nvidia_smi"], flush=True)
    dev = torch.device("cuda")
    cur = build.library("block_matvec", bm._SIGNATURES)
    old = None
    if args.against:
        out_dir = build.BUILD_DIR / "probe"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / "libblock_matvec_old.so"
        proc = subprocess.run(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o",
             str(lib_path), os.path.abspath(args.against)],
            capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"FAIL: nvcc old:\n{proc.stdout}{proc.stderr}")
        old = ctypes.CDLL(str(lib_path))
        for fn, argtypes in OLD_SIGNATURES.items():
            getattr(old, fn).argtypes = argtypes
            getattr(old, fn).restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_call(a, v, M, adjoint):
        """The earlier kernels: 8 columns a thread for block_rmatvec on aligned
        2-byte A with n and nb multiples of 8 (its rmatvec_columns)."""
        N, m, n = a.shape
        nb, K = -(-n // M), v.shape[3]
        sfx = bm.SUFFIX[a.dtype]
        if adjoint:
            cols = 8 if (a.element_size() == 2 and n % 8 == 0
                         and nb % 8 == 0 and a.data_ptr() % 16 == 0) else 1
            slices = old.block_rmatvec_slices(N, M, m, nb, cols)
            part = torch.empty((slices, N, M, nb, K) if slices > 1 else (0,),
                               device=dev)
            out = torch.empty((N, M, nb, K), device=dev)
            rc = getattr(old, f"block_rmatvec_{sfx}")(
                a.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(),
                N, M, m, n, nb, K, cols, stream())
        else:
            out = torch.empty((N, M, m, K), device=dev)
            rc = getattr(old, f"block_matvec_{sfx}")(
                a.data_ptr(), v.data_ptr(), out.data_ptr(), N, M, m, n, nb,
                K, stream())
        if rc:
            raise SystemExit(f"FAIL: old kernel: CUDA error {rc}")
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    if args.variants or args.only_variants:
        report["variants"] = variants(torch, bm, cur, cs, dev, g)
    if args.trace:
        report["trace"] = trace(torch, bm, build, dev, g)
    if args.only_variants or (args.trace and not args.variants
                              and not args.against):
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    base = torch.randn(8, 25_000, 4_000, device=dev, generator=g)
    ragged = torch.randn(2, 3_000, 1_001, device=dev, generator=g)
    shapes = [("rank (1, 25000, 1000)", base[0, :, :1_000].contiguous()[None],
               1, (1, 3)),
              ("node (1, 25000, 4000)", base[:1], 1, (1,)),
              ("fig3 (8, 25000, 4000)", base, 4, (1,)),
              ("ragged (2, 3000, 1001)", ragged, 4, (1, 3))]
    failed = []
    for label, A32, M, Ks in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            Aa = A32 if dt == torch.float32 else A32.to(dt)
            N, m, n = Aa.shape
            nb = -(-n // M)
            absA = Aa.float().abs()
            view = (Aa.view(N, m, M, nb).transpose(1, 2) if n == M * nb
                    else None)
            for K in Ks:
                x = torch.randn(N, M, nb, K, device=dev, generator=g)
                y = torch.randn(N, M, m, K, device=dev, generator=g)
                for adjoint, v in ((False, x), (True, y)):
                    fn = bm.block_rmatvec if adjoint else bm.block_matvec
                    plain = (ref.block_rmatvec_ref if adjoint
                             else ref.block_matvec_ref)
                    got, want = fn(Aa, v, M), plain(Aa, v, M)
                    scale = float(plain(absA, v.abs(), M).max())
                    err = float((got - want).abs().max())
                    lim = 1e-5 * scale + 1e-6
                    name = (f"{'block_rmatvec' if adjoint else 'block_matvec'}"
                            f" {label} {str(dt)[6:]} K={K}")
                    bnd = cs.bound(Aa.numel() * Aa.element_size()
                                   + 4 * (v.numel() + got.numel()),
                                   2 * Aa.numel() * K)[0]
                    plan = bm.plan_for(Aa, M, K, adjoint=adjoint)
                    row = {"name": name, "plan": plan._asdict(),
                           "max_abs_err": err, "limit": lim,
                           "ms": cs.graph_ms(torch, lambda: fn(Aa, v, M)),
                           "bound_ms": bnd}
                    if view is not None:
                        vh = v.to(dt)
                        row["library_ms"] = cs.graph_ms(
                            torch, lambda: torch.matmul(
                                view.mT if adjoint else view, vh))
                    if not torch.equal(fn(Aa, v, M), got):
                        failed.append(f"{name}: two calls differ")
                    if old is not None:
                        prev = old_call(Aa, v, M, adjoint)
                        if dt == torch.float32:
                            same = torch.equal(got, prev)
                            report["identity"][name] = same
                            if not same:
                                failed.append(f"{name}: not bit for bit the "
                                              "old kernel")
                        row["old_max_abs_err"] = float(
                            (prev - want).abs().max())
                        row["old_ms"] = cs.graph_ms(
                            torch, lambda: old_call(Aa, v, M, adjoint))
                        row["old_ms_again"] = cs.graph_ms(
                            torch, lambda: old_call(Aa, v, M, adjoint))
                        row["ms_again"] = cs.graph_ms(
                            torch, lambda: fn(Aa, v, M))
                    if err > lim:
                        failed.append(f"{name}: err {err:.3e} > {lim:.3e}")
                    print(json.dumps(row), flush=True)
                    report["rows"].append(row)
            del absA, view
    # an odd-n view one element past 16 bytes: the scalar paths
    for dt in (torch.bfloat16, torch.float16):
        Ao = torch.randn(2 * 3_001 * 1_001 + 1, device=dev,
                         generator=g).to(dt)[1:].view(2, 3_001, 1_001)
        x = torch.randn(2, 4, 251, 1, device=dev, generator=g)
        y = torch.randn(2, 4, 3_001, 1, device=dev, generator=g)
        for fn, plain, v in ((bm.block_matvec, ref.block_matvec_ref, x),
                             (bm.block_rmatvec, ref.block_rmatvec_ref, y)):
            err = float((fn(Ao, v, 4) - plain(Ao, v, 4)).abs().max())
            scale = float(plain(Ao.float().abs(), v.abs(), 4).max())
            if err > 1e-5 * scale + 1e-6:
                failed.append(f"{fn.__name__} odd view {dt}: err {err:.3e}")
            report["rows"].append({"name": f"{fn.__name__} odd view {dt}",
                                   "max_abs_err": err})
    if args.collectives:
        report["collectives"] = collectives()
        for r in report["collectives"]:
            print(json.dumps(r), flush=True)
            if not (r["sum_ok"] and r["max_ok"] and r["gather_ok"]):
                failed.append(f"collectives on a {r['mesh_type']} mesh: {r}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if failed:
        print("FAIL:\n" + "\n".join(failed), flush=True)
        return 1
    print(json.dumps({"ok": True, "identity": report["identity"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
