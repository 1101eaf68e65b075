#!/usr/bin/env python3
"""Card probe of ``csrc/block_matvec.cu`` and of the collectives the sharded
engine issues, on one NVIDIA GPU.

    python3 tools/block_matvec_probe.py [--against OLD.cu] [--collectives]

* Every instantiation (f32, bf16, fp16) of ``block_matvec`` and
  ``block_rmatvec`` against its plain version (``kernels/ref.py``) at the
  sharded engine's per-rank shape (1, 25,000, 1,000) with K = 1 and 3, the
  Fig. 3 point (8, 25,000, 4,000) with M = 4, the ragged (2, 3,000, 1,001)
  (the scalar paths) and an odd-n view one element past 16 bytes; the
  bound is f32-accumulation error <= 1e-5 x scale + 1e-6. Each timed as
  chip_smoke times a kernel (CUDA-graph replays), beside its bound.
* ``--against OLD.cu``: an earlier ``block_matvec.cu`` with the f32-only C
  interface (``git show <commit>:src/repro_torch/csrc/block_matvec.cu``);
  the f32 instantiations must equal its kernels bit for bit at every shape
  above, and both are timed in turns.
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
OLD_SIGNATURES = {
    "block_matvec_f32": [P, P, P, I, I, I, I, I, I, P],
    "block_rmatvec_f32": [P, P, P, P, I, I, I, I, I, I, P],
    "block_rmatvec_slices": [I, I, I, I],
}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="an earlier block_matvec.cu")
    ap.add_argument("--collectives", action="store_true")
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
        N, m, n = a.shape
        nb, K = -(-n // M), v.shape[3]
        if adjoint:
            slices = old.block_rmatvec_slices(N, M, m, nb)
            part = torch.empty((slices, N, M, nb, K) if slices > 1 else (0,),
                               device=dev)
            out = torch.empty((N, M, nb, K), device=dev)
            rc = old.block_rmatvec_f32(a.data_ptr(), v.data_ptr(),
                                       part.data_ptr(), out.data_ptr(), N, M,
                                       m, n, nb, K, stream())
        else:
            out = torch.empty((N, M, m, K), device=dev)
            rc = old.block_matvec_f32(a.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), N, M, m, n, nb, K,
                                      stream())
        if rc:
            raise SystemExit(f"FAIL: old kernel: CUDA error {rc}")
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn(8, 25_000, 4_000, device=dev, generator=g)
    ragged = torch.randn(2, 3_000, 1_001, device=dev, generator=g)
    shapes = [("rank (1, 25000, 1000)", base[0, :, :1_000].contiguous()[None],
               1, (1, 3)),
              ("fig3 (8, 25000, 4000)", base, 4, (1,)),
              ("ragged (2, 3000, 1001)", ragged, 4, (1, 3))]
    failed = []
    for label, A32, M, Ks in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            Aa = A32 if dt == torch.float32 else A32.to(dt)
            N, m, n = Aa.shape
            nb = -(-n // M)
            absA = Aa.float().abs()
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
                    row = {"name": name, "max_abs_err": err, "limit": lim,
                           "ms": cs.graph_ms(torch, lambda: fn(Aa, v, M)),
                           "bound_ms": bnd}
                    if dt == torch.float32 and old is not None:
                        same = torch.equal(got, old_call(Aa, v, M, adjoint))
                        report["identity"][name] = same
                        row["old_ms"] = cs.graph_ms(
                            torch, lambda: old_call(Aa, v, M, adjoint))
                        row["ms_again"] = cs.graph_ms(
                            torch, lambda: fn(Aa, v, M))
                        if not same:
                            failed.append(f"{name}: not bit for bit the old "
                                          "kernel")
                    if err > lim:
                        failed.append(f"{name}: err {err:.3e} > {lim:.3e}")
                    print(json.dumps(row), flush=True)
                    report["rows"].append(row)
            del absA
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
