#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line with its wall time:

1. device   — a CUDA device or fail; the card's name and power limit as
              ``nvidia-smi`` reports them.
2. build    — the kernels of ``src/repro_torch/csrc`` with nvcc, one
              compiler per source, all started together.
3. kernels  — every kernel against its plain PyTorch version on the card,
              at the solver path's shapes and at ragged ones; for each, the
              kernel's device time, the plain version's, one PyTorch library
              call computing the same function (a yardstick the port never
              calls) and the bound from bytes and operations. Device times
              replay the calls from a CUDA graph, so the host's share of a
              call is left out; the eager time of one call, host included,
              is printed beside them.
4. woodbury — the paper's Fig. 2 largest point at full width (N = 8 nodes,
              m = 800 rows each, n = 10,000 features, kappa = 2,000) through
              ``SparseLinearRegression.fit`` on the card; the x-update must
              take the Woodbury backend and every kernel must launch.
5. dense    — Fig. 2's smallest point (n = 1,000, kappa = 200) through the
              dense factorization and the dense polish.
6. parity   — a reduced fit on the card against the port's own CPU fit.

Before the last line it prints one ``{"kernels": [...]}`` JSON line; the last
line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result; so does a machine with no CUDA device. With
``--report PATH`` the fuller details (ptxas reports, every kernel check, the
profiler's table) are written to PATH as JSON. It imports neither ``jax``
nor ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
RTOL = 1e-4          # the JAX package's f32 kernel bound (rtol 1e-4,
ATOL_PER_SCALE = 1e-5  # atol 1e-5 per unit of summed magnitude)

REPLACES = {
    "ladder_stats": "src/repro/kernels/bisect_proj.py:42",
    "gram": "src/repro/kernels/gram.py:35",
    "matvec": "src/repro/kernels/matvec.py:95",
    "rmatvec": "src/repro/kernels/matvec.py:135",
}
SOURCES = {
    "ladder_stats": "src/repro_torch/csrc/ladder_stats.cu",
    "gram": "src/repro_torch/csrc/gram.cu",
    "matvec": "src/repro_torch/csrc/matvec.cu",
    "rmatvec": "src/repro_torch/csrc/matvec.cu",
}


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def phase(name: str, t0: float, text: str) -> None:
    print(f"[{name}] {text} ({time.perf_counter() - t0:.2f} s)", flush=True)


def graph_ms(torch, fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call without the host's share: ``inner`` calls
    captured in a CUDA graph, replays timed with CUDA events, the median
    replay divided by ``inner``."""
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
    return cuda_ms(torch, graph.replay, reps=reps) / inner


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one eager call, host share included (CUDA events
    around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(torch, name, got, want, scale) -> float:
    err = float((got - want).abs().max())
    atol = ATOL_PER_SCALE * float(scale)
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=atol))
    require(ok, f"{name}: kernel disagrees with its plain version "
                f"(max abs err {err:.3e}, rtol {RTOL}, atol {atol:.3e})")
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", metavar="PATH",
                        help="write the full report to PATH as JSON")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import api
    from repro_torch.core.results import SolveStatus
    from repro_torch.data import SyntheticSpec, make_sparse_regression
    from repro_torch.kernels import bisect_proj, build, gram, matvec, ops, ref

    report: dict = {}
    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase("device", t0, f"{kind}; torch {torch.__version__}, "
                        f"CUDA {torch.version.cuda}")
    report["nvidia_smi"] = smi

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    report["build"] = info
    built = []
    for k, v in info.items():
        built.append(f"{k} (cached)" if v["cached"]
                     else f"{k} ({v['seconds']:.1f} s)")
    phase("build", t0, "built " + ", ".join(built))

    # data of the two Fig. 2 points (numpy generator, seed 0) --------------
    t0 = time.perf_counter()
    wide = SyntheticSpec(8, 800, 10_000, sparsity_level=0.8)
    narrow = SyntheticSpec(8, 800, 1_000, sparsity_level=0.8)
    As_w, bs_w, xt_w = make_sparse_regression(0, wide)
    As_n, bs_n, xt_n = make_sparse_regression(0, narrow)
    A = torch.as_tensor(As_w, device=dev)
    An = torch.as_tensor(As_n, device=dev)
    phase("data", t0, f"As {tuple(As_w.shape)} and {tuple(As_n.shape)} f32 "
                      "on the card")

    # 3. kernels against their plain versions ------------------------------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    N, m, n = A.shape
    A_all = A.reshape(N * m, n)
    rows = {}

    def kernel_row(name, label, fn, plain, library, got_want_scale,
                   nbytes, flops):
        err = check_close(torch, label, *got_want_scale)
        bnd, by = bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "shape": label,
               "max_abs_err": err, "ms": graph_ms(torch, fn),
               "plain_ms": graph_ms(torch, plain),
               "bound_ms": bnd, "bound_by": by,
               "library_ms": (None if library is None
                              else graph_ms(torch, library)),
               "call_ms": cuda_ms(torch, fn)}
        lib_ms = row["library_ms"]
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {label}: kernel {row['ms']:.4f} ms (eager call "
              f"{row['call_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
              f"library {lib_txt}, bound {bnd:.4f} ms ({by}), max abs err "
              f"{err:.3e}", flush=True)
        rows.setdefault(name, row)      # the first row is the path's shape
        report.setdefault("kernel_checks", []).append(row)

    # ladder_stats: one bracketing round of a projection at n = 10,000
    for nn, B in ((10_000, 128), (10_001, 7)):
        az = torch.rand(nn, device=dev, generator=g)
        th = torch.sort(torch.rand(B, device=dev, generator=g)).values
        want = ref.ladder_stats_ref(az, th)
        got = bisect_proj.ladder_stats(az, th)
        require(torch.equal(got[1], want[1]), "ladder_stats counts differ")
        kernel_row("ladder_stats", f"ladder_stats n={nn} B={B}",
                   lambda az=az, th=th: bisect_proj.ladder_stats(az, th),
                   lambda az=az, th=th: ref.ladder_stats_ref(az, th), None,
                   (got[0], want[0], float(az.sum())),
                   4 * (nn + B) + 8 * B, 4 * nn * B)

    # gram: A A^T of the Woodbury setup, A^T A of the dense setup
    for label, X in ((f"gram A A^T {tuple(A.shape)}", A.mT),
                     (f"gram A^T A {tuple(An.shape)}", An)):
        nb, mm, nx = X.shape
        got, want = gram.gram(X), ref.gram_ref(X)
        scale = float((ref.gram_ref(X.abs())).max())
        kernel_row("gram", label, lambda X=X: gram.gram(X),
                   lambda X=X: ref.gram_ref(X),
                   lambda X=X: torch.matmul(X.mT, X), (got, want, scale),
                   4 * nb * mm * nx + 4 * nb * nx * nx, 2 * nb * nx * nx * mm)

    # matvec / rmatvec: per node (Woodbury prox) and stacked (polish)
    for Aa in (A, A_all):
        label_a = str(tuple(Aa.shape))
        lead = Aa.shape[:-2]
        mm, nn = Aa.shape[-2:]
        na = math.prod(lead)
        for K in (1, 3):
            x = torch.randn(*lead, nn, *((K,) if K > 1 else ()), device=dev,
                            generator=g)
            y = torch.randn(*lead, mm, *((K,) if K > 1 else ()), device=dev,
                            generator=g)
            xk, yk = (x, y) if K > 1 else (x[..., None], y[..., None])
            got, want = matvec.matvec(Aa, x), ref.matvec_ref(Aa, x)
            scale = float((Aa.abs() @ xk.abs()).max())
            kernel_row("matvec", f"matvec {label_a} K={K}",
                       lambda Aa=Aa, x=x: matvec.matvec(Aa, x),
                       lambda Aa=Aa, x=x: ref.matvec_ref(Aa, x),
                       lambda Aa=Aa, xk=xk: torch.matmul(Aa, xk),
                       (got, want, scale),
                       4 * (na * mm * nn + na * nn * K + na * mm * K),
                       2 * na * mm * nn * K)
            got, want = matvec.rmatvec(Aa, y), ref.rmatvec_ref(Aa, y)
            scale = float((Aa.abs().mT @ yk.abs()).max())
            kernel_row("rmatvec", f"rmatvec {label_a} K={K}",
                       lambda Aa=Aa, y=y: matvec.rmatvec(Aa, y),
                       lambda Aa=Aa, y=y: ref.rmatvec_ref(Aa, y),
                       lambda Aa=Aa, yk=yk: torch.matmul(Aa.mT, yk),
                       (got, want, scale),
                       4 * (na * mm * nn + na * nn * K + na * mm * K),
                       2 * na * mm * nn * K)
    # normal_matvec (the PCG polish's product) = the two kernels composed
    p = torch.randn(n, device=dev, generator=g)
    shift = torch.rand(n, device=dev, generator=g) + 1e-3
    got = matvec.normal_matvec(A_all, p, shift)
    want = ref.normal_matvec_ref(A_all, p, shift)
    scale = float((A_all.abs().mT @ (A_all.abs() @ p.abs())).max())
    err = check_close(torch, "normal_matvec", got, want, scale)
    nm_ms = cuda_ms(torch, lambda: matvec.normal_matvec(A_all, p, shift))
    print(f"  normal_matvec {tuple(A_all.shape)}: {nm_ms:.4f} ms (matvec + "
          f"rmatvec), max abs err {err:.3e}", flush=True)
    report["normal_matvec_ms"] = nm_ms
    phase("kernels", t0, "every kernel agrees with its plain version "
                         f"(rtol {RTOL}, atol {ATOL_PER_SCALE} x scale)")

    def support_f1(est, x_true) -> float:
        got = est.support_.cpu().numpy()
        true = x_true != 0
        tp = float((got & true).sum())
        return 2 * tp / max(float(got.sum() + true.sum()), 1.0)

    def fit_phase(name, As, bs, x_true, kappa, backend, needed):
        t_ph = time.perf_counter()
        est = api.SparseLinearRegression(kappa=kappa, gamma=10.0, rho_c=4.0,
                                         max_iter=60, tol=0.0)
        require(est.device.type == "cuda", f"{name}: estimator not on cuda")
        Nn, mm, nn = As.shape
        kind_ = est._adapter.solver._x_engine(mm, nn).kind
        require(kind_ == backend, f"{name}: x-update took {kind_}, "
                                  f"expected {backend}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_fit = time.perf_counter()
        est.fit(As, bs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_fit
        counts = ops.launch_counts()
        res = est.result_
        for k_name in needed:
            require(counts[k_name] > 0, f"{name}: kernel {k_name} was not "
                                        "launched on the path")
        require(bool(torch.isfinite(res.z).all())
                and bool(torch.isfinite(res.coef).all()),
                f"{name}: non-finite iterates")
        status = SolveStatus(int(res.status))
        require(status != SolveStatus.DIVERGED, f"{name}: DIVERGED")
        iters = int(res.iters)
        r2 = est.score(As, bs)
        f1 = support_f1(est, x_true)
        out = {"x_solver": kind_, "iters": iters, "status": status.name,
               "fit_s": wall, "s_per_outer_iter": wall / max(iters, 1),
               "launches": counts,
               "launches_per_outer_iter": {k: v / max(iters, 1)
                                           for k, v in counts.items()},
               "support_f1": f1, "r2": r2}
        report[name] = out
        phase(name, t_ph, f"N={Nn} m={mm} n={nn} kappa={kappa} via {kind_}: "
                          f"{iters} iters, {status.name}, fit {wall:.3f} s "
                          f"({wall / max(iters, 1) * 1e3:.2f} ms/outer iter), "
                          f"launches {counts}, support F1 {f1:.4f}, "
                          f"R^2 {r2:.6f}")
        return est

    # 4. the main path at full width ---------------------------------------
    est = fit_phase("woodbury", As_w, bs_w, xt_w, wide.kappa, "woodbury",
                    ops.KERNELS)
    main_counts = report["woodbury"]["launches"]

    # where the time goes: two more outer iterations (no polish), first
    # with the profiler off, then on
    t0 = time.perf_counter()
    prof_est = api.SparseLinearRegression(kappa=wide.kappa, gamma=10.0,
                                          rho_c=4.0, max_iter=2, tol=0.0,
                                          polish=False)
    Aw_dev = torch.as_tensor(As_w, device=dev)
    bw_dev = torch.as_tensor(bs_w, device=dev)
    prof_est.fit(Aw_dev, bw_dev, state=est.result_.state)  # setup outside
    torch.cuda.synchronize()
    t_w = time.perf_counter()
    prof_est.fit(Aw_dev, bw_dev, state=est.result_.state)
    torch.cuda.synchronize()
    window_off = time.perf_counter() - t_w
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_w = time.perf_counter()
        prof_est.fit(Aw_dev, bw_dev, state=est.result_.state)
        torch.cuda.synchronize()
        window = time.perf_counter() - t_w
    on_device, syncs = {}, 0
    for ev in prof.key_averages():
        if ev.key == "aten::_local_scalar_dense":
            syncs += ev.count          # a device-to-host read of a scalar
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            on_device[ev.key] = {"device_ms": dev_us / 1e3,
                                 "calls": ev.count}
    busy_ms = sum(v["device_ms"] for v in on_device.values())
    n_dev = sum(v["calls"] for v in on_device.values())
    top = sorted(on_device.items(), key=lambda kv: -kv[1]["device_ms"])[:8]
    report["profile"] = {
        "outer_iters": 2, "window_s_profiler_off": window_off,
        "window_s_profiler_on": window, "device_busy_ms": busy_ms,
        "device_ops": n_dev, "host_syncs": syncs, "top": dict(top),
        "all_device_ops": on_device}
    if busy_ms > 0:
        phase("profile", t0, f"2 outer iterations: wall "
                             f"{window_off * 1e3:.1f} ms (profiler off), "
                             f"{window * 1e3:.1f} ms (on); device busy "
                             f"{busy_ms:.1f} ms in {n_dev} kernels and "
                             f"copies, {syncs} host syncs; idle share "
                             f"{1 - busy_ms / (window_off * 1e3):.3f} "
                             f"(profiler off) / "
                             f"{1 - busy_ms / (window * 1e3):.3f} (on); top: "
                             + "; ".join(f"{k[:40]} {v['device_ms']:.2f} ms"
                                         f"/{v['calls']}" for k, v in top[:4]))
    else:
        phase("profile", t0, "the profiler reported no device time: "
                             "device busy share not measured")
    del Aw_dev, bw_dev, prof_est

    # 5. the dense regime ---------------------------------------------------
    fit_phase("dense", As_n, bs_n, xt_n, narrow.kappa, "dense",
              ("ladder_stats", "gram", "rmatvec"))

    # 6. the card against the port's own CPU fit ---------------------------
    t0 = time.perf_counter()
    small = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    As_s, bs_s, _ = make_sparse_regression(1, small)
    kw = dict(kappa=small.kappa, gamma=10.0, rho_c=4.0, x_solver="woodbury",
              tol=1e-4, max_iter=300)
    on_card = api.SparseLinearRegression(**kw).fit(As_s, bs_s).result_
    t_card = time.perf_counter() - t0
    on_cpu = api.SparseLinearRegression(device="cpu", **kw).fit(
        As_s, bs_s).result_
    require(int(on_card.status) == int(on_cpu.status),
            f"parity: status {int(on_card.status)} on the card, "
            f"{int(on_cpu.status)} on the CPU")
    require(torch.equal(on_card.support.cpu(), on_cpu.support),
            "parity: supports differ")
    coef_err = float((on_card.coef.cpu() - on_cpu.coef).abs().max())
    require(torch.allclose(on_card.coef.cpu(), on_cpu.coef, rtol=1e-3,
                           atol=1e-3), f"parity: coef differs by {coef_err}")
    d_iter = abs(int(on_card.iters) - int(on_cpu.iters))
    require(d_iter <= 2, f"parity: iterations {int(on_card.iters)} vs "
                         f"{int(on_cpu.iters)}")
    report["parity"] = {"iters_card": int(on_card.iters),
                        "iters_cpu": int(on_cpu.iters),
                        "status": SolveStatus(int(on_card.status)).name,
                        "coef_max_abs_diff": coef_err,
                        "card_fit_s": t_card}
    phase("parity", t0, f"N={small.n_nodes} m={small.m_per_node} "
                        f"n={small.n_features} kappa={small.kappa} woodbury: "
                        f"card {int(on_card.iters)} iters vs CPU "
                        f"{int(on_cpu.iters)}, same status "
                        f"{SolveStatus(int(on_card.status)).name} and "
                        f"support, coef max abs diff {coef_err:.2e}")

    kernels = []
    for name in ops.KERNELS:
        row = dict(rows[name])
        row.pop("shape")
        row.pop("call_ms")
        row["launches"] = main_counts[name]
        kernels.append(row)
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
