#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line with its wall time:

1. device   — a CUDA device or fail; the card's name and power limit as
              ``nvidia-smi`` reports them.
2. build    — the kernels of ``src/repro_torch/csrc`` with nvcc, one
              compiler per source, all started together; ``cuobjdump``
              must find DMMA in every bf16 / fp16 gram kernel.
3. kernels  — every kernel against its plain PyTorch version on the card,
              at the solver path's shapes and at ragged ones; for each, the
              kernel's device time, the plain version's, one PyTorch library
              call computing the same function (a yardstick the port never
              calls) and the bound from bytes and operations. Device times
              replay the calls from a CUDA graph, so the host's share of a
              call is left out; the eager time of one call, host included,
              is printed beside them. The one-launch projections are also
              timed at each cluster size (1, 2, 4, 8 CTAs) at the path's
              widths and at 0, 1 and 2 bracketing rounds, beside an empty
              kernel's launch latency. normal_matvec is timed at the
              Woodbury polish's (6,400, 10,000), the PCG x-update's
              (8, 25,000, 4,000) and that fit's polish (200,000, 4,000),
              beside the composition of the matvec and rmatvec kernels
              and two torch.matmul calls; two calls must agree bit for bit.
              The bf16 / fp16 instantiations of matvec, rmatvec and
              normal_matvec are held and timed the same way at the
              reduced-precision cells' shapes, beside their bound with
              2-byte A and torch.matmul on the half-width operands, plus an
              odd-n view one element past 16 bytes; the bf16 / fp16 gram
              (on the FP64 tensor cores) beside its bound at the f64
              tensor-core rate and the f64 torch.matmul.
   large_n  — one l1-epigraph projection and one S^kappa support one entry
              past the one-launch limit, where the bracketing rounds run on
              the one-launch ladder_stats kernel; ladder_stats is held
              against its plain version (and timed) at this n with the
              first round's 128 rungs, and at an odd B.
4. woodbury — the paper's Fig. 2 largest point at full width (N = 8 nodes,
              m = 800 rows each, n = 10,000 features, kappa = 2,000) through
              ``SparseLinearRegression.fit`` on the card; the x-update must
              take the Woodbury backend and its four kernels must launch.
   woodbury_bf16 — the same point with A and b cast to bf16 on the card
              before the clock (``precision="bf16"``): the bf16 gram,
              matvec, rmatvec and normal_matvec instantiations must launch
              and no f32 one.
5. dense    — Fig. 2's smallest point (n = 1,000, kappa = 200) through the
              dense factorization and the dense polish.
   dense_fp16 — the same point in fp16 (``precision="fp16"``).
6. fig3     — the paper's Fig. 3 smallest point at full width (N = 8,
              m = 25,000, n = 4,000, kappa = 800) through the feature-split
              sub-solver (M = 4 blocks, 15 inner iterations): the block
              kernels and ``gram`` must launch, and the fit's peak device
              memory above its start must stay under a quarter of A's
              3.2 GB — no padded or blocked copy of A.
   pcg      — the same point and data through the PCG x-update (the
              paper's ``x_solver="auto"`` there, no feature split, polish
              on): ``normal_matvec`` every CG step. Prints ms per outer
              iteration and the PCG x-update's share, CG steps per outer
              iteration, normal_matvec calls and launches per fit and the
              peak memory (under a quarter of A). The fit runs in turns
              with the kernel and with the solver's normal_matvec bound to
              the composition of the matvec and rmatvec kernels (kernel,
              composition, composition, kernel), then a profile window of
              2 outer iterations with each.
   pcg_bf16 — the same fit with A (1.6 GB) and b cast to bf16 on the card
              before the clock: normal_matvec_bf16 every CG step; peak
              memory above the start under a quarter of the bf16 A.
7. classify — logistic and 3-class softmax regression at n = 4,000 through
              the feature split and the Newton-CG polish (rows cut to
              m = 5,000 per node on N = 8 to bound the run's time).
   classify_bf16 — the same two fits in bf16 through the Newton-CG prox
              (the feature split is not ported under bf16).
   large_n_fit — the squared loss at N = 8, m = 200, n = 409,601 (one past
              the one-launch limit; A 2.6 GB), kappa = 81,920, 3 outer
              iterations, polish off: every projection's bracketing rounds
              on ladder_stats. Prints ms and ladder_stats launches per
              outer iteration and ladder_stats' device time in a profiler
              window of 2 outer iterations.
8. parity   — reduced fits on the card against the port's own CPU fits:
              Woodbury, the feature split (squared and logistic), the
              Woodbury fit's data through the PCG x-update, and that data
              in bf16 through Woodbury and in fp16 through PCG and
              Woodbury.
9. lm       — the dense LM's serving path at full width and depth:
              qwen3-8b (36 layers, 8.19e9 parameters drawn on the card
              from seed 0, 16.4 GB in bf16), 4 prompts of 2,048 tokens
              (numpy seed 0) through ``zoo.prefill`` (max_seq 2,080), then
              32 greedy ``zoo.decode_step``s. Each prefill must launch the
              flash-attention kernel once per layer. Prints the prefill's
              time and prompt tokens per second, the decode time per
              token, the peak device memory and the flash kernel's share
              of the prefill's device time (profiler).
10. lm_parity — (a) qwen3-8b at full width cut to 2 layers, bf16: prefill
              and decode through the kernel against the same model through
              the plain ``impl="full"``, and the first layer's attention
              output on the kernel path against the f32 attention of the
              same q, k and v within one bf16 rounding; (b) the reduced f32
              config, card
              against the port's CPU run; (c) decode after prefill against
              the forward pass on the card, 2 layers at full width in f32.

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
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # dense bf16 on the tensor cores
PEAK_F64_TC_FLOPS = 67e12     # f64 on the tensor cores (DMMA)
PEAK_BYTES = 3.35e12
RTOL = 1e-4          # the JAX package's f32 kernel bound (rtol 1e-4,
ATOL_PER_SCALE = 1e-5  # atol 1e-5 per unit of summed magnitude)
# Flash attention against the f32 computation on the same operands: f32 at
# the JAX package's own bound (tests/test_kernels.py); bf16 within one
# rounding of the bf16 output (rtol 2^-8) plus 1e-4
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2 ** -8, 1e-4)}
LM_TOL = 2e-2        # LM logits: max |diff| within 2e-2 of the logit scale
# the device kernels of csrc/flash_attention.cu (f32 on the CUDA cores; bf16
# on the tensor cores through wgmma)
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_wgmma_kernel")
# device kernels whose ptxas report (registers, shared memory, spills) the
# build phase prints
PTXAS_SHOWN = ("flash_wgmma_kernel", "gram_xy_kernel", "gram_dmma_kernel",
               "ladder_kernel")
# csrc/matvec.cu's kernel templates, summed over their instantiations, and
# the template arguments of those the solver path runs: matvec <type of A,
# path, rows per warp, KC, X as float4s> at K = 1 and 3, rmatvec <type,
# columns a lane, KC>, in f32 and bf16
PTXAS_MATVEC = {"matvec_kernel": ("f32:0,4,1,0", "f32:1,2,3,1",
                                  "bf16:0,4,1,0", "bf16:1,2,3,1"),
                "rmatvec_team_kernel": ("f32:4,1", "f32:4,3", "bf16:4,1"),
                "rmatvec_slices_kernel": ("f32:4,1", "f32:4,3", "bf16:4,1",
                                          "bf16:4,3"),
                "sum_slices": ("",)}
# csrc/normal_matvec.cu's: the stream kernel <type, bulk, vpt, rows> at
# n = 10,000 (Woodbury polish), 4,000 (Fig. 3 PCG) and 2,500 (PCG parity)
# in f32; 4,000 (pcg_bf16) and 2,500 (the fp16 PCG parity fit) half-width
PTXAS_NORMAL = {"normal_stream_kernel": ("f32:1,5,1", "f32:1,2,2",
                                         "f32:1,2,4", "bf16:1,1,4",
                                         "f16:0,1,4"),
                "normal_sum_kernel": ("",)}
# the element type of a mangled template argument list
MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}

REPLACES = {
    "ladder_stats": "src/repro/kernels/bisect_proj.py:42",
    # the loops around the ladder kernel, each now one launch
    "l1_epigraph_proj": "src/repro/core/bilinear.py:177",
    "skappa_support": "src/repro/core/bilinear.py:409",
    "gram": "src/repro/kernels/gram.py:35",
    "matvec": "src/repro/kernels/matvec.py:95",
    "rmatvec": "src/repro/kernels/matvec.py:135",
    "normal_matvec": "src/repro/kernels/matvec.py:175",
    "block_matvec": "src/repro/kernels/ops.py:115",
    "block_rmatvec": "src/repro/kernels/ops.py:126",
    "flash_attention": "src/repro/kernels/flash_attention.py:30",
}
SOURCES = {
    "ladder_stats": "src/repro_torch/csrc/ladder_stats.cu",
    "l1_epigraph_proj": "src/repro_torch/csrc/ladder_proj.cu",
    "skappa_support": "src/repro_torch/csrc/ladder_proj.cu",
    "gram": "src/repro_torch/csrc/gram.cu",
    "matvec": "src/repro_torch/csrc/matvec.cu",
    "rmatvec": "src/repro_torch/csrc/matvec.cu",
    "normal_matvec": "src/repro_torch/csrc/normal_matvec.cu",
    "block_matvec": "src/repro_torch/csrc/block_matvec.cu",
    "block_rmatvec": "src/repro_torch/csrc/block_matvec.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
# the bf16 / fp16 instantiations, each a row of the kernels line
HALF_TYPES = ("bf16", "f16")
HALF_KERNELS = tuple(f"{k}_{t}" for k in ("gram", "matvec", "rmatvec",
                                          "normal_matvec")
                     for t in HALF_TYPES)
for _name in HALF_KERNELS:
    _base = _name.rsplit("_", 1)[0]
    REPLACES[_name], SOURCES[_name] = REPLACES[_base], SOURCES[_base]
PROJ_KERNELS = ("l1_epigraph_proj", "skappa_support")
MAIN_KERNELS = (*PROJ_KERNELS, "gram", "matvec", "rmatvec", "normal_matvec")
BLOCK_KERNELS = ("block_matvec", "block_rmatvec")
# the projections against their plain versions and the f64 sort oracles:
# theta, z, t and u_max at rtol 1e-5 and an atol of 1e-6 x max |z|; s*
# equal bit for bit (it depends on counts alone)
PROJ_RTOL, PROJ_ATOL_PER_MAX = 1e-5, 1e-6
# the cluster sweep's widths: the solver path's d = n K (the split parity
# fits 250, dense 1,000, the Woodbury parity fit 2,500, fig3 and classify
# logistic 4,000, woodbury 10,000, classify softmax 12,000) and between
PROJ_SWEEP_N = (250, 500, 1_000, 2_500, 4_000, 6_000, 10_000, 12_000)


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


def bound(nbytes: float, flops: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(torch, name, got, want, scale, rtol=RTOL,
                atol=None) -> float:
    """``got`` against ``want`` at ``rtol`` and an atol of ``atol``, by
    default ATOL_PER_SCALE per unit of ``scale``."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = ATOL_PER_SCALE * float(scale) if atol is None else atol
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    require(ok, f"{name}: kernel disagrees with its plain version "
                f"(max abs err {err:.3e}, rtol {rtol}, atol {atol:.3e})")
    return err


def ptxas_summary(info: dict) -> list[str]:
    """One line per kernel of PTXAS_SHOWN from the build's ptxas reports:
    its registers, shared memory and spill bytes."""
    lines, entry = [], None
    for name, v in info.items():
        for ln in v.get("log", "").splitlines():
            if "Compiling entry function" in ln:
                entry = next((k for k in PTXAS_SHOWN if k in ln), None)
                mangled = ln.split("'")[1] if "'" in ln else ln
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(f"{name}: {entry} {mangled[:48]}: "
                             f"{ln.split(':', 1)[-1].strip()}")
    return lines


def dmma_kernels(build) -> dict:
    """{mangled name: issues DMMA} of every gram_dmma_kernel instantiation
    in the built gram library, from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path("gram"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs = (f.split("\n", 1) for f in sass.split("Function : ")[1:])
    return {name.strip(): "DMMA" in body for name, body in funcs
            if "gram_dmma_kernel" in name}


def ptxas_ladder_proj(log: str) -> list[str]:
    """One line per kernel of csrc/ladder_proj.cu from its ptxas report:
    registers and spill stores of each cluster size's instantiation."""
    kern, regs, spills = None, {}, {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mt = re.search(r"(l1_proj_kernel|skappa_kernel)ILi(\d+)E", ln)
            kern = mt and (mt.group(1), int(mt.group(2)))
        elif kern:
            used = re.search(r"Used (\d+) registers", ln)
            spill = re.search(r"(\d+) bytes spill stores", ln)
            if used:
                regs.setdefault(kern[0], {})[kern[1]] = int(used.group(1))
            if spill:
                spills.setdefault(kern[0], 0)
                spills[kern[0]] += int(spill.group(1))
    return [f"ladder_proj: {k} registers by cluster size "
            + ", ".join(f"<{c}> {r}" for c, r in sorted(v.items()))
            + f"; spill stores {spills.get(k, 0)} B" for k, v in regs.items()]


def ptxas_matvec(log: str, source: str = "matvec",
                 families: dict = PTXAS_MATVEC) -> list[str]:
    """One line per kernel template of a source (by default csrc/matvec.cu)
    from its ptxas report: instantiations, register range, spill stores,
    and the registers of the instantiations on the solver path
    (``families``)."""
    fams, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mt = re.search(r"\d+(" + "|".join(sorted(families,
                                                       key=len)[::-1])
                           + r")(?:I(f|13__nv_bfloat16|6__half)?"
                             r"((?:L[ib]\d+E)*)E)?", ln)
            args = mt and ",".join(re.findall(r"L[ib](\d+)E",
                                              mt.group(3) or ""))
            typ = mt and MANGLED_TYPES.get(mt.group(2))
            entry = mt and (mt.group(1), f"{typ}:{args}" if typ else args)
        elif entry:
            fam = fams.setdefault(entry[0], {"regs": {}, "spill": {}})
            used = re.search(r"Used (\d+) registers", ln)
            spill = re.search(r"(\d+) bytes spill stores", ln)
            if used:
                fam["regs"][entry[1]] = int(used.group(1))
            if spill and int(spill.group(1)):
                fam["spill"][entry[1]] = int(spill.group(1))
    lines = []
    for name, fam in fams.items():
        regs, spill = fam["regs"], fam["spill"]
        path = ", ".join(f"<{k}> {regs[k]}" if k else str(regs[k])
                         for k in families[name] if k in regs)
        spilled = ", ".join(f"<{k}> {v} B" for k, v in spill.items())
        lines.append(f"{source}: {name} x{len(regs)}: "
                     f"{min(regs.values())}-{max(regs.values())} registers, "
                     f"spill stores {spilled or 'none'}; on the path "
                     f"{path} registers")
    return lines


def device_table(prof) -> dict:
    """{name: {"device_ms", "calls"}} of the device ops a profiler saw."""
    table = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            table[ev.key] = {"device_ms": dev_us / 1e3, "calls": ev.count}
    return table


def parity_fits() -> list:
    """The card-vs-CPU parity fits (phase 8), as ``(report key, what,
    estimator class, its keywords, As, bs)`` with numpy data from seed 1:
    Woodbury at n = 2,500, the feature split (M = 4, ragged last block
    nb = 63) at n = 250, squared and logistic, the Woodbury fit's data
    through the PCG x-update (normal_matvec every CG step), and that data
    cast to bf16 through Woodbury and to fp16 through PCG and Woodbury (the
    engine casts it, on the card and on the CPU alike). ``repro_torch``
    must be importable."""
    from repro_torch import api
    from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                                  make_sparse_regression)
    small = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    split = SyntheticSpec(2, 200, 250, sparsity_level=0.95, noise=1e-3)
    fits = []
    for key, what, make, spec, cls, kw in (
            ("parity", "woodbury", make_sparse_regression, small,
             api.SparseLinearRegression,
             dict(rho_c=4.0, x_solver="woodbury")),
            ("parity_split_squared", "squared, feature split M=4",
             make_sparse_regression, split, api.SparseLinearRegression,
             dict(rho_c=1.0, n_feature_blocks=4)),
            ("parity_split_logistic", "logistic, feature split M=4",
             make_sparse_classification, split, api.SparseLogisticRegression,
             dict(rho_c=1.0, n_feature_blocks=4)),
            ("parity_pcg", "pcg", make_sparse_regression, small,
             api.SparseLinearRegression, dict(rho_c=4.0, x_solver="pcg")),
            ("parity_woodbury_bf16", "woodbury bf16", make_sparse_regression,
             small, api.SparseLinearRegression,
             dict(rho_c=4.0, x_solver="woodbury", precision="bf16")),
            ("parity_pcg_fp16", "pcg fp16", make_sparse_regression, small,
             api.SparseLinearRegression,
             dict(rho_c=4.0, x_solver="pcg", precision="fp16")),
            ("parity_woodbury_fp16", "woodbury fp16", make_sparse_regression,
             small, api.SparseLinearRegression,
             dict(rho_c=4.0, x_solver="woodbury", precision="fp16"))):
        As, bs, _ = make(1, spec)
        fits.append((key, f"N={spec.n_nodes} m={spec.m_per_node} "
                          f"n={spec.n_features} kappa={spec.kappa} {what}",
                     cls, dict(kappa=spec.kappa, gamma=10.0, tol=1e-4,
                               max_iter=300, **kw), As, bs))
    return fits


def lm_phase(torch, dev, report) -> dict:
    """9. The qwen3-8b serving path at full width and depth (module
    docstring). Returns the launch counts of the timed prefill and decode
    steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    t0 = time.perf_counter()
    cfg = get_config("qwen3-8b")
    B, S, n_new = 4, 2048, 32
    max_seq = S + n_new
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    model = zoo.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    w_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}

    def greedy(logits):
        return logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)

    # warm-up: a prefill and two decode steps; then two more decode steps
    # with the profiler on (where a decode step's time goes)
    logits, cache = zoo.prefill(model, cfg, batch, max_seq=max_seq)
    tok = greedy(logits)
    for pos in (S, S + 1):
        logits, cache = zoo.decode_step(model, cfg, {"token": tok,
                                                     "pos": pos}, cache)
        tok = greedy(logits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_w = time.perf_counter()
        for pos in (S + 2, S + 3):
            logits, cache = zoo.decode_step(model, cfg, {"token": tok,
                                                         "pos": pos}, cache)
            tok = greedy(logits)
        torch.cuda.synchronize()
        dec_window = time.perf_counter() - t_w
    dec_busy = sum(v["device_ms"] for v in device_table(prof).values())
    dec_launches = sum(ev.count for ev in prof.key_averages()
                       if ev.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t_p = time.perf_counter()
    logits, cache = zoo.prefill(model, cfg, batch, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t_p
    flash_prefill = ops.launch_counts()["flash_attention"]
    require(flash_prefill == cfg.n_layers,
            f"lm: the prefill launched the flash kernel {flash_prefill} "
            f"times, not once per layer ({cfg.n_layers})")
    require(tuple(logits.shape) == (B, 1, cfg.padded_vocab),
            f"lm: prefill logits of shape {tuple(logits.shape)}")
    finite = torch.isfinite(logits).all()
    tok = greedy(logits)
    generated = [tok]
    t_d = time.perf_counter()
    for i in range(n_new):
        logits, cache = zoo.decode_step(model, cfg,
                                        {"token": tok, "pos": S + i}, cache)
        finite &= torch.isfinite(logits).all()
        tok = greedy(logits)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t_d
    counts = ops.launch_counts()
    require(bool(finite), "lm: non-finite logits")
    peak = torch.cuda.max_memory_allocated() - mem0
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    del logits, cache

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_w = time.perf_counter()
        out = zoo.prefill(model, cfg, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        window = time.perf_counter() - t_w
    del out
    table = device_table(prof)
    busy = sum(v["device_ms"] for v in table.values())
    flash_ms = sum(v["device_ms"] for k, v in table.items()
                   if any(n in k for n in FLASH_KERNEL_NAMES))
    require(busy == 0 or flash_ms > 0,
            "lm: the profiled prefill shows no flash-attention kernel")
    top = sorted(table.items(), key=lambda kv: -kv[1]["device_ms"])[:6]
    share = flash_ms / busy if busy > 0 else None
    report["lm"] = {
        "config": "qwen3-8b", "batch": B, "prompt_len": S, "max_seq": max_seq,
        "decode_steps": n_new, "init_s": init_s, "prefill_s": prefill_s,
        "prompt_tokens_per_s": B * S / prefill_s,
        "decode_ms_per_token": decode_s / n_new * 1e3,
        "weights_bytes": w_bytes, "cache_bytes": cache_bytes,
        "peak_bytes_above_start": peak, "launches": counts,
        "profile": {"window_s_profiler_on": window, "device_busy_ms": busy,
                    "flash_ms": flash_ms, "flash_share": share,
                    "top": dict(top)},
        "decode_profile": {"steps": 2, "window_s_profiler_on": dec_window,
                           "device_busy_ms": dec_busy,
                           "kernel_launches": dec_launches},
        "generated": torch.cat(generated, 1).tolist()}
    share_txt = ("not measured (the profiler saw no device time)"
                 if share is None else
                 f"{share:.3f} ({flash_ms:.1f} of {busy:.1f} ms busy in a "
                 f"{window * 1e3:.1f} ms window with the profiler on)")
    phase("lm", t0, f"qwen3-8b, {cfg.n_layers} layers, bf16, "
                    f"{w_bytes / 1e9:.2f} GB of weights drawn in "
                    f"{init_s:.2f} s: prefill {B} x {S} tokens "
                    f"{prefill_s * 1e3:.1f} ms ({B * S / prefill_s:.0f} "
                    f"prompt tokens/s), {n_new} decode steps "
                    f"{decode_s / n_new * 1e3:.2f} ms per token (profiled: "
                    f"device busy {dec_busy / 2:.2f} ms of "
                    f"{dec_window * 1e3 / 2:.2f} ms per step, "
                    f"{dec_launches // 2} kernel launches per step); flash "
                    f"launches {flash_prefill} per prefill; peak device "
                    f"memory above the start {peak / 1e9:.2f} GB (weights "
                    f"{w_bytes / 1e9:.2f} GB + cache {cache_bytes / 1e9:.2f} "
                    f"GB); flash share of the prefill's device time "
                    f"{share_txt}; top: "
                    + "; ".join(f"{k[:40]} {v['device_ms']:.1f} ms/"
                                f"{v['calls']}" for k, v in top[:4]))
    del model
    torch.cuda.empty_cache()
    return counts


def lm_parity_phase(torch, dev, report) -> None:
    """10. The LM on the card against its plain attention, against the
    port's CPU run, and its decode against its forward pass."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention, transformer, zoo
    from repro_torch.models.layers import rms_norm

    def gen(device, seed=0):
        return torch.Generator(device=device).manual_seed(seed)

    # (a) full width, 2 layers, bf16: the kernel against impl="full"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    V, B, S, n_new = cfg.vocab_size, 4, 2048, 8
    model = zoo.init_params(cfg, generator=gen(dev), device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, V, (B, S)), device=dev)
    steps = {}
    caches = {}
    attn_out = {}                   # layer 0's attention output, before wo
    hook = model.blocks[0].attn.wo.register_forward_pre_hook(
        lambda mod, args: attn_out.__setitem__(impl, args[0].clone()))
    ops.reset_launch_counts()
    for impl in ("flash", "full"):
        logits, caches[impl] = zoo.prefill(model, cfg, {"tokens": tokens},
                                           max_seq=S + n_new, impl=impl)
        steps[impl] = [logits[:, -1, :V].float()]
    hook.remove()
    require(ops.launch_counts()["flash_attention"] == cfg.n_layers,
            "lm_parity: only the flash prefill launches the kernel")
    # the kernel path's layer-0 attention against the f32 attention of the
    # same bf16 q, k, v (recomputed: the same calls on the same inputs)
    with torch.inference_mode():
        blk = model.blocks[0]
        h = rms_norm(transformer._embed_tokens(model, cfg, tokens), blk.norm1)
        q, k, v = attention._project_qkv(
            blk.attn, cfg, h, transformer._prompt_rope(cfg, tokens))
        exact = attention._sdpa_full(q.float(), k.float(), v.float(),
                                     causal=True).reshape(B, S, -1)
    del h, q, k, v
    attn_err = {i: float((attn_out[i].float() - exact).abs().max())
                for i in attn_out}
    attn_scale = float(exact.abs().max())
    require(torch.allclose(attn_out["flash"].float(), exact,
                           rtol=FLASH_TOL["bfloat16"][0],
                           atol=FLASH_TOL["bfloat16"][1]),
            f"lm_parity: layer 0's attention on the kernel path is "
            f"{attn_err['flash']:.3e} from the f32 attention of its q, k, v "
            f"(limit rtol {FLASH_TOL['bfloat16'][0]}, atol "
            f"{FLASH_TOL['bfloat16'][1]}; |o| up to {attn_scale:.3e})")
    del exact, attn_out
    tok = steps["flash"][0].argmax(-1, keepdim=True)
    for i in range(n_new):          # both fed the kernel path's tokens
        for impl in ("flash", "full"):
            logits, _ = zoo.decode_step(model, cfg, {"token": tok,
                                                     "pos": S + i},
                                        caches[impl])
            steps[impl].append(logits[:, -1, :V].float())
        tok = steps["flash"][-1].argmax(-1, keepdim=True)
    worst = 0.0
    for i, (got, want) in enumerate(zip(steps["flash"], steps["full"])):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        require(err <= LM_TOL * scale,
                f"lm_parity: step {i} logits differ by {err:.3f}, over "
                f"{LM_TOL} of the logit scale {scale:.1f}")
        worst = max(worst, err / scale)
    # the greedy next token of each prompt: equal, unless the reference's
    # top two logits are within one bf16 step of each other (a tie in the
    # logits' own dtype, which either path may break either way)
    got, want = steps["flash"][0], steps["full"][0]
    top2 = want.topk(2, dim=-1).values
    bf16_step = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    ties = (top2[:, 0] - top2[:, 1]) <= bf16_step
    same = got.argmax(-1) == want.argmax(-1)
    require(bool((same | ties).all()),
            f"lm_parity: greedy next tokens differ: "
            f"{got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
    agree = [int((a.argmax(-1) == b.argmax(-1)).sum())
             for a, b in zip(steps["flash"][1:], steps["full"][1:])]
    del model, caches, steps
    torch.cuda.empty_cache()
    report["lm_parity_flash_vs_full"] = {
        "layer0_attention_max_abs_err_vs_f32": attn_err,
        "layer0_attention_max_abs": attn_scale,
        "worst_err_over_scale": worst, "steps": n_new + 1,
        "next_token_equal": same.tolist(), "next_token_ties": ties.tolist(),
        "decode_greedy_agree_per_step": agree}
    phase("lm_parity", t0, f"qwen3-8b cut to 2 layers, bf16, {B} x {S}: "
                           f"prefill + {n_new} decode steps through the "
                           f"kernel vs impl='full': layer 0's attention "
                           f"output within {attn_err['flash']:.3e} of the "
                           f"f32 attention (limit rtol 2^-8, atol 1e-4; "
                           f"impl='full' {attn_err['full']:.3e}; |o| up to "
                           f"{attn_scale:.3e}); logits within "
                           f"{worst:.2e} of their scale (limit {LM_TOL}); "
                           f"greedy next token equal for "
                           f"{int(same.sum())} of {B} prompts "
                           f"({int((ties & ~same).sum())} bf16 ties); "
                           f"decode steps' greedy tokens agree in "
                           f"{sum(agree)} of {B * n_new}")

    # (b) the reduced f32 config: the card against the port's CPU run
    t0 = time.perf_counter()
    cfg = reduced_config(get_config("qwen3-8b"))
    on_cpu = zoo.init_params(cfg, generator=gen("cpu"), device="cpu")
    on_card = copy.deepcopy(on_cpu).to(dev)
    tok_np = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    ops.reset_launch_counts()
    outs = {}
    for name, model in (("card", on_card), ("cpu", on_cpu)):
        full, _ = zoo.forward(model, cfg, {"tokens": tok_np})
        last, cache = zoo.prefill(model, cfg, {"tokens": tok_np[:, :-1]},
                                  max_seq=32)
        pre_k = cache["k"].clone()
        step, cache = zoo.decode_step(model, cfg, {"token": tok_np[:, -1:],
                                                   "pos": 31}, cache)
        outs[name] = [t.cpu() for t in (full, last, pre_k, step,
                                        cache["v"])]
    require(ops.launch_counts()["flash_attention"] == 2 * cfg.n_layers,
            "lm_parity: the card's forward and prefill launch the kernel "
            "once per layer each")
    err = 0.0
    for got, want in zip(outs["card"], outs["cpu"]):
        err = max(err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                f"lm_parity: reduced config, card vs CPU differ by {err}")
    phase("lm_parity", t0, f"reduced qwen3-8b (2 layers, d_model 64, f32): "
                           f"forward, prefill logits and cache, decode "
                           f"logits and cache on the card within {err:.2e} "
                           f"of the port's CPU run (limit 1e-4)")
    report["lm_parity_card_vs_cpu"] = {"max_abs_diff": err}

    # (c) decode after prefill against the forward pass, full width, f32
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                              dtype="float32")
    model = zoo.init_params(cfg, generator=gen(dev), device=dev)
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 128)), device=dev)
    full, _ = zoo.forward(model, cfg, {"tokens": x})
    _, cache = zoo.prefill(model, cfg, {"tokens": x[:, :-1]}, max_seq=128)
    step, _ = zoo.decode_step(model, cfg, {"token": x[:, -1:], "pos": 127},
                              cache)
    got, want = step[:, 0, :cfg.vocab_size], full[:, -1]
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
            f"lm_parity: decode after prefill differs from forward by {err}")
    del model, cache, full
    torch.cuda.empty_cache()
    report["lm_parity_decode_vs_forward"] = {"max_abs_diff": err}
    phase("lm_parity", t0, f"qwen3-8b cut to 2 layers, f32, 2 x 128: "
                           f"decode(prefill(x[:-1]), x[-1]) within "
                           f"{err:.2e} of forward(x)[:, -1] (rtol and atol "
                           f"2e-3)")


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
    from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                                  make_sparse_regression, make_sparse_softmax)
    from repro_torch import runtime
    from repro_torch.core import bicadmm, bilinear, prox
    from repro_torch.kernels import (bisect_proj, block_matvec, build,
                                     flash_attention, gram, matvec, ops, ref)

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
    dmma = dmma_kernels(build)
    require(len(dmma) == 16 and all(dmma.values()),
            f"gram: the bf16 / fp16 kernels do not all issue DMMA: {dmma}")
    report["gram_dmma"] = dmma
    print(f"  gram: DMMA (the FP64 tensor cores) in all {len(dmma)} bf16 / "
          "fp16 instantiations of gram_dmma_kernel (cuobjdump -sass)",
          flush=True)
    for line in (*ptxas_summary(info),
                 *ptxas_ladder_proj(info.get("ladder_proj", {}).get("log",
                                                                    "")),
                 *ptxas_matvec(info.get("matvec", {}).get("log", "")),
                 *ptxas_matvec(info.get("normal_matvec", {}).get("log", ""),
                               "normal_matvec", PTXAS_NORMAL)):
        print("  " + line, flush=True)

    # data of the two Fig. 2 points and the Fig. 3 point (numpy, seed 0) --
    t0 = time.perf_counter()
    wide = SyntheticSpec(8, 800, 10_000, sparsity_level=0.8)
    narrow = SyntheticSpec(8, 800, 1_000, sparsity_level=0.8)
    fig3 = SyntheticSpec(8, 25_000, 4_000, sparsity_level=0.8)
    As_w, bs_w, xt_w = make_sparse_regression(0, wide)
    As_n, bs_n, xt_n = make_sparse_regression(0, narrow)
    As_3, bs_3, xt_3 = make_sparse_regression(0, fig3)
    A = torch.as_tensor(As_w, device=dev)
    An = torch.as_tensor(As_n, device=dev)
    A3 = torch.as_tensor(As_3, device=dev)
    b3 = torch.as_tensor(bs_3, device=dev)
    del As_3
    phase("data", t0, f"As {tuple(As_w.shape)}, {tuple(As_n.shape)} and "
                      f"{tuple(A3.shape)} f32 on the card")

    def composed_normal(a, p, shift):
        """normal_matvec as the matvec and rmatvec kernels composed (the
        port's product before csrc/normal_matvec.cu): a yardstick and the
        pcg phase's A/B, never called by the port."""
        return matvec.rmatvec(a, matvec.matvec(a, p)) + shift * p

    # 3. kernels against their plain versions ------------------------------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    N, m, n = A.shape
    A_all = A.reshape(N * m, n)
    rows = {}

    def kernel_row(name, label, fn, plain, library, got_want_scale,
                   nbytes, flops, peak=PEAK_F32_FLOPS, tol=None,
                   plain_eager=False, yardsticks=None):
        """``plain_eager``: the plain version reads the host inside its
        loops, so it is timed eagerly (no CUDA graph can hold it).
        ``yardsticks``: {label: fn} of other ways to the same result, each
        timed like the kernel (reported, not used by the port)."""
        err = check_close(torch, label, *got_want_scale,
                          **({} if tol is None else
                             dict(rtol=tol[0], atol=tol[1])))
        bnd, by = bound(nbytes, flops, peak)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "shape": label,
               "max_abs_err": err, "ms": graph_ms(torch, fn),
               "plain_ms": (cuda_ms(torch, plain, reps=5) if plain_eager
                            else graph_ms(torch, plain)),
               "bound_ms": bnd, "bound_by": by,
               "library_ms": (None if library is None
                              else graph_ms(torch, library)),
               "call_ms": cuda_ms(torch, fn),
               "yardsticks_ms": {k: graph_ms(torch, f)
                                 for k, f in (yardsticks or {}).items()}}
        lib_ms = row["library_ms"]
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        yard_txt = "".join(f", {k} {v:.4f} ms"
                           for k, v in row["yardsticks_ms"].items())
        print(f"  {label}: kernel {row['ms']:.4f} ms (eager call "
              f"{row['call_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
              f"library {lib_txt}{yard_txt}, bound {bnd:.4f} ms ({by}), "
              f"max abs err {err:.3e}", flush=True)
        rows.setdefault(name, row)      # the first row is the path's shape
        report.setdefault("kernel_checks", []).append(row)

    # the one-launch projections at the path's widths (woodbury d = 10,000
    # first, then fig3 / classify logistic 4,000 and classify softmax
    # 12,000), held to their plain versions and the f64 sort oracles. The
    # bound counts 2 n operations (a compare and an add) for each threshold
    # this run's data needs: the first pass, 128 rungs a round, each polish
    # step (l1) or 4 a search step (the band and three counts) plus the
    # output pass (S^kappa); bytes: z read, the output written.
    proj_stats = {}
    for nn in (10_000, 4_000, 12_000):
        z0 = torch.randn(nn, device=dev, generator=g)
        scale = float(z0.abs().max())
        ptol = (PROJ_RTOL, PROJ_ATOL_PER_MAX * scale)
        tz = (0.5 * z0.abs().sum()).reshape(())
        got = bisect_proj.l1_epigraph_proj(z0, tz, stats=True)
        want = ref.l1_epigraph_proj_ref(z0, tz, stats=True)
        sz, st = bilinear.project_l1_epigraph_sort(z0.double(), tz.double())
        for what, g_, w_ in (("t", got[1], want[1]), ("theta", got[2],
                                                      want[2]),
                             ("z vs sort", got[0], sz), ("t vs sort", got[1],
                                                         st),
                             ("theta vs sort", got[2], st - tz.double())):
            check_close(torch, f"l1_epigraph_proj n={nn} {what}", g_, w_,
                        None, rtol=ptol[0], atol=ptol[1])
        steps = int(got[3])
        rounds = runtime.ladder_rounds("cuda")
        proj_stats[f"l1 n={nn}"] = {"polish_steps": steps,
                                    "plain_polish_steps": want[3]}
        kernel_row("l1_epigraph_proj",
                   f"l1_epigraph_proj n={nn} ({steps} polish steps)",
                   lambda z0=z0, tz=tz: bisect_proj.l1_epigraph_proj(z0, tz),
                   lambda z0=z0, tz=tz: ref.l1_epigraph_proj_ref(z0, tz),
                   None, (got[0], want[0], None), 8 * nn + 8,
                   2 * nn * (1 + rounds * bisect_proj.RUNGS + steps),
                   tol=ptol, plain_eager=True)
        kappa = nn / 5
        got = bisect_proj.skappa_support(z0, kappa, stats=True)
        want = ref.skappa_support_ref(z0, kappa, stats=True)
        require(torch.equal(got[1], want[1]),
                f"skappa_support n={nn}: s* differs from the plain version")
        u64, _ = bilinear.support_skappa_sort(z0.double(), kappa)
        check_close(torch, f"skappa_support n={nn} u_max vs sort", got[0],
                    u64, None, rtol=ptol[0], atol=ptol[1])
        steps = int(got[2])
        proj_stats[f"skappa n={nn}"] = {"search_steps": steps,
                                        "plain_search_steps": want[2]}
        kernel_row("skappa_support",
                   f"skappa_support n={nn} kappa={kappa:g} ({steps} search "
                   "steps)",
                   lambda z0=z0, k=kappa: bisect_proj.skappa_support(z0, k),
                   lambda z0=z0, k=kappa: ref.skappa_support_ref(z0, k),
                   None, (got[0], want[0], None), 8 * nn + 4,
                   2 * nn * (2 + rounds * bisect_proj.RUNGS + 4 * steps),
                   tol=ptol, plain_eager=True)
    # each cluster size at each of the path's widths (plan picks one), and
    # the launch latency: an empty kernel
    sweep = {}
    for nn in PROJ_SWEEP_N:
        z0 = torch.randn(nn, device=dev, generator=g)
        tz = (0.5 * z0.abs().sum()).reshape(())
        for c in (1, 2, 4, 8):
            sweep[f"l1 n={nn} ctas={c}"] = graph_ms(
                torch, lambda z0=z0, tz=tz, c=c: bisect_proj.l1_epigraph_proj(
                    z0, tz, ctas=c))
            sweep[f"skappa n={nn} ctas={c}"] = graph_ms(
                torch, lambda z0=z0, c=c: bisect_proj.skappa_support(
                    z0, nn / 5, ctas=c))
        print(f"  cluster sweep n={nn} (plan: {bisect_proj.plan(nn).ctas} "
              "CTAs): " + "; ".join(
                  f"{kind} " + " / ".join(
                      f"{sweep[f'{kind} n={nn} ctas={c}']:.4f}"
                      for c in (1, 2, 4, 8))
                  for kind in ("l1", "skappa")) + " ms at 1 / 2 / 4 / 8 CTAs",
              flush=True)
    # the bracketing rounds' share: the same projections at 0, 1 and 2
    # rounds (the path runs 2; fewer rounds leave the polish or search more
    # steps, with the same result)
    for nn in (4_000, 10_000, 12_000):
        z0 = torch.randn(nn, device=dev, generator=g)
        tz = (0.5 * z0.abs().sum()).reshape(())
        for r in (0, 1, 2):
            sweep[f"l1 n={nn} rounds={r}"] = graph_ms(
                torch, lambda z0=z0, tz=tz, r=r: bisect_proj.l1_epigraph_proj(
                    z0, tz, rounds=r))
            sweep[f"skappa n={nn} rounds={r}"] = graph_ms(
                torch, lambda z0=z0, r=r: bisect_proj.skappa_support(
                    z0, nn / 5, rounds=r))
        print(f"  rounds n={nn}: " + "; ".join(
            f"{kind} " + " / ".join(f"{sweep[f'{kind} n={nn} rounds={r}']:.4f}"
                                    for r in (0, 1, 2))
            for kind in ("l1", "skappa")) + " ms at 0 / 1 / 2 rounds",
            flush=True)
    empty = {"ms": graph_ms(torch, lambda: bisect_proj.launch_empty(A)),
             "call_ms": cuda_ms(torch, lambda: bisect_proj.launch_empty(A))}
    print(f"  empty kernel: {empty['ms']:.4f} ms in a CUDA graph, "
          f"{empty['call_ms']:.4f} ms eager (the launch latency beside the "
          "projections' bounds)", flush=True)
    report["ladder_proj"] = {"stats": proj_stats, "cluster_sweep_ms": sweep,
                             "empty_kernel": empty}

    # gram: A A^T of the Woodbury setup, A^T A of the dense setup. Both are
    # symmetric products (X^T X): their needed work is nb nx (nx + 1) m
    # flops, half the full product's, and that is what the bound counts.
    for label, X in ((f"gram A A^T {tuple(A.shape)}", A.mT),
                     (f"gram A^T A {tuple(An.shape)}", An)):
        nb, mm, nx = X.shape
        got, want = gram.gram(X), ref.gram_ref(X)
        # the upper tiles mirrored are the full product's values, bit for bit
        require(torch.equal(got, got.mT)
                and torch.equal(got, gram.gram_xy(X, X.clone())),
                f"{label}: the symmetric path differs from the full product")
        scale = float((ref.gram_ref(X.abs())).max())
        kernel_row("gram", f"{label} (symmetric: nb nx (nx+1) m flop)",
                   lambda X=X: gram.gram(X), lambda X=X: ref.gram_ref(X),
                   lambda X=X: torch.matmul(X.mT, X), (got, want, scale),
                   4 * nb * mm * nx + 4 * nb * nx * nx,
                   nb * nx * (nx + 1) * mm)
    # gram_xy of two different operands: the general (full) product
    B = torch.randn(A.shape, device=dev, generator=g)
    X, Y = A.mT, B.mT
    nb, mm, nx = X.shape
    got, want = gram.gram_xy(X, Y), ref.gram_xy_ref(X, Y)
    scale = float(ref.gram_xy_ref(X.abs(), Y.abs()).max())
    kernel_row("gram", f"gram_xy A^T B of two {tuple(A.shape)} arrays "
                       "(general: 2 nb nx ny m flop)",
               lambda: gram.gram_xy(X, Y), lambda: ref.gram_xy_ref(X, Y),
               lambda: torch.matmul(X.mT, Y), (got, want, scale),
               8 * nb * mm * nx + 4 * nb * nx * nx, 2 * nb * nx * nx * mm)
    del B, X, Y, got, want

    # matvec / rmatvec: per node (Woodbury prox), stacked (the polish), and
    # the classify polish's stacked (8 x 5,000, 4,000): a view of the Fig. 3
    # data's first 40,000 rows
    for Aa in (A, A_all, A3.view(-1, A3.shape[-1])[:40_000]):
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
    # normal_matvec, (A^T A + diag(shift)) p reading A once: the Woodbury
    # polish's stacked (6,400, 10,000) with its vector shift (the row the
    # kernels line reports), the Fig. 3 PCG x-update's (8, 25,000, 4,000)
    # with its scalar shift, and that fit's stacked polish (200,000, 4,000).
    # Yardsticks (no one PyTorch call computes it): the composition of the
    # matvec and rmatvec kernels, and two torch.matmul calls. The bound
    # reads A, p and the shift once and writes the output; 4 flop an entry
    # of A.
    plans = {}
    for Aa, vec_shift in ((A_all, True), (A3, False),
                          (A3.view(-1, A3.shape[-1]), True)):
        nn = Aa.shape[-1]
        Na = Aa.shape[0] if Aa.ndim == 3 else 1
        p = torch.randn(Aa.shape[:-2] + (nn,), device=dev, generator=g)
        shift = (torch.rand(nn, device=dev, generator=g) + 1e-3
                 if vec_shift else 4.1)
        label = (f"normal_matvec {tuple(Aa.shape)} "
                 f"{'vector' if vec_shift else 'scalar'} shift")
        got = matvec.normal_matvec(Aa, p, shift)
        require(torch.equal(got, matvec.normal_matvec(Aa, p, shift)),
                f"{label}: two calls differ")
        want = ref.normal_matvec_ref(Aa, p, shift)
        aa = Aa.abs()
        mags = torch.matmul(aa.mT, torch.matmul(aa, p.abs()[..., None]))
        del aa
        scale = float((mags[..., 0] + torch.as_tensor(shift).abs().to(dev)
                       * p.abs()).max())
        del mags
        plans[label] = matvec.normal_plan(
            Na, Aa.shape[-2], nn, None, Aa.data_ptr() % 16 == 0,
            matvec.sm_count(dev))._asdict()
        kernel_row("normal_matvec", label,
                   lambda Aa=Aa, p=p, s=shift: matvec.normal_matvec(Aa, p, s),
                   lambda Aa=Aa, p=p, s=shift: ref.normal_matvec_ref(Aa, p,
                                                                     s),
                   None, (got, want, scale),
                   4 * (Aa.numel() + 2 * p.numel() + (nn if vec_shift
                                                      else 0)),
                   4 * Aa.numel() + 2 * p.numel(),
                   yardsticks={
                       "composed": lambda Aa=Aa, p=p, s=shift:
                           composed_normal(Aa, p, s),
                       "two matmul": lambda Aa=Aa, p=p: torch.matmul(
                           Aa.mT, torch.matmul(Aa, p[..., None]))})
        del got, want
    report["normal_matvec_plans"] = plans
    torch.cuda.empty_cache()

    # the bf16 / fp16 instantiations at the reduced-precision cells' shapes:
    # matvec / rmatvec at the Woodbury prox's (8, 800, 10,000) K = 1 and the
    # classify polish's (40,000, 4,000) K = 1 and 3; normal_matvec at the
    # PCG x-update's (8, 25,000, 4,000) and its polish's (200,000, 4,000);
    # and gram at A A^T of (8, 800, 10,000) (bf16) and A^T A of (8, 800,
    # 1,000). The GEMVs' outputs are f32 (A widened exactly, the sums in
    # f32), so the f32 bound holds; their library yardstick is
    # torch.matmul on half-width operands. Bytes count 2 for an element of
    # A. gram's bound and yardstick are below.
    for sfx, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        # odd n, A one element past 16 bytes: the scalar loads, and
        # normal_matvec through the composed half-width kernels
        Ao = torch.randn(2 * 3_001 * 1_001 + 1, device=dev,
                         generator=g).to(dt)[1:].view(2, 3_001, 1_001)
        require(Ao.data_ptr() % 16 == 2, "odd-n view: not misaligned")
        mats = [(A.to(dt), (1,)), (A3.view(-1, A3.shape[-1])[:40_000].to(dt),
                                   (1, 3)), (Ao, (1,))]
        for Aa, Ks in mats:
            label_a = f"{tuple(Aa.shape)} {sfx}"
            lead, (mm, nn) = Aa.shape[:-2], Aa.shape[-2:]
            na = math.prod(lead)
            af = Aa.float().abs()
            for K in Ks:
                x = torch.randn(*lead, nn, *((K,) if K > 1 else ()),
                                device=dev, generator=g)
                y = torch.randn(*lead, mm, *((K,) if K > 1 else ()),
                                device=dev, generator=g)
                xk, yk = (x, y) if K > 1 else (x[..., None], y[..., None])
                nbytes = 2 * na * mm * nn + 4 * (na * nn * K + na * mm * K)
                got = matvec.matvec(Aa, x)
                require(got.dtype == torch.float32, "matvec: f32 out")
                kernel_row(f"matvec_{sfx}", f"matvec {label_a} K={K}",
                           lambda Aa=Aa, x=x: matvec.matvec(Aa, x),
                           lambda Aa=Aa, x=x: ref.matvec_ref(Aa, x),
                           lambda Aa=Aa, xk=xk: torch.matmul(Aa, xk.to(dt)),
                           (got, ref.matvec_ref(Aa, x),
                            float((af @ xk.abs()).max())),
                           nbytes, 2 * na * mm * nn * K)
                got = matvec.rmatvec(Aa, y)
                kernel_row(f"rmatvec_{sfx}", f"rmatvec {label_a} K={K}",
                           lambda Aa=Aa, y=y: matvec.rmatvec(Aa, y),
                           lambda Aa=Aa, y=y: ref.rmatvec_ref(Aa, y),
                           lambda Aa=Aa, yk=yk: torch.matmul(Aa.mT,
                                                             yk.to(dt)),
                           (got, ref.rmatvec_ref(Aa, y),
                            float((af.mT @ yk.abs()).max())),
                           nbytes, 2 * na * mm * nn * K)
            del af, got
        A3h = A3.to(dt)
        for Aa, vec_shift in ((A3h, False), (A3h.view(-1, A3h.shape[-1]),
                                              True), (Ao, True)):
            nn = Aa.shape[-1]
            p = torch.randn(Aa.shape[:-2] + (nn,), device=dev, generator=g)
            shift = (torch.rand(nn, device=dev, generator=g) + 1e-3
                     if vec_shift else 4.1)
            label = (f"normal_matvec {tuple(Aa.shape)} {sfx} "
                     f"{'vector' if vec_shift else 'scalar'} shift")
            got = matvec.normal_matvec(Aa, p, shift)
            require(torch.equal(got, matvec.normal_matvec(Aa, p, shift)),
                    f"{label}: two calls differ")
            want = ref.normal_matvec_ref(Aa, p, shift)
            aa = Aa.float().abs()
            mags = torch.matmul(aa.mT, torch.matmul(aa, p.abs()[..., None]))
            del aa
            scale = float((mags[..., 0] + torch.as_tensor(shift).abs().to(
                dev) * p.abs()).max())
            del mags
            Na = Aa.shape[0] if Aa.ndim == 3 else 1
            plans[label] = matvec.normal_plan(
                Na, Aa.shape[-2], nn, None, Aa.data_ptr() % 16 == 0,
                matvec.sm_count(dev), 2, Aa.data_ptr() % 4 == 0)._asdict()
            kernel_row(f"normal_matvec_{sfx}", label,
                       lambda Aa=Aa, p=p, s=shift: matvec.normal_matvec(
                           Aa, p, s),
                       lambda Aa=Aa, p=p, s=shift: ref.normal_matvec_ref(
                           Aa, p, s),
                       None, (got, want, scale),
                       2 * Aa.numel() + 4 * (2 * p.numel()
                                             + (nn if vec_shift else 0)),
                       4 * Aa.numel() + 2 * p.numel(),
                       yardsticks={
                           "composed": lambda Aa=Aa, p=p, s=shift:
                               composed_normal(Aa, p, s),
                           "two matmul": lambda Aa=Aa, p=p: torch.matmul(
                               Aa.mT, torch.matmul(Aa, p.to(dt)[..., None]))})
            del got, want
        del A3h, Ao, mats, Aa
        torch.cuda.empty_cache()
        # gram on the FP64 tensor cores: A A^T of the bf16 Woodbury set-up,
        # A^T A of the dense set-up (the fp16 dense cell's too). The
        # products are exact and summed in f64 on both sides, so the kernel
        # is held to one f32 rounding of the plain version (rtol 2^-23),
        # and must equal itself bit for bit: symmetric, the general path's
        # full product of an equal copy, a repeat call. The bound counts
        # the symmetric work at the f64 tensor-core rate; the library
        # yardstick is the f64 torch.matmul the plain version runs, on
        # operands widened before the clock (the half-type matmul, which
        # sums in f32, is an extra yardstick of another function).
        grams = [(f"gram A^T A {tuple(An.shape)} {sfx}", An.to(dt))]
        if sfx == "bf16":
            grams.insert(0, (f"gram A A^T {tuple(A.shape)} {sfx}",
                             A.to(dt).mT))
        for label, X in grams:
            nb, mm, nx = X.shape
            got, want = gram.gram(X), ref.gram_ref(X)
            require(torch.equal(got, got.mT)
                    and torch.equal(got, gram.gram_xy(X, X.clone()))
                    and torch.equal(got, gram.gram(X)),
                    f"{label}: not bit-identical to its mirror, the full "
                    "product or a repeat call")
            Xd = X.double()
            kernel_row(f"gram_{sfx}", f"{label} (symmetric: nb nx (nx+1) m "
                                      "flop)",
                       lambda X=X: gram.gram(X), lambda X=X: ref.gram_ref(X),
                       lambda Xd=Xd: torch.matmul(Xd.mT, Xd),
                       (got, want, None),
                       2 * nb * mm * nx + 4 * nb * nx * nx,
                       nb * nx * (nx + 1) * mm, peak=PEAK_F64_TC_FLOPS,
                       tol=(2.0 ** -23, 0.0),
                       yardsticks={f"{sfx} matmul":
                                   lambda X=X: torch.matmul(X.mT, X)})
            del X, Xd, got, want
        del grams
        torch.cuda.empty_cache()
    report["normal_matvec_plans"] = plans

    # block_matvec / block_rmatvec: the Fig. 3 point with M = 4 blocks (the
    # first rows are the path's shape), and a ragged shape whose last block
    # is short and whose nb is not a multiple of 4
    M3 = 4
    Ar = torch.randn(2, 3_000, 1_001, device=dev, generator=g)
    for Ab, K in ((A3, 1), (A3, 3), (Ar, 1), (Ar, 3)):
        Nb, mb, nbb = Ab.shape
        nb = -(-nbb // M3)
        x = torch.randn(Nb, M3, nb, K, device=dev, generator=g)
        y = torch.randn(Nb, M3, mb, K, device=dev, generator=g)
        label = f"{tuple(Ab.shape)} M={M3} K={K}"
        nbytes = 4 * (Nb * mb * nbb + Nb * M3 * (nb + mb) * K)
        flops = 2 * Nb * mb * nbb * K
        view = (Ab.view(Nb, mb, M3, nb).transpose(1, 2)
                if nbb == M3 * nb else None)
        got, want = (block_matvec.block_matvec(Ab, x, M3),
                     ref.block_matvec_ref(Ab, x, M3))
        scale = float(ref.block_matvec_ref(Ab.abs(), x.abs(), M3).max())
        kernel_row("block_matvec", f"block_matvec {label}",
                   lambda Ab=Ab, x=x: block_matvec.block_matvec(Ab, x, M3),
                   lambda Ab=Ab, x=x: ref.block_matvec_ref(Ab, x, M3),
                   None if view is None else
                   (lambda view=view, x=x: torch.matmul(view, x)),
                   (got, want, scale), nbytes, flops)
        del got, want
        got, want = (block_matvec.block_rmatvec(Ab, y, M3),
                     ref.block_rmatvec_ref(Ab, y, M3))
        scale = float(ref.block_rmatvec_ref(Ab.abs(), y.abs(), M3).max())
        kernel_row("block_rmatvec", f"block_rmatvec {label}",
                   lambda Ab=Ab, y=y: block_matvec.block_rmatvec(Ab, y, M3),
                   lambda Ab=Ab, y=y: ref.block_rmatvec_ref(Ab, y, M3),
                   None if view is None else
                   (lambda view=view, y=y: torch.matmul(view.mT, y)),
                   (got, want, scale), nbytes, flops)
        del got, want
    # gram on every node's blocks, the strided (N, M, m, nb) view of A that
    # the feature split's set-up passes in one call
    Xb = A3.unflatten(-1, (M3, -1)).permute(0, 2, 1, 3)
    Nb, Mb, mb, nb = Xb.shape
    got, want = gram.gram(Xb), ref.gram_ref(Xb)
    require(torch.equal(got, got.mT), "gram A_j^T A_j: not symmetric")
    kernel_row("gram", f"gram A_j^T A_j {tuple(Xb.shape)} (every node's "
                       "blocks; symmetric: N M nb (nb+1) m flop)",
               lambda: gram.gram(Xb), lambda: ref.gram_ref(Xb),
               lambda: torch.matmul(Xb.mT, Xb),
               (got, want, float(ref.gram_ref(Xb.abs()).max())),
               4 * Nb * Mb * mb * nb + 4 * Nb * Mb * nb * nb,
               Nb * Mb * nb * (nb + 1) * mb)
    del got, want, Ar
    torch.cuda.empty_cache()

    # flash attention: the qwen3-8b prefill's shape first (4 prompts x 32
    # query heads over 8 KV heads, S = 2,048, Dh = 128), in bf16 and f32;
    # then ragged S, GQA groups 1, 3 and 8, Dh 64, non-causal, Sq != Sk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, Hq, Hkv, Sq, Sk, Dh, causal, dt in (
            (4, 32, 8, 2048, 2048, 128, True, torch.bfloat16),
            (4, 32, 8, 2048, 2048, 128, True, torch.float32),
            (1, 32, 32, 1000, 1000, 128, True, torch.bfloat16),
            (1, 24, 8, 1000, 1000, 128, True, torch.bfloat16),
            (2, 32, 4, 1000, 1000, 64, True, torch.bfloat16),
            (1, 32, 8, 512, 1024, 128, False, torch.bfloat16),
            (1, 32, 8, 300, 2048, 128, True, torch.float32)):
        q = torch.randn(B * Hq, Sq, Dh, device=dev, generator=g).to(dt)
        k = torch.randn(B * Hkv, Sk, Dh, device=dev, generator=g).to(dt)
        v = torch.randn(B * Hkv, Sk, Dh, device=dev, generator=g).to(dt)
        got = flash_attention.flash_attention_flat(q, k, v, causal=causal)
        want = ref.flash_attention_flat_ref(q.float(), k.float(), v.float(),
                                            causal=causal)
        require(got.dtype == dt, "flash_attention: output dtype")
        pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
                 else Sq * Sk)
        views = [t.view(B, -1, t.shape[1], Dh) for t in (q, k, v)]
        dname = str(dt).removeprefix("torch.")
        kernel_row(
            "flash_attention",
            f"flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} "
            f"{'causal' if causal else 'full'} {dname}",
            lambda q=q, k=k, v=v, c=causal:
                flash_attention.flash_attention_flat(q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal:
                ref.flash_attention_flat_ref(q, k, v, causal=c),
            lambda views=views, c=causal: sdpa(*views, is_causal=c,
                                               enable_gqa=True),
            (got, want, None),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4 * B * Hq * Dh * pairs,
            peak=PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS,
            tol=FLASH_TOL[dname])
        del q, k, v, views, got, want
    torch.cuda.empty_cache()
    phase("kernels", t0, "every kernel agrees with its plain version "
                         f"(rtol {RTOL}, atol {ATOL_PER_SCALE} x scale; "
                         f"flash_attention against the f32 computation at "
                         f"{FLASH_TOL})")

    # the projections past the one-launch limit: bilinear sends them to the
    # composed path, whose bracketing rounds run on the ladder_stats kernel
    t0 = time.perf_counter()
    nn = bisect_proj.MAX_N + 1
    require(not bisect_proj.plan(nn).one_launch,
            f"large_n: n={nn} should be past the one-launch limit")
    zb = torch.randn(nn, device=dev, generator=g)
    tb = (0.5 * zb.abs().sum()).reshape(())
    kb = nn / 5
    # ladder_stats at the shape this path gives it: |zb| against the first
    # round's 128 rungs lo + (hi - lo) * b / B over [0, max |zb|] (the row
    # whose time the kernels line reports); then an odd B at a partial
    # chunk. Counts exactly, sums at rtol / atol x sum |z|.
    azb = zb.abs()
    B = bisect_proj.RUNGS
    ar = torch.arange(1, B + 1, dtype=torch.float32, device=dev)
    lo = torch.zeros((), device=dev)
    for az, th in ((azb, lo + (azb.max() - lo) * ar / B),
                   (torch.rand(10_001, device=dev, generator=g),
                    torch.sort(torch.rand(7, device=dev,
                                          generator=g)).values)):
        want = ref.ladder_stats_ref(az, th)
        got = bisect_proj.ladder_stats(az, th)
        require(torch.equal(got[1], want[1]),
                f"ladder_stats n={az.shape[0]} B={th.shape[0]}: counts "
                "differ")
        kernel_row("ladder_stats",
                   f"ladder_stats n={az.shape[0]} B={th.shape[0]}",
                   lambda az=az, th=th: bisect_proj.ladder_stats(az, th),
                   lambda az=az, th=th: ref.ladder_stats_ref(az, th), None,
                   (got[0], want[0], float(az.sum())),
                   4 * (az.shape[0] + th.shape[0]) + 8 * th.shape[0],
                   4 * az.shape[0] * th.shape[0])
    del azb, az, th, got, want
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    z_l, t_l = bilinear.project_l1_epigraph(zb, tb)
    u_l, s_l = bilinear.support_skappa_ladder(zb, kb)
    torch.cuda.synchronize()
    large_counts = ops.launch_counts()
    require(large_counts["ladder_stats"] > 0
            and not any(large_counts[k] for k in PROJ_KERNELS),
            f"large_n: the projections took {large_counts}, not the "
            "ladder_stats rounds")
    scale = float(zb.abs().max())
    wz, wt = ref.l1_epigraph_proj_ref(zb, tb)
    wu, ws = ref.skappa_support_ref(zb, kb)
    err = max(check_close(torch, "large_n l1 z", z_l, wz, None,
                          rtol=PROJ_RTOL, atol=PROJ_ATOL_PER_MAX * scale),
              check_close(torch, "large_n l1 t", t_l, wt, None,
                          rtol=PROJ_RTOL, atol=PROJ_ATOL_PER_MAX * scale),
              check_close(torch, "large_n u_max", u_l, wu, None,
                          rtol=PROJ_RTOL, atol=PROJ_ATOL_PER_MAX * scale))
    require(torch.equal(s_l, ws), "large_n: s* differs from the plain one")
    report["large_n"] = {"n": nn, "launches": large_counts,
                         "max_abs_err": err}
    phase("large_n", t0, f"n={nn} (one past the one-launch limit): "
                         f"project_l1_epigraph + support_skappa_ladder "
                         f"through the ladder_stats rounds, launches "
                         f"{ {k: v for k, v in large_counts.items() if v} }; "
                         f"within {err:.3e} of the plain versions, s* equal")
    del zb, z_l, s_l, wz, ws

    def support_f1(est, x_true) -> float:
        got = est.support_.cpu().numpy()
        true = x_true != 0
        tp = float((got & true).sum())
        return 2 * tp / max(float(got.sum() + true.sum()), 1.0)

    def fit_phase(name, As, bs, x_true, kappa, backend, needed, est=None,
                  setup=False, cut="", needed_types=()):
        """Fit ``est`` (by default the Fig. 2 SparseLinearRegression) on
        the card with the launch counts set to 0 just before and read just
        after; with ``setup`` the solver's set-up runs first, timed on its
        own. The peak device memory above the start is recorded, and
        ``cut`` says how the cell was cut to size. ``needed_types``: the
        instantiations (``"matvec_bf16"``, ...) that must launch; a fit of
        bf16 / fp16 data must launch no f32 instantiation of gram, matvec,
        rmatvec or normal_matvec."""
        t_ph = time.perf_counter()
        if est is None:
            est = api.SparseLinearRegression(kappa=kappa, gamma=10.0,
                                             rho_c=4.0, max_iter=60, tol=0.0)
        require(est.device.type == "cuda", f"{name}: estimator not on cuda")
        Nn, mm, nn = As.shape
        solver = est._adapter.solver
        kind_ = ("feature split" if solver.cfg.use_feature_split
                 else solver._x_engine(mm, nn).kind
                 if solver.loss.name == "squared" else "newton-cg")
        require(kind_ == backend, f"{name}: x-update took {kind_}, "
                                  f"expected {backend}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t_fit = time.perf_counter()
        if setup:
            # the fit below finds these factors in the solver's set-up
            # cache (keyed on the same data tensors)
            solver._setup(As, bs)
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_fit
        t_fit = time.perf_counter()
        est.fit(As, bs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_fit
        counts = ops.launch_counts()
        by_type = ops.launch_counts_by_type()
        peak = torch.cuda.max_memory_allocated() - mem0
        res = est.result_
        for k_name in needed:
            require(counts[k_name] > 0, f"{name}: kernel {k_name} was not "
                                        "launched on the path")
        for k_name in needed_types:
            require(by_type.get(k_name, 0) > 0,
                    f"{name}: {k_name} was not launched on the path")
        if solver.cfg.precision.data is not None:
            f32 = {k: v for k, v in by_type.items() if k.endswith("_f32")}
            require(not any(f32.values()),
                    f"{name}: reduced-precision fit launched {f32}")
        require(bool(torch.isfinite(res.z).all())
                and bool(torch.isfinite(res.coef).all()),
                f"{name}: non-finite iterates")
        status = SolveStatus(int(res.status))
        require(status != SolveStatus.DIVERGED, f"{name}: DIVERGED")
        iters = int(res.iters)
        score = est.score(As, bs)
        f1 = support_f1(est, x_true)
        out = {"x_solver": kind_, "iters": iters, "status": status.name,
               "fit_s": wall, "s_per_outer_iter": wall / max(iters, 1),
               "launches": counts, "launches_by_type": by_type,
               "launches_per_outer_iter": {k: v / max(iters, 1)
                                           for k, v in counts.items()},
               "support_f1": f1, est._score_kind: score,
               "peak_bytes_above_start": peak}
        if setup:
            out["setup_s"] = setup_s
        report[name] = out
        setup_txt = f"set-up {setup_s:.3f} s, " if setup else ""
        phase(name, t_ph, f"N={Nn} m={mm} n={nn} kappa={kappa}{cut} via "
                          f"{kind_}: "
                          f"{iters} iters, {status.name}, {setup_txt}fit "
                          f"{wall:.3f} s ({wall / max(iters, 1) * 1e3:.2f} "
                          f"ms/outer iter), launches "
                          f"{ {k: v for k, v in counts.items() if v} }, by "
                          f"type {by_type}, support F1 "
                          f"{f1:.4f}, {est._score_kind} {score:.6f}, peak "
                          f"device memory above the start "
                          f"{peak / 1e9:.3f} GB")
        return est

    # 4. the main path at full width ---------------------------------------
    est = fit_phase("woodbury", A, torch.as_tensor(bs_w, device=dev), xt_w,
                    wide.kappa, "woodbury", MAIN_KERNELS, setup=True)
    main_counts = report["woodbury"]["launches"]
    # normal_matvec runs in the PCG polish, on the stacked (N m, n) A
    per_call = matvec.normal_plan(1, N * m, n, None, A.data_ptr() % 16 == 0,
                                  matvec.sm_count(dev)).launches
    report["woodbury"]["normal_matvec"] = {
        "launches": main_counts["normal_matvec"],
        "calls": main_counts["normal_matvec"] / per_call}
    print(f"  normal_matvec in the woodbury fit (PCG polish): "
          f"{main_counts['normal_matvec'] // per_call} calls, "
          f"{main_counts['normal_matvec']} launches ({per_call} a call)",
          flush=True)

    def profile_phase(name, est_kw, As, bs, state):
        """Where the time goes: two more outer iterations (no polish) from
        ``state``, first with the profiler off, then on."""
        t0 = time.perf_counter()
        prof_est = api.SparseLinearRegression(max_iter=2, tol=0.0,
                                              polish=False, **est_kw)
        prof_est.fit(As, bs, state=state)           # set-up outside
        torch.cuda.synchronize()
        t_w = time.perf_counter()
        prof_est.fit(As, bs, state=state)
        torch.cuda.synchronize()
        window_off = time.perf_counter() - t_w
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_w = time.perf_counter()
            prof_est.fit(As, bs, state=state)
            torch.cuda.synchronize()
            window = time.perf_counter() - t_w
        on_device = device_table(prof)
        # a device-to-host read of a scalar
        syncs = sum(ev.count for ev in prof.key_averages()
                    if ev.key == "aten::_local_scalar_dense")
        busy_ms = sum(v["device_ms"] for v in on_device.values())
        n_dev = sum(v["calls"] for v in on_device.values())
        top = sorted(on_device.items(),
                     key=lambda kv: -kv[1]["device_ms"])[:8]
        report[name] = {
            "outer_iters": 2, "window_s_profiler_off": window_off,
            "window_s_profiler_on": window, "device_busy_ms": busy_ms,
            "device_ops": n_dev, "host_syncs": syncs, "top": dict(top),
            "all_device_ops": on_device}
        if busy_ms > 0:
            phase(name, t0, f"2 outer iterations: wall "
                            f"{window_off * 1e3:.1f} ms (profiler off), "
                            f"{window * 1e3:.1f} ms (on); device busy "
                            f"{busy_ms:.1f} ms in {n_dev} kernels and "
                            f"copies, {syncs} host syncs; idle share "
                            f"{1 - busy_ms / (window_off * 1e3):.3f} "
                            f"(profiler off) / "
                            f"{1 - busy_ms / (window * 1e3):.3f} (on); top: "
                            + "; ".join(f"{k[:40]} {v['device_ms']:.2f} ms"
                                        f"/{v['calls']}"
                                        for k, v in top[:4]))
        else:
            phase(name, t0, "the profiler reported no device time: "
                            "device busy share not measured")

    profile_phase("profile", dict(kappa=wide.kappa, gamma=10.0, rho_c=4.0),
                  torch.as_tensor(As_w, device=dev),
                  torch.as_tensor(bs_w, device=dev), est.result_.state)

    # 4b. the same point in bf16: A and b cast on the card once, before the
    # clock, so the fit reads the 2-byte data in place
    A16 = A.to(torch.bfloat16)
    b16 = torch.as_tensor(bs_w, device=dev).to(torch.bfloat16)
    fit_phase("woodbury_bf16", A16, b16, xt_w, wide.kappa, "woodbury",
              MAIN_KERNELS, est=api.SparseLinearRegression(
                  kappa=wide.kappa, gamma=10.0, rho_c=4.0, max_iter=60,
                  tol=0.0, precision="bf16"), setup=True,
              needed_types=("gram_bf16", "matvec_bf16", "rmatvec_bf16",
                            "normal_matvec_bf16"))
    del A16, b16

    # 5. the dense regime ---------------------------------------------------
    fit_phase("dense", As_n, bs_n, xt_n, narrow.kappa, "dense",
              (*PROJ_KERNELS, "gram", "rmatvec"))
    fit_phase("dense_fp16", torch.as_tensor(As_n, device=dev).to(
                  torch.float16),
              torch.as_tensor(bs_n, device=dev).to(torch.float16), xt_n,
              narrow.kappa, "dense", (*PROJ_KERNELS, "gram", "rmatvec"),
              est=api.SparseLinearRegression(
                  kappa=narrow.kappa, gamma=10.0, rho_c=4.0, max_iter=60,
                  tol=0.0, precision="fp16"),
              needed_types=("gram_f16", "rmatvec_f16"))

    # 6. Fig. 3's smallest point through the feature split ------------------
    est3 = fit_phase("fig3", A3, b3, xt_3, fig3.kappa, "feature split",
              (*PROJ_KERNELS, "gram", *BLOCK_KERNELS),
              est=api.SparseLinearRegression(
                  kappa=fig3.kappa, gamma=10.0, rho_c=4.0, max_iter=60,
                  tol=0.0, n_feature_blocks=M3), setup=True)
    a_bytes = A3.numel() * A3.element_size()
    peak = report["fig3"]["peak_bytes_above_start"]
    require(peak < 0.25 * a_bytes,
            f"fig3: the fit's peak device memory above its start, "
            f"{peak / 1e9:.3f} GB, is not under a quarter of A's "
            f"{a_bytes / 1e9:.2f} GB: a copy of A was made")
    block_counts = report["fig3"]["launches"]
    profile_phase("profile_fig3", dict(kappa=fig3.kappa, gamma=10.0,
                                       rho_c=4.0, n_feature_blocks=M3),
                  A3, b3, est3.result_.state)
    del est3

    # 6b. the same point and data through the PCG x-update -----------------
    # (Fig. 3's x_solver="auto", no feature split, polish on). The CG steps
    # and the wall time (host clock, synchronised) of each pcg call are
    # taken around the solver's prox.pcg; the fit runs with the kernel, then
    # with the solver's normal_matvec bound to the composition, in turns
    # (kernel, composition, composition, kernel).
    cg_steps = {"x-update": [], "polish": []}
    cg_secs = {"x-update": 0.0, "polish": 0.0}
    plain_pcg = prox.pcg
    bound_normal = (prox.normal_matvec_auto, bicadmm.normal_matvec_auto)

    def counted_pcg(mv, rhs, x0, precond, iters, tol):
        calls = [0]

        def counted(v):
            calls[0] += 1
            return mv(v)
        t_cg = time.perf_counter()
        out = plain_pcg(counted, rhs, x0, precond, iters, tol)
        torch.cuda.synchronize()
        kind_ = "polish" if rhs.ndim == 1 else "x-update"
        cg_secs[kind_] += time.perf_counter() - t_cg
        cg_steps[kind_].append(calls[0] - 1)
        return out

    def bind_normal(fn):
        prox.normal_matvec_auto = bicadmm.normal_matvec_auto = fn

    def pcg_est():
        return api.SparseLinearRegression(kappa=fig3.kappa, gamma=10.0,
                                          rho_c=4.0, max_iter=60, tol=0.0)

    pcg_runs = {}
    kernel_needs = (*PROJ_KERNELS, "rmatvec", "normal_matvec")
    composed_needs = (*PROJ_KERNELS, "matvec", "rmatvec")
    prox.pcg = counted_pcg
    try:
        for name, fn, needed in (
                ("pcg", bound_normal[0], kernel_needs),
                ("pcg_composed", composed_normal, composed_needs),
                ("pcg_composed_2", composed_normal, composed_needs),
                ("pcg_2", bound_normal[0], kernel_needs)):
            bind_normal(fn)
            for v in cg_steps.values():
                v.clear()
            cg_secs.update(dict.fromkeys(cg_secs, 0.0))
            est_p = fit_phase(name, A3, b3, xt_3, fig3.kappa, "pcg", needed,
                              est=pcg_est(), setup=True,
                              cut=" (polish on)")
            rep_p = report[name]
            iters = max(rep_p["iters"], 1)
            calls = sum(s_ + 1 for v in cg_steps.values() for s_ in v)
            rep_p["cg_steps"] = {k: list(v) for k, v in cg_steps.items()}
            rep_p["cg_steps_per_outer_iter"] = (sum(cg_steps["x-update"])
                                                / iters)
            rep_p["pcg_s"] = dict(cg_secs)
            rep_p["normal_matvec_calls"] = calls
            pcg_runs[name] = est_p
            print(f"  {name}: {rep_p['s_per_outer_iter'] * 1e3:.2f} ms per "
                  f"outer iteration, of which the PCG x-update "
                  f"{cg_secs['x-update'] / iters * 1e3:.2f} ms; CG steps "
                  f"per outer iteration "
                  f"{rep_p['cg_steps_per_outer_iter']:.2f}; polish "
                  f"{sum(cg_steps['polish'])} CG steps in "
                  f"{cg_secs['polish'] * 1e3:.2f} ms; normal_matvec calls "
                  f"{calls}, launches "
                  f"{rep_p['launches']['normal_matvec']}", flush=True)
    finally:
        prox.pcg = plain_pcg
        bind_normal(bound_normal[0])
    pcg_counts = report["pcg"]["launches"]
    # every call on this path has two launches (normal_plan at (8, 25,000,
    # 4,000) and (200,000, 4,000)); the composed run launches none
    require(pcg_counts["normal_matvec"]
            == 2 * report["pcg"]["normal_matvec_calls"],
            f"pcg: {pcg_counts['normal_matvec']} normal_matvec launches for "
            f"{report['pcg']['normal_matvec_calls']} calls, not 2 a call")
    for name in ("pcg_composed", "pcg_composed_2"):
        require(report[name]["launches"]["normal_matvec"] == 0,
                f"{name}: the composition launched normal_matvec")
    for name in pcg_runs:
        peak = report[name]["peak_bytes_above_start"]
        require(peak < 0.25 * a_bytes,
                f"{name}: the fit's peak device memory above its start, "
                f"{peak / 1e9:.3f} GB, is not under a quarter of A's "
                f"{a_bytes / 1e9:.2f} GB: a copy of A was made")
    ms = {k: report[k]["s_per_outer_iter"] * 1e3 for k in pcg_runs}
    xu = {k: report[k]["pcg_s"]["x-update"] / max(report[k]["iters"], 1)
          * 1e3 for k in pcg_runs}
    print("  pcg A/B, ms per outer iteration (of which the PCG x-update): "
          + "; ".join(f"{k} {ms[k]:.2f} ({xu[k]:.2f})" for k in pcg_runs),
          flush=True)
    # where the time goes, with the kernel and with the composition
    for name, fn in (("profile_pcg", bound_normal[0]),
                     ("profile_pcg_composed", composed_normal)):
        bind_normal(fn)
        try:
            profile_phase(name, dict(kappa=fig3.kappa, gamma=10.0,
                                     rho_c=4.0),
                          A3, b3, pcg_runs["pcg"].result_.state)
        finally:
            bind_normal(bound_normal[0])
    del pcg_runs, est_p

    # 6c. the same fit in bf16: A (1.6 GB) and b cast on the card once,
    # before the clock; no copy of A, so the peak stays under a quarter of
    # the bf16 A
    A3h, b3h = A3.to(torch.bfloat16), b3.to(torch.bfloat16)
    del A3, b3
    torch.cuda.empty_cache()
    cg_steps["x-update"].clear()
    cg_steps["polish"].clear()
    cg_secs.update(dict.fromkeys(cg_secs, 0.0))
    prox.pcg = counted_pcg
    try:
        fit_phase("pcg_bf16", A3h, b3h, xt_3, fig3.kappa, "pcg",
                  kernel_needs, est=api.SparseLinearRegression(
                      kappa=fig3.kappa, gamma=10.0, rho_c=4.0, max_iter=60,
                      tol=0.0, precision="bf16"), setup=True,
                  cut=" (polish on)",
                  needed_types=("normal_matvec_bf16", "rmatvec_bf16"))
    finally:
        prox.pcg = plain_pcg
    rep_h = report["pcg_bf16"]
    iters = max(rep_h["iters"], 1)
    rep_h["cg_steps"] = {k: list(v) for k, v in cg_steps.items()}
    rep_h["cg_steps_per_outer_iter"] = sum(cg_steps["x-update"]) / iters
    rep_h["pcg_s"] = dict(cg_secs)
    a_half = A3h.numel() * A3h.element_size()
    require(rep_h["peak_bytes_above_start"] < 0.25 * a_half,
            f"pcg_bf16: the fit's peak device memory above its start, "
            f"{rep_h['peak_bytes_above_start'] / 1e9:.3f} GB, is not under "
            f"a quarter of the bf16 A's {a_half / 1e9:.2f} GB")
    print(f"  pcg_bf16: {rep_h['s_per_outer_iter'] * 1e3:.2f} ms per outer "
          f"iteration, of which the PCG x-update "
          f"{cg_secs['x-update'] / iters * 1e3:.2f} ms; CG steps per outer "
          f"iteration {rep_h['cg_steps_per_outer_iter']:.2f}; polish "
          f"{sum(cg_steps['polish'])} CG steps in "
          f"{cg_secs['polish'] * 1e3:.2f} ms", flush=True)
    del A3h, b3h
    torch.cuda.empty_cache()

    # 7. classification through the feature split (rows cut to m = 5,000) --
    for name, spec_c, make, cls, kw_c in (
            ("classify_logistic", SyntheticSpec(8, 5_000, 4_000),
             make_sparse_classification, api.SparseLogisticRegression, {}),
            ("classify_softmax", SyntheticSpec(8, 5_000, 4_000, n_classes=3),
             make_sparse_softmax, api.SparseSoftmaxRegression,
             dict(n_classes=3))):
        As_c, bs_c, xt_c = make(0, spec_c)
        kappa_c = int((xt_c != 0).sum())
        est_c = cls(kappa=kappa_c, gamma=10.0, rho_c=1.0, max_iter=30,
                    tol=0.0, n_feature_blocks=M3, **kw_c)
        fit_phase(name, torch.as_tensor(As_c, device=dev),
                  torch.as_tensor(bs_c, device=dev),
                  xt_c.reshape(-1), kappa_c, "feature split",
                  (*PROJ_KERNELS, "gram", "matvec", "rmatvec",
                   *BLOCK_KERNELS), est=est_c,
                  cut=" (rows cut from Fig. 3's 25,000 per node; 30 "
                      "iterations)")
        del As_c, est_c
    torch.cuda.empty_cache()
    # 7b. the same two fits in bf16 through the Newton-CG prox (the feature
    # split is not ported under bf16): data cast on the card before the
    # clock
    for name, spec_c, make, cls, kw_c in (
            ("classify_bf16_logistic", SyntheticSpec(8, 5_000, 4_000),
             make_sparse_classification, api.SparseLogisticRegression, {}),
            ("classify_bf16_softmax",
             SyntheticSpec(8, 5_000, 4_000, n_classes=3),
             make_sparse_softmax, api.SparseSoftmaxRegression,
             dict(n_classes=3))):
        As_c, bs_c, xt_c = make(0, spec_c)
        kappa_c = int((xt_c != 0).sum())
        est_c = cls(kappa=kappa_c, gamma=10.0, rho_c=1.0, max_iter=30,
                    tol=0.0, precision="bf16", **kw_c)
        fit_phase(name, torch.as_tensor(As_c, device=dev).to(torch.bfloat16),
                  torch.as_tensor(bs_c, device=dev).to(torch.bfloat16),
                  xt_c.reshape(-1), kappa_c, "newton-cg",
                  (*PROJ_KERNELS, "matvec", "rmatvec"), est=est_c,
                  cut=" (rows cut from Fig. 3's 25,000 per node; 30 "
                      "iterations)",
                  needed_types=("matvec_bf16", "rmatvec_bf16"))
        del As_c, est_c
    torch.cuda.empty_cache()

    # 7c. the composed projections in a fit: the squared loss one entry
    # past the one-launch limit (n = MAX_N + 1, kappa = 0.2 n as Fig. 2 sets
    # it, 3 outer iterations, polish off as benchmarks/fig23_scaling.py
    # fits), so every (7b) and (7c) projection runs its bracketing rounds
    # on ladder_stats; then ladder_stats' device time in a profiler window
    # of 2 outer iterations
    big = SyntheticSpec(8, 200, bisect_proj.MAX_N + 1, sparsity_level=0.8)
    As_l, bs_l, xt_l = make_sparse_regression(0, big)
    A_l = torch.as_tensor(As_l, device=dev)
    b_l = torch.as_tensor(bs_l, device=dev)
    del As_l
    est_l = fit_phase(
        "large_n_fit", A_l, b_l, xt_l, big.kappa, "woodbury",
        ("ladder_stats", "gram", "matvec", "rmatvec"),
        est=api.SparseLinearRegression(kappa=big.kappa, gamma=10.0,
                                       rho_c=4.0, max_iter=3, tol=0.0,
                                       polish=False),
        setup=True, cut=" (3 outer iterations, polish off)")
    rep_l = report["large_n_fit"]
    require(not any(rep_l["launches"][k] for k in PROJ_KERNELS),
            f"large_n_fit: a one-launch projection ran: {rep_l['launches']}")
    profile_phase("profile_large_n", dict(kappa=big.kappa, gamma=10.0,
                                          rho_c=4.0),
                  A_l, b_l, est_l.result_.state)
    prof_l = report["profile_large_n"]
    lad = [v for k, v in prof_l["all_device_ops"].items()
           if "ladder_kernel" in k]
    require(lad, "large_n_fit: the profiler saw no ladder_stats kernel")
    lad_ms = sum(v["device_ms"] for v in lad)
    lad_calls = sum(v["calls"] for v in lad)
    rep_l["ladder_stats_profile"] = {
        "outer_iters": prof_l["outer_iters"], "device_ms": lad_ms,
        "calls": lad_calls, "ms_a_call": lad_ms / max(lad_calls, 1)}
    print(f"  large_n_fit: {rep_l['s_per_outer_iter'] * 1e3:.2f} ms per "
          f"outer iteration; ladder_stats "
          f"{rep_l['launches_per_outer_iter']['ladder_stats']:.1f} launches "
          f"per outer iteration; in the profiler window of "
          f"{prof_l['outer_iters']} outer iterations {lad_calls} calls, "
          f"{lad_ms:.3f} ms of device time "
          f"({lad_ms / max(lad_calls, 1) * 1e3:.2f} us a call)", flush=True)
    del A_l, b_l, est_l
    torch.cuda.empty_cache()

    # 8. the card against the port's own CPU fit ---------------------------
    for key, what, cls, kw, As_p, bs_p in parity_fits():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        on_card = cls(**kw).fit(As_p, bs_p).result_
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        parity_types = ops.launch_counts_by_type()
        on_cpu = cls(device="cpu", **kw).fit(As_p, bs_p).result_
        require(int(on_card.status) == int(on_cpu.status),
                f"{key}: status {int(on_card.status)} on the card, "
                f"{int(on_cpu.status)} on the CPU")
        require(torch.equal(on_card.support.cpu(), on_cpu.support),
                f"{key}: supports differ")
        coef_err = float((on_card.coef.cpu() - on_cpu.coef).abs().max())
        require(torch.allclose(on_card.coef.cpu(), on_cpu.coef, rtol=1e-3,
                               atol=1e-3),
                f"{key}: coef differs by {coef_err}")
        require(abs(int(on_card.iters) - int(on_cpu.iters)) <= 2,
                f"{key}: iterations {int(on_card.iters)} vs "
                f"{int(on_cpu.iters)}")
        report[key] = {
            "iters_card": int(on_card.iters), "iters_cpu": int(on_cpu.iters),
            "status": SolveStatus(int(on_card.status)).name,
            "coef_max_abs_diff": coef_err, "card_fit_s": t_card,
            "launches_by_type": parity_types}
        phase("parity", t0, f"{what}: card {int(on_card.iters)} iters vs "
                            f"CPU {int(on_cpu.iters)}, same status "
                            f"{SolveStatus(int(on_card.status)).name} and "
                            f"support, coef max abs diff {coef_err:.2e}")

    # 9. the LM serving path; 10. its parity checks
    lm_counts = lm_phase(torch, dev, report)
    lm_parity_phase(torch, dev, report)

    # launches: each kernel's count from the full-width path that runs it
    # (the Fig. 2 Woodbury fit, the Fig. 3 feature-split fit, the Fig. 3
    # PCG fit, the qwen3-8b prefill and decode, the projections past the
    # one-launch limit); the bf16 instantiations' from woodbury_bf16 and
    # pcg_bf16, the fp16 ones' from dense_fp16 and the fp16 parity fits
    # (no full-width fp16 cell runs matvec or normal_matvec)
    half_counts = {
        "gram_bf16": "woodbury_bf16", "matvec_bf16": "woodbury_bf16",
        "rmatvec_bf16": "woodbury_bf16", "normal_matvec_bf16": "pcg_bf16",
        "gram_f16": "dense_fp16", "rmatvec_f16": "dense_fp16",
        "matvec_f16": "parity_woodbury_fp16",
        "normal_matvec_f16": "parity_pcg_fp16"}
    kernels = []
    for name in (*ops.KERNELS, *HALF_KERNELS):
        row = dict(rows[name])
        for key in ("shape", "call_ms", "yardsticks_ms"):
            row.pop(key)
        if name in half_counts:
            row["launches"] = report[half_counts[name]][
                "launches_by_type"].get(name, 0)
            row["launches_in"] = half_counts[name]
            require(row["launches"] > 0, f"{name}: no launch in "
                                         f"{half_counts[name]}")
        else:
            counts = (lm_counts if name == "flash_attention" else
                      block_counts if name in BLOCK_KERNELS else
                      large_counts if name == "ladder_stats" else
                      pcg_counts if name == "normal_matvec" else
                      main_counts)
            row["launches"] = counts[name]
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
