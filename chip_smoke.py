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
              (8, 25,000, 4,000), that fit's polish (200,000, 4,000) and
              the spectral Woodbury refinement's (8, 800, 10,000) with its
              scalar shift sigma + rho_c (path_gamma runs it), beside the composition of the matvec and rmatvec kernels
              and two torch.matmul calls; two calls must agree bit for bit.
              The bf16 / fp16 instantiations of matvec, rmatvec and
              normal_matvec are held and timed the same way at the
              reduced-precision cells' shapes, beside their bound with
              2-byte A and torch.matmul on the half-width operands, plus an
              odd-n view one element past 16 bytes; the bf16 / fp16 gram
              (on the FP64 tensor cores) beside its bound at the f64
              tensor-core rate and the f64 torch.matmul. The lane
              projections at the fleet's (10,000, 16) and (2,000, 64)
              against their plain versions and, lane by lane, against the
              solo kernel (bit for bit); gram, matvec, rmatvec and
              normal_matvec at the fleet's (B N, m, n) views. The bf16 /
              fp16 block_matvec and block_rmatvec at the sharded engine's
              per-rank block (1, 25,000, 1,000) with K = 1 and 3, at
              Fig. 3's (8, 25,000, 4,000) with M = 4, at the ragged
              (2, 3,000, 1,001) and (fp16) at sharded_fp16's one-node
              block (1, 25,000, 4,000), held to the f32-accumulation bound
              1e-5 x scale + 1e-6 and two calls bit for bit, beside
              torch.matmul on the half-width block view, each with the
              plan it ran (route, tiles, ring, threads, CTAs, launches);
              the f32 ones also at the sharded cell's (1, 25,000, 1,000).
              Flash attention at the qwen3-8b prefill's shape (Dh 128)
              and at the zamba2-2.7b prefill's, q, k and v
              (128, 2,048, 80), beside SDPA; ragged, GQA and non-causal
              cases and the other head dims between multiples of 64.
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
   fp64_polish — the woodbury point under ``precision="fp64_polish"``:
              every l1 projection on the kernel's f64-polish instantiation;
              ms an outer iteration beside the woodbury fit's, that kernel
              against its plain version and beside the f32 one at d =
              10,000, the certificate and the projection's KKT residual
              under both presets. fp64_polish_lanes: fleet_sq (B = 10,000,
              m = 32, n = 16) through ``fit_many`` in fp64_polish, the lane
              kernel's f64 instantiation 121 launches an outer iteration, 8
              lanes in their solo fits' band.
   recovery — at the woodbury point, each ladder rung the genuine fix,
              driven by ``faults.inject``: retry (limit=1), rho_restart
              (where rho_c < 5), precision (bf16, where the data is bf16)
              and exhaustion (max_attempts=2); the x-solver fallback (PCG
              poisoned) on the Woodbury parity data. Prints each log and
              each rung's wall time.
   stream_dense — ``api.stream`` at n = 2,048 (DENSE_MAX_N), 12 chunks of
              256 rows of benchmarks/stream_bench.py's data and config
              (kappa 8, gamma 20, rho_c 2, tol 1e-3; max_iter cut to 60 a
              refit), window 8 chunks (four rank-256 downdates): ms a chunk
              for absorb, evict and refit, the maintained factor against
              chol(G + cI) in f64 at every chunk, the final refit against a
              batch fit on the window; the Cholesky kernel at (2,048, 256)
              timed beside one cholesky_ex of the updated matrix, given
              and formed (L L^T + V V^T); chol_rank_update bit for bit
              against its plain version (on the card) at (256, 16) and at
              (500, 33), a grid of 32 x 32 tiles, update and downdate.
   stream_woodbury — the same at Fig. 2's width n = 10,000, chunks of 800
              rows, window 8 (6,400 rows), 10 chunks (two rank-800
              evictions), and the Cholesky kernel at (6,400, 800) beside
              the same yardsticks.
5. dense    — Fig. 2's smallest point (n = 1,000, kappa = 200) through the
              dense factorization and the dense polish.
   dense_fp16 — the same point in fp16 (``precision="fp16"``).
   path     — the hyperparameter path at the woodbury point and data
              (gamma = 10, rho_c = 4, 30 iterations a point, tol 1e-4), over
              kappa_ladder(10,000, 8, hi_frac=0.25) in descending order:
              a warm ``fit_path`` (the set-up inside its counted window),
              ``fit_path(warm_start=False)`` and ``fit_grid``. Prints each
              point's kappa, iterations, status, cardinality and training
              loss, the iteration totals and wall times, and each run's
              launches. No point may diverge or leave a non-finite
              iterate, the cardinality stays within kappa, ``fit_grid``
              (the points on lanes) keeps each point's status and
              iterations of the cold scan (how far the unconverged
              supports and iterates differ is printed; path_converge holds
              the grid to the band), the scans launch skappa_support once
              per outer iteration and the grid each lane kernel once a step
              for all points, and ladder_stats never launches. No point
              converges in 30 iterations, so warm and cold spend the same
              (depth cut from 60 in PR 22 for the new phases' time); path_converge
              (phase 8) measures the warm start's saving.
   path_gamma — the woodbury point at kappa = 2,000 (tol 0, as the
              woodbury phase) through ``fit_grid`` over gamma = 1, 3.16,
              10, 31.6 on the spectral Woodbury factors: one gram launch
              for the set-up (eigh of A A^T), the points on lanes, and the
              gamma = 10 point against the woodbury phase's static fit:
              the same status and iterations (tol 0: both max_iter); how
              many support entries, and how far coef and z before the
              polish, differ is printed (the top-kappa support of an
              unconverged z moves with the products' summation order).
              Prints the set-up time and ms per outer iteration beside the
              static fit's.
   path_dense — a 3-point gamma grid at the dense point through the
              spectral dense factors (ridge_setup_eigh), against the dense
              phase's fit at gamma = 10 the same way.
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
              Woodbury. The CPU side of phase 8 (these fits at torch's
              default thread count, parity_path's at 2 threads) runs in a
              worker process from the build on, beside phases 3 to 8.
   parity_path — on the Woodbury parity data, card against CPU: a 4-point
              warm kappa path, and a warm 3-point (kappa, gamma, rho_c)
              path through the spectral Woodbury factors and through PCG;
              at every point the same status and support, coef within
              1e-3, iterations within 2.
   path_converge — the warm kappa path of parity_path against its cold
              scan on the card (``fit_path(warm_start=False)``): every
              point must converge; prints each run's outer iterations
              and time, and the share the warm start saves; then
              ``fit_grid`` (the points on lanes) with every point in the
              cold scan's band.
9. lm       — the dense LM's serving path at full width and depth:
              qwen3-8b (36 layers, 8.19e9 parameters drawn on the card
              from seed 0, 16.4 GB in bf16), 4 prompts of 2,048 tokens
              (numpy seed 0) through ``zoo.prefill`` (max_seq 2,080), then
              32 greedy ``zoo.decode_step``s. Each prefill must launch the
              flash-attention kernel once per layer, a decode step never.
              Prints the prefill's time and prompt tokens per second, the
              decode time per token, the launches and idle share of a
              profiled window of 2 decode steps, the peak device memory
              above the phase's start and the flash kernel's share of the
              prefill's device time (profiler).
10. lm_parity — (a) qwen3-8b at full width cut to 2 layers, bf16: prefill
              and decode through the kernel against the same model through
              the plain ``impl="full"``, and the first layer's attention
              output on the kernel path against the f32 attention of the
              same q, k and v within one bf16 rounding; (b) the reduced f32
              config, card
              against the port's CPU run; (c) decode after prefill against
              the forward pass on the card, 2 layers at full width in f32.
11. fleet   — the fleet driver (``api.fit_many``) at
              benchmarks/fleet_bench.py's settings (kappa 4, gamma 5,
              rho_c 1, 100 iterations, tol 1e-3; its data, seed 0), run
              before phases 9 and 10: fleet_sq (B = 10,000, N = 1, m = 32,
              n = 16, squared), fleet_sq_wide (B = 2,000, m = 128, n = 64)
              and fleet_sq_wide_het (per-lane kappa 4 / 8 / 12 / 16 and
              gamma 1 / 5 / 25: the spectral factors), fleet_logistic (that
              shape, labels sign(A x*), examples/lm_sparse_probe.py's gamma
              1,000 and tol 1e-3, rho_c 10, cut to 20 iterations: Newton-CG
              on lanes), fleet_list (64 problems, m in {24, 32, 40}, n 16,
              through the sequence input, with the corrected train losses),
              fleet_caps (iter_caps 0 / 3 / 100 / 7 on 1,000 lanes: ABORTED
              and inert lanes) and fleet_warm (a refit from the returned
              state); after fleet_sq, fleet_sq_window: two more of its
              outer iterations from its state under the profiler (device
              ops, host syncs, idle share, the lane kernels' device ms;
              244 lane launches required, by the wrappers' counts and in
              the trace, which is taken again, up to 3 times, while it
              lacks kernel records). Each stacked part holds 4 lanes
              spread over the fleet against solo card fits (the same
              status, support, coef within
              1e-3, iterations within 2; the count that match to the
              iteration is printed), checks 121 l1 and 1 S^kappa lane
              launches an outer iteration, and prints fits per second, the
              wall time, outer iterations (mean and max), the solo loop
              extrapolated to B as fleet_bench does, the launches and the
              peak device memory above the fleet's start.

12. sharded — the sharded engine (``engine="sharded"``) on 8 spawned
              ranks as a (nodes = 2, feat = 4) grid on the one card, each
              rank Fig. 3's A_ij (25,000 x 1,000) of Fig. 3's point cut to
              N = 2 nodes (seed 0; kappa 800, gamma 10, rho_c 4, the
              sub-solver, ladder_exact, SHARDED_ITERS outer iterations:
              the depth cut), through gloo (NCCL refuses two ranks on one
              device, so every collective is staged through the host):
              every rank's result the same, held to the single-process
              feature split (n_feature_blocks = 4, polish off) on the same
              data in the band (status, support, coef within 1e-3,
              iterations within 2); ms an outer iteration, launches and
              collectives (and their host time) an outer iteration, and
              peak memory, by rank.
   sharded_bf16 — the same grid and data under ``precision="bf16"``:
              every rank launches the bf16 block kernels and no f32 ones;
              finite, not DIVERGED; its support's agreement with the f32
              fit.
   sharded_cg — a (1, 1) grid on NCCL in this process, one node of that
              data (25,000 x 4,000), x_update "auto" (cg: nb = 4,000 >
              2,048), SHARDED_CG_ITERS outer iterations, held to the
              single-process PCG x-update (polish off) in the band.
   sharded_fp16 — the same node in fp16 through the engine directly
              (the api certifies float32 and bfloat16 for the sharded
              engine, as the JAX package): the f16 block kernels launch;
              its ms an outer iteration (set-up included) and launches by
              type.
13. zamba2   — the hybrid LM's serving path at full width and depth, with
              the lm phase's traffic and checks: zamba2-2.7b (54 Mamba2
              layers in 9 groups of 6, each group followed by the one
              shared attention + MLP block of 32 heads of dim 80; 2.42e9
              parameters drawn on the card from seed 0, 4.85 GB in bf16).
              Each prefill must launch the flash kernel at head dim 80 once
              a group (9 times), a decode step never.
14. zamba2_parity — (a) zamba2-2.7b at full width cut to 2 groups (12
              Mamba2 layers, 2 applications of the shared block), bf16,
              4 x 2,048: the kernel path against ``impl="full"``, the
              shared block's first attention output held to one bf16
              rounding of the f32 attention of its q, k and v; (b) the
              reduced config at head dim 80 (4 layers, d_model 160), f32,
              over two SSD chunks, card against the port's CPU run (rtol
              1e-4, atol 1e-4 per unit of each tensor's scale); (c)
              decode steps 256 to 383 after a two-chunk prefill against
              the forward pass over 384 tokens, 2 groups at full width in
              f32.

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
# f32 -> f64 conversions a clock an SM at compute capability 9.0 (the CUDA
# C++ Programming Guide's arithmetic instruction throughput table)
F64_CONVERTS_PER_CLOCK = 16
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
               "ladder_kernel", "chol_wave_kernel")
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
    # the same loops, vmapped over the fleet's lanes
    "l1_epigraph_proj_lanes": "src/repro/core/bilinear.py:177",
    "skappa_support_lanes": "src/repro/core/bilinear.py:409",
    # the same l1 loops with ladder_refine's polish_dtype=float64
    "l1_epigraph_proj_f64polish": "src/repro/core/bilinear.py:177",
    "l1_epigraph_proj_lanes_f64polish": "src/repro/core/bilinear.py:177",
    # no Pallas kernel: the lax.fori_loop of _chol_rank1 under chol_update
    # and chol_downdate
    "chol_rank_update": "src/repro/core/prox.py:372",
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
    "l1_epigraph_proj_lanes": "src/repro_torch/csrc/ladder_proj.cu",
    "skappa_support_lanes": "src/repro_torch/csrc/ladder_proj.cu",
    "l1_epigraph_proj_f64polish": "src/repro_torch/csrc/ladder_proj.cu",
    "l1_epigraph_proj_lanes_f64polish": "src/repro_torch/csrc/ladder_proj.cu",
    "chol_rank_update": "src/repro_torch/csrc/chol_update.cu",
}
# the flash kernel at zamba2-2.7b's head dim 80 (the 128-column bf16 kernel
# on zero-filled columns), a row of the kernels line of its own
FLASH_DH80 = "flash_attention_dh80"
REPLACES[FLASH_DH80] = REPLACES["flash_attention"]
SOURCES[FLASH_DH80] = SOURCES["flash_attention"]
# the bf16 / fp16 instantiations, each a row of the kernels line
HALF_TYPES = ("bf16", "f16")
HALF_KERNELS = tuple(f"{k}_{t}" for k in ("gram", "matvec", "rmatvec",
                                          "normal_matvec", "block_matvec",
                                          "block_rmatvec")
                     for t in HALF_TYPES)
# the l1 projections' f64-polish instantiations (precision "fp64_polish"),
# each a row of the kernels line
POLISH_KERNELS = ("l1_epigraph_proj_f64polish",
                  "l1_epigraph_proj_lanes_f64polish")
for _name in HALF_KERNELS:
    _base = _name.rsplit("_", 1)[0]
    REPLACES[_name], SOURCES[_name] = REPLACES[_base], SOURCES[_base]
PROJ_KERNELS = ("l1_epigraph_proj", "skappa_support")
LANE_KERNELS = ("l1_epigraph_proj_lanes", "skappa_support_lanes")
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


def conversion_bound(torch, conversions: int, report: dict,
                     key: str) -> float:
    """The l1 projections' second bound: their f32 -> f64 conversions (one
    a (rung, entry) term of a round, an entry of a sum or a polish step) at
    F64_CONVERTS_PER_CLOCK a clock on every SM at the card's top SM clock;
    ms, printed and kept in ``report["lane_conversion_bounds"][key]``."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = conversions / (sms * F64_CONVERTS_PER_CLOCK * mhz * 1e6) * 1e3
    report.setdefault("lane_conversion_bounds", {})[key] = {
        "conversions": conversions, "sms": sms, "max_sm_mhz": mhz,
        "conversion_bound_ms": ms}
    print(f"  {key}: conversion bound {ms:.4f} ms ({conversions:,} f32 -> "
          f"f64 conversions at {F64_CONVERTS_PER_CLOCK} a clock on {sms} "
          f"SMs at {mhz:.0f} MHz)", flush=True)
    return ms


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
    registers and spill stores of each cluster size's instantiation (the
    1,024-thread lane kernels' by (cluster size, threads); the warp-a-lane
    kernels have one); the l1 kernels' f64-polish instantiations on lines
    of their own."""
    kern, regs, spills = None, {}, {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mt = re.search(r"\d(l1_proj_kernel|skappa_kernel|l1_lanes_kernel|"
                           r"skappa_lanes_kernel|l1_warp_lanes_kernel|"
                           r"skappa_warp_lanes_kernel)((?:I(?:L[ib]\d+E)+E)?)",
                           ln)
            sizes = mt and ",".join(re.findall(r"Li(\d+)E", mt.group(2)))
            kern = mt and (mt.group(1) + (" f64 polish" if "Lb1E" in
                                          mt.group(2) else ""), sizes)
        elif kern:
            used = re.search(r"Used (\d+) registers", ln)
            spill = re.search(r"(\d+) bytes spill stores", ln)
            if used:
                regs.setdefault(kern[0], {})[kern[1]] = int(used.group(1))
            if spill:
                spills.setdefault(kern[0], 0)
                spills[kern[0]] += int(spill.group(1))
    return [f"ladder_proj: {k} registers "
            + (f"{v['']}" if "warp_lanes" in k else "by cluster size "
               + ", ".join(f"<{c}> {r}" for c, r in sorted(v.items())))
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
    through the PCG x-update (normal_matvec every CG step), that data cast
    to bf16 through Woodbury and to fp16 through PCG and Woodbury (the
    engine casts it, on the card and on the CPU alike), and through
    Woodbury under fp64_polish. ``repro_torch`` must be importable."""
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
             dict(rho_c=4.0, x_solver="woodbury", precision="fp16")),
            ("parity_woodbury_fp64", "woodbury fp64_polish",
             make_sparse_regression, small, api.SparseLinearRegression,
             dict(rho_c=4.0, x_solver="woodbury",
                  precision="fp64_polish"))):
        As, bs, _ = make(1, spec)
        fits.append((key, f"N={spec.n_nodes} m={spec.m_per_node} "
                          f"n={spec.n_features} kappa={spec.kappa} {what}",
                     cls, dict(kappa=spec.kappa, gamma=10.0, tol=1e-4,
                               max_iter=300, **kw), As, bs))
    return fits


def parity_path_fits() -> list:
    """The card-vs-CPU path fits (phase 8, ``parity_path``), as ``(report
    key, what, estimator keywords, method, its keywords)`` on the Woodbury
    parity data (``parity_fits``' first), which follows."""
    from repro_torch.data import SyntheticSpec, make_sparse_regression
    small = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    As, bs, _ = make_sparse_regression(1, small)
    base = dict(kappa=small.kappa, gamma=10.0, rho_c=4.0, tol=1e-4,
                max_iter=300)
    grid = dict(kappas=[50, 40, 30], gammas=[10.0, 5.0, 20.0],
                rho_cs=[4.0, 2.0, 4.0])
    # warm paths, the grids' too: the CPU side of a cold point costs ~0.2 s
    # an outer iteration there, and warm starts compound any difference
    fits = [("parity_path_woodbury", "warm kappa path [50, 40, 30, 20], "
             "woodbury", dict(base, x_solver="woodbury"), "fit_path",
             dict(kappas=[50, 40, 30, 20])),
            ("parity_grid_woodbury", "warm (kappa, gamma, rho_c) path, "
             "spectral woodbury", dict(base, x_solver="woodbury"),
             "fit_path", grid),
            ("parity_grid_pcg", "warm (kappa, gamma, rho_c) path, pcg",
             dict(base, x_solver="pcg"), "fit_path", grid)]
    return fits, As, bs


def parity_cpu(conn) -> None:
    """The CPU side of phase 8, run in a worker process from the build on
    while the card works through phases 3 to 8: sends ``{"fits": {report
    key: the parity fit's coef, support, status and iters as numpy},
    "paths": {report key: path_to_numpy(path)}}`` (less the last state)
    down ``conn``, or the exception's text. The parity fits run at torch's
    default thread count, the main process's (the CPU's GEMMs partition
    their sums by thread, and the reduced-precision fits' stopping
    iteration follows: at 2 threads the fp16 Woodbury fit read 123 against
    the card's 120), the paths at 2 threads."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import torch
        from repro_torch import api
        from repro_torch.convert import path_to_numpy
        out = {"fits": {}, "paths": {}}
        for key, _, cls, kw, As_p, bs_p in parity_fits():
            res = cls(device="cpu", **kw).fit(As_p, bs_p).result_
            out["fits"][key] = {f: getattr(res, f).numpy() for f in
                                ("coef", "support", "status", "iters")}
        torch.set_num_threads(2)
        fits, As, bs = parity_path_fits()
        for key, _, kw, method, grid in fits:
            extra = {k: v for k, v in grid.items() if k != "kappas"}
            t0 = time.perf_counter()
            p = getattr(api.SparseLinearRegression(device="cpu", **kw),
                        method)(As, bs, grid["kappas"], **extra)
            out["paths"][key] = dict(path_to_numpy(p._replace(state=None)),
                                     seconds=time.perf_counter() - t0)
        conn.send(out)
    except Exception as e:          # noqa: BLE001 -- reported by the parent
        conn.send(f"{type(e).__name__}: {e}")
    finally:
        conn.close()


def check_path(torch, name, path, kappas) -> list:
    """The checks every path phase makes on a SparsePath: no point
    DIVERGED, finite iterates, cardinality within kappa. Returns one dict a
    point."""
    from repro_torch.core.results import SolveStatus
    require(bool(torch.isfinite(path.z).all())
            and bool(torch.isfinite(path.coef).all()),
            f"{name}: non-finite iterates")
    points = []
    for i, kappa in enumerate(kappas):
        status = SolveStatus(int(path.status[i]))
        require(status != SolveStatus.DIVERGED,
                f"{name}: the point kappa={kappa} DIVERGED")
        card = int(path.cardinality[i])
        require(card <= kappa, f"{name}: cardinality {card} > kappa "
                               f"{kappa}")
        points.append({"kappa": float(path.kappas[i]),
                       "gamma": float(path.gammas[i]),
                       "rho_c": float(path.rho_cs[i]),
                       "iters": int(path.iters[i]), "status": status.name,
                       "cardinality": card,
                       "train_loss": float(path.train_loss[i])})
    return points


def points_text(points) -> str:
    return "; ".join(f"kappa {p['kappa']:g} gamma {p['gamma']:g}: "
                     f"{p['iters']} it {p['status']} card "
                     f"{p['cardinality']} loss {p['train_loss']:.6g}"
                     for p in points)


def path_point(path, i):
    """Point ``i`` of a SparsePath as a FitResult."""
    from repro_torch.core.results import FitResult
    return FitResult(path.coef[i], path.z[i], path.support[i], path.iters[i],
                     path.p_r[i], path.d_r[i], path.b_r[i],
                     status=path.status[i])


def check_band(torch, name, got, want, what) -> dict:
    """One point against a reference result: the same status and support,
    coef within 1e-3, iterations within 2."""
    require(int(got.status) == int(want.status),
            f"{name}: status {int(got.status)} against {what}'s "
            f"{int(want.status)}")
    require(torch.equal(got.support.cpu(), want.support.cpu()),
            f"{name}: the support differs from {what}'s")
    err = float((got.coef.cpu() - want.coef.cpu()).abs().max())
    require(torch.allclose(got.coef.cpu(), want.coef.cpu(), rtol=1e-3,
                           atol=1e-3), f"{name}: coef differs from {what}'s "
                                       f"by {err}")
    require(abs(int(got.iters) - int(want.iters)) <= 2,
            f"{name}: {int(got.iters)} iterations against {what}'s "
            f"{int(want.iters)}")
    # z, before the polish: the dense polish re-solves on the support and
    # erases most of a difference between two sets of factors
    return {"iters": int(got.iters), "iters_ref": int(want.iters),
            "coef_max_abs_diff": err,
            "z_max_abs_diff": float((got.z.cpu() - want.z.cpu()).abs().max())}


# unconverged_diffs' bound on z before the polish, relative to max |z| of
# the reference: on an H100 80GB HBM3 at 700 W the lane grids read at most
# 3.6e-5 against the cold scan (path, max |z| 3.0), 1.8e-5 / 9.2e-6
# against the static fits (path_gamma / path_dense, max |z| 3.0 / 2.7); a
# wrong per-lane sigma, rho_c or kappa moves z by far more in 60
# iterations
Z_RTOL = 1e-3
# the path phase's iterations a point (60 until PR 21; cut to pay for the
# streaming phases: no point converges in either, path_converge measures
# the warm start where they do)
PATH_ITERS = 30


def unconverged_diffs(torch, name, got, want, what, kappa) -> dict:
    """One point of a grid against a reference where neither converges:
    the same status and iterations, z before the polish within Z_RTOL x
    max |z| of the reference's, and supports (the top-kappa nonzeros of an
    unconverged z) that differ only at near-ties: where the reference's |z|
    lies within that bound of its kappa-th largest |z| (0 where z has fewer
    nonzeros). Returns the differences."""
    require(int(got.status) == int(want.status)
            and int(got.iters) == int(want.iters),
            f"{name}: status / iterations differ from {what}'s")
    z_ref, z_got = want.z.cpu().reshape(-1), got.z.cpu().reshape(-1)
    az = z_ref.abs()
    z_max = float(az.max())
    limit = Z_RTOL * z_max
    z_err = float((z_got - z_ref).abs().max())
    require(z_err <= limit, f"{name}: z before the polish differs from "
                            f"{what}'s by {z_err:.3e} (limit {limit:.3e})")
    k = min(az.numel(), max(0, math.ceil(kappa)))
    thr = (0.0 if k in (0, az.numel()) else
           float(torch.sort(az, descending=True).values[k - 1]))
    flips = (got.support.cpu() != want.support.cpu()).reshape(-1)
    tie = float((az[flips] - thr).abs().max()) if bool(flips.any()) else 0.0
    require(tie <= limit, f"{name}: the support differs from {what}'s at "
                          f"an entry {tie:.3e} from the threshold {thr:.3e} "
                          f"(limit {limit:.3e})")
    return {"iters": int(got.iters), "iters_ref": int(want.iters),
            "support_differs_in": int(flips.sum()),
            "flip_distance_from_threshold": tie,
            "coef_max_abs_diff": float((got.coef.cpu()
                                        - want.coef.cpu()).abs().max()),
            "z_max_abs_diff": z_err, "z_max_abs": z_max,
            "z_limit": limit}


def parity_phases(torch, api, ops, report, cpu_recv, cpu_proc) -> None:
    """Phase 8: the parity fits and the path parity, card against the
    port's CPU side (``parity_cpu``, computed in ``cpu_proc``, read from
    ``cpu_recv``), and ``path_converge``: the warm kappa path of that data
    against its cold scan on the card, where every point converges."""
    from types import SimpleNamespace

    from repro_torch.core.results import SolveStatus, SparsePath
    t0 = time.perf_counter()
    require(cpu_recv.poll(1200), "parity: the CPU worker sent nothing in "
                                 "1,200 s")
    cpu = cpu_recv.recv()
    cpu_proc.join(60)
    require(isinstance(cpu, dict),
            f"parity: the CPU worker failed: {cpu}")
    print(f"  parity: waited {time.perf_counter() - t0:.2f} s for the CPU "
          "worker", flush=True)
    for key, what, cls, kw, As_p, bs_p in parity_fits():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        on_card = cls(**kw).fit(As_p, bs_p).result_
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        parity_types = ops.launch_counts_by_type()
        on_cpu = SimpleNamespace(**{f: torch.as_tensor(v)
                                    for f, v in cpu["fits"][key].items()})
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

    # 8b. the path and grids, card against CPU ------------------------------
    path_fits, As_pp, bs_pp = parity_path_fits()
    on_cards = {}
    for key, what, kw, method, grid in path_fits:
        t0 = time.perf_counter()
        kappas_pp = grid["kappas"]
        extra = {k: v for k, v in grid.items() if k != "kappas"}
        on_card = getattr(api.SparseLinearRegression(**kw), method)(
            As_pp, bs_pp, kappas_pp, **extra)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        on_cards[key] = on_card
        check_path(torch, key, on_card, kappas_pp)
        report[key] = {"card_s": t_card, "strategy": on_card.strategy}
    cpu_paths = cpu["paths"]
    for key, what, kw, method, grid in path_fits:
        t0 = time.perf_counter()
        got = cpu_paths[key]
        on_cpu = SparsePath(**{f: (torch.as_tensor(got[f])
                                   if f in got and f != "strategy"
                                   and got[f] is not None else got.get(f))
                               for f in SparsePath._fields})
        on_card = on_cards[key]
        bands = [check_band(torch, f"{key} point {i}", path_point(on_card, i),
                            path_point(on_cpu, i), "the CPU")
                 for i in range(len(grid["kappas"]))]
        report[key].update(points=bands, cpu_s=got["seconds"])
        phase("parity_path", t0, f"{what}: card against CPU iterations "
                                 + ", ".join(f"{b['iters']}/{b['iters_ref']}"
                                             for b in bands)
                                 + ", same status and support, coef max "
                                 f"abs diff "
                                 f"{max(b['coef_max_abs_diff'] for b in bands):.2e}"
                                 f" (card {report[key]['card_s']:.2f} s, CPU "
                                 f"worker {got['seconds']:.2f} s)")

    # 8c. warm against cold where the points converge (card only) --------
    t0 = time.perf_counter()
    key, what, kw, method, grid = path_fits[0]
    kappas_pp = grid["kappas"]
    warm = on_cards[key]
    cold = api.SparseLinearRegression(**kw).fit_path(
        As_pp, bs_pp, kappas_pp, warm_start=False)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    # the same points on lanes (fit_grid), held to the cold scan's band
    t_g = time.perf_counter()
    grid = api.SparseLinearRegression(**kw).fit_grid(As_pp, bs_pp,
                                                     kappas_pp)
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t_g
    require(grid.strategy == "vmap", f"path_converge: the grid ran as "
                                     f"{grid.strategy}")
    grid_bands = [check_band(torch, f"path_converge grid point {i}",
                             path_point(grid, i), path_point(cold, i),
                             "the cold scan")
                  for i in range(len(kappas_pp))]
    # a (kappa, gamma, rho_c) grid on the spectral Woodbury factors, on
    # lanes, against its cold scan: every point in the band
    _, _, kw_s, _, grid_s = path_fits[1]
    pen = {k: v for k, v in grid_s.items() if k != "kappas"}
    cold_s = api.SparseLinearRegression(**kw_s).fit_path(
        As_pp, bs_pp, grid_s["kappas"], warm_start=False, **pen)
    lanes_s = api.SparseLinearRegression(**kw_s).fit_grid(
        As_pp, bs_pp, grid_s["kappas"], **pen)
    torch.cuda.synchronize()
    grid_bands += [check_band(torch, f"path_converge spectral grid point "
                                     f"{i}", path_point(lanes_s, i),
                              path_point(cold_s, i), "the cold scan")
                   for i in range(len(grid_s["kappas"]))]
    runs = {"warm": check_path(torch, "path_converge warm", warm, kappas_pp),
            "cold": check_path(torch, "path_converge cold", cold, kappas_pp)}
    for run, points in runs.items():
        require(all(pt["status"] == "CONVERGED" for pt in points),
                f"path_converge: a {run} point did not converge: "
                + points_text(points))
    totals = {run: sum(pt["iters"] for pt in pts)
              for run, pts in runs.items()}
    report["path_converge"] = {
        "kappas": kappas_pp, "warm": runs["warm"], "cold": runs["cold"],
        "iters": totals, "warm_s": report[key]["card_s"], "cold_s": t_cold,
        "iters_saved": 1 - totals["warm"] / totals["cold"],
        "grid_s": t_grid, "grid_vs_cold": grid_bands}
    phase("path_converge", t0,
          f"kappa path {kappas_pp}, woodbury, on the parity data, every "
          f"point CONVERGED: warm {totals['warm']} outer iterations in "
          f"{report[key]['card_s']:.2f} s, cold {totals['cold']} in "
          f"{t_cold:.2f} s ({report['path_converge']['iters_saved']:.1%} "
          "fewer warm); grid (the points on lanes) in "
          f"{t_grid:.2f} s and the spectral (kappa, gamma, rho_c) grid of "
          "parity_path on lanes, every point in its cold scan's band "
          "(iterations " + ", ".join(f"{b['iters']}/{b['iters_ref']}"
                                     for b in grid_bands)
          + "); warm: " + points_text(runs["warm"]) + "; cold: "
          + points_text(runs["cold"]))


# benchmarks/fleet_bench.py's config and rows (B, N, m, n, loop sample)
FLEET_CFG = dict(kappa=4, gamma=5.0, rho_c=1.0, max_iter=100, tol=1e-3)
FLEET_ROWS = {"fleet_sq": (10_000, 1, 32, 16), "fleet_sq_wide": (2_000, 1,
                                                                 128, 64)}
# examples/lm_sparse_probe.py's probe fit: gamma 1,000, tol 1e-3; rho_c 10,
# not 1: at rho_c 1 the iterates on sign(A x*) labels grow without bound
# (z ~ 30-50, p_r ~ 77 after 200 iterations) and a 1e-7 relative change of
# A changes the support, so no fit determines the support a lane could be
# held to. Depth cut from the probe's 200 iterations to 20: a Newton-CG
# outer iteration is ~250 host-paced CG steps (~0.25 s solo, ~0.44 s for
# the fleet), so 8 solo fits of 200 took 407 s of a run (PERF.md section 6)
PROBE_CFG = dict(kappa=4, gamma=1000.0, rho_c=10.0, max_iter=20, tol=1e-3)
# lanes held against solo fits, spread over B: 4 (8 until PR 21; cut in
# PR 22 to keep the script within its time with the new phases: the solo
# loops were ~140 s of the fleet phases)
FLEET_SAMPLE = 4
WINDOW_TRACES = 3             # profiled runs of fleet_sq_window at most


def fleet_data(B, N, m, n, seed=0, labels=False):
    """benchmarks/fleet_bench.py's ``_fleet_data`` as numpy (seed 0): A
    standard normal, x* with ~30 % nonzeros, b = A x* + 0.01 noise; with
    ``labels`` b = sign(A x*) instead (the logistic probes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((B, N, m, n)).astype(np.float32)
    xs = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.3)
    bs = np.einsum("bnmf,bf->bnm", As, xs).astype(np.float32)
    if labels:
        return As, np.where(bs >= 0, 1.0, -1.0).astype(np.float32)
    bs += 0.01 * rng.standard_normal((B, N, m)).astype(np.float32)
    return As, bs


def fleet_window(torch, As, bs, state) -> dict:
    """Where a fleet's time goes: two outer iterations of fleet_sq's
    config over ``As`` / ``bs`` from ``state`` (warm, counters reset; the
    factors set up outside the window), first with the profiler off, then
    on: device ops, host syncs (device-to-host scalar reads), the idle
    share and the lane projection kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import BiCADMM, BiCADMMConfig
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.kernels import ops
    solver = BiCADMM("squared", BiCADMMConfig(
        **{**FLEET_CFG, "max_iter": 2, "tol": 0.0}))
    B, N = As.shape[:2]
    kaps, gams, rhos, dyn = fleet_mod._fleet_grids(
        solver, B, None, None, None, As.dtype, As.device)
    factors = fleet_mod._fleet_setup(solver, As, bs, dyn)
    params = fleet_mod._fleet_params(solver, N, kaps, gams, rhos, dyn)
    st0 = fleet_mod.reset_fleet_for_resume(state)

    def run():
        st = solver._run_while_fleet(factors, As, bs, params, st0)
        torch.cuda.synchronize()
        return st

    run()
    t_w = time.perf_counter()
    st = run()
    wall_ms = (time.perf_counter() - t_w) * 1e3
    require(int(st.k.max()) == 2, f"fleet window: {int(st.k.max())} outer "
                                  "iterations, expected 2")
    # the wrappers' counts are what the profiled run launched; a trace that
    # lost kernel records (CUPTI drops some now and then) is taken again,
    # and the window's numbers come from the first complete trace
    for attempt in range(1, WINDOW_TRACES + 1):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_w = time.perf_counter()
            run()
            on_ms = (time.perf_counter() - t_w) * 1e3
        counted = sum(ops.launch_counts()[k] for k in LANE_KERNELS)
        table = device_table(prof)
        lanes = {k: v for k, v in table.items() if "lanes_kernel" in k}
        seen = sum(v["calls"] for v in lanes.values())
        if seen == counted:
            break
        print(f"  fleet_sq_window: trace {attempt} saw {seen} of the "
              f"{counted} lane launches; profiling again", flush=True)
    busy = sum(v["device_ms"] for v in table.values())
    syncs = sum(ev.count for ev in prof.key_averages()
                if ev.key == "aten::_local_scalar_dense")
    top = sorted(table.items(), key=lambda kv: -kv[1]["device_ms"])[:6]
    return {"outer_iters": 2, "wall_ms": wall_ms, "wall_ms_profiler_on":
            on_ms, "busy_ms": busy,
            "device_ops": sum(v["calls"] for v in table.values()),
            "host_syncs": syncs,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "idle_share_profiler_on": 1 - busy / on_ms if busy else None,
            "lane_ms": sum(v["device_ms"] for v in lanes.values()),
            "lane_launches": seen, "lane_launches_counted": counted,
            "traces": attempt,
            "lane_kernels": lanes, "top": dict(top)}


# the sharded engine's phases: Fig. 3's per-rank blocks on a (2, 4) grid of
# ranks on the one card, and a (1, 1) NCCL grid of one Fig. 3 node
SHARDED_GRID = (2, 4)          # (nodes, feat): 8 ranks, one process each
SHARDED_CFG = dict(kappa=800, gamma=10.0, rho_c=4.0)
# outer iterations of the grid's fits: the depth cut (each outer iteration
# issues ~1,300 host-staged collectives a rank)
SHARDED_ITERS = 2
SHARDED_CG_ITERS = 8           # the (1, 1) grid's cg fit, on NCCL (12
                               # until PR 27)
SHARDED_FP16_ITERS = 5         # its fp16 sub-solver fit (the f16 rows)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed_collectives(sharded):
    """Count the sharded engine's collectives and their host time (the
    clock around each call: gloo stages a CUDA tensor through the host and
    returns when the result is back on the card's stream). Returns the
    stats dict, reset by the caller."""
    stats = {"calls": 0, "s": 0.0}

    def timed(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stats["s"] += time.perf_counter() - t0
            stats["calls"] += 1
            return out
        return call
    sharded._all_reduce = timed(sharded._all_reduce)
    sharded._gather = timed(sharded._gather)
    return stats


def sharded_rank(rank: int, world: int, port: int, A, b, iters: int,
                 queue) -> None:
    """One rank of the sharded phases' (2, 4) grid on the one card: a gloo
    group (NCCL refuses two ranks on one device), the global data on the
    card (the api's contract: every rank passes the same global arrays),
    the f32 and then the bf16 fit through the estimator; each fit's
    launches, collectives and their host time, wall time and peak device
    memory, and its result, sent to the parent."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import api
    from repro_torch.core import sharded
    from repro_torch.kernels import ops
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", SHARDED_GRID,
                                mesh_dim_names=("nodes", "feat"))
        stats = _timed_collectives(sharded)
        A, b = A.to("cuda"), b.to("cuda")
        out = {}
        for name, precision in (("sharded", "fp32"),
                                ("sharded_bf16", "bf16")):
            est = api.SparseLinearRegression(
                **SHARDED_CFG, options=api.SolverOptions(
                    engine="sharded", mesh=mesh, x_update="subsolver",
                    max_iter=iters, tol=0.0, precision=precision))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            # the set-up, timed on its own (the block's gram and Cholesky);
            # the fit below finds it in the engine's set-up cache (keyed on
            # the same data)
            block = est._adapter.solver._prepare(
                A.reshape(-1, A.shape[-1]), b.reshape(-1))[0]
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            dist.barrier()
            stats.update(calls=0, s=0.0)
            t0 = time.perf_counter()
            est.fit(A, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res = est.result_
            # numpy, not tensors: a tensor crosses the queue as a handle
            # to this process's memory, gone once the rank exits
            out[name] = {
                "iters": int(res.iters), "status": int(res.status),
                "z": res.z.cpu().numpy(), "coef": res.coef.cpu().numpy(),
                "support": res.support.cpu().numpy(), "wall_s": wall,
                "setup_s": setup_s,
                "launches": {k: v for k, v in ops.launch_counts().items()
                             if v},
                "launches_by_type": ops.launch_counts_by_type(),
                "collectives": stats["calls"],
                "collective_s": stats["s"],
                "peak_bytes_above_start": (torch.cuda.max_memory_allocated()
                                           - mem0),
                "dtype": str(block.dtype), "block": tuple(block.shape)}
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def sharded_phases(torch, api, ops, report, A2, b2) -> None:
    """The ``sharded`` and ``sharded_bf16`` phases: 8 spawned ranks as a
    (nodes = 2, feat = 4) grid on the one card, each rank holding Fig. 3's
    A_ij (25,000 x 1,000) of the (2, 25,000, 4,000) data ``A2``, ``b2``;
    the f32 fit held to the single-process port's feature split
    (``n_feature_blocks=4``, ``polish=False``) on the same data in PERF.md
    section 2's band; the bf16 fit on the bf16 block kernels only, finite
    and not DIVERGED, its support beside the f32 fit's."""
    import collections
    import torch.multiprocessing as mp
    from queue import Empty
    from types import SimpleNamespace
    from repro_torch.core.results import SolveStatus
    t_ph = time.perf_counter()
    N, m, n = A2.shape
    M = SHARDED_GRID[1]
    world = SHARDED_GRID[0] * M
    # the reference first, on the card: the single-process feature split
    ref_est = api.SparseLinearRegression(
        **SHARDED_CFG, n_feature_blocks=M, polish=False,
        max_iter=SHARDED_ITERS, tol=0.0)
    ref_est._adapter.solver._setup(A2, b2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_est.fit(A2, b2)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    ref = ref_est.result_
    # the ranks read the global data from shared host memory and move it
    # to the card themselves; every kernel library is already built
    A_host = A2.cpu().share_memory_()
    b_host = b2.cpu().share_memory_()
    queue = mp.get_context("spawn").Queue()
    t0 = time.perf_counter()
    ranks = mp.spawn(sharded_rank, args=(world, _free_port(), A_host,
                                         b_host, SHARDED_ITERS, queue),
                     nprocs=world, join=False)
    outs = {}
    while len(outs) < world:
        try:
            rank, out = queue.get(timeout=1)
            outs[rank] = out
        except Empty:
            ranks.join(timeout=0)            # raises when a rank failed
    while not ranks.join():
        pass
    grid_s = time.perf_counter() - t0
    del A_host, b_host
    for name in ("sharded", "sharded_bf16"):
        per = [outs[r][name] for r in range(world)]
        first = per[0]
        for r, o in enumerate(per[1:], 1):
            require((o["z"] == first["z"]).all()
                    and (o["support"] == first["support"]).all(),
                    f"{name}: rank {r}'s result differs from rank 0's")
        needed = ("block_matvec", "block_rmatvec", "ladder_stats", "gram")
        sfx = "f32" if name == "sharded" else "bf16"
        for r, o in enumerate(per):
            for k in needed:
                require(o["launches"].get(k, 0) > 0,
                        f"{name}: rank {r} launched no {k}")
            for k in ("block_matvec", "block_rmatvec"):
                require(o["launches_by_type"].get(f"{k}_{sfx}", 0) > 0,
                        f"{name}: rank {r} launched no {k}_{sfx}")
                if sfx != "f32":
                    require(not o["launches_by_type"].get(f"{k}_f32", 0),
                            f"{name}: rank {r} launched {k}_f32")
            require(o["dtype"] == ("torch.float32" if sfx == "f32"
                                   else "torch.bfloat16"),
                    f"{name}: rank {r}'s block is {o['dtype']}")
        require(first["block"] == (m, n // M),
                f"{name}: rank 0 holds a {first['block']} block")
        res = SimpleNamespace(**{k: torch.as_tensor(first[k]) for k in
                                 ("z", "coef", "support", "iters",
                                  "status")})
        require(bool(torch.isfinite(res.z).all()),
                f"{name}: non-finite iterates")
        require(int(res.status) != 2, f"{name}: DIVERGED")
        iters = max(first["iters"], 1)
        rep = {"grid": list(SHARDED_GRID), "iters": first["iters"],
               "status": SolveStatus(int(res.status)).name,
               "s_per_outer_iter": [o["wall_s"] / iters for o in per],
               "setup_s": [o["setup_s"] for o in per],
               "launches": [o["launches"] for o in per],
               "launches_by_type": dict(sum(
                   (collections.Counter(o["launches_by_type"]) for o in per),
                   collections.Counter())),
               "collectives_per_outer_iter": [o["collectives"] / iters
                                              for o in per],
               "collective_s_per_outer_iter": [o["collective_s"] / iters
                                               for o in per],
               "peak_bytes_above_start": [o["peak_bytes_above_start"]
                                          for o in per]}
        if name == "sharded":
            rep["band"] = check_band(torch, name, res, SimpleNamespace(
                z=ref.z, coef=ref.coef, support=ref.support,
                iters=ref.iters, status=ref.status),
                "the single-process feature split")
            rep["reference_s_per_outer_iter"] = ref_wall / max(
                int(ref.iters), 1)
            f32_support = res.support
        else:
            both = int((res.support & f32_support).sum())
            rep["support_agreement_with_f32"] = both / max(
                int(f32_support.sum()), 1)
        report[name] = rep
        ms = [1e3 * t for t in rep["s_per_outer_iter"]]
        coll = rep["collectives_per_outer_iter"]
        coll_ms = [1e3 * t for t in rep["collective_s_per_outer_iter"]]
        extra = (f"band against the single-process feature split "
                 f"({rep['reference_s_per_outer_iter'] * 1e3:.2f} ms/outer "
                 f"iter): iters {rep['band']['iters']} vs "
                 f"{rep['band']['iters_ref']}, coef max abs diff "
                 f"{rep['band']['coef_max_abs_diff']:.2e}, z "
                 f"{rep['band']['z_max_abs_diff']:.2e}"
                 if name == "sharded" else
                 f"support agreement with the f32 fit "
                 f"{rep['support_agreement_with_f32']:.4f}")
        phase(name, t_ph,
              f"{world} ranks as a {SHARDED_GRID} (nodes, feat) grid on one "
              f"card (gloo, host-staged), N={N} m={m} n={n} (A_ij "
              f"{m} x {n // M}), {iters} iters, {rep['status']}; ms/outer "
              f"iter by rank {[round(x, 1) for x in ms]}; collectives/outer "
              f"iter {coll[0]:.0f}, their host ms/outer iter by rank "
              f"{[round(x, 1) for x in coll_ms]}; launches rank 0 "
              f"{per[0]['launches']}, by type {per[0]['launches_by_type']};"
              f" peak MB by rank "
              f"{[round(p / 1e6, 1) for p in rep['peak_bytes_above_start']]}"
              f"; {extra}; the spawned grid took {grid_s:.1f} s")


def sharded_cg_phase(torch, api, ops, report, A1, b1) -> None:
    """The ``sharded_cg`` phase: a (1, 1) grid on NCCL in this process, one
    node of Fig. 3 (``A1`` (1, 25,000, 4,000)), x_update "auto" (cg: nb =
    4,000 > 2,048), held to the single-process PCG x-update
    (``x_solver="pcg"``, ``polish=False``) in PERF.md section 2's band;
    then ``sharded_fp16``: an fp16 sub-solver fit through the engine on the
    same grid (the bf16 / fp16 block kernels' f16 launches)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import BiCADMMConfig, sharded
    from repro_torch.core.results import SolveStatus
    t_ph = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("nodes", "feat"))
        plain = (sharded._all_reduce, sharded._gather)
        stats = _timed_collectives(sharded)
        try:
            est = api.SparseLinearRegression(
                **SHARDED_CFG, engine="sharded", mesh=mesh,
                max_iter=SHARDED_CG_ITERS, tol=0.0)
            solver = est._adapter.solver
            require(solver._x_mode(A1.shape[-1]) == "cg",
                    "sharded_cg: x_update 'auto' did not take cg")
            ops.reset_launch_counts()
            solver._prepare(A1.reshape(-1, A1.shape[-1]), b1.reshape(-1))
            torch.cuda.synchronize()
            stats.update(calls=0, s=0.0)
            t0 = time.perf_counter()
            est.fit(A1, b1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            calls, coll_s = stats["calls"], stats["s"]
            res = est.result_
            for k in ("matvec", "rmatvec", "ladder_stats"):
                require(counts.get(k, 0) > 0,
                        f"sharded_cg: {k} was not launched")
            require(not counts.get("normal_matvec", 0),
                    "sharded_cg: the cg x-update launched normal_matvec")
            ref_est = api.SparseLinearRegression(
                **SHARDED_CFG, x_solver="pcg", polish=False,
                max_iter=SHARDED_CG_ITERS, tol=0.0)
            ref_est._adapter.solver._setup(A1, b1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_est.fit(A1, b1)
            torch.cuda.synchronize()
            ref_wall = time.perf_counter() - t0
            band = check_band(torch, "sharded_cg", res, ref_est.result_,
                              "the single-process PCG x-update")
            iters = max(int(res.iters), 1)
            report["sharded_cg"] = {
                "backend": dist.get_backend(), "iters": int(res.iters),
                "status": SolveStatus(int(res.status)).name,
                "s_per_outer_iter": wall / iters,
                "reference_s_per_outer_iter": ref_wall / max(
                    int(ref_est.result_.iters), 1),
                "launches": counts, "collectives_per_outer_iter":
                    calls / iters, "collective_s_per_outer_iter":
                    coll_s / iters, "band": band}
            phase("sharded_cg", t_ph,
                  f"a (1, 1) grid on {dist.get_backend()}, one Fig. 3 node "
                  f"{tuple(A1.shape)}, x_update auto -> cg, {iters} iters, "
                  f"{SolveStatus(int(res.status)).name}: "
                  f"{wall / iters * 1e3:.2f} ms/outer iter against the "
                  f"single-process PCG x-update's "
                  f"{ref_wall / iters * 1e3:.2f}; collectives/outer iter "
                  f"{calls / iters:.0f} ({coll_s / iters * 1e3:.2f} ms of "
                  f"host time); launches {counts}; band: iters "
                  f"{band['iters']} vs {band['iters_ref']}, coef max abs "
                  f"diff {band['coef_max_abs_diff']:.2e}, z "
                  f"{band['z_max_abs_diff']:.2e}")
            # fp16 through the engine directly (the api certifies float32
            # and bfloat16 for the sharded engine, as the JAX package)
            t_ph = time.perf_counter()
            eng = sharded.ShardedBiCADMM(
                "squared", BiCADMMConfig(
                    **SHARDED_CFG, max_iter=SHARDED_FP16_ITERS, tol=0.0,
                    precision="fp16"), mesh, x_update="subsolver")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res16 = eng.fit(A1.reshape(-1, A1.shape[-1]), b1.reshape(-1))
            torch.cuda.synchronize()
            wall16 = time.perf_counter() - t0
            by_type = ops.launch_counts_by_type()
            for k in ("block_matvec", "block_rmatvec"):
                require(by_type.get(f"{k}_f16", 0) > 0,
                        f"sharded_fp16: {k}_f16 was not launched")
                require(not by_type.get(f"{k}_f32", 0),
                        f"sharded_fp16: {k}_f32 was launched")
            require(bool(torch.isfinite(res16.z).all())
                    and int(res16.status) != 2,
                    "sharded_fp16: non-finite or DIVERGED")
            iters16 = max(int(res16.iters), 1)
            report["sharded_fp16"] = {"iters": int(res16.iters),
                                      "fit_s": wall16,
                                      "s_per_outer_iter": wall16 / iters16,
                                      "launches_by_type": by_type}
            phase("sharded_fp16", t_ph,
                  f"the same node in fp16 through the engine (sub-solver, "
                  f"nb = {A1.shape[-1]}), {int(res16.iters)} iters, fit "
                  f"{wall16:.2f} s, {wall16 / iters16 * 1e3:.2f} ms/outer "
                  f"iter (set-up included); launches by type "
                  f"{ {k: v for k, v in by_type.items() if 'block' in k} }")
        finally:
            sharded._all_reduce, sharded._gather = plain
    finally:
        dist.destroy_process_group()


def fleet_phases(torch, api, ops, report, dev) -> dict:
    """Phase 11: the fleet driver (module docstring). Returns the launch
    counts of the fleet_sq run."""
    import numpy as np
    from repro_torch.core import BiCADMM, BiCADMMConfig
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core.results import SolveStatus

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def solo_fit(solver, A, b, kappa, gamma):
        over = {}
        if kappa is not None:
            over["kappa"] = kappa
        if gamma is not None:
            over["gamma"] = torch.tensor(gamma, dtype=torch.float32)
        if not over:
            return solver.fit(A, b)
        return solver.run_from(A, b, solver.init_state(A, b), **over)

    def run_part(name, loss, cfg, As_np, bs_np, kappas=None, gammas=None,
                 cut=""):
        """Fit the stacked fleet through api.fit_many with the launch
        counts set to 0 just before and read just after; hold FLEET_SAMPLE
        lanes against solo fits of their problems on the card."""
        t_ph = time.perf_counter()
        B, N, m, n = As_np.shape
        As = torch.as_tensor(As_np, device=dev)
        bs = torch.as_tensor(bs_np, device=dev)
        problem = api.SparseProblem(loss, kappa=cfg["kappa"],
                                    gamma=cfg["gamma"], rho_c=cfg["rho_c"])
        opts = api.SolverOptions(device=dev, max_iter=cfg["max_iter"],
                                 tol=cfg["tol"])
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t_fit = time.perf_counter()
        res = api.fit_many(problem, As, bs, kappas=kappas, gammas=gammas,
                           options=opts)
        sync()
        wall = time.perf_counter() - t_fit
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() - mem0
                if dev.type == "cuda" else 0)
        iters = res.iters.cpu().numpy()
        trips = int(iters.max())
        require(bool(torch.isfinite(res.z).all())
                and bool(torch.isfinite(res.coef).all()),
                f"{name}: non-finite iterates")
        statuses = res.status.cpu().numpy()
        require(not (statuses == int(SolveStatus.DIVERGED)).any(),
                f"{name}: a lane DIVERGED")
        # the projections: one launch an outer iteration for every lane
        require(counts["l1_epigraph_proj_lanes"] == 121 * trips
                and counts["skappa_support_lanes"] == trips,
                f"{name}: {counts['l1_epigraph_proj_lanes']} l1 and "
                f"{counts['skappa_support_lanes']} S^kappa lane launches in "
                f"{trips} outer iterations (expected 121 and 1 each)")
        require(not any(counts[k] for k in PROJ_KERNELS),
                f"{name}: a solo projection launched: {counts}")
        needed = ("rmatvec", "matvec") + (("gram",) if loss == "squared"
                                          else ())
        for k_name in needed:
            require(counts[k_name] > 0, f"{name}: kernel {k_name} was not "
                                        "launched")
        # FLEET_SAMPLE lanes against solo fits of their problems
        solver = BiCADMM(loss, BiCADMMConfig(**cfg))
        sample = np.linspace(0, B - 1, FLEET_SAMPLE).astype(int)
        sync()
        t_solo = time.perf_counter()
        solos = [solo_fit(solver, As[i], bs[i],
                          None if kappas is None else int(kappas[i]),
                          None if gammas is None else float(gammas[i]))
                 for i in sample]
        sync()
        solo_s = time.perf_counter() - t_solo
        exact = 0
        for i, solo in zip(sample, solos):
            lane = res[int(i)]
            require(int(lane.status) == int(solo.status),
                    f"{name} lane {i}: status {int(lane.status)} against "
                    f"the solo fit's {int(solo.status)}")
            require(torch.equal(lane.support.cpu(), solo.support.cpu()),
                    f"{name} lane {i}: the support differs from the solo "
                    "fit's")
            err = float((lane.coef - solo.coef).abs().max())
            require(err <= 1e-3, f"{name} lane {i}: coef differs from the "
                                 f"solo fit's by {err}")
            di = abs(int(lane.iters) - int(solo.iters))
            require(di <= 2, f"{name} lane {i}: {int(lane.iters)} "
                             f"iterations against the solo fit's "
                             f"{int(solo.iters)}")
            exact += di == 0
        per_fit = solo_s / len(sample)
        out = {"B": B, "N": N, "m": m, "n": n, "loss": loss,
               "fleet_s": wall, "fits_per_s": B / wall,
               "outer_iters_mean": float(iters.mean()),
               "outer_iters_max": trips,
               "ms_per_outer_iter": wall / max(trips, 1) * 1e3,
               "solo_sample": len(sample), "solo_s": solo_s,
               "solo_per_fit_s": per_fit,
               "solo_loop_s_extrapolated": per_fit * B,
               "speedup_vs_solo_loop": per_fit * B / wall,
               "lanes_matching_solo_iterations": exact,
               "statuses": {SolveStatus(c).name: int((statuses == c).sum())
                            for c in np.unique(statuses)},
               "launches": counts, "peak_bytes_above_start": peak}
        report[name] = out
        phase(name, t_ph, f"B={B} N={N} m={m} n={n} {loss}{cut}: "
                          f"{wall:.3f} s, {B / wall:.1f} fits/s, outer "
                          f"iterations mean {iters.mean():.2f} max {trips} "
                          f"({wall / max(trips, 1) * 1e3:.2f} ms each), "
                          f"statuses {out['statuses']}; solo loop "
                          f"{per_fit * 1e3:.1f} ms a fit on {len(sample)} "
                          f"lanes, {per_fit * B:.1f} s extrapolated to B "
                          f"({per_fit * B / wall:.1f}x the fleet); "
                          f"{exact}/{len(sample)} sampled lanes match their "
                          f"solo fit to the iteration (all within 2, same "
                          f"status and support, coef within 1e-3); launches "
                          f"{ {k: v for k, v in counts.items() if v} }; "
                          f"peak device memory above the start "
                          f"{peak / 1e9:.3f} GB")
        return res, As, bs

    # fleet_sq: fleet_bench's default first row, stacked input
    B, N, m, n = FLEET_ROWS["fleet_sq"]
    As_np, bs_np = fleet_data(B, N, m, n)
    res_sq, As_sq, bs_sq = run_part("fleet_sq", "squared", FLEET_CFG, As_np,
                                    bs_np)
    sq_counts = report["fleet_sq"]["launches"]
    if dev.type == "cuda":
        t_ph = time.perf_counter()
        win = fleet_window(torch, As_sq, bs_sq, res_sq.state)
        report["fleet_sq_window"] = win
        require(win["lane_launches_counted"] == 2 * 122,
                f"fleet_sq_window: {win['lane_launches_counted']} lane "
                f"kernel launches in 2 outer iterations (expected 244)")
        require(win["busy_ms"] > 0 and win["lane_launches"] == 2 * 122,
                f"fleet_sq_window: the last of {win['traces']} traces saw "
                f"{win['lane_launches']} of the 244 lane kernel launches "
                f"and {win['busy_ms']:.3f} ms of device time")
        phase("fleet_sq_window", t_ph,
              f"2 outer iterations of fleet_sq from its state: wall "
              f"{win['wall_ms']:.2f} ms (profiler off), "
              f"{win['wall_ms_profiler_on']:.2f} ms (on); device busy "
              f"{win['busy_ms']:.2f} ms in {win['device_ops']} ops, "
              f"{win['host_syncs']} host syncs; idle share "
              f"{win['idle_share']:.3f} (profiler off); the lane kernels "
              f"{win['lane_ms']:.3f} ms in {win['lane_launches']} launches "
              f"({win['lane_ms'] / 2:.3f} ms an outer iteration); top: "
              + "; ".join(f"{k[:40]} {v['device_ms']:.2f} ms/{v['calls']}"
                          for k, v in list(win["top"].items())[:4]))

    # fleet_sq_wide: its second row, then per-lane kappa and gamma cycling
    # (the spectral factors)
    B, N, m, n = FLEET_ROWS["fleet_sq_wide"]
    Aw_np, bw_np = fleet_data(B, N, m, n)
    run_part("fleet_sq_wide", "squared", FLEET_CFG, Aw_np, bw_np)
    kappas = np.resize(np.array([4, 8, 12, 16]), B)
    gammas = np.resize(np.array([1.0, 5.0, 25.0], np.float32), B)
    res_het, _, _ = run_part("fleet_sq_wide_het", "squared", FLEET_CFG,
                             Aw_np, bw_np, kappas=kappas, gammas=gammas,
                             cut=" (kappa 4/8/12/16 and gamma 1/5/25 "
                                 "cycling: spectral factors)")
    require(bool((res_het.cardinality.cpu()
                  <= torch.as_tensor(kappas)).all()),
            "fleet_sq_wide_het: a lane's cardinality exceeds its kappa")

    # fleet_logistic: the wide shape, labels sign(A x*), the probe's config
    Al_np, bl_np = fleet_data(B, N, m, n, labels=True)
    run_part("fleet_logistic", "logistic", PROBE_CFG, Al_np, bl_np)

    # a bucketed list: 64 problems, m in {24, 32, 40} at n = 16, through
    # fit_many's sequence input; the bucket's corrected train losses
    t_ph = time.perf_counter()
    ms = [24, 32, 40] * 21 + [24]
    problems = []
    for i, mi in enumerate(ms):
        A_i, b_i = fleet_data(1, 1, mi, 16, seed=100 + i)
        problems.append((A_i[0], b_i[0]))
    problem = api.SparseProblem("squared", kappa=FLEET_CFG["kappa"],
                                gamma=FLEET_CFG["gamma"])
    opts = api.SolverOptions(device=dev, max_iter=FLEET_CFG["max_iter"],
                             tol=FLEET_CFG["tol"])
    ops.reset_launch_counts()
    listed = api.fit_many(problem, [p[0] for p in problems],
                          [p[1] for p in problems], options=opts)
    sync()
    wall = time.perf_counter() - t_ph
    list_counts = ops.launch_counts()
    buckets = fleet_mod.bucket_problems(
        [(torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev))
         for X, y in problems])
    require(len(buckets) == 1 and buckets[0].signature == (1, 40, 16),
            f"fleet_list: buckets {[b.signature for b in buckets]}")
    solver = BiCADMM("squared", BiCADMMConfig(**FLEET_CFG))
    sub = fleet_mod.fit_many_stacked(solver, buckets[0].As, buckets[0].bs)
    corrected = fleet_mod.corrected_train_losses(solver, sub, buckets[0])
    worst = 0.0
    for j, (X, y) in enumerate(problems):
        require(torch.equal(listed[j].coef, sub.coef[j])
                and int(listed[j].iters) == int(sub.iters[j]),
                f"fleet_list: problem {j} differs from its bucket's lane")
        pred = torch.as_tensor(X.reshape(-1, 16), device=dev) @ sub.coef[j]
        true = float(0.5 * ((pred[:, 0] - torch.as_tensor(
            y.reshape(-1), device=dev)) ** 2).sum())
        worst = max(worst, abs(float(corrected[j]) - true)
                    / max(abs(true), 1e-6))
    require(worst <= 1e-4, f"fleet_list: corrected train loss off the true "
                           f"loss by {worst:.2e} relative")
    report["fleet_list"] = {"problems": len(problems), "fit_s": wall,
                            "launches": list_counts,
                            "corrected_loss_max_rel_err": worst}
    phase("fleet_list", t_ph, f"{len(problems)} problems, m in {{24, 32, "
                              f"40}}, n 16, through fit_many's sequence "
                              f"input: one bucket (1, 40, 16), {wall:.3f} "
                              f"s; each equals its bucket lane; corrected "
                              f"train losses within {worst:.2e} of the "
                              "unpadded losses")

    # iter_caps: cap 0 on some lanes, caps below max_iter on others
    t_ph = time.perf_counter()
    Bc = min(1_000, As_sq.shape[0])
    caps = np.resize(np.array([0, 3, FLEET_CFG["max_iter"], 7]), Bc)
    capped = api.fit_many(problem, As_sq[:Bc], bs_sq[:Bc], iter_caps=caps,
                          options=opts)
    sync()
    it = capped.iters.cpu().numpy()
    st = capped.status.cpu().numpy()
    zero = caps == 0
    require((it[zero] == 0).all() and bool(
        (capped.state.k[torch.as_tensor(zero, device=dev)] == 0).all()),
            "fleet_caps: a cap-0 lane stepped")
    low = (caps > 0) & (caps < FLEET_CFG["max_iter"])
    require((it[low] <= caps[low]).all(), "fleet_caps: a lane ran past its "
                                          "cap")
    stopped = low & (it == caps) & (st != int(SolveStatus.CONVERGED))
    require((st[zero] == int(SolveStatus.ABORTED)).all()
            and (st[stopped] == int(SolveStatus.ABORTED)).all(),
            "fleet_caps: a capped lane is not ABORTED")
    full = caps == FLEET_CFG["max_iter"]
    require(not (st[full] == int(SolveStatus.ABORTED)).any(),
            "fleet_caps: an uncapped lane is ABORTED")
    report["fleet_caps"] = {"lanes": Bc, "cap_zero": int(zero.sum()),
                            "aborted": int((st == int(
                                SolveStatus.ABORTED)).sum()),
                            "fit_s": time.perf_counter() - t_ph}
    phase("fleet_caps", t_ph, f"{Bc} lanes of fleet_sq, caps 0 / 3 / "
                              f"{FLEET_CFG['max_iter']} / 7 cycling: cap-0 "
                              f"lanes keep k = 0, "
                              f"{report['fleet_caps']['aborted']} lanes "
                              "ABORTED (every cap-0 lane and every lane its "
                              "cap stopped), none of the uncapped")

    # a warm refit from the returned state
    t_ph = time.perf_counter()
    ops.reset_launch_counts()
    warm = api.fit_many(problem, As_sq, bs_sq, states=res_sq.state,
                        options=opts)
    sync()
    wall = time.perf_counter() - t_ph
    w_it = warm.iters.cpu().numpy()
    conv = res_sq.status.cpu().numpy() == int(SolveStatus.CONVERGED)
    require((warm.status.cpu().numpy()[conv]
             == int(SolveStatus.CONVERGED)).all(),
            "fleet_warm: a converged lane did not stay converged")
    report["fleet_warm"] = {"fit_s": wall,
                            "outer_iters_max": int(w_it.max()),
                            "outer_iters_mean": float(w_it.mean()),
                            "cold_outer_iters_max":
                                report["fleet_sq"]["outer_iters_max"],
                            "launches": ops.launch_counts()}
    phase("fleet_warm", t_ph, f"fleet_sq refit from its state: outer "
                              f"iterations mean {w_it.mean():.2f} max "
                              f"{w_it.max()} (cold: max "
                              f"{report['fleet_sq']['outer_iters_max']}), "
                              f"{wall:.3f} s; converged lanes stay "
                              "converged")
    return sq_counts


# benchmarks/stream_bench.py's config (kappa 8, gamma 20, rho_c 2, tol 1e-3)
# with max_iter cut from 2,000 to 60 a refit (100 until PR 27, cut for the
# zamba2 phases' time: no refit converges in either); its chunk data
# (seed 0)
STREAM_CFG = dict(kappa=8, gamma=20.0, rho_c=2.0, max_iter=60, tol=1e-3)
# (n, rows a chunk, window in chunks, chunks): dense at DENSE_MAX_N, four
# rank-256 downdates; Woodbury at Fig. 2's width and one node's m, the
# window 6,400 rows < WOODBURY_MAX_M, two rank-800 evictions
STREAM_ROWS = {"stream_dense": (2_048, 256, 8, 12),
               "stream_woodbury": (10_000, 800, 8, 10)}


def stream_chunks(n, m, T, kappa, seed=0):
    """benchmarks/stream_bench.py's ``_chunk_data`` as numpy: T chunks of m
    standard normal rows, b = A w + 0.01 noise, w with kappa entries in
    [1, 2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = np.zeros(n)
    w[rng.choice(n, kappa, replace=False)] = 1.0 + rng.random(kappa)
    out = []
    for _ in range(T):
        X = rng.standard_normal((m, n)).astype(np.float32)
        y = (X @ w + 0.01 * rng.standard_normal(m)).astype(np.float32)
        out.append((X, y))
    return out


def slice_phases(torch, api, ops, report, dev, kernel_row, fit_phase,
                 A, b_w, x_true, kappa, f32_fit) -> dict:
    """The fp64_polish, recovery, stream_dense and stream_woodbury phases
    (module docstring) at the woodbury point (``A``, ``b_w``), beside the
    woodbury phase's f32 fit ``f32_fit`` (its report). Returns each new
    kernel's launches from the run that drives it."""
    import numpy as np
    from repro_torch import faults
    from repro_torch.core import bilinear
    from repro_torch.core.results import SolveStatus
    from repro_torch.kernels import bisect_proj, chol_update, ref
    g = torch.Generator(device=dev).manual_seed(22)
    launches = {}

    # fp64_polish: the woodbury fit with the (7b) polish in f64 ------------
    est64 = api.SparseLinearRegression(kappa=kappa, gamma=10.0, rho_c=4.0,
                                       max_iter=60, tol=0.0,
                                       precision="fp64_polish")
    fit_phase("fp64_polish", A, b_w, x_true, kappa, "woodbury",
              MAIN_KERNELS, est=est64, setup=True,
              needed_types=("l1_epigraph_proj_f64polish",))
    rep = report["fp64_polish"]
    f64_l1 = rep["launches_by_type"]["l1_epigraph_proj_f64polish"]
    require(f64_l1 == rep["launches"]["l1_epigraph_proj"],
            f"fp64_polish: {rep['launches']['l1_epigraph_proj']} l1 "
            f"launches, {f64_l1} of them the f64-polish instantiation")
    launches["l1_epigraph_proj_f64polish"] = f64_l1
    cert = {}
    for name, res in (("fp32", f32_fit), ("fp64_polish", est64.result_)):
        c = bilinear.check_theorem_certificate(res.coef.reshape(-1), kappa)
        cert[name] = {k: float(v) for k, v in c.items()}
    # the kernels at d = 10,000: f64 polish against its plain version and
    # beside the f32 instantiation on the same input; the KKT residual
    # |sum |z| - t| (f64) of each
    nn = A.shape[2]
    z0 = torch.randn(nn, device=dev, generator=g)
    tz = (0.5 * z0.abs().sum()).reshape(())
    got = bisect_proj.l1_epigraph_proj(z0, tz, stats=True, polish64=True)
    want = ref.l1_epigraph_proj_ref(z0, tz, stats=True, polish64=True)
    f32 = bisect_proj.l1_epigraph_proj(z0, tz, stats=True)
    scale = float(z0.abs().max())
    for what, g_, w_ in (("t", got[1], want[1]), ("theta", got[2], want[2])):
        check_close(torch, f"l1_epigraph_proj_f64polish n={nn} {what}", g_,
                    w_, None, rtol=PROJ_RTOL, atol=PROJ_ATOL_PER_MAX * scale)
    kkt = {name: abs(float(out[0].double().abs().sum() - out[1].double()))
           for name, out in (("fp32", f32), ("fp64_polish", got))}
    steps = int(got[3])
    rounds = 2
    kernel_row("l1_epigraph_proj_f64polish",
               f"l1_epigraph_proj_f64polish n={nn} ({steps} polish steps)",
               lambda: bisect_proj.l1_epigraph_proj(z0, tz, polish64=True),
               lambda: ref.l1_epigraph_proj_ref(z0, tz, polish64=True),
               None, (got[0], want[0], None), 8 * nn + 8,
               2 * nn * (1 + rounds * bisect_proj.RUNGS) + 2 * nn * steps,
               tol=(PROJ_RTOL, PROJ_ATOL_PER_MAX * scale), plain_eager=True,
               yardsticks={"f32 instantiation": lambda:
                           bisect_proj.l1_epigraph_proj(z0, tz)})
    print(f"  fp64_polish: {rep['s_per_outer_iter'] * 1e3:.2f} ms an outer "
          f"iteration against the f32 fit's "
          f"{f32_fit_ms(report):.2f} ms; certificate (bilinear residual) "
          f"f32 {cert['fp32']['bilinear']:.3e}, fp64_polish "
          f"{cert['fp64_polish']['bilinear']:.3e}; projection KKT residual "
          f"|sum|z| - t| at n={nn}: f32 polish {kkt['fp32']:.3e}, f64 "
          f"polish {kkt['fp64_polish']:.3e} (theta {float(f32[2])!r} / "
          f"{float(got[2])!r}, steps {int(f32[3])} / {steps})", flush=True)
    rep.update(certificate=cert, projection_kkt_residual=kkt)

    # the f64 polish on lanes: fleet_sq's (10,000, 16) through fit_many
    t_ph = time.perf_counter()
    B, N, m, n = FLEET_ROWS["fleet_sq"]
    As_np, bs_np = fleet_data(B, N, m, n)
    Af, bf = torch.as_tensor(As_np, device=dev), torch.as_tensor(bs_np,
                                                                  device=dev)
    zl = torch.randn(B, n, device=dev, generator=g)
    tl = 0.5 * zl.abs().sum(1)
    got = bisect_proj.l1_epigraph_proj_lanes(zl, tl, stats=True,
                                             polish64=True)
    want = ref.l1_epigraph_proj_lanes_ref(zl, tl, stats=True, polish64=True)
    lscale = float(zl.abs().max())
    need = got[3] > 0
    l1_terms = int((1 + need.long() * rounds * bisect_proj.RUNGS
                    + got[3].long()).sum()) * n
    kernel_row("l1_epigraph_proj_lanes_f64polish",
               f"l1_epigraph_proj_lanes_f64polish ({B}, {n})",
               lambda: bisect_proj.l1_epigraph_proj_lanes(zl, tl,
                                                          polish64=True),
               lambda: ref.l1_epigraph_proj_lanes_ref(zl, tl, polish64=True),
               None, (got[0], want[0], None), 8 * B * n + 8 * B,
               2 * l1_terms,
               tol=(PROJ_RTOL, PROJ_ATOL_PER_MAX * lscale), plain_eager=True,
               yardsticks={"f32 instantiation": lambda:
                           bisect_proj.l1_epigraph_proj_lanes(zl, tl)})
    conversion_bound(torch, l1_terms, report,
                     f"l1_epigraph_proj_lanes_f64polish ({B}, {n})")
    problem = api.SparseProblem("squared", kappa=FLEET_CFG["kappa"],
                                gamma=FLEET_CFG["gamma"],
                                rho_c=FLEET_CFG["rho_c"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_fit = time.perf_counter()
    fleet = api.fit_many(problem, Af, bf, options=api.SolverOptions(
        max_iter=FLEET_CFG["max_iter"], tol=FLEET_CFG["tol"],
        precision="fp64_polish"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_fit
    counts = ops.launch_counts()
    f64_lanes = ops.launch_counts_by_type().get(
        "l1_epigraph_proj_lanes_f64polish", 0)
    trips = int(fleet.iters.max())
    require(bool(torch.isfinite(fleet.coef).all()),
            "fp64_polish_lanes: non-finite coef")
    require(not bool((fleet.status == int(SolveStatus.DIVERGED)).any()),
            "fp64_polish_lanes: a lane DIVERGED")
    require(f64_lanes == counts["l1_epigraph_proj_lanes"] == 121 * trips,
            f"fp64_polish_lanes: {f64_lanes} f64-polish of "
            f"{counts['l1_epigraph_proj_lanes']} lane launches in {trips} "
            "outer iterations (expected 121 each, all f64-polish)")
    launches["l1_epigraph_proj_lanes_f64polish"] = f64_lanes
    # the first and the last lane against solo fp64_polish fits on the card
    solver = api._ReferenceAdapter(problem, api.SolverOptions(
        max_iter=FLEET_CFG["max_iter"], tol=FLEET_CFG["tol"],
        precision="fp64_polish")).solver
    for i in (0, B - 1):
        solo = solver.fit(Af[i], bf[i])
        lane = fleet[int(i)]
        require(int(lane.status) == int(solo.status)
                and torch.equal(lane.support, solo.support)
                and float((lane.coef - solo.coef).abs().max()) <= 1e-3
                and abs(int(lane.iters) - int(solo.iters)) <= 2,
                f"fp64_polish_lanes lane {i}: out of the solo fit's band")
    report["fp64_polish_lanes"] = {
        "B": B, "n": n, "fleet_s": wall, "fits_per_s": B / wall,
        "outer_iters_max": trips,
        "outer_iters_mean": float(fleet.iters.float().mean()),
        "launches": counts}
    phase("fp64_polish_lanes", t_ph,
          f"fleet_sq (B={B}, m={m}, n={n}) in fp64_polish: {wall:.3f} s, "
          f"{B / wall:.1f} fits/s, outer iterations max {trips}; "
          f"{f64_lanes} f64-polish lane "
          "launches (121 an outer iteration), lanes 0 and B - 1 in their "
          "solo fp64_polish fits' band")
    del Af, bf

    # recovery: each rung the genuine fix, driven by faults.inject ---------
    t_ph = time.perf_counter()
    rung_s = []
    fit0 = api._ReferenceAdapter.fit

    def timed_fit(self, *a, **kw):
        t0 = time.perf_counter()
        out = fit0(self, *a, **kw)
        torch.cuda.synchronize()
        rung_s.append(time.perf_counter() - t0)
        return out

    api._ReferenceAdapter.fit = timed_fit
    cases = {}
    try:
        kw = dict(kappa=kappa, gamma=10.0, max_iter=60, tol=0.0)
        for name, hook, where, limit, extra, policy, want in (
                ("retry", faults.nan_x(3), None, 1, {},
                 api.RecoveryPolicy(), ["retry"]),
                ("rho_restart", faults.nan_x(2),
                 lambda s: float(s.cfg.rho_c) < 5.0, None, {},
                 api.RecoveryPolicy(), ["retry", "rho_restart"]),
                ("precision", faults.nan_x(2),
                 lambda s: s.cfg.precision.data == "bfloat16", None,
                 dict(precision="bf16"), api.RecoveryPolicy(),
                 ["retry", "rho_restart", "precision"]),
                ("exhaustion", faults.nan_x(2), None, None, {},
                 api.RecoveryPolicy(max_attempts=2),
                 ["retry", "rho_restart"])):
            rung_s.clear()
            t0 = time.perf_counter()
            with faults.inject(hook, where=where, limit=limit):
                est = api.SparseLinearRegression(rho_c=4.0, recovery=policy,
                                                 **kw, **extra)
                est.fit(A, b_w)
            torch.cuda.synchronize()
            res = est.result_
            log = [tuple(a) for a in res.recovery]
            require([a[0] for a in log] == want,
                    f"recovery {name}: log {log}, expected stages {want}")
            final = int(res.status)
            require((final == int(SolveStatus.DIVERGED))
                    == (name == "exhaustion"),
                    f"recovery {name}: ended {SolveStatus(final).name}")
            cases[name] = {"log": log, "status": SolveStatus(final).name,
                           "wall_s": time.perf_counter() - t0,
                           "rung_s": list(rung_s[1:]),
                           "first_fit_s": rung_s[0]}
        # the x-solver fallback at the parity size (a Woodbury factor of
        # Fig. 3's 25,000 rows a node would take 20 GB)
        from repro_torch.data import SyntheticSpec, make_sparse_regression
        small = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
        As_p, bs_p, _ = make_sparse_regression(1, small)
        rung_s.clear()
        t0 = time.perf_counter()
        with faults.inject(faults.nan_x(2),
                           where=lambda s: s.cfg.x_solver == "pcg"):
            est = api.SparseLinearRegression(
                kappa=small.kappa, gamma=10.0, rho_c=4.0, tol=1e-4,
                max_iter=300, x_solver="pcg",
                recovery=api.RecoveryPolicy()).fit(As_p, bs_p)
        torch.cuda.synchronize()
        res = est.result_
        log = [tuple(a) for a in res.recovery]
        require([a[:2] for a in log] == [
            ("retry", "same configuration"), ("rho_restart", "rho_c=40"),
            ("precision", "fp64_polish"), ("x_solver", "woodbury")]
                and int(res.status) == int(SolveStatus.CONVERGED),
                f"recovery x_solver: log {log}, {res.status_name}")
        cases["x_solver"] = {"log": log, "status": res.status_name,
                             "wall_s": time.perf_counter() - t0,
                             "rung_s": list(rung_s[1:]),
                             "first_fit_s": rung_s[0]}
    finally:
        api._ReferenceAdapter.fit = fit0
    report["recovery"] = cases
    phase("recovery", t_ph, "; ".join(
        f"{k}: " + ", ".join(f"{a[0]} {a[1]} -> "
                             f"{SolveStatus(a[2]).name} in {a[3]} iters "
                             f"({s:.2f} s)"
                             for a, s in zip(v["log"], v["rung_s"]))
        + f" (first fit {v['first_fit_s']:.2f} s)" for k, v in cases.items()))

    # stream_dense and stream_woodbury ---------------------------------------
    for name, backend in (("stream_dense", "dense"),
                          ("stream_woodbury", "woodbury")):
        n, m, window, T = STREAM_ROWS[name]
        t_ph = time.perf_counter()
        chunks = stream_chunks(n, m, T, STREAM_CFG["kappa"])
        problem = api.SparseProblem("squared", kappa=STREAM_CFG["kappa"],
                                    gamma=STREAM_CFG["gamma"],
                                    rho_c=STREAM_CFG["rho_c"])
        opts = api.SolverOptions(max_iter=STREAM_CFG["max_iter"],
                                 tol=STREAM_CFG["tol"])
        s = api.stream(problem, options=opts, window=window)
        eng = s.engine
        spans = {"absorb": [], "evict": [], "refit": []}
        originals = {}
        for span, attr in (("absorb", "_absorb_one"),
                           ("evict", "_evict_oldest"),
                           ("refit", "_refit")):
            originals[attr] = getattr(eng, attr)

            def timed(*a, _f=originals[attr], _span=span, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _f(*a, **kw)
                torch.cuda.synchronize()
                spans[_span].append(time.perf_counter() - t0)
                return out
            setattr(eng, attr, timed)
        resid, iters, statuses = [], [], []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        for X, y in chunks:
            res = s.partial_fit(torch.as_tensor(X, device=dev),
                                torch.as_tensor(y, device=dev))
            iters.append(int(res.iters))
            statuses.append(SolveStatus(int(res.status)).name)
            # the maintained factor against chol(Gram + c I) in f64
            A_win, _ = eng._window_data()
            Aw = A_win.double()
            M = Aw.T @ Aw if backend == "dense" else Aw @ Aw.T
            M += eng._c * torch.eye(M.shape[0], dtype=M.dtype, device=dev)
            L64 = torch.linalg.cholesky(M)
            resid.append(float((eng._acc.L.double() - L64).norm()
                               / L64.norm()))
            del Aw, M, L64
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        counts = ops.launch_counts()
        for attr, f in originals.items():
            setattr(eng, attr, f)
        require(eng.mode == backend, f"{name}: the stream took {eng.mode}")
        require(counts["chol_rank_update"] > 0,
                f"{name}: chol_rank_update was not launched")
        require(not any(st == "DIVERGED" for st in statuses),
                f"{name}: a refit DIVERGED")
        require(max(resid) < 1e-4, f"{name}: the maintained factor is "
                                   f"{max(resid):.3e} from chol(G + cI)")
        require(len(spans["evict"]) == T - window,
                f"{name}: {len(spans['evict'])} evictions")
        launches.setdefault("chol_rank_update", counts["chol_rank_update"])
        # the final refit against a batch fit on the window
        A_win, y_win = eng._window_data()
        batch = api.solve(problem, A_win, y_win, options=opts)
        require(torch.equal(batch.support, res.support),
                f"{name}: the final refit's support differs from the batch "
                "fit's on the window")
        coef_err = float((batch.coef - res.coef).abs().max())
        require(coef_err <= 1e-3, f"{name}: the final refit's coef is "
                                  f"{coef_err} from the batch fit's")
        out = {"n": n, "rows_a_chunk": m, "window": window, "chunks": T,
               "run_s": run_s, "iters": iters, "statuses": statuses,
               "factor_rel_residual": resid,
               "ms_a_chunk": {k: (sum(v) / max(len(v), 1)) * 1e3
                              for k, v in spans.items()},
               "spans_s": spans, "launches": counts,
               "batch_coef_max_abs_diff": coef_err,
               "batch_iters": int(batch.iters)}
        report[name] = out
        # the Cholesky kernel at this stream's shape: a rank-m update of
        # the (window rows or n)-wide factor, timed against its bound and
        # beside one cholesky_ex of the updated matrix, given (formed
        # before the clock) and formed (L L^T + V V^T inside it); the
        # yardsticks are eager calls (CUDA events, host share included)
        k_n = n if backend == "dense" else window * m
        L = eng._acc.L if backend == "dense" else torch.linalg.cholesky(
            M_spd(torch, k_n, dev, g))
        V = torch.randn(k_n, m, device=dev, generator=g)
        Lu, oku = chol_update.chol_rank_update(L, V, 1.0)
        require(bool(oku) and bool(torch.isfinite(Lu).all()),
                f"{name}: chol_rank_update ({k_n}, {m}) lost definiteness")
        Mu = Lu @ Lu.T
        yard = {
            "cholesky_ex given": cuda_ms(
                torch, lambda: torch.linalg.cholesky_ex(Mu), reps=5,
                warmup=1),
            "cholesky_ex formed": cuda_ms(
                torch, lambda: torch.linalg.cholesky_ex(
                    torch.addmm(L @ L.T, V, V.T)), reps=5, warmup=1)}
        del Mu
        t_g = graph_ms(torch, lambda: chol_update.chol_rank_update(L, V, 1.0),
                       reps=5, inner=2)
        t_k = cuda_ms(torch, lambda: chol_update.chol_rank_update(L, V, 1.0),
                      reps=5, warmup=1)
        bnd, by = bound(2 * 4 * k_n * k_n + 4 * k_n * m,
                        6.0 * k_n * k_n / 2 * m)
        out["chol_kernel"] = {"n": k_n, "k": m, "ms": t_g, "call_ms": t_k,
                              "bound_ms": bnd, "bound_by": by,
                              "library_ms": yard}
        phase(name, t_ph,
              f"n={n}, {T} chunks of {m} rows, window {window} chunks, "
              f"{STREAM_CFG} (max_iter cut from 2,000): {run_s:.2f} s; ms a "
              f"chunk absorb {out['ms_a_chunk']['absorb']:.2f}, evict "
              f"{out['ms_a_chunk']['evict']:.2f}, refit "
              f"{out['ms_a_chunk']['refit']:.2f}; iterations {iters}, "
              f"statuses {sorted(set(statuses))}; maintained factor within "
              f"{max(resid):.2e} of chol(G + cI) in f64; final refit within "
              f"{coef_err:.2e} of the batch fit on the window (same "
              f"support); chol_rank_update {counts['chol_rank_update']} "
              f"launches, ({k_n}, k={m}) {t_g:.4f} ms (eager call "
              f"{t_k:.4f} ms) against a {by} bound of {bnd:.4f} ms; "
              "cholesky_ex of the updated matrix given "
              f"{yard['cholesky_ex given']:.4f} ms, formed "
              f"{yard['cholesky_ex formed']:.4f} ms")

    # chol_rank_update against its plain version, bit for bit, at (256, 16)
    k_n, k_k = 256, 16
    L = torch.linalg.cholesky(M_spd(torch, k_n, dev, g))
    V = 0.3 * torch.randn(k_n, k_k, device=dev, generator=g)
    Lu, _ = chol_update.chol_rank_update(L, V, 1.0)
    wants = {}
    for sign, L0 in ((1.0, L), (-1.0, Lu)):
        gotc, gok = chol_update.chol_rank_update(L0, V, sign)
        wantc, wok = ref.chol_rank_update_ref(L0, V, sign)
        wants[sign] = wantc
        require(torch.equal(gotc, wantc) and bool(gok) == bool(wok),
                f"chol_rank_update n={k_n} k={k_k} sign {sign:+.0f}: not "
                "bit-equal to its plain version")
    Mu = Lu @ Lu.T
    # library: one cuSOLVER Cholesky of the updated matrix (given)
    kernel_row("chol_rank_update",
               f"chol_rank_update n={k_n} k={k_k} (bit for bit, update and "
               "downdate)",
               lambda: chol_update.chol_rank_update(L, V, 1.0),
               lambda: ref.chol_rank_update_ref(L, V, 1.0),
               lambda: torch.linalg.cholesky_ex(Mu),
               (Lu, wants[1.0], None),
               2 * 4 * k_n * k_n + 4 * k_n * k_k,
               6.0 * k_n * k_n / 2 * k_k, tol=(0.0, 0.0), plain_eager=True,
               plain_reps=1)
    # and at (500, 33): 16 panels (the last one ragged), 136 tiles, k across
    # five 8-rotation chunks. The plain version runs on the card (~20 torch
    # launches, ~0.3 ms, a (vector, column) step: ~5 s a sign), where every
    # f32 square root is correctly rounded; a CPU build of torch may round
    # some by an ulp
    t_ph = time.perf_counter()
    k_n, k_k = 500, 33
    L = torch.linalg.cholesky(M_spd(torch, k_n, dev, g))
    V = 0.3 * torch.randn(k_n, k_k, device=dev, generator=g)
    L0 = L
    for sign in (1.0, -1.0):
        gotc, gok = chol_update.chol_rank_update(L0, V, sign)
        wantc, wok = ref.chol_rank_update_ref(L0, V, sign)
        require(torch.equal(gotc, wantc) and bool(gok) == bool(wok),
                f"chol_rank_update n={k_n} k={k_k} sign {sign:+.0f}: not "
                "bit-equal to its plain version")
        L0 = gotc
    phase("chol_multi_panel", t_ph,
          f"chol_rank_update n={k_n} k={k_k}: update and downdate bit for "
          "bit the plain version on the card")
    return launches


def f32_fit_ms(report) -> float:
    """The woodbury phase's ms an outer iteration."""
    return report["woodbury"]["s_per_outer_iter"] * 1e3


def M_spd(torch, n, dev, g):
    """A well-conditioned SPD matrix (n, n) on the card: A^T A / n + I."""
    a = torch.randn(n + 8, n, device=dev, generator=g)
    return a.T @ a / n + torch.eye(n, device=dev)


# the serving cells' traffic: 4 prompts of 2,048 tokens (numpy seed 0) into
# a cache of 2,080 positions, then 32 greedy decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2_048, 32


def flash_per_prefill(cfg) -> int:
    """Flash launches a prefill: one a layer, or for the hybrid family one
    an application of the shared block (n_layers / attn_every)."""
    return (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
            else cfg.n_layers)


def _gen(torch, device, seed=0):
    return torch.Generator(device=device).manual_seed(seed)


def serve_phase(torch, dev, report, arch: str, key: str) -> dict:
    """9. / 13. The serving path of ``arch`` at full width and depth (module
    docstring), reported under ``key``. Returns the launch counts of the
    timed prefill and decode steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    t0 = time.perf_counter()
    cfg = get_config(arch)
    B, S, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    max_seq = S + n_new
    n_flash = flash_per_prefill(cfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    model = zoo.init_params(cfg, generator=_gen(torch, dev), device=dev)
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
    dec_idle = (None if dec_busy == 0
                else max(0.0, 1.0 - dec_busy / (dec_window * 1e3)))
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t_p = time.perf_counter()
    logits, cache = zoo.prefill(model, cfg, batch, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t_p
    flash_prefill = ops.launch_counts()["flash_attention"]
    require(flash_prefill == n_flash,
            f"{key}: the prefill launched the flash kernel {flash_prefill} "
            f"times, not {n_flash}")
    require(tuple(logits.shape) == (B, 1, cfg.padded_vocab),
            f"{key}: prefill logits of shape {tuple(logits.shape)}")
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
    require(counts["flash_attention"] == flash_prefill,
            f"{key}: decode launched the flash kernel "
            f"{counts['flash_attention'] - flash_prefill} times")
    require(bool(finite), f"{key}: non-finite logits")
    peak = torch.cuda.max_memory_allocated() - mem0
    cache_bytes = {k: t.numel() * t.element_size() for k, t in cache.items()}
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
            f"{key}: the profiled prefill shows no flash-attention kernel")
    top = sorted(table.items(), key=lambda kv: -kv[1]["device_ms"])[:6]
    share = flash_ms / busy if busy > 0 else None
    report[key] = {
        "config": arch, "batch": B, "prompt_len": S, "max_seq": max_seq,
        "decode_steps": n_new, "init_s": init_s, "prefill_s": prefill_s,
        "prompt_tokens_per_s": B * S / prefill_s,
        "decode_ms_per_token": decode_s / n_new * 1e3,
        "weights_bytes": w_bytes, "cache_bytes": cache_bytes,
        "peak_bytes_above_start": peak, "launches": counts,
        "flash_per_prefill": flash_prefill,
        "profile": {"window_s_profiler_on": window, "device_busy_ms": busy,
                    "flash_ms": flash_ms, "flash_share": share,
                    "top": dict(top)},
        "decode_profile": {"steps": 2, "window_s_profiler_on": dec_window,
                           "device_busy_ms": dec_busy,
                           "idle_share": dec_idle,
                           "kernel_launches": dec_launches},
        "generated": torch.cat(generated, 1).tolist()}
    share_txt = ("not measured (the profiler saw no device time)"
                 if share is None else
                 f"{share:.3f} ({flash_ms:.1f} of {busy:.1f} ms busy in a "
                 f"{window * 1e3:.1f} ms window with the profiler on)")
    idle_txt = ("idle share not measured" if dec_idle is None
                else f"idle share {dec_idle:.3f}")
    cache_txt = " + ".join(f"{k} {v / 1e9:.3f}" for k, v in
                           cache_bytes.items())
    phase(key, t0, f"{arch}, {cfg.n_layers} layers"
                   + (f" ({cfg.n_layers // cfg.attn_every} groups, shared "
                      f"attention block)" if cfg.family == "hybrid" else "")
                   + f", {cfg.dtype}, {w_bytes / 1e9:.2f} GB of weights "
                    f"drawn in "
                    f"{init_s:.2f} s: prefill {B} x {S} tokens "
                    f"{prefill_s * 1e3:.1f} ms ({B * S / prefill_s:.0f} "
                    f"prompt tokens/s), {n_new} decode steps "
                    f"{decode_s / n_new * 1e3:.2f} ms per token (profiled: "
                    f"device busy {dec_busy / 2:.2f} ms of "
                    f"{dec_window * 1e3 / 2:.2f} ms per step, {idle_txt}, "
                    f"{dec_launches // 2} kernel launches per step); flash "
                    f"launches {flash_prefill} per prefill, 0 in decode; "
                    f"peak device memory above the start {peak / 1e9:.2f} GB "
                    f"(weights {w_bytes / 1e9:.2f} GB + cache {cache_txt} "
                    f"GB); flash share of the prefill's device time "
                    f"{share_txt}; top: "
                    + "; ".join(f"{k[:40]} {v['device_ms']:.1f} ms/"
                                f"{v['calls']}" for k, v in top[:4]))
    del model
    torch.cuda.empty_cache()
    return counts


def flash_vs_full(torch, report, key, label, cfg, model, attn, tokens,
                  n_new, what) -> None:
    """(a) of the parity phases: the prefill of ``tokens`` and ``n_new``
    greedy decode steps through the kernel against the same model through
    the plain ``impl="full"`` (logits within LM_TOL of their scale), and
    the first output of the attention ``attn`` on the kernel path against
    the f32 attention of the same q, k and v within one bf16 rounding (its
    input and output caught by forward pre-hooks on ``wq`` and ``wo``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, transformer, zoo

    t0 = time.perf_counter()
    V, (B, S) = cfg.vocab_size, tuple(tokens.shape)
    steps, caches, first = {}, {}, {}
    impl = "flash"
    hooks = [attn.wq.register_forward_pre_hook(
                 lambda mod, args: first.setdefault("x", args[0].clone())),
             attn.wo.register_forward_pre_hook(
                 lambda mod, args: first.setdefault(impl, args[0].clone()))]
    ops.reset_launch_counts()
    for impl in ("flash", "full"):
        logits, caches[impl] = zoo.prefill(model, cfg, {"tokens": tokens},
                                           max_seq=S + n_new, impl=impl)
        steps[impl] = [logits[:, -1, :V].float()]
    for hook in hooks:
        hook.remove()
    require(ops.launch_counts()["flash_attention"] == flash_per_prefill(cfg),
            f"{key}: only the flash prefill launches the kernel, "
            f"{flash_per_prefill(cfg)} times")
    # the kernel path's attention against the f32 attention of the same
    # bf16 q, k, v (recomputed: the same calls on the same inputs)
    with torch.inference_mode():
        q, k, v = attention._project_qkv(
            attn, cfg, first.pop("x"), transformer._prompt_rope(cfg, tokens))
        exact = attention._sdpa_full(q.float(), k.float(), v.float(),
                                     causal=True).reshape(B, S, -1)
    del q, k, v
    attn_err = {i: float((first[i].float() - exact).abs().max())
                for i in first}
    attn_scale = float(exact.abs().max())
    require(torch.allclose(first["flash"].float(), exact,
                           rtol=FLASH_TOL["bfloat16"][0],
                           atol=FLASH_TOL["bfloat16"][1]),
            f"{key}: {what} on the kernel path is {attn_err['flash']:.3e} "
            f"from the f32 attention of its q, k, v (limit rtol "
            f"{FLASH_TOL['bfloat16'][0]}, atol {FLASH_TOL['bfloat16'][1]}; "
            f"|o| up to {attn_scale:.3e})")
    del exact, first
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
                f"{key}: step {i} logits differ by {err:.3f}, over "
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
            f"{key}: greedy next tokens differ: "
            f"{got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
    agree = [int((a.argmax(-1) == b.argmax(-1)).sum())
             for a, b in zip(steps["flash"][1:], steps["full"][1:])]
    del caches, steps
    torch.cuda.empty_cache()
    report[f"{key}_flash_vs_full"] = {
        "attention_max_abs_err_vs_f32": attn_err,
        "attention_max_abs": attn_scale,
        "worst_err_over_scale": worst, "steps": n_new + 1,
        "next_token_equal": same.tolist(), "next_token_ties": ties.tolist(),
        "decode_greedy_agree_per_step": agree}
    phase(key, t0, f"{label}, {cfg.dtype}, {B} x {S}: prefill + {n_new} "
                   f"decode steps through the kernel vs impl='full': {what} "
                   f"output within {attn_err['flash']:.3e} of the f32 "
                   f"attention (limit rtol 2^-8, atol 1e-4; impl='full' "
                   f"{attn_err['full']:.3e}; |o| up to {attn_scale:.3e}); "
                   f"logits within {worst:.2e} of their scale (limit "
                   f"{LM_TOL}); greedy next token equal for "
                   f"{int(same.sum())} of {B} prompts "
                   f"({int((ties & ~same).sum())} bf16 ties); decode steps' "
                   f"greedy tokens agree in {sum(agree)} of {B * n_new}")


def card_vs_cpu(torch, dev, report, key, label, cfg, n_prompt,
                per_scale=False) -> None:
    """(b): a reduced f32 config on the card against the port's CPU run:
    forward over ``n_prompt`` tokens (numpy seed 1), the prefill of those
    (logits and every cache entry) and one decode step at ``n_prompt``
    (logits and the cache), rtol and atol 1e-4; with ``per_scale`` the
    atol is 1e-4 per unit of each tensor's scale (its largest |entry| on
    the CPU)."""
    import copy

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    t0 = time.perf_counter()
    on_cpu = zoo.init_params(cfg, generator=_gen(torch, "cpu"), device="cpu")
    on_card = copy.deepcopy(on_cpu).to(dev)
    tok_np = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (2, n_prompt + 1))
    prompt = {"tokens": tok_np[:, :n_prompt]}
    ops.reset_launch_counts()
    outs = {}
    for name, model in (("card", on_card), ("cpu", on_cpu)):
        full, _ = zoo.forward(model, cfg, prompt)
        last, cache = zoo.prefill(model, cfg, prompt, max_seq=n_prompt + 1)
        pre = [t.clone() for t in cache.values()]
        step, cache = zoo.decode_step(model, cfg, {
            "token": tok_np[:, n_prompt:], "pos": n_prompt}, cache)
        outs[name] = [t.cpu() for t in (full, last, *pre, step,
                                        *cache.values())]
    require(ops.launch_counts()["flash_attention"]
            == 2 * flash_per_prefill(cfg),
            f"{key}: the card's forward and prefill launch the kernel "
            f"{flash_per_prefill(cfg)} times each")
    err = worst = 0.0
    for got, want in zip(outs["card"], outs["cpu"]):
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        err, worst = max(err, diff), max(worst, diff / max(scale, 1e-30))
        atol = 1e-4 * scale if per_scale else 1e-4
        require(torch.allclose(got, want, rtol=1e-4, atol=atol),
                f"{key}: {label}, card vs CPU differ by {diff} (atol "
                f"{atol:.2e})")
    limit = "1e-4 x scale" if per_scale else "1e-4"
    phase(key, t0, f"{label}, f32: forward, prefill logits and cache, "
                   f"decode logits and cache over {n_prompt} tokens on the "
                   f"card within {err:.2e} of the port's CPU run, "
                   f"{worst:.2e} of a tensor's scale (limit rtol 1e-4, atol "
                   f"{limit})")
    report[f"{key}_card_vs_cpu"] = {"max_abs_diff": err,
                                    "max_diff_over_scale": worst}


def decode_vs_forward(torch, dev, report, key, label, cfg, n_forward,
                      n_prompt) -> None:
    """(c): the prefill of ``n_prompt`` tokens and decode steps to
    ``n_forward`` against the forward pass over ``n_forward`` tokens at
    each of those positions, on the card (rtol and atol 2e-3)."""
    import numpy as np

    from repro_torch.models import zoo

    t0 = time.perf_counter()
    model = zoo.init_params(cfg, generator=_gen(torch, dev), device=dev)
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, n_forward)), device=dev)
    full, _ = zoo.forward(model, cfg, {"tokens": x})
    _, cache = zoo.prefill(model, cfg, {"tokens": x[:, :n_prompt]},
                           max_seq=n_forward)
    err = 0.0
    for pos in range(n_prompt, n_forward):
        step, cache = zoo.decode_step(model, cfg, {"token": x[:, pos:pos + 1],
                                                   "pos": pos}, cache)
        got, want = step[:, 0, :cfg.vocab_size], full[:, pos]
        err = max(err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
                f"{key}: decode at {pos} after prefill differs from forward "
                f"by {err}")
    del model, cache, full
    torch.cuda.empty_cache()
    report[f"{key}_decode_vs_forward"] = {"max_abs_diff": err}
    phase(key, t0, f"{label}, f32, 2 x {n_forward}: decode steps "
                   f"{n_prompt}..{n_forward - 1} after prefill(x[:"
                   f"{n_prompt}]) within {err:.2e} of forward(x) (rtol and "
                   f"atol 2e-3)")


def lm_parity_phase(torch, dev, report) -> None:
    """10. The dense LM on the card against its plain attention, against
    the port's CPU run, and its decode against its forward pass."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import zoo

    # (a) full width, 2 layers, bf16: the kernel against impl="full"
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    model = zoo.init_params(cfg, generator=_gen(torch, dev), device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    flash_vs_full(torch, report, "lm_parity", "qwen3-8b cut to 2 layers",
                  cfg, model, model.blocks[0].attn, tokens, 8,
                  "layer 0's attention")
    del model
    torch.cuda.empty_cache()
    # (b) the reduced f32 config: the card against the port's CPU run
    card_vs_cpu(torch, dev, report, "lm_parity",
                "reduced qwen3-8b (2 layers, d_model 64)",
                reduced_config(get_config("qwen3-8b")), 31)
    # (c) decode after prefill against the forward pass, full width, f32
    decode_vs_forward(torch, dev, report, "lm_parity",
                      "qwen3-8b cut to 2 layers",
                      dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                                          dtype="float32"), 128, 127)


def zamba2_parity_phase(torch, dev, report) -> None:
    """14. The hybrid LM on the card against its plain attention (at head
    dim 80), against the port's CPU run, and its decode against its
    forward pass across SSD chunks."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import zoo

    full_width = get_config("zamba2-2.7b")
    two_groups = 2 * full_width.attn_every
    # (a) full width, 2 groups (12 Mamba2 layers, 2 applications of the
    # shared block), bf16: the kernel against impl="full"
    cfg = dataclasses.replace(full_width, n_layers=two_groups)
    model = zoo.init_params(cfg, generator=_gen(torch, dev), device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    flash_vs_full(torch, report, "zamba2_parity",
                  f"zamba2-2.7b cut to 2 groups ({two_groups} Mamba2 "
                  f"layers)", cfg, model, model.shared.attn, tokens, 8,
                  "the shared block's first attention")
    del model
    torch.cuda.empty_cache()
    # (b) the reduced config at head dim 80, f32, two SSD chunks. The atol
    # is per unit of scale: rounding the matmuls otherwise (f64 products
    # rounded once, on the CPU) moves this run's 256-token logits by 5.4e-4
    # at a scale of 59, and the SSD's decays carry such changes through
    # whole chunks
    red = reduced_config(full_width, n_layers=4, d_model=160)
    require(red.resolved_head_dim == 80, "zamba2_parity: reduced Dh 80")
    card_vs_cpu(torch, dev, report, "zamba2_parity",
                "reduced zamba2-2.7b (2 groups of 2, d_model 160, Dh 80)",
                red, 256, per_scale=True)
    # (c) decode after a two-chunk prefill against the forward pass, full
    # width, 2 groups, f32
    decode_vs_forward(torch, dev, report, "zamba2_parity",
                      "zamba2-2.7b cut to 2 groups",
                      dataclasses.replace(full_width, n_layers=two_groups,
                                          dtype="float32"), 384, 256)


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
    from repro_torch.core import path as path_mod
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

    # the CPU side of phase 8 (the parity fits' and paths' CPU fits) runs in
    # a worker process from here on, beside the card's phases 3 to 8
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    cpu_recv, cpu_send = ctx.Pipe(duplex=False)
    cpu_proc = ctx.Process(target=parity_cpu, args=(cpu_send,), daemon=True)
    cpu_proc.start()
    cpu_send.close()

    def stop_worker():
        if cpu_proc.is_alive():
            cpu_proc.terminate()
        cpu_proc.join()
        cpu_recv.close()

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
                   plain_eager=False, yardsticks=None, plain_reps=5):
        """``plain_eager``: the plain version reads the host inside its
        loops, so it is timed eagerly (no CUDA graph can hold it), the
        median of ``plain_reps`` calls (after 3 warm-up calls when there
        are more than one).
        ``yardsticks``: {label: fn} of other ways to the same result, each
        timed like the kernel (reported, not used by the port)."""
        err = check_close(torch, label, *got_want_scale,
                          **({} if tol is None else
                             dict(rtol=tol[0], atol=tol[1])))
        bnd, by = bound(nbytes, flops, peak)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "shape": label,
               "max_abs_err": err, "ms": graph_ms(torch, fn),
               "plain_ms": (cuda_ms(torch, plain, reps=plain_reps,
                                    warmup=3 if plain_reps > 1 else 0)
                            if plain_eager
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
    # the lane projections at the fleet phase's shapes (fleet_sq's
    # (10,000, 16), fleet_sq_wide's (2,000, 64) with kappa 4 / 8 / 12 / 16
    # cycling) against their plain versions (s* and the step counts equal,
    # z, t and u_max within the solo projections' tolerance) and, lane by
    # lane, against the solo kernel (bit for bit). The bound counts each
    # lane's thresholds as the solo rows do; bytes: z and t0 / kappa read,
    # the outputs written.
    lane_stats = {}
    for (Bl, dl), kap_cycle in (((10_000, 16), (4,)),
                                ((2_000, 64), (4, 8, 12, 16))):
        zl = (torch.randn(Bl, dl, device=dev, generator=g)
              * torch.rand(Bl, 1, device=dev, generator=g))
        zl[::5, :3] = 0.0                       # zeros and a tie cluster
        zl[1::5, 2:6] = zl[1::5, 2:3]
        scale = float(zl.abs().max())
        ptol = (PROJ_RTOL, PROJ_ATOL_PER_MAX * scale)
        tl = (torch.rand(Bl, device=dev, generator=g) - 0.3) * zl.abs().sum(1)
        kl = torch.as_tensor(kap_cycle, dtype=torch.float32,
                             device=dev).repeat(Bl // len(kap_cycle))
        got = bisect_proj.l1_epigraph_proj_lanes(zl, tl, stats=True)
        want = ref.l1_epigraph_proj_lanes_ref(zl, tl, stats=True)
        require(torch.equal(got[3], want[3]),
                f"l1_epigraph_proj_lanes ({Bl}, {dl}): polish steps differ "
                "from the plain version's")
        for what, g_, w_ in (("t", got[1], want[1]),
                             ("theta", got[2], want[2])):
            check_close(torch, f"l1_epigraph_proj_lanes ({Bl}, {dl}) {what}",
                        g_, w_, None, rtol=ptol[0], atol=ptol[1])
        gs = bisect_proj.skappa_support_lanes(zl, kl, stats=True)
        ws = ref.skappa_support_lanes_ref(zl, kl, stats=True)
        require(torch.equal(gs[1], ws[1]) and torch.equal(gs[2], ws[2]),
                f"skappa_support_lanes ({Bl}, {dl}): s* or the search steps "
                "differ from the plain version's")
        check_close(torch, f"skappa_support_lanes ({Bl}, {dl}) u_max", gs[0],
                    ws[0], None, rtol=ptol[0], atol=ptol[1])
        solo = [torch.empty_like(x) for x in (*got, *gs)]
        for i in range(Bl):
            z_i, t_i, th_i, k_i = bisect_proj.l1_epigraph_proj(
                zl[i], tl[i], stats=True)
            u_i, s_i, ks_i = bisect_proj.skappa_support(
                zl[i], float(kap_cycle[i % len(kap_cycle)]), stats=True)
            for dst, v in zip(solo, (z_i, t_i, th_i, k_i, u_i, s_i, ks_i)):
                dst[i] = v
        require(all(torch.equal(a, b) for a, b in zip(solo, (*got, *gs))),
                f"lane projections ({Bl}, {dl}): a lane differs from the "
                "solo kernel's output on its row")
        rounds = runtime.ladder_rounds("cuda")
        need = got[3] > 0
        l1_terms = int((1 + need.long() * rounds * bisect_proj.RUNGS
                        + got[3].long()).sum()) * dl
        search = gs[2] > 0
        sk_terms = int((2 + search.long() * rounds * bisect_proj.RUNGS
                        + 4 * gs[2].long()).sum()) * dl
        lane_stats[f"({Bl}, {dl})"] = {
            "polish_steps_mean": float(got[3].float().mean()),
            "search_steps_mean": float(gs[2].float().mean()),
            "layout": bisect_proj.lane_plan(dl)._asdict()}
        kernel_row("l1_epigraph_proj_lanes",
                   f"l1_epigraph_proj_lanes ({Bl}, {dl}), "
                   f"{bisect_proj.lane_plan(dl)}",
                   lambda zl=zl, tl=tl: bisect_proj.l1_epigraph_proj_lanes(
                       zl, tl),
                   lambda zl=zl, tl=tl: ref.l1_epigraph_proj_lanes_ref(zl,
                                                                       tl),
                   None, (got[0], want[0], None), 8 * Bl * dl + 8 * Bl,
                   2 * l1_terms, tol=ptol, plain_eager=True)
        conversion_bound(torch, l1_terms, report,
                         f"l1_epigraph_proj_lanes ({Bl}, {dl})")
        kernel_row("skappa_support_lanes",
                   f"skappa_support_lanes ({Bl}, {dl}) kappa "
                   f"{'/'.join(map(str, kap_cycle))}",
                   lambda zl=zl, kl=kl: bisect_proj.skappa_support_lanes(
                       zl, kl),
                   lambda zl=zl, kl=kl: ref.skappa_support_lanes_ref(zl, kl),
                   None, (gs[0], ws[0], None), 8 * Bl * dl + 8 * Bl,
                   2 * sk_terms, tol=ptol, plain_eager=True)
        print(f"  lane projections ({Bl}, {dl}): every lane equals the solo "
              "kernel on its row bit for bit", flush=True)
        del zl, got, want, gs, ws, solo
    report["lane_projections"] = lane_stats
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
    # with its scalar shift, that fit's stacked polish (200,000, 4,000), and
    # the spectral Woodbury refinement's per-node (8, 800, 10,000) with its
    # scalar shift sigma + rho_c (path_gamma's point, gamma = 10, rho_c = 4).
    # Yardsticks (no one PyTorch call computes it): the composition of the
    # matvec and rmatvec kernels, and two torch.matmul calls. The bound
    # reads A, p and the shift once and writes the output; 4 flop an entry
    # of A.
    plans = {}
    for Aa, vec_shift, c in ((A_all, True, None), (A3, False, 4.1),
                             (A3.view(-1, A3.shape[-1]), True, None),
                             (A, False, 1.0 / (N * 10.0) + 4.0)):
        nn = Aa.shape[-1]
        Na = Aa.shape[0] if Aa.ndim == 3 else 1
        p = torch.randn(Aa.shape[:-2] + (nn,), device=dev, generator=g)
        shift = (torch.rand(nn, device=dev, generator=g) + 1e-3
                 if vec_shift else c)
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

    # the node products at the fleet phase's (B N, m, n) views, far narrower
    # than any shape above: fleet_sq's (10,000, 32, 16) and fleet_sq_wide's
    # (2,000, 128, 64) -- the dense set-up's and polish's gram, A^T b and the
    # training loss's matvec, Newton-CG's matvec / rmatvec, normal_matvec
    for Bf, mf, nf in ((10_000, 32, 16), (2_000, 128, 64)):
        Af = torch.randn(Bf, mf, nf, device=dev, generator=g)
        xf = torch.randn(Bf, nf, device=dev, generator=g)
        yf = torch.randn(Bf, mf, device=dev, generator=g)
        label = f"({Bf}, {mf}, {nf}) fleet view"
        scale = float(ref.gram_ref(Af.abs()).max())
        kernel_row("gram", f"gram A^T A {label}", lambda Af=Af: gram.gram(Af),
                   lambda Af=Af: ref.gram_ref(Af),
                   lambda Af=Af: torch.matmul(Af.mT, Af),
                   (gram.gram(Af), ref.gram_ref(Af), scale),
                   4 * Af.numel() + 4 * Bf * nf * nf, Bf * nf * (nf + 1) * mf)
        for name, fn, plain, lib, v, mags in (
                ("matvec", matvec.matvec, ref.matvec_ref,
                 lambda Af=Af, xf=xf: torch.matmul(Af, xf[..., None]), xf,
                 (Af.abs() @ xf.abs()[..., None]).max()),
                ("rmatvec", matvec.rmatvec, ref.rmatvec_ref,
                 lambda Af=Af, yf=yf: torch.matmul(Af.mT, yf[..., None]), yf,
                 (Af.abs().mT @ yf.abs()[..., None]).max())):
            kernel_row(name, f"{name} {label}",
                       lambda fn=fn, Af=Af, v=v: fn(Af, v),
                       lambda plain=plain, Af=Af, v=v: plain(Af, v), lib,
                       (fn(Af, v), plain(Af, v), float(mags)),
                       4 * (Af.numel() + Bf * (mf + nf)),
                       2 * Af.numel())
        got = matvec.normal_matvec(Af, xf, 1.25)
        want = ref.normal_matvec_ref(Af, xf, 1.25)
        mags = (Af.abs().mT @ (Af.abs() @ xf.abs()[..., None]))[..., 0]
        kernel_row("normal_matvec", f"normal_matvec {label} scalar shift",
                   lambda Af=Af, xf=xf: matvec.normal_matvec(Af, xf, 1.25),
                   lambda Af=Af, xf=xf: ref.normal_matvec_ref(Af, xf, 1.25),
                   None, (got, want, float((mags + 1.25 * xf.abs()).max())),
                   4 * (Af.numel() + 2 * xf.numel()),
                   4 * Af.numel() + 2 * xf.numel())
        del Af, xf, yf, got, want, mags

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
    # first rows are the path's shape), a ragged shape whose last block
    # is short and whose nb is not a multiple of 4, and the sharded cell's
    # per-rank block (1, 25,000, 1,000) with M = 1 (its 480 launches of
    # each)
    M3 = 4
    Ar = torch.randn(2, 3_000, 1_001, device=dev, generator=g)
    for Ab, Mb, K in ((A3, M3, 1), (A3, M3, 3), (Ar, M3, 1), (Ar, M3, 3),
                      (A3[:1, :, :1_000].contiguous(), 1, 1)):
        Nb, mb, nbb = Ab.shape
        nb = -(-nbb // Mb)
        x = torch.randn(Nb, Mb, nb, K, device=dev, generator=g)
        y = torch.randn(Nb, Mb, mb, K, device=dev, generator=g)
        label = f"{tuple(Ab.shape)} M={Mb} K={K}"
        nbytes = 4 * (Nb * mb * nbb + Nb * Mb * (nb + mb) * K)
        flops = 2 * Nb * mb * nbb * K
        view = (Ab.view(Nb, mb, Mb, nb).transpose(1, 2)
                if nbb == Mb * nb else None)
        got, want = (block_matvec.block_matvec(Ab, x, Mb),
                     ref.block_matvec_ref(Ab, x, Mb))
        scale = float(ref.block_matvec_ref(Ab.abs(), x.abs(), Mb).max())
        kernel_row("block_matvec", f"block_matvec {label}",
                   lambda Ab=Ab, x=x, Mb=Mb:
                       block_matvec.block_matvec(Ab, x, Mb),
                   lambda Ab=Ab, x=x, Mb=Mb: ref.block_matvec_ref(Ab, x, Mb),
                   None if view is None else
                   (lambda view=view, x=x: torch.matmul(view, x)),
                   (got, want, scale), nbytes, flops)
        del got, want
        got, want = (block_matvec.block_rmatvec(Ab, y, Mb),
                     ref.block_rmatvec_ref(Ab, y, Mb))
        scale = float(ref.block_rmatvec_ref(Ab.abs(), y.abs(), Mb).max())
        kernel_row("block_rmatvec", f"block_rmatvec {label}",
                   lambda Ab=Ab, y=y, Mb=Mb:
                       block_matvec.block_rmatvec(Ab, y, Mb),
                   lambda Ab=Ab, y=y, Mb=Mb:
                       ref.block_rmatvec_ref(Ab, y, Mb),
                   None if view is None else
                   (lambda view=view, y=y: torch.matmul(view.mT, y)),
                   (got, want, scale), nbytes, flops)
        del got, want
    # the bf16 / fp16 block kernels: the sharded engine's per-rank block
    # (1, 25,000, 1,000) first (its sub-solver's shape; K = 3 for softmax),
    # then Fig. 3's (8, 25,000, 4,000) with M = 4, the ragged
    # (2, 3,000, 1,001) (the scalar route) and, in fp16, sharded_fp16's
    # one-node block (1, 25,000, 4,000), held to their plain versions at
    # the f32-accumulation bound 1e-5 x scale + 1e-6; bytes count 2 for an
    # element of A; the yardstick is torch.matmul on the half-width (N, M,
    # m, nb) view and half-width blocks (bf16 out: another rounding); each
    # row prints the plan it ran (kernels/block_matvec.py, block_plan)
    block_plans = report.setdefault("block_plans", {})
    for sfx, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        for Ab, Mb, K in ((A3[:1, :, :1_000].to(dt), 1, 1),
                          (A3[:1, :, :1_000].to(dt), 1, 3),
                          (A3.to(dt), M3, 1), (Ar.to(dt), M3, 1),
                          *(((A3[:1].to(dt), 1, 1),) if sfx == "f16"
                            else ())):
            Nb, mb, nbb = Ab.shape
            nb = -(-nbb // Mb)
            x = torch.randn(Nb, Mb, nb, K, device=dev, generator=g)
            y = torch.randn(Nb, Mb, mb, K, device=dev, generator=g)
            label = f"{tuple(Ab.shape)} {sfx} M={Mb} K={K}"
            nbytes = 2 * Ab.numel() + 4 * Nb * Mb * (nb + mb) * K
            flops = 2 * Ab.numel() * K
            view = (Ab.view(Nb, mb, Mb, nb).transpose(1, 2)
                    if nbb == Mb * nb else None)
            for adj, v in ((False, x), (True, y)):
                kname = "block_rmatvec" if adj else "block_matvec"
                fn = block_matvec.block_rmatvec if adj \
                    else block_matvec.block_matvec
                plain = ref.block_rmatvec_ref if adj \
                    else ref.block_matvec_ref
                got = fn(Ab, v, Mb)
                require(got.dtype == torch.float32, f"{kname}_{sfx}: f32 out")
                require(torch.equal(fn(Ab, v, Mb), got),
                        f"{kname}_{sfx} {label}: two calls differ")
                plan = block_matvec.plan_for(Ab, Mb, K, adjoint=adj)
                block_plans[f"{kname} {label}"] = plan._asdict()
                print(f"  {kname} {label}: plan {plan._asdict()}",
                      flush=True)
                scale = float(plain(Ab.float().abs(), v.abs(), Mb).max())
                kernel_row(f"{kname}_{sfx}", f"{kname} {label}",
                           lambda Ab=Ab, v=v, fn=fn, Mb=Mb: fn(Ab, v, Mb),
                           lambda Ab=Ab, v=v, plain=plain, Mb=Mb:
                               plain(Ab, v, Mb),
                           None if view is None else
                           (lambda view=view, vh=v.to(dt), adj=adj:
                               torch.matmul(view.mT if adj else view, vh)),
                           (got, plain(Ab, v, Mb), scale), nbytes, flops,
                           tol=(0.0, 1e-5 * scale + 1e-6))
                del got
            del Ab, view, x, y
        torch.cuda.empty_cache()
    # gram at a sharded rank's block, A_ij^T A_ij of (1, 1, 25,000, 1,000)
    # (its sub-solver's set-up), in f32 and in bf16 (the FP64 tensor cores:
    # one f32 rounding of the f64 plain version, as the rows above)
    for dt in (torch.float32, torch.bfloat16):
        Xr = A3[:1, :, :1_000].contiguous().to(dt)[:, None]
        sfx = "" if dt == torch.float32 else "_bf16"
        _, _, mm, nx = Xr.shape
        got, want = gram.gram(Xr), ref.gram_ref(Xr)
        Xd = Xr.double()
        kernel_row(f"gram{sfx}", f"gram A_ij^T A_ij {tuple(Xr.shape)} "
                                 f"{str(dt)[6:]} (a sharded rank's set-up)",
                   lambda Xr=Xr: gram.gram(Xr), lambda Xr=Xr:
                       ref.gram_ref(Xr),
                   (lambda Xr=Xr: torch.matmul(Xr.mT, Xr)) if not sfx
                   else (lambda Xd=Xd: torch.matmul(Xd.mT, Xd)),
                   (got, want, float(ref.gram_ref(Xr.float().abs()).max())
                    if not sfx else None),
                   Xr.element_size() * Xr.numel() + 4 * nx * nx,
                   nx * (nx + 1) * mm,
                   peak=PEAK_F32_FLOPS if not sfx else PEAK_F64_TC_FLOPS,
                   tol=None if not sfx else (2.0 ** -23, 0.0))
        del Xr, Xd, got, want
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
    # then ragged S, GQA groups 1, 3 and 8, Dh 64, non-causal, Sq != Sk;
    # then the zamba2-2.7b prefill's (4 prompts x 32 heads over 32 KV
    # heads, S = 2,048, Dh = 80; the row FLASH_DH80) in bf16 and f32, Dh 80
    # ragged and non-causal, and the other head dims between multiples of
    # 64 (48, 96, 112) ragged
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, Hq, Hkv, Sq, Sk, Dh, causal, dt in (
            (4, 32, 8, 2048, 2048, 128, True, torch.bfloat16),
            (4, 32, 8, 2048, 2048, 128, True, torch.float32),
            (1, 32, 32, 1000, 1000, 128, True, torch.bfloat16),
            (1, 24, 8, 1000, 1000, 128, True, torch.bfloat16),
            (2, 32, 4, 1000, 1000, 64, True, torch.bfloat16),
            (1, 32, 8, 512, 1024, 128, False, torch.bfloat16),
            (1, 32, 8, 300, 2048, 128, True, torch.float32),
            (4, 32, 32, 2048, 2048, 80, True, torch.bfloat16),
            (4, 32, 32, 2048, 2048, 80, True, torch.float32),
            (1, 32, 32, 1000, 1000, 80, True, torch.bfloat16),
            (1, 32, 8, 512, 1024, 80, False, torch.bfloat16),
            (1, 8, 8, 333, 333, 48, True, torch.bfloat16),
            (1, 8, 2, 333, 333, 96, True, torch.bfloat16),
            (1, 8, 8, 333, 333, 112, True, torch.float32)):
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
            FLASH_DH80 if Dh == 80 else "flash_attention",
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
    # chunk, and the sharded engine's: a rank's shard of d = nb K = 1,000
    # entries (one CTA) against a first round. Counts exactly, sums at
    # rtol / atol x sum |z|.
    azb = zb.abs()
    azr = torch.randn(1_000, device=dev, generator=g).abs()
    B = bisect_proj.RUNGS
    ar = torch.arange(1, B + 1, dtype=torch.float32, device=dev)
    lo = torch.zeros((), device=dev)
    for az, th in ((azb, lo + (azb.max() - lo) * ar / B),
                   (torch.rand(10_001, device=dev, generator=g),
                    torch.sort(torch.rand(7, device=dev,
                                          generator=g)).values),
                   (azr, lo + (azr.max() - lo) * ar / B)):
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
    del azb, azr, az, th, got, want
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
    wood_res = est.result_

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

    # 4c. fp64_polish, recovery and the streams (this slice's phases)
    slice_launches = slice_phases(
        torch, api, ops, report, dev, kernel_row, fit_phase, A,
        torch.as_tensor(bs_w, device=dev), xt_w, wide.kappa, wood_res)
    torch.cuda.empty_cache()

    # 5. the dense regime ---------------------------------------------------
    dense_res = fit_phase("dense", As_n, bs_n, xt_n, narrow.kappa, "dense",
                          (*PROJ_KERNELS, "gram", "rmatvec")).result_
    fit_phase("dense_fp16", torch.as_tensor(As_n, device=dev).to(
                  torch.float16),
              torch.as_tensor(bs_n, device=dev).to(torch.float16), xt_n,
              narrow.kappa, "dense", (*PROJ_KERNELS, "gram", "rmatvec"),
              est=api.SparseLinearRegression(
                  kappa=narrow.kappa, gamma=10.0, rho_c=4.0, max_iter=60,
                  tol=0.0, precision="fp16"),
              needed_types=("gram_f16", "rmatvec_f16"))

    # 5b. the hyperparameter path at the woodbury point -------------------
    t0 = time.perf_counter()
    bw = torch.as_tensor(bs_w, device=dev)
    kaps = path_mod.kappa_ladder(wide.n_features, 8, hi_frac=0.25)
    path_est = api.SparseLinearRegression(kappa=wide.kappa, gamma=10.0,
                                          rho_c=4.0, max_iter=PATH_ITERS)
    path_runs, paths = {}, {}
    for run in ("warm", "cold", "grid"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        setup_s = None
        if run == "warm":     # the set-up, timed on its own, counted here
            path_est._adapter.solver._setup(A, bw)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_run
            t_run = time.perf_counter()
        if run == "grid":
            p = path_est.fit_grid(A, bw, kaps)
        else:
            p = path_est.fit_path(A, bw, kaps, warm_start=run == "warm")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        counts = ops.launch_counts()
        points = check_path(torch, f"path {run}", p, kaps)
        iters = sum(pt["iters"] for pt in points)
        if run == "grid":    # every point a lane: one launch a step for all
            trips = max(pt["iters"] for pt in points)
            require(counts["skappa_support_lanes"] == trips
                    and counts["l1_epigraph_proj_lanes"] == 121 * trips
                    and not any(counts[k] for k in PROJ_KERNELS),
                    f"path grid: {counts} in {trips} outer iterations of "
                    "the lanes")
        else:
            require(counts["skappa_support"] == iters,
                    f"path {run}: {counts['skappa_support']} skappa_support "
                    f"launches in {iters} outer iterations")
        require(counts["ladder_stats"] == 0,
                f"path {run}: {counts['ladder_stats']} ladder_stats launches")
        needed = (MAIN_KERNELS if run == "warm" else
                  (*LANE_KERNELS, "matvec", "rmatvec", "normal_matvec")
                  if run == "grid" else
                  (*PROJ_KERNELS, "matvec", "rmatvec", "normal_matvec"))
        for k_name in needed:
            require(counts[k_name] > 0, f"path {run}: kernel {k_name} was "
                                        "not launched")
        require(path_est.n_iter_ == points[-1]["iters"],
                f"path {run}: the estimator is not fitted on the last point")
        path_runs[run] = {"points": points, "iters": iters, "wall_s": wall,
                          "s_per_outer_iter": wall / max(iters, 1),
                          "setup_s": setup_s, "launches": counts,
                          "strategy": p.strategy}
        paths[run] = p
        print(f"  path {run} ({p.strategy}): {iters} outer iterations, "
              f"{wall:.3f} s ({wall / max(iters, 1) * 1e3:.2f} ms/outer "
              f"iter)" + (f", set-up {setup_s:.3f} s" if setup_s else "")
              + f"; launches { {k: v for k, v in counts.items() if v} }; "
              + points_text(points), flush=True)
    # fit_grid runs the points on lanes (shared factors, the K = 8 form of
    # the products). No point converges in PATH_ITERS, and a support
    # there is the nonzeros of an unconverged z (kappa >= 667), which the
    # products' other summation order moves by single near-zero entries:
    # each point keeps the cold scan's status and iterations, z within
    # Z_RTOL and supports that differ only at near-ties; path_converge
    # holds the grid to the cold scan's band where every point converges
    grid_vs_cold = [unconverged_diffs(torch, f"path grid point {i}",
                                      path_point(paths["grid"], i),
                                      path_point(paths["cold"], i),
                                      "the cold scan", kaps[i])
                    for i in range(len(kaps))]
    report["path"] = dict(path_runs, kappas=kaps, grid_vs_cold=grid_vs_cold)
    phase("path", t0, f"N={N} m={m} n={n} gamma=10 rho_c=4, kappas "
                      f"{kaps}: warm {path_runs['warm']['iters']} outer "
                      f"iterations in {path_runs['warm']['wall_s']:.3f} s, "
                      f"cold {path_runs['cold']['iters']} in "
                      f"{path_runs['cold']['wall_s']:.3f} s (every point "
                      f"stops at max_iter {PATH_ITERS}: path_converge "
                      "measures the "
                      f"warm start's saving), grid (the points on lanes) "
                      f"{path_runs['grid']['iters']} in "
                      f"{path_runs['grid']['wall_s']:.3f} s, against the "
                      f"cold scan: supports differ in at most "
                      f"{max(d['support_differs_in'] for d in grid_vs_cold)}"
                      f" entries, coef by "
                      f"{max(d['coef_max_abs_diff'] for d in grid_vs_cold):.2e}"
                      f", z by "
                      f"{max(d['z_max_abs_diff'] for d in grid_vs_cold):.2e}"
                      f" (limit, Z_RTOL x max |z|: at least "
                      f"{min(d['z_limit'] for d in grid_vs_cold):.2e}), "
                      f"support flips at most "
                      f"{max(d['flip_distance_from_threshold'] for d in grid_vs_cold):.2e}"
                      f" from the threshold")
    del paths, path_est

    # 5c. a gamma grid on the spectral Woodbury factors ---------------------
    t0 = time.perf_counter()
    gammas = (1.0, 3.16, 10.0, 31.6)
    g_est = api.SparseLinearRegression(kappa=wide.kappa, gamma=10.0,
                                       rho_c=4.0, max_iter=60, tol=0.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_s = time.perf_counter()
    factors = g_est._adapter.solver._setup(A, bw, dynamic_penalties=True)[0]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_s
    require(type(factors).__name__ == "WoodburyEighFactors",
            f"path_gamma: set-up took {type(factors).__name__}")
    t_s = time.perf_counter()
    gp = g_est.fit_grid(A, bw, [wide.kappa] * len(gammas), gammas=gammas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_s
    counts = ops.launch_counts()
    points = check_path(torch, "path_gamma", gp, [wide.kappa] * len(gammas))
    iters = sum(pt["iters"] for pt in points)
    require(counts["gram"] == 1, f"path_gamma: {counts['gram']} gram "
                                 "launches, expected one for the set-up")
    for k_name in (*LANE_KERNELS, "matvec", "rmatvec", "normal_matvec"):
        require(counts[k_name] > 0, f"path_gamma: kernel {k_name} was not "
                                    "launched")
    at10 = gammas.index(10.0)
    # the grid's points are lanes (K = 4 products on the spectral
    # factors): at tol 0 nothing converges, and the top-kappa support of an
    # unconverged z moves with the summation order (near-ties only); z is
    # held to Z_RTOL; path_converge holds a spectral grid to its cold
    # scan's band where the points converge
    band = unconverged_diffs(torch, "path_gamma (gamma=10)",
                             path_point(gp, at10), wood_res,
                             "the woodbury phase's static fit", wide.kappa)
    static_ms = report["woodbury"]["s_per_outer_iter"] * 1e3
    report["path_gamma"] = {
        "points": points, "setup_s": setup_s, "wall_s": wall,
        "s_per_outer_iter": wall / max(iters, 1),
        "static_setup_s": report["woodbury"]["setup_s"],
        "static_s_per_outer_iter": static_ms / 1e3, "launches": counts,
        "launches_per_outer_iter": {k: v / max(iters, 1)
                                    for k, v in counts.items()},
        "gamma10_against_static": band}
    phase("path_gamma", t0, f"kappa={wide.kappa}, gammas {gammas} via "
                            f"spectral woodbury: set-up {setup_s:.3f} s "
                            f"(static {report['woodbury']['setup_s']:.3f} "
                            f"s), {wall / max(iters, 1) * 1e3:.2f} ms/outer "
                            f"iter (static {static_ms:.2f}), launches "
                            f"{ {k: v for k, v in counts.items() if v} }; "
                            f"gamma=10 against the static fit: "
                            f"{band['iters']} vs {band['iters_ref']} iters "
                            f"(tol 0: both max_iter), support differs in "
                            f"{band['support_differs_in']} entries, coef max "
                            f"abs diff "
                            f"{band['coef_max_abs_diff']:.2e}, z before the "
                            f"polish {band['z_max_abs_diff']:.2e} (limit "
                            f"{band['z_limit']:.2e}), flips "
                            f"{band['flip_distance_from_threshold']:.2e} "
                            f"from the threshold; "
                            + points_text(points))
    del gp, g_est, factors

    # 5d. a gamma grid on the spectral dense factors ------------------------
    t0 = time.perf_counter()
    gammas_d = (3.16, 10.0, 31.6)
    bn = torch.as_tensor(bs_n, device=dev)
    d_est = api.SparseLinearRegression(kappa=narrow.kappa, gamma=10.0,
                                       rho_c=4.0, max_iter=60, tol=0.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_s = time.perf_counter()
    dp = d_est.fit_grid(An, bn, [narrow.kappa] * 3, gammas=gammas_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_s
    counts = ops.launch_counts()
    points = check_path(torch, "path_dense", dp, [narrow.kappa] * 3)
    iters = sum(pt["iters"] for pt in points)
    require(type(d_est._adapter.solver._setup(
        An, bn, dynamic_penalties=True)[0]).__name__ == "EighRidgeFactors",
        "path_dense: the set-up did not take ridge_setup_eigh")
    # one gram for the eigh set-up, one for each point's dense polish
    require(counts["gram"] == 1 + len(gammas_d),
            f"path_dense: {counts['gram']} gram launches, expected "
            f"{1 + len(gammas_d)}")
    band_d = unconverged_diffs(torch, "path_dense (gamma=10)",
                               path_point(dp, 1), dense_res,
                               "the dense phase's fit", narrow.kappa)
    report["path_dense"] = {"points": points, "wall_s": wall,
                            "s_per_outer_iter": wall / max(iters, 1),
                            "launches": counts,
                            "gamma10_against_static": band_d}
    phase("path_dense", t0, f"N={N} m={m} n={narrow.n_features} "
                            f"kappa={narrow.kappa}, gammas {gammas_d} via "
                            f"ridge_setup_eigh: "
                            f"{wall / max(iters, 1) * 1e3:.2f} ms/outer "
                            f"iter, launches "
                            f"{ {k: v for k, v in counts.items() if v} }; "
                            f"gamma=10 against the dense fit: "
                            f"{band_d['iters']} vs {band_d['iters_ref']} "
                            f"iters (tol 0: both max_iter), support differs "
                            f"in {band_d['support_differs_in']} entries, "
                            f"coef max abs "
                            f"diff {band_d['coef_max_abs_diff']:.2e}, z "
                            f"before the polish "
                            f"{band_d['z_max_abs_diff']:.2e} (limit "
                            f"{band_d['z_limit']:.2e}), flips "
                            f"{band_d['flip_distance_from_threshold']:.2e} "
                            f"from the threshold; "
                            + points_text(points))
    del dp, d_est, bw, bn

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

    # 8. the card against the port's own CPU fit (its CPU side computed by
    # the worker started after the build) ----------------------------------
    try:
        parity_phases(torch, api, ops, report, cpu_recv, cpu_proc)
    finally:
        stop_worker()

    # 11. the fleet driver (before the LM phases, which take 16 GB)
    fleet_counts = fleet_phases(torch, api, ops, report, dev)
    torch.cuda.empty_cache()

    # 12. the sharded engine: Fig. 3's point cut to N = 2 nodes (seed 0) on
    # a (2, 4) grid of ranks, and one of its nodes on a (1, 1) NCCL grid
    t0 = time.perf_counter()
    As_s, bs_s, _ = make_sparse_regression(0, SyntheticSpec(
        2, 25_000, 4_000, sparsity_level=0.8))
    A_s = torch.as_tensor(As_s, device=dev)
    b_s = torch.as_tensor(bs_s, device=dev)
    del As_s
    phase("sharded_data", t0, f"As {tuple(A_s.shape)} f32 on the card")
    sharded_phases(torch, api, ops, report, A_s, b_s)
    sharded_cg_phase(torch, api, ops, report, A_s[:1], b_s[:1])
    del A_s, b_s
    torch.cuda.empty_cache()

    # 9. the dense LM's serving path; 10. its parity checks
    lm_counts = serve_phase(torch, dev, report, "qwen3-8b", "lm")
    lm_parity_phase(torch, dev, report)
    # 13. the hybrid LM's serving path; 14. its parity checks
    zamba2_counts = serve_phase(torch, dev, report, "zamba2-2.7b", "zamba2")
    zamba2_parity_phase(torch, dev, report)

    # launches: each kernel's count from the full-width path that runs it
    # (the Fig. 2 Woodbury fit, the Fig. 3 feature-split fit, the Fig. 3
    # PCG fit, the qwen3-8b prefill and decode (and at head dim 80 the
    # zamba2-2.7b prefill and decode), the projections past the
    # one-launch limit, the lane projections' from fleet_sq); the bf16 instantiations' from woodbury_bf16 and
    # pcg_bf16, the fp16 ones' from dense_fp16 and the fp16 parity fits
    # (no full-width fp16 cell runs matvec or normal_matvec)
    half_counts = {
        "gram_bf16": "woodbury_bf16", "matvec_bf16": "woodbury_bf16",
        "rmatvec_bf16": "woodbury_bf16", "normal_matvec_bf16": "pcg_bf16",
        "gram_f16": "dense_fp16", "rmatvec_f16": "dense_fp16",
        "matvec_f16": "parity_woodbury_fp16",
        "normal_matvec_f16": "parity_pcg_fp16",
        # the sharded grid's bf16 fit, every rank's launches; the (1, 1)
        # grid's fp16 fit
        "block_matvec_bf16": "sharded_bf16",
        "block_rmatvec_bf16": "sharded_bf16",
        "block_matvec_f16": "sharded_fp16",
        "block_rmatvec_f16": "sharded_fp16"}
    kernels = []
    for name in (*ops.KERNELS, FLASH_DH80, *HALF_KERNELS, *POLISH_KERNELS):
        row = dict(rows[name])
        for key in ("shape", "call_ms", "yardsticks_ms"):
            row.pop(key)
        if name in half_counts:
            row["launches"] = report[half_counts[name]][
                "launches_by_type"].get(name, 0)
            row["launches_in"] = half_counts[name]
            require(row["launches"] > 0, f"{name}: no launch in "
                                         f"{half_counts[name]}")
        elif name in slice_launches:
            row["launches"] = slice_launches[name]
        else:
            counts = (lm_counts if name == "flash_attention" else
                      {name: zamba2_counts["flash_attention"]}
                      if name == FLASH_DH80 else
                      fleet_counts if name in LANE_KERNELS else
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
