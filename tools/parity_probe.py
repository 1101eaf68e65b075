#!/usr/bin/env python3
"""How far the card-vs-CPU parity fits of the reduced-precision presets move
with the order of the products' sums.

    python3 tools/parity_probe.py [--report PATH]

For each reduced-precision parity fit of ``chip_smoke.parity_fits()`` (the
Woodbury parity data, seed 1: bf16 through Woodbury, fp16 through PCG and
through Woodbury) and the f32 Woodbury one, the fit runs on the card and on
the CPU with the products as built, then with the registry rows of both
devices rebound to other, equally valid sums of the same products (PyTorch
ops, never the port's path):

* ``built``    — the port as it is (the half-width Gram summed in f64);
* ``gram_f32`` — the Gram of half-width data summed in f32;
* ``gemv_f64`` — also matvec, rmatvec and normal_matvec summed in f64.

It prints the stopping iteration of each fit on each device: the parity
band (iterations within 2) holds for a variant when the two differ by 2 or
less. Needs a card; imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

VARIANTS = ("built", "gram_f32", "gemv_f64")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the results to PATH as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import runtime
    from repro_torch.kernels import ops, ref

    f32, f64 = torch.float32, torch.float64

    def mv(a, x):
        x2, one = ref._vec_as_mat(a, x)
        out = (a.to(f64) @ x2.to(f64)).to(f32)
        return out[..., 0] if one else out

    def rmv(a, y):
        y2, one = ref._vec_as_mat(a, y)
        out = (a.to(f64).mT @ y2.to(f64)).to(f32)
        return out[..., 0] if one else out

    def nmv(a, p, shift):
        pd = p.to(f64)
        s = (shift if isinstance(shift, float)
             else torch.as_tensor(shift, device=a.device).to(f64))
        return (rmv(a, mv(a, p).to(f64)).to(f64) + s * pd).to(f32)

    built = {(k, d): runtime.kernel(k, d)
             for k in ("gram", "matvec", "rmatvec", "normal_matvec")
             for d in runtime.DEVICE_TYPES}

    def gram_f32(a, out_dtype=None):
        if a.dtype not in runtime.REDUCED:
            return built["gram", a.device.type](a, out_dtype)
        return ops._out(a.to(f32).mT @ a.to(f32), a, a, out_dtype)

    gemv = {"matvec": lambda a, x, out_dtype=None: ops._out(mv(a, x), a, x,
                                                            out_dtype),
            "rmatvec": lambda a, y, out_dtype=None: ops._out(rmv(a, y), a, y,
                                                             out_dtype),
            "normal_matvec": nmv}

    def bind(variant):
        for (k, d), fn in built.items():
            runtime.register_kernel(k, d, fn)
        if variant == "built":
            return
        for d in runtime.DEVICE_TYPES:
            runtime.register_kernel("gram", d, gram_f32)
            if variant == "gemv_f64":
                for k, fn in gemv.items():
                    runtime.register_kernel(k, d, fn)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "fits": {}}
    fits = [f for f in cs.parity_fits()
            if f[0] in ("parity", "parity_woodbury_bf16", "parity_pcg_fp16",
                        "parity_woodbury_fp16")]
    try:
        for key, what, cls, kw, As, bs in fits:
            for variant in VARIANTS:
                bind(variant)
                t0 = time.perf_counter()
                card = cls(**kw).fit(As, bs).result_
                cpu = cls(device="cpu", **kw).fit(As, bs).result_
                it = (int(card.iters), int(cpu.iters))
                report["fits"][f"{key} {variant}"] = {
                    "card": it[0], "cpu": it[1],
                    "in_band": abs(it[0] - it[1]) <= 2}
                print(f"{what} [{variant}]: card {it[0]} iters, CPU {it[1]}"
                      f" ({'in' if abs(it[0] - it[1]) <= 2 else 'out of'} "
                      f"band; {time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        bind("built")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
