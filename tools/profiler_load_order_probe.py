#!/usr/bin/env python3
"""Which ``torch.profiler`` sessions see the port's kernels on the card,
by the order in which the kernel libraries are loaded.

    python3 tools/profiler_load_order_probe.py

Each of three fresh processes profiles one call at a time (a session each)
and prints the device events it saw:

* ``stats_first``: ``ladder_stats`` loaded and profiled, then the
  ``ladder_proj`` library loaded by a projection and profiled, then a
  PyTorch add, the projection again and ``ladder_stats`` again (the order
  of the card tests' two profiled tests, when one runs after the other);
* ``both_loaded``: both libraries loaded and launched before the first
  session;
* ``add_first``: a session of a PyTorch add before any kernel library is
  loaded, then ``ladder_stats``.

Needs a card; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDERS = ("stats_first", "both_loaded", "add_first")


def run(order: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import bilinear
    from repro_torch.kernels import bisect_proj

    def seen(label, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
        print(f"[{order}] {label}: {len(ev)} device events {ev[:3]}",
              flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    az = torch.randn(bisect_proj.MAX_N + 1, device="cuda", generator=g).abs()
    th = torch.rand(128, device="cuda", generator=g)
    z = torch.randn(10_000, device="cuda", generator=g)
    t0 = torch.tensor(5.0, device="cuda")
    x = torch.randn(1_000, device="cuda")

    def stats():
        return bisect_proj.ladder_stats(az, th)

    def proj():
        return bilinear.project_l1_epigraph(z, t0)

    def add():
        return x + 1

    if order == "stats_first":
        stats()
        torch.cuda.synchronize()
        seen("ladder_stats", stats)
        proj()
        torch.cuda.synchronize()
        seen("l1 proj (its library loaded after a session)", proj)
        seen("torch add", add)
        seen("l1 proj again", proj)
        seen("ladder_stats again", stats)
    elif order == "both_loaded":
        stats()
        proj()
        torch.cuda.synchronize()
        seen("ladder_stats", stats)
        seen("l1 proj (its library loaded before any session)", proj)
        seen("torch add", add)
    else:
        seen("torch add", add)
        stats()
        torch.cuda.synchronize()
        seen("ladder_stats (its library loaded after a session)", stats)


def main() -> int:
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    rc = 0
    for order in ORDERS:
        rc |= subprocess.run([sys.executable, __file__, order],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
