"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` compiles it into a shared library in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so <name>.cu

The library is built at first use into ``build/repro_torch/`` (git-ignored)
under a name that carries the content hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited source or header is rebuilt and a
stale library is never loaded. Only sources in this package
are built. The library is loaded with ``ctypes``: pointer and stream
arguments are declared ``c_void_p`` (an undeclared Python int would be cut
to 32 bits), and every C entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ladder_stats", "ladder_proj", "gram", "matvec", "normal_matvec",
           "block_matvec", "flash_attention", "chol_update")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# flags of one source beyond the common ones: the projections and the
# Cholesky rotations keep every f32 operation of their plain versions as its
# own rounding (no a*b+c contracted into one FMA)
SOURCE_FLAGS = {"ladder_proj": ("-fmad=false",),
                "chol_update": ("-fmad=false",)}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# Device kernel launches per kernel: a wrapper adds, where it launches, the
# number of CUDA kernels its C entry point issued — the launches
# kernels/block_matvec.py's block_plan gives (a pass of right-hand sides
# each, and a second kernel that adds block_rmatvec's row slices or CTA
# partials), two for rmatvec when a second kernel sums its row slices
# (kernels/matvec.py, plan) and for normal_matvec when a second kernel adds
# its CTAs' partials (normal_plan), one otherwise (ladder_stats,
# flash_attention and the two one-launch projections: one; chol_rank_update
# one a launch of at most chol_update.MAX_K rotations) — and nowhere else
# (read through repro_torch.kernels.ops).
LAUNCHES: collections.Counter = collections.Counter()
# The same launches of the kernels that take several element types of A
# (gram, matvec, rmatvec, normal_matvec), by "<kernel>_<f32|bf16|f16>", and
# of the l1 projections' f64-polish instantiations, by "<kernel>_f64polish".
LAUNCHES_BY_TYPE: collections.Counter = collections.Counter()


def count_launches(name: str, suffix: str, n: int) -> None:
    """Add ``n`` device launches of kernel ``name`` on ``suffix`` data."""
    LAUNCHES[name] += n
    LAUNCHES_BY_TYPE[f"{name}_{suffix}"] += n

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else PATH)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH to build the kernels")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source content, the shared headers' (``csrc/*.cuh``) and flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(SOURCE_FLAGS.get(name, ())).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            *SOURCE_FLAGS.get(name, ()),
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, dict]:
    """Build every library that is missing, one ``nvcc`` per source, all
    started together. Returns ``{name: {"seconds", "cached", "log"}}``
    (``log`` holds ptxas' register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                      "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` declared from ``signatures`` and ``int`` return types."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: kernel operands must lie on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
