"""Build and load the port's CUDA kernels (``pslam_tpu_torch/csrc/*.cu``).

Each kernel file exposes a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library that ``ctypes`` loads; nothing
includes PyTorch's headers, so a build takes seconds. Libraries go to
``build/pslam_tpu_torch/`` at the repository root (git-ignored), keyed by a
hash of the source and the flags, and are built at first use. Each kernel
has its own lock, so different kernels can build at once from several
threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pslam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, or 0.0 when loaded from the cache;
# nvcc's -Xptxas=-v report)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` as a shared library, compiling it if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        key = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}_{key}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
                )
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        BUILD_INFO[name] = (seconds, log_path.read_text() if log_path.exists() else "")
        _libs[name] = lib
        return lib


def bind(name: str, argtypes: dict[str, list]) -> dict[str, ctypes._CFuncPtr]:
    """Load ``csrc/<name>.cu`` and declare its C functions: name -> argtypes
    (``ctypes.c_void_p`` for each pointer and the stream, ``ctypes.c_int``
    for an int); every function returns an int."""
    lib = library(name)
    fns = {}
    for fn_name, types in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def stream_ptr(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda(t, name: str, dtype, shape=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
