"""Build the CUDA sources with nvcc and load them through ctypes.

Each of ``parlayann_tpu_torch/csrc/*.cu`` compiles in its own nvcc process,
all started together, and one more nvcc call links the objects into one
shared library with a plain C interface (no PyTorch headers). The library
lands in ``parlayann_tpu_torch/_build/`` under a name keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
is reused. Nothing is built or loaded until a wrapper first launches a
kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# the loaded library, the compiler's report and the build seconds: one per
# process, like the library mapping itself
_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for p in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libparlayann_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log = []
    try:
        for src, proc in zip(sources, procs):
            text = proc.communicate()[0]
            log.append(f"nvcc {src.name}: done by {time.perf_counter() - t0:.2f} s\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{text}")
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    _loaded["log"] = "".join(log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    with _lock:
        if "lib" not in _loaded:
            t0 = time.perf_counter()
            path = build()
            lib = ctypes.CDLL(str(path))
            lib.pa_error_string.argtypes = [ctypes.c_int]
            lib.pa_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
            _loaded["seconds"] = time.perf_counter() - t0
        return _loaded["lib"]


def build_report() -> tuple[float, str]:
    """(seconds the first build-and-load took, nvcc's -Xptxas -v report;
    empty when the library was already on disk)."""
    library()
    return _loaded["seconds"], _loaded.get("log", "")


def function(name: str, argtypes: list):
    """A C entry point with its argument types declared; returns int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().pa_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel (all tensors on one CUDA device), False for
    the plain version (all on the CPU); raise on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


VP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
