"""Build and load the port's CUDA kernels (``cara_tpu_torch/csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file of the package, and nothing else,
into one shared library with a plain C interface,
``build/kernels/libcara_tpu_torch_kernels.so`` under the repository root,
which ``ctypes`` loads.  The build runs at the first kernel call, not at
import, so the package imports on machines without a GPU or ``nvcc``; it
is redone when the sources or the flags change (a hash of both is kept
beside the library).

Pointers and the stream pass as ``ctypes.c_void_p``; every C entry point
returns ``cudaGetLastError()`` and :func:`check` raises on a nonzero code.
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

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
LIB_NAME = "libcara_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C entry points (see the .cu files).
_SIGNATURES = {
    "cara_cp_site": [_P] * 14 + [_I] * 7 + [_F, _F, _P],
    "cara_qkv_attention": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "cara_qkv_attention_smem": [_I, _I],
}

_lock = threading.Lock()
_lib = None
BUILD_INFO = {"seconds": None, "log": "", "cached": None}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the cara_tpu_torch CUDA kernels are built "
            "from source at first use and need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library if it is missing or stale; return its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if (lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        BUILD_INFO.update(seconds=0.0, cached=True)
        return lib_path
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    BUILD_INFO.update(seconds=seconds, log=log, cached=False)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check_no_grad(name: str, *tensors) -> None:
    """Forward-only kernels: refuse inputs autograd would record through,
    so that no caller gets silently wrong (missing) gradients."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its backward kernel is not yet "
            "ported; call it under torch.no_grad() / inference_mode() or "
            "on tensors that do not require grad")


def check_cuda_inputs(name: str, device: torch.device, **tensors) -> None:
    """Kernel-side argument checks: same CUDA device, bf16, contiguous,
    16-byte aligned.  ``None`` entries are skipped."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} must be bfloat16 on CUDA, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
