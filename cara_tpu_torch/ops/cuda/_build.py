"""Build and load the port's CUDA kernels (``cara_tpu_torch/csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file of the package, and nothing else,
one process per file, all started together, and links the objects into
one shared library with a plain C interface,
``build/kernels/libcara_tpu_torch_kernels.so`` under the repository root,
which ``ctypes`` loads.  The build runs at the first kernel call, not at
import, so the package imports on machines without a GPU or ``nvcc``; it
is redone when the sources (``.cu`` and ``.cuh``) or the flags change (a
hash of both is kept beside the library).

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
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_S = ctypes.POINTER(ctypes.c_longlong)  # host array of strides
# name -> argtypes of the C entry points (see the .cu files).
_SIGNATURES = {
    "cara_cp_site": [_P] * 12 + [_I] * 6 + [_F, _P],
    "cara_qkv_attention": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "cara_qkv_attention_smem": [_I, _I],
    "cara_qkv_attention_bwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    "cara_attn_proj": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
    "cara_blockwise_attention": [_P] * 3 + [_I] * 5 + [_F, _P],
    "cara_blockwise_attention_bwd": [_P] * 7 + [_I] * 5 + [_F, _P],
    "cara_flash_attention": [_P] * 5 + [_S] + [_I] * 4 + [_F, _P],
    "cara_flash_attention_bwd": [_P] * 11 + [_S] + [_I] * 4 + [_F, _P],
    "cara_wd_fold": [_I, _S, _F, _U, _P],
    "cara_wd_factor_grads": [_P] * 8 + [_I] * 3 + [_F, _U, _P],
    "cara_rank_z": [_P] * 3 + [_I] * 3 + [_P],
    "cara_grad_gemm": [_I] * 3 + [_P] * 14 + [_I] * 7 + [_P],
    "cara_ln_rows": [_P] * 4 + [_I, _I, _F, _P],
    "cara_gate_rows": [_P] * 3 + [_I, _I, _P],
    "cara_gate_colsum": [_P, _P, _I] + [_P] * 4 + [_I, _I, _P],
    "cara_ln_bwd_residual": [_P] * 5 + [_I, _I, _F, _P],
    "cara_colsum": [_P, _I, _P, _P, _I, _I, _P],
    "cara_int8_dense": [_P] * 6 + [_I] * 6 + [_P],
    "cara_block_pair": [_P] * 21 + [_I] * 9 + [_F] * 3 + [_P],
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
    for src in sorted(CSRC.glob("*.cu*")):
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
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:  # wait for every compiler, failed or not
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd[-1])
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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


def recorded(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record through a forward-only kernel."""
    if recorded(*tensors):
        raise RuntimeError(
            f"{name} is forward only (inference, as in the reference): "
            "call it under torch.no_grad() or torch.inference_mode()")


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
