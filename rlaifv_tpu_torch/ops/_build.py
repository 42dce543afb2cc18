"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Every `csrc/*.cu` file exports plain C entry points (no PyTorch headers), so
one nvcc call builds them all in seconds. The library lands in
`build/rlaifv_tpu_torch/` at the repository root, named by a hash of the
sources and flags, and is reused while the sources are unchanged.

Nothing here runs at import time: `load_kernels()` builds on the first call
that needs a kernel, which is the first kernel launch on a CUDA tensor.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rlaifv_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points; every one returns a cudaError_t
SIGNATURES = {
    # q, k, v, mask, out, lse, B, H, KVH, Lq, Lk, D,
    # q strides (b, l, h), k strides (b, l, h), v strides (b, l, h),
    # causal, q_offset, scale, stream
    "flash_attention_fwd_bf16": [_P] * 6 + [_I] * 6 + [_I] * 9
    + [_I, _I, _F, _P],
    # q, k, v, mask, out, B, H, KVH, L, D, valid_len, q stride b, q stride h,
    # scale, stream
    "decode_attention_prefix_bf16": [_P] * 5 + [_I] * 8 + [_F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librlaifv_kernels_{h.hexdigest()[:16]}.so"


def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, _sources())]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{build_log}"
                )
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rlaifv_error_string.argtypes = [ctypes.c_int]
        lib.rlaifv_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if err != 0:
        msg = load_kernels().rlaifv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError {err} ({msg})")
