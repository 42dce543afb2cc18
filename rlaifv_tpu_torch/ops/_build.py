"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Every `csrc/*.cu` file exports plain C entry points (no PyTorch headers), so
each compiles in seconds: one nvcc per source, all started together, then
one link into a single shared library. The library lands in
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
    # q, k, v, mask, dout, lse, delta, dq, B, H, KVH, Lq, Lk, D,
    # q/k/v/dout strides (b, l, h), causal, q_offset, scale, stream
    "flash_attention_bwd_dq_bf16": [_P] * 8 + [_I] * 6 + [_I] * 12
    + [_I, _I, _F, _P],
    # as above with dk, dv in place of dq
    "flash_attention_bwd_dkv_bf16": [_P] * 9 + [_I] * 6 + [_I] * 12
    + [_I, _I, _F, _P],
    # q, k, v, mask, out, part, B, H, KVH, L, D, valid_len, splits,
    # q stride b, q stride h, scale, stream
    "decode_attention_prefix_bf16": [_P] * 6 + [_I] * 9 + [_F, _P],
    # q, k, v, mask, out, part, B, H, KVH, L, D, q stride b, q stride h,
    # is_bf16, splits, scale, stream
    "decode_attention_full_cuda": [_P] * 6 + [_I] * 9 + [_F, _P],
    # q, k, k_scale, v, v_scale, mask, out, part, B, H, KVH, L, D, valid_len,
    # block_l, splits, q stride b, q stride h, scale, stream
    "decode_attention_prefix_int8_bf16": [_P] * 8 + [_I] * 10 + [_F, _P],
    # x, w, y, part, logp, lse, M, H, V, nsplit, stream
    "fused_head_fwd_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # x, w, y, lse, g, dl, M, H, V, c0, vw, ldl, stream
    "fused_head_dl_bf16": [_P] * 6 + [_I] * 6 + [_P],
    # dl, w, dx32, dx, M, H, V, c0, vw, ldl, mode, stream
    "fused_head_dx_bf16": [_P] * 4 + [_I] * 7 + [_P],
    # dl, x, dw (the chunk's first row), M, H, vw, ldl, stream
    "fused_head_dw_bf16": [_P] * 3 + [_I] * 4 + [_P],
    # x, q, s, xq, sx, part, cnt, out, M, K, N, route, rows, split, stream
    "int8_matmul_bf16": [_P] * 8 + [_I] * 6 + [_P],
    # dy, q, s, dyq, sy, part, dx, M, K, N, split, stream
    "int8_matmul_dx_bf16": [_P] * 7 + [_I] * 4 + [_P],
    # xq, sx, q, s, out, M, K, N, route, stream
    "int8_matmul_prequant_bf16": [_P] * 5 + [_I] * 4 + [_P],
    # x, s (or null), xq, sx, M, K, stream
    "int8_quant_rows_bf16": [_P] * 4 + [_I] * 2 + [_P],
    # dyq, sy, q, part, dx, M, K, N, route, split, stream
    "int8_matmul_dx_prequant_bf16": [_P] * 5 + [_I] * 5 + [_P],
    # xq, sx, qp, gs, out, M, K, N, G, stream
    "int4_matmul_bf16": [_P] * 5 + [_I] * 4 + [_P],
    # dy, qp, gs, amax, dx, M, K, N, G, stream
    "int4_matmul_dx_bf16": [_P] * 5 + [_I] * 4 + [_P],
    # int64 array of pointers and ints (ops/fused_decode.py), its length,
    # eps, scale, w4, stream
    "fused_decode_step_cuda": [_P, _I, _F, _F, _I, _P],
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


def _run(cmds: list) -> str:
    """Run the commands at once; raise with the output of a failed one."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(logs)


def compile_and_link(path: Path, sources: list, include: Optional[Path] = None) -> str:
    """One nvcc per source, all started together, then one link into
    `path` (written under a temporary name and renamed). The objects and
    the temporary file are removed whether or not the build succeeds."""
    tag = f"{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if include is not None:
        compile_flags += ["-I", str(include)]
    objs = [path.parent / f"{src.stem}.{tag}.o" for src in sources]
    tmp = path.with_suffix(f".{tag}")
    try:
        log = _run([[_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)])
        log += _run([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


def open_library(path: Path) -> ctypes.CDLL:
    """Load a kernel library and declare the C signatures of the entry
    points it exports."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.rlaifv_error_string.argtypes = [ctypes.c_int]
    lib.rlaifv_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = compile_and_link(path, _sources())
            build_seconds = time.perf_counter() - t0
        _lib = open_library(path)
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if err != 0:
        msg = load_kernels().rlaifv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError {err} ({msg})")
