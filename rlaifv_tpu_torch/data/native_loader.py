"""ctypes bindings + build for the native JPEG decode/pad loader.

Counterpart of rlaifv_tpu/data/native_loader.py, function for function.
The C++ source (rlaifv_tpu_torch/native/image_loader.cpp, a byte-for-byte
copy of the JAX package's) compiles on first use with g++ -O3 -shared
against the system libjpeg; if the toolchain or library is missing the
loader falls back to the PIL host path, keeping every environment
functional (`native_available()` says which one runs).

Two differences. The library goes to `build/rlaifv_tpu_torch/` at the
repository root (as ops/_build.py places the CUDA kernels), named by a
hash of the source and flags, never next to the source. And a library
that exists but does not load (built on a machine with libjpeg, run on
one without) means the PIL path too, where the JAX loader raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "image_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rlaifv_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-pthread"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libimage_loader_{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    so = library_path()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        # a library built elsewhere may miss this machine's libjpeg: OSError
        return ctypes.CDLL(str(so))
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print(f"[native_loader] build or load failed ({e}; "
              f"{detail.decode(errors='replace').strip()[:300]}); PIL fallback", flush=True)
        _build_failed = True
        return None
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
            if _lib is not None:
                u8p = ctypes.POINTER(ctypes.c_uint8)
                _lib.rlaifv_decode_pad_batch.argtypes = [
                    ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                    ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int), u8p, ctypes.c_int]
                _lib.rlaifv_decode_pad_batch.restype = ctypes.c_int
                _lib.rlaifv_jpeg_dims.argtypes = [
                    u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)]
                _lib.rlaifv_jpeg_dims.restype = ctypes.c_int
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    if lib.rlaifv_jpeg_dims(buf, len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


class NativeImageLoader:
    """Batch JPEG decode + expand2square pad on a C++ thread pool.

    __call__(jpeg_bytes_list) -> list of (side, side, 3) uint8 arrays,
    mean-background padded (ClipImageProcessor.background semantics).
    """

    def __init__(self, background: Sequence[int] = (122, 116, 104),
                 num_threads: Optional[int] = None):
        self.background = np.asarray(background, np.uint8)
        self.num_threads = num_threads or min(16, os.cpu_count() or 4)

    def _fallback(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        from rlaifv_tpu_torch.data.image_processing import decode_image

        out = []
        bg = self.background
        for blob in blobs:
            arr = np.asarray(decode_image(blob), np.uint8)
            h, w, _ = arr.shape
            side = max(h, w)
            canvas = np.empty((side, side, 3), np.uint8)
            canvas[:] = bg
            top, left = (side - h) // 2, (side - w) // 2
            canvas[top : top + h, left : left + w] = arr
            out.append(canvas)
        return out

    def __call__(self, blobs: Sequence[bytes]) -> List[np.ndarray]:
        lib = get_lib()
        if lib is None:
            return self._fallback(blobs)

        n = len(blobs)
        dims = []
        for blob in blobs:
            d = jpeg_dims(blob)
            if d is None:
                return self._fallback(blobs)  # non-JPEG in the batch
            dims.append(d)

        sides = [max(w, h) for w, h in dims]
        outs = [np.empty((s, s, 3), np.uint8) for s in sides]

        data_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
        for i, blob in enumerate(blobs):
            # zero-copy: point straight at the bytes object's buffer (the
            # caller's list keeps the blobs alive across the call)
            data_ptrs[i] = ctypes.cast(
                ctypes.c_char_p(blob), ctypes.POINTER(ctypes.c_uint8)
            )
        size_arr = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        out_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
            *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for o in outs]
        )
        side_arr = (ctypes.c_int * n)(*sides)
        bg = (ctypes.c_uint8 * 3)(*self.background.tolist())

        failures = lib.rlaifv_decode_pad_batch(
            data_ptrs, size_arr, n, out_ptrs, side_arr, bg, self.num_threads
        )
        if failures:
            return self._fallback(blobs)
        return outs
