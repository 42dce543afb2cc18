"""Device-side image preprocessing: resize (as matmuls) + normalize.

Counterpart of rlaifv_tpu/ops/image_kernels.py (the `preprocess ms/image`
BASELINE metric) on an explicit torch device:

- bicubic resampling is two small matrix products, out = Wr @ img @ Wc^T,
  with PIL-faithful (dst, src) weight matrices (`_bicubic` and
  `pil_resize_weights` are the JAX package's numpy, copied function for
  function), so outputs match the host path to uint8 rounding;
- mean-pad-to-square runs on the host; the device does the horizontal
  pass, uint8 rounding emulation (round half to even, clip 0..255), the
  vertical pass, rounding again, /255 and (x - mean) / std;
- images group by source size, one batched call per group; the weight
  matrices are cached per (src, dst) on the device.

The products run in true fp32: a TF32 product (10-bit mantissa) moves
pixels across a rounding boundary, so TF32 is switched off for the call's
duration whatever the process-wide setting. As in the JAX package, no
hand-written kernel: these are dense products outside any TPU kernel.
The output is a float32 tensor on the pipeline's device, (B, D, D, 3).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from rlaifv_tpu_torch.constants import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (support 2)."""
    x = np.abs(x)
    out = np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(
            x < 2.0,
            (((x - 5.0) * x + 8.0) * x - 4.0) * a,
            0.0,
        ),
    )
    return out


@functools.lru_cache(maxsize=256)
def pil_resize_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) PIL-faithful bicubic resampling matrix (rows sum to 1)."""
    support = 2.0
    scale = src / dst
    filterscale = max(scale, 1.0)
    supp = support * filterscale
    W = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - supp + 0.5), 0)
        xmax = min(int(center + supp + 0.5), src)
        xs = np.arange(xmin, xmax)
        w = _bicubic((xs + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        W[i, xmin:xmax] = w
    return W


@contextlib.contextmanager
def _fp32_products():
    """True fp32 matmuls (no TF32) for the block, the previous setting
    restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _resize_normalize(img_u8: torch.Tensor, Wr: torch.Tensor, Wc: torch.Tensor,
                      mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """img (B, S, S, 3) uint8 -> (B, D, D, 3) float32 normalized.

    PIL resamples in two passes (horizontal, then vertical) and stores
    uint8 between passes; both roundings are emulated for parity. The
    passes run on planar (B, 3, H, W) pixels, so the horizontal one is a
    single (B 3 H, W) x (W, D) product and the vertical one a batch of
    (D, H) x (H, D) products."""
    x = img_u8.permute(0, 3, 1, 2).contiguous().to(torch.float32)
    with _fp32_products():
        x = torch.matmul(x, Wc.T)  # horizontal: (B, 3, H, W) -> (B, 3, H, D)
        x = torch.round(x).clamp_(0.0, 255.0)
        x = torch.matmul(Wr, x)  # vertical: (B, 3, H, D) -> (B, 3, D, D)
        x = torch.round(x).clamp_(0.0, 255.0)
    # a device divisor: CUDA multiplies by the reciprocal of a host scalar
    x = x / x.new_full((), 255.0)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.permute(0, 2, 3, 1).contiguous()


class DeviceImagePipeline:
    """Batched pad -> resize -> normalize on `device`, one call per source
    size.

    Drop-in device replacement for ClipImageProcessor (same numbers to the
    uint8 rounding); the host keeps JPEG decode + square padding, the device
    does everything dense.
    """

    def __init__(
        self,
        image_size: int = 336,
        mean: Sequence[float] = OPENAI_CLIP_MEAN,
        std: Sequence[float] = OPENAI_CLIP_STD,
        device: Union[str, torch.device] = "cuda",
    ):
        self.image_size = image_size
        self.device = torch.device(device)
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self.background = tuple(
            int(x * 255) for x in np.asarray(mean)
        )
        self._weights: Dict[Tuple[int, int], torch.Tensor] = {}

    def _pad_square_host(self, arr: np.ndarray) -> np.ndarray:
        h, w, _ = arr.shape
        if h == w:
            return arr
        side = max(h, w)
        out = np.empty((side, side, 3), np.uint8)
        out[:] = np.asarray(self.background, np.uint8)
        top = (side - h) // 2
        left = (side - w) // 2
        out[top : top + h, left : left + w] = arr
        return out

    def resize_weights(self, src: int) -> torch.Tensor:
        """The (image_size, src) resampling matrix on the device, cached."""
        key = (src, self.image_size)
        if key not in self._weights:
            self._weights[key] = torch.from_numpy(
                pil_resize_weights(src, self.image_size)).to(self.device)
        return self._weights[key]

    def __call__(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """List of HWC uint8 arrays -> (B, D, D, 3) float32 normalized, on
        the pipeline's device. Same-size groups batch into one call."""
        arrs = [self._pad_square_host(np.asarray(im, np.uint8)) for im in images]

        out = torch.empty((len(arrs), self.image_size, self.image_size, 3),
                          dtype=torch.float32, device=self.device)
        groups: Dict[int, list] = {}
        for idx, arr in enumerate(arrs):
            groups.setdefault(arr.shape[0], []).append(idx)

        for side, idxs in groups.items():
            batch = torch.from_numpy(np.stack([arrs[i] for i in idxs])).to(self.device)
            Wr = self.resize_weights(side)
            res = _resize_normalize(batch, Wr, Wr, self.mean, self.std)
            if len(idxs) == len(arrs):
                out = res
            else:
                out[torch.tensor(idxs, device=self.device)] = res
        return out
