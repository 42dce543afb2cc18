# A copy of rlaifv_tpu/data/image_processing.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Host-side image preprocessing (decode -> pad -> resize -> normalize).

Port of the reference LLaVA image path (ref: llava/mm_utils.py:152-182
`expand2square` + `process_images` with image_aspect_ratio='pad'; CLIP
processor does bicubic resize + OPENAI_CLIP normalize). PIL provides the
bit-faithful bicubic taps; the fused Pallas device kernel
(rlaifv_tpu/ops/image_kernels.py) is the fast path behind the same
interface and is parity-tested against this implementation.

Output convention: float32 NHWC (TPU-friendly), not torch NCHW.
"""
from __future__ import annotations

import dataclasses
import io
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from rlaifv_tpu_torch.constants import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def decode_image(data) -> "PIL.Image.Image":
    from PIL import Image

    if isinstance(data, Image.Image):
        return data.convert("RGB")
    if isinstance(data, (bytes, bytearray)):
        return Image.open(io.BytesIO(data)).convert("RGB")
    if isinstance(data, str):
        # eval/gen jsonl rows carry either a path or a b64 payload in the
        # same field (ref muffin/eval/muffin_vqa.py:31-114 handles both)
        if os.path.exists(data):
            return Image.open(data).convert("RGB")
        import base64

        return Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    if isinstance(data, np.ndarray):
        return Image.fromarray(data.astype(np.uint8)).convert("RGB")
    if isinstance(data, dict) and "bytes" in data:
        # HF datasets image column with decode=False: {'bytes':..., 'path':...}
        return Image.open(io.BytesIO(data["bytes"])).convert("RGB")
    raise TypeError(f"cannot decode image from {type(data)}")


def expand2square_pil(img, background_color: Tuple[int, int, int]):
    """Pad to square with mean fill, image centered on the long axis
    (ref mm_utils.py:152-163)."""
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), background_color)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


@dataclasses.dataclass
class ClipImageProcessor:
    """expand2square-pad -> bicubic resize -> rescale+normalize.

    Matches HF CLIPImageProcessor semantics for the 'pad' aspect-ratio mode
    used by LLaVA-1.5 training and chat (mm_utils.py:166-173).
    """

    image_size: int = 336
    mean: Sequence[float] = OPENAI_CLIP_MEAN
    std: Sequence[float] = OPENAI_CLIP_STD
    aspect_ratio: str = "pad"  # "pad" | "square" (plain resize)

    @property
    def background_color(self) -> Tuple[int, int, int]:
        return tuple(int(x * 255) for x in self.mean)

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        img = decode_image(image)
        if self.aspect_ratio == "pad":
            img = expand2square_pil(img, self.background_color)
        img = img.resize(
            (self.image_size, self.image_size), Image.Resampling.BICUBIC
        )
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32
        )
        return arr  # (H, W, 3) float32

    def batch(self, images) -> np.ndarray:
        return np.stack([self(im) for im in images])

    def resize_uint8(self, image) -> np.ndarray:
        """Pad+resize only, normalization deferred to the device
        (models.llava.encode_images' uint8 path) — ships half the bytes of
        bf16 over the host->device link and skips the host float pass."""
        from PIL import Image

        img = decode_image(image)
        if self.aspect_ratio == "pad":
            img = expand2square_pil(img, self.background_color)
        img = img.resize(
            (self.image_size, self.image_size), Image.Resampling.BICUBIC
        )
        return np.asarray(img, dtype=np.uint8)  # (H, W, 3)


def select_best_resolution(original_size, possible_resolutions):
    """anyres grid selection (ref mm_utils.py:12-40): maximize effective
    resolution, tie-break on minimal waste."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, math.inf
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def divide_to_patches(img, patch_size: int) -> List:
    """Row-major crop grid (ref mm_utils.py:77-96)."""
    patches = []
    w, h = img.size
    for top in range(0, h, patch_size):
        for left in range(0, w, patch_size):
            patches.append(img.crop((left, top, left + patch_size, top + patch_size)))
    return patches


def resize_and_pad(img, target: Tuple[int, int]):
    """Aspect-preserving resize, centered zero-pad (ref mm_utils.py:43-74)."""
    from PIL import Image

    ow, oh = img.size
    tw, th = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nw, nh = min(math.ceil(ow * scale_h), tw), th
    resized = img.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def process_anyres_image(image, processor: ClipImageProcessor, grid_pinpoints):
    """anyres: base resize + grid patches (ref mm_utils.py:119-145)."""
    return process_anyres_image_full(image, processor, grid_pinpoints)[0]


def process_anyres_image_full(
    image, processor: ClipImageProcessor, grid_pinpoints
):
    """anyres views plus the geometry the feature merge needs:
    -> (views (1+nw*nh, S, S, 3), grid_shape (nw, nh), original_size (w, h)).
    """
    import ast

    res = grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(
        grid_pinpoints
    )
    img = decode_image(image)
    best = select_best_resolution(img.size, res)
    padded = resize_and_pad(img, best)
    patches = divide_to_patches(padded, processor.image_size)
    base = img.resize((processor.image_size, processor.image_size))
    plain = dataclasses.replace(processor, aspect_ratio="square")
    views = np.stack([plain(p) for p in [base] + patches])
    grid_shape = (best[0] // processor.image_size,
                  best[1] // processor.image_size)
    return views, grid_shape, img.size
