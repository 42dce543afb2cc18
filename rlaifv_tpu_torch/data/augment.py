"""Train-time image augmentation for the OmniLMM pipeline.

A copy of rlaifv_tpu/data/augment.py (numpy and PIL only), code unchanged:
every sampled op is applied, where RLAIF-V applies each with p = 0.5 (a
reference quirk kept; ROADMAP.md section 3).

Rebuild of the reference RandomAugment (ref: omnilmm/model/utils.py:352-418
— cv2-based table of 14 ops, N=2 ops at magnitude 7, gated OFF by default
via TRAIN_DO_AUG, :438). PIL-backed here (cv2-free), same op names and
selection scheme; disabled by default to match the reference gate, now an
explicit config flag instead of an environment variable.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np


def _pil(img):
    from PIL import Image

    if isinstance(img, np.ndarray):
        return Image.fromarray(img.astype(np.uint8))
    return img


def identity(img, level, rng=random):
    return img


def autocontrast(img, level, rng=random):
    from PIL import ImageOps

    return ImageOps.autocontrast(_pil(img))


def equalize(img, level, rng=random):
    from PIL import ImageOps

    return ImageOps.equalize(_pil(img))


def brightness(img, level, rng=random):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(_pil(img)).enhance(1 + level / 10 * 0.9)


def sharpness(img, level, rng=random):
    from PIL import ImageEnhance

    return ImageEnhance.Sharpness(_pil(img)).enhance(1 + level / 10 * 0.9)


def _affine(img, matrix):
    from PIL import Image

    img = _pil(img)
    return img.transform(img.size, Image.Transform.AFFINE, matrix,
                         resample=Image.Resampling.BILINEAR)


def shear_x(img, level, rng=random):
    v = level / 10 * 0.3 * rng.choice([-1, 1])
    return _affine(img, (1, v, 0, 0, 1, 0))


def shear_y(img, level, rng=random):
    v = level / 10 * 0.3 * rng.choice([-1, 1])
    return _affine(img, (1, 0, 0, v, 1, 0))


def translate_x(img, level, rng=random):
    img_p = _pil(img)
    v = level / 10 * 0.3 * img_p.size[0] * rng.choice([-1, 1])
    return _affine(img_p, (1, 0, v, 0, 1, 0))


def translate_y(img, level, rng=random):
    img_p = _pil(img)
    v = level / 10 * 0.3 * img_p.size[1] * rng.choice([-1, 1])
    return _affine(img_p, (1, 0, 0, 0, 1, v))


def rotate(img, level, rng=random):
    deg = level / 10 * 30 * rng.choice([-1, 1])
    return _pil(img).rotate(deg)


AUG_OPS = {
    "Identity": identity,
    "AutoContrast": autocontrast,
    "Equalize": equalize,
    "Brightness": brightness,
    "Sharpness": sharpness,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateX": translate_x,
    "TranslateY": translate_y,
    "Rotate": rotate,
}

# reference default op list (omnilmm/model/utils.py:441-446)
DEFAULT_AUGS = list(AUG_OPS.keys())


class RandomAugment:
    """Apply N randomly chosen ops at magnitude M (ref :394-418)."""

    def __init__(self, n: int = 2, m: int = 7,
                 augs: Optional[Sequence[str]] = None,
                 seed: Optional[int] = None):
        self.n = n
        self.m = m
        self.augs = list(augs or DEFAULT_AUGS)
        self._rng = random.Random(seed)

    def __call__(self, img) -> np.ndarray:
        ops = [self._rng.choice(self.augs) for _ in range(self.n)]
        out = img
        for name in ops:
            out = AUG_OPS[name](out, self.m, self._rng)
        return np.asarray(_pil(out), np.uint8)
