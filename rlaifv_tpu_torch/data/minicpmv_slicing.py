# A copy of rlaifv_tpu/data/minicpmv_slicing.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""MiniCPM-V adaptive image slicing geometry (host side).

The reference drives this through the model's remote code
(ref: minicpm-llama3-v-25/minicpmv_autocheck.py:119-134 — slice_mode loop
calling `get_slice_image_placeholder` / `reshape_by_patch`, per-slice
tgt_sizes). The geometry itself is the public MiniCPM-V scheme: pick a
grid whose aspect ratio best matches the image (log-ratio score), resize
the source to a 448-budget canvas, refine slice sizes to patch multiples.

Host computes geometry + placeholder text; the port's generator
(genai/minicpmv_gen.py) normalises the slices on the host in fp32, as the
JAX generator does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

DEFAULT_SCALE_RESOLUTION = 448
DEFAULT_PATCH_SIZE = 14
DEFAULT_MAX_SLICE_NUMS = 9

IM_START = "<image>"
IM_END = "</image>"
SLICE_START = "<slice>"
SLICE_END = "</slice>"
UNK = "<unk>"


def ensure_divide(length: int, patch_size: int) -> int:
    return max(round(length / patch_size) * patch_size, patch_size)


def find_best_resize(
    original_size: Tuple[int, int],
    scale_resolution: int,
    patch_size: int,
    allow_upscale: bool = False,
) -> Tuple[int, int]:
    """Fit (w, h) into the scale_resolution² budget, patch-aligned."""
    w, h = original_size
    if w * h > scale_resolution * scale_resolution or allow_upscale:
        r = w / h
        h = int(scale_resolution / math.sqrt(r))
        w = int(h * r)
    return ensure_divide(w, patch_size), ensure_divide(h, patch_size)


def get_refine_size(
    original_size: Tuple[int, int],
    grid: Tuple[int, int],
    scale_resolution: int,
    patch_size: int,
    allow_upscale: bool = False,
) -> Tuple[int, int]:
    """Canvas size so each grid cell hits the best per-cell resize."""
    w, h = original_size
    cols, rows = grid
    grid_w, grid_h = w / cols, h / rows
    best_w, best_h = find_best_resize(
        (grid_w, grid_h), scale_resolution, patch_size,
        allow_upscale=allow_upscale,
    )
    return best_w * cols, best_h * rows


def best_grid(
    original_size: Tuple[int, int], multiple: int, max_slice_nums: int
) -> Optional[Tuple[int, int]]:
    """Candidate grids near `multiple` cells; pick min |log r_img - log r_grid|."""
    if multiple <= 1:
        return None
    w, h = original_size
    log_ratio = math.log(w / h)
    candidates = []
    for n in {multiple - 1, multiple, multiple + 1}:
        if n < 1 or n > max_slice_nums:
            continue
        for cols in range(1, n + 1):
            if n % cols == 0:
                candidates.append((cols, n // cols))
    if not candidates:
        return None
    return min(
        candidates,
        key=lambda g: abs(log_ratio - math.log(g[0] / g[1])),
    )


def slice_image_plan(
    original_size: Tuple[int, int],
    max_slice_nums: int = DEFAULT_MAX_SLICE_NUMS,
    scale_resolution: int = DEFAULT_SCALE_RESOLUTION,
    patch_size: int = DEFAULT_PATCH_SIZE,
    never_split: bool = False,
) -> dict:
    """Pure geometry: what to resize and where to cut.

    Returns {source_size, grid, refine_size, cells} where cells are
    (left, top, right, bottom) boxes into the refine canvas.
    """
    w, h = original_size
    ratio = (w * h) / (scale_resolution * scale_resolution)
    multiple = min(math.ceil(ratio), max_slice_nums)

    source_size = find_best_resize(
        original_size, scale_resolution, patch_size,
        allow_upscale=(multiple <= 1),
    )
    grid = None if never_split else best_grid(
        original_size, multiple, max_slice_nums
    )
    plan = {"source_size": source_size, "grid": grid,
            "refine_size": None, "cells": []}
    if grid is None:
        return plan

    refine = get_refine_size(
        original_size, grid, scale_resolution, patch_size, allow_upscale=True
    )
    plan["refine_size"] = refine
    cols, rows = grid
    cw, ch = refine[0] // cols, refine[1] // rows
    for r in range(rows):
        for c in range(cols):
            plan["cells"].append(
                (c * cw, r * ch, (c + 1) * cw, (r + 1) * ch)
            )
    return plan


def slice_image(
    image,
    max_slice_nums: int = DEFAULT_MAX_SLICE_NUMS,
    scale_resolution: int = DEFAULT_SCALE_RESOLUTION,
    patch_size: int = DEFAULT_PATCH_SIZE,
    never_split: bool = False,
):
    """PIL image -> (source_image, patch_list, grid)."""
    from PIL import Image

    plan = slice_image_plan(
        image.size, max_slice_nums, scale_resolution, patch_size, never_split
    )
    source = image.resize(plan["source_size"], Image.Resampling.BICUBIC)
    patches = []
    if plan["grid"] is not None:
        refined = image.resize(plan["refine_size"], Image.Resampling.BICUBIC)
        patches = [refined.crop(cell) for cell in plan["cells"]]
    return source, patches, plan["grid"]


def get_grid_placeholder(grid: Optional[Tuple[int, int]], query_num: int) -> str:
    """Text placeholder for the slice grid (rows of <slice>…</slice>)."""
    if grid is None:
        return ""
    cell = SLICE_START + UNK * query_num + SLICE_END
    cols, rows = grid
    return "\n".join(cell * cols for _ in range(rows))


def get_image_placeholder(grid: Optional[Tuple[int, int]], query_num: int) -> str:
    """Full placeholder: source span + optional slice grid
    (joined into the message text, minicpmv_autocheck.py:122-125)."""
    out = IM_START + UNK * query_num + IM_END
    grid_text = get_grid_placeholder(grid, query_num)
    if grid_text:
        out += "\n" + grid_text
    return out


def reshape_by_patch(image_chw: np.ndarray, patch_size: int = DEFAULT_PATCH_SIZE):
    """(3, H, W) -> (3, patch, H*W/patch) column-major patch packing —
    the var-size batching format the reference feeds its encoder."""
    c, h, w = image_chw.shape
    assert h % patch_size == 0 and w % patch_size == 0
    x = image_chw.reshape(c, h // patch_size, patch_size, w // patch_size,
                          patch_size)
    x = x.transpose(0, 1, 3, 2, 4)  # (c, gh, gw, p, p)
    x = x.reshape(c, -1, patch_size, patch_size)
    x = x.transpose(0, 2, 1, 3).reshape(c, patch_size, -1)
    return x
