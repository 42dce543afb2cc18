"""anyres multi-view feature merging (LLaVA-1.6-style grids).

Counterpart of rlaifv_tpu/models/anyres.py (the reference merge of
llava/model/llava_arch.py:158-205 and `unpad_image`, :101-121; the host
geometry is data/image_processing.py's `process_anyres_image_full`).
`unpad_grid` and `merge_anyres_features` are the JAX package's numpy code,
copied. `encode_anyres` encodes the views in one batch on the model's
device and merges there: the merge is a gather from a host-built index
(the numpy merge run on the views' row numbers), so its rows are the numpy
merge's bit for bit, and the merged features stay on the device for the
engine's span splice.

Views layout: features (1 + nh*nw, P^2, D); view 0 is the base (a square
resize), the rest are the grid patches in row-major order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rlaifv_tpu_torch.utils.device import to_device


def unpad_grid(grid: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
    """Crop the letterbox padding from a (H, W, D) feature grid.

    original_size: (width, height) of the source image
    (ref unpad_image, llava_arch.py:101-121 — same ratio arithmetic).
    """
    ow, oh = original_size
    H, W = grid.shape[:2]
    original_ratio = ow / oh
    current_ratio = W / H
    if original_ratio > current_ratio:
        # padding on top/bottom
        scale = W / ow
        new_h = int(oh * scale)
        pad = (H - new_h) // 2
        return grid[pad : H - pad, :]
    scale = H / oh
    new_w = int(ow * scale)
    pad = (W - new_w) // 2
    return grid[:, pad : W - pad]


def merge_anyres_features(
    view_features: np.ndarray,  # (1 + nh*nw, P^2, D)
    grid_shape: Tuple[int, int],  # (num_patch_w, num_patch_h)
    *,
    merge_type: str = "spatial_unpad",
    original_size: Optional[Tuple[int, int]] = None,  # (w, h), for unpad
    image_newline: Optional[np.ndarray] = None,  # (D,), for unpad
) -> np.ndarray:
    """-> (T, D) merged feature sequence (T varies with merge_type).

    merge_type:
      'flat'          — all views flattened in order (llava_arch.py:167)
      'spatial'       — base ++ grid patches stitched spatially (:181-183)
      'spatial_unpad' — base ++ unpadded grid with a newline feature at the
                        end of every row (:173-180)
    """
    n_views, p2, D = view_features.shape
    side = int(round(p2 ** 0.5))
    assert side * side == p2, "views must be square patch grids"

    if merge_type == "flat":
        return view_features.reshape(-1, D)

    base = view_features[0]
    patches = view_features[1:]
    nw, nh = grid_shape
    assert patches.shape[0] == nw * nh, (
        f"grid {grid_shape} needs {nw * nh} patch views, got {patches.shape[0]}"
    )
    # (nh, nw, side, side, D) -> (nh*side, nw*side, D)
    grid = patches.reshape(nh, nw, side, side, D)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(nh * side, nw * side, D)

    if merge_type == "spatial":
        return np.concatenate([base, grid.reshape(-1, D)], axis=0)

    if merge_type == "spatial_unpad":
        assert original_size is not None and image_newline is not None
        grid = unpad_grid(grid, original_size)
        newline_col = np.broadcast_to(
            image_newline[None, None, :], (grid.shape[0], 1, D)
        )
        grid = np.concatenate([grid, newline_col], axis=1)
        return np.concatenate([base, grid.reshape(-1, D)], axis=0)

    raise ValueError(f"Unexpected mm_patch_merge_type: {merge_type}")


def merge_index(n_views: int, p2: int, grid_shape, *, merge_type: str = "spatial_unpad",
                original_size=None) -> np.ndarray:
    """The merge as a gather: (T,) int64 rows of the flattened (n_views *
    p2, D) view features, -1 where the image newline goes."""
    rows = np.arange(n_views * p2, dtype=np.int64).reshape(n_views, p2, 1)
    return merge_anyres_features(rows, grid_shape, merge_type=merge_type,
                                 original_size=original_size,
                                 image_newline=np.full(1, -1, np.int64))[:, 0]


def merge_anyres_device(feats: torch.Tensor, grid_shape, *, merge_type: str = "spatial_unpad",
                        original_size=None, image_newline=None) -> torch.Tensor:
    """`merge_anyres_features` on (n_views, P^2, D) features where they lie:
    one gather by `merge_index`, the newline rows filled -> (T, D).
    image_newline: (D,) numpy or a tensor."""
    n_views, p2, D = feats.shape
    idx_np = merge_index(n_views, p2, grid_shape, merge_type=merge_type,
                         original_size=original_size)
    idx = to_device(idx_np, feats.device)
    out = feats.reshape(-1, D)[idx.clamp(min=0)]
    if (idx_np < 0).any():
        nl = (image_newline if torch.is_tensor(image_newline)
              else to_device(np.asarray(image_newline), feats.device))
        out = torch.where((idx < 0)[:, None], nl.to(feats.device, feats.dtype), out)
    return out


@torch.inference_mode()
def encode_anyres(model, processor, cfg, image, *,
                  image_newline: Optional[np.ndarray] = None) -> torch.Tensor:
    """Full anyres encode for inference: host geometry -> the views through
    `model.encode_images` in one batch -> the merge on the device -> (T, D)
    merged features in the model's dtype on its device (T varies per
    image; the B = 1 chat splices them as one span).

    cfg: a LlavaConfig with image_grid_pinpoints / mm_patch_merge_type set
    (ref llava_arch.py:150-205, the anyres branch)."""
    from rlaifv_tpu_torch.data.image_processing import process_anyres_image_full

    views, grid_shape, original_size = process_anyres_image_full(
        image, processor, cfg.image_grid_pinpoints)
    feats = model.encode_images(to_device(views, model.device))
    if cfg.mm_patch_merge_type == "spatial_unpad" and image_newline is None:
        raise ValueError("encode_anyres: spatial_unpad needs the checkpoint's image_newline")
    return merge_anyres_device(feats, grid_shape, merge_type=cfg.mm_patch_merge_type,
                               original_size=original_size, image_newline=image_newline)
