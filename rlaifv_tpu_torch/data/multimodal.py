# A copy of rlaifv_tpu/data/multimodal.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Host-side multimodal token handling.

- `tokenizer_image_token`: split the prompt on <image>, splice the -200
  sentinel (ref: llava/mm_utils.py:185-204, duplicated at
  muffin/train/train_utils.py:176 — collapsed to one implementation here).
- `expand_image_sentinels`: replace each -200 with `num_patches` patch-slot
  positions and record the span start. This moves the reference's in-model
  ragged splice (llava/model/llava_arch.py:237-313) to the host so the
  device-side program is static-shape: the model overwrites the span with
  vision features (rlaifv_tpu_torch/models/llava.py `splice_image_features`).
  Truncation to max_len after expansion mirrors llava_arch.py:279-283.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rlaifv_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize text around <image> markers, inserting the sentinel id.

    Each chunk is tokenized independently; a leading BOS on the first chunk
    is preserved and the per-chunk BOS re-added by the tokenizer is stripped
    from subsequent chunks (offset trick, mm_utils.py:190-201).
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, ck in enumerate(chunks):
        joined.append(ck)
        if i != len(chunks) - 1:
            joined.append(sep)
    for piece in joined:
        ids.extend(piece[offset:])
    return ids


def expand_image_token(source: Sequence[dict], multimodal_cfg: dict) -> Sequence[dict]:
    """Replace <image> in message text with im_patch placeholder tokens
    (legacy Muffin/OmniLMM path; ref train_utils.py:161-174)."""
    if not multimodal_cfg["is_multimodal"] or multimodal_cfg.get("keep_image_tag"):
        return source
    n = multimodal_cfg["image_token_len"]
    replace = DEFAULT_IMAGE_PATCH_TOKEN * n
    if multimodal_cfg.get("use_im_start_end"):
        replace = DEFAULT_IM_START_TOKEN + replace + DEFAULT_IM_END_TOKEN
    for sentence in source:
        sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, replace)
    return source


def expand_image_sentinels(
    input_ids: Sequence[int],
    labels: Optional[Sequence[int]],
    num_patches: int,
    max_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Expand each IMAGE_TOKEN_INDEX into `num_patches` slots.

    Returns dict with:
      input_ids : int32 (L',) — patch slots carry IMAGE_TOKEN_INDEX
      labels    : int32 (L',) — IGNORE_INDEX over the image span (or None)
      image_start: int32 scalar — start of the first image span, -1 if none
    """
    ids_out: List[int] = []
    labels_out: List[int] = []
    image_start = -1
    has_labels = labels is not None
    for pos, tok in enumerate(input_ids):
        if tok == IMAGE_TOKEN_INDEX:
            if image_start < 0:
                image_start = len(ids_out)
            ids_out.extend([IMAGE_TOKEN_INDEX] * num_patches)
            if has_labels:
                labels_out.extend([IGNORE_INDEX] * num_patches)
        else:
            ids_out.append(int(tok))
            if has_labels:
                labels_out.append(int(labels[pos]))
    if max_len is not None:
        ids_out = ids_out[:max_len]
        labels_out = labels_out[:max_len]
        if image_start >= max_len:
            image_start = -1
    out = {
        "input_ids": np.asarray(ids_out, dtype=np.int32),
        "image_start": np.int32(image_start),
    }
    if has_labels:
        out["labels"] = np.asarray(labels_out, dtype=np.int32)
    return out
