"""Model-family dispatch for DPO training and ref-logp scoring.

Counterpart of rlaifv_tpu/train/family.py: `core/config.py`'s
`model_family` knob resolves here, and the spec names what differs between
the trainable families:

- how a preference row tokenizes (`preprocess_v1` with the kept `<image>`
  sentinel for llava15, `omni_preprocess` over text-expanded `<im_patch>`
  spans for omnilmm),
- how the collator finds the image span (sentinel expansion, or the
  literal patch-token id),
- which adapter drives the shared train step (`LlavaDPOAdapter`,
  `OmnilmmDPOAdapter`).

MiniCPM-V is not a training family, in the JAX package either (it serves
and labels only): naming it raises ValueError.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np

from rlaifv_tpu_torch.constants import DEFAULT_IMAGE_PATCH_TOKEN


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Everything that differs between DPO-trainable model families."""

    name: str
    # (sources, tokenizer) -> {input_ids, labels}; fed to
    # encode_preference_sample (data/preprocess.py)
    preprocess_func: Callable
    # text-level <image> handling (data/multimodal.py::expand_image_token)
    keep_image_tag: bool
    use_im_start_end: bool
    # collator convention: expand the -200 sentinel on the host (llava15) or
    # locate the literal <im_patch> span already in the row (omnilmm)
    expand_images_in_collator: bool
    # host image pipeline defaults
    default_image_size: int
    image_aspect: str  # ClipImageProcessor aspect_ratio

    def mm_cfg(self, image_processor, image_token_len: int) -> dict:
        return {
            "is_multimodal": True,
            "image_processor": image_processor,
            "image_token_len": image_token_len,
            "use_im_start_end": self.use_im_start_end,
            "keep_image_tag": self.keep_image_tag,
        }

    def image_processor(self, image_size: Optional[int] = None):
        from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor

        return ClipImageProcessor(
            image_size=image_size or self.default_image_size,
            aspect_ratio=self.image_aspect,
        )

    def collator_kwargs(self, tokenizer) -> dict:
        if self.expand_images_in_collator:
            return {"expand_images": True}
        return {
            "expand_images": False,
            "image_patch_id": tokenizer.convert_tokens_to_ids(DEFAULT_IMAGE_PATCH_TOKEN),
        }

    def adapter(self, model):
        from rlaifv_tpu_torch.train.train_step import (
            LlavaDPOAdapter,
            OmnilmmDPOAdapter,
        )

        return (LlavaDPOAdapter if self.name == "llava15" else OmnilmmDPOAdapter)(model)

    def expand_inst(self, inst: dict, num_patches: int, max_len: int,
                    tokenizer=None) -> dict:
        """Encoded side -> batch-ready {input_ids, labels, image_start}
        (the per-row step DPOCollator._encode_side performs; exposed for
        the shared-prefix ref-logp splitter, train/ref_logp.py)."""
        if self.expand_images_in_collator:
            from rlaifv_tpu_torch.data.multimodal import expand_image_sentinels

            return expand_image_sentinels(
                np.asarray(inst["input_ids"]), np.asarray(inst["labels"]),
                num_patches, max_len,
            )
        ids = np.asarray(inst["input_ids"])[:max_len].astype(np.int32)
        labels = np.asarray(inst["labels"])[:max_len].astype(np.int32)
        patch_id = tokenizer.convert_tokens_to_ids(DEFAULT_IMAGE_PATCH_TOKEN)
        hits = np.where(ids == patch_id)[0]
        start = int(hits[0]) if len(hits) else -1
        if start >= 0 and start + num_patches > len(ids):
            start = -1  # truncation cut the span: treat the row as text-only
        return {"input_ids": ids, "labels": labels, "image_start": np.int32(start)}


def _llava_spec() -> FamilySpec:
    from rlaifv_tpu_torch.data.preprocess import preprocess_v1

    return FamilySpec(
        name="llava15",
        preprocess_func=partial(preprocess_v1, has_image=True),
        keep_image_tag=True,
        use_im_start_end=False,
        expand_images_in_collator=True,
        default_image_size=336,
        image_aspect="pad",  # expand2square (ref mm_utils.py:152-163)
    )


def _omnilmm_spec() -> FamilySpec:
    from rlaifv_tpu_torch.data.preprocess import omni_preprocess

    return FamilySpec(
        name="omnilmm",
        preprocess_func=omni_preprocess,
        keep_image_tag=False,  # text-expand <image> -> the im tokens
        use_im_start_end=True,  # <im_start><im_patch>*N<im_end>
        expand_images_in_collator=False,
        default_image_size=448,
        image_aspect="square",  # plain resize + CLIP norm, no pad
    )


_SPECS = {"llava15": _llava_spec, "omnilmm": _omnilmm_spec}


def get_family(name: str) -> FamilySpec:
    if name not in _SPECS:
        raise ValueError(
            f"unknown model_family {name!r}; trainable families: "
            f"{sorted(_SPECS)} (minicpmv is serve/label-only — the "
            "reference has no MiniCPM-V train entry either; PARITY.md §2.2)"
        )
    return _SPECS[name]()
