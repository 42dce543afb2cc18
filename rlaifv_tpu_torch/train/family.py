"""Model-family dispatch for DPO training and ref-logp scoring.

Counterpart of rlaifv_tpu/train/family.py with the llava15 spec only:
`core/config.py`'s `model_family` knob resolves here, and the spec names
how a preference row tokenizes (`preprocess_v1` with the kept `<image>`
sentinel), how the collator finds the image span (sentinel expansion) and
which adapter drives the train step (`LlavaDPOAdapter`). The other families
of the JAX package raise: OmniLMM-12B is ROADMAP.md 'Modules to port' #9,
MiniCPM-V 2.5 #10.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np


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
    # collator convention: expand the -200 sentinel on the host
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
        # llava15 expands the -200 sentinel on the host; the JAX package's
        # omnilmm branch (a literal <im_patch> span) comes with #9
        return {"expand_images": self.expand_images_in_collator}

    def adapter(self, model):
        from rlaifv_tpu_torch.train.train_step import LlavaDPOAdapter

        return LlavaDPOAdapter(model)

    def expand_inst(self, inst: dict, num_patches: int, max_len: int,
                    tokenizer=None) -> dict:
        """Encoded side -> batch-ready {input_ids, labels, image_start}
        (the per-row step DPOCollator._encode_side performs; exposed for
        the shared-prefix ref-logp splitter, train/ref_logp.py)."""
        from rlaifv_tpu_torch.data.multimodal import expand_image_sentinels

        return expand_image_sentinels(
            np.asarray(inst["input_ids"]), np.asarray(inst["labels"]),
            num_patches, max_len,
        )


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


_SPECS = {"llava15": _llava_spec}
_NOT_PORTED = {
    "omnilmm": "#9 (OmniLMM-12B family)",
    "minicpmv": "#10 (MiniCPM-V 2.5 family)",
}


def get_family(name: str) -> FamilySpec:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model_family={name!r} is not ported to rlaifv_tpu_torch yet: "
            f"ROADMAP.md 'Modules to port' {_NOT_PORTED[name]}"
        )
    if name not in _SPECS:
        raise ValueError(
            f"unknown model_family {name!r}; trainable families: {sorted(_SPECS)}"
        )
    return _SPECS[name]()
