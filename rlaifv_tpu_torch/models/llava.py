"""LLaVA-1.5 meta-architecture in PyTorch: CLIP tower + projector + LLaMA LM.

Counterpart of rlaifv_tpu/models/llava.py with the same static-shape
splice: the host pre-expands each prompt so the image span occupies
`num_image_tokens` slots, and the model overwrites that span with the
projected vision features. An anyres (LLaVA-1.6) configuration builds the
same modules: its views are encoded by `encode_images` and merged by
models/anyres.py, the merged features spliced as one span by the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig, CLIPVisionTower
from rlaifv_tpu_torch.models.layers import Dense, LayerNorm
from rlaifv_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    RMSNorm,
    llama_init_cache,
)
from rlaifv_tpu_torch.models.projector import VisionProjector
from rlaifv_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    projector_type: str = "mlp2x_gelu"
    image_aspect_ratio: str = "pad"
    image_grid_pinpoints: Optional[list] = None
    mm_patch_merge_type: str = "flat"

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches if self.vision.select_feature == "patch" \
            else self.vision.num_positions

    @staticmethod
    def llava15_7b(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                   **kw) -> "LlavaConfig":
        return LlavaConfig(
            llm=LlamaConfig.vicuna_7b(dtype=dtype, param_dtype=param_dtype, **kw),
            vision=CLIPVisionConfig.clip_l_336(dtype=dtype, param_dtype=param_dtype),
        )

    @staticmethod
    def tiny(**kw) -> "LlavaConfig":
        return LlavaConfig(
            llm=LlamaConfig.tiny(**kw),
            vision=CLIPVisionConfig.tiny(hidden_size=48),
        )


def splice_image_features(text_embeds: torch.Tensor, image_features: torch.Tensor,
                          image_starts) -> torch.Tensor:
    """Overwrite `P` slots of each sequence with its image features.

    text_embeds (B, L, D); image_features (B, P, D); image_starts (B,) host
    ints, -1 => text-only row. A start is clamped so the span fits, as
    dynamic_update_slice clamps it. A text-only row keeps its embeddings
    plus a zero-strength `0 * feats.sum()` term, as in the JAX version, so
    the vision path stays on the autograd graph: its parameters get zero
    gradients (not None) and the optimizer still updates them.
    """
    L, P = text_embeds.shape[1], image_features.shape[1]
    rows = []
    for b, start in enumerate(int(s) for s in image_starts):
        emb, feats = text_embeds[b], image_features[b].to(text_embeds.dtype)
        if start >= 0:
            s = max(min(start, L - P), 0)
            rows.append(torch.cat([emb[:s], feats, emb[s + P:]]))
        else:
            rows.append(emb + (0.0 * image_features[b].sum()).to(emb.dtype))
    return torch.stack(rows)


class LlavaForCausalLM(nn.Module):
    def __init__(self, cfg: LlavaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = CLIPVisionTower(cfg.vision, device)
        self.mm_projector = VisionProjector(
            cfg.projector_type, cfg.vision.hidden_size, cfg.llm.hidden_size,
            dtype=cfg.llm.dtype, param_dtype=cfg.llm.param_dtype, device=device,
        )
        self.llm = LlamaForCausalLM(cfg.llm, device)

    @property
    def device(self) -> torch.device:
        return self.llm.model.tok_embed.weight.device

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, P, llm_hidden). uint8 pixels (resized, not
        normalised) are normalised here in fp32, like the host processor."""
        v = self.cfg.vision
        if images.dtype == torch.uint8:
            mean, std = (to_device(np.asarray(x, np.float32), images.device)
                         for x in (v.image_mean, v.image_std))
            images = ((images.float() / 255.0 - mean) / std).to(v.dtype)
        return self.mm_projector(self.vision_tower(images))

    def build_embeds(self, input_ids: torch.Tensor, images: Optional[torch.Tensor],
                     image_starts) -> torch.Tensor:
        text_embeds = self.llm.embed(input_ids.clamp(min=0))  # sentinels -> 0
        if images is None:
            return text_embeds
        return splice_image_features(text_embeds, self.encode_images(images),
                                     image_starts)

    def forward(self, input_ids, *, images=None, image_starts=None,
                attention_mask=None, position_ids=None, cache=None,
                cache_index=None):
        """input_ids are host-side pre-expanded (image span = patch slots)."""
        embeds = self.build_embeds(input_ids, images, image_starts)
        return self.llm(inputs_embeds=embeds, attention_mask=attention_mask,
                        position_ids=position_ids, cache=cache,
                        cache_index=cache_index)

    def forward_with_features(self, input_ids, image_features, image_starts,
                              attention_mask=None) -> torch.Tensor:
        """Logits from precomputed vision features (B or 2B rows): the DPO
        step encodes each image once and tiles the features over win||rej."""
        return self.llm.logits(self.hidden_with_features(
            input_ids, image_features, image_starts, attention_mask))

    def forward_text(self, input_ids, attention_mask=None) -> torch.Tensor:
        return self.llm.logits(self.hidden_text(input_ids, attention_mask))

    def hidden_with_features(self, input_ids, image_features, image_starts,
                             attention_mask=None) -> torch.Tensor:
        """forward_with_features stopping before the lm_head: (B, L, H)."""
        embeds = splice_image_features(self.llm.embed(input_ids.clamp(min=0)),
                                       image_features, image_starts)
        return self.llm.model(inputs_embeds=embeds, attention_mask=attention_mask)[0]

    def hidden_text(self, input_ids, attention_mask=None) -> torch.Tensor:
        return self.llm.model(input_ids.clamp(min=0),
                              attention_mask=attention_mask)[0]

    def init_cache(self, batch: int, max_len: int) -> list:
        return llama_init_cache(self.cfg.llm, batch, max_len, self.device)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` with the flax initialisers'
    stds: each Dense its `init_std` (0.02 LM and projector, 0.01 CLIP
    layers), embeddings and the CLIP class/position tokens 0.02, norms at
    ones (and zero bias), Dense biases zero. Works on a model built on the
    meta device and moved with `to_empty`."""
    for m in model.modules():
        if isinstance(m, Dense):
            m.weight.normal_(0.0, m.init_std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (RMSNorm, LayerNorm)):
            m.weight.fill_(1.0)
            if isinstance(m, LayerNorm):
                m.bias.zero_()
        elif isinstance(m, CLIPVisionTower):
            m.cls_token.normal_(0.0, 0.02, generator=generator)
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
