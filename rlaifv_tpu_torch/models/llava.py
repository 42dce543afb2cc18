"""LLaVA-1.5 meta-architecture in PyTorch: CLIP tower + projector + LLaMA LM.

Counterpart of rlaifv_tpu/models/llava.py with the same static-shape
splice: the host pre-expands each prompt so the image span occupies
`num_image_tokens` slots, and the model overwrites that span with the
projected vision features.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
    dynamic_update_slice clamps it. Inference only: the JAX version's
    zero-strength gradient term for text-only rows has no use here.
    """
    out = text_embeds.clone()
    L, P = text_embeds.shape[1], image_features.shape[1]
    for b, start in enumerate(int(s) for s in image_starts):
        if start >= 0:
            s = min(start, L - P)
            out[b, s:s + P] = image_features[b].to(out.dtype)
    return out


class LlavaForCausalLM(nn.Module):
    def __init__(self, cfg: LlavaConfig, device=None):
        super().__init__()
        if cfg.image_aspect_ratio == "anyres" or cfg.mm_patch_merge_type != "flat":
            raise NotImplementedError(
                "anyres images are not ported to rlaifv_tpu_torch yet: "
                "ROADMAP.md 'Modules to port' #8 (anyres)"
            )
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
            mean = torch.tensor(v.image_mean, dtype=torch.float32, device=images.device)
            std = torch.tensor(v.image_std, dtype=torch.float32, device=images.device)
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
