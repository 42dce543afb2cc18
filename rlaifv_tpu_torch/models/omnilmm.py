"""OmniLMM-12B in PyTorch: EVA02-enormous tower + perceiver resampler +
Mistral-7B LM.

Counterpart of rlaifv_tpu/models/omnilmm.py. The prompt already holds the
literal `<im_start><im_patch>*N<im_end>` tokens (the host expands the
image marker as text), so the sequence length never changes: the model
overwrites the N patch-token embeddings with the resampled features, the
port's `splice_image_features` with start = the first `<im_patch>`. The
LM is the port's LlamaForCausalLM at `LlamaConfig.mistral_7b` widths (GQA,
8 KV heads), so the serving engine (genai/engine.py) and every kernel of
the LLaVA path serve it unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.models.eva02 import EvaConfig, EvaVisionTower
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import init_weights_, splice_image_features
from rlaifv_tpu_torch.models.resampler import Resampler, ResamplerConfig


@dataclasses.dataclass(frozen=True)
class OmniLMMConfig:
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.mistral_7b)
    vision: EvaConfig = dataclasses.field(default_factory=EvaConfig.enormous)
    num_query: int = 64  # an 8 x 8 grid of resampled queries

    @property
    def resampler(self) -> ResamplerConfig:
        return ResamplerConfig(
            grid_size=int(math.isqrt(self.num_query)),
            embed_dim=self.llm.hidden_size,
            num_heads=max(1, self.llm.hidden_size // 128),
            kv_dim=self.vision.embed_dim,
            dtype=self.llm.dtype,
            param_dtype=self.llm.param_dtype,
        )

    @property
    def num_image_tokens(self) -> int:
        return self.num_query

    @staticmethod
    def omnilmm_12b(dtype=torch.bfloat16, param_dtype=torch.bfloat16) -> "OmniLMMConfig":
        return OmniLMMConfig(
            llm=LlamaConfig.mistral_7b(dtype=dtype, param_dtype=param_dtype),
            vision=EvaConfig.enormous(dtype=dtype, param_dtype=param_dtype),
            num_query=64,
        )

    @staticmethod
    def omnilmm_12b_int8(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                         bits: int = 8) -> "OmniLMMConfig":
        """The one-card 12B serving configuration: int8 (or, bits=4,
        int4) weights on both towers, the LM head left in `dtype`, an int8
        KV cache."""
        return OmniLMMConfig(
            llm=LlamaConfig.mistral_7b(
                dtype=dtype, param_dtype=param_dtype, quantize=True,
                quantize_bits=bits, quantize_lm_head=False, kv_cache_dtype="int8",
            ),
            vision=EvaConfig.enormous(dtype=dtype, param_dtype=param_dtype, quantize=True,
                                      quantize_bits=bits),
            num_query=64,
        )

    @staticmethod
    def tiny(**kw) -> "OmniLMMConfig":
        return OmniLMMConfig(
            llm=LlamaConfig.tiny(num_kv_heads=2, **kw),
            vision=EvaConfig.tiny(),
            num_query=4,
        )


class OmniLMMForCausalLM(nn.Module):
    def __init__(self, cfg: OmniLMMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = EvaVisionTower(cfg.vision, device)
        self.resampler = Resampler(cfg.resampler, device)
        self.llm = LlamaForCausalLM(cfg.llm, device)

    @property
    def device(self) -> torch.device:
        return self.llm.model.tok_embed.weight.device

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised pixels -> (B, num_query, llm hidden)."""
        return self.resampler(self.vision_tower(images))

    def build_embeds(self, input_ids: torch.Tensor, images: Optional[torch.Tensor],
                     image_starts) -> torch.Tensor:
        """Token embeddings with the resampled features over each row's
        `<im_patch>` span (text-only without images)."""
        text_embeds = self.llm.embed(input_ids.clamp(min=0))
        if images is None:
            return text_embeds
        return splice_image_features(text_embeds, self.encode_images(images), image_starts)

    def forward(self, input_ids, *, images=None, image_starts=None, attention_mask=None,
                position_ids=None, cache=None, cache_index=None):
        embeds = self.build_embeds(input_ids, images, image_starts)
        return self.llm(inputs_embeds=embeds, attention_mask=attention_mask,
                        position_ids=position_ids, cache=cache, cache_index=cache_index)

    def forward_with_features(self, input_ids, image_features, image_starts,
                              attention_mask=None) -> torch.Tensor:
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
        return self.llm.model(input_ids.clamp(min=0), attention_mask=attention_mask)[0]

    def init_cache(self, batch: int, max_len: int) -> list:
        return self.llm.init_cache(batch, max_len)


@torch.no_grad()
def init_omnilmm_weights_(model: OmniLMMForCausalLM,
                          generator: torch.Generator) -> OmniLMMForCausalLM:
    """Random weights from `generator`: `init_weights_` (each Dense its
    init_std, embeddings 0.02, norms at ones), then the tower's cls/pos
    tokens and the resampler's table, queries and proj by their flax
    initialisers. Works on a model built on the meta device and moved with
    `to_empty`."""
    init_weights_(model, generator)
    model.vision_tower.init_random_(generator)
    model.resampler.init_random_(generator)
    return model


def find_image_start(input_ids, im_patch_token: int) -> int:
    """Host-side: first <im_patch> position (-1 when text-only)."""
    hits = np.where(np.asarray(input_ids) == im_patch_token)[0]
    return int(hits[0]) if len(hits) else -1
