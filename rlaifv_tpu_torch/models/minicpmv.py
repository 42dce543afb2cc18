"""MiniCPM-Llama3-V 2.5 in PyTorch: SigLIP-so400m tower + resampler +
Llama3-8B.

Counterpart of rlaifv_tpu/models/minicpmv.py. A sliced image contributes
1 + n_slices feature groups (the source image and each slice), each
`query_num` (96) resampled tokens long, spliced over the `<unk>` runs of
the prompt at several spans of one row (`splice_multi_span`). The prompt
already holds those runs, so the sequence length never changes. The LM is
the port's LlamaForCausalLM at `LlamaConfig.llama3_8b` widths (GQA, 8 KV
heads of 32, rope theta 500000, vocabulary 128256), so the serving engine
(genai/engine.py) and every kernel of the LLaVA path serve it unchanged.

The resampler is models/resampler.py in its MiniCPM-V 2.5 form: 96
learned queries (not a square grid), no position embedding on the query
side, the sincos positions of each slice's (gh, gw) grid on the keys
(`tgt_hw`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, llama_init_cache
from rlaifv_tpu_torch.models.llava import init_weights_
from rlaifv_tpu_torch.models.resampler import Resampler, ResamplerConfig
from rlaifv_tpu_torch.models.siglip import SiglipVisionConfig, SiglipVisionTower
from rlaifv_tpu_torch.utils.device import to_device


def span_index(span_starts, L: int, Q: int) -> np.ndarray:
    """(B, L) int64 host array: for each position the flat (span * Q + q)
    feature it takes, -1 where the text embedding stays. Spans overwrite
    in list order; a start of -1 is inactive; a start is clamped so the
    span fits, as dynamic_update_slice clamps it."""
    starts = np.asarray(span_starts, np.int64)
    B, S = starts.shape
    idx = np.full((B, L), -1, np.int64)
    for b in range(B):
        for s in range(S):
            st = int(starts[b, s])
            if st >= 0:
                st = max(min(st, L - Q), 0)
                idx[b, st:st + Q] = s * Q + np.arange(Q)
    return idx


def splice_multi_span(text_embeds: torch.Tensor, span_features: torch.Tensor,
                      span_starts) -> torch.Tensor:
    """Overwrite Q-token spans of each row with its span features.

    text_embeds (B, L, D); span_features (B, S, Q, D); span_starts (B, S)
    host ints relative to the row, -1 = inactive. The spans land in list
    order (a later span overwrites an earlier one where they overlap), as
    the JAX function's scan of dynamic_update_slice. The whole splice is
    one gather from a host-built index. The JAX function adds a
    zero-strength `0 * feat.sum()` term on inactive spans to keep the
    features on the gradient graph; serving takes no gradient, so the port
    leaves it out."""
    B, L, D = text_embeds.shape
    S, Q = span_features.shape[1], span_features.shape[2]
    idx = to_device(span_index(span_starts, L, Q), text_embeds.device)
    feats = span_features.reshape(B, S * Q, D).to(text_embeds.dtype)
    taken = torch.gather(feats, 1, idx.clamp(min=0)[..., None].expand(B, L, D))
    return torch.where((idx >= 0)[..., None], taken, text_embeds)


@dataclasses.dataclass(frozen=True)
class MiniCPMVConfig:
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.llama3_8b)
    vision: SiglipVisionConfig = dataclasses.field(default_factory=SiglipVisionConfig.so400m)
    query_num: int = 96
    slice_mode: bool = True
    max_slice_nums: int = 9
    scale_resolution: int = 448
    patch_size: int = 14

    @property
    def resampler(self) -> ResamplerConfig:
        return ResamplerConfig(
            grid_size=int(math.isqrt(self.query_num)),
            embed_dim=self.llm.hidden_size,
            num_heads=max(1, self.llm.hidden_size // 128),
            kv_dim=self.vision.hidden_size,
            dtype=self.llm.dtype,
            param_dtype=self.llm.param_dtype,
            # 2.5: query_num queries, no query-side position embedding (the
            # sincos positions ride the keys, per slice: tgt_hw)
            num_queries_override=self.query_num,
            query_pos=False,
        )

    @staticmethod
    def minicpm_llama3_v25(dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16) -> "MiniCPMVConfig":
        return MiniCPMVConfig(
            llm=LlamaConfig.llama3_8b(dtype=dtype, param_dtype=param_dtype),
            vision=SiglipVisionConfig.so400m(dtype=dtype, param_dtype=param_dtype),
        )

    @staticmethod
    def minicpm_llama3_v25_int8(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                bits: int = 8) -> "MiniCPMVConfig":
        """The one-card serving configuration: int8 (or, bits=4, int4) LLM
        projections with the head left in `dtype`, an int8 KV cache, the
        SigLIP tower in `dtype`. Quantise a float model in place with
        models/convert.py `quantize_llm_int8(model, include_lm_head=False)`
        (or `quantize_llm_int4`)."""
        return MiniCPMVConfig(
            llm=LlamaConfig.llama3_8b(
                dtype=dtype, param_dtype=param_dtype, quantize=True, quantize_bits=bits,
                quantize_lm_head=False, kv_cache_dtype="int8",
            ),
            vision=SiglipVisionConfig.so400m(dtype=dtype, param_dtype=param_dtype),
        )

    @staticmethod
    def tiny(**kw) -> "MiniCPMVConfig":
        return MiniCPMVConfig(
            llm=LlamaConfig.tiny(num_kv_heads=2, **kw),
            vision=SiglipVisionConfig.tiny(),
            query_num=4,
            scale_resolution=28,
            patch_size=7,
        )


class MiniCPMVForCausalLM(nn.Module):
    def __init__(self, cfg: MiniCPMVConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vpm = SiglipVisionTower(cfg.vision, device)
        self.resampler = Resampler(cfg.resampler, device)
        self.llm = LlamaForCausalLM(cfg.llm, device)

    @property
    def device(self) -> torch.device:
        return self.llm.model.tok_embed.weight.device

    def encode_slices(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalised slices of one shape -> (N, query_num,
        llm hidden); the resampler gets the (gh, gw) token grid, so its key
        positions match the slice (2.5's tgt_sizes)."""
        p = self.cfg.vision.patch_size
        tgt_hw = (images.shape[1] // p, images.shape[2] // p)
        return self.resampler(self.vpm(images), tgt_hw=tgt_hw)

    def build_embeds(self, input_ids: torch.Tensor, images=None, image_starts=None, *,
                     span_features: Optional[torch.Tensor] = None,
                     span_starts=None) -> torch.Tensor:
        """Token embeddings (ids clamped at 0) with the span features
        spliced over their spans; text-only without them. The model takes
        no raw images: its slices are encoded ahead (`encode_slices`)."""
        if images is not None:
            raise ValueError("MiniCPM-V takes pre-encoded span features, not images")
        embeds = self.llm.embed(input_ids.clamp(min=0))
        if span_features is None:
            return embeds
        return splice_multi_span(embeds, span_features, span_starts)

    def forward(self, input_ids, *, span_features=None, span_starts=None,
                attention_mask=None, position_ids=None, cache=None, cache_index=None):
        embeds = self.build_embeds(input_ids, span_features=span_features,
                                   span_starts=span_starts)
        return self.llm(inputs_embeds=embeds, attention_mask=attention_mask,
                        position_ids=position_ids, cache=cache, cache_index=cache_index)

    def forward_with_spans(self, input_ids, span_features, span_starts,
                           attention_mask=None) -> torch.Tensor:
        logits, _ = self(input_ids, span_features=span_features, span_starts=span_starts,
                         attention_mask=attention_mask)
        return logits

    def init_cache(self, batch: int, max_len: int) -> list:
        return llama_init_cache(self.cfg.llm, batch, max_len, self.device)


@torch.no_grad()
def init_minicpmv_weights_(model: MiniCPMVForCausalLM,
                           generator: torch.Generator) -> MiniCPMVForCausalLM:
    """Random weights from `generator`: `init_weights_` (each Dense its
    init_std, embeddings 0.02, norms at ones), then the tower's position
    table and the resampler's queries and proj by their flax initialisers.
    Works on a model built on the meta device and moved with `to_empty`."""
    init_weights_(model, generator)
    model.vpm.init_random_(generator)
    model.resampler.init_random_(generator)
    return model


def find_unk_spans(input_ids, unk_id: int, query_num: int) -> List[int]:
    """Host-side: starts of contiguous unk runs of exactly query_num (the
    <image> / <slice> placeholder spans, in reading order)."""
    ids = np.asarray(input_ids)
    starts = []
    i = 0
    while i < len(ids):
        if ids[i] == unk_id:
            j = i
            while j < len(ids) and ids[j] == unk_id:
                j += 1
            if j - i == query_num:
                starts.append(i)
            i = j
        else:
            i += 1
    return starts
