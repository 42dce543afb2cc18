"""LLaMA-family decoder in PyTorch - the LM backbone of LLaVA-1.5 (Vicuna-7B).

Counterpart of rlaifv_tpu/models/llama.py on its bf16-cache path: HF-layout
RoPE (rotate-half), RMSNorm in fp32, SiLU-gated MLP, grouped-query
attention through ops/attention.py, and a static-shape per-layer KV cache
(B, max_len, KVH, D) written in place.

Not carried (each raises NotImplementedError, naming the ROADMAP.md item
that ports it): int8/int4 weights (`quantize`), the int8 KV cache,
fused projections (`fuse_proj`), `remat`. LoRA adapters come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense
from rlaifv_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden//heads
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6  # HF Llama default (Vicuna-7B)
    tie_word_embeddings: bool = False
    attn_impl: str = "auto"  # "auto" | "flash" | "dense"
    remat: bool = False
    dtype: torch.dtype = torch.float32  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    quantize: bool = False
    quantize_bits: int = 8
    quantize_lm_head: bool = True
    kv_cache_dtype: str = "fp"
    fuse_proj: bool = False

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def vicuna_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            max_position_embeddings=128,
        )
        base.update(kw)
        return LlamaConfig(**base)


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for options the port does not carry yet."""
    todo = {
        "quantize": (cfg.quantize, "#5 (QLoRA: int8/int4 weights)"),
        "kv_cache_dtype='int8'": (cfg.kv_cache_dtype not in ("fp", "bf16"),
                                  "#6 (serving extensions: int8 KV cache)"),
        "fuse_proj": (cfg.fuse_proj, "#6 (serving extensions: fused projections)"),
        "remat": (cfg.remat, "#2 (DPO train step)"),
    }
    for name, (on, item) in todo.items():
        if on:
            raise NotImplementedError(
                f"LlamaConfig.{name} is not ported to rlaifv_tpu_torch yet: "
                f"ROADMAP.md 'Modules to port' {item}"
            )


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-layout rotary tables: (..., L, head_dim) with freqs duplicated,
    built in fp32 and cast to `dtype`."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D); cos/sin: (B, L, D) or (L, D). HF rotate-half layout."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


def llama_init_cache(cfg: LlamaConfig, batch: int, max_len: int,
                     device=None) -> list:
    """Static-shape decode cache: per layer {"k", "v"} of
    (B, max_len, KVH, D) in cfg.dtype."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_size)
    return [
        {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        for _ in range(cfg.num_layers)
    ]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def _dense(cfg: LlamaConfig, n_in: int, n_out: int, device) -> Dense:
    return Dense(n_in, n_out, bias=False, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype, init_std=0.02, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        self.q_proj = _dense(cfg, cfg.hidden_size, H * D, device)
        self.k_proj = _dense(cfg, cfg.hidden_size, KVH * D, device)
        self.v_proj = _dense(cfg, cfg.hidden_size, KVH * D, device)
        self.o_proj = _dense(cfg, H * D, cfg.hidden_size, device)
        self.attn_impl = cfg.attn_impl

    def forward(self, x, cos, sin, attention_mask, cache=None, cache_index=None):
        cfg = self.cfg
        B, L, _ = x.shape
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        q = apply_rope(self.q_proj(x).view(B, L, H, D), cos, sin)
        k = apply_rope(self.k_proj(x).view(B, L, KVH, D), cos, sin)
        v = self.v_proj(x).view(B, L, KVH, D)

        if cache is not None:
            # in place (the JAX dynamic_update_slice): the step's k/v land in
            # the caller's cache tensors, which the next step reads; the
            # cache must be a real tensor, never an expand()-ed view
            cache["k"][:, cache_index:cache_index + L] = k
            cache["v"][:, cache_index:cache_index + L] = v
            k, v = cache["k"], cache["v"]

        out = multi_head_attention(
            q, k, v,
            attention_mask=attention_mask,
            causal=True,
            q_offset=cache_index if cache is not None else None,
            impl=self.attn_impl,
        )
        return self.o_proj(out.reshape(B, L, H * D)), cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.up_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.down_proj = _dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype, device)
        self.attn = LlamaAttention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin, attention_mask, cache=None, cache_index=None):
        attn_out, cache = self.attn(self.ln_attn(x), cos, sin, attention_mask,
                                    cache, cache_index)
        x = x + attn_out
        return x + self.mlp(self.ln_mlp(x)), cache


class LlamaModel(nn.Module):
    """Decoder stack over token ids or pre-built input embeddings."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                      device=device, dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, device) for _ in range(cfg.num_layers)
        )
        self.ln_f = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype, device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        # a plain gather: the TPU one-hot trick serves mesh sharding only
        return F.embedding(input_ids, self.tok_embed.weight).to(self.cfg.dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None, attention_mask=None,
                position_ids=None, cache=None, cache_index=None):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        B, L, _ = inputs_embeds.shape
        if position_ids is None:
            base = torch.arange(L, device=inputs_embeds.device)[None, :]
            if cache_index is not None:
                base = base + cache_index
            position_ids = base.expand(B, L)
        cos, sin = rope_cos_sin(position_ids, cfg.head_size, cfg.rope_theta, cfg.dtype)

        x = inputs_embeds
        for i, blk in enumerate(self.layers):
            x, _ = blk(x, cos, sin, attention_mask,
                       cache[i] if cache is not None else None, cache_index)
        return self.ln_f(x), cache


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = _dense(cfg, cfg.hidden_size, cfg.vocab_size, device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed(input_ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.model.tok_embed.weight.to(hidden.dtype).T
        return self.lm_head(hidden)

    def forward(self, input_ids=None, *, inputs_embeds=None, attention_mask=None,
                position_ids=None, cache=None, cache_index=None):
        """-> (logits (B, L, V), cache). A given cache is updated in place
        at [cache_index, cache_index + L) and returned."""
        hidden, cache = self.model(
            input_ids, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
            position_ids=position_ids, cache=cache, cache_index=cache_index,
        )
        return self.logits(hidden), cache

    def init_cache(self, batch: int, max_len: int) -> list:
        device = self.model.tok_embed.weight.device
        return llama_init_cache(self.cfg, batch, max_len, device)
