"""LLaMA-family decoder in PyTorch - the LM backbone of LLaVA-1.5 (Vicuna-7B)
and, as a bare LlamaForCausalLM, the Llama3-8B of the divide-and-conquer
stage (grouped-query attention, 8 KV heads, rope theta 5e5).

Counterpart of rlaifv_tpu/models/llama.py: HF-layout RoPE (rotate-half),
RMSNorm in fp32, SiLU-gated MLP, grouped-query attention through
ops/attention.py, and a static-shape per-layer KV cache (B, max_len, KVH, D)
written in place.

`kv_cache_dtype="int8"` stores the cache as int8 with fp32 (B, max_len, KVH)
per-(token, head) scales (`quantize_kv`). A prefill (L > 1) attends over the
fresh k/v, exactly as the float cache would; a decode step reads the int8
cache through ops/decode_attention.py's kernel #5 on the card, and through
the JAX package's off-TPU formula (dense attention over the dequantised
cache) on the CPU or with attn_impl "dense". `fuse_proj` computes q/k/v in
one `qkv_proj` (N = (H + 2 KVH) D) and gate/up in one `gate_up_proj`
(N = 2 I), split after the product; models/convert.py's
`fuse_llm_projections_` fuses a model in place.

`remat` is activation checkpointing per block
(`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`), the
counterpart of `nn.remat(LlamaBlock, policy=nothing_saveable)`: only each
block's input is kept for the backward, the rest is recomputed. It applies
only where autograd records and no cache is given (the training forward).

`quantize` builds the projections as QuantDense, the weight-only layer of
the JAX package with its weights as buffers: `quantize_bits` 8, int8 (K, N)
weights and fp32 per-output-channel scales through ops/quant_matmul.py's
kernels on the card; `quantize_bits` 4, nibble-packed (K/2, N) int8 weights
and fp32 (K/G, N) group scales through ops/int4_matmul.py's. Every
projection (Dense or QuantDense) adds a LoRA side term when train/lora.py
attaches adapters to it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rlaifv_tpu_torch.models.layers import Dense, lora_side_term
from rlaifv_tpu_torch.ops.attention import kernel_domain, multi_head_attention
from rlaifv_tpu_torch.ops.decode_attention import (
    decode_attention_prefix_int8,
    decode_attention_prefix_int8_dense,
    quantize_kv,
)
from rlaifv_tpu_torch.ops.int4_matmul import dequantize_int4, int4_matmul_grad, pick_int4_group
from rlaifv_tpu_torch.ops.quant_matmul import int8_matmul_grad


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
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            max_position_embeddings=8192,
            rope_theta=500000.0,
            rms_norm_eps=1e-5,
        )
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mistral_7b(**kw) -> "LlamaConfig":
        """Mistral-7B / Zephyr-beta: the OmniLMM-12B language backbone."""
        base = dict(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            max_position_embeddings=32768,
            rope_theta=10000.0,
            rms_norm_eps=1e-5,
        )
        base.update(kw)
        return LlamaConfig(**base)

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
    """Raise for a bit width or a cache type the JAX package does not know."""
    if cfg.quantize and cfg.quantize_bits not in (4, 8):
        raise ValueError(f"LlamaConfig.quantize_bits must be 8 or 4; got {cfg.quantize_bits}")
    if cfg.kv_cache_dtype not in ("fp", "bf16", "int8"):
        raise ValueError(f"LlamaConfig.kv_cache_dtype must be 'fp', 'bf16' or 'int8'; "
                         f"got {cfg.kv_cache_dtype!r}")


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
    (B, max_len, KVH, D) in cfg.dtype; with kv_cache_dtype "int8", {"k",
    "k_scale", "v", "v_scale"}: int8 values and fp32 (B, max_len, KVH)
    scales."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_size)
    if cfg.kv_cache_dtype == "int8":
        return [
            {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
            for _ in range(cfg.num_layers)
        ]
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


def quantize_kernel_int8(w: "np.ndarray"):
    """(in, out) float kernel -> (int8 kernel, f32 per-out-channel scale)."""
    import numpy as _np

    w = _np.asarray(w, _np.float32)
    scale = _np.abs(w).max(axis=0) / 127.0
    scale = _np.maximum(scale, 1e-8)
    q = _np.clip(_np.round(w / scale[None, :]), -127, 127).astype(_np.int8)
    return q, scale.astype(_np.float32)


class QuantDense(nn.Module):
    """Weight-only quantised projection (the flax `kernel`/`scale` leaves
    as frozen buffers `q`/`scale`, in the flax layout; with `bias=True` the
    flax `bias` as a frozen buffer in `param_dtype`):

    - bits 8: y = x @ (q * scale), q (in, out) int8, scale (out,) fp32; on
      the card ops/quant_matmul.py's `int8_matmul_grad`;
    - bits 4: y = x @ dequant(q, scale), q (in/2, out) int8 nibble-packed,
      scale (in/G, out) fp32 group scales (G = `pick_int4_group(in)`); on the
      card ops/int4_matmul.py's `int4_matmul_grad`.

    Both products are differentiable in x. On the CPU the layer computes the
    formula the JAX package runs off the TPU: x @ the weight dequantised to
    the activation type. `lora` adds the same side term as Dense; the bias
    comes after both, in the compute type, as in the JAX QuantDense (the
    vision towers' projections)."""

    def __init__(self, in_features: int, out_features: int, *, dtype: torch.dtype,
                 bits: int = 8, bias: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"QuantDense: bits must be 8 or 4; got {bits}")
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype, self.bits = dtype, bits
        if bits == 4:
            q_shape = (in_features // 2, out_features)
            s_shape = (in_features // pick_int4_group(in_features), out_features)
        else:
            q_shape, s_shape = (in_features, out_features), (out_features,)
        self.register_buffer("q", torch.zeros(q_shape, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(s_shape, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=param_dtype,
                                                 device=device) if bias else None)
        self.lora = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        y = quant_product(x, self.q, self.scale, self.bits)
        if self.lora is not None:
            y = y + lora_side_term(x, self.lora)
        return y if self.bias is None else y + self.bias.to(self.compute_dtype)


def quant_product(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """QuantDense's product on x in its compute type: the int8 or int4
    kernels' dispatch on the card, x @ the dequantised weight on the CPU."""
    if x.is_cuda:
        product = int4_matmul_grad if bits == 4 else int8_matmul_grad
        return product(x, q, scale)
    if bits == 4:
        return x @ dequantize_int4(q, scale, x.dtype)
    return x @ (q.to(x.dtype) * scale.to(x.dtype))


def _dense(cfg: LlamaConfig, n_in: int, n_out: int, device, quantize=None):
    if cfg.quantize if quantize is None else quantize:
        return QuantDense(n_in, n_out, dtype=cfg.dtype, bits=cfg.quantize_bits,
                          device=device)
    return Dense(n_in, n_out, bias=False, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype, init_std=0.02, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        if cfg.fuse_proj:
            self.qkv_proj = _dense(cfg, cfg.hidden_size, (H + 2 * KVH) * D, device)
        else:
            self.q_proj = _dense(cfg, cfg.hidden_size, H * D, device)
            self.k_proj = _dense(cfg, cfg.hidden_size, KVH * D, device)
            self.v_proj = _dense(cfg, cfg.hidden_size, KVH * D, device)
        self.o_proj = _dense(cfg, H * D, cfg.hidden_size, device)
        self.attn_impl = cfg.attn_impl

    def qkv(self, x: torch.Tensor):
        """x (B, L, hidden) -> q, k, v (B, L, H|KVH, D), before RoPE. The
        head counts are read off the projections' output, so a tensor-
        parallel shard (parallel/sharding.py) yields its local heads."""
        cfg = self.cfg
        B, L, _ = x.shape
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        if cfg.fuse_proj:
            qkv = self.qkv_proj(x)
            kv = qkv.shape[-1] * KVH // (H + 2 * KVH)
            q, k, v = qkv.split([qkv.shape[-1] - 2 * kv, kv, kv], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        return q.view(B, L, -1, D), k.view(B, L, -1, D), v.view(B, L, -1, D)

    def forward(self, x, cos, sin, attention_mask, cache=None, cache_index=None):
        B, L, _ = x.shape
        q, k, v = self.qkv(x)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

        if cache is not None and "k_scale" in cache:
            out = self._int8_cache_attention(q, k, v, attention_mask, cache, cache_index)
            return self.o_proj(out.reshape(B, L, -1)), cache

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
        return self.o_proj(out.reshape(B, L, -1)), cache

    def forward_paired(self, xp, xs, cosp, sinp, coss, sins, pmask, smask):
        """The shared-prefix paired attention (train/paired_forward.py):
        prefix xp (B, P, hidden) causal over itself; suffix xs (2B, W,
        hidden), rows b and B + b over prefix b's keys then their own, with
        q_offset P. -> (prefix out, suffix out) after o_proj."""
        B, P, _ = xp.shape
        S, W, _ = xs.shape  # S = 2B (win rows then rej rows)
        qp, kp, vp = self.qkv(xp)
        qs, ks, vs = self.qkv(xs)
        qp, kp = apply_rope(qp, cosp, sinp), apply_rope(kp, cosp, sinp)
        qs, ks = apply_rope(qs, coss, sins), apply_rope(ks, coss, sins)
        op = multi_head_attention(qp, kp, vp, attention_mask=pmask, causal=True,
                                  impl=self.attn_impl)
        kf = torch.cat([torch.cat([kp, kp]), ks], dim=1)
        vf = torch.cat([torch.cat([vp, vp]), vs], dim=1)
        os_ = multi_head_attention(qs, kf, vf, attention_mask=smask, causal=True,
                                   q_offset=P, impl=self.attn_impl)
        return self.o_proj(op.reshape(B, P, -1)), self.o_proj(os_.reshape(S, W, -1))

    def _int8_cache_attention(self, q, k, v, attention_mask, cache, cache_index):
        """The int8-cache branch (the JAX LlamaAttention's): the fresh k/v
        are quantised and written in place at cache_index; a prefill attends
        over the fresh window (mask columns [0, L), no q_offset), a decode
        step over the cache's live prefix."""
        L = q.shape[1]
        sl = slice(cache_index, cache_index + L)
        cache["k"][:, sl], cache["k_scale"][:, sl] = quantize_kv(k)
        cache["v"][:, sl], cache["v_scale"][:, sl] = quantize_kv(v)
        if L > 1:
            mask = attention_mask[:, :L] if attention_mask is not None else None
            return multi_head_attention(q, k, v, attention_mask=mask, causal=True,
                                        q_offset=None, impl=self.attn_impl)
        args = (q[:, 0], cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
                attention_mask)
        n_rep = q.shape[2] // cache["k"].shape[2]
        if q.is_cuda and self.attn_impl != "dense" and (
                self.attn_impl != "auto"
                or kernel_domain(q.dtype, q.shape[-1], n_rep, decode=True)):
            out = decode_attention_prefix_int8(*args, cache_index + 1)
        else:
            out = decode_attention_prefix_int8_dense(*args)
        return out[:, None]


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        I = cfg.intermediate_size
        if cfg.fuse_proj:
            self.gate_up_proj = _dense(cfg, cfg.hidden_size, 2 * I, device)
        else:
            self.gate_proj = _dense(cfg, cfg.hidden_size, I, device)
            self.up_proj = _dense(cfg, cfg.hidden_size, I, device)
        self.down_proj = _dense(cfg, I, cfg.hidden_size, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.fuse_proj:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


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

    def forward_paired(self, xp, xs, cosp, sinp, coss, sins, pmask, smask):
        """The block over the paired streams (train/paired_forward.py):
        prefix xp (B, P, hidden), suffix xs (2B, W, hidden) -> both after
        the block. A method of its own, so that a sharded block (an FSDP
        unit) gathers its weights around it as around `forward`."""
        ap, as_ = self.attn.forward_paired(self.ln_attn(xp), self.ln_attn(xs),
                                           cosp, sinp, coss, sins, pmask, smask)
        xp, xs = xp + ap, xs + as_
        xp = xp + self.mlp(self.ln_mlp(xp))
        xs = xs + self.mlp(self.ln_mlp(xs))
        return xp, xs


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
        # a plain gather (the TPU one-hot trick serves GSPMD only); over a
        # tp mesh the vocabulary-parallel lookup of parallel/sharding.py
        tp = getattr(self.tok_embed, "tp", None)
        if tp is not None:
            return tp.embedding(input_ids, self.tok_embed.weight).to(self.cfg.dtype)
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
        if cache is None and cfg.remat and torch.is_grad_enabled():
            for blk in self.layers:
                x = checkpoint(_block_no_cache, blk, x, cos, sin, attention_mask,
                               use_reentrant=False)
            return self.ln_f(x), None
        for i, blk in enumerate(self.layers):
            x, _ = blk(x, cos, sin, attention_mask,
                       cache[i] if cache is not None else None, cache_index)
        return self.ln_f(x), cache


def _block_no_cache(blk: LlamaBlock, x, cos, sin, attention_mask):
    return blk(x, cos, sin, attention_mask)[0]


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = _dense(cfg, cfg.hidden_size, cfg.vocab_size, device,
                                  cfg.quantize and cfg.quantize_lm_head)

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
