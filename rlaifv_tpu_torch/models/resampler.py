"""Perceiver resampler in PyTorch: grid² learnable queries cross-attend to
the vision tokens (OmniLMM-12B's bridge from EVA02 to the Mistral LM).

Counterpart of rlaifv_tpu/models/resampler.py with the same parameters:
`kv_proj` (when the tower is wider than the LM), `ln_kv` / `ln_q` /
`ln_post` at eps 1e-6, the torch nn.MultiheadAttention in-projection split
into `attn_q` / `attn_k` / `attn_v` plus `attn_out`, and the raw (D, D)
`proj` right-multiplied. The cross-attention is plain torch
(ops/attention.py `dense_attention`: fp32 scores and softmax, the
probabilities cast to v's type): 64 queries sit below the flash kernel's
tile and the JAX package runs an einsum here too.

`interp_abs_pos` re-grids a square position table the way
`jax.image.resize(..., "bicubic")` does (Keys cubic, a = -0.5, the kernel
widened by the scale when shrinking, each output's weights normalised to
sum 1): one (tgt, src) weight matrix applied on both axes in fp32.
`F.interpolate(mode="bicubic")` is another function (its border handling
and lack of antialias move a unit-normal table by ~0.25).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense, LayerNorm
from rlaifv_tpu_torch.ops.attention import dense_attention
from rlaifv_tpu_torch.utils.device import to_device


def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float32) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d_rect(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """(grid_h*grid_w, D): height-half ++ width-half."""
    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    grid = np.meshgrid(gw, gh)  # w first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_h, grid_w)
    emb_h = sincos_1d(embed_dim // 2, grid[0])
    emb_w = sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    return sincos_2d_rect(embed_dim, grid_size, grid_size)


@functools.lru_cache(maxsize=64)
def sincos_table(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """`sincos_2d_rect`, computed once a (width, grid): at width 4096 the
    table of one 448 px slice's grid takes tens of ms of host numpy, which
    a forward would otherwise pay on every call. Callers do not write to
    it."""
    return sincos_2d_rect(embed_dim, grid_h, grid_w)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def bicubic_weights(src: int, tgt: int) -> np.ndarray:
    """(tgt, src) fp32 resampling matrix of jax.image.resize's bicubic
    method: output i samples source coordinate (i + 0.5) src / tgt - 0.5,
    the kernel stretched by src / tgt when shrinking (antialias), each row
    normalised to sum 1."""
    s = np.float32(tgt) / np.float32(src)
    centers = (np.arange(tgt, dtype=np.float32) + 0.5) / s - 0.5
    x = (centers[:, None] - np.arange(src, dtype=np.float32)[None, :]) * min(s, 1.0)
    w = _keys_cubic(x.astype(np.float32)).astype(np.float32)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def interp_abs_pos(abs_pos: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """Bicubic re-grid of a square (src², D) position table to (tgt², D),
    computed in fp32 and cast back to the table's dtype."""
    src = int(math.isqrt(abs_pos.shape[0]))
    tgt = int(math.isqrt(tgt_len))
    if src == tgt:
        return abs_pos
    w = to_device(bicubic_weights(src, tgt), abs_pos.device)
    grid = abs_pos.reshape(src, src, -1).float()
    out = torch.einsum("ia,jb,abd->ijd", w, w, grid)
    return out.reshape(tgt * tgt, -1).to(abs_pos.dtype)


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    grid_size: int
    embed_dim: int
    num_heads: int
    kv_dim: Optional[int] = None
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # MiniCPM-V 2.5: query_num learned queries, not a square grid, and no
    # position embedding on the query side (sincos on the keys only)
    num_queries_override: Optional[int] = None
    query_pos: bool = True

    @property
    def num_queries(self) -> int:
        if self.num_queries_override is not None:
            return self.num_queries_override
        return self.grid_size ** 2


class Resampler(nn.Module):
    """x (B, N, kv_dim) vision tokens -> (B, num_queries, embed_dim)."""

    def __init__(self, cfg: ResamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, pdt = cfg.embed_dim, cfg.param_dtype
        if cfg.query_pos:
            self.pos_embed = nn.Parameter(torch.zeros(cfg.num_queries, D, dtype=pdt,
                                                      device=device))
        else:
            self.pos_embed = None
        self.query = nn.Parameter(torch.zeros(cfg.num_queries, D, dtype=pdt, device=device))
        self.kv_proj = None
        if cfg.kv_dim is not None and cfg.kv_dim != D:
            self.kv_proj = self._dense(cfg.kv_dim, False, device)
        self.ln_kv, self.ln_q, self.ln_post = (self._ln(device) for _ in range(3))
        self.attn_q, self.attn_k, self.attn_v, self.attn_out = (
            self._dense(D, True, device) for _ in range(4))
        self.proj = nn.Parameter(torch.zeros(D, D, dtype=pdt, device=device))

    def _dense(self, n_in: int, bias: bool, device) -> Dense:
        cfg = self.cfg
        return Dense(n_in, cfg.embed_dim, bias=bias, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, init_std=n_in ** -0.5, device=device)

    def _ln(self, device) -> LayerNorm:
        cfg = self.cfg
        return LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype=cfg.dtype,
                         param_dtype=cfg.param_dtype, device=device)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The flax initialisers of the non-Dense parameters: the sincos
        table, truncated-normal(0.02) queries, proj ~ N(0, 1/D)."""
        cfg = self.cfg
        if self.pos_embed is not None:
            self.pos_embed.copy_(torch.from_numpy(sincos_2d(cfg.embed_dim, cfg.grid_size)))
        q = torch.empty(self.query.shape, device=self.query.device)
        q.normal_(0.0, 1.0, generator=generator)
        self.query.copy_(q.clamp_(-2.0, 2.0) * 0.02)
        self.proj.normal_(0.0, cfg.embed_dim ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, tgt_hw: Optional[tuple] = None) -> torch.Tensor:
        """tgt_hw: (grid_h, grid_w) of a non-square token grid (MiniCPM-V
        slices); by default the N tokens form a square grid."""
        cfg = self.cfg
        B, N, _ = x.shape
        D, H, dt = cfg.embed_dim, cfg.num_heads, cfg.dtype
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        kv = self.ln_kv(x)
        q = self.ln_q(self.query.to(dt))

        if tgt_hw is not None:
            kv_pos = to_device(sincos_table(D, tgt_hw[0], tgt_hw[1]), x.device).to(dt)
        elif self.pos_embed is not None:
            kv_pos = interp_abs_pos(self.pos_embed.to(dt), N)
        else:
            side = int(math.isqrt(N))
            if side * side != N:
                raise ValueError(f"non-square token count N={N} needs explicit tgt_hw")
            kv_pos = to_device(sincos_table(D, side, side), x.device).to(dt)

        q_in = q[None] + self.pos_embed.to(dt)[None] if cfg.query_pos else q[None]
        qh = self.attn_q(q_in.expand(B, -1, -1))
        kh = self.attn_k(kv + kv_pos[None])
        vh = self.attn_v(kv)
        hd = D // H
        out = dense_attention(qh.reshape(B, -1, H, hd), kh.reshape(B, N, H, hd),
                              vh.reshape(B, N, H, hd), None)
        out = self.attn_out(out.reshape(B, -1, D).to(dt))
        return self.ln_post(out) @ self.proj.to(dt)


def convert_resampler(sd, prefix: str = "", dtype=np.float32,
                      query_pos: bool = True) -> dict:
    """torch Resampler state dict -> the flax-style tree (in_proj split in
    q/k/v); with query_pos=False (MiniCPM-V 2.5) the tree has no
    'pos_embed'."""

    def g(k):
        v = sd[prefix + k]
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        return np.asarray(v).astype(dtype)

    D = g("query").shape[1]
    in_proj_w = g("attn.in_proj_weight")  # (3D, D)
    in_proj_b = g("attn.in_proj_bias")
    out = {
        "query": g("query"),
        "ln_q": {"scale": g("ln_q.weight"), "bias": g("ln_q.bias")},
        "ln_kv": {"scale": g("ln_kv.weight"), "bias": g("ln_kv.bias")},
        "ln_post": {"scale": g("ln_post.weight"), "bias": g("ln_post.bias")},
        "attn_q": {"kernel": in_proj_w[:D].T, "bias": in_proj_b[:D]},
        "attn_k": {"kernel": in_proj_w[D:2 * D].T, "bias": in_proj_b[D:2 * D]},
        "attn_v": {"kernel": in_proj_w[2 * D:].T, "bias": in_proj_b[2 * D:]},
        "attn_out": {
            "kernel": g("attn.out_proj.weight").T,
            "bias": g("attn.out_proj.bias"),
        },
        "proj": g("proj"),
    }
    if query_pos:
        out["pos_embed"] = g("pos_embed")
    if prefix + "kv_proj.weight" in sd:
        out["kv_proj"] = {"kernel": g("kv_proj.weight").T}
    return out
