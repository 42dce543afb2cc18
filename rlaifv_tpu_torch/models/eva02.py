"""EVA02 / EVA-CLIP ViT in PyTorch: OmniLMM-12B's vision tower.

Counterpart of rlaifv_tpu/models/eva02.py (timm's
`eva02_enormous_patch14_clip_224` with its last block left out: the
second-last block's features feed the resampler, prefix tokens stripped).
The block family is flag-configurable as in timm and the JAX module, and a
checkpoint's `eva_config` may switch any flag:

- use_rope: 2D axial rotary embedding on the patch tokens' q/k;
- use_swiglu: SwiGLU FFN (w1, w2, w3) with an optional inner LayerNorm
  (subln), else fc1 -> exact GELU -> fc2;
- qkv_fused: one packed qkv projection, or q/k/v (q and v biased, k not);
- use_post_norm: post-norm residuals (EVA-CLIP giants), else pre-norm.

The patch conv is a reshape and a matmul (as models/clip_vit.py: the flax
(kh, kw, 3, C) kernel flattened to (C, kh*kw*3)), the cls token is
broadcast, the position table is re-gridded bicubically
(models/resampler.py `interp_abs_pos`, jax.image.resize's function) when
the image's grid differs from the table's, and only depth - 1 blocks run.
Attention is plain torch (ops/attention.py `dense_attention`, the JAX
module's fp32-accumulated einsums): the head dim, 1792 / 16 = 112, is
outside the flash kernel's domain. `quantize` builds the projections as
QuantDense with their biases (int8 or int4 as `quantize_bits` says), the
int8 kernels #9 / #7 or the int4 kernel #11 on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense, LayerNorm
from rlaifv_tpu_torch.models.llama import QuantDense
from rlaifv_tpu_torch.models.resampler import interp_abs_pos
from rlaifv_tpu_torch.ops.attention import dense_attention
from rlaifv_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class EvaConfig:
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1792
    depth: int = 64
    num_heads: int = 16
    mlp_hidden: int = 15360
    use_rope: bool = False
    use_swiglu: bool = False
    subln: bool = False
    qkv_fused: bool = True
    use_post_norm: bool = False
    ln_eps: float = 1e-6
    num_prefix_tokens: int = 1  # cls token
    quantize: bool = False  # weight-only projections (QuantDense, with bias)
    quantize_bits: int = 8  # 4: nibble-packed int4 + group-128 scales
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def enormous(**kw) -> "EvaConfig":
        return EvaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "EvaConfig":
        base = dict(
            image_size=28, patch_size=7, embed_dim=32, depth=3,
            num_heads=4, mlp_hidden=64,
        )
        base.update(kw)
        return EvaConfig(**base)


def _dense(cfg: EvaConfig, n_in: int, n_out: int, bias: bool, device):
    if cfg.quantize:
        return QuantDense(n_in, n_out, dtype=cfg.dtype, bits=cfg.quantize_bits,
                          bias=bias, param_dtype=cfg.param_dtype, device=device)
    return Dense(n_in, n_out, bias=bias, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                 init_std=n_in ** -0.5, device=device)


def _ln(cfg: EvaConfig, dim: int, device) -> LayerNorm:
    return LayerNorm(dim, cfg.ln_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                     device=device)


def rope_2d(grid_h: int, grid_w: int, head_dim: int, theta: float = 100.0):
    """EVA02 axial 2D rotary tables over the patch grid: (cos, sin), each
    (grid_h * grid_w, head_dim) fp32 numpy."""
    dim_half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim_half, 2) / dim_half))
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    ang = np.concatenate([ys.reshape(-1, 1) * freqs[None],
                          xs.reshape(-1, 1) * freqs[None]], axis=1)
    emb = np.concatenate([ang, ang], axis=1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


class EvaAttention(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        if cfg.qkv_fused:
            self.qkv = _dense(cfg, D, 3 * D, True, device)
        else:  # the EVA02 convention: q and v have a bias, k does not
            self.q_proj = _dense(cfg, D, D, True, device)
            self.k_proj = _dense(cfg, D, D, False, device)
            self.v_proj = _dense(cfg, D, D, True, device)
        self.proj = _dense(cfg, D, D, True, device)

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        cfg = self.cfg
        B, L, D = x.shape
        H = cfg.num_heads
        if cfg.qkv_fused:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (t.reshape(B, L, H, D // H) for t in (q, k, v))
        if rope is not None:
            q, k = self._rope(q, rope), self._rope(k, rope)
        out = dense_attention(q, k, v, None).reshape(B, L, D).to(cfg.dtype)
        return self.proj(out)

    def _rope(self, t: torch.Tensor, rope) -> torch.Tensor:
        """Rotate-half rope on the patch tokens, the prefix tokens passed
        through; the fp32 tables promote the result to fp32, as in JAX."""
        cos, sin = rope  # (L_patches, hd) fp32
        npre = self.cfg.num_prefix_tokens
        tp = t[:, npre:]
        half = tp.shape[-1] // 2
        rotated = torch.cat([-tp[..., half:], tp[..., :half]], dim=-1)
        tp = tp * cos[None, :, None, :] + rotated * sin[None, :, None, :]
        return torch.cat([t[:, :npre].to(tp.dtype), tp], dim=1)


class EvaMlp(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, I = cfg.embed_dim, cfg.mlp_hidden
        if cfg.use_swiglu:
            self.w1 = _dense(cfg, D, I, True, device)
            self.w2 = _dense(cfg, D, I, True, device)
            self.ffn_ln = _ln(cfg, I, device) if cfg.subln else None
            self.w3 = _dense(cfg, I, D, True, device)
        else:
            self.fc1 = _dense(cfg, D, I, True, device)
            self.fc2 = _dense(cfg, I, D, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_swiglu:
            h = F.silu(self.w1(x)) * self.w2(x)
            if self.ffn_ln is not None:
                h = self.ffn_ln(h)
            return self.w3(h)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class EvaBlock(nn.Module):
    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.post_norm = cfg.use_post_norm
        self.norm1 = _ln(cfg, cfg.embed_dim, device)
        self.attn = EvaAttention(cfg, device)
        self.norm2 = _ln(cfg, cfg.embed_dim, device)
        self.mlp = EvaMlp(cfg, device)

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        if self.post_norm:
            x = x + self.norm1(self.attn(x, rope))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class EvaVisionTower(nn.Module):
    """Images (B, H, W, 3), normalised -> the features of block depth - 1
    (B, H/p * W/p, embed_dim), prefix tokens stripped."""

    def __init__(self, cfg: EvaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        p, C, pdt = cfg.patch_size, cfg.embed_dim, cfg.param_dtype
        # the flax (kh, kw, 3, C) conv kernel flattened to (C, kh*kw*3)
        self.patch_embed = Dense(p * p * 3, C, bias=True, dtype=cfg.dtype, param_dtype=pdt,
                                 init_std=(p * p * 3) ** -0.5, device=device)
        self.cls_token = nn.Parameter(torch.zeros(C, dtype=pdt, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.grid ** 2 + cfg.num_prefix_tokens, C, dtype=pdt, device=device))
        # the last block is dead weight in the reference (replaced by Identity)
        self.blocks = nn.ModuleList(EvaBlock(cfg, device) for _ in range(cfg.depth - 1))
        self.norm = _ln(cfg, C, device)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The flax initialisers of cls_token and pos_embed: N(0, 0.02)."""
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, gh*gw, p*p*3), each patch row-major over
        (kh, kw, channel) like the flax conv kernel."""
        B, Himg, Wimg, _ = images.shape
        p = self.cfg.patch_size
        gh, gw = Himg // p, Wimg // p
        x = images[:, : gh * p, : gw * p].reshape(B, gh, p, gw, p, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * 3)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, Himg, Wimg, _ = images.shape
        gh, gw = Himg // cfg.patch_size, Wimg // cfg.patch_size
        x = self.patch_embed(self.patchify(images.to(cfg.dtype)))
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1)
        pos = self.pos_embed.to(cfg.dtype)
        npre = cfg.num_prefix_tokens
        pos_patch = pos[npre:]
        if gh * gw != pos_patch.shape[0]:
            pos_patch = interp_abs_pos(pos_patch, gh * gw)
        x = x + torch.cat([pos[:npre], pos_patch])[None]
        rope = None
        if cfg.use_rope:
            rope = tuple(to_device(t, x.device)
                         for t in rope_2d(gh, gw, cfg.embed_dim // cfg.num_heads))
        for blk in self.blocks:
            x = blk(x, rope)
        return self.norm(x)[:, npre:]
