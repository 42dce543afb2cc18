"""SigLIP vision tower in PyTorch: MiniCPM-Llama3-V 2.5's image encoder.

Counterpart of rlaifv_tpu/models/siglip.py (SigLIP-so400m: 27 pre-norm
blocks of width 1152, 16 heads, a gelu-tanh MLP of 4304, the final
LayerNorm `post_ln`; no class token). MiniCPM-V feeds it slices of varying
shape, so a slice's (gh, gw) patch grid rarely matches the 70 x 70
position table: the table is then re-gridded to (gh, gw) by
jax.image.resize's bicubic function (antialiased where it shrinks), one
weight matrix an axis from models/resampler.py `bicubic_weights`, in fp32,
cast to the tower's dtype. As in the JAX module, a slice whose gh * gw
equals the table's length takes the table as it is.

The stride-14 patch conv is a reshape and a matmul (as models/clip_vit.py
and models/eva02.py: the flax (kh, kw, 3, C) kernel flattened to
(C, kh*kw*3)). Attention is plain torch (ops/attention.py
`dense_attention`, the JAX module's impl="dense"): the head dim, 1152 / 16
= 72, is outside the flash kernel's domain.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense, LayerNorm
from rlaifv_tpu_torch.models.resampler import bicubic_weights
from rlaifv_tpu_torch.ops.attention import dense_attention
from rlaifv_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 980
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def so400m(**kw) -> "SiglipVisionConfig":
        return SiglipVisionConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "SiglipVisionConfig":
        base = dict(
            image_size=28, patch_size=7, hidden_size=32,
            intermediate_size=64, num_layers=2, num_heads=4,
        )
        base.update(kw)
        return SiglipVisionConfig(**base)


def regrid_pos(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bicubic re-grid of a square (src², D) position table to (gh * gw, D):
    rows by bicubic_weights(src, gh), columns by bicubic_weights(src, gw),
    in fp32, cast back to the table's dtype."""
    src = int(round(pos.shape[0] ** 0.5))
    wh = to_device(bicubic_weights(src, gh), pos.device)
    ww = to_device(bicubic_weights(src, gw), pos.device)
    out = torch.einsum("ia,jb,abd->ijd", wh, ww, pos.reshape(src, src, -1).float())
    return out.reshape(gh * gw, -1).to(pos.dtype)


class SiglipBlock(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, I = cfg.hidden_size, cfg.intermediate_size
        ln = lambda: LayerNorm(D, cfg.layer_norm_eps, dtype=cfg.dtype,  # noqa: E731
                               param_dtype=cfg.param_dtype, device=device)
        dense = lambda n_in, n_out: Dense(  # noqa: E731
            n_in, n_out, bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            init_std=n_in ** -0.5, device=device)
        self.ln1 = ln()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (dense(D, D) for _ in range(4))
        self.ln2 = ln()
        self.fc1 = dense(D, I)
        self.fc2 = dense(I, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.cfg.num_heads
        h = self.ln1(x)
        q, k, v = (p(h).reshape(B, L, H, D // H) for p in (self.q_proj, self.k_proj,
                                                             self.v_proj))
        attn = dense_attention(q, k, v, None).reshape(B, L, D)
        x = x + self.out_proj(attn)
        h = self.fc1(self.ln2(x))
        return x + self.fc2(F.gelu(h, approximate="tanh"))  # gelu_pytorch_tanh


class SiglipVisionTower(nn.Module):
    """(B, H, W, 3) normalised pixels -> (B, H/p * W/p, hidden); no prefix
    tokens."""

    def __init__(self, cfg: SiglipVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        p, C, pdt = cfg.patch_size, cfg.hidden_size, cfg.param_dtype
        # the flax (kh, kw, 3, C) conv kernel flattened to (C, kh*kw*3)
        self.patch_embed = Dense(p * p * 3, C, bias=True, dtype=cfg.dtype, param_dtype=pdt,
                                 init_std=(p * p * 3) ** -0.5, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.grid ** 2, C, dtype=pdt, device=device))
        self.layers = nn.ModuleList(SiglipBlock(cfg, device) for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(C, cfg.layer_norm_eps, dtype=cfg.dtype, param_dtype=pdt,
                                 device=device)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The flax initialiser of pos_embed: N(0, 0.02)."""
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
        _, Himg, Wimg, _ = images.shape
        gh, gw = Himg // cfg.patch_size, Wimg // cfg.patch_size
        x = self.patch_embed(self.patchify(images.to(cfg.dtype)))
        pos = self.pos_embed.to(cfg.dtype)
        if gh * gw != pos.shape[0]:
            pos = regrid_pos(pos, gh, gw)
        x = x + pos[None]
        for layer in self.layers:
            x = layer(x)
        return self.post_ln(x)
