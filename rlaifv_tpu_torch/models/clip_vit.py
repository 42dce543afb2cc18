"""CLIP ViT vision tower in PyTorch - LLaVA-1.5's image encoder.

Counterpart of rlaifv_tpu/models/clip_vit.py: quick-GELU, pre-layernorm
ViT, learned position embeddings, the hidden-layer -2 tap taken by running
only `layers_to_run` blocks. The stride-14 patch embedding is a reshape and
a matmul rather than a convolution, so cuDNN's default TF32 convolutions
never enter a float32 run.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense, LayerNorm
from rlaifv_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    select_layer: int = -2  # hidden-state tap (HF indexing over L+1 states)
    select_feature: str = "patch"  # "patch" drops CLS; "cls_patch" keeps it
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    image_mean: Any = (0.48145466, 0.4578275, 0.40821073)  # OPENAI_CLIP
    image_std: Any = (0.26862954, 0.26130258, 0.27577711)

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1

    @property
    def layers_to_run(self) -> int:
        """Blocks whose output feeds the tap (HF hidden_states has L+1
        entries; [-2] is the output of block L-1)."""
        idx = self.select_layer
        if idx < 0:
            idx = self.num_layers + 1 + idx
        return idx

    @staticmethod
    def clip_l_336(**kw) -> "CLIPVisionConfig":
        return CLIPVisionConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        base = dict(
            image_size=28,
            patch_size=7,
            hidden_size=32,
            intermediate_size=64,
            num_layers=3,
            num_heads=4,
        )
        base.update(kw)
        return CLIPVisionConfig(**base)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _dense(cfg: CLIPVisionConfig, n_in: int, n_out: int, device) -> Dense:
    return Dense(n_in, n_out, bias=True, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype, init_std=0.01, device=device)


def _ln(cfg: CLIPVisionConfig, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.q_proj = _dense(cfg, C, C, device)
        self.k_proj = _dense(cfg, C, C, device)
        self.v_proj = _dense(cfg, C, C, device)
        self.out_proj = _dense(cfg, C, C, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        H = self.cfg.num_heads
        q = self.q_proj(x).view(B, L, H, C // H)
        k = self.k_proj(x).view(B, L, H, C // H)
        v = self.v_proj(x).view(B, L, H, C // H)
        out = multi_head_attention(q, k, v, causal=False, impl="dense")
        return self.out_proj(out.reshape(B, L, C))


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.ln1 = _ln(cfg, device)
        self.attn = CLIPAttention(cfg, device)
        self.ln2 = _ln(cfg, device)
        self.fc1 = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.fc2 = _dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPVisionTower(nn.Module):
    """Images (B, H, W, 3) normalized -> patch features (B, P, hidden)."""

    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        p, C = cfg.patch_size, cfg.hidden_size
        # the flax (kh, kw, 3, C) conv kernel flattened to (C, kh*kw*3)
        self.patch_embed = Dense(p * p * 3, C, bias=False, dtype=cfg.dtype,
                                 param_dtype=cfg.param_dtype, init_std=0.02,
                                 device=device)
        self.cls_token = nn.Parameter(torch.zeros(C, dtype=cfg.param_dtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.num_positions, C, dtype=cfg.param_dtype, device=device))
        self.pre_ln = _ln(cfg, device)
        self.layers = nn.ModuleList(
            CLIPBlock(cfg, device) for _ in range(cfg.layers_to_run)
        )

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, n*n, p*p*3), each patch row-major over
        (kh, kw, channel) like the flax conv kernel."""
        B = images.shape[0]
        p, n = self.cfg.patch_size, self.cfg.num_patches_per_side
        x = images[:, : n * p, : n * p].reshape(B, n, p, n, p, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, p * p * 3)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(self.patchify(images.to(cfg.dtype)))
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)[None]
        x = self.pre_ln(x)
        for blk in self.layers:
            x = blk(x)
        if cfg.select_feature == "patch":
            return x[:, 1:]
        if cfg.select_feature == "cls_patch":
            return x
        raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
