"""Building blocks shared by the towers: flax-style Dense and LayerNorm.

flax modules keep parameters in `param_dtype` and compute in `dtype`; these
do the same, so a bf16 model and an fp32 model are one code path. Each
Dense records the std of its flax `kernel_init` (`init_std`), which
`init_weights_` (models/llava.py) uses to draw random weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def lora_side_term(x: torch.Tensor, lora) -> torch.Tensor:
    """(x @ a) @ b in x's dtype for an adapter pair a (in, r), b (r, out)
    whose alpha/r scale is already folded into b (train/lora.py
    `lora_scaled`): the JAX package's LoraDense / QuantDense side term."""
    a, b = lora
    return (x @ a.to(x.dtype)) @ b.to(x.dtype)


class Dense(nn.Linear):
    """y = x @ W^T (+ b), computed in `dtype`; weight (out, in) is the
    transpose of the flax (in, out) kernel. `lora`, when set to an adapter
    pair (train/lora.py `attach_lora`), adds the low-rank side term: the
    JAX package's LoraDense reading its "lora" collection. `tp`, set by
    parallel/sharding.py's `shard_params`, makes the layer hold its tensor-
    parallel slice and compute through it."""

    tp = None

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 init_std: float, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype
        self.init_std = init_std
        self.lora = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if self.tp is not None:
            return self.tp.linear(self, x)
        bias = self.bias.to(dt) if self.bias is not None else None
        y = F.linear(x, self.weight.to(dt), bias)
        return y if self.lora is None else y + lora_side_term(x, self.lora)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: statistics in fp32, output cast to `dtype`."""

    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)
