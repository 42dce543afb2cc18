"""Vision->LLM multimodal projector ('linear', 'mlpNx_gelu', 'identity').

Counterpart of rlaifv_tpu/models/projector.py; the GELU between layers is
the exact erf form.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from rlaifv_tpu_torch.models.layers import Dense


class VisionProjector(nn.Module):
    def __init__(self, projector_type: str, in_features: int, out_features: int,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.projector_type = projector_type
        if projector_type == "identity":
            depth = 0
        elif projector_type == "linear":
            depth = 1
        elif m := re.match(r"^mlp(\d+)x_gelu$", projector_type):
            depth = int(m.group(1))
        else:
            raise ValueError(f"Unknown projector type: {projector_type}")
        self.fcs = nn.ModuleList(
            Dense(in_features if i == 0 else out_features, out_features,
                  bias=True, dtype=dtype, param_dtype=param_dtype,
                  init_std=0.02, device=device)
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.fcs):
            x = fc(F.gelu(x) if i else x)
        return x
