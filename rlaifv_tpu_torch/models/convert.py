"""Bridge from the JAX package's flax parameter trees to PyTorch state dicts.

`llava_params_from_jax` maps a `rlaifv_tpu.models.llava.LlavaForCausalLM`
param tree (nested dicts of arrays) onto the names of
`rlaifv_tpu_torch.models.llava.LlavaForCausalLM`, so both packages compute
the same function from the same weights:

- flax Dense `kernel` (in, out) -> `weight` (out, in);
- the flax patch Conv `kernel` (kh, kw, in, out) -> `weight` (out, kh*kw*in);
- LayerNorm/RMSNorm `scale` and Embed `embedding` -> `weight`;
- `layer_{i}` -> `layers.{i}`, projector `fc{i}` -> `fcs.{i}`.

Loading real HF checkpoints goes through the JAX package's converter
(rlaifv_tpu/models/convert.py) into such a tree first.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _torch_name(path: str) -> str:
    path = re.sub(r"\blayer_(\d+)\b", r"layers.\1", path)
    path = re.sub(r"^mm_projector\.fc(\d+)\.", r"mm_projector.fcs.\1.", path)
    return re.sub(r"\.(kernel|scale|embedding)$", ".weight", path)


def llava_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax LLaVA param tree (arrays of any numpy-convertible type) ->
    state dict for rlaifv_tpu_torch's LlavaForCausalLM. A variables dict
    that carries LoRA adapters ({"params", "lora"}) raises."""
    if "lora" in params:
        raise NotImplementedError(
            "LoRA adapters are not ported to rlaifv_tpu_torch yet: "
            "ROADMAP.md 'Modules to port' #2 (DPO train step)"
        )
    sd = {}
    for path, val in _flatten(params):
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes; torch cannot wrap it
            arr = arr.astype(np.float32)
        if path.endswith(".kernel"):
            if arr.ndim == 4:  # patch conv (kh, kw, in, out)
                arr = arr.reshape(-1, arr.shape[-1])
            arr = arr.T
        sd[_torch_name(path)] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax LLaVA param tree into `model` (strict: every name must
    match), converting to each parameter's dtype and device."""
    sd = llava_params_from_jax(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"param bridge mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(sd[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: {tuple(sd[name].shape)} != {tuple(t.shape)}")
            t.copy_(sd[name].to(dtype=t.dtype))
    return model
