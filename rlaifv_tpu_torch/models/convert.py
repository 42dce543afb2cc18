"""Bridge from the JAX package's flax parameter trees to PyTorch state dicts.

`llava_params_from_jax` maps a `rlaifv_tpu.models.llava.LlavaForCausalLM`
param tree (nested dicts of arrays) onto the names of
`rlaifv_tpu_torch.models.llava.LlavaForCausalLM`, so both packages compute
the same function from the same weights:

- flax Dense `kernel` (in, out) -> `weight` (out, in);
- the flax patch Conv `kernel` (kh, kw, in, out) -> `weight` (out, kh*kw*in);
- LayerNorm/RMSNorm `scale` and Embed `embedding` -> `weight`;
- `layer_{i}` -> `layers.{i}`, projector `fc{i}` -> `fcs.{i}`.

Real HF checkpoints load through `load_llava_checkpoint`, the numpy
converter of rlaifv_tpu/models/convert.py copied function for function
(`load_state_dict_dir`, `convert_llama`, `convert_clip_vision`,
`convert_llava`, `load_image_newline`): HF state dict -> the same flax-style
tree, then the bridge above. The train entry point builds its configs from
presets, as train.py does, so no config reader is needed. The quantizers
and the other families' converters are not copied: ROADMAP.md 'Modules to
port' #5, #9 and #10.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

Tree = Dict[str, Any]


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
            "ROADMAP.md 'Modules to port' #5 (QLoRA and LoRA adapters)"
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


def flax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """torch parameter name -> the last key of the flax leaf it bridges
    from: the inverse of `_torch_name`'s renaming, where a `.weight` was a
    Dense/Conv `kernel`, a norm `scale` or an Embed `embedding` and every
    other name (`bias`, `cls_token`, `pos_embed`) is kept."""
    from rlaifv_tpu_torch.models.layers import LayerNorm
    from rlaifv_tpu_torch.models.llama import RMSNorm

    kinds = ((nn.Linear, "kernel"), ((LayerNorm, RMSNorm), "scale"),
             (nn.Embedding, "embedding"))
    names = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            leaf = p_name
            if p_name == "weight":
                leaf = next(k for cls, k in kinds if isinstance(mod, cls))
            names[f"{mod_name}.{p_name}" if mod_name else p_name] = leaf
    return names


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


# ------------------------------------------------ HF checkpoints (numpy)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().to("cpu")
        # torch bf16 has no numpy dtype; go through float32
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _set(tree: Tree, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value



def load_state_dict_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """Read all safetensors (or torch .bin) shards from a checkpoint dir."""
    sd: Dict[str, np.ndarray] = {}
    st_files = sorted(
        f for f in os.listdir(model_dir) if f.endswith(".safetensors")
    )
    if st_files:
        from safetensors import safe_open

        for f in st_files:
            with safe_open(os.path.join(model_dir, f), framework="np") as h:
                for k in h.keys():
                    sd[k] = h.get_tensor(k)
        return sd
    bin_files = sorted(
        f for f in os.listdir(model_dir)
        if f.endswith(".bin") and f.startswith("pytorch_model")
    )
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin shards in {model_dir}")
    import torch

    for f in bin_files:
        shard = torch.load(
            os.path.join(model_dir, f), map_location="cpu", weights_only=True
        )
        for k, v in shard.items():
            sd[k] = _np(v)
    return sd


def convert_llama(
    sd: Mapping[str, Any], prefix: str = "", dtype=np.float32
) -> Tree:
    """HF LlamaForCausalLM state dict -> LlamaForCausalLM params."""
    g = lambda k: _np(sd[prefix + k]).astype(dtype)
    tree: Tree = {}
    _set(tree, "model/tok_embed/embedding", g("model.embed_tokens.weight"))
    layer_pat = re.compile(re.escape(prefix) + r"model\.layers\.(\d+)\.")
    n_layers = 1 + max(
        int(m.group(1)) for k in sd if (m := layer_pat.match(k))
    )
    for i in range(n_layers):
        hf = f"model.layers.{i}."
        fx = f"model/layer_{i}/"
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _set(tree, fx + f"attn/{name}/kernel", g(hf + f"self_attn.{name}.weight").T)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _set(tree, fx + f"mlp/{name}/kernel", g(hf + f"mlp.{name}.weight").T)
        _set(tree, fx + "ln_attn/scale", g(hf + "input_layernorm.weight"))
        _set(tree, fx + "ln_mlp/scale", g(hf + "post_attention_layernorm.weight"))
    _set(tree, "model/ln_f/scale", g("model.norm.weight"))
    if prefix + "lm_head.weight" in sd:
        _set(tree, "lm_head/kernel", g("lm_head.weight").T)
    return tree


def convert_clip_vision(
    sd: Mapping[str, Any], prefix: str = "vision_model.", dtype=np.float32,
    layers_to_run: Optional[int] = None,
) -> Tree:
    """HF CLIPVisionModel state dict -> CLIPVisionTower params.

    Only the first `layers_to_run` blocks are converted (the select_layer=-2
    tap means the final block's weights are dead, clip_encoder.py:36-44).
    """
    g = lambda k: _np(sd[prefix + k]).astype(dtype)
    tree: Tree = {}
    _set(tree, "cls_token", g("embeddings.class_embedding"))
    # (D, 3, P, P) conv -> (P, P, 3, D) flax HWIO
    _set(
        tree, "patch_embed/kernel",
        g("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0),
    )
    _set(tree, "pos_embed", g("embeddings.position_embedding.weight"))
    _set(tree, "pre_ln/scale", g("pre_layrnorm.weight"))
    _set(tree, "pre_ln/bias", g("pre_layrnorm.bias"))

    layer_pat = re.compile(re.escape(prefix) + r"encoder\.layers\.(\d+)\.")
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := layer_pat.match(k)))
    if layers_to_run is not None:
        n_layers = min(n_layers, layers_to_run)
    for i in range(n_layers):
        hf = f"encoder.layers.{i}."
        fx = f"layer_{i}/"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _set(tree, fx + f"attn/{name}/kernel", g(hf + f"self_attn.{name}.weight").T)
            _set(tree, fx + f"attn/{name}/bias", g(hf + f"self_attn.{name}.bias"))
        _set(tree, fx + "ln1/scale", g(hf + "layer_norm1.weight"))
        _set(tree, fx + "ln1/bias", g(hf + "layer_norm1.bias"))
        _set(tree, fx + "ln2/scale", g(hf + "layer_norm2.weight"))
        _set(tree, fx + "ln2/bias", g(hf + "layer_norm2.bias"))
        _set(tree, fx + "fc1/kernel", g(hf + "mlp.fc1.weight").T)
        _set(tree, fx + "fc1/bias", g(hf + "mlp.fc1.bias"))
        _set(tree, fx + "fc2/kernel", g(hf + "mlp.fc2.weight").T)
        _set(tree, fx + "fc2/bias", g(hf + "mlp.fc2.bias"))
    return tree


def convert_llava(
    sd: Mapping[str, Any], dtype=np.float32, vision_layers_to_run: Optional[int] = None
) -> Tree:
    """Composite LLaVA-1.5 checkpoint -> LlavaForCausalLM params.

    Key layout in reference checkpoints (llava/model/language_model/
    llava_llama.py registers LlavaLlamaForCausalLM under the Llama arch):
      model.embed_tokens.* / model.layers.* / model.norm.* / lm_head.*
      model.vision_tower.vision_tower.vision_model.*
      model.mm_projector.{0,2}.{weight,bias}   (mlp2x_gelu: Linear-GELU-Linear)
    """
    llm_sd = {
        k: v for k, v in sd.items()
        if not k.startswith(("model.vision_tower", "model.mm_projector"))
    }
    tree: Tree = {"llm": convert_llama(llm_sd, dtype=dtype)}

    tree["vision_tower"] = convert_clip_vision(
        sd,
        prefix="model.vision_tower.vision_tower.vision_model.",
        dtype=dtype,
        layers_to_run=vision_layers_to_run,
    )

    proj: Tree = {}
    # torch Sequential indices 0,2,4... are the Linear layers of mlpNx_gelu
    proj_keys = sorted(
        {int(m.group(1)) for k in sd
         if (m := re.match(r"model\.mm_projector\.(\d+)\.weight", k))}
    )
    for out_i, seq_i in enumerate(proj_keys):
        proj[f"fc{out_i}"] = {
            "kernel": _np(sd[f"model.mm_projector.{seq_i}.weight"]).astype(dtype).T,
            "bias": _np(sd[f"model.mm_projector.{seq_i}.bias"]).astype(dtype),
        }
    tree["mm_projector"] = proj
    return tree


def load_image_newline(model_dir: str) -> Optional[np.ndarray]:
    """LLaVA-1.6 checkpoints carry a learnable `model.image_newline` (D,)
    used by the spatial_unpad anyres merge. Lazy single-tensor read."""
    key = "model.image_newline"
    for fname in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, fname)
        if fname.endswith(".safetensors"):
            from safetensors import safe_open

            with safe_open(path, framework="np") as f:
                if key in f.keys():
                    return np.asarray(f.get_tensor(key))
        elif fname.endswith(".bin"):
            import torch

            sd = torch.load(path, map_location="cpu", weights_only=True)
            if key in sd:
                return sd[key].float().numpy()
    return None


def load_llava_checkpoint(model_dir: str, dtype=np.float32,
                          vision_layers_to_run: Optional[int] = None) -> Tree:
    return convert_llava(load_state_dict_dir(model_dir), dtype=dtype,
                         vision_layers_to_run=vision_layers_to_run)
