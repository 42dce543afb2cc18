"""Bridge from the JAX package's flax parameter trees to PyTorch state dicts.

`llava_params_from_jax` maps a `rlaifv_tpu.models.llava.LlavaForCausalLM`
param tree (nested dicts of arrays) onto the names of
`rlaifv_tpu_torch.models.llava.LlavaForCausalLM`, so both packages compute
the same function from the same weights:

- flax Dense `kernel` (in, out) -> `weight` (out, in);
- the flax patch Conv `kernel` (kh, kw, in, out) -> `weight` (out, kh*kw*in);
- LayerNorm/RMSNorm `scale` and Embed `embedding` -> `weight`;
- `layer_{i}` -> `layers.{i}`, projector `fc{i}` -> `fcs.{i}`;
- an int8 QuantDense node {kernel (in, out) int8, scale (out,)} -> the
  port's QuantDense buffers `q` (the same layout) and `scale`;
- a flax variables dict {"params", "lora"}: the base from "params"; the
  adapters cross with `lora_from_jax`.

`flax_tree` is the inverse view (the model's tensors under the flax names,
kernels as (in, out)), which train/lora.py walks. `quantize_llm_int8`
quantises a model's LLM projections to int8 in place, on their device,
with `quantize_kernel_int8_torch`, bit for bit the JAX package's numpy
`quantize_kernel_int8`.

Real HF checkpoints load through `load_llava_checkpoint`, the numpy
converter of rlaifv_tpu/models/convert.py copied function for function
(`load_state_dict_dir`, `convert_llama`, `convert_clip_vision`,
`convert_llava`, `load_image_newline`): HF state dict -> the same flax-style
tree, then the bridge above. The train entry point builds its configs from
presets, as train.py does, so no config reader is needed. The int4
quantizer and the other families' converters are not copied: ROADMAP.md
'Modules to port' #5 (int4), #9 and #10.
"""
from __future__ import annotations

import dataclasses
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


def _quant_modules(tree: Mapping[str, Any], prefix: str = "") -> set:
    """Dotted paths of the int8 QuantDense nodes ({kernel: int8 (in, out),
    scale: (out,)}); an int4 node (2-D group scales) raises."""
    out = set()
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            continue
        kernel = val.get("kernel")
        if kernel is not None and not isinstance(kernel, Mapping) \
                and _np(kernel).dtype == np.int8:
            if np.ndim(val.get("scale")) != 1:
                raise NotImplementedError(
                    f"{prefix}{key}: int4 weights are not ported to rlaifv_tpu_torch "
                    "yet: ROADMAP.md 'Modules to port' #5 (int4, kernels #11-#12)")
            out.add(prefix + key)
        else:
            out |= _quant_modules(val, f"{prefix}{key}.")
    return out


def llava_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax LLaVA param tree (arrays of any numpy-convertible type, or
    torch tensors, as `flax_tree` gives them) ->
    state dict for rlaifv_tpu_torch's LlavaForCausalLM. int8 QuantDense
    nodes become `q`/`scale` buffers; given a variables dict {"params",
    "lora"}, the state dict of its base (the adapters: `lora_from_jax`)."""
    if set(params) == {"params", "lora"}:
        params = params["params"]
    quant = _quant_modules(params)
    sd = {}
    for path, val in _flatten(params):
        arr = _np(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes; torch cannot wrap it
            arr = arr.astype(np.float32)
        module, _, leaf = path.rpartition(".")
        if module in quant:  # QuantDense keeps the flax (in, out) layout
            name = _torch_name(f"{module}.kernel")[:-len("weight")]
            sd[name + ("q" if leaf == "kernel" else leaf)] = torch.from_numpy(
                np.array(arr, order="C"))
            continue
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


def lora_from_jax(lora: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's adapter tree {.../q_proj: {a (in, r), b (r, out)}}
    -> the port's (train/lora.py): the same nesting and layout, fp32 torch
    tensors."""
    return {k: lora_from_jax(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(np.asarray(v), dtype=np.float32))
            for k, v in lora.items()}


def _flax_module_path(torch_name: str) -> str:
    """`llm.model.layers.0.attn.q_proj` -> `llm/model/layer_0/attn/q_proj`."""
    path = re.sub(r"\blayers\.(\d+)\b", r"layer_\1", torch_name)
    path = re.sub(r"^mm_projector\.fcs\.(\d+)\b", r"mm_projector.fc\1", path)
    return path.replace(".", "/")


def torch_module_name(flax_path: str) -> str:
    """`llm/model/layer_0/attn/q_proj` -> `llm.model.layers.0.attn.q_proj`."""
    return _torch_name(flax_path.replace("/", ".") + ".kernel")[:-len(".weight")]


def flax_tree(model: nn.Module) -> Tree:
    """The model's parameters and buffers as the JAX package's param tree:
    the flax names (`layers.{i}` -> `layer_{i}`, `weight` -> `kernel`/
    `scale`/`embedding`), Dense weights as (in, out) kernels (transposed
    views; the patch conv flattened to 2-D), QuantDense `q`/`scale` as
    `kernel`/`scale`. The leaves share storage with the model."""
    from rlaifv_tpu_torch.models.llama import QuantDense

    leaves = flax_leaf_names(model)
    tree: Tree = {}
    for mod_name, mod in model.named_modules():
        prefix = _flax_module_path(mod_name) + "/" if mod_name else ""
        if isinstance(mod, QuantDense):
            _set(tree, prefix + "kernel", mod.q)
            _set(tree, prefix + "scale", mod.scale)
            continue
        for name, t in mod.named_parameters(recurse=False):
            leaf = leaves[f"{mod_name}.{name}" if mod_name else name]
            _set(tree, prefix + leaf, t.T if leaf == "kernel" else t)
    return tree


def quantize_kernel_int8_torch(kernel: torch.Tensor):
    """(in, out) float kernel -> (int8 (in, out), fp32 (out,) scale) on the
    kernel's device: models/llama.py's `quantize_kernel_int8` (the JAX
    package's numpy quantiser) bit for bit, with tensor-by-tensor IEEE
    divisions (torch multiplies by the reciprocal of a Python-scalar
    divisor) and round half to even."""
    w = kernel.detach().float()
    amax = w.abs().amax(dim=0)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    q = torch.round(w / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return q.contiguous(), scale  # a transposed view in gives row-major (in, out) out


_QUANT_PROJ = re.compile(
    r"^(q_proj|k_proj|v_proj|o_proj|out_proj|gate_proj|up_proj|down_proj|"
    r"lm_head)$"
)


@torch.no_grad()
def quantize_llm_int8(model: nn.Module, include_lm_head: bool = True) -> nn.Module:
    """Weight-only int8 for the LLM's projections, in place (the JAX
    package's `quantize_llm_int8` over the port's modules): each bias-free
    Dense named q/k/v/o_proj, gate/up/down_proj (and lm_head with
    include_lm_head) becomes a QuantDense whose `q`/`scale` come from
    `quantize_kernel_int8_torch` on the weight's device; the float weight
    is dropped. `model` is a LlavaForCausalLM (its `llm` is quantised) or a
    LlamaForCausalLM; the configs it carries are updated to say so.
    include_lm_head=False keeps the head bf16, as QLoRA training does (the
    fused and compact heads read it as a matrix)."""
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import LlamaConfig, QuantDense

    llm = getattr(model, "llm", model)
    targets = [name for name, mod in llm.named_modules()
               if isinstance(mod, Dense) and mod.bias is None
               and _QUANT_PROJ.match(name.rsplit(".", 1)[-1])
               and (include_lm_head or name != "lm_head")]
    for name in targets:  # one float weight alive at a time
        dense = llm.get_submodule(name)
        q, scale = quantize_kernel_int8_torch(dense.weight.T)
        quant = QuantDense(dense.in_features, dense.out_features,
                           dtype=dense.compute_dtype, device="meta")
        quant.q, quant.scale = q, scale
        parent, _, attr = name.rpartition(".")
        setattr(llm.get_submodule(parent), attr, quant)
    for mod in model.modules():
        cfg = getattr(mod, "cfg", None)
        if isinstance(cfg, LlamaConfig):
            mod.cfg = dataclasses.replace(cfg, quantize=True, quantize_bits=8,
                                          quantize_lm_head=include_lm_head)
        elif isinstance(getattr(cfg, "llm", None), LlamaConfig):
            mod.cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
                cfg.llm, quantize=True, quantize_bits=8,
                quantize_lm_head=include_lm_head))
    return model


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
