"""Bridge from the JAX package's flax parameter trees to PyTorch state dicts.

`llava_params_from_jax` maps a `rlaifv_tpu.models.llava.LlavaForCausalLM`
param tree (nested dicts of arrays) onto the names of
`rlaifv_tpu_torch.models.llava.LlavaForCausalLM`, and
`llama_params_from_jax` a bare `rlaifv_tpu.models.llama.LlamaForCausalLM`
tree (the divide-and-conquer stage's Llama3-8B) onto the port's
LlamaForCausalLM, so both packages compute the same function from the same
weights:

- flax Dense `kernel` (in, out) -> `weight` (out, in);
- the flax patch Conv `kernel` (kh, kw, in, out) -> `weight` (out, kh*kw*in);
- LayerNorm/RMSNorm `scale` and Embed `embedding` -> `weight`;
- `layer_{i}` -> `layers.{i}`, projector `fc{i}` -> `fcs.{i}`;
- a QuantDense node, int8 {kernel (in, out) int8, scale (out,)} or int4
  {kernel (in/2, out) int8 nibble-packed, scale (in/G, out)} -> the port's
  QuantDense buffers `q` (the same layout) and `scale`;
- a flax variables dict {"params", "lora"}: the base from "params"; the
  adapters cross with `lora_from_jax`;
- a fused tree (`fuse_llm_projections`: `qkv_proj`, `gate_up_proj`) onto a
  model built with `fuse_proj=True`, float or quantised alike.

`flax_tree` is the inverse view (the model's tensors under the flax names,
kernels as (in, out)), which train/lora.py walks. `quantize_llm_int8` and
`quantize_llm_int4` quantise a model's LLM projections in place, on their
device, with `quantize_kernel_int8_torch` and `quantize_int4_torch`, bit
for bit the JAX package's numpy `quantize_kernel_int8` and
`quantize_int4`. `fuse_llm_projections_` fuses a model's q/k/v and gate/up
projections in place, as the JAX package's numpy `fuse_llm_projections`
(copied here) rewrites a tree; `set_llm_config` replaces fields of every
LlamaConfig a model carries (e.g. kv_cache_dtype).

Real HF checkpoints load through `load_llava_checkpoint`, the numpy
converter of rlaifv_tpu/models/convert.py copied function for function
(`load_state_dict_dir`, `convert_llama`, `convert_clip_vision`,
`convert_llava`, `load_image_newline`): HF state dict -> the same flax-style
tree, then the bridge above; a bare HF Llama checkpoint goes through
`convert_llama` and `llama_params_from_jax`, and `llama_config_from_hf`
reads its config.json. `llava_config_from_hf` and `clip_config_from_hf`
read a LLaVA's or a CLIP tower's config.json into the port's configs, and
`load_pretrained_llava` (with `_merge_tree`, `convert_peft_lora` and the
numpy `_quantize_llm_tree`) loads the full, LoRA-over-base and
projector-only layouts as the JAX function does. The train entry point
builds its configs from presets, as train.py does. OmniLMM-12B checkpoints
go through `convert_omnilmm` (`convert_llama`, `convert_eva02` and
models/resampler.py's `convert_resampler`) and `omnilmm_config_from_hf`,
then the same bridge (the EVA blocks `block_{i}` -> `blocks.{i}`);
`quantize_vision_int8` / `quantize_vision_int4` quantise the EVA tower's
projections in place, biases kept, and `set_vision_config` replaces
fields of every EvaConfig a model carries. MiniCPM-Llama3-V 2.5
checkpoints go through `convert_minicpmv` (`convert_llama` under llm.*,
`convert_siglip` under vpm.*, `convert_resampler` without a query-side
table) and `minicpmv_config_from_hf`, then the same bridge (the SigLIP
blocks `layer_{i}` -> `layers.{i}`); the tower stays float when the LLM is
quantised.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.ops.int4_matmul import INT4_GROUP, pack_int4_torch, pick_int4_group

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
    path = re.sub(r"\bblock_(\d+)\b", r"blocks.\1", path)  # the EVA02 tower
    path = re.sub(r"^mm_projector\.fc(\d+)\.", r"mm_projector.fcs.\1.", path)
    return re.sub(r"\.(kernel|scale|embedding)$", ".weight", path)


def _quant_modules(tree: Mapping[str, Any], prefix: str = "") -> set:
    """Dotted paths of the QuantDense nodes: an int8 `kernel` beside its
    `scale` ((out,) for int8 weights, (in/G, out) for packed int4)."""
    out = set()
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            continue
        kernel = val.get("kernel")
        if kernel is not None and not isinstance(kernel, Mapping) \
                and _np(kernel).dtype == np.int8:
            if np.ndim(val.get("scale")) not in (1, 2):
                raise ValueError(f"{prefix}{key}: an int8 kernel needs a 1-D (int8) or "
                                 "2-D (int4) scale")
            out.add(prefix + key)
        else:
            out |= _quant_modules(val, f"{prefix}{key}.")
    return out


def _bridge(params: Mapping[str, Any]):
    """(torch name, flax leaf, is a Dense/Conv kernel) for every leaf of a
    flax param tree, in tree order; QuantDense leaves keep their layout."""
    if set(params) == {"params", "lora"}:
        params = params["params"]
    quant = _quant_modules(params)
    for path, val in _flatten(params):
        module, _, leaf = path.rpartition(".")
        if module in quant:  # QuantDense keeps the flax (in, out) layout
            name = _torch_name(f"{module}.kernel")[:-len("weight")]
            yield name + ("q" if leaf == "kernel" else leaf), val, False
        else:
            yield _torch_name(path), val, path.endswith(".kernel")


def _bridged_tensor(val, kernel: bool) -> torch.Tensor:
    arr = _np(val)
    if arr.dtype.name == "bfloat16":  # ml_dtypes; torch cannot wrap it
        arr = arr.astype(np.float32)
    if kernel:
        if arr.ndim == 4:  # patch conv (kh, kw, in, out)
            arr = arr.reshape(-1, arr.shape[-1])
        arr = arr.T
    return torch.from_numpy(np.array(arr, order="C"))


def llava_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax LLaVA param tree (arrays of any numpy-convertible type, or
    torch tensors, as `flax_tree` gives them) ->
    state dict for rlaifv_tpu_torch's LlavaForCausalLM. QuantDense nodes
    (int8 or int4) become `q`/`scale` buffers (and `bias`, the vision
    towers'); given a variables dict {"params", "lora"}, the state dict of
    its base (the adapters: `lora_from_jax`). A flax OmniLMMForCausalLM
    tree maps the same way onto the port's: the EVA02 blocks `block_{i}`
    -> `blocks.{i}`, the resampler's raw (D, D) `proj` kept as it is."""
    return {name: _bridged_tensor(val, kernel) for name, val, kernel in _bridge(params)}


def llama_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A bare flax LlamaForCausalLM param tree ({"model": {tok_embed,
    layer_{i}, ln_f}, "lm_head"}) -> state dict for the port's
    LlamaForCausalLM. The mapping is `llava_params_from_jax`'s: a LLaVA
    tree holds this one under "llm"."""
    return llava_params_from_jax(params)


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
    path = re.sub(r"\bblocks\.(\d+)\b", r"block_\1", path)
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
            if mod.bias is not None:
                _set(tree, prefix + "bias", mod.bias)
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


def quantize_int4_torch(kernel: torch.Tensor, group: int = INT4_GROUP):
    """(in, out) float kernel -> (packed int8 (in/2, out), fp32 (in/group,
    out) scales) on the kernel's device: ops/int4_matmul.py's numpy
    `quantize_int4` (the JAX package's) bit for bit, with tensor-by-tensor
    IEEE divisions and round half to even."""
    w = kernel.detach().float()
    K, N = w.shape
    if K % group or group % 2:
        raise ValueError(f"K={K} not a multiple of even group={group}")
    g = w.reshape(K // group, group, N)
    amax = g.abs().amax(dim=1)
    scale = torch.clamp_min(amax / torch.full_like(amax, 7.0), 1e-8)
    q = torch.round(g / scale[:, None, :]).clamp_(-7, 7).to(torch.int8)
    return pack_int4_torch(q.reshape(K, N), group), scale


_QUANT_PROJ = re.compile(
    r"^(q_proj|k_proj|v_proj|o_proj|out_proj|gate_proj|up_proj|down_proj|"
    r"qkv_proj|gate_up_proj|lm_head)$"
)


def _set_config(model: nn.Module, kind: type, sub: str, fields: dict) -> nn.Module:
    """Replace `fields` of every `kind` config `model` carries (its modules'
    `cfg`, or the `sub` field of a composite model's), in place."""
    for mod in model.modules():
        cfg = getattr(mod, "cfg", None)
        if isinstance(cfg, kind):
            mod.cfg = dataclasses.replace(cfg, **fields)
        elif isinstance(getattr(cfg, sub, None), kind):
            mod.cfg = dataclasses.replace(
                cfg, **{sub: dataclasses.replace(getattr(cfg, sub), **fields)})
    return model


def set_llm_config(model: nn.Module, **fields) -> nn.Module:
    """Replace `fields` of every LlamaConfig `model` carries (its modules'
    `cfg`, or a LlavaConfig's / OmniLMMConfig's `llm`), in place."""
    from rlaifv_tpu_torch.models.llama import LlamaConfig

    return _set_config(model, LlamaConfig, "llm", fields)


def set_vision_config(model: nn.Module, **fields) -> nn.Module:
    """Replace `fields` of every EvaConfig `model` carries (its modules'
    `cfg`, or an OmniLMMConfig's `vision`), in place."""
    from rlaifv_tpu_torch.models.eva02 import EvaConfig

    return _set_config(model, EvaConfig, "vision", fields)


@torch.no_grad()
def _quantize_llm(model: nn.Module, include_lm_head: bool, bits: int) -> nn.Module:
    """The LLM's bias-free projections named q/k/v/o_proj, gate/up/down_proj
    (and lm_head with include_lm_head) become bits-wide QuantDense layers in
    place, their weights quantised on their device one at a time (the float
    weight is dropped); the configs `model` carries say so."""
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import QuantDense

    llm = getattr(model, "llm", model)
    targets = [name for name, mod in llm.named_modules()
               if isinstance(mod, Dense) and mod.bias is None
               and _QUANT_PROJ.match(name.rsplit(".", 1)[-1])
               and (include_lm_head or name != "lm_head")]
    for name in targets:  # one float weight alive at a time
        dense = llm.get_submodule(name)
        kernel = dense.weight.T
        if bits == 4:
            q, scale = quantize_int4_torch(kernel, pick_int4_group(dense.in_features))
        else:
            q, scale = quantize_kernel_int8_torch(kernel)
        quant = QuantDense(dense.in_features, dense.out_features,
                           dtype=dense.compute_dtype, bits=bits, device="meta")
        quant.q, quant.scale = q, scale
        parent, _, attr = name.rpartition(".")
        setattr(llm.get_submodule(parent), attr, quant)
    return set_llm_config(model, quantize=True, quantize_bits=bits,
                          quantize_lm_head=include_lm_head)


def quantize_llm_int8(model: nn.Module, include_lm_head: bool = True) -> nn.Module:
    """Weight-only int8 for the LLM's projections, in place (the JAX
    package's `quantize_llm_int8` over the port's modules), with
    `quantize_kernel_int8_torch`. `model` is a LlavaForCausalLM (its `llm`
    is quantised) or a LlamaForCausalLM. include_lm_head=False keeps the
    head bf16, as QLoRA training does (the fused and compact heads read it
    as a matrix)."""
    return _quantize_llm(model, include_lm_head, bits=8)


def quantize_llm_int4(model: nn.Module, include_lm_head: bool = False) -> nn.Module:
    """Weight-only int4 for the LLM's projections, in place (the JAX
    package's `quantize_llm_int4`): nibble-packed weights and group scales
    from `quantize_int4_torch` with G = `pick_int4_group(in)`. The head
    stays float by default, as in the JAX package."""
    return _quantize_llm(model, include_lm_head, bits=4)


_VISION_QUANT = re.compile(
    r"^(qkv|q_proj|k_proj|v_proj|proj|out_proj|w1|w2|w3|fc1|fc2)$"
)


@torch.no_grad()
def _quantize_vision(model: nn.Module, bits: int) -> nn.Module:
    """The vision tower's projections named as `_VISION_QUANT` says become
    bits-wide QuantDense layers with their biases, in place, their weights
    quantised on their device one at a time; the patch embedding, norms
    and cls/pos tokens stay float. `model` is an OmniLMMForCausalLM (its
    `vision_tower`) or a tower; the configs it carries say so."""
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import QuantDense

    tower = getattr(model, "vision_tower", model)
    targets = [name for name, mod in tower.named_modules()
               if isinstance(mod, Dense) and _VISION_QUANT.match(name.rsplit(".", 1)[-1])]
    for name in targets:
        dense = tower.get_submodule(name)
        kernel = dense.weight.T
        if bits == 4:
            q, scale = quantize_int4_torch(kernel, pick_int4_group(dense.in_features))
        else:
            q, scale = quantize_kernel_int8_torch(kernel)
        quant = QuantDense(dense.in_features, dense.out_features, dtype=dense.compute_dtype,
                           bits=bits, bias=dense.bias is not None,
                           param_dtype=dense.weight.dtype, device="meta")
        quant.q, quant.scale = q, scale
        if dense.bias is not None:
            quant.bias = dense.bias.detach()
        parent, _, attr = name.rpartition(".")
        setattr(tower.get_submodule(parent), attr, quant)
    return set_vision_config(model, quantize=True, quantize_bits=bits)


def quantize_vision_int8(model: nn.Module) -> nn.Module:
    """Weight-only int8 for the ViT projections, in place (the JAX
    package's `quantize_vision_int8` over the port's modules): int8
    kernels and per-output-channel scales from
    `quantize_kernel_int8_torch`, biases kept."""
    return _quantize_vision(model, bits=8)


def quantize_vision_int4(model: nn.Module) -> nn.Module:
    """Weight-only int4 for the ViT projections, in place (the JAX
    package's `quantize_vision_int4`): packed nibbles and group scales
    from `quantize_int4_torch` with G = `pick_int4_group(in)`, biases
    kept."""
    return _quantize_vision(model, bits=4)


def fuse_llm_projections(llm_params: Tree) -> Tree:
    """Rewrite a Llama param tree for LlamaConfig.fuse_proj: q/k/v kernels
    concat into qkv_proj, gate/up into gate_up_proj (out axis). Works on
    both float {kernel} and int8 {kernel, scale} layouts — per-out-channel
    scales concatenate exactly, so the fused matmul is bit-identical to
    the separate ones."""

    def fuse(mods, names, out_name):
        parts = [mods.pop(n) for n in names]
        fused = {"kernel": np.concatenate(
            [np.asarray(p["kernel"]) for p in parts], axis=1
        )}
        if "scale" in parts[0]:
            scales = [np.asarray(p["scale"]) for p in parts]
            # int8: (N,) per-out-channel -> concat; int4 (QuantDense
            # bits=4): (K//G, N) group scales -> concat the out axis.
            # Both packing (along K) and grouping are orthogonal to the
            # out-axis concat, so fused stays bit-identical to separate.
            axis = 0 if scales[0].ndim == 1 else 1
            fused["scale"] = np.concatenate(scales, axis=axis)
        mods[out_name] = fused

    def walk(node):
        if not isinstance(node, dict):
            return node
        node = {k: walk(v) for k, v in node.items()}
        if {"q_proj", "k_proj", "v_proj"} <= set(node):
            fuse(node, ("q_proj", "k_proj", "v_proj"), "qkv_proj")
        if {"gate_proj", "up_proj"} <= set(node):
            fuse(node, ("gate_proj", "up_proj"), "gate_up_proj")
        return node

    return walk(llm_params)


def _fuse_layers(parts: list) -> nn.Module:
    """One layer computing the given bias-free projections of the same input
    side by side: QuantDense `q`/`scale` concatenated along the out axis
    (int8 scales on axis 0, int4 group scales on axis 1) or Dense weights
    (out, in) along axis 0."""
    from rlaifv_tpu_torch.models.layers import Dense
    from rlaifv_tpu_torch.models.llama import QuantDense

    first, n_out = parts[0], sum(p.out_features for p in parts)
    if isinstance(first, QuantDense):
        fused = QuantDense(first.in_features, n_out, dtype=first.compute_dtype,
                           bits=first.bits, device="meta")
        fused.q = torch.cat([p.q for p in parts], dim=1)
        fused.scale = torch.cat([p.scale for p in parts], dim=first.scale.dim() - 1)
        return fused
    fused = Dense(first.in_features, n_out, bias=False, dtype=first.compute_dtype,
                  param_dtype=first.weight.dtype, init_std=first.init_std, device="meta")
    fused.weight = nn.Parameter(torch.cat([p.weight for p in parts]),
                                requires_grad=first.weight.requires_grad)
    return fused


@torch.no_grad()
def fuse_llm_projections_(model: nn.Module) -> nn.Module:
    """`fuse_llm_projections` on a model, in place: every LlamaAttention's
    q/k/v_proj become one `qkv_proj`, every LlamaMLP's gate/up_proj one
    `gate_up_proj` (float or quantised, bit-identical products), and the
    configs `model` carries get fuse_proj=True. LoRA adapters name the
    separate projections, so a model with adapters attached raises."""
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaMLP

    groups = {LlamaAttention: (("q_proj", "k_proj", "v_proj"), "qkv_proj"),
              LlamaMLP: (("gate_proj", "up_proj"), "gate_up_proj")}
    for mod in list(model.modules()):
        names, fused_name = groups.get(type(mod), ((), None))
        if not names or not hasattr(mod, names[0]):
            continue
        parts = [getattr(mod, n) for n in names]
        if any(p.lora is not None for p in parts):
            raise ValueError("fuse_llm_projections_: detach the LoRA adapters first")
        setattr(mod, fused_name, _fuse_layers(parts))
        for n in names:
            delattr(mod, n)
    return set_llm_config(model, fuse_proj=True)


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax LLaVA param tree into a LlavaForCausalLM, a flax OmniLMM
    tree into an OmniLMMForCausalLM, a flax MiniCPM-V tree (vpm/,
    resampler/, llm/) into a MiniCPMVForCausalLM, or a bare flax Llama tree
    into a LlamaForCausalLM (strict: every name must match), converting to
    each parameter's dtype and device one tensor at a time (a 7B tree needs
    no second host copy)."""
    leaves = {name: (val, kernel) for name, val, kernel in _bridge(params)}
    own = model.state_dict()
    missing = sorted(set(own) - set(leaves))
    unexpected = sorted(set(leaves) - set(own))
    if missing or unexpected:
        raise KeyError(f"param bridge mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            src = _bridged_tensor(*leaves[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src.to(dtype=t.dtype))
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


def llama_config_from_hf(model_dir: str, **overrides):
    """LlamaConfig from a bare HF LLaMA/Vicuna/Mistral checkpoint dir
    (for text-only loads and the real-checkpoint goldens gate)."""
    import json as _json

    from rlaifv_tpu_torch.models.llama import LlamaConfig

    with open(os.path.join(model_dir, "config.json")) as f:
        raw = _json.load(f)
    return LlamaConfig(
        vocab_size=raw.get("vocab_size", 32000),
        hidden_size=raw.get("hidden_size", 4096),
        intermediate_size=raw.get("intermediate_size", 11008),
        num_layers=raw.get("num_hidden_layers", 32),
        num_heads=raw.get("num_attention_heads", 32),
        num_kv_heads=raw.get(
            "num_key_value_heads", raw.get("num_attention_heads", 32)
        ),
        max_position_embeddings=raw.get("max_position_embeddings", 4096),
        rope_theta=raw.get("rope_theta", 10000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
        **overrides,
    )


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


def convert_eva02(
    sd: Mapping[str, Any], prefix: str = "", dtype=np.float32,
    layers_to_run: Optional[int] = None,
) -> Tree:
    """timm Eva (fused-qkv plain variant) -> the EvaVisionTower tree.

    timm layout: patch_embed.proj.{weight,bias}, cls_token, pos_embed,
    blocks.N.{norm1, attn.{qkv,proj}, norm2, mlp.fc1/fc2}, norm. The last
    block is dead (replaced by Identity in the reference) and skipped; a
    checkpoint with q_bias/v_bias instead of a qkv bias gets a zero k bias.
    """
    g = lambda k: _np(sd[prefix + k]).astype(dtype)
    tree: Tree = {}
    _set(tree, "patch_embed/kernel",
         g("patch_embed.proj.weight").transpose(2, 3, 1, 0))
    _set(tree, "patch_embed/bias", g("patch_embed.proj.bias"))
    _set(tree, "cls_token", g("cls_token").reshape(-1))
    _set(tree, "pos_embed", g("pos_embed").reshape(
        -1, g("pos_embed").shape[-1]))
    layer_pat = re.compile(re.escape(prefix) + r"blocks\.(\d+)\.")
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := layer_pat.match(k)))
    run = layers_to_run if layers_to_run is not None else n_layers - 1
    for i in range(run):
        hf = f"blocks.{i}."
        fx = f"block_{i}/"
        _set(tree, fx + "norm1/scale", g(hf + "norm1.weight"))
        _set(tree, fx + "norm1/bias", g(hf + "norm1.bias"))
        _set(tree, fx + "norm2/scale", g(hf + "norm2.weight"))
        _set(tree, fx + "norm2/bias", g(hf + "norm2.bias"))
        _set(tree, fx + "attn/qkv/kernel", g(hf + "attn.qkv.weight").T)
        if prefix + hf + "attn.qkv.bias" in sd:
            _set(tree, fx + "attn/qkv/bias", g(hf + "attn.qkv.bias"))
        else:
            # EVA q/v-bias-only convention: k bias is fixed zero
            q_b = g(hf + "attn.q_bias")
            v_b = g(hf + "attn.v_bias")
            _set(tree, fx + "attn/qkv/bias",
                 np.concatenate([q_b, np.zeros_like(q_b), v_b]))
        _set(tree, fx + "attn/proj/kernel", g(hf + "attn.proj.weight").T)
        _set(tree, fx + "attn/proj/bias", g(hf + "attn.proj.bias"))
        _set(tree, fx + "mlp/fc1/kernel", g(hf + "mlp.fc1.weight").T)
        _set(tree, fx + "mlp/fc1/bias", g(hf + "mlp.fc1.bias"))
        _set(tree, fx + "mlp/fc2/kernel", g(hf + "mlp.fc2.weight").T)
        _set(tree, fx + "mlp/fc2/bias", g(hf + "mlp.fc2.bias"))
    _set(tree, "norm/scale", g("norm.weight"))
    _set(tree, "norm/bias", g("norm.bias"))
    return tree


def omnilmm_config_from_hf(model_dir: str, **overrides):
    """OmniLMMConfig from the checkpoint's config.json (the reference
    OmniLMMConfig extends MistralConfig and carries num_query; the EVA
    tower is a fixed timm model, so `eva_config` in config.json, or the
    `vision` overrides, only matter for other checkpoints). `llm={...}`
    and `vision={...}` override fields of the two sub-configs."""
    import json as _json

    from rlaifv_tpu_torch.models.eva02 import EvaConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.omnilmm import OmniLMMConfig

    cfg_path = os.path.join(model_dir, "config.json")
    raw = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = _json.load(f)

    llm = LlamaConfig.mistral_7b(
        vocab_size=raw.get("vocab_size", 32000),
        hidden_size=raw.get("hidden_size", 4096),
        intermediate_size=raw.get("intermediate_size", 14336),
        num_layers=raw.get("num_hidden_layers", 32),
        num_heads=raw.get("num_attention_heads", 32),
        num_kv_heads=raw.get("num_key_value_heads", 8),
        max_position_embeddings=raw.get("max_position_embeddings", 32768),
        rope_theta=raw.get("rope_theta", 10000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
        **overrides.get("llm", {}),
    )
    eva_kw = dict(raw.get("eva_config", {}))
    eva_kw.update(overrides.get("vision", {}))
    return OmniLMMConfig(llm=llm, vision=EvaConfig.enormous(**eva_kw),
                         num_query=raw.get("num_query", 64))


def convert_omnilmm(sd: Mapping[str, Any], dtype=np.float32,
                    vision_layers_to_run: Optional[int] = None) -> Tree:
    """OmniLMM-12B checkpoint -> the OmniLMMForCausalLM tree: the Mistral
    LM under model.* / lm_head.*, the timm Eva tower under
    model.vision_tower.*, the resampler under model.resampler.*."""
    from rlaifv_tpu_torch.models.resampler import convert_resampler

    llm_sd = {
        k: v for k, v in sd.items()
        if not k.startswith(("model.vision_tower", "model.resampler"))
    }
    tree: Tree = {"llm": convert_llama(llm_sd, dtype=dtype)}
    tree["vision_tower"] = convert_eva02(
        sd, prefix="model.vision_tower.", dtype=dtype,
        layers_to_run=vision_layers_to_run,
    )
    tree["resampler"] = convert_resampler(sd, prefix="model.resampler.", dtype=dtype)
    return tree


def convert_siglip(
    sd: Mapping[str, Any], prefix: str = "vpm.", dtype=np.float32
) -> Tree:
    """HF SiglipVisionModel / MiniCPM-V `vpm.` tower -> the
    SiglipVisionTower tree.

    Key layout (HF siglip + MiniCPM-V 2.5 remote code): embeddings.
    patch_embedding.{weight,bias}, embeddings.position_embedding.weight,
    encoder.layers.N.{self_attn.{q,k,v,out}_proj, layer_norm1/2, mlp.fc1/2},
    post_layernorm; an extra `vision_model.` nesting is tolerated.
    """
    if not any(k.startswith(prefix + "encoder") for k in sd):
        if any(k.startswith(prefix + "vision_model.encoder") for k in sd):
            prefix = prefix + "vision_model."
    g = lambda k: _np(sd[prefix + k]).astype(dtype)
    tree: Tree = {}
    _set(tree, "patch_embed/kernel",
         g("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0))
    _set(tree, "patch_embed/bias", g("embeddings.patch_embedding.bias"))
    _set(tree, "pos_embed", g("embeddings.position_embedding.weight"))
    layer_pat = re.compile(re.escape(prefix) + r"encoder\.layers\.(\d+)\.")
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := layer_pat.match(k)))
    for i in range(n_layers):
        hf = f"encoder.layers.{i}."
        fx = f"layer_{i}/"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _set(tree, fx + f"{name}/kernel", g(hf + f"self_attn.{name}.weight").T)
            _set(tree, fx + f"{name}/bias", g(hf + f"self_attn.{name}.bias"))
        _set(tree, fx + "ln1/scale", g(hf + "layer_norm1.weight"))
        _set(tree, fx + "ln1/bias", g(hf + "layer_norm1.bias"))
        _set(tree, fx + "ln2/scale", g(hf + "layer_norm2.weight"))
        _set(tree, fx + "ln2/bias", g(hf + "layer_norm2.bias"))
        _set(tree, fx + "fc1/kernel", g(hf + "mlp.fc1.weight").T)
        _set(tree, fx + "fc1/bias", g(hf + "mlp.fc1.bias"))
        _set(tree, fx + "fc2/kernel", g(hf + "mlp.fc2.weight").T)
        _set(tree, fx + "fc2/bias", g(hf + "mlp.fc2.bias"))
    _set(tree, "post_ln/scale", g("post_layernorm.weight"))
    _set(tree, "post_ln/bias", g("post_layernorm.bias"))
    return tree


def minicpmv_config_from_hf(model_dir: str, **overrides):
    """MiniCPMVConfig from the checkpoint's config.json (the MiniCPM-Llama3-V
    2.5 remote-code layout: the Llama3 fields at the top level, the slicing
    knobs query_num / slice_mode / max_slice_nums / scale_resolution /
    patch_size, the SigLIP tower so400m unless a vision_config block says
    otherwise). `llm={...}` and `vision={...}` override fields of the two
    sub-configs."""
    import json as _json

    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.minicpmv import MiniCPMVConfig
    from rlaifv_tpu_torch.models.siglip import SiglipVisionConfig

    cfg_path = os.path.join(model_dir, "config.json")
    raw = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = _json.load(f)

    llm = LlamaConfig.llama3_8b(
        vocab_size=raw.get("vocab_size", 128256),
        hidden_size=raw.get("hidden_size", 4096),
        intermediate_size=raw.get("intermediate_size", 14336),
        num_layers=raw.get("num_hidden_layers", 32),
        num_heads=raw.get("num_attention_heads", 32),
        num_kv_heads=raw.get("num_key_value_heads", 8),
        max_position_embeddings=raw.get("max_position_embeddings", 8192),
        rope_theta=raw.get("rope_theta", 500000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
        **overrides.get("llm", {}),
    )
    vis_raw = dict(raw.get("vision_config", {}))
    vis_kw = dict(
        image_size=vis_raw.get("image_size", 980),
        patch_size=vis_raw.get("patch_size", 14),
        hidden_size=vis_raw.get("hidden_size", 1152),
        intermediate_size=vis_raw.get("intermediate_size", 4304),
        num_layers=vis_raw.get("num_hidden_layers", 27),
        num_heads=vis_raw.get("num_attention_heads", 16),
    )
    vis_kw.update(overrides.get("vision", {}))
    return MiniCPMVConfig(
        llm=llm,
        vision=SiglipVisionConfig.so400m(**vis_kw),
        query_num=raw.get("query_num", 96),
        slice_mode=raw.get("slice_mode", True),
        max_slice_nums=raw.get("max_slice_nums", 9),
        scale_resolution=raw.get("scale_resolution", 448),
        patch_size=raw.get("patch_size", 14),
    )


def convert_minicpmv(sd: Mapping[str, Any], dtype=np.float32) -> Tree:
    """MiniCPM-Llama3-V 2.5 checkpoint -> the MiniCPMVForCausalLM tree: the
    Llama3 LM under llm.*, the SigLIP tower under vpm.*, the resampler
    under resampler.* (the remote code's module names)."""
    from rlaifv_tpu_torch.models.resampler import convert_resampler

    llm_sd = {k[len("llm."):]: v for k, v in sd.items() if k.startswith("llm.")}
    tree: Tree = {"llm": convert_llama(llm_sd, dtype=dtype)}
    tree["vpm"] = convert_siglip(sd, prefix="vpm.", dtype=dtype)
    # 2.5's resampler runs query_pos=False (the positions ride the keys a
    # slice at a time), so the tree holds no pos_embed
    tree["resampler"] = convert_resampler(sd, prefix="resampler.", dtype=dtype,
                                          query_pos=False)
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


def llava_config_from_hf(model_dir: str, **overrides):
    """Build LlavaConfig from the checkpoint's config.json (HF LlavaConfig /
    reference LlavaLlamaForCausalLM layout). Falls back to 7B defaults for
    missing fields (ref builder.py relies on from_pretrained for this).
    `llm={...}` and `vision={...}` override fields of the two sub-configs
    (e.g. dtype and param_dtype)."""
    import json as _json

    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig

    cfg_path = os.path.join(model_dir, "config.json")
    raw = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = _json.load(f)

    llm = LlamaConfig(
        vocab_size=raw.get("vocab_size", 32000),
        hidden_size=raw.get("hidden_size", 4096),
        intermediate_size=raw.get("intermediate_size", 11008),
        num_layers=raw.get("num_hidden_layers", 32),
        num_heads=raw.get("num_attention_heads", 32),
        num_kv_heads=raw.get(
            "num_key_value_heads", raw.get("num_attention_heads", 32)
        ),
        max_position_embeddings=raw.get("max_position_embeddings", 4096),
        rope_theta=raw.get("rope_theta", 10000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
        **overrides.get("llm", {}),
    )
    vis_raw = raw.get("vision_config", {})
    vision = CLIPVisionConfig(
        image_size=vis_raw.get("image_size", 336),
        patch_size=vis_raw.get("patch_size", 14),
        hidden_size=vis_raw.get("hidden_size", raw.get("mm_hidden_size", 1024)),
        intermediate_size=vis_raw.get("intermediate_size", 4096),
        num_layers=vis_raw.get("num_hidden_layers", 24),
        num_heads=vis_raw.get("num_attention_heads", 16),
        select_layer=raw.get("mm_vision_select_layer", -2),
        **overrides.get("vision", {}),
    )
    return LlavaConfig(
        llm=llm,
        vision=vision,
        projector_type=raw.get("mm_projector_type", "mlp2x_gelu"),
        image_aspect_ratio=raw.get("image_aspect_ratio", "pad"),
        image_grid_pinpoints=raw.get("image_grid_pinpoints"),
        mm_patch_merge_type=raw.get("mm_patch_merge_type", "flat"),
    )


def clip_config_from_hf(model_dir: str, **overrides):
    """CLIPVisionConfig from a bare HF CLIPVisionModel checkpoint dir."""
    import json as _json

    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig

    with open(os.path.join(model_dir, "config.json")) as f:
        raw = _json.load(f)
    raw = raw.get("vision_config", raw)
    return CLIPVisionConfig(
        image_size=raw.get("image_size", 336),
        patch_size=raw.get("patch_size", 14),
        hidden_size=raw.get("hidden_size", 1024),
        intermediate_size=raw.get("intermediate_size", 4096),
        num_layers=raw.get("num_hidden_layers", 24),
        num_heads=raw.get("num_attention_heads", 16),
        **overrides,
    )


def _merge_tree(base: Tree, overlay: Tree) -> Tree:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_tree(out[k], v)
        else:
            out[k] = v
    return out


def convert_peft_lora(sd: Mapping[str, Any], dtype=np.float32) -> Tree:
    """peft adapter state dict -> the LoRA tree ({module: {a, b}}).

    peft keys look like 'base_model.model.model.layers.N.self_attn.q_proj.
    lora_A.weight' with lora_A (r, in), lora_B (out, r) — transposed into
    the a (in, r) / b (r, out) layout (ref builder.py:52-86 merge path).
    """
    lora: Tree = {}
    hf2fx = {"self_attn": "attn", "mlp": "mlp"}
    pat = re.compile(
        r"(?:base_model\.)?(?:model\.)*layers\.(\d+)\.(self_attn|mlp)\."
        r"(\w+_proj)\.lora_(A|B)\.weight"
    )
    for key, val in sd.items():
        m = pat.search(key)
        if not m:
            continue
        layer, block, proj, ab = m.groups()
        path = f"llm/model/layer_{layer}/{hf2fx[block]}/{proj}"
        node = lora
        for part in path.split("/"):
            node = node.setdefault(part, {})
        w = _np(val).astype(dtype)
        node["a" if ab == "A" else "b"] = w.T
    return lora


def _quantize_llm_tree(llm: Tree, mode) -> Tree:
    """A numpy LLM tree with its projection kernels quantised, the JAX
    package's numpy `_quantize_llm` (its `quantize_llm_int8` /
    `quantize_llm_int4` walks): quantize_llm=True/"int8" -> {kernel int8,
    scale per out channel}, lm_head included; "int4" -> {kernel packed
    nibbles, scale per group}, lm_head left float. A model built with
    quantize=True (quantize_bits, quantize_lm_head to match) loads it."""
    from rlaifv_tpu_torch.models.llama import quantize_kernel_int8
    from rlaifv_tpu_torch.ops.int4_matmul import quantize_int4

    bits4 = mode == "int4"

    def walk(node, name):
        if isinstance(node, dict):
            if (_QUANT_PROJ.match(name or "") and (not bits4 or name != "lm_head")
                    and set(node) == {"kernel"} and np.ndim(node["kernel"]) == 2):
                w = np.asarray(node["kernel"])
                if bits4:
                    q, s = quantize_int4(w, group=pick_int4_group(w.shape[0]))
                else:
                    q, s = quantize_kernel_int8(w)
                return {"kernel": q, "scale": s}
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(llm, "")


def load_pretrained_llava(
    model_path: str,
    model_base: Optional[str] = None,
    dtype=np.float32,
    vision_layers_to_run: Optional[int] = None,
    lora_alpha: float = 16.0,
    quantize_llm=False,
) -> Tree:
    """Reference load_pretrained_model semantics (ref llava/model/
    builder.py:26-167) for the three layouts, as a numpy tree that
    `load_jax_params` copies into a model:

    - full checkpoint:                load_pretrained_llava(path)
    - LoRA adapters over a base:      load_pretrained_llava(lora_dir, base)
      (adapter_model safetensors/bin + optional non_lora_trainables.bin)
    - delta/projector-only over base: base weights overlaid with whatever
      tensors the delta dir provides (mm_projector-only checkpoints).
    """
    if model_base is None:
        params = load_llava_checkpoint(
            model_path, dtype=dtype, vision_layers_to_run=vision_layers_to_run
        )
        if quantize_llm:
            params["llm"] = _quantize_llm_tree(params["llm"], quantize_llm)
        return params

    params = load_llava_checkpoint(
        model_base, dtype=dtype, vision_layers_to_run=vision_layers_to_run
    )

    # non-LoRA trainables (projector etc.) saved beside adapters
    non_lora_path = os.path.join(model_path, "non_lora_trainables.bin")
    if os.path.exists(non_lora_path):
        sd = torch.load(non_lora_path, map_location="cpu", weights_only=True)
        sd = {
            k[len("base_model."):] if k.startswith("base_model.") else k: v
            for k, v in sd.items()
        }
        sd = {
            k[len("model."):] if k.startswith("model.model.") else k: v
            for k, v in sd.items()
        }
        overlay = convert_llava(
            sd, dtype=dtype, vision_layers_to_run=vision_layers_to_run
        ) if any(k.startswith("model.layers") for k in sd) else {}
        if not overlay and any("mm_projector" in k for k in sd):
            proj: Tree = {}
            for k, v in sd.items():
                m = re.match(r".*mm_projector\.(\d+)\.(weight|bias)", k)
                if not m:
                    continue
                seq_i, kind = int(m.group(1)), m.group(2)
                fc = proj.setdefault(f"fc{seq_i // 2}", {})
                arr = _np(v).astype(dtype)
                fc["kernel" if kind == "weight" else "bias"] = (
                    arr.T if kind == "weight" else arr
                )
            overlay = {"mm_projector": proj}
        params = _merge_tree(params, overlay)

    # adapters: merge a@b * alpha/r into the kernels
    try:
        adapter_sd = load_state_dict_dir(model_path)
    except FileNotFoundError:
        # peft's torch-format save name (builder.py loads it explicitly);
        # load_state_dict_dir's bin glob only matches pytorch_model*.bin
        adapter_sd = {}
        abin = os.path.join(model_path, "adapter_model.bin")
        if os.path.exists(abin):
            adapter_sd = {
                k: _np(v) for k, v in torch.load(
                    abin, map_location="cpu", weights_only=True
                ).items()
            }
    lora = convert_peft_lora(adapter_sd, dtype=dtype)
    if lora:
        from rlaifv_tpu_torch.train.lora import lora_merge

        params = lora_merge(params, lora, alpha=lora_alpha)
    if quantize_llm:
        params["llm"] = _quantize_llm_tree(params["llm"], quantize_llm)
    return params
