"""LoRA adapters as a separate tree of tensors, read by the projections.

Counterpart of rlaifv_tpu/train/lora.py (the reference's peft injection on
every LLM linear layer except the projector, vision tower and lm_head; r 64,
alpha 16). The adapter tree has the JAX package's nesting and layout:
{"llm": {"model": {"layer_0": {"attn": {"q_proj": {"a": (in, r),
"b": (r, out)}}}}}}, fp32 tensors; `lora_from_jax` (models/convert.py)
bridges the JAX tree. `lora_target_paths`, `lora_merge`, `lora_scaled` and
`save_lora`/`load_lora` are the JAX package's functions, taking numpy or
torch leaves (and, for the paths, a model, through `flax_tree`).

`attach_lora` hands the (alpha/r-scaled) pairs to the model's projections
(models/layers.py Dense, models/llama.py QuantDense), which add the side
term (x @ a) @ b: the JAX package's "lora" variable collection. They stay
attached until replaced or cleared, so a remat recompute in the backward
reads the same tensors as its forward.
"""
from __future__ import annotations

import re
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rlaifv_tpu_torch.models.convert import flax_tree, torch_module_name

Tree = Any

# ref find_all_linear_names: skip vision tower / projector / lm_head
DEFAULT_TARGET = r"llm/.*(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$"
DEFAULT_EXCLUDE = r"(vision_tower|mm_projector|lm_head)"


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_flatten(v, f"{prefix}{k}/"))
    else:
        out.append((prefix[:-1], tree))
    return out


def _set(tree: Tree, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get(tree: Tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def lora_target_paths(
    params: Tree,
    target: str = DEFAULT_TARGET,
    exclude: str = DEFAULT_EXCLUDE,
) -> List[str]:
    """The flax paths (".../q_proj/kernel") of the 2-D kernels that get
    adapters, in tree order. params: a param tree or a model."""
    if isinstance(params, nn.Module):
        params = flax_tree(params)
    paths = []
    for path, leaf in _flatten(params):
        if re.search(exclude, path):
            continue
        if re.search(target, path) and _ndim(leaf) == 2:
            paths.append(path)
    return paths


def lora_init(
    generator: torch.Generator,
    params: Tree,
    *,
    r: int = 64,
    target: str = DEFAULT_TARGET,
    exclude: str = DEFAULT_EXCLUDE,
    dtype=torch.float32,
) -> Tree:
    """a ~ kaiming-uniform (peft default, bound sqrt(6 / fan_in)), b = 0
    (the delta starts at zero), on each kernel's device, drawn from
    `generator` (which lives on that device) in tree order."""
    if isinstance(params, nn.Module):
        params = flax_tree(params)
    lora: Tree = {}
    for path in lora_target_paths(params, target, exclude):
        leaf = _get(params, path)
        fan_in = leaf.shape[0]
        bound = float(np.sqrt(6.0 / fan_in))
        a = torch.empty((fan_in, r), dtype=dtype, device=leaf.device).uniform_(
            -bound, bound, generator=generator)
        b = torch.zeros((r, leaf.shape[1]), dtype=dtype, device=leaf.device)
        # adapters sit at the module level: ".../q_proj" -> {a, b}
        _set(lora, path.rsplit("/kernel", 1)[0], {"a": a, "b": b})
    return lora


def _cast(x, like):
    return x.to(like.dtype) if isinstance(x, torch.Tensor) else x.astype(like.dtype)


def lora_merge(params: Tree, lora: Tree, alpha: float = 16.0,
               r: Optional[int] = None) -> Tree:
    """params with kernel' = kernel + (alpha/r) * a @ b, other leaves shared."""

    def walk(p_node, l_node):
        if not isinstance(p_node, dict):
            return p_node
        out = {}
        for k, v in p_node.items():
            sub = l_node.get(k) if isinstance(l_node, dict) else None
            if isinstance(sub, dict) and "a" in sub and "b" in sub:
                a, b = sub["a"], sub["b"]
                scale = alpha / a.shape[1]
                delta = _cast((a @ b) * scale, v["kernel"])
                out[k] = dict(v, kernel=v["kernel"] + delta)
            else:
                out[k] = walk(v, sub)
        return out

    return walk(params, lora)


def lora_scaled(lora: Tree, alpha: float = 16.0) -> Tree:
    """Fold the alpha/r scale into b, so the projections' unscaled x@a@b
    side term equals the merged kernel' = kernel + a@b·(alpha/r).
    Gradients flow through the fold (chain rule), so training on the raw
    {a, b} tree matches the merged formulation exactly."""

    def walk(node):
        if isinstance(node, dict) and "a" in node and "b" in node:
            r = node["a"].shape[1]
            return {"a": node["a"], "b": node["b"] * (alpha / r)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(lora)


def adapter_pairs(lora: Tree, prefix: str = "") -> Iterator[Tuple[str, dict]]:
    """(flax module path, {"a", "b"}) for every adapter of the tree."""
    for k, v in lora.items():
        if isinstance(v, dict) and "a" in v and "b" in v:
            yield prefix + k, v
        elif isinstance(v, dict):
            yield from adapter_pairs(v, f"{prefix}{k}/")


def attach_lora(model: nn.Module, lora: Optional[Tree]) -> None:
    """Give each adapted projection of `model` its (a, b) pair (pass the
    `lora_scaled` tree); every other projection, or all of them with None,
    gets none."""
    for mod in model.modules():
        if hasattr(mod, "lora"):
            mod.lora = None
    for path, node in adapter_pairs(lora or {}):
        model.get_submodule(torch_module_name(path)).lora = (node["a"], node["b"])


def save_lora(path: str, lora: Tree, alpha: float, r: int) -> None:
    """Adapters saved separately from base weights (ref :184-197 contract)."""
    flat = {p: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for p, v in _flatten(lora)}
    flat["__alpha__"] = np.float32(alpha)
    flat["__r__"] = np.int32(r)
    np.savez(path, **flat)


def load_lora(path: str) -> Tuple[Tree, float, int]:
    data = np.load(path)
    lora: Tree = {}
    alpha, r = 16.0, 64
    for key in data.files:
        if key == "__alpha__":
            alpha = float(data[key])
        elif key == "__r__":
            r = int(data[key])
        else:
            _set(lora, key, torch.from_numpy(data[key]))
    return lora, alpha, r
