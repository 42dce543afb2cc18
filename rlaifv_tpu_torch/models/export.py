"""Export a port model back to reference/HF checkpoint formats.

Counterpart of rlaifv_tpu/models/export.py: its numpy functions copied
function for function (`_kernel`, `_f`, `unfuse_llm_projections`,
`export_llama_sd`, `export_clip_vision_sd`, `export_projector_sd`,
`export_llava_sd`, `_save_torch_bin`, `_hf_config_from_llava`,
`export_llava_hf`, `export_peft_lora`), each the inverse of its
models/convert.py counterpart: convert(export(params)) == params bit for
bit at the export dtype. The reference's iterative protocol feeds each
round's HF checkpoint back in as the next base model (ref README.md:205-221)
and its loader consumes a full checkpoint or a peft LoRA dir +
non_lora_trainables.bin (ref llava/model/builder.py:26-167); these write
both.

The functions take the JAX package's numpy param tree. `params_from_model`
is the bridge from a built port model to that tree (the inverse of
models/convert.py `llava_params_from_jax` / `load_jax_params`): float
weights as fp32 arrays, int8 QuantDense layers as {kernel int8, scale}
(dequantised on export by `_kernel`, as the JAX package does), fused
qkv/gate_up projections split back by `unfuse_llm_projections`; and
`lora_params` turns train/lora.py's adapter tree into the numpy {a, b}
tree `export_peft_lora` takes.

One deliberate difference: a packed int4 kernel (int8 nibbles beside 2-D
group scales) raises ValueError in `_kernel`. The JAX function raises for
it too, except where the group spans the whole input (one group): there it
would write the packed bytes, scaled, as float weights.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np

Tree = Dict[str, Any]

_TOKENIZER_FILES = (
    "tokenizer.model", "tokenizer.json", "tokenizer_config.json",
    "special_tokens_map.json", "added_tokens.json",
)


def _kernel(node: Mapping[str, Any]) -> np.ndarray:
    """Materialize a Dense/QuantDense kernel as float numpy (dequantized)."""
    k = np.asarray(node["kernel"])
    if k.dtype == np.int8:
        if "scale" not in node:
            raise ValueError("int8 kernel without scale — not exportable")
        if np.ndim(node["scale"]) != 1:
            raise ValueError(
                "packed int4 kernel (2-D group scales) — not exportable; export "
                "the float model, or its adapters with export_peft_lora")
        return k.astype(np.float32) * np.asarray(node["scale"])[None, :]
    return np.asarray(k, np.float32) if k.dtype.kind != "f" else k


def _f(x, dtype) -> np.ndarray:
    return np.asarray(x, np.float32).astype(dtype)


def unfuse_llm_projections(llm_params: Tree, cfg) -> Tree:
    """Inverse of convert.fuse_llm_projections: split qkv_proj back into
    q/k/v and gate_up_proj into gate/up (out-axis split at the config's
    head/intermediate dims; per-out-channel int8 scales split exactly)."""
    q_dim = cfg.num_heads * cfg.head_size
    kv_dim = cfg.num_kv_heads * cfg.head_size

    def split(node, bounds, names):
        outs, lo = {}, 0
        for name, hi in zip(names, bounds):
            part = {"kernel": np.asarray(node["kernel"])[:, lo:hi]}
            if "scale" in node:
                part["scale"] = np.asarray(node["scale"])[lo:hi]
            outs[name] = part
            lo = hi
        return outs

    def walk(node):
        if not isinstance(node, dict):
            return node
        node = {k: walk(v) for k, v in node.items()}
        if "qkv_proj" in node:
            node.update(split(
                node.pop("qkv_proj"),
                (q_dim, q_dim + kv_dim, q_dim + 2 * kv_dim),
                ("q_proj", "k_proj", "v_proj"),
            ))
        if "gate_up_proj" in node:
            g = node.pop("gate_up_proj")
            half = np.asarray(g["kernel"]).shape[1] // 2
            node.update(split(g, (half, 2 * half), ("gate_proj", "up_proj")))
        return node

    return walk(llm_params)


def export_llama_sd(
    tree: Tree, prefix: str = "", dtype=np.float16
) -> Dict[str, np.ndarray]:
    """LlamaForCausalLM params -> HF LlamaForCausalLM state dict
    (inverse of convert.convert_llama)."""
    sd: Dict[str, np.ndarray] = {}
    model = tree["model"]
    sd[prefix + "model.embed_tokens.weight"] = _f(
        model["tok_embed"]["embedding"], dtype)
    i = 0
    while f"layer_{i}" in model:
        fx, hf = model[f"layer_{i}"], f"{prefix}model.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[hf + f"self_attn.{name}.weight"] = _f(
                _kernel(fx["attn"][name]).T, dtype)
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[hf + f"mlp.{name}.weight"] = _f(
                _kernel(fx["mlp"][name]).T, dtype)
        sd[hf + "input_layernorm.weight"] = _f(fx["ln_attn"]["scale"], dtype)
        sd[hf + "post_attention_layernorm.weight"] = _f(
            fx["ln_mlp"]["scale"], dtype)
        i += 1
    sd[prefix + "model.norm.weight"] = _f(model["ln_f"]["scale"], dtype)
    if "lm_head" in tree:
        sd[prefix + "lm_head.weight"] = _f(_kernel(tree["lm_head"]).T, dtype)
    return sd


def export_clip_vision_sd(
    tree: Tree, prefix: str = "vision_model.", dtype=np.float16
) -> Dict[str, np.ndarray]:
    """CLIPVisionTower params -> HF CLIPVisionModel state dict (inverse of
    convert.convert_clip_vision). Only the blocks present in the tree are
    emitted — the select_layer=-2 tap drops the final (dead) block on
    import; pass a base_dir to export_llava_hf to carry it through."""
    sd: Dict[str, np.ndarray] = {}
    g = lambda k, v: sd.__setitem__(prefix + k, _f(v, dtype))
    g("embeddings.class_embedding", tree["cls_token"])
    # (P, P, 3, D) flax HWIO -> (D, 3, P, P) torch conv
    g("embeddings.patch_embedding.weight",
      np.asarray(tree["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    g("embeddings.position_embedding.weight", tree["pos_embed"])
    g("pre_layrnorm.weight", tree["pre_ln"]["scale"])
    g("pre_layrnorm.bias", tree["pre_ln"]["bias"])
    i = 0
    while f"layer_{i}" in tree:
        fx, hf = tree[f"layer_{i}"], f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            g(hf + f"self_attn.{name}.weight", _kernel(fx["attn"][name]).T)
            g(hf + f"self_attn.{name}.bias", fx["attn"][name]["bias"])
        g(hf + "layer_norm1.weight", fx["ln1"]["scale"])
        g(hf + "layer_norm1.bias", fx["ln1"]["bias"])
        g(hf + "layer_norm2.weight", fx["ln2"]["scale"])
        g(hf + "layer_norm2.bias", fx["ln2"]["bias"])
        g(hf + "mlp.fc1.weight", _kernel(fx["fc1"]).T)
        g(hf + "mlp.fc1.bias", fx["fc1"]["bias"])
        g(hf + "mlp.fc2.weight", _kernel(fx["fc2"]).T)
        g(hf + "mlp.fc2.bias", fx["fc2"]["bias"])
        i += 1
    return sd


def export_projector_sd(tree: Tree, dtype=np.float16) -> Dict[str, np.ndarray]:
    """mm_projector params -> torch Sequential keys (Linear at 0, 2, 4...)."""
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"fc{i}" in tree:
        fc = tree[f"fc{i}"]
        sd[f"model.mm_projector.{2 * i}.weight"] = _f(_kernel(fc).T, dtype)
        sd[f"model.mm_projector.{2 * i}.bias"] = _f(fc["bias"], dtype)
        i += 1
    return sd


def export_llava_sd(params: Tree, dtype=np.float16) -> Dict[str, np.ndarray]:
    """Composite LlavaForCausalLM params -> reference checkpoint state dict
    (inverse of convert.convert_llava; key layout per
    llava/model/language_model/llava_llama.py)."""
    sd = export_llama_sd(params["llm"], dtype=dtype)
    sd.update(export_clip_vision_sd(
        params["vision_tower"],
        prefix="model.vision_tower.vision_tower.vision_model.",
        dtype=dtype,
    ))
    sd.update(export_projector_sd(params["mm_projector"], dtype=dtype))
    return sd


def _save_torch_bin(sd: Mapping[str, np.ndarray], path: str) -> None:
    import torch

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


def _hf_config_from_llava(cfg) -> dict:
    """Synthesize a reference-compatible config.json from LlavaConfig
    (inverse of convert.llava_config_from_hf's field reads)."""
    llm, vis = cfg.llm, cfg.vision
    return {
        "architectures": ["LlavaLlamaForCausalLM"],
        "model_type": "llava",
        "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_layers,
        "num_attention_heads": llm.num_heads,
        "num_key_value_heads": llm.num_kv_heads,
        "max_position_embeddings": llm.max_position_embeddings,
        "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "torch_dtype": "float16",
        "mm_hidden_size": vis.hidden_size,
        "mm_projector_type": cfg.projector_type,
        "mm_vision_select_layer": vis.select_layer,
        "mm_vision_select_feature": "patch",
        # the reference tower ids follow this naming (e.g.
        # clip-vit-large-patch14-336) — derive from geometry instead of
        # hardcoding so a 224-px or patch-16 config round-trips
        "mm_vision_tower": (
            f"openai/clip-vit-large-patch{vis.patch_size}-{vis.image_size}"
        ),
        "mm_use_im_patch_tokens": False,
        "mm_use_im_start_end": False,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "image_grid_pinpoints": cfg.image_grid_pinpoints,
        "mm_patch_merge_type": cfg.mm_patch_merge_type,
        "vision_config": {
            "image_size": vis.image_size,
            "patch_size": vis.patch_size,
            "hidden_size": vis.hidden_size,
            "intermediate_size": vis.intermediate_size,
            "num_hidden_layers": vis.num_layers,
            "num_attention_heads": vis.num_heads,
        },
    }


def export_llava_hf(
    params: Tree,
    out_dir: str,
    cfg=None,
    base_dir: Optional[str] = None,
    dtype=np.float16,
) -> str:
    """Write a reference-loadable full checkpoint dir: pytorch_model.bin +
    config.json (+ tokenizer files and passthrough tensors from base_dir).

    base_dir (the checkpoint the run started from) supplies everything the
    import direction dropped or cannot synthesize: the dead final ViT block
    (convert_clip_vision layers_to_run), model.image_newline, tokenizer
    files, and the authoritative config.json. Without it the config is
    synthesized from `cfg` and the tokenizer must be copied by the caller.
    """
    os.makedirs(out_dir, exist_ok=True)
    sd = export_llava_sd(params, dtype=dtype)

    raw_cfg: dict = {}
    if base_dir:
        from rlaifv_tpu_torch.models.convert import load_state_dict_dir

        base_sd = load_state_dict_dir(base_dir)
        for k, v in base_sd.items():
            if k not in sd:  # dead ViT block, image_newline, buffers...
                sd[k] = _f(v, dtype) if np.asarray(v).dtype.kind == "f" else v
        base_cfg_path = os.path.join(base_dir, "config.json")
        if os.path.exists(base_cfg_path):
            with open(base_cfg_path) as f:
                raw_cfg = json.load(f)
        for fname in _TOKENIZER_FILES:
            src = os.path.join(base_dir, fname)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, fname))
    if not raw_cfg:
        if cfg is None:
            raise ValueError("export_llava_hf needs cfg or base_dir for "
                             "config.json")
        raw_cfg = _hf_config_from_llava(cfg)
    if not base_dir:
        # the flax tree only carries the ViT blocks the forward runs
        # (layers_to_run = depth + select_layer + 1 at import); without a
        # base_dir the exported checkpoint is missing the tail blocks +
        # post_layernorm, which the reference from_pretrained RANDOMLY
        # initializes — dead at select_layer=-2, silently wrong for any
        # consumer reading a later layer. Say so loudly.
        import warnings

        depth = int(raw_cfg.get("vision_config", {}).get(
            "num_hidden_layers", 0))
        exported = len({k.split("encoder.layers.")[1].split(".")[0]
                        for k in sd if "encoder.layers." in k})
        missing = [f"encoder.layers.{i}" for i in range(exported, depth)]
        missing.append("post_layernorm")
        warnings.warn(
            "export_llava_hf without base_dir: the checkpoint will be "
            f"missing vision keys {missing} (never run at "
            f"select_layer={raw_cfg.get('mm_vision_select_layer')}); the "
            "reference loader will randomly initialize them — pass the "
            "base checkpoint dir to carry them through",
            stacklevel=2,
        )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(raw_cfg, f, indent=2)

    _save_torch_bin(sd, os.path.join(out_dir, "pytorch_model.bin"))
    return out_dir


def export_peft_lora(
    lora: Tree,
    out_dir: str,
    alpha: float = 16.0,
    r: Optional[int] = None,
    base_model_name: str = "",
    non_lora_params: Optional[Tree] = None,
    dtype=np.float16,
) -> str:
    """Write a peft-format adapter dir the reference loader consumes
    (builder.py:52-86): adapter_model.bin + adapter_config.json, plus
    non_lora_trainables.bin when `non_lora_params` (e.g. {"mm_projector":
    ...}) is given. Inverse of convert.convert_peft_lora: our a (in, r) /
    b (r, out) transpose back to lora_A (r, in) / lora_B (out, r)."""
    os.makedirs(out_dir, exist_ok=True)
    sd: Dict[str, np.ndarray] = {}
    targets = set()
    seen_r = r

    def walk(node, path):
        nonlocal seen_r
        if isinstance(node, dict) and set(node) >= {"a", "b"}:
            # path like llm/model/layer_N/attn/q_proj
            parts = path.split("/")
            if (len(parts) < 3
                    or not re.fullmatch(r"layer_\d+", parts[-3])
                    or parts[-2] not in ("attn", "mlp")):
                raise ValueError(
                    f"export_peft_lora: adapter at {path!r} is not a "
                    "layer_N/(attn|mlp)/<proj> target — peft's key layout "
                    "only covers decoder-layer projections (lm_head/vision "
                    "adapters have no reference-loadable encoding)"
                )
            layer = parts[-3].split("_")[1]
            block = {"attn": "self_attn", "mlp": "mlp"}[parts[-2]]
            proj = parts[-1]
            targets.add(proj)
            a, b = np.asarray(node["a"]), np.asarray(node["b"])
            seen_r = a.shape[1]
            hf = (f"base_model.model.model.layers.{layer}.{block}.{proj}")
            sd[hf + ".lora_A.weight"] = _f(a.T, dtype)
            sd[hf + ".lora_B.weight"] = _f(b.T, dtype)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)

    walk(lora, "")
    if not sd:
        raise ValueError(
            "export_peft_lora: no {a, b} adapter leaves in the tree — this "
            "looks like a full param tree; use export_llava_hf instead"
        )
    _save_torch_bin(sd, os.path.join(out_dir, "adapter_model.bin"))
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "task_type": "CAUSAL_LM",
            "r": int(seen_r or 0),
            "lora_alpha": alpha,
            "lora_dropout": 0.0,
            "bias": "none",
            "target_modules": sorted(targets),
            "base_model_name_or_path": base_model_name,
        }, f, indent=2)

    if non_lora_params:
        extra: Dict[str, np.ndarray] = {}
        if "mm_projector" in non_lora_params:
            for k, v in export_projector_sd(
                    non_lora_params["mm_projector"], dtype=dtype).items():
                extra["base_model.model." + k] = v
        if extra:
            _save_torch_bin(
                extra, os.path.join(out_dir, "non_lora_trainables.bin"))
    return out_dir


# ------------------------------------------- the bridge from a port model


def _numpy_leaves(node):
    """A tree of torch tensors -> the same tree of numpy arrays on the host:
    float leaves as fp32 (bf16 and fp16 exactly), integer ones unchanged."""
    if isinstance(node, Mapping):
        return {k: _numpy_leaves(v) for k, v in node.items()}
    t = node.detach()
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


def params_from_model(model) -> Tree:
    """A built port LlavaForCausalLM (or bare LlamaForCausalLM) -> the JAX
    package's numpy param tree, which the export functions above take: the
    inverse of models/convert.py `load_jax_params`. Float weights become
    fp32 arrays (kernels (in, out), the patch conv (P, P, 3, D)); int8
    QuantDense layers {kernel int8, scale}; packed int4 layers {kernel,
    scale (in/G, out)} as they are (`_kernel` refuses them); a model built
    with fuse_proj gets its qkv_proj / gate_up_proj split back. Attached
    LoRA adapters are not part of the tree: `lora_params` exports them."""
    from rlaifv_tpu_torch.models.convert import flax_tree

    tree = _numpy_leaves(flax_tree(model))
    vision = tree.get("vision_tower")
    if vision is not None and "patch_embed" in vision:
        P = model.cfg.vision.patch_size
        k = vision["patch_embed"]["kernel"]
        vision["patch_embed"]["kernel"] = k.reshape(P, P, -1, k.shape[-1])
    llm_cfg = model.cfg.llm if hasattr(model.cfg, "llm") else model.cfg
    if llm_cfg.fuse_proj:
        if "llm" in tree:
            tree["llm"] = unfuse_llm_projections(tree["llm"], llm_cfg)
        else:
            tree = unfuse_llm_projections(tree, llm_cfg)
    return tree


def lora_params(lora: Mapping[str, Any]) -> Tree:
    """train/lora.py's adapter tree ({.../q_proj: {a (in, r), b (r, out)}},
    torch tensors on any device) -> the same tree of fp32 numpy arrays,
    as `export_peft_lora` takes it."""
    return _numpy_leaves(lora)
