"""models/export.py and `python -m rlaifv_tpu_torch.export` on a tiny LLaVA
bridged from a JAX param tree.

- The port's export of the bridged model (`params_from_model`) equals the
  JAX package's export of the tree, key for key and bit for bit, at fp32
  and fp16, from an fp32 and a bf16 model;
- export_llava_hf -> the port's load_pretrained_llava -> the same model
  (the round-trip cases of tests/test_export_hf.py);
- an int8 model exports dequantised as the JAX function does; a model
  fused in place exports unfused (float and int8);
- export_peft_lora -> load_pretrained_llava(adapter, base) is the merged
  model;
- int4: the port refuses a packed kernel (ValueError) where the JAX
  function raises, and also where it would write the packed bytes as float
  weights (one group spanning the input): a deliberate difference;
- the CLI on a demo run (full; a use_lora config trains full there too) and
  on a LoRA trainer run (peft).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models import convert as jconv
from rlaifv_tpu.models import export as jexport
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.models import convert as tconv
from rlaifv_tpu_torch.models import export as texport
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM


def _tree_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {set(a) ^ set(b)}"
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _sd_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _np_tree(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _np_tree(v, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(dtype) if dtype is not None and a.dtype.kind == "f" else a


@pytest.fixture(scope="module")
def jparams():
    cfg = JLlavaConfig.tiny()
    S = cfg.vision.image_size
    params = JLlava(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, cfg.num_image_tokens + 4), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]),
    )["params"]
    return _np_tree(params, np.float32)


def _model(params, dtype=torch.float32):
    cfg = LlavaConfig.tiny(dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype,
                                                              param_dtype=dtype))
    return tconv.load_jax_params(LlavaForCausalLM(cfg), params).eval()


def _bf16(tree):
    """The tree as a bf16 model holds it (values rounded, fp32 arrays)."""
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), tree)


@pytest.mark.parametrize("model_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("export_dtype", [np.float32, np.float16])
def test_export_matches_jax_key_for_key(jparams, model_dtype, export_dtype):
    dtype = getattr(torch, model_dtype)
    tree = jparams if dtype == torch.float32 else _bf16(jparams)
    model = _model(jparams, dtype)
    bridged = texport.params_from_model(model)
    _tree_equal(bridged, tree)
    _sd_equal(texport.export_llava_sd(bridged, dtype=export_dtype),
              jexport.export_llava_sd(tree, dtype=export_dtype))


def _logits(model, ids):
    with torch.no_grad():
        return model.llm(input_ids=ids)[0]


@pytest.mark.parametrize("export_dtype", [np.float32, np.float16])
def test_export_hf_reloads_to_the_same_model(jparams, tmp_path, export_dtype):
    model = _model(jparams)
    tree = texport.params_from_model(model)
    with pytest.warns(UserWarning, match="without base_dir"):
        out = texport.export_llava_hf(tree, str(tmp_path / "ckpt"), cfg=model.cfg,
                                      dtype=export_dtype)
    assert os.path.exists(os.path.join(out, "pytorch_model.bin"))
    back = tconv.load_pretrained_llava(out, dtype=np.float32)
    want = _np_tree(_np_tree(tree, export_dtype), np.float32)
    _tree_equal(back, want)
    # the JAX package reads the port's export the same way
    _tree_equal(_np_tree(jconv.load_pretrained_llava(out, dtype=np.float32)), want)
    cfg2 = tconv.llava_config_from_hf(out)
    assert (cfg2.llm.hidden_size, cfg2.llm.num_layers, cfg2.llm.num_kv_heads) == \
        (model.cfg.llm.hidden_size, model.cfg.llm.num_layers, model.cfg.llm.num_kv_heads)
    assert cfg2.vision.num_layers == model.cfg.vision.num_layers
    assert cfg2.projector_type == model.cfg.projector_type
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["architectures"] == ["LlavaLlamaForCausalLM"]
    reloaded = tconv.load_jax_params(LlavaForCausalLM(cfg2), back).eval()
    ids = torch.arange(3, 13)[None]
    if export_dtype == np.float32:
        for k, v in model.state_dict().items():
            torch.testing.assert_close(reloaded.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(_logits(reloaded, ids), _logits(model, ids), rtol=0, atol=0)
    else:
        ref = _logits(model, ids)
        assert (_logits(reloaded, ids) - ref).abs().max() < 1e-2 * ref.abs().max()


def test_export_hf_with_base_dir_carries_its_extra_tensors(jparams, tmp_path):
    model = _model(jparams)
    tree = texport.params_from_model(model)
    with pytest.warns(UserWarning):
        base = texport.export_llava_hf(tree, str(tmp_path / "base"), cfg=model.cfg,
                                       dtype=np.float32)
    sd = torch.load(os.path.join(base, "pytorch_model.bin"), weights_only=True)
    sd["model.image_newline"] = torch.arange(4.0)
    torch.save(sd, os.path.join(base, "pytorch_model.bin"))
    with open(os.path.join(base, "tokenizer_config.json"), "w") as f:
        f.write('{"x": 1}')
    got = texport.export_llava_hf(tree, str(tmp_path / "port"), base_dir=base)
    want = jexport.export_llava_hf(jparams, str(tmp_path / "jax"), base_dir=base)
    for name in ("config.json", "tokenizer_config.json"):
        assert open(os.path.join(got, name)).read() == open(os.path.join(want, name)).read()
    g = torch.load(os.path.join(got, "pytorch_model.bin"), weights_only=True)
    w = torch.load(os.path.join(want, "pytorch_model.bin"), weights_only=True)
    _sd_equal({k: v.numpy() for k, v in g.items()}, {k: v.numpy() for k, v in w.items()})
    assert "model.image_newline" in g


def test_int8_exports_dequantized_as_jax(jparams):
    model = tconv.quantize_llm_int8(_model(jparams))
    bridged = texport.params_from_model(model)
    jq = jconv.quantize_llm_int8(jparams["llm"])
    _tree_equal(bridged["llm"], _np_tree(jq))
    got = texport.export_llama_sd(bridged["llm"], dtype=np.float32)
    _sd_equal(got, jexport.export_llama_sd(_np_tree(jq), dtype=np.float32))
    node = bridged["llm"]["model"]["layer_0"]["attn"]["q_proj"]
    np.testing.assert_array_equal(
        got["model.layers.0.self_attn.q_proj.weight"],
        (node["kernel"].astype(np.float32) * node["scale"][None, :]).T)


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_model_exports_unfused(jparams, quantized):
    plain = _model(jparams)
    fused = _model(jparams)
    if quantized:
        tconv.quantize_llm_int8(plain)
        tconv.quantize_llm_int8(fused)
    tconv.fuse_llm_projections_(fused)
    assert fused.cfg.llm.fuse_proj and hasattr(fused.llm.model.layers[0].attn, "qkv_proj")
    _tree_equal(texport.params_from_model(fused), texport.params_from_model(plain))
    # unfuse_llm_projections inverts the JAX tree rewrite the in-place fuse mirrors
    llm = texport.params_from_model(plain)["llm"]
    _tree_equal(texport.unfuse_llm_projections(tconv.fuse_llm_projections(llm),
                                               plain.cfg.llm), llm)


def test_peft_export_reloads_to_the_merged_model(jparams, tmp_path):
    from rlaifv_tpu_torch.train.lora import attach_lora, lora_init, lora_merge, lora_scaled

    model = _model(jparams)
    lora = lora_init(torch.Generator().manual_seed(1), model, r=4)
    g = torch.Generator().manual_seed(2)
    for layer in lora["llm"]["model"].values():
        for block in layer.values():
            for node in block.values():
                node["b"] = torch.randn(node["b"].shape, generator=g) * 0.05
    tree = texport.params_from_model(model)
    with pytest.warns(UserWarning):
        base = texport.export_llava_hf(tree, str(tmp_path / "base"), cfg=model.cfg,
                                       dtype=np.float32)
    adapters = texport.lora_params(lora)
    out = texport.export_peft_lora(adapters, str(tmp_path / "adapter"), alpha=16.0,
                                   non_lora_params={"mm_projector": tree["mm_projector"]},
                                   dtype=np.float32)
    with open(os.path.join(out, "adapter_config.json")) as f:
        acfg = json.load(f)
    assert acfg["r"] == 4 and acfg["peft_type"] == "LORA"
    assert acfg["target_modules"] == sorted(
        ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"])
    _tree_equal(tconv.convert_peft_lora(
        torch.load(os.path.join(out, "adapter_model.bin"), weights_only=True)), adapters)
    merged = tconv.load_pretrained_llava(out, base, dtype=np.float32, lora_alpha=16.0)
    _tree_equal(merged, lora_merge(tree, adapters, alpha=16.0))
    reloaded = tconv.load_jax_params(LlavaForCausalLM(tconv.llava_config_from_hf(base)),
                                     merged).eval()
    attach_lora(model, lora_scaled(lora, 16.0))
    ids = torch.arange(3, 13)[None]
    want = _logits(model, ids)
    assert (_logits(reloaded, ids) - want).abs().max() < 1e-5 * want.abs().max()


def test_int4_export_raises(jparams):
    """A deliberate difference. One int4 group spanning the input (the tiny
    model's 64-wide layers): the JAX `_kernel` broadcasts the packed bytes
    against the scales and writes them as float weights; the port raises.
    Two groups and more: both raise ValueError."""
    from rlaifv_tpu_torch.ops.int4_matmul import quantize_int4

    model = tconv.quantize_llm_int4(_model(jparams))
    bridged = texport.params_from_model(model)
    node = bridged["llm"]["model"]["layer_0"]["attn"]["q_proj"]
    assert node["kernel"].dtype == np.int8 and node["scale"].shape == (1, 64)
    with pytest.raises(ValueError, match="packed int4"):
        texport.export_llama_sd(bridged["llm"])
    bad = jexport._kernel(node)  # (1, 32, 64): packed bytes as floats
    assert bad.shape == (1, 32, 64)
    q, s = quantize_int4(np.random.default_rng(0).normal(size=(256, 8)).astype(np.float32),
                         group=128)
    for fn in (jexport._kernel, texport._kernel):
        with pytest.raises(ValueError):
            fn({"kernel": q, "scale": s})


def _write_config(path, **training):
    from rlaifv_tpu_torch.core.config import Config

    config = Config()
    for k, v in training.items():
        setattr(config.training, k, v)
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    return str(path)


def _reload(out):
    cfg = tconv.llava_config_from_hf(out)
    return tconv.load_jax_params(LlavaForCausalLM(cfg),
                                 tconv.load_pretrained_llava(out, dtype=np.float32))


@pytest.mark.parametrize("use_lora", [False, True])
def test_cli_on_a_demo_run(tmp_path, use_lora):
    """A demo run trains the full tiny LLaVA under any config; its
    checkpoint carries the model's class and config, which the CLI builds
    to write the full model."""
    from rlaifv_tpu_torch.core.checkpoint import CheckpointManager
    from rlaifv_tpu_torch.export import llava_config
    from rlaifv_tpu_torch.export import main as export_main
    from rlaifv_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    config = _write_config(tmp_path / "cfg.json", use_lora=use_lora, output_dir=run)
    train_main(["--demo", "--config", config, "--device", "cpu", "--max-steps", "2"])
    out = export_main(["--config", config, "--out", str(tmp_path / "hf")])
    assert sorted(os.listdir(out)) == ["config.json", "pytorch_model.bin"]
    saved = CheckpointManager(os.path.join(run, "checkpoints")).restore()
    assert saved["model"]["class"] == "LlavaForCausalLM"
    assert llava_config(saved["model"]["config"]) == LlavaConfig.tiny()
    state = saved["params"]
    for k, v in _reload(out).state_dict().items():
        torch.testing.assert_close(v, state[k].half().float(), rtol=0, atol=0)


def test_cli_refuses_a_full_export_of_another_family(tmp_path):
    from rlaifv_tpu_torch.export import main as export_main
    from rlaifv_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    config = _write_config(tmp_path / "cfg.json", use_lora=False, output_dir=run)
    train_main(["--demo", "--family", "omnilmm", "--config", config, "--device", "cpu",
                "--max-steps", "1"])
    with pytest.raises(ValueError, match="OmniLMMForCausalLM"):
        export_main(["--config", config, "--out", str(tmp_path / "hf")])


def test_cli_on_a_lora_run(tmp_path):
    from rlaifv_tpu_torch.core.checkpoint import CheckpointManager
    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.export import main as export_main
    from rlaifv_tpu_torch.models.llava import init_weights_
    from rlaifv_tpu_torch.train.__main__ import lora_kwargs
    from rlaifv_tpu_torch.train.family import get_family
    from rlaifv_tpu_torch.train.lora import lora_merge
    from rlaifv_tpu_torch.train.trainer import DPOTrainer
    from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

    run = str(tmp_path / "run")
    path = _write_config(tmp_path / "cfg.json", use_lora=True, lora_r=4, lora_alpha=8.0,
                         output_dir=run, max_steps=2, save_steps=2, learning_rate=1e-2)
    config = Config.from_json(path)
    cfg = LlavaConfig.tiny()
    model = init_weights_(LlavaForCausalLM(cfg), torch.Generator().manual_seed(0))
    pairs = synth_preference_pairs(cfg, 4, answer_len=8, question_len=6)
    collator = DPOCollator(pad_token_id=0, max_len=64, num_patches=cfg.num_image_tokens)
    DPOTrainer(config, model, pairs, collator, adapter=get_family("llava15").adapter(model),
               **lora_kwargs(config, model, "cpu")).train()
    out = export_main(["--config", path, "--out", str(tmp_path / "peft")])
    with open(os.path.join(out, "adapter_config.json")) as f:
        acfg = json.load(f)
    assert acfg["r"] == 4 and acfg["lora_alpha"] == 8.0
    state = CheckpointManager(os.path.join(run, "checkpoints")).restore()["params"]
    adapters = {}
    for p, v in state.items():
        node = adapters
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v.numpy()
    assert any(np.abs(n).max() > 0 for n in (
        adapters["llm"]["model"]["layer_0"]["attn"]["q_proj"]["b"],))  # trained
    tree = texport.params_from_model(model)
    with pytest.warns(UserWarning):
        base = texport.export_llava_hf(tree, str(tmp_path / "base"), cfg=cfg,
                                       dtype=np.float32)
    merged = tconv.load_pretrained_llava(out, base, dtype=np.float32, lora_alpha=8.0)
    want = lora_merge(tree, _np_tree(_np_tree(adapters, np.float16), np.float32), alpha=8.0)
    _tree_equal(merged, want)
