"""The port's LLaVA-1.5 modules against the JAX package's, on the CPU.

One flax param tree (LlavaConfig.tiny(), fp32) is bridged into the torch
model with `llava_params_from_jax`; the same numpy-seeded inputs then go
through both. Tolerance: atol 1e-4 (fp32, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.models.convert import llava_params_from_jax, load_jax_params
from rlaifv_tpu_torch.models.llama import LlamaConfig
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = JLlavaConfig.tiny()
    jmodel = JLlava(jcfg)
    P = jcfg.num_image_tokens
    S = jcfg.vision.image_size
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]),
    )["params"]
    tmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    return jmodel, params, tmodel


def _apply(jmodel, params, fn, *args, **kw):
    return jmodel.apply({"params": params}, *args, method=fn, **kw)


def test_bridge_covers_every_parameter(pair):
    jmodel, params, tmodel = pair
    sd = llava_params_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tmodel.parameters())


def test_clip_tower_matches_jax(pair):
    jmodel, params, tmodel = pair
    S = tmodel.cfg.vision.image_size
    img = np.random.default_rng(0).normal(size=(2, S, S, 3)).astype(np.float32)
    want = _apply(jmodel, params, lambda m, x: m.vision_tower(x), jnp.asarray(img))
    with torch.no_grad():
        got = tmodel.vision_tower(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode_images_uint8_matches_jax(pair):
    jmodel, params, tmodel = pair
    S = tmodel.cfg.vision.image_size
    img = np.random.default_rng(1).integers(0, 256, size=(2, S, S, 3), dtype=np.uint8)
    want = _apply(jmodel, params, lambda m, x: m.encode_images(x), jnp.asarray(img))
    with torch.no_grad():
        got = tmodel.encode_images(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_llava_forward_with_image_matches_jax(pair):
    """Spliced image features + left-padded text through the whole model."""
    jmodel, params, tmodel = pair
    cfg = tmodel.cfg
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    rng = np.random.default_rng(2)
    L = P + 12
    ids = rng.integers(3, 200, size=(2, L)).astype(np.int32)
    ids[:, 3:3 + P] = -200  # image sentinels
    mask = np.ones((2, L), np.int32)
    mask[1, :2] = 0
    starts = np.asarray([3, 3], np.int32)
    img = rng.integers(0, 256, size=(2, S, S, 3), dtype=np.uint8)
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                           images=jnp.asarray(img), image_starts=jnp.asarray(starts),
                           attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(ids).long(), images=torch.from_numpy(img),
                        image_starts=starts, attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_llm_logits_with_cache_match_jax(pair):
    """No cache, then prefill into a static cache and 3 decode steps."""
    jmodel, params, tmodel = pair
    lm_cfg = tmodel.cfg.llm
    B, Lp, max_len = 2, 10, 16
    rng = np.random.default_rng(3)
    ids = rng.integers(3, lm_cfg.vocab_size, size=(B, Lp + 3)).astype(np.int32)
    mask = np.zeros((B, max_len), np.int32)
    mask[0, :Lp] = 1
    mask[1, 2:Lp] = 1  # left-padded row
    pos = np.maximum(np.cumsum(mask[:, :Lp], axis=1) - 1, 0)

    def jllm(**kw):
        return jmodel.apply({"params": params}, method=lambda m, **k: m.llm(**k), **kw)

    want, _ = jllm(input_ids=jnp.asarray(ids[:, :Lp]),
                   attention_mask=jnp.asarray(mask[:, :Lp]))
    with torch.no_grad():
        got, _ = tmodel.llm(torch.from_numpy(ids[:, :Lp]).long(),
                            attention_mask=torch.from_numpy(mask[:, :Lp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    jcache = jmodel.apply({"params": params}, B, max_len,
                          method=lambda m, b, n: m.init_cache(b, n))
    tcache = tmodel.init_cache(B, max_len)
    want, jcache = jllm(input_ids=jnp.asarray(ids[:, :Lp]),
                        attention_mask=jnp.asarray(mask), position_ids=jnp.asarray(pos),
                        cache=jcache, cache_index=0)
    with torch.no_grad():
        got, tcache = tmodel.llm(torch.from_numpy(ids[:, :Lp]).long(),
                                 attention_mask=torch.from_numpy(mask),
                                 position_ids=torch.from_numpy(pos), cache=tcache,
                                 cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    for t in range(3):
        mask[:, Lp + t] = 1
        step_pos = mask.sum(axis=1, keepdims=True) - 1
        tok = ids[:, Lp + t:Lp + t + 1]
        want, jcache = jllm(input_ids=jnp.asarray(tok), attention_mask=jnp.asarray(mask),
                            position_ids=jnp.asarray(step_pos), cache=jcache,
                            cache_index=jnp.int32(Lp + t))
        with torch.no_grad():
            got, tcache = tmodel.llm(torch.from_numpy(tok).long(),
                                     attention_mask=torch.from_numpy(mask),
                                     position_ids=torch.from_numpy(step_pos),
                                     cache=tcache, cache_index=Lp + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(tcache[0]["k"].numpy(), np.asarray(jcache[0]["k"]),
                                   atol=ATOL)


@pytest.mark.parametrize("option,value,item", [
    ("quantize_bits", 4, "#5"), ("kv_cache_dtype", "int8", "#6"),
    ("fuse_proj", True, "#6"),
])
def test_unported_options_raise(option, value, item):
    """int4 weights (quantize with quantize_bits 4; int8 is ported), the
    int8 KV cache and fused projections raise naming their ROADMAP item."""
    from rlaifv_tpu_torch.models.llama import LlamaForCausalLM

    kw = {option: value, **({"quantize": True} if option == "quantize_bits" else {})}
    with pytest.raises(NotImplementedError, match=item):
        LlamaForCausalLM(LlamaConfig.tiny(**kw), device="meta")


def test_lora_adapters_and_anyres_raise():
    """A {"params", "lora"} variables dict bridges its base (the adapters
    cross with lora_from_jax); an int4 tree (packed kernel, 2-D group
    scales) raises naming #5, anyres #8."""
    assert llava_params_from_jax({"params": {}, "lora": {}}) == {}
    int4 = {"llm": {"model": {"layer_0": {"attn": {"q_proj": {
        "kernel": np.zeros((32, 64), np.int8), "scale": np.ones((1, 64), np.float32)}}}}}}
    with pytest.raises(NotImplementedError, match="#5"):
        llava_params_from_jax(int4)
    with pytest.raises(NotImplementedError, match="#5"):
        llava_params_from_jax({"params": int4, "lora": {}})
    with pytest.raises(NotImplementedError, match="#8"):
        LlavaForCausalLM(LlavaConfig(image_aspect_ratio="anyres"), device="meta")


def test_remat_recomputes_per_block_with_the_same_result(pair):
    """remat=True: activation checkpointing per block under autograd (the
    hidden states and every gradient equal the plain forward's to fp32
    rounding), and no checkpointing under no_grad or with a cache."""
    jmodel, params, _ = pair
    plain = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params)
    remat = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny(remat=True)), params)
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(3, 200, size=(2, 20))).long()
    mask = torch.ones((2, 20), dtype=torch.int32)
    mask[1, :4] = 0
    outs = []
    for model in (plain, remat):
        hidden = model.hidden_text(ids, mask)
        hidden.square().mean().backward()
        outs.append((hidden.detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-6, rtol=0)
    for name, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], g, atol=1e-6, rtol=1e-5)
    with torch.no_grad():
        logits, _ = remat.llm(ids, attention_mask=mask)
    np.testing.assert_allclose(logits.numpy(), plain.llm(ids, attention_mask=mask)[0]
                               .detach().numpy(), atol=ATOL)
