"""The port's OmniLMM-12B modules against the JAX package's, on the CPU.

Flax param trees (tiny widths, fp32) are bridged into the torch modules
with `load_jax_params` (`llava_params_from_jax`); the same numpy-seeded
inputs go through both.

- `interp_abs_pos` against the JAX one (jax.image.resize bicubic) at
  16->32, 8->32, 32->16 and two odd shapes, fp32, within 1e-5 of a
  unit-normal table;
- the Resampler (query positions on and off, an explicit tgt_hw), the
  EvaVisionTower (the enormous layout at tiny widths, at the table's grid
  and at twice it, then rope, SwiGLU with sub-LN, post-norm and split
  q/k/v), OmniLMMForCausalLM's logits (bf16 weights off, fp32 throughout):
  within 1e-4 x max(1, max|JAX|);
- QuantDense with a bias, bits 8 and 4, against the JAX QuantDense's
  off-TPU formula (1e-5 relative);
- `quantize_vision_int8/int4` (in place) bit-equal to the JAX numpy
  quantisers' trees, the int8 and int4 models' logits against JAX's;
- `convert_eva02`, `convert_resampler`, `convert_omnilmm` and
  `omnilmm_config_from_hf` on a tiny real-format state dict, equal to the
  JAX converters' trees and configs (the q/v-bias convention and the dead
  last block included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import eva02 as jeva
from rlaifv_tpu.models import omnilmm as jomni
from rlaifv_tpu.models import resampler as jres
from rlaifv_tpu.models.llama import QuantDense as JQuantDense
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import eva02 as teva
from rlaifv_tpu_torch.models import omnilmm as tomni
from rlaifv_tpu_torch.models import resampler as tres
from rlaifv_tpu_torch.models.llama import LlamaConfig, QuantDense

REL = 1e-4  # of max(1, max|JAX|), fp32, sums in another order


def _close(got: torch.Tensor, want, rel: float = REL) -> None:
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------ interp_abs_pos


@pytest.mark.parametrize("src,tgt", [(16, 32), (8, 32), (32, 16), (24, 10), (7, 5)])
def test_interp_abs_pos_matches_jax(src, tgt):
    table = np.random.default_rng(src * 100 + tgt).standard_normal((src * src, 24))
    table = table.astype(np.float32)
    want = jres.interp_abs_pos(jnp.asarray(table), tgt * tgt)
    got = tres.interp_abs_pos(torch.from_numpy(table), tgt * tgt)
    assert got.shape == (tgt * tgt, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_interp_abs_pos_is_not_torch_bicubic():
    """F.interpolate's bicubic is another function (why the weight matrix)."""
    table = np.random.default_rng(0).standard_normal((16 * 16, 8)).astype(np.float32)
    ours = tres.interp_abs_pos(torch.from_numpy(table), 32 * 32)
    grid = torch.from_numpy(table).reshape(1, 16, 16, 8).permute(0, 3, 1, 2)
    theirs = torch.nn.functional.interpolate(grid, size=(32, 32), mode="bicubic",
                                             align_corners=False)
    theirs = theirs.permute(0, 2, 3, 1).reshape(32 * 32, 8)
    assert (ours - theirs).abs().max() > 0.05
    same = tres.interp_abs_pos(torch.from_numpy(table), 16 * 16)
    assert torch.equal(same, torch.from_numpy(table))


def test_sincos_tables_equal_jax():
    np.testing.assert_array_equal(tres.sincos_2d(16, 4), jres.sincos_2d(16, 4))
    np.testing.assert_array_equal(tres.sincos_2d_rect(8, 2, 3), jres.sincos_2d_rect(8, 2, 3))
    for a, b in zip(teva.rope_2d(3, 4, 16), jeva.rope_2d(3, 4, 16)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)


# ------------------------------------------------------------ the resampler


RES_CASES = {
    "omnilmm": dict(cfg=dict(grid_size=2, embed_dim=32, num_heads=4, kv_dim=24), n=16, hw=None),
    "same width": dict(cfg=dict(grid_size=3, embed_dim=24, num_heads=2, kv_dim=24), n=9,
                       hw=None),
    "no query pos": dict(cfg=dict(grid_size=1, embed_dim=32, num_heads=4, kv_dim=24,
                                  num_queries_override=6, query_pos=False), n=16, hw=None),
    "tgt_hw": dict(cfg=dict(grid_size=2, embed_dim=32, num_heads=4, kv_dim=24), n=12,
                   hw=(3, 4)),
    "no query pos, tgt_hw": dict(cfg=dict(grid_size=1, embed_dim=32, num_heads=4, kv_dim=24,
                                          num_queries_override=5, query_pos=False), n=10,
                                 hw=(2, 5)),
}


@pytest.mark.parametrize("name", list(RES_CASES))
def test_resampler_matches_jax(name):
    case = RES_CASES[name]
    jcfg = jres.ResamplerConfig(**case["cfg"])
    x = np.random.default_rng(1).standard_normal((2, case["n"], 24)).astype(np.float32)
    jmod = jres.Resampler(jcfg)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), tgt_hw=case["hw"])["params"]
    params = jax.tree.map(lambda a: a + 0.1 * jnp.sin(jnp.arange(a.size).reshape(a.shape)),
                          params)  # norms and biases off their init values
    want = jmod.apply({"params": params}, jnp.asarray(x), tgt_hw=case["hw"])
    tmod = tconvert.load_jax_params(tres.Resampler(tres.ResamplerConfig(**case["cfg"])),
                                    params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), tgt_hw=case["hw"])
    assert got.shape == (2, jcfg.num_queries, jcfg.embed_dim)
    _close(got, want)


# ------------------------------------------------------------ the EVA02 tower


EVA_CASES = {
    "enormous layout": dict(),
    "rope": dict(use_rope=True),
    "swiglu subln": dict(use_swiglu=True, subln=True),
    "swiglu": dict(use_swiglu=True),
    "post-norm": dict(use_post_norm=True),
    "split qkv": dict(qkv_fused=False),
    "rope, split qkv, swiglu subln, post-norm": dict(use_rope=True, qkv_fused=False,
                                                     use_swiglu=True, subln=True,
                                                     use_post_norm=True),
}


def _eva_pair(kw, seed=0):
    jcfg = jeva.EvaConfig.tiny(**kw)
    jmod = jeva.EvaVisionTower(jcfg)
    S = jcfg.image_size
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)))["params"]
    params = jax.tree.map(lambda a: a * 2.0, params)
    tmod = tconvert.load_jax_params(teva.EvaVisionTower(teva.EvaConfig.tiny(**kw)),
                                    params).eval()
    return jmod, params, tmod


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("name", list(EVA_CASES))
def test_eva_tower_matches_jax(name, scale):
    """At the table's grid (28 px, 4 x 4 patches) and at twice it (56 px:
    the position table re-gridded 4 -> 8, as 224 -> 448 at full size)."""
    jmod, params, tmod = _eva_pair(EVA_CASES[name])
    S = tmod.cfg.image_size * scale
    img = np.random.default_rng(scale).standard_normal((2, S, S, 3)).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = tmod(torch.from_numpy(img))
    grid = S // tmod.cfg.patch_size
    assert got.shape == (2, grid * grid, tmod.cfg.embed_dim)
    _close(got, want)


def test_eva_tower_runs_depth_minus_one_blocks():
    tower = teva.EvaVisionTower(teva.EvaConfig.tiny(depth=5))
    assert len(tower.blocks) == 4
    enormous = teva.EvaConfig.enormous()
    assert (enormous.embed_dim, enormous.depth, enormous.num_heads, enormous.mlp_hidden,
            enormous.patch_size, enormous.grid) == (1792, 64, 16, 15360, 14, 16)


# ------------------------------------------------------------ QuantDense + bias


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_dense_bias_matches_jax(bits):
    """QuantDense(bias) = x @ dequant(q, scale) + bias, the JAX off-TPU
    formula (K = 256: two int4 groups of 128)."""
    K, N = 256, 160
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    bias = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    if bits == 4:
        q, s = jconvert.quantize_vision_int4({"fc1": {"kernel": w}})["fc1"].values()
    else:
        q, s = jconvert.quantize_vision_int8({"fc1": {"kernel": w}})["fc1"].values()
    jmod = JQuantDense(N, dtype=jnp.float32, use_bias=True, bits=bits)
    want = jmod.apply({"params": {"kernel": q, "scale": s, "bias": bias}}, jnp.asarray(x))
    tmod = QuantDense(K, N, dtype=torch.float32, bits=bits, bias=True)
    tmod.q.copy_(torch.from_numpy(np.asarray(q)))
    tmod.scale.copy_(torch.from_numpy(np.asarray(s)))
    tmod.bias.copy_(torch.from_numpy(bias))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert QuantDense(K, N, dtype=torch.float32, bits=bits).bias is None


# ------------------------------------------------------------ the model


def _omni_pair(seed=0, vocab=256):
    jcfg = jomni.OmniLMMConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=vocab))
    jmod = jomni.OmniLMMForCausalLM(jcfg)
    S = jcfg.vision.image_size
    params = jmod.init(jax.random.PRNGKey(seed), jnp.ones((1, jcfg.num_query + 8), jnp.int32),
                       images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([1]))["params"]
    tcfg = tomni.OmniLMMConfig.tiny(vocab_size=vocab)
    return jcfg, jmod, _np_tree(params), tcfg


@pytest.fixture(scope="module")
def omni():
    jcfg, jmod, params, tcfg = _omni_pair()
    tmod = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tcfg), params).eval()
    return jcfg, jmod, params, tmod


def _inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    Q, S = cfg.num_query, cfg.vision.image_size
    L = Q + 12
    ids = rng.integers(3, 200, size=(2, L)).astype(np.int32)
    starts = np.asarray([3, 5], np.int32)
    mask = np.ones((2, L), np.int32)
    mask[1, :2] = 0
    img = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    return ids, starts, mask, img


def test_bridge_covers_every_parameter(omni):
    _, _, params, tmod = omni
    sd = tconvert.llava_params_from_jax(params)
    assert set(sd) == set(tmod.state_dict())
    assert sum(np.asarray(x).size for x in jax.tree.leaves(params)) == \
        sum(p.numel() for p in tmod.parameters())
    assert "vision_tower.blocks.1.attn.qkv.bias" in sd and "resampler.proj" in sd


def test_omnilmm_logits_match_jax(omni):
    jcfg, jmod, params, tmod = omni
    ids, starts, mask, img = _inputs(jcfg)
    want, _ = jmod.apply({"params": params}, jnp.asarray(ids), images=jnp.asarray(img),
                         image_starts=jnp.asarray(starts), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(ids), images=torch.from_numpy(img),
                      image_starts=starts, attention_mask=torch.from_numpy(mask))
    _close(got, want)


def test_encode_images_and_feature_paths_match_jax(omni):
    jcfg, jmod, params, tmod = omni
    ids, starts, mask, img = _inputs(jcfg, seed=3)
    ap = lambda fn, *a: jmod.apply({"params": params}, *a, method=fn)  # noqa: E731
    feats = ap(lambda m, x: m.encode_images(x), jnp.asarray(img))
    with torch.no_grad():
        tfeats = tmod.encode_images(torch.from_numpy(img))
        _close(tfeats, feats)
        args = (torch.from_numpy(ids), tfeats, starts, torch.from_numpy(mask))
        _close(tmod.forward_with_features(*args),
               ap(lambda m, *a: m.forward_with_features(*a), jnp.asarray(ids), feats,
                  jnp.asarray(starts), jnp.asarray(mask)))
        _close(tmod.hidden_with_features(*args),
               ap(lambda m, *a: m.hidden_with_features(*a), jnp.asarray(ids), feats,
                  jnp.asarray(starts), jnp.asarray(mask)))
        _close(tmod.forward_text(torch.from_numpy(ids)),
               ap(lambda m, i: m.forward_text(i), jnp.asarray(ids)))
    assert tomni.find_image_start([5, 6, 99, 99, 7], 99) == 2
    assert tomni.find_image_start([5, 6, 7], 99) == -1


def test_random_init_is_seeded_and_finite():
    cfg = tomni.OmniLMMConfig.tiny()
    a = tomni.init_omnilmm_weights_(tomni.OmniLMMForCausalLM(cfg),
                                    torch.Generator().manual_seed(0))
    b = tomni.init_omnilmm_weights_(tomni.OmniLMMForCausalLM(cfg),
                                    torch.Generator().manual_seed(0))
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    np.testing.assert_array_equal(a.resampler.pos_embed.detach().numpy(), tres.sincos_2d(64, 2))
    assert a.vision_tower.cls_token.abs().max() > 0 and a.resampler.proj.abs().max() > 0
    ids, starts, mask, img = _inputs(cfg)
    with torch.no_grad():
        logits, _ = a(torch.from_numpy(ids), images=torch.from_numpy(img), image_starts=starts)
    assert torch.isfinite(logits).all()


def test_presets_match_jax():
    for name in ("omnilmm_12b", "omnilmm_12b_int8"):
        t, j = getattr(tomni.OmniLMMConfig, name)(), getattr(jomni.OmniLMMConfig, name)()
        for sub in ("llm", "vision"):
            tf = {k: v for k, v in dataclasses.asdict(getattr(t, sub)).items()
                  if k not in ("dtype", "param_dtype")}
            jf = {k: v for k, v in dataclasses.asdict(getattr(j, sub)).items()
                  if k in tf}
            assert tf == jf, (name, sub)
        assert t.num_query == j.num_query == 64
        r, jr = t.resampler, j.resampler
        assert (r.grid_size, r.embed_dim, r.num_heads, r.kv_dim) == \
            (jr.grid_size, jr.embed_dim, jr.num_heads, jr.kv_dim) == (8, 4096, 32, 1792)
    assert LlamaConfig.mistral_7b().num_kv_heads == 8


# ------------------------------------------------------------ quantisation


def _quantized_jax(params, bits):
    if bits == 4:
        return {**params, "llm": jconvert.quantize_llm_int4(params["llm"]),
                "vision_tower": jconvert.quantize_vision_int4(params["vision_tower"])}
    return {**params, "llm": jconvert.quantize_llm_int8(params["llm"], include_lm_head=False),
            "vision_tower": jconvert.quantize_vision_int8(params["vision_tower"])}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_vision_in_place_equals_jax(bits):
    """A port model quantised in place (both towers; the LM head float)
    holds the JAX numpy quantisers' trees bit for bit, biases kept, and
    its logits (int8 KV cache, fp32) match the JAX quantised model's."""
    jcfg, jmod, params, tcfg = _omni_pair(seed=1)
    params = jax.tree.map(lambda a: a * 2.0, params)
    tmod = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tcfg), params)
    quant_llm = tconvert.quantize_llm_int4 if bits == 4 else tconvert.quantize_llm_int8
    quant_llm(tmod, include_lm_head=False)
    quant = tconvert.quantize_vision_int4 if bits == 4 else tconvert.quantize_vision_int8
    assert quant(tmod) is tmod
    assert tmod.cfg.vision.quantize and tmod.cfg.vision.quantize_bits == bits
    assert tmod.vision_tower.blocks[0].attn.cfg.quantize
    qkv = tmod.vision_tower.blocks[0].attn.qkv
    assert isinstance(qkv, QuantDense) and qkv.bias is not None and qkv.bits == bits
    assert not isinstance(tmod.vision_tower.patch_embed, QuantDense)

    jparams = _quantized_jax(params, bits)
    want_sd = tconvert.llava_params_from_jax(jparams)
    got_sd = tmod.state_dict()
    assert set(want_sd) == set(got_sd)
    for name, t in got_sd.items():
        assert torch.equal(t, want_sd[name].to(t.dtype)), name

    ids, starts, mask, img = _inputs(jcfg, seed=4)
    qcfg = jomni.OmniLMMConfig(
        llm=dataclasses.replace(jcfg.llm, quantize=True, quantize_bits=bits,
                                quantize_lm_head=False),
        vision=dataclasses.replace(jcfg.vision, quantize=True, quantize_bits=bits),
        num_query=jcfg.num_query)
    want, _ = jomni.OmniLMMForCausalLM(qcfg).apply(
        {"params": jparams}, jnp.asarray(ids), images=jnp.asarray(img),
        image_starts=jnp.asarray(starts), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(ids), images=torch.from_numpy(img),
                      image_starts=starts, attention_mask=torch.from_numpy(mask))
    _close(got, want)
    # the JAX tree bridges straight into a model built quantised
    built = tomni.OmniLMMForCausalLM(tomni.OmniLMMConfig(
        llm=dataclasses.replace(tcfg.llm, quantize=True, quantize_bits=bits,
                                quantize_lm_head=False),
        vision=dataclasses.replace(tcfg.vision, quantize=True, quantize_bits=bits),
        num_query=tcfg.num_query))
    tconvert.load_jax_params(built, jparams)
    for name, t in built.state_dict().items():
        assert torch.equal(t, got_sd[name]), name


def test_fused_tree_bridges():
    """A fuse_llm_projections(quantize_llm_int8(...)) tree loads into a
    model built with fuse_proj, equal to fusing the port model in place."""
    jcfg, jmod, params, tcfg = _omni_pair(seed=2)
    jparams = _quantized_jax(params, 8)
    jparams = {**jparams, "llm": jconvert.fuse_llm_projections(jparams["llm"])}
    llm = dataclasses.replace(tcfg.llm, quantize=True, quantize_lm_head=False, fuse_proj=True)
    vision = dataclasses.replace(tcfg.vision, quantize=True)
    built = tconvert.load_jax_params(
        tomni.OmniLMMForCausalLM(tomni.OmniLMMConfig(llm=llm, vision=vision,
                                                     num_query=tcfg.num_query)), jparams)
    tmod = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tcfg), params)
    tconvert.quantize_llm_int8(tmod, include_lm_head=False)
    tconvert.quantize_vision_int8(tmod)
    tconvert.fuse_llm_projections_(tmod)
    got = tmod.state_dict()
    for name, t in built.state_dict().items():
        assert torch.equal(t, got[name]), name


# ------------------------------------------------------------ HF checkpoints


def _tiny_omni_sd(qv_bias: bool = False):
    """A tiny real-format OmniLMM state dict (Mistral LM, timm Eva tower,
    resampler), numpy, from a seed."""
    rng = np.random.default_rng(7)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.1  # noqa: E731
    H, D, NQ, V, I, ED = 16, 32, 4, 64, 32, 64
    sd = {"model.embed_tokens.weight": r(V, H), "model.norm.weight": 1 + r(H),
          "lm_head.weight": r(V, H)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": r(H, H), p + "self_attn.k_proj.weight": r(H, H),
                   p + "self_attn.v_proj.weight": r(H, H), p + "self_attn.o_proj.weight": r(H, H),
                   p + "mlp.gate_proj.weight": r(I, H), p + "mlp.up_proj.weight": r(I, H),
                   p + "mlp.down_proj.weight": r(H, I), p + "input_layernorm.weight": 1 + r(H),
                   p + "post_attention_layernorm.weight": 1 + r(H)})
    eva = {"patch_embed.proj.weight": r(D, 3, 7, 7), "patch_embed.proj.bias": r(D),
           "cls_token": r(1, 1, D), "pos_embed": r(1, 17, D), "norm.weight": 1 + r(D),
           "norm.bias": r(D)}
    for i in range(3):
        p = f"blocks.{i}."
        eva.update({p + "norm1.weight": 1 + r(D), p + "norm1.bias": r(D),
                    p + "norm2.weight": 1 + r(D), p + "norm2.bias": r(D),
                    p + "attn.qkv.weight": r(3 * D, D), p + "attn.proj.weight": r(D, D),
                    p + "attn.proj.bias": r(D), p + "mlp.fc1.weight": r(ED, D),
                    p + "mlp.fc1.bias": r(ED), p + "mlp.fc2.weight": r(D, ED),
                    p + "mlp.fc2.bias": r(D)})
        if qv_bias:
            eva.update({p + "attn.q_bias": r(D), p + "attn.v_bias": r(D)})
        else:
            eva[p + "attn.qkv.bias"] = r(3 * D)
    sd.update({f"model.vision_tower.{k}": v for k, v in eva.items()})
    res = {"query": r(NQ, H), "pos_embed": r(NQ, H), "kv_proj.weight": r(H, D),
           "attn.in_proj_weight": r(3 * H, H), "attn.in_proj_bias": r(3 * H),
           "attn.out_proj.weight": r(H, H), "attn.out_proj.bias": r(H),
           "ln_q.weight": 1 + r(H), "ln_q.bias": r(H), "ln_kv.weight": 1 + r(H),
           "ln_kv.bias": r(H), "ln_post.weight": 1 + r(H), "ln_post.bias": r(H),
           "proj": r(H, H)}
    sd.update({f"model.resampler.{k}": v for k, v in res.items()})
    return sd


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("qv_bias", [False, True])
def test_converters_equal_jax(qv_bias):
    sd = _tiny_omni_sd(qv_bias)
    got, want = tconvert.convert_omnilmm(sd), jconvert.convert_omnilmm(sd)
    _assert_trees_equal(got, want)
    assert "block_2" not in got["vision_tower"]  # the dead last block
    if qv_bias:
        np.testing.assert_array_equal(got["vision_tower"]["block_0"]["attn"]["qkv"]["bias"][32:64],
                                      np.zeros(32, np.float32))
    _assert_trees_equal(tconvert.convert_eva02(sd, prefix="model.vision_tower.",
                                               layers_to_run=3),
                        jconvert.convert_eva02(sd, prefix="model.vision_tower.",
                                               layers_to_run=3))
    _assert_trees_equal(tres.convert_resampler(sd, prefix="model.resampler."),
                        jres.convert_resampler(sd, prefix="model.resampler."))
    _assert_trees_equal(tres.convert_resampler(sd, prefix="model.resampler.", query_pos=False),
                        jres.convert_resampler(sd, prefix="model.resampler.", query_pos=False))


def test_converted_checkpoint_runs_like_jax(tmp_path):
    """omnilmm_config_from_hf equals the JAX one (eva_config and overrides
    included), and the converted tree gives the JAX model's logits."""
    import json

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
        "max_position_embeddings": 64, "num_query": 4,
        "eva_config": {"image_size": 28, "patch_size": 7, "embed_dim": 32, "depth": 3,
                       "num_heads": 4, "mlp_hidden": 64}}))
    over = dict(llm=dict(quantize=True, kv_cache_dtype="int8"), vision=dict(use_rope=True))
    t = tconvert.omnilmm_config_from_hf(str(tmp_path), **over)
    j = jconvert.omnilmm_config_from_hf(str(tmp_path), **over)
    for sub in ("llm", "vision"):
        tf = {k: v for k, v in dataclasses.asdict(getattr(t, sub)).items()
              if k not in ("dtype", "param_dtype")}
        assert tf == {k: v for k, v in dataclasses.asdict(getattr(j, sub)).items() if k in tf}
    assert t.num_query == j.num_query == 4
    d = tconvert.omnilmm_config_from_hf(str(tmp_path / "missing"))
    assert (d.llm.hidden_size, d.vision.embed_dim, d.num_query) == (4096, 1792, 64)

    sd = _tiny_omni_sd()
    cfg = tconvert.omnilmm_config_from_hf(str(tmp_path))
    jcfg = jconvert.omnilmm_config_from_hf(str(tmp_path))
    tree = tconvert.convert_omnilmm(sd)
    tmod = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(cfg), tree).eval()
    ids, starts, mask, img = _inputs(cfg, seed=5)
    ids = ids % 64
    want, _ = jomni.OmniLMMForCausalLM(jcfg).apply(
        {"params": jconvert.convert_omnilmm(sd)}, jnp.asarray(ids), images=jnp.asarray(img),
        image_starts=jnp.asarray(starts))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(ids), images=torch.from_numpy(img), image_starts=starts)
    _close(got, want)
