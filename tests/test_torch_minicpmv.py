"""The port's MiniCPM-Llama3-V 2.5 model (models/minicpmv.py) against the
JAX package's, on the CPU.

Flax MiniCPM-V trees (tiny widths, fp32) are bridged into the torch model
with `load_jax_params`; the same numpy-seeded inputs go through both:

- `find_unk_spans`; `splice_multi_span` with inactive (-1) spans, a
  padded span group, overlapping spans (the later one wins) and a start
  clamped at the row's end, equal to the JAX scan of dynamic_update_slice;
- the tiny model's `encode_slices` (square and non-square slices) and its
  logits with spans: within 1e-4 absolute (fp32, sums in other orders);
- the engine on span features: int8 weights (head float) with the int8 KV
  cache, and the fused engine at bits 8 and 4 (kernel #16's twin here, the
  JAX kernel in interpret mode): greedy tokens equal to JAX's, first
  logits within 1e-4 absolute (tests/test_torch_kv_int8.py and
  tests/test_torch_fused_decode.py's ATOL);
- `minicpmv_config_from_hf` and `convert_minicpmv` on a tiny checkpoint
  written here: the same configs and trees as the JAX converters, the
  same logits in both packages.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.sampling import SamplingParams as JSamplingParams
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import minicpmv as jmcv
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import minicpmv as tmcv

ATOL = 1e-4


def _close(got, want, atol: float = ATOL) -> None:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------------ the splice


def test_find_unk_spans_equals_jax():
    for ids, q in (([5, 9, 9, 9, 7, 9, 9, 9, 2, 9], 3), ([5, 9, 9, 9, 7, 9, 9, 9, 2, 9], 2),
                   ([9, 9, 1, 9, 9], 2), ([], 1), ([1, 2, 3], 1)):
        assert tmcv.find_unk_spans(ids, 9, q) == jmcv.find_unk_spans(ids, 9, q)
    assert tmcv.find_unk_spans([5, 9, 9, 9, 7, 9, 9, 9, 2, 9], 9, 3) == [1, 5]


SPLICE_CASES = {
    # a full row, a row with inactive (padded) spans
    "inactive": np.array([[0, 4, 8], [2, -1, -1]]),
    # overlapping spans: the later one wins where they meet
    "overlap": np.array([[1, 2, -1], [6, 0, 5]]),
    # a start past L - Q is clamped so the span fits
    "clamped": np.array([[11, -1, 3], [-1, -1, -1]]),
}


@pytest.mark.parametrize("name", list(SPLICE_CASES))
def test_splice_multi_span_equals_jax(name):
    rng = np.random.default_rng(0)
    B, L, S, Q, D = 2, 12, 3, 2, 4
    text = rng.normal(size=(B, L, D)).astype(np.float32)
    feats = rng.normal(size=(B, S, Q, D)).astype(np.float32)
    starts = SPLICE_CASES[name].astype(np.int32)
    want = jmcv.splice_multi_span(jnp.asarray(text), jnp.asarray(feats), jnp.asarray(starts))
    got = tmcv.splice_multi_span(torch.from_numpy(text), torch.from_numpy(feats), starts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bf16 embeddings take the features in their own dtype
    half = tmcv.splice_multi_span(torch.from_numpy(text).to(torch.bfloat16),
                                  torch.from_numpy(feats), starts)
    assert half.dtype == torch.bfloat16


# ------------------------------------------------------------ the model


def _jcfg(vocab=256, **llm):
    base = jmcv.MiniCPMVConfig.tiny()
    return dataclasses.replace(base, llm=dataclasses.replace(base.llm, vocab_size=vocab, **llm))


def _tcfg(vocab=256, **llm):
    base = tmcv.MiniCPMVConfig.tiny(vocab_size=vocab)
    return dataclasses.replace(base, llm=dataclasses.replace(base.llm, **llm))


def _init_params(cfg, seed=0):
    """Both halves of a flax MiniCPM-V tree (the LM with the resampler, the
    SigLIP tower), as numpy."""
    model = jmcv.MiniCPMVForCausalLM(cfg)
    Q, size = cfg.query_num, cfg.vision.image_size
    lm = model.init(jax.random.PRNGKey(seed), jnp.ones((1, Q + 8), jnp.int32),
                    span_features=jnp.zeros((1, 1, Q, cfg.llm.hidden_size)),
                    span_starts=jnp.asarray([[0]], jnp.int32))["params"]
    vis = model.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, size, size, 3)),
                     method=model.encode_slices)["params"]
    return jax.tree.map(np.asarray, {**lm, **vis})


@pytest.fixture(scope="module")
def pair():
    jcfg = _jcfg()
    params = _init_params(jcfg)
    tmod = tconvert.load_jax_params(tmcv.MiniCPMVForCausalLM(_tcfg()), params).eval()
    return jcfg, jmcv.MiniCPMVForCausalLM(jcfg), params, tmod


def _inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    B, S, Q = 2, 3, cfg.query_num
    L = 3 * Q + 10
    ids = rng.integers(3, 200, size=(B, L)).astype(np.int32)
    starts = np.asarray([[1, 2 + Q, 3 + 2 * Q], [4, 5 + Q, -1]], np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, :2] = 0
    feats = rng.normal(size=(B, S, Q, cfg.llm.hidden_size)).astype(np.float32)
    return ids, starts, mask, feats


def test_bridge_covers_every_parameter(pair):
    _, _, params, tmod = pair
    sd = tconvert.llava_params_from_jax(params)
    assert set(sd) == set(tmod.state_dict())
    assert "vpm.layers.1.q_proj.weight" in sd and "resampler.proj" in sd
    assert "resampler.pos_embed" not in sd  # 2.5: no query-side table


@pytest.mark.parametrize("hw", [(28, 28), (21, 35)])
def test_encode_slices_matches_jax(pair, hw):
    jcfg, jmod, params, tmod = pair
    img = np.random.default_rng(hw[1]).standard_normal((3, *hw, 3)).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(img), method=jmod.encode_slices)
    with torch.no_grad():
        got = tmod.encode_slices(torch.from_numpy(img))
    assert got.shape == (3, jcfg.query_num, jcfg.llm.hidden_size)
    _close(got, want)


def test_logits_with_spans_match_jax(pair):
    jcfg, jmod, params, tmod = pair
    ids, starts, mask, feats = _inputs(jcfg)
    want, _ = jmod.apply({"params": params}, jnp.asarray(ids), span_features=jnp.asarray(feats),
                         span_starts=jnp.asarray(starts), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(ids), span_features=torch.from_numpy(feats),
                      span_starts=starts, attention_mask=torch.from_numpy(mask))
        text, _ = tmod(torch.from_numpy(ids))
        fws = tmod.forward_with_spans(torch.from_numpy(ids), torch.from_numpy(feats), starts)
    _close(got, want)
    jtext, _ = jmod.apply({"params": params}, jnp.asarray(ids))
    _close(text, jtext)
    _close(fws, jmod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(feats),
                           jnp.asarray(starts), method=jmod.forward_with_spans))
    with pytest.raises(ValueError, match="span features"):
        tmod.build_embeds(torch.from_numpy(ids), torch.zeros(1))


def test_presets_and_random_init():
    for name in ("minicpm_llama3_v25", "minicpm_llama3_v25_int8"):
        t, j = getattr(tmcv.MiniCPMVConfig, name)(), getattr(jmcv.MiniCPMVConfig, name)()
        for sub in ("llm", "vision"):
            tf = {k: v for k, v in dataclasses.asdict(getattr(t, sub)).items()
                  if k not in ("dtype", "param_dtype")}
            assert tf == {k: v for k, v in dataclasses.asdict(getattr(j, sub)).items()
                          if k in tf}, (name, sub)
        r, jr = t.resampler, j.resampler
        assert (r.num_queries, r.query_pos, r.embed_dim, r.num_heads, r.kv_dim) == \
            (jr.num_queries, jr.query_pos, jr.embed_dim, jr.num_heads, jr.kv_dim) == \
            (96, False, 4096, 32, 1152)
        assert (t.query_num, t.max_slice_nums, t.scale_resolution, t.patch_size) == \
            (j.query_num, j.max_slice_nums, j.scale_resolution, j.patch_size)
    cfg = tmcv.MiniCPMVConfig.tiny()
    a, b = (tmcv.init_minicpmv_weights_(tmcv.MiniCPMVForCausalLM(cfg),
                                        torch.Generator().manual_seed(0)) for _ in range(2))
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    assert a.vpm.pos_embed.abs().max() > 0 and a.resampler.proj.abs().max() > 0
    ids, starts, mask, feats = _inputs(cfg)
    with torch.no_grad():
        logits, _ = a(torch.from_numpy(ids), span_features=torch.from_numpy(feats),
                      span_starts=starts)
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------ engines


def _serving(jcfg, tcfg, params, bits, fused):
    llm = dict(quantize=True, quantize_bits=bits, quantize_lm_head=False,
               kv_cache_dtype="int8", fuse_proj=fused)
    quant = (jconvert.quantize_llm_int4 if bits == 4
             else lambda p: jconvert.quantize_llm_int8(p, include_lm_head=False))
    qllm = quant(params["llm"])
    if fused:
        qllm = jconvert.fuse_llm_projections(qllm)
    jparams = {**params, "llm": qllm}
    jq = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, **llm))
    tq = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, **llm))
    tmod = tconvert.load_jax_params(tmcv.MiniCPMVForCausalLM(tq), jparams).eval()
    return jmcv.MiniCPMVForCausalLM(jq), jax.tree.map(jnp.asarray, jparams), tmod


def _engine_inputs(cfg):
    Q = cfg.query_num
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(4, 200, size=n))) for n in (2 * Q + 6, 2 * Q + 3)]
    starts = np.asarray([[1, 2 + Q], [1, -1]], np.int32)
    spans = rng.normal(size=(2, 2, Q, cfg.llm.hidden_size)).astype(np.float32)
    return prompts, starts, spans


@pytest.mark.parametrize("mode", ["int8 kv", "fused 8", "fused 4"])
def test_serving_engines_match_jax(pair, mode):
    """The int8-weight int8-KV engine and the fused engine at bits 8 and 4
    on span features: greedy tokens equal to JAX's, first logits within
    ATOL; the fused engine's tokens equal the eager int8-KV engine's on the
    same quantised weights."""
    jcfg, _, params, _ = pair
    fused, bits = mode.startswith("fused"), 4 if mode.endswith("4") else 8
    jmod, jparams, tmod = _serving(jcfg, _tcfg(), params, bits, fused)
    prompts, starts, spans = _engine_inputs(jcfg)
    kw = dict(span_features=spans, span_starts=starts, max_new_tokens=4, prompt_bucket=8)
    want = JEngine(jmod, jparams, eos_id=-1, pad_id=0, fused_decode=fused).generate(
        prompts, sampling=JSamplingParams.greedy(), **kw)
    got = DecodeEngine(tmod, eos_id=-1, pad_id=0, fused_decode=fused).generate(
        prompts, sampling=SamplingParams.greedy(), **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    _close(got.first_logits, want.first_logits)
    if fused:
        _, _, eager = _serving(jcfg, _tcfg(), params, bits, False)
        ref = DecodeEngine(eager, eos_id=-1, pad_id=0).generate(
            prompts, sampling=SamplingParams.greedy(), **kw)
        np.testing.assert_array_equal(got.tokens, ref.tokens)


# ------------------------------------------------------------ checkpoints


def _hf_minicpmv_sd(vocab: int = 64, hidden: int = 16):
    """A tiny MiniCPM-V checkpoint in the remote-code layout (llm.*, vpm.*,
    resampler.*), numpy from a seed: 2 heads over 1 KV head, MLP 2 x
    hidden."""
    rng = np.random.default_rng(7)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa: E731
    H, I, V, D, VI, NQ, P = hidden, 2 * hidden, vocab, 32, 64, 4, 7
    sd = {"llm.model.embed_tokens.weight": r(V, H), "llm.model.norm.weight": 1 + r(H),
          "llm.lm_head.weight": r(V, H)}
    for i in range(2):
        p = f"llm.model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": r(H, H),
                   p + "self_attn.k_proj.weight": r(H // 2, H),
                   p + "self_attn.v_proj.weight": r(H // 2, H),
                   p + "self_attn.o_proj.weight": r(H, H), p + "mlp.gate_proj.weight": r(I, H),
                   p + "mlp.up_proj.weight": r(I, H), p + "mlp.down_proj.weight": r(H, I),
                   p + "input_layernorm.weight": 1 + r(H),
                   p + "post_attention_layernorm.weight": 1 + r(H)})
    v = "vpm."
    sd.update({v + "embeddings.patch_embedding.weight": r(D, 3, P, P),
               v + "embeddings.patch_embedding.bias": r(D),
               v + "embeddings.position_embedding.weight": r(16, D),
               v + "post_layernorm.weight": 1 + r(D), v + "post_layernorm.bias": r(D)})
    for i in range(2):
        p = f"{v}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{name}.weight"] = r(D, D)
            sd[p + f"self_attn.{name}.bias"] = r(D)
        sd.update({p + "layer_norm1.weight": 1 + r(D), p + "layer_norm1.bias": r(D),
                   p + "layer_norm2.weight": 1 + r(D), p + "layer_norm2.bias": r(D),
                   p + "mlp.fc1.weight": r(VI, D), p + "mlp.fc1.bias": r(VI),
                   p + "mlp.fc2.weight": r(D, VI), p + "mlp.fc2.bias": r(D)})
    m = "resampler."
    if H != D:  # the resampler maps the tower's width to the LM's
        sd[m + "kv_proj.weight"] = r(H, D)
    sd.update({m + "query": r(NQ, H), m + "pos_embed": r(NQ, H),
               m + "attn.in_proj_weight": r(3 * H, H), m + "attn.in_proj_bias": r(3 * H),
               m + "attn.out_proj.weight": r(H, H), m + "attn.out_proj.bias": r(H),
               m + "ln_q.weight": 1 + r(H), m + "ln_q.bias": r(H),
               m + "ln_kv.weight": 1 + r(H), m + "ln_kv.bias": r(H),
               m + "ln_post.weight": 1 + r(H), m + "ln_post.bias": r(H), m + "proj": r(H, H)})
    return sd


CKPT_CONFIG = {
    "architectures": ["MiniCPMV"], "vocab_size": 64, "hidden_size": 16,
    "intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 1, "max_position_embeddings": 512, "rope_theta": 500000.0,
    "rms_norm_eps": 1e-5, "query_num": 4, "slice_mode": True, "max_slice_nums": 9,
    "scale_resolution": 28, "patch_size": 7,
    "vision_config": {"image_size": 28, "patch_size": 7, "hidden_size": 32,
                      "intermediate_size": 64, "num_hidden_layers": 2,
                      "num_attention_heads": 4},
}


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def test_converted_checkpoint_runs_like_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CKPT_CONFIG))
    over = dict(llm=dict(quantize=True, kv_cache_dtype="int8"), vision=dict(num_layers=2))
    for kw in ({}, over):
        t = tconvert.minicpmv_config_from_hf(str(tmp_path), **kw)
        j = jconvert.minicpmv_config_from_hf(str(tmp_path), **kw)
        for sub in ("llm", "vision"):
            tf = {k: v for k, v in dataclasses.asdict(getattr(t, sub)).items()
                  if k not in ("dtype", "param_dtype")}
            assert tf == {k: v for k, v in dataclasses.asdict(getattr(j, sub)).items()
                          if k in tf}, sub
        assert (t.query_num, t.slice_mode, t.max_slice_nums, t.scale_resolution,
                t.patch_size) == (j.query_num, j.slice_mode, j.max_slice_nums,
                                  j.scale_resolution, j.patch_size) == (4, True, 9, 28, 7)
    d = tconvert.minicpmv_config_from_hf(str(tmp_path / "missing"))
    assert (d.llm.vocab_size, d.llm.num_kv_heads, d.vision.hidden_size, d.query_num) == \
        (128256, 8, 1152, 96)

    sd = _hf_minicpmv_sd()
    tree, jtree = tconvert.convert_minicpmv(sd), jconvert.convert_minicpmv(sd)
    _assert_trees_equal(tree, jtree)
    assert "pos_embed" not in tree["resampler"]
    cfg = tconvert.minicpmv_config_from_hf(str(tmp_path))
    jcfg = jconvert.minicpmv_config_from_hf(str(tmp_path))
    tmod = tconvert.load_jax_params(tmcv.MiniCPMVForCausalLM(cfg), tree).eval()
    jmod = jmcv.MiniCPMVForCausalLM(jcfg)
    ids, starts, mask, _ = _inputs(jcfg, seed=5)
    ids = ids % 64
    img = np.random.default_rng(8).standard_normal((3, 21, 35, 3)).astype(np.float32)
    jfeat = jmod.apply({"params": jtree}, jnp.asarray(img), method=jmod.encode_slices)
    with torch.no_grad():
        feat = tmod.encode_slices(torch.from_numpy(img))
    _close(feat, jfeat)
    feats = np.stack([np.asarray(jfeat)[:3], np.asarray(jfeat)[[2, 1, 0]]])
    want, _ = jmod.apply({"params": jtree}, jnp.asarray(ids), span_features=jnp.asarray(feats),
                         span_starts=jnp.asarray(starts), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(ids), span_features=torch.from_numpy(feats),
                      span_starts=starts, attention_mask=torch.from_numpy(mask))
    _close(got, want)
