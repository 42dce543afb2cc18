"""The port's fused decode (kernel #16's twin, the stacked layouts, the
write-through prefill, the fused engine) against the JAX package's, on the
CPU.

- The block pickers and `default_dims` equal the JAX ones (tiny, Vicuna-7B
  and Llama3-8B geometries, int8 and int4).
- `stack_llama_params` on the bridged port model equals the JAX stacking of
  the same tree: int8 exactly; int4 after removing the JAX package's
  Mosaic-only banding of the down scales.
- `fused_decode_step_ref` against the JAX `fused_decode_step(...,
  interpret=True)` on the same stacked weights and cache: MHA, GQA, a padded
  intermediate and int4. Both quantise every activation with IEEE
  divisions and sum the integer products exactly, but fp32 sums (the norm,
  the fresh column, the head sum, the softmax) reduce in other orders and
  exp / sigmoid round differently, so a value may land on the other side
  of a quantisation step, which moves x_out by a fraction of one step of
  that row's scale. x_out is held to X_REL_TOL of max|x_out| (read <= 1.9e-7
  in the four cases: no step flipped), the fresh int8 k/v equal except for
  at most KV_FLIPS one-step flips in a case (read 0 of 256-512 values), their
  scales to 1e-5 relative (read <= 2.4e-7).
- The key split (kernel #16's deliberate difference): the twin at one
  split equals, bit for bit, a frozen copy of the sequential attention; at
  2-4 splits (3-4 live blocks, a fully masked row, a cache_index inside a
  block, int8 and int4, MHA and GQA) it stays within the tolerances above
  of the sequential JAX function; the plans split on block boundaries,
  fill a wave at Llama3-8B's B 8 x KVH 8 and take one split at batch 24.
- `stacked_prefill_tower` and `scatter_new_kv` against the JAX ones (the
  off-TPU product formula on both sides: fp32, different sum orders, so
  int8 cache values within one step).
- A tiny LLaVA (int8 weights, bf16-kept head, fuse_proj, int8 KV) through
  both fused engines: equal greedy tokens, first logits within 1e-4; the
  generator's greedy_gen, diverse_gen and autocheck against the JAX
  generator's; the ValueError cases.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
from rlaifv_tpu.models.convert import fuse_llm_projections, quantize_llm_int4, quantize_llm_int8
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llama import llama_init_cache as jllama_init_cache
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.ops import fused_decode as jfd
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llama import LlamaConfig
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.ops import fused_decode as tfd
from tests.fake_tokenizer import FakeTokenizer

X_REL_TOL = 1e-5
KV_FLIPS = 2
ATOL = 1e-4
SERVE = dict(quantize=True, quantize_lm_head=False, fuse_proj=True, kv_cache_dtype="int8")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _unband(sdown, d) -> np.ndarray:
    """The JAX int4 down scales (n, nI * band, D) -> (n, Ip / g, D)."""
    sdown = np.asarray(sdown)
    gpb, nI = d.gpb_down, d.nI
    band = sdown.shape[1] // nI
    return sdown.reshape(sdown.shape[0], nI, band, -1)[:, :, :gpb].reshape(
        sdown.shape[0], nI * gpb, -1)


def _torch_stacked(jstacked, d) -> dict:
    out = {k: _t(v) for k, v in jstacked.items()}
    if d.w4:
        out["sdown"] = _t(_unband(jstacked["sdown"], d))
    return out


# ------------------------------------------------------------ dims


_GEOMETRIES = {
    "tiny": dict(JLlamaConfig.tiny().__dict__),
    "vicuna-7b": dict(JLlamaConfig.vicuna_7b().__dict__),
    "llama3-8b": dict(JLlamaConfig.llama3_8b().__dict__),
}
_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
           "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps")


@pytest.mark.parametrize("geom", sorted(_GEOMETRIES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("L", [128, 384, 1024])
def test_dims_and_pickers_equal_jax(geom, bits, L):
    kw = {k: _GEOMETRIES[geom][k] for k in _SHARED}
    jcfg = JLlamaConfig(**kw, quantize=True, quantize_bits=bits)
    tcfg = LlamaConfig(**kw, quantize=True, quantize_bits=bits)
    jd, td = jfd.default_dims(jcfg, L), tfd.default_dims(tcfg, L)
    for f in tfd.FusedDecodeDims.__dataclass_fields__:
        assert getattr(td, f) == getattr(jd, f), f
    for prop in ("gpb_down", "Nq", "nq", "natt", "no", "nI", "att_prep", "att0", "att_fin",
                 "o0", "m0", "phases"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    for I in (96, 128, 384, 512, 8192, 11008, 11264, 13824, 14336):
        assert tfd._pick_intermediate(I) == jfd._pick_intermediate(I)
    for n, targets in ((L, (128, 256, L)), (4096, (2048, 1024, 512, 256, 128, 4096)),
                       (96, (128, 256, 96))):
        assert tfd._pick_block(n, targets) == jfd._pick_block(n, targets)
    with pytest.raises(ValueError, match="no block"):
        tfd._pick_block(100, (128, 256))


# ------------------------------------------------------------ stacking


def _llava_params(bits: int, **llm_kw):
    """A tiny LLaVA tree with int8 (or int4) LLM projections (head kept
    float) and fused q/k/v and gate/up."""
    jcfg = JLlavaConfig.tiny(**llm_kw)
    P, S = jcfg.num_image_tokens, jcfg.vision.image_size
    params = dict(JLlava(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))["params"])
    quant = quantize_llm_int4 if bits == 4 else quantize_llm_int8
    kw = {} if bits == 4 else dict(include_lm_head=False)
    params["llm"] = fuse_llm_projections(quant(params["llm"], **kw))
    return params


@pytest.mark.parametrize("bits,llm_kw", [(8, {}), (8, dict(intermediate_size=96)),
                                         (4, {}), (4, dict(num_kv_heads=4))])
def test_stacked_arrays_equal_jax(bits, llm_kw):
    params = _llava_params(bits, **llm_kw)
    cfg = LlavaConfig.tiny(**SERVE, quantize_bits=bits, **llm_kw)
    jcfg = JLlavaConfig.tiny(**SERVE, quantize_bits=bits, **llm_kw)
    model = load_jax_params(LlavaForCausalLM(cfg), params).eval()
    want = jfd.stack_llama_params(params["llm"], jcfg.llm)
    d = tfd.default_dims(cfg.llm, 128)
    got = tfd.stack_llama_params(model)
    assert set(got) == set(want)
    for key, arr in _torch_stacked(want, d).items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        assert torch.equal(got[key], arr), key
    # in place: every stacked projection's buffer is freed
    layer = model.llm.model.layers[0]
    assert layer.attn.qkv_proj.q.numel() == 0 and layer.mlp.down_proj.q.numel() == 0
    assert layer.attn.qkv_proj.scale.numel() > 0


def test_cache_layouts_round_trip():
    rng = np.random.default_rng(0)
    cache = [{"k": _t(rng.integers(-127, 128, (2, 16, 3, 8)).astype(np.int8)),
              "k_scale": _t(rng.random((2, 16, 3)).astype(np.float32)),
              "v": _t(rng.integers(-127, 128, (2, 16, 3, 8)).astype(np.int8)),
              "v_scale": _t(rng.random((2, 16, 3)).astype(np.float32))} for _ in range(2)]
    got = tfd.stack_cache(cache)
    want = jfd.stack_cache([{k: jnp.asarray(v.numpy()) for k, v in c.items()} for c in cache])
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for a, b in zip(tfd.unstack_cache(got), cache):
        for key in b:
            assert torch.equal(a[key], b[key])
    cfg = LlamaConfig.tiny()
    init = tfd.init_stacked_cache(cfg, 3, 128)
    jinit = jfd.init_stacked_cache(JLlamaConfig.tiny(), 3, 128)
    for key in init:
        assert tuple(init[key].shape) == jinit[key].shape and not init[key].any()
        assert init[key].dtype == {"k": torch.int8, "v": torch.int8}.get(key, torch.float32)


# ------------------------------------------------------------ the step


def _jax_setup(bits: int, prompt_len: int, L: int, B: int = 2, **llm_kw):
    """The JAX tests' harness: a tiny fused int8 (or int4) Llama, its cache
    from a flax prefill of `prompt_len` tokens (row 1 left-padded by 3)."""
    cfg = JLlamaConfig.tiny(quantize=True, quantize_bits=bits, quantize_lm_head=False,
                            fuse_proj=True, kv_cache_dtype="int8", **llm_kw)
    ids = jnp.asarray(np.random.default_rng(0).integers(1, 200, size=(B, prompt_len)),
                      jnp.int32)
    fparams = JLlama(JLlamaConfig.tiny(**llm_kw)).init(jax.random.PRNGKey(0), ids)["params"]
    quant = quantize_llm_int4 if bits == 4 else quantize_llm_int8
    kw = {} if bits == 4 else dict(include_lm_head=False)
    params = jax.tree.map(jnp.asarray, fuse_llm_projections(quant(fparams, **kw)))
    model = JLlama(cfg)
    mask = np.zeros((B, L), np.int32)
    mask[:, :prompt_len] = 1
    mask[1, :3] = 0
    mask = jnp.asarray(mask)
    pos = jnp.maximum(jnp.cumsum(mask[:, :prompt_len], axis=1) - 1, 0)
    logits, cache = model.apply({"params": params}, ids, attention_mask=mask, position_ids=pos,
                                cache=jllama_init_cache(cfg, B, L), cache_index=jnp.int32(0))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    x = model.apply({"params": params}, tok[:, None], method=model.embed)[:, 0]
    return cfg, params, jfd.stack_cache(cache), mask, pos[:, -1] + 1, x


@pytest.mark.parametrize("bits,prompt_len,L,llm_kw", [
    (8, 5, 128, dict(num_kv_heads=4)),  # MHA
    (8, 5, 128, {}),  # GQA (tiny default: 4 heads, 2 kv heads)
    (8, 133, 256, dict(intermediate_size=96)),  # padded I, two cache blocks
    (4, 5, 128, {}),  # int4 (tiny: one group along D, 2 heads a group along H Dh)
])
def test_twin_matches_jax_interpret(bits, prompt_len, L, llm_kw):
    cfg, params, scache, mask, positions, x = _jax_setup(bits, prompt_len, L, **llm_kw)
    d = jfd.default_dims(cfg, L)
    jstacked = jfd.stack_llama_params(params, cfg)
    want_x, want_kv = jfd.fused_decode_step(jstacked, scache, x, mask, positions,
                                            jnp.int32(prompt_len), d, rope_theta=cfg.rope_theta,
                                            interpret=True)
    td = tfd.default_dims(LlamaConfig.tiny(**SERVE, quantize_bits=bits, **llm_kw), L)
    assert td == tfd.FusedDecodeDims(**{f: getattr(d, f) for f in
                                        tfd.FusedDecodeDims.__dataclass_fields__})
    got_x, got_kv = tfd.fused_decode_step(
        _torch_stacked(jstacked, d), {k: _t(v) for k, v in scache.items()}, _t(x), _t(mask),
        _t(positions), prompt_len, td, rope_theta=cfg.rope_theta)
    assert tfd.fused_decode_step.launches == 0  # CPU tensors: the twin
    want_x = np.asarray(want_x)
    rel = np.abs(got_x.numpy() - want_x).max() / np.abs(want_x).max()
    assert rel <= X_REL_TOL, rel
    flips = 0
    for key in ("k", "v"):
        diff = np.abs(got_kv[key].numpy().astype(np.int32) - np.asarray(want_kv[key], np.int32))
        assert diff.max() <= 1, (key, diff.max())
        flips += int(diff.sum())
        np.testing.assert_allclose(got_kv[f"{key}_scale"].numpy(),
                                   np.asarray(want_kv[f"{key}_scale"]), rtol=1e-5)
    assert flips <= KV_FLIPS, flips


# ------------------------------------------------------------ the key split


def _frozen_sequential_attention(q, k, v, cache, layer, mask, cache_index, d, splits=1):
    """A frozen copy of the twin's attention before the key split: the fresh
    column, then every live block in one recurrence."""
    assert splits == 1
    B = q.shape[0]
    scale = 1.0 / (d.Dh ** 0.5)
    qg = q.reshape(B, d.KVH, d.H // d.KVH, d.Dh)
    q8, qs = tfd.quantize_rows(qg)
    m, l, acc = tfd._fresh_column(qg, k, v, scale)
    live_col = torch.arange(d.L, device=q.device) < cache_index
    live_all = (mask != 0) & live_col[None, :]
    for j in range(max(-(-cache_index // d.bl), 0)):
        cols = slice(j * d.bl, (j + 1) * d.bl)
        kb = cache["k"][layer][:, :, cols].permute(1, 0, 3, 2)
        vb = cache["v"][layer][:, :, cols].permute(1, 0, 2, 3)
        ks = cache["k_scale"][layer][:, :, cols].permute(1, 0, 2)[:, :, None, :]
        vs = cache["v_scale"][layer][:, :, cols].permute(1, 0, 2)[:, :, None, :]
        sc = tfd._int_product(q8, kb) * qs * ks * scale
        sc = torch.where(live_all[:, None, None, cols], sc, tfd.NEG_INF)
        m_new = torch.maximum(m, torch.clamp_min(sc.amax(dim=-1, keepdim=True),
                                                 tfd.NEG_INF / 2))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p8, ps = tfd.quantize_rows(p * vs)
        acc = acc * corr + tfd._int_product(p8, vb) * ps
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).reshape(B, d.H, d.Dh)


def _split_case(bits: int, prompt_len: int, L: int, dead_row: bool, **llm_kw):
    """_jax_setup's step as torch inputs, with row 1's cache columns all
    masked when `dead_row` (it then sees the fresh column alone)."""
    cfg, params, scache, mask, positions, x = _jax_setup(bits, prompt_len, L, **llm_kw)
    mask = np.array(mask)
    if dead_row:
        mask[1] = 0
    d = jfd.default_dims(cfg, L)
    jstacked = jfd.stack_llama_params(params, cfg)
    td = tfd.default_dims(LlamaConfig.tiny(**SERVE, quantize_bits=bits, **llm_kw), L)
    targs = (_torch_stacked(jstacked, d), {k: _t(v) for k, v in scache.items()}, _t(x),
             _t(mask), _t(positions), prompt_len, td)
    jargs = (jstacked, scache, x, jnp.asarray(mask), positions, jnp.int32(prompt_len), d)
    return cfg, targs, jargs


@pytest.mark.parametrize("bits", [8, 4])
def test_split_twin_at_one_split_is_the_sequential_twin(bits):
    """fused_decode_step_ref with attn_splits 1 (and left out) equals, bit
    for bit, the step with a frozen copy of the sequential attention."""
    from unittest import mock

    cfg, targs, _ = _split_case(bits, 300, 512, dead_row=False)
    kw = dict(rope_theta=cfg.rope_theta)
    with mock.patch.object(tfd, "_attention", _frozen_sequential_attention):
        want_x, want_kv = tfd.fused_decode_step_ref(*targs, **kw)
    for splits in (None, 1):
        got_x, got_kv = tfd.fused_decode_step_ref(*targs, **kw, attn_splits=splits)
        assert torch.equal(got_x, want_x)
        for key in want_kv:
            assert torch.equal(got_kv[key], want_kv[key]), key


_SPLIT_CONFIGS = {  # the twin's tiny configs with 3-4 live cache blocks
    "int8 MHA, a fully masked row": (8, 400, 512, True, dict(num_kv_heads=4)),
    "int8 GQA, cache_index inside a block": (8, 300, 512, False, {}),
    "int4 GQA": (4, 400, 512, False, {}),
}
_split_jax_cache = {}


def _split_jax(name):
    """The JAX step (interpret mode) of a split config, computed once."""
    if name not in _split_jax_cache:
        bits, prompt_len, L, dead, llm_kw = _SPLIT_CONFIGS[name]
        cfg, targs, jargs = _split_case(bits, prompt_len, L, dead, **llm_kw)
        want = jfd.fused_decode_step(*jargs, rope_theta=cfg.rope_theta, interpret=True)
        _split_jax_cache[name] = (cfg, targs, tuple(np.asarray(w) for w in (want[0],)),
                                  {k: np.asarray(v) for k, v in want[1].items()})
    return _split_jax_cache[name]


@pytest.mark.parametrize("name,splits", [
    (n, s) for n in _SPLIT_CONFIGS for s in (2, 3, 4)
    if s <= -(-_SPLIT_CONFIGS[n][1] // 128)])
def test_split_twin_matches_jax_interpret(name, splits):
    """The twin with its cache blocks cut into 2-4 splits (the kernel's
    function) against the sequential JAX function: within
    test_twin_matches_jax_interpret's tolerances."""
    cfg, targs, (want_x,), want_kv = _split_jax(name)
    got_x, got_kv = tfd.fused_decode_step_ref(*targs, rope_theta=cfg.rope_theta,
                                              attn_splits=splits)
    rel = np.abs(got_x.numpy() - want_x).max() / np.abs(want_x).max()
    assert rel <= X_REL_TOL, rel
    flips = 0
    for key in ("k", "v"):
        diff = np.abs(got_kv[key].numpy().astype(np.int32) - want_kv[key].astype(np.int32))
        assert diff.max() <= 1, (key, diff.max())
        flips += int(diff.sum())
        np.testing.assert_allclose(got_kv[f"{key}_scale"].numpy(), want_kv[f"{key}_scale"],
                                   rtol=1e-5)
    assert flips <= KV_FLIPS, flips


def test_split_twin_rejects_more_splits_than_blocks():
    cfg, targs, _ = _split_case(8, 300, 512, dead_row=False)
    with pytest.raises(ValueError, match="attn_splits"):
        tfd.fused_decode_step_ref(*targs, rope_theta=cfg.rope_theta, attn_splits=4)


@pytest.mark.parametrize("B,KVH,n_blocks,ctas,want", [
    (8, 8, 18, 264, 4),  # Llama3-8B's step: 64 items x 4 fill the wave of 264
    (24, 32, 8, 264, 1),  # the batch-24 headline: 768 items fill it already
    (10, 32, 7, 264, 1),  # diverse_gen: 320 items
    (6, 8, 3, 264, 3),  # GQA n_rep 4 at 300 columns: at most one split a block
    (1, 2, 0, 264, 1),  # no live block: the fresh column alone
    (2, 2, 1, 264, 1),
])
def test_fused_attention_plan(B, KVH, n_blocks, ctas, want):
    for n_rep in (1, 2, 4, 8):
        assert tfd.fused_attention_plan(B, KVH, n_blocks, ctas, n_rep) == want
    if want > 1:
        assert B * KVH * want <= ctas < B * KVH * (want + 1) or want == n_blocks
    spans = tfd.fused_split_blocks(n_blocks, want)
    assert spans[0][0] == 0 and spans[-1][1] == n_blocks
    assert all(j1 > j0 for j0, j1 in spans) or n_blocks == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    with pytest.raises(ValueError, match="n_rep"):
        tfd.fused_attention_plan(B, KVH, n_blocks, ctas, 3)


@pytest.mark.parametrize("geom,bits,B,L,ci,want", [
    ("vicuna-7b", 8, 24, 1024, 960, (1, 8, 3)),
    ("vicuna-7b", 8, 8, 896, 840, (1, 8, 3)),
    ("llama3-8b", 8, 8, 2304, 2200, (4, 5, 1)),
    ("vicuna-7b", 4, 24, 1024, 960, (1, 1, 1)),
])
def test_fused_plan(geom, bits, B, L, ci, want):
    """The kernel's plan at 3g's shapes on 264 CTAs (132 SMs): deterministic,
    splits within the live blocks, slices within the contractions."""
    kw = {k: _GEOMETRIES[geom][k] for k in _SHARED}
    d = tfd.default_dims(LlamaConfig(**kw, quantize=True, quantize_bits=bits), L)
    plan = tfd.fused_plan(d, B, ci, ctas=264)
    assert plan == tfd.fused_plan(d, B, ci, ctas=264)
    assert (plan.attn_splits, plan.qkv_slices, plan.gu_slices) == want
    assert 1 <= plan.qkv_slices <= min(d.D // 128, tfd.FUSED_MAX_SLICES)


def test_tower_and_scatter_match_jax():
    """The write-through prefill over the stacked weights equals the JAX
    one (hidden states to fp32 rounding, int8 cache within one step), and
    the fresh k/v land in the same cache column."""
    prompt_len, L, B = 7, 128, 2
    cfg, params, _, mask, positions, x = _jax_setup(8, prompt_len, L)
    tcfg = LlamaConfig.tiny(**SERVE)
    jstacked = jfd.stack_llama_params(params, cfg)
    ids = jnp.asarray(np.random.default_rng(1).integers(1, 200, size=(B, prompt_len)), jnp.int32)
    embeds = JLlama(cfg).apply({"params": params}, ids, method=JLlama(cfg).embed)
    win = np.asarray(mask)[:, :prompt_len]
    pos = np.maximum(np.cumsum(win, axis=1) - 1, 0)
    want_h, want_c = jfd.stacked_prefill_tower(
        jstacked, jfd.init_stacked_cache(cfg, B, L), embeds, jnp.asarray(win),
        jnp.asarray(pos), cfg, jnp.int32(0))
    got_h, got_c = tfd.stacked_prefill_tower(
        _torch_stacked(jstacked, jfd.default_dims(cfg, L)), tfd.init_stacked_cache(tcfg, B, L),
        _t(embeds), _t(win), _t(pos), tcfg)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    for key in ("k", "v"):
        diff = np.abs(got_c[key].numpy().astype(np.int32) - np.asarray(want_c[key], np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(got_c[f"{key}_scale"].numpy(), np.asarray(want_c[f"{key}_scale"]),
                                   rtol=1e-5)
    assert not got_c["k"][:, :, :, prompt_len:].any()  # nothing past the window

    rng = np.random.default_rng(2)
    new = {"k": rng.integers(-127, 128, (2, 2, B, 16)).astype(np.int8),
           "k_scale": rng.random((2, 2, B)).astype(np.float32),
           "v": rng.integers(-127, 128, (2, 2, B, 16)).astype(np.int8),
           "v_scale": rng.random((2, 2, B)).astype(np.float32)}
    want = jfd.scatter_new_kv(want_c, {k: jnp.asarray(v) for k, v in new.items()}, jnp.int32(9))
    got = tfd.scatter_new_kv(got_c, {k: _t(v) for k, v in new.items()}, 9)
    assert got is got_c  # in place
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key][:, :, :, 9].numpy(), np.asarray(want[key])[:, :, :, 9])


# ------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def serving():
    """A tiny LLaVA in the int8-KV serving configuration, its JAX and port
    generators with fused engines (each engine consumes its own copy of the
    weights)."""
    params = _llava_params(8)
    jmodel = JLlava(JLlavaConfig.tiny(**SERVE))
    cfg = LlavaConfig.tiny(**SERVE)
    tok = FakeTokenizer()
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    jgen = JGenerator(jmodel, copy.deepcopy(params), tok, P, image_size=S, checkpoint_name="tiny",
                      fused_decode=True)
    tmodel = load_jax_params(LlavaForCausalLM(cfg), params).eval()
    tgen = Llava15Generator(tmodel, tok, P, image_size=S, checkpoint_name="tiny",
                            fused_decode=True)
    eager = Llava15Generator(load_jax_params(LlavaForCausalLM(cfg), params).eval(), tok, P,
                             image_size=S, checkpoint_name="tiny")
    return dict(jgen=jgen, tgen=tgen, eager=eager, cfg=cfg)


def _items(cfg, n, same_image=False):
    rng = np.random.default_rng(4)
    S = cfg.vision.image_size
    image = rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8)
    return [{"question": f"Is object {i} present?", "question_id": i,
             "image": image if same_image else rng.integers(0, 255, size=(S, S, 3),
                                                              dtype=np.uint8)}
            for i in range(n)]


def test_fused_engines_match(serving):
    """generate on both fused engines (ragged prompts, left padding): equal
    greedy tokens, first logits within 1e-4; the port's stacked weights
    replaced the per-layer ones."""
    jgen, tgen = serving["jgen"], serving["tgen"]
    prompts, starts, images = tgen._prepare(_items(serving["cfg"], 2))
    prompts[1] = prompts[1][:-3]
    kw = dict(images=images, image_starts=starts, max_new_tokens=4)
    want, got = jgen.engine.generate(prompts, **kw), tgen.engine.generate(prompts, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, atol=ATOL)
    assert tgen.model.llm.model.layers[0].mlp.gate_up_proj.q.numel() == 0
    # the prefill equals the per-layer int8-KV model's
    eager = serving["eager"].engine.generate(prompts, **dict(kw, max_new_tokens=1))
    np.testing.assert_allclose(got.first_logits, eager.first_logits, atol=ATOL)


def test_fused_generator_modes_match_jax(serving, monkeypatch):
    """greedy_gen's answers and autocheck's probabilities equal the JAX
    fused generator's; diverse_gen takes the batch generate path (no
    generate_repeated: it raises on a fused engine) and autocheck runs the
    prefill only (no decode step)."""
    jgen, tgen, cfg = serving["jgen"], serving["tgen"], serving["cfg"]
    items = _items(cfg, 3, same_image=True)
    got = [r["answer"] for r in tgen.greedy_gen(items[:2], max_new_tokens=3)]
    assert got == [r["answer"] for r in jgen.greedy_gen(items[:2], max_new_tokens=3)]
    steps = []
    orig = tgen.engine._step
    monkeypatch.setattr(tgen.engine, "_step", lambda *a: steps.append(1) or orig(*a))
    got = tgen.autocheck(items, batch_size=2)
    assert not steps
    want = jgen.autocheck(items, batch_size=2)
    for a, b in zip(got, want):
        for w in a["scores"]:
            assert abs(a["scores"][w] - b["scores"][w]) < 1e-5
    rows = tgen.diverse_gen([items[0]] * 3, max_new_tokens=3, seed=1)
    assert len(rows) == 3 and all(isinstance(r["answer"], str) for r in rows)
    assert steps  # the sampled answers decoded through the fused step


def test_fused_engine_value_errors(serving):
    """The JAX engine's checks: a model without int8/int4 weights, fused
    projections and an int8 cache is refused; the per-layer paths raise on
    a fused engine."""
    tok = FakeTokenizer()
    for kw in (dict(), dict(SERVE, fuse_proj=False), dict(SERVE, kv_cache_dtype="fp"),
               dict(quantize=True, fuse_proj=True, kv_cache_dtype="int8", num_kv_heads=3)):
        cfg = LlavaConfig.tiny(**kw)
        with pytest.raises(ValueError, match="fused_decode requires quantize"):
            DecodeEngine(LlavaForCausalLM(cfg, device="meta"), eos_id=tok.eos_token_id,
                         fused_decode=True)
    eng = serving["tgen"].engine
    for call in (lambda: eng.generate_repeated([1, 2, 3], n=2),
                 lambda: eng.score_shared_prefix([1, 2], [[3]]),
                 lambda: eng.score_pair_logps([[1]], [[2], [3]], [[2], [3]])):
        with pytest.raises(ValueError, match="fused_decode=False"):
            call()
