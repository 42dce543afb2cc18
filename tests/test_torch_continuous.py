"""The port's continuous batching (genai/continuous.py, DecodeEngine.
generate_continuous / generate_many, the fused cache's slot scatter and
compaction) against the port's own generate and the JAX package's, on the
CPU.

Greedy decoding is batch-independent (per-row masks, content-relative
positions), so under any slot schedule, refill, write-column advance or
compaction the continuous output must equal per-prompt `generate` token for
token (the cases of tests/test_continuous.py), and equal the JAX
`ContinuousGenerator` on the same bridged fp32 weights: tokens and lengths
exactly, first logits within ATOL (fp32 sums in other orders, as
tests/test_torch_engine.py). The fused engine runs kernel #16's twin here
and the JAX kernel in interpret mode. Sampled tokens are not compared with
JAX (the two draw different random bits from one seed).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai.continuous import ContinuousGenerator as JContinuous
from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.sampling import SamplingParams as JSamplingParams
from rlaifv_tpu.models.convert import fuse_llm_projections, quantize_llm_int8
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.ops import fused_decode as jfd
from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator, _bucket, _pow2_at_least
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.ops import fused_decode as tfd

ATOL = 1e-4
GREEDY = SamplingParams.greedy()
SERVE = dict(quantize=True, quantize_lm_head=False, fuse_proj=True, kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def lm_params():
    cfg = JLlamaConfig.tiny()
    return JLlama(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def lm(lm_params):
    """The port's tiny Llama on the JAX weights, an engine that never stops
    early (eos -1: rows run to their budget)."""
    model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny()), lm_params).eval()
    return DecodeEngine(model, eos_id=-1, pad_id=0)


@pytest.fixture(scope="module")
def llava_params():
    cfg = JLlavaConfig.tiny()
    ids = jnp.ones((1, cfg.num_image_tokens + 8), jnp.int32)
    img = jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3))
    return JLlava(cfg).init(jax.random.PRNGKey(0), ids, images=img,
                            image_starts=jnp.asarray([0]))["params"]


def _llava_engine(params, **llm_kw):
    model = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny(**llm_kw)), params).eval()
    return DecodeEngine(model, eos_id=-1, pad_id=0)


def _prompts(seed, lengths, lo=3, hi=200):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(lo, hi, size=n))) for n in lengths]


def _reference(engine, prompts, sampling=GREEDY, max_new=6, **kw):
    """Per-prompt generate (a batch of 1): what each prompt's tokens must
    equal under any schedule."""
    toks, lens = [], []
    for i, p in enumerate(prompts):
        extra = {k: (v[i:i + 1] if k == "images" else [v[i]]) for k, v in kw.items()}
        res = engine.generate([p], sampling=sampling, max_new_tokens=max_new, prompt_bucket=8,
                              **extra)
        toks.append(res.tokens[0])
        lens.append(res.lengths[0])
    return toks, lens


def _check(res, ref_toks, ref_lens):
    for i, (rt, rl) in enumerate(zip(ref_toks, ref_lens)):
        n = int(res.lengths[i])
        assert n == int(rl), f"prompt {i}: length {n} != {rl}"
        np.testing.assert_array_equal(res.tokens[i, :n], rt[:n], err_msg=f"prompt {i}")
        assert (res.tokens[i, n:] == 0).all()


def _count_window_prefills(gen):
    calls = [0]
    orig = gen._window_prefill

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    gen._window_prefill = counting
    return calls


def test_bucket_and_pow2_match_jax():
    from rlaifv_tpu.genai import continuous as jc

    for n in range(0, 40):
        for b in (1, 8, 64):
            assert _bucket(n, b) == jc._bucket(n, b)
        for cap in (1, 4, 8, 16):
            assert _pow2_at_least(n, cap) == jc._pow2_at_least(n, cap)


# ------------------------------------------------ against the port's generate


@pytest.mark.parametrize("slots,chunk", [(2, 4), (3, 8), (4, 2)])
def test_continuous_matches_generate_text(lm, slots, chunk):
    prompts = _prompts(0, (13, 4, 22, 7, 3, 17, 9))
    gen = ContinuousGenerator(lm, slots=slots, chunk=chunk, max_new_tokens=6,
                              sampling=GREEDY, prompt_bucket=8)
    res = gen.run(prompts)
    _check(res, *_reference(lm, prompts))
    assert gen.stats["refill_waves"] >= 2 and gen.stats["prefills"] >= 2


def test_continuous_eos_and_varied_finish(lm):
    """With a real eos id some rows stop early and their slots refill
    mid-flight."""
    prompts = _prompts(1, (11, 5, 19, 8, 6))
    eos = int(lm.generate(prompts[:1], max_new_tokens=1, prompt_bucket=8).tokens[0, 0])
    engine = DecodeEngine(lm.model, eos_id=eos, pad_id=0)
    gen = ContinuousGenerator(engine, slots=2, chunk=4, max_new_tokens=8, sampling=GREEDY,
                              prompt_bucket=8)
    res = gen.run(prompts)
    _check(res, *_reference(engine, prompts, max_new=8))
    assert res.lengths[0] == 1 and res.tokens[0, 0] == eos


def test_continuous_compaction_and_gt_advance(lm):
    """A small headroom and many short rows force compactions; a long
    prompt queued behind short active rows forces the write-column
    advance."""
    prompts = _prompts(2, (40, 4, 38, 37, 5, 36, 6, 33, 7, 30, 8, 3))
    gen = ContinuousGenerator(lm, slots=2, chunk=4, max_new_tokens=16, sampling=GREEDY,
                              prompt_bucket=8, headroom=8)
    res = gen.run(prompts)
    _check(res, *_reference(lm, prompts, max_new=16))
    assert gen.stats["compactions"] >= 1, gen.stats


def test_continuous_repetition_penalty(lm):
    """token_seen resets per slot at a refill."""
    prompts = _prompts(3, (10, 4, 15, 6))
    sp = SamplingParams(do_sample=False, repetition_penalty=1.3)
    gen = ContinuousGenerator(lm, slots=2, chunk=4, max_new_tokens=6, sampling=sp,
                              prompt_bucket=8)
    _check(gen.run(prompts), *_reference(lm, prompts, sampling=sp))


def test_continuous_per_prompt_budgets(lm):
    prompts = _prompts(5, (9, 5, 14, 7))
    budgets = [3, 7, 1, 5]
    gen = ContinuousGenerator(lm, slots=2, chunk=4, max_new_tokens=8, sampling=GREEDY,
                              prompt_bucket=8)
    res = gen.run(prompts, max_new_per_prompt=budgets)
    ref, _ = _reference(lm, prompts, max_new=8)
    for i, b in enumerate(budgets):
        assert int(res.lengths[i]) == b
        np.testing.assert_array_equal(res.tokens[i, :b], ref[i][:b])
        assert (res.tokens[i, b:] == 0).all()


def _image_prompts(cfg, seed, extras, repeats=1):
    rng = np.random.default_rng(seed)
    S, P = cfg.vision.image_size, cfg.num_image_tokens
    images = rng.integers(0, 255, size=(len(extras), S, S, 3), dtype=np.uint8)
    prompts, rows, keys = [], [], []
    for q, extra in enumerate(extras):
        body = list(map(int, rng.integers(3, 200, size=extra)))
        for _ in range(repeats):
            prompts.append([1] + [-2] * P + body)  # patch sentinels at [1, 1 + P)
            rows.append(q)
            keys.append(q)
    return prompts, images[np.asarray(rows)], [1] * len(prompts), keys


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_continuous_multimodal(llava_params, kv):
    engine = _llava_engine(llava_params, kv_cache_dtype=kv)
    prompts, images, starts, _ = _image_prompts(engine.model.cfg, 4, (3, 7, 5))
    gen = ContinuousGenerator(engine, slots=2, chunk=4, max_new_tokens=5, sampling=GREEDY,
                              prompt_bucket=8)
    res = gen.run(prompts, images=images, image_starts=starts)
    _check(res, *_reference(engine, prompts, max_new=5, images=images, image_starts=starts))


def test_continuous_with_int8_kv_cache(lm_params):
    """The int8 cache's {k, k_scale, v, v_scale} leaves (3-D scales) take
    the same scatter and roll; tokens equal the int8-cache generate."""
    model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(kv_cache_dtype="int8")),
                            lm_params).eval()
    engine = DecodeEngine(model, eos_id=-1, pad_id=0)
    prompts = _prompts(5, (5, 9, 3, 7, 6), lo=5, hi=255)
    gen = ContinuousGenerator(engine, slots=2, chunk=2, max_new_tokens=10, sampling=GREEDY,
                              prompt_bucket=8)
    _check(gen.run(prompts), *_reference(engine, prompts, max_new=10))


def test_continuous_spans_raise(lm, lm_params):
    """MiniCPM-V's pre-encoded span features (the "spans" refill mode) on
    the bare LM: the JAX engine splices spans into any model's token
    embeddings, so greedy continuous tokens equal the JAX
    ContinuousGenerator's on the same weights and per-prompt generate's,
    through refills of padded windows (rows with 1-3 active spans, the
    padding rows' starts -1) and a compaction."""
    prompts = _prompts(6, (90, 4, 60, 9, 3, 46, 7, 12), lo=5, hi=255)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(8, 3, 2, 64)).astype(np.float32)
    starts = np.asarray([[0, 40, 80], [2, -1, -1], [1, 30, -1], [3, 7, -1], [1, -1, -1],
                         [44, -1, 5], [0, 4, -1], [-1, 9, 2]])
    kw = dict(span_features=feats, span_starts=starts)
    cont = dict(slots=2, chunk=4, max_new_tokens=12, prompt_bucket=8, headroom=8)
    gen = ContinuousGenerator(lm, sampling=GREEDY, **cont)
    got = gen.run(prompts, collect_first_logits=True, **kw)
    assert gen.stats["compactions"] > 0 and gen.stats["prefills"] > 1
    jeng = JEngine(JLlama(JLlamaConfig.tiny()), lm_params, eos_id=-1, pad_id=0)
    want = JContinuous(jeng, sampling=JSamplingParams.greedy(), **cont).run(
        prompts, collect_first_logits=True, **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_allclose(got.first_logits, np.asarray(want.first_logits), atol=ATOL)
    refs = [lm.generate([p], span_features=feats[i:i + 1], span_starts=starts[i:i + 1],
                        sampling=GREEDY, max_new_tokens=12, prompt_bucket=8).tokens[0]
            for i, p in enumerate(prompts)]
    np.testing.assert_array_equal(got.tokens, np.stack(refs))
    via_engine = lm.generate_continuous(prompts, slots=2, chunk=4, max_new_tokens=12,
                                        prompt_bucket=8, **kw)
    np.testing.assert_array_equal(via_engine.tokens, got.tokens)


# ------------------------------------------------ share_keys


def test_continuous_share_keys_greedy_parity(lm):
    """Repeat-expanded prompts refill through the window prefill and the
    broadcast scatter, and still equal generate; stragglers of a key reuse
    its saved window."""
    base = _prompts(7, (11, 6, 9))
    prompts, keys = [], []
    for q, p in enumerate(base):
        prompts += [list(p) for _ in range(4)]
        keys += [q] * 4
    prompts.append(_prompts(8, (5,))[0])
    keys.append("solo")
    gen = ContinuousGenerator(lm, slots=3, chunk=4, max_new_tokens=6, sampling=GREEDY,
                              prompt_bucket=8)
    calls = _count_window_prefills(gen)
    res = gen.run(prompts, share_keys=keys)
    _check(res, *_reference(lm, prompts))
    assert calls[0] <= len(base) + 1, calls[0]
    assert gen.stats["scatter_refills"] >= len(base)


def test_continuous_share_keys_multimodal_int8(llava_params):
    engine = _llava_engine(llava_params, kv_cache_dtype="int8")
    prompts, images, starts, keys = _image_prompts(engine.model.cfg, 8, (4, 5), repeats=3)
    gen = ContinuousGenerator(engine, slots=2, chunk=4, max_new_tokens=5, sampling=GREEDY,
                              prompt_bucket=8)
    res = gen.run(prompts, images=images, image_starts=starts, share_keys=keys)
    _check(res, *_reference(engine, prompts, max_new=5, images=images, image_starts=starts))


def test_continuous_share_keys_sampled_rows_differ(lm):
    """Slots refilled from one window still draw their own tokens."""
    p = _prompts(9, (10,))[0]
    gen = ContinuousGenerator(lm, slots=4, chunk=4, max_new_tokens=8,
                              sampling=SamplingParams(temperature=1.0, do_sample=True),
                              prompt_bucket=8)
    res = gen.run([list(p) for _ in range(6)], share_keys=[0] * 6, seed=3)
    assert len({tuple(res.tokens[i]) for i in range(6)}) > 1


def test_continuous_share_keys_singleton_saves_window(lm):
    """A key with one instance in its first wave and more queued behind it
    still takes the shared path, so its window is saved and the next wave
    refills with no prefill."""
    pa, pb = _prompts(5, (9, 7))
    prompts = [list(pa), list(pa), list(pb), list(pb), list(pb)]
    gen = ContinuousGenerator(lm, slots=3, chunk=4, max_new_tokens=5, sampling=GREEDY,
                              prompt_bucket=8)
    calls = _count_window_prefills(gen)
    res = gen.run(prompts, share_keys=["A", "A", "B", "B", "B"])
    _check(res, *_reference(lm, prompts, max_new=5))
    assert calls[0] == 2, calls[0]


@pytest.mark.parametrize("share", [False, True])
def test_fewer_prompts_than_slots_under_sampling(lm, share):
    """While the queue is shorter than the slots, empty slots (an all-zero
    mask row) ride along: every draw stays a valid token and the rows end at
    their budgets."""
    prompts = [_prompts(10, (6,))[0]] * 3 if share else _prompts(10, (6, 9, 4))
    sp = SamplingParams(temperature=0.7, top_p=0.9, do_sample=True)
    gen = ContinuousGenerator(lm, slots=8, chunk=4, sampling=sp, max_new_tokens=6,
                              prompt_bucket=8)
    res = gen.run(prompts, seed=1, max_new_per_prompt=[6, 2, 5],
                  share_keys=[0, 0, 0] if share else None)
    np.testing.assert_array_equal(res.lengths, [6, 2, 5])
    for i, n in enumerate(res.lengths):
        assert ((res.tokens[i, :n] >= 0) & (res.tokens[i, :n] < lm.vocab_size)).all()
        assert (res.tokens[i, n:] == 0).all()
    assert gen.stats["refill_waves"] == 1


# ------------------------------------------------ against the JAX package


def _jax_lm_engine(params, fused=False, **kw):
    return JEngine(JLlama(JLlamaConfig.tiny(**kw)), params, eos_id=-1, pad_id=0,
                   fused_decode=fused)


def _serve_params(lm_params):
    return jax.tree.map(jnp.asarray, fuse_llm_projections(
        quantize_llm_int8(copy.deepcopy(lm_params), include_lm_head=False)))


@pytest.mark.parametrize("engine", ["bf16", "int8_kv", "fused", "share_keys"])
def test_continuous_matches_jax(lm_params, engine):
    """The port's ContinuousGenerator against the JAX one on the same
    weights, with a compaction on the port's side (the JAX chunk leaves
    early once every row is done, so its write column and compactions may
    fall elsewhere; the tokens may not): the per-layer float cache, the
    int8 cache on int8 fused weights, the fused engine (the JAX kernel in
    interpret mode) and share_keys."""
    prompts = _prompts(11, (90, 4, 60, 9, 3, 46, 7, 12), lo=5, hi=255)
    kw = dict(slots=2, chunk=4, max_new_tokens=12, prompt_bucket=8, headroom=8)
    run_kw = dict(collect_first_logits=True)
    if engine == "share_keys":
        prompts = [p for p in prompts[:3] for _ in range(3)]
        run_kw["share_keys"] = [k for k in range(3) for _ in range(3)]
    if engine in ("bf16", "share_keys"):
        model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny()), lm_params)
        jeng = _jax_lm_engine(lm_params)
    else:
        # the port's models first: the JAX fused engine consumes its tree
        params = _serve_params(lm_params)
        model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(**SERVE)), params)
        eager = DecodeEngine(load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(**SERVE)),
                                             params).eval(), eos_id=-1, pad_id=0)
        jeng = _jax_lm_engine(params, fused=engine == "fused", **SERVE)
    teng = DecodeEngine(model.eval(), eos_id=-1, pad_id=0, fused_decode=engine == "fused")
    want = JContinuous(jeng, sampling=JSamplingParams.greedy(), **kw).run(prompts, **run_kw)
    gen = ContinuousGenerator(teng, sampling=GREEDY, **kw)
    got = gen.run(prompts, **run_kw)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=ATOL)
    assert gen.stats["compactions"] >= 1, gen.stats
    if engine == "fused":  # and the port's own per-layer int8-cache engine
        _check(got, *_reference(eager, prompts, max_new=12))


def test_generate_many_matches_jax(lm_params, lm):
    prompts = _prompts(12, (13, 4, 22, 7, 3, 17, 9))
    want = _jax_lm_engine(lm_params).generate_many(prompts, batch_size=3, max_new_tokens=5,
                                                    prompt_bucket=8)
    got = lm.generate_many(prompts, batch_size=3, max_new_tokens=5, prompt_bucket=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=ATOL)
    # and every row equals its own generate
    _check(got, *_reference(lm, prompts, max_new=5))


def test_generate_continuous_matches_jax_multimodal(llava_params):
    """generate_continuous with images (uint8 pixels, normalised on the
    device) against the JAX engine's on the same tiny LLaVA."""
    engine = _llava_engine(llava_params)
    prompts, images, starts, _ = _image_prompts(engine.model.cfg, 13, (3, 7, 5, 2))
    kw = dict(images=images, image_starts=starts, slots=2, chunk=4, max_new_tokens=5,
              prompt_bucket=8, collect_first_logits=True)
    want = JEngine(JLlava(JLlavaConfig.tiny()), llava_params, eos_id=-1,
                   pad_id=0).generate_continuous(prompts, **kw)
    got = engine.generate_continuous(prompts, **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=ATOL)


# ------------------------------------------------ the fused cache's helpers


def _stacked_cache(seed, n=2, KVH=2, B=4, L=32, Dh=16):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-127, 128, (n, KVH, B, L, Dh)).astype(np.int8),
            "k_scale": rng.random((n, KVH, B, L)).astype(np.float32),
            "v": rng.integers(-127, 128, (n, KVH, B, L, Dh)).astype(np.int8),
            "v_scale": rng.random((n, KVH, B, L)).astype(np.float32)}


@pytest.mark.parametrize("shift", [0, 1, 13, 31])
def test_compact_stacked_matches_jax(shift):
    cache = _stacked_cache(shift)
    want = jfd.compact_stacked({k: jnp.asarray(v) for k, v in cache.items()}, jnp.int32(shift))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    got = tfd.compact_stacked(tcache, shift)
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].data_ptr() == ptrs[k]  # in place


@pytest.mark.parametrize("col_start,slot_ids", [(0, None), (9, None), (5, [2, 0, 4, 4]),
                                                 (16, [3, 4])])
def test_write_prefill_window_matches_jax(col_start, slot_ids):
    """A layer's (R, Lp) window into the stacked cache at a column offset,
    into given slots (ids >= n_slots dropped), in place."""
    cache = _stacked_cache(1)
    R = len(slot_ids) if slot_ids is not None else 4
    rng = np.random.default_rng(2)
    mini = {"k": rng.integers(-127, 128, (R, 8, 2, 16)).astype(np.int8),
            "k_scale": rng.random((R, 8, 2)).astype(np.float32),
            "v": rng.integers(-127, 128, (R, 8, 2, 16)).astype(np.int8),
            "v_scale": rng.random((R, 8, 2)).astype(np.float32)}
    sid = None if slot_ids is None else jnp.asarray(slot_ids, jnp.int32)
    want = jfd.write_prefill_window({k: jnp.asarray(v) for k, v in cache.items()}, 1,
                                    {k: jnp.asarray(v) for k, v in mini.items()},
                                    jnp.int32(col_start), sid, 4)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = tfd.write_prefill_window(tcache, 1, {k: torch.from_numpy(v) for k, v in mini.items()},
                                   col_start, slot_ids, 4)
    assert got is tcache
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_stacked_prefill_tower_into_slots():
    """The write-through prefill with col_start and slot_ids writes what the
    plain prefill at column 0 writes, moved to those columns and slots, and
    nothing else."""
    cfg = LlamaConfig.tiny(**SERVE)
    model = LlamaForCausalLM(cfg).eval()
    stacked = tfd.stack_llama_params(model, cfg)
    g = torch.Generator().manual_seed(0)
    R, Lp, B, L = 2, 8, 4, 32
    embeds = torch.randn(R, Lp, cfg.hidden_size, generator=g) * 0.02
    mask = torch.ones(R, Lp, dtype=torch.int32)
    mask[1, :3] = 0
    pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    h0, plain = tfd.stacked_prefill_tower(stacked, tfd.init_stacked_cache(cfg, R, Lp), embeds,
                                          mask, pos, cfg)
    base = _stacked_cache(3, cfg.num_layers, cfg.num_kv_heads, B, L, cfg.head_size)
    cache = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
    h, cache = tfd.stacked_prefill_tower(stacked, cache, embeds, mask, pos, cfg, col_start=20,
                                         slot_ids=[3, 1], n_slots=B)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    for k, v in cache.items():
        want = torch.from_numpy(base[k].copy())
        want[:, :, 3, 20:28] = plain[k][:, :, 0]
        want[:, :, 1, 20:28] = plain[k][:, :, 1]
        assert torch.equal(v, want), k


def test_chunk_reads_the_device_once(lm, monkeypatch):
    """A chunk of T steps makes one host read (its packed tokens, done and
    cur_pos): counted on every tensor-to-host copy the chunk makes."""
    reads = []
    orig = torch.Tensor.cpu

    def spy(self, *a, **kw):
        reads.append(tuple(self.shape))
        return orig(self, *a, **kw)

    gen = ContinuousGenerator(lm, slots=2, chunk=5, max_new_tokens=6,
                              sampling=SamplingParams(temperature=0.8, do_sample=True,
                                                      repetition_penalty=1.2),
                              prompt_bucket=8)
    chunk = gen._chunk

    def counted(*a):
        monkeypatch.setattr(torch.Tensor, "cpu", spy)
        try:
            return chunk(*a)
        finally:
            monkeypatch.setattr(torch.Tensor, "cpu", orig)

    gen._chunk = counted
    gen.run(_prompts(14, (5, 9, 3)))
    assert reads == [(5 + 2, 2)] * gen.stats["chunks"], reads


def test_sample_token_is_multinomials_draw():
    """The sampler's exponential race is torch.multinomial's one-sample
    draw on the same generator state (so no generate output moved), with no
    host read."""
    from rlaifv_tpu_torch.genai.sampling import sample_token

    logits = torch.randn(5, 300, generator=torch.Generator().manual_seed(0)) * 3
    sp = SamplingParams(temperature=0.7, top_k=50, top_p=0.9)
    from rlaifv_tpu_torch.genai.sampling import filtered_logits

    probs = torch.softmax(filtered_logits(logits, sp), dim=-1)
    for seed in range(4):
        want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(seed))[:, 0]
        got = sample_token(torch.Generator().manual_seed(seed), logits, sp)
        assert torch.equal(got, want)


def test_continuous_generator_runs_again_from_fresh_state(lm):
    """A refill resets the slot's emitted count, budget and done flag; a
    second run on the same generator starts from fresh state."""
    gen = ContinuousGenerator(lm, slots=2, chunk=3, max_new_tokens=4, sampling=GREEDY,
                              prompt_bucket=8)
    prompts = _prompts(15, (6, 5, 4))
    first = gen.run(prompts, max_new_per_prompt=[4, 1, 3])
    again = gen.run(prompts, max_new_per_prompt=[4, 1, 3])
    np.testing.assert_array_equal(first.tokens, again.tokens)
    np.testing.assert_array_equal(first.lengths, [4, 1, 3])


# ------------------------------------------------ the decode twins at its masks


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("shift", [0, 96])
def test_prefix_twins_at_continuous_masks(splits, shift):
    """Kernels #4's and #5's split twins at the masks continuous batching
    gives them (active windows ending at the write column with different
    starts, finished rows ending earlier, a slot never filled, and a
    compaction's roll) against the JAX kernels in interpret mode: #4 within
    1e-4 (fp32), #5 within 2^-7 max|out| (as tests/test_torch_kv_int8.py);
    the empty slot's row is exactly 0."""
    import rlaifv_tpu.ops.decode_attention as jd
    from rlaifv_tpu_torch.ops import decode_attention as td
    from rlaifv_tpu_torch.utils.synth import continuous_mask

    B, L, H, KVH, D, gt = 6, 640, 8, 2, 32, 500
    mask = continuous_mask(B, L, gt, seed=splits, shift=shift)
    valid = gt + 1
    rng = np.random.default_rng(splits)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, L, KVH, D)).astype(np.float32) for _ in range(2))
    want = np.asarray(jd.decode_attention_prefix(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                                 jnp.int32(valid), block_l=128, interpret=True))
    got = td.decode_attention_prefix_split_ref(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                               valid, splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (got[1] == 0).all()
    kq, ks = jd.quantize_kv(jnp.asarray(k))
    vq, vs = jd.quantize_kv(jnp.asarray(v))
    arrays = [q, *(np.asarray(a) for a in (kq, ks, vq, vs)), mask]
    want = np.asarray(jd.decode_attention_prefix_int8(*(jnp.asarray(a) for a in arrays),
                                                      jnp.int32(valid), interpret=True))
    got = td.decode_attention_prefix_int8_split_ref(*(torch.from_numpy(np.array(a))
                                                      for a in arrays), valid, splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -7 * np.abs(want).max())
    assert (got[1] == 0).all()


@pytest.mark.parametrize("offset", [0, 128, 256, 2, 64, 130])
def test_int8_twin_depends_on_the_key_block_offset(offset):
    """Kernel #5's function quantises p per key block (128 columns in a
    896-column cache), so the same live keys give the same output wherever
    they sit at the same offset in the blocks (masked whole blocks before
    them: a continuous refill at a multiple of 128 columns from generate's
    place) and another quantisation of the same attention where they sit
    elsewhere (another offset, or a compaction's roll): 1-3% of max|out|
    apart here, a thousand times fp32 rounding and more than the 2^-7
    max|out| the twin is held to against the JAX kernel at one placement.
    Windows this long (300 keys, 3 blocks) are what the int8 engines'
    continuous runs see at 7B (chip_smoke.py phase 15c)."""
    from rlaifv_tpu_torch.ops import decode_attention as td

    B, H, KVH, D, n, L = 4, 8, 2, 32, 300, 896
    assert td.prefix_block_l(L) == 128
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, n, KVH, D)).astype(np.float32))
            for _ in range(2))

    def at(off):
        mask = torch.zeros(B, L, dtype=torch.int32)
        mask[:, off:off + n] = 1
        placed = []
        for x in (k, v):
            full = torch.zeros(B, L, KVH, D)
            full[:, off:off + n] = x
            placed += td.quantize_kv(full)
        return td.decode_attention_prefix_int8_ref(q, *placed, mask, off + n)

    base, got = at(0), at(offset)
    err, top = (got - base).abs().max().item(), base.abs().max().item()
    if offset % 128 == 0:
        assert torch.equal(got, base)
    else:
        assert 1e-3 * top < err <= 5e-2 * top, err / top
