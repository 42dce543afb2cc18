"""The port's beam search against the JAX package's, on the CPU.

1. Scripted logits: one numpy step function (logits from the step, the
   last token and the beam's own history, all multiples of 1/8, so rows
   hold exact ties) drives both `beam_search`s. Tokens are equal and scores
   within 1e-6: ties break toward the lower index in both packages (the
   port's stable sort, `jax.lax.top_k`'s order), EOS freezes beams, and a
   run in which every beam finishes early stops calling the model and pads
   the tail as the JAX scan does.
2. A tiny fp32 Llama and LLaVA bridged by `load_jax_params`: the port's
   `DecodeEngine.generate_beam` and `greedy_gen(num_beams=3)` against the
   JAX engine and generator (left-padded prompts, bf16-free fp32 and an
   int8 KV cache, EOS freezing): tokens equal, scores within 1e-5; K = 1
   equals greedy.
3. Beam+sample: reproducible by seed, varies with seed, at a low
   temperature one beam follows the greedy chain (tests/test_beam.py's
   checks in port form); the fused engine raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai import beam as jbeam
from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.genai import beam as tbeam
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.convert import load_jax_params, set_llm_config
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from tests.fake_tokenizer import FakeTokenizer

V, M, LP, B = 16, 5, 8, 2
EOS, PAD = 3, 0


def _tables(scenario: str, max_new: int, seed: int = 0):
    """Step tables: logits = T1[step, last token] + T2[history % M], in
    eighths. "eos_mid": EOS leads after token 5 at step 2 (some beams
    freeze); "all_done": EOS leads every row at step 3 (every beam ends)."""
    rng = np.random.default_rng(seed)
    t1 = rng.integers(-6, 7, (max(max_new, 4) + 1, V, V)).astype(np.float32) / 4.0
    t2 = rng.integers(-3, 4, (M, V)).astype(np.float32) / 8.0
    t1[:, :, EOS] = -2.0
    first = rng.integers(-4, 5, (B, V)).astype(np.float32) / 4.0
    first[:, EOS] = -2.0
    if scenario == "eos_mid":
        t1[2, 5, EOS] = 3.0
        first[:, 5] = 2.0
    elif scenario == "all_done":
        t1[3, :, EOS] = 40.0
    hist0 = rng.integers(1, V, (B, LP)).astype(np.int32)
    return t1, t2, first, hist0


def _run_jax(t1, t2, first, hist0, K, max_new, lp):
    T1, T2 = jnp.asarray(t1), jnp.asarray(t2)
    max_len = LP + max_new + 1

    def llm_apply(params, input_ids, attention_mask, position_ids, cache, cache_index):
        tok = input_ids[:, 0]
        h = cache["h"].at[:, cache_index].set(tok + 1)
        logits = T1[cache_index - LP][tok] + T2[h.sum(axis=1) % M]
        return logits[:, None, :], {"h": h}

    h = jnp.zeros((B, max_len), jnp.int32).at[:, :LP].set(hist0)
    seqs, scores = jbeam.beam_search(
        llm_apply, None, jnp.asarray(first), {"h": h}, jnp.ones((B, max_len), jnp.int32),
        jnp.full((B,), LP, jnp.int32), LP, num_beams=K, max_new_tokens=max_new,
        eos_id=EOS, pad_id=PAD, length_penalty=lp)
    return np.asarray(seqs), np.asarray(scores)


class _Scripted:
    """The same step as a port step function; counts its calls."""

    def __init__(self, t1, t2):
        self.t1, self.t2 = torch.from_numpy(t1), torch.from_numpy(t2)
        self.calls = 0

    def __call__(self, tok, cache_mask, positions, cache, cache_index):
        self.calls += 1
        h = cache[0]["h"]
        # the port feeds step t at column LP + t - 1 (the JAX function at
        # LP + t): the same step index, and the history's sum is the same
        h[:, cache_index] = (tok + 1).to(h.dtype)
        logits = self.t1[cache_index - LP + 1][tok] + self.t2[h.sum(dim=1) % M]
        return logits, cache


def _run_torch(t1, t2, first, hist0, K, max_new, lp):
    max_len = LP + max_new + 1
    h = torch.zeros((B, max_len), dtype=torch.int32)
    h[:, :LP] = torch.from_numpy(hist0)
    step = _Scripted(t1, t2)
    seqs, scores = tbeam.beam_search(
        step, torch.from_numpy(first), [{"h": h.repeat_interleave(K, dim=0)}],
        torch.ones((B * K, max_len), dtype=torch.int32),
        torch.full((B * K,), LP), LP, num_beams=K, max_new_tokens=max_new,
        eos_id=EOS, pad_id=PAD, length_penalty=lp)
    return seqs, scores, step.calls


@pytest.mark.parametrize("scenario", ["ties", "eos_mid", "all_done"])
@pytest.mark.parametrize("lp", [0.0, 1.0, 2.0])
def test_scripted_beam_matches_jax(scenario, lp):
    max_new = 7
    tabs = _tables(scenario, max_new)
    want_seqs, want_scores = _run_jax(*tabs, 3, max_new, lp)
    seqs, scores, calls = _run_torch(*tabs, 3, max_new, lp)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-6)
    if scenario == "all_done":
        # every beam ended at step 3: the model is not called past it
        assert calls == 3
        assert (seqs[:, 4:] == PAD).all() and (seqs[:, 3] == EOS).all()
    else:
        assert calls == max_new - 1


@pytest.mark.parametrize("K,max_new", [(1, 6), (4, 6), (2, 3), (3, 2)])
def test_scripted_beam_widths_match_jax(K, max_new):
    tabs = _tables("eos_mid", max_new, seed=K)
    want_seqs, want_scores = _run_jax(*tabs, K, max_new, 1.0)
    seqs, scores, _ = _run_torch(*tabs, K, max_new, 1.0)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-6)


def test_top_k_stable_takes_the_lower_index_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 1.0]])
    vals, idx = tbeam.top_k_stable(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("shape,dtype", [
    ((1,), torch.float32),  # the last axis too narrow for 8-byte elements
    ((2, 8), torch.bfloat16),  # a bf16 cache's (KVH, D): moved as int64
    ((2, 16), torch.int8),  # an int8 cache's values
    ((2,), torch.float32),  # and its scales
])
def test_reorder_rows_copies_only_moved_rows_and_live_columns(shape, dtype):
    g = torch.Generator().manual_seed(0)
    c = (torch.randn((4, 6) + shape, generator=g) * 50).to(dtype)
    mask = torch.arange(4 * 6).reshape(4, 6).int()
    before = c.clone()
    n = tbeam.reorder_rows([{"k": c}], mask, np.array([0, 0, 3, 2]), live=4)
    assert n == 3
    assert torch.equal(c[:, :4], before[[0, 0, 3, 2], :4])
    assert torch.equal(c[:, 4:], before[:, 4:])
    assert mask[1].tolist() == list(range(6)) and mask[2].tolist() == list(range(18, 24))


# ------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def lm():
    cfg = JLlamaConfig.tiny(attn_impl="dense")
    jmodel = JLlama(cfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return cfg, jmodel, params


@pytest.fixture
def greedy_columns(monkeypatch):
    """The JAX engines' beam_search with its model step moved to the greedy
    loop's columns: the sequences' token t - 1 at cache column Lp + t - 1
    and position prompt_len + t - 1, column Lp unmasked. The JAX function
    feeds it one column later (Lp + t, prompt_len + t, column Lp left
    masked); the port feeds the greedy columns (a deliberate difference),
    so the packages are compared with the JAX step shifted back."""
    orig = jbeam.beam_search

    def shifted(llm_apply, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw):
        def step(params, *, input_ids, attention_mask, position_ids, cache, cache_index):
            mask = attention_mask.at[:, Lp].set(1).at[:, cache_index].set(0)
            return llm_apply(params, input_ids=input_ids, attention_mask=mask,
                             position_ids=position_ids - 1, cache=cache,
                             cache_index=cache_index - 1)

        return orig(step, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw)

    monkeypatch.setattr(jbeam, "beam_search", shifted)


def _engines(lm, eos_id=-1, kv="fp"):
    cfg, _, params = lm
    jcfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    jeng = JEngine(JLlama(jcfg), params, eos_id=eos_id, pad_id=0)
    tmodel = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(kv_cache_dtype=kv)),
                             params).eval()
    return jeng, DecodeEngine(tmodel, eos_id=eos_id, pad_id=0)


PROMPTS = [[1, 7, 8, 9, 12, 40], [1, 5, 6], [1, 22, 23, 24, 25]]


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_generate_beam_matches_jax(lm, greedy_columns, K, kv):
    jeng, teng = _engines(lm, kv=kv)
    kw = dict(num_beams=K, max_new_tokens=6, prompt_bucket=4)
    want = jeng.generate_beam(PROMPTS, **kw)
    got = teng.generate_beam(PROMPTS, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=1e-5)
    if K == 1:
        greedy = teng.generate(PROMPTS, max_new_tokens=6, prompt_bucket=4)
        np.testing.assert_array_equal(got.tokens, greedy.tokens)


@pytest.mark.parametrize("length_penalty", [0.0, 2.0])
def test_generate_beam_eos_freezes_like_jax(lm, greedy_columns, length_penalty):
    """EOS = the greedy first token of row 0: beams finish at once or later,
    the post-EOS positions are PAD, and both packages pick the same beam."""
    jeng0, _ = _engines(lm)
    eos = int(jeng0.generate(PROMPTS[:1], max_new_tokens=1, prompt_bucket=4).tokens[0, 0])
    jeng, teng = _engines(lm, eos_id=eos)
    kw = dict(num_beams=3, max_new_tokens=5, prompt_bucket=4,
              length_penalty=length_penalty)
    want = jeng.generate_beam(PROMPTS, **kw)
    got = teng.generate_beam(PROMPTS, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=1e-5)
    for row, n in zip(got.tokens, got.lengths):
        assert (row[n:] == 0).all()


def test_one_beam_is_greedy_where_the_jax_beam_runs_a_column_late(lm):
    """The deliberate difference: the port's beam feeds the greedy loop's
    columns, so one beam is greedy decoding (its best score is the greedy
    tokens' log-probability); the JAX engine's beam feeds each token one
    column and one position later and scores another sequence function."""
    jeng, teng = _engines(lm)
    kw = dict(max_new_tokens=8, prompt_bucket=4)
    one = teng.generate_beam(PROMPTS, num_beams=1, **kw)
    greedy = teng.generate(PROMPTS, **kw)
    np.testing.assert_array_equal(one.tokens, greedy.tokens)
    np.testing.assert_array_equal(one.tokens, jeng.generate(PROMPTS, **kw).tokens)
    # the best score is the greedy tokens' mean log-probability under the
    # model, each row run unpadded in one forward
    for i, prompt in enumerate(PROMPTS):
        seq = torch.tensor([list(prompt) + one.tokens[i].tolist()])
        with torch.inference_mode():
            logits, _ = teng.llm(input_ids=seq)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        n = len(prompt)
        total = sum(float(logp[n - 1 + j, tok]) for j, tok in enumerate(one.tokens[i]))
        assert abs(total / one.lengths[i] - one.first_logits[i]) < 1e-4
    late = jeng.generate_beam(PROMPTS, num_beams=1, **kw)
    assert np.abs(late.first_logits - one.first_logits).max() > 1e-4


def test_beam_sample_reproducible_varies_and_low_temperature_is_greedy(lm):
    _, teng = _engines(lm)
    sp = SamplingParams.chat_12b()
    kw = dict(num_beams=3, max_new_tokens=6, prompt_bucket=4, sampling=sp)
    a = teng.generate_beam(PROMPTS, seed=0, **kw)
    b = teng.generate_beam(PROMPTS, seed=0, **kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    outs = {tuple(teng.generate_beam(PROMPTS, seed=s, **kw).tokens[0].tolist())
            for s in range(4)}
    assert len(outs) > 1, "beam sampling never varied across seeds"
    greedy = teng.generate(PROMPTS[:1], max_new_tokens=5, prompt_bucket=4)
    cold = teng.generate_beam(PROMPTS[:1], num_beams=1, max_new_tokens=5, prompt_bucket=4,
                              sampling=SamplingParams(temperature=1e-4, do_sample=True))
    np.testing.assert_array_equal(cold.tokens, greedy.tokens)


def test_beam_step_replays_forced_parents(lm):
    """`beam_step(forced=...)` follows recorded parents and tokens: a
    replay of a run's first steps gives that run's log-probs and scores."""
    _, teng = _engines(lm)
    ids = torch.tensor([[0, 0, 1, 5, 6], [1, 7, 8, 9, 12]])
    mask = (torch.tensor([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]])).int()

    def run(forced=None):
        first, cache, cmask = teng._prefill(ids, mask, None, None, 128, beams=3)
        state, _, _ = tbeam.beam_start(first, cache, cmask,
                                       mask.sum(1).repeat_interleave(3),
                                       num_beams=3, eos_id=-1)
        out = []
        for t in range(1, 4):
            parent, tok, logp = tbeam.beam_step(
                teng._step, state, t, Lp=5, eos_id=-1, pad_id=0,
                forced=forced[t - 1] if forced else None)
            out.append(((parent, tok), logp, state.scores.clone()))
        return out

    with torch.inference_mode():
        rec = run()
        rep = run([r[0] for r in rec])
    for (pt, logp, scores), (pt2, logp2, scores2) in zip(rec, rep):
        np.testing.assert_array_equal(pt[0], pt2[0])
        np.testing.assert_array_equal(pt[1], pt2[1])
        torch.testing.assert_close(logp2, logp, rtol=0, atol=0)
        torch.testing.assert_close(scores2, scores, rtol=0, atol=0)


# ------------------------------------------------------------ LLaVA


@pytest.fixture(scope="module")
def gens():
    cfg = JLlavaConfig.tiny()
    jmodel = JLlava(cfg)
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]),
    )["params"]
    tok = FakeTokenizer()
    jgen = JGenerator(jmodel, params, tok, P, image_size=S, checkpoint_name="tiny")
    tmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    tgen = Llava15Generator(tmodel, tok, P, image_size=S, checkpoint_name="tiny")
    return cfg, params, jgen, tgen


def _items(cfg, n):
    rng = np.random.default_rng(0)
    S = cfg.vision.image_size
    return [{"question": "Describe it." if i % 2 else f"What is object {i} doing now?",
             "question_id": i,
             "image": rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8),
             "metainfos": {"ds_question_id": f"ds{i}"}} for i in range(n)]


def test_greedy_gen_beams_matches_jax(gens, greedy_columns):
    cfg, _, jgen, tgen = gens
    items = _items(cfg, 3)
    want = jgen.greedy_gen(items, max_new_tokens=6, batch_size=2, num_beams=3)
    got = tgen.greedy_gen(items, max_new_tokens=6, batch_size=2, num_beams=3)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["question_id"] for r in got] == [0, 1, 2]


def test_llava_generate_beam_scores_match_jax(gens, greedy_columns):
    cfg, _, jgen, tgen = gens
    prompts, starts, images = tgen._prepare(_items(cfg, 3))
    kw = dict(images=images, image_starts=starts, num_beams=3, max_new_tokens=5)
    want = jgen.engine.generate_beam(prompts, **kw)
    got = tgen.engine.generate_beam(prompts, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=1e-5)


def test_fused_engine_refuses_beam(gens):
    """The fused engine frees the per-layer weights a beam step runs on: it
    raises (the JAX method has no guard)."""
    from rlaifv_tpu_torch.models.convert import fuse_llm_projections_, quantize_llm_int8

    cfg, params, _, _ = gens
    model = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    fuse_llm_projections_(quantize_llm_int8(model))
    set_llm_config(model, kv_cache_dtype="int8")
    eng = DecodeEngine(model, eos_id=2, pad_id=0, fused_decode=True)
    with pytest.raises(ValueError, match="generate_beam needs the per-layer path"):
        eng.generate_beam([[1, 5, 6]], num_beams=3, max_new_tokens=2)
