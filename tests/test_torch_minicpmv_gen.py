"""The port's MiniCPM-Llama3-V 2.5 generator and chat
(genai/minicpmv_gen.py) against the JAX package's, on the CPU (tiny
widths, fp32, tests/fake_tokenizer.py: `<unk>` 3, `<image>` 310, `<slice>`
312).

- prompt building: the ids, the span starts and the slices' shapes equal
  the JAX generator's; the (B, S, Q, D) span features and (B, S) starts of
  a batch of differently sliced images equal the JAX `_prepare`'s (1e-4);
- on weights bridged from one flax tree: greedy `generate`,
  `generate_repeated` and `generate_continuous` tokens with spans equal to
  the JAX engine's (first logits within 1e-4 absolute); `generate_beam`
  with spans equal to the JAX engine's with its beam step moved to the
  greedy columns (tests/test_torch_beam.py::greedy_columns);
- autocheck scores through the shared prefix and the plain path within
  rtol 1e-4 of JAX's, and the port's shared equal to its plain within
  rtol 1e-4; the group whose last span ends past the common prefix takes
  the plain path;
- diverse_gen's shared (generate_repeated), continuous and plain paths,
  seeded; the int8-KV and fused generators (the JAX kernel in interpret
  mode): greedy tokens equal, autocheck within rtol 1e-4;
- `MiniCPMVChat` from a tiny checkpoint directory written here (fp32,
  `int8`, `int4`, `fused_decode`): greedy tokens equal to the JAX chat's on
  the same directory; the chat's answer equal to `generate` with the chat
  sampling; `int4_smooth` (the LLM smoothed first) too;
- the chat CLI's "minicpm" branch.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai import beam as jbeam
from rlaifv_tpu.genai import minicpmv_gen as jgen_mod
from rlaifv_tpu.genai.sampling import SamplingParams as JSamplingParams
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import minicpmv as jmcv
from rlaifv_tpu_torch import chat as tchat
from rlaifv_tpu_torch.genai import minicpmv_gen as tgen_mod
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import minicpmv as tmcv
from tests.fake_tokenizer import FakeTokenizer
from tests.test_torch_minicpmv import CKPT_CONFIG, _hf_minicpmv_sd, _init_params

ATOL = 1e-4
SCORE_RTOL = 1e-4
VOCAB = 512  # covers the fake tokenizer's ids (specials at 310-316)
GREEDY = SamplingParams.greedy()


def _scores_close(got, want, rtol=SCORE_RTOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["answer"] == b["answer"]
        assert set(a["scores"]) == {"yes", "Yes", "no", "No"}
        for w in a["scores"]:
            np.testing.assert_allclose(a["scores"][w], b["scores"][w], rtol=rtol, atol=0,
                                       err_msg=w)
        assert {k: v for k, v in a.items() if k != "scores"} == \
            {k: v for k, v in b.items() if k != "scores"}


def _jcfg(**llm):
    base = jmcv.MiniCPMVConfig.tiny()
    return dataclasses.replace(base, llm=dataclasses.replace(base.llm, vocab_size=VOCAB, **llm))


def _tcfg(**llm):
    base = tmcv.MiniCPMVConfig.tiny(vocab_size=VOCAB)
    return dataclasses.replace(base, llm=dataclasses.replace(base.llm, **llm))


@pytest.fixture(scope="module")
def params():
    # the LM scaled up so the tiny random model's logits are not flat (the
    # tower and resampler at their init scale: sharper attention there
    # turns fp32 rounding into 1e-3 differences of the features)
    p = _init_params(_jcfg())
    return {**p, "llm": jax.tree.map(lambda a: a * 3.0, p["llm"])}


def _gens(params, mode="float", fused=False):
    """The JAX and port generators on one tree; mode "int8": int8 LLM
    projections (head float), int8 KV (MiniCPMVChat(int8=True)'s model)."""
    tok = FakeTokenizer()
    llm, jparams = {}, params
    if mode == "int8":
        llm = dict(quantize=True, quantize_lm_head=False, kv_cache_dtype="int8",
                   fuse_proj=fused)
        qllm = jconvert.quantize_llm_int8(params["llm"], include_lm_head=False)
        if fused:
            qllm = jconvert.fuse_llm_projections(qllm)
        jparams = {**params, "llm": qllm}
    jgen = jgen_mod.MiniCPMVGenerator(jmcv.MiniCPMVForCausalLM(_jcfg(**llm)),
                                      jax.tree.map(jnp.asarray, copy.deepcopy(jparams)), tok,
                                      checkpoint_name="tiny", fused_decode=fused)
    tmodel = tconvert.load_jax_params(tmcv.MiniCPMVForCausalLM(_tcfg(**llm)), jparams).eval()
    tgen = tgen_mod.MiniCPMVGenerator(tmodel, tok, checkpoint_name="tiny", fused_decode=fused)
    return jgen, tgen


@pytest.fixture(scope="module")
def gens(params):
    return _gens(params)


@pytest.fixture(scope="module")
def int8_gens(params):
    return _gens(params, "int8")


SIZES = [(90, 60), (40, 70), (28, 28), (20, 30)]  # sliced 2 x 3, 2 x 1, unsliced x 2


def _items(n, same_image=False, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 255, size=(*SIZES[0], 3), dtype=np.uint8)
    return [{"question": f"Is there object {i} here? Please answer yes or no.",
             "question_id": i,
             "image": image if same_image else rng.integers(
                 0, 255, size=(*SIZES[i % len(SIZES)], 3), dtype=np.uint8),
             "metainfos": {"ds_question_id": f"ds{i}"}} for i in range(n)]


def test_prompts_equal_jax(gens):
    jgen, tgen = gens
    items = _items(4)
    n_slices = []
    for item in items:
        (ids, starts, slices), (jids, jstarts, jslices) = (tgen._build_prompt(item),
                                                           jgen._build_prompt(item))
        assert list(ids) == list(jids) and starts == jstarts
        assert [s.size for s in slices] == [s.size for s in jslices]
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(slices, jslices))
        assert len(starts) == len(slices)
        assert all(t == 3 for st in starts for t in ids[st:st + tgen.cfg.query_num])
        n_slices.append(len(slices))
    assert n_slices[0] > 2 and n_slices[2] == 1  # sliced and unsliced images
    prompts, feats, starts = tgen._prepare(items)
    jprompts, jfeats, jstarts = jgen._prepare(items)
    assert prompts == [list(p) for p in jprompts]
    np.testing.assert_array_equal(starts, jstarts)
    assert feats.shape == jfeats.shape and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), jfeats, rtol=0, atol=ATOL)
    assert tgen._yesno_ids() == jgen._yesno_ids()


def _greedy(gen, items, new=5, **kw):
    prompts, feats, starts = gen._prepare(items)
    return gen.engine.generate(prompts, span_features=feats, span_starts=starts,
                               sampling=GREEDY if isinstance(gen, tgen_mod.MiniCPMVGenerator)
                               else JSamplingParams.greedy(), max_new_tokens=new, **kw)


def _same_result(got, want):
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_allclose(got.first_logits, np.asarray(want.first_logits), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_greedy_generate_matches_jax(gens, int8_gens, mode):
    jgen, tgen = gens if mode == "float" else int8_gens
    items = _items(3)
    _same_result(_greedy(tgen, items), _greedy(jgen, items))


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_generate_repeated_matches_jax(gens, int8_gens, mode):
    jgen, tgen = gens if mode == "float" else int8_gens
    item = _items(1)[0]
    outs = []
    for gen, sp in ((tgen, GREEDY), (jgen, JSamplingParams.greedy())):
        prompts, feats, starts = gen._prepare([item])
        outs.append(gen.engine.generate_repeated(
            prompts[0], n=3, span_features=feats[0], span_starts=starts[0], sampling=sp,
            max_new_tokens=5))
    _same_result(*outs)
    # each repeat is the prompt's greedy generate
    np.testing.assert_array_equal(outs[0].tokens, np.repeat(_greedy(tgen, [item]).tokens, 3, 0))


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_generate_continuous_matches_jax(gens, int8_gens, mode):
    """Five differently sliced prompts through two slots: refills batch
    prompts of different span counts (padding rows, -1 starts)."""
    jgen, tgen = gens if mode == "float" else int8_gens
    items = _items(5, seed=3)
    outs = []
    for gen, sp in ((tgen, GREEDY), (jgen, JSamplingParams.greedy())):
        prompts, feats, starts = gen._prepare(items)
        outs.append(gen.engine.generate_continuous(
            prompts, span_features=feats, span_starts=starts, slots=2, sampling=sp,
            max_new_tokens=6, chunk=4, collect_first_logits=True))
    _same_result(*outs)
    np.testing.assert_array_equal(outs[0].tokens, _greedy(tgen, items, 6).tokens)
    # the features as host numpy take the same path
    prompts, feats, starts = tgen._prepare(items)
    host = tgen.engine.generate_continuous(prompts, span_features=feats.numpy(),
                                           span_starts=starts, slots=2, sampling=GREEDY,
                                           max_new_tokens=6, chunk=4)
    np.testing.assert_array_equal(host.tokens, outs[0].tokens)


@pytest.fixture
def greedy_columns(monkeypatch):
    """The JAX beam step moved to the greedy loop's columns
    (tests/test_torch_beam.py::greedy_columns)."""
    orig = jbeam.beam_search

    def shifted(llm_apply, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw):
        def step(params, *, input_ids, attention_mask, position_ids, cache, cache_index):
            mask = attention_mask.at[:, Lp].set(1).at[:, cache_index].set(0)
            return llm_apply(params, input_ids=input_ids, attention_mask=mask,
                             position_ids=position_ids - 1, cache=cache,
                             cache_index=cache_index - 1)

        return orig(step, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw)

    monkeypatch.setattr(jbeam, "beam_search", shifted)


def test_generate_beam_with_spans_matches_jax(params, greedy_columns):
    jgen, tgen = _gens(params)  # a fresh JAX engine: its beam program takes the shift
    items = _items(2, seed=4)
    outs = []
    for gen in (tgen, jgen):
        prompts, feats, starts = gen._prepare(items)
        outs.append(gen.engine.generate_beam(prompts, span_features=feats, span_starts=starts,
                                             num_beams=3, max_new_tokens=5))
    np.testing.assert_array_equal(outs[0].tokens, np.asarray(outs[1].tokens))
    np.testing.assert_array_equal(outs[0].lengths, np.asarray(outs[1].lengths))
    prompts, feats, starts = tgen._prepare(items)
    one = tgen.engine.generate_beam(prompts, span_features=feats, span_starts=starts,
                                    num_beams=1, max_new_tokens=5)
    np.testing.assert_array_equal(one.tokens, _greedy(tgen, items).tokens)


def _autocheck_items():
    """Four facts about one sliced image (one with a longer question), two
    other images, then a pair whose common prefix ends before the last span
    (the same question about two images of one size)."""
    items = _items(4, same_image=True) + _items(2, seed=1)
    items[1]["question"] = "Is there a very small red thing near the top? Please answer."
    return items


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_autocheck_matches_jax(gens, int8_gens, mode, shared):
    jgen, tgen = gens if mode == "float" else int8_gens
    items = _autocheck_items()
    got = tgen.autocheck(items, batch_size=2, shared_prefix=shared)
    _scores_close(got, jgen.autocheck(items, batch_size=2, shared_prefix=shared))
    if shared:
        _scores_close(got, tgen.autocheck(items, batch_size=2, shared_prefix=False))


def test_autocheck_shares_one_prefix_an_image(gens, monkeypatch):
    """One shared-prefix call for the image with 3 facts, holding every
    span; a group whose last span ends past the common prefix (here a
    prefix cut to 5 tokens) runs the plain path."""
    _, tgen = gens
    calls = []
    orig = tgen.engine.score_shared_prefix
    monkeypatch.setattr(tgen.engine, "score_shared_prefix",
                        lambda prefix, suffixes, **kw: calls.append((prefix, kw)) or
                        orig(prefix, suffixes, **kw))
    tgen.autocheck(_items(3, same_image=True))
    (prefix, kw), = calls
    starts = kw["span_starts"]
    assert (starts >= 0).all() and int(starts.max()) + tgen.cfg.query_num <= len(prefix)
    assert kw["span_features"].shape[0] == len(starts) > 2
    calls.clear()
    items = _items(3, same_image=True)
    plain = tgen.autocheck(items, shared_prefix=False)
    monkeypatch.setattr(tgen.engine, "longest_common_prefix_len", lambda seqs: 5)
    rows = tgen.autocheck(items)
    assert calls == [] and rows == plain


def test_diverse_gen_paths(gens, monkeypatch):
    """Repeat groups go through generate_repeated, continuous=True through
    generate_continuous, share_repeats=False through generate; each path
    keeps the items' order and the JAX rows' fields, and a seed fixes it."""
    jgen, tgen = gens
    items = [_items(1)[0]] * 3 + _items(2, seed=2)
    used = []
    for name in ("generate_repeated", "generate_continuous", "generate"):
        orig = getattr(tgen.engine, name)
        monkeypatch.setattr(tgen.engine, name,
                            lambda *a, _o=orig, _n=name, **kw: used.append(_n) or _o(*a, **kw))
    want = jgen.diverse_gen(items, max_new_tokens=3, batch_size=2)
    for kw, path in ((dict(), "generate_repeated"), (dict(continuous=True), "generate_continuous"),
                     (dict(share_repeats=False), "generate")):
        used.clear()
        rows = tgen.diverse_gen(items, max_new_tokens=3, batch_size=2, seed=1, **kw)
        assert path in used and (path != "generate" or "generate_repeated" not in used)
        assert rows == tgen.diverse_gen(items, max_new_tokens=3, batch_size=2, seed=1, **kw)
        assert [set(r) for r in rows] == [set(r) for r in want]
        assert [r["question_id"] for r in rows] == [r["question_id"] for r in want]
        assert [r["metainfos"] for r in rows] == [r["metainfos"] for r in want]


def test_fused_generator_matches_jax(params):
    """The int8 fused engines (the JAX kernel in interpret mode): greedy
    tokens equal, autocheck (the plain path on the port's fused engine)
    within SCORE_RTOL of JAX's plain path; diverse_gen takes generate."""
    jgen, tgen = _gens(params, "int8", fused=True)
    items = _items(2)
    want, got = _greedy(jgen, items, 4), _greedy(tgen, items, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    _scores_close(tgen.autocheck(items, batch_size=2),
                  jgen.autocheck(items, batch_size=2, shared_prefix=False))
    assert len(tgen.diverse_gen([items[0]] * 2, max_new_tokens=3)) == 2
    with pytest.raises(ValueError, match="per-layer"):
        prompts, feats, starts = tgen._prepare(items)
        tgen.engine.generate_beam(prompts, span_features=feats, span_starts=starts,
                                  max_new_tokens=2)


# ------------------------------------------------------------ checkpoints


def _write_ckpt(path: str) -> str:
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    save_file(_hf_minicpmv_sd(vocab=VOCAB, hidden=32), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(CKPT_CONFIG, vocab_size=VOCAB, hidden_size=32, intermediate_size=64), f)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_ckpt(str(tmp_path_factory.mktemp("mcv") / "MiniCPM-Llama3-V-2_5"))


CHAT_MODES = {"fp32": {}, "int8": dict(int8=True), "int4": dict(int4=True),
              "fused_decode": dict(fused_decode=True)}


@pytest.mark.parametrize("mode", list(CHAT_MODES))
def test_minicpmv_chat_matches_jax(ckpt, mode):
    _minicpmv_chat_matches_jax(ckpt, mode, CHAT_MODES[mode])


def _minicpmv_chat_matches_jax(ckpt, mode, kw):
    tok = FakeTokenizer()
    chat = tgen_mod.MiniCPMVChat(ckpt, tokenizer=tok, max_new_tokens=5, device="cpu", **kw)
    jchat = jgen_mod.MiniCPMVChat(ckpt, tokenizer=tok, max_new_tokens=5, **kw)
    llm = chat.gen.engine.llm.cfg
    assert chat.gen.model.cfg.llm.dtype == torch.float32
    assert (llm.hidden_size, chat.gen.cfg.query_num, chat.gen.cfg.scale_resolution) == (32, 4, 28)
    if mode != "fp32":
        bits = 4 if mode == "int4" else 8
        assert llm.quantize and llm.quantize_bits == bits and not llm.quantize_lm_head
        assert llm.kv_cache_dtype == "int8"
        assert chat.gen.model.vpm.layers[0].q_proj.weight.dtype == torch.float32
    assert llm.fuse_proj == (mode == "fused_decode")
    items = _items(2, seed=5)
    want, got = _greedy(jchat.gen, items, 4), _greedy(chat.gen, items, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.first_logits, np.asarray(want.first_logits), rtol=0,
                               atol=ATOL)
    question = {"question": "What do you see?", "image": items[0]["image"]}
    answer = chat.chat(question)
    sp = SamplingParams(temperature=0.7, top_p=0.8, do_sample=True, repetition_penalty=1.05)
    prompts, feats, starts = chat.gen._prepare([dict(question, question_id=0)])
    res = chat.gen.engine.generate(prompts, span_features=feats, span_starts=starts,
                                   sampling=sp, max_new_tokens=5, seed=0)
    assert isinstance(answer, str) and answer == chat.gen._text(res, 0)


def test_minicpmv_chat_int4_smooth_raises(ckpt):
    """int4_smooth=True raised NotImplementedError until
    models/quant_smooth.py was ported: it now runs the int4 path with the
    LM smoothed first (alpha 0.5, calibrated on the fake tokenizer's id
    ramp by each package's own forward), against the JAX chat as the int4
    mode is."""
    _minicpmv_chat_matches_jax(ckpt, "int4", dict(int4=True, int4_smooth=True))


def test_chat_cli_picks_minicpmv(ckpt, monkeypatch, capsys):
    """A path holding "minicpm" loads MiniCPMVChat (--load-8bit: the LLM
    int8 with an int8 cache); `main` prints the chat's answer."""
    import transformers

    chat = tchat.RLAIFVChat(ckpt, load_8bit=True, device="cpu", max_new_tokens=4,
                            tokenizer=FakeTokenizer())
    assert isinstance(chat.model, tgen_mod.MiniCPMVChat)
    assert chat.model.gen.engine.llm.cfg.quantize
    assert chat.model.gen.engine.llm.cfg.kv_cache_dtype == "int8"
    four = tchat.RLAIFVChat(ckpt, load_4bit=True, device="cpu", tokenizer=FakeTokenizer())
    assert four.model.gen.engine.llm.cfg.quantize_bits == 4
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **kw: FakeTokenizer())
    image = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "examples", "test.jpeg")
    tchat.main(["--model-path", ckpt, "--image", image, "--question", "Why?",
                "--max-new-tokens", "4", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    plain = tchat.RLAIFVChat(ckpt, device="cpu", max_new_tokens=4, tokenizer=FakeTokenizer())
    assert printed == plain.chat({"image": image, "question": "Why?"})
