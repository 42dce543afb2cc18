"""The port's divide-and-conquer stage (Llama3-8B, a bare LM) against the
JAX package's, on the CPU.

- The copied prompts and functions (`parse_facts`, `divide_messages`,
  `changeq_messages`, `construct_question_yesno`, `batch_process` with its
  resume by the answer file) give the JAX module's results exactly.
- `LlamaConfig.llama3_8b` and `llama_config_from_hf` equal the JAX ones;
  `rope_cos_sin` at theta 5e5 and positions up to 8192 equals the JAX tables
  to one fp32 ulp (the same inverse frequencies, cos/sin of the same fp32
  angles in two libraries).
- A tiny HF LlamaForCausalLM with num_key_value_heads < num_attention_heads
  loads through `load_state_dict_dir` / `convert_llama` /
  `llama_params_from_jax` and computes HF's logits (atol 1e-4, fp32).
- The bare-LM DecodeEngine against the JAX DecodeEngine on a tiny
  Llama3-shaped model (GQA n_rep 4, theta 5e5, eps 1e-5, vocabulary 512 for
  the fake tokenizer's <|eot_id|> = 399), the JAX weights carried across:
  greedy tokens equal, first logits within 1e-4 (fp32, sums in another
  order, as tests/test_torch_engine.py); the same through `llama3_backend`
  with int8 weights + fuse_proj + an int8 KV cache (tests/test_torch_kv_int8
  .py's 1e-4) and with fused decode (the JAX kernel in interpret mode, the
  port's twin; tests/test_torch_fused_decode.py's 1e-4).
- The fused q/k/v projection at the Llama3 widths (q 4096, k 1024, v 1024)
  splits into the separate products, float and int8 (atol 1e-5: fp32
  products over K = 4096 that the CPU may block differently).
- `int4=True, int4_smooth=True` (AWQ smoothing at alpha 0.5, then int4,
  fused, an int8 cache) against the JAX engine on the JAX loader's tree:
  greedy tokens equal, first logits within 1e-4; `continuous=True` runs
  (tests/test_torch_chat.py holds its tokens to `generate`'s).
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai import divide_conquer as jdc
from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.sampling import SamplingParams as JSamplingParams
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import quant_smooth as jqs
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llama import rope_cos_sin as jrope
from rlaifv_tpu_torch.genai import divide_conquer as tdc
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig, LlamaForCausalLM, rope_cos_sin
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines
from tests.fake_tokenizer import FakeTokenizer

ATOL = 1e-4
ROPE_ATOL = 2.0 ** -24  # one fp32 ulp of values in [0.5, 1]
EOT = 399  # FakeTokenizer's id for "<|eot_id|>"
TINY3 = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=8, num_kv_heads=2, max_position_embeddings=256,
             rope_theta=500000.0, rms_norm_eps=1e-5)
SERVE = dict(quantize=True, quantize_lm_head=False, fuse_proj=True, kv_cache_dtype="int8")
SERVE4 = dict(SERVE, quantize_bits=4)

TEXTS = [
    "### Facts:\n- The cat is black.\n- There are two dogs.\n",
    "- one\n\n- two\n### Facts:\n-three",
    "   \n",
    "no bullet at all",
]
ITEMS = [
    {"raw_question": "What is shown?", "answer": "A black cat on a mat.",
     "facts": ["The cat is black.", "The cat is on a mat."]},
    {"question": "Describe it.", "text": " ".join(["word"] * 400), "facts": []},
    {"prompt": "P?", "answer": "Yes.", "facts": ["It is yes."]},
]


@pytest.mark.parametrize("text", TEXTS)
def test_parse_facts_matches_jax(text):
    assert tdc.parse_facts(text) == jdc.parse_facts(text)


@pytest.mark.parametrize("item", ITEMS)
def test_messages_match_jax(item):
    assert tdc.DIVIDE_PROMPT == jdc.DIVIDE_PROMPT
    assert tdc.CHANGEQ_PROMPT == jdc.CHANGEQ_PROMPT
    assert tdc.divide_messages(item) == jdc.divide_messages(item)
    assert tdc.changeq_messages(item) == jdc.changeq_messages(item)


def _answer_rows(n):
    return [{"question_id": i, "ds_question_id": f"ds{i // 2}",
             "raw_question": f"Question {i // 2}?", "answer": f"Answer number {i}.",
             "metainfos": {"image_path": f"/img/{i // 2}.jpg", "ds_question_id": f"ds{i // 2}"}}
            for i in range(n)]


def _stub_backend(calls):
    def gen(prompts):
        calls.append(len(prompts))
        return [f"- fact {len(p)}\n- other {len(p) % 7}" for p in prompts]

    def tmpl(messages):
        return "T:" + messages[0]["content"][-60:]

    return gen, tmpl


def test_batch_process_and_yesno_match_jax(tmp_path):
    """batch_process (facts, then changed facts) and construct_question_yesno
    write the JAX module's rows, and the port resumes a half-written answer
    file the way the JAX module does: only the missing rows are generated."""
    src = str(tmp_path / "ans.jsonl")
    write_jsonlines(src, _answer_rows(7))
    out = {}
    for name, mod in (("jax", jdc), ("torch", tdc)):
        d = tmp_path / name
        calls = []
        gen, tmpl = _stub_backend(calls)
        facts = mod.batch_process(src, str(d / "div.jsonl"), gen, tmpl, key="facts",
                                  wrap_func=mod.divide_messages, batch_size=3)
        gq = mod.batch_process(str(d / "div.jsonl"), str(d / "gq.jsonl"), gen, tmpl,
                               key="changed_facts", wrap_func=mod.changeq_messages,
                               batch_size=3)
        qas = mod.construct_question_yesno(str(d / "gq.jsonl"), str(d / "qas.jsonl"))
        out[name] = (facts, gq, qas, read_jsonlines(str(d / "qas.jsonl")), calls)
    assert out["torch"] == out["jax"]
    assert out["torch"][4] == [3, 3, 1, 3, 3, 1]

    # resume: the first 4 rows are already in the answer file
    for name, mod in (("jax", jdc), ("torch", tdc)):
        d = tmp_path / f"resume_{name}"
        os.makedirs(d)
        write_jsonlines(str(d / "div.jsonl"), out[name][0][:4])
        calls = []
        gen, tmpl = _stub_backend(calls)
        got = mod.batch_process(src, str(d / "div.jsonl"), gen, tmpl, key="facts",
                                wrap_func=mod.divide_messages, batch_size=2, start=0, end=-1)
        assert calls == [2, 1]  # rows 4-6 only
        assert got == out["jax"][0]
        assert read_jsonlines(str(d / "div.jsonl")) == out["jax"][0]


def test_batch_process_window_and_chunks_match_jax(tmp_path):
    src = str(tmp_path / "ans.json")
    with open(src, "w") as f:
        json.dump(_answer_rows(9), f)
    got = {}
    for name, mod in (("jax", jdc), ("torch", tdc)):
        gen, tmpl = _stub_backend([])
        got[name] = mod.batch_process(src, str(tmp_path / name / "x.jsonl"), gen, tmpl,
                                      key="facts", wrap_func=mod.divide_messages,
                                      batch_size=4, chunk_num=2, chunk_idx=1, start=1, end=8)
    assert got["torch"] == got["jax"] and len(got["torch"]) == 3


def test_llama3_config_and_rope_match_jax():
    want = JLlamaConfig.llama3_8b()
    got = LlamaConfig.llama3_8b()
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                  "num_kv_heads", "max_position_embeddings", "rope_theta", "rms_norm_eps",
                  "head_size"):
        assert getattr(got, field) == getattr(want, field), field
    pos = np.arange(8192)
    jc, js = jrope(jnp.asarray(pos), got.head_size, got.rope_theta)
    tc, ts = rope_cos_sin(torch.from_numpy(pos), got.head_size, got.rope_theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ROPE_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ROPE_ATOL)


def _hf_llama(tmp_path):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFLlama

    torch.manual_seed(0)
    hf_cfg = HFConfig(vocab_size=300, hidden_size=64, intermediate_size=160,
                      num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
                      max_position_embeddings=512, rope_theta=500000.0, rms_norm_eps=1e-5,
                      tie_word_embeddings=False)
    hf = HFLlama(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    return hf


def test_hf_gqa_checkpoint_loads_and_matches(tmp_path):
    """A tiny HF Llama with 2 KV heads for 8 query heads: the config reader
    equals the JAX one, and the loaded port model computes HF's logits."""
    hf = _hf_llama(tmp_path)
    cfg = tconvert.llama_config_from_hf(str(tmp_path))
    jcfg = jconvert.llama_config_from_hf(str(tmp_path))
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                  "num_kv_heads", "max_position_embeddings", "rope_theta", "rms_norm_eps",
                  "tie_word_embeddings"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.rope_theta) == (8, 2, 500000.0)
    tree = tconvert.convert_llama(tconvert.load_state_dict_dir(str(tmp_path)))
    jtree = jconvert.convert_llama(jconvert.load_state_dict_dir(str(tmp_path)))
    flat = dict(tconvert._flatten(tree))
    assert flat.keys() == dict(tconvert._flatten(jtree)).keys()
    for k, v in tconvert._flatten(jtree):
        np.testing.assert_array_equal(flat[k], v)
    sd = tconvert.llama_params_from_jax(tree)
    assert sd["model.layers.0.attn.k_proj.weight"].shape == (2 * 8, 64)
    model = tconvert.load_jax_params(LlamaForCausalLM(cfg), tree).eval()
    ids = torch.as_tensor([[1, 5, 9, 33, 200, 7, 8]])
    with torch.no_grad():
        want = hf(ids).logits
        got, _ = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def _jax_params():
    cfg = JLlamaConfig(**TINY3)
    ids = jnp.asarray(np.random.default_rng(0).integers(1, 300, size=(1, 8)), jnp.int32)
    return JLlama(cfg).init(jax.random.PRNGKey(0), ids)["params"]


def _prompts():
    tok = FakeTokenizer()
    texts = ["Is it red?", "A longer question about the picture here", "Hi"]
    return [tok(tok.apply_chat_template([{"role": "user", "content": t}], tokenize=False,
                                        add_generation_prompt=True)).input_ids for t in texts]


def _jax_engine(params, fused=False, **kw):
    return JEngine(JLlama(JLlamaConfig(**TINY3, **kw)), params, eos_id=EOT,
                   pad_id=FakeTokenizer().eos_token_id, fused_decode=fused)


def _generate_both(jeng, teng, n_new=6):
    prompts = _prompts()
    want = jeng.generate(prompts, sampling=JSamplingParams.greedy(), max_new_tokens=n_new)
    got = teng.generate(prompts, max_new_tokens=n_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=ATOL)
    return got


def test_bare_engine_matches_jax():
    """The bare-LM engine (no images, token embeddings only) against the
    JAX engine's bare-LM mode, both in fp32 on the CPU."""
    params = _jax_params()
    model = tconvert.load_jax_params(LlamaForCausalLM(LlamaConfig(**TINY3)), params).eval()
    eng = DecodeEngine(model, eos_id=EOT, pad_id=FakeTokenizer().eos_token_id)
    assert not eng._multimodal and eng.vocab_size == 512 and eng.device.type == "cpu"
    _generate_both(_jax_engine(params), eng)
    with pytest.raises(ValueError, match="no images"):
        eng.generate(_prompts(), images=np.zeros((3, 4, 4, 3), np.uint8),
                     image_starts=[0, 0, 0], max_new_tokens=1)


@pytest.mark.parametrize("fused", [False, True])
def test_llama3_backend_int8_matches_jax(fused):
    """`llama3_backend(int8=True)` (or fused_decode=True, which implies
    int8) quantises the built model in place (head float), fuses its
    projections and switches it to an int8 cache, as make_llama3_backend's
    JAX config and tree do; its engine's greedy tokens and first logits
    equal the JAX engine's on `fuse_llm_projections(quantize_llm_int8(...))`
    (fused: the JAX kernel in interpret mode against the port's twin)."""
    params = _jax_params()
    jparams = jax.tree.map(jnp.asarray, jconvert.fuse_llm_projections(
        jconvert.quantize_llm_int8(copy.deepcopy(params), include_lm_head=False)))
    model = tconvert.load_jax_params(LlamaForCausalLM(LlamaConfig(**TINY3)), params).eval()
    gen, tmpl = tdc.llama3_backend(model, FakeTokenizer(), int8=not fused, fused_decode=fused)
    cfg = model.cfg
    assert (cfg.quantize, cfg.quantize_bits, cfg.fuse_proj, cfg.kv_cache_dtype) == \
        (True, 8, True, "int8")
    assert not cfg.quantize_lm_head and model.lm_head.weight.dtype == torch.float32
    assert gen.engine.eos_id == EOT and gen.engine.fused_decode == fused
    _generate_both(_jax_engine(jparams, fused, **SERVE), gen.engine)
    if fused:  # the stacked arrays replaced the per-layer weights
        assert model.model.layers[0].mlp.gate_up_proj.q.numel() == 0
    msgs = tdc.divide_messages(ITEMS[0])
    assert tmpl(msgs) == FakeTokenizer().apply_chat_template(msgs, tokenize=False,
                                                             add_generation_prompt=True)


def test_llama3_backend_generate_fn_and_unported_options(monkeypatch):
    """generate_fn samples each prompt (the reference's T 0.2 / top-p 0.9)
    and decodes the row's tokens up to <|eot_id|> with the tokenizer;
    int4_smooth=True (once unported) serves the JAX loader's smoothed int4
    model; continuous=True (ported) builds a backend whose generate_fn goes
    through generate_continuous."""
    params = _jax_params()

    def build():
        return tconvert.load_jax_params(LlamaForCausalLM(LlamaConfig(**TINY3)), params).eval()

    tok = FakeTokenizer()
    gen, tmpl = tdc.llama3_backend(build(), tok, max_new_tokens=5)
    prompts = [tmpl(tdc.divide_messages(item)) for item in ITEMS[:2]]
    calls = []
    orig = gen.engine.generate
    gen.engine.generate = lambda *a, **kw: calls.append(kw) or orig(*a, **kw)
    out = gen(prompts)
    (kw,) = calls
    assert (kw["sampling"].temperature, kw["sampling"].top_p, kw["max_new_tokens"]) == (0.2, 0.9, 5)
    assert len(out) == 2 and all(isinstance(s, str) and len(s) <= 5 for s in out)
    from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator

    runs, run = [], ContinuousGenerator.run
    monkeypatch.setattr(ContinuousGenerator, "run",
                        lambda self, *a, **kw: runs.append(self) or run(self, *a, **kw))
    cgen, _ = tdc.llama3_backend(build(), tok, continuous=True, slots=2, max_new_tokens=3)
    assert len(cgen(prompts)) == 2 and [g.B for g in runs] == [2]
    # int4_smooth (raised NotImplementedError until models/quant_smooth.py
    # was ported): the JAX make_llama3_backend's tree, fuse_llm_projections(
    # smooth_quantize_for_serving(cfg, params, tokenizer)) at alpha 0.5,
    # calibrated on the fake tokenizer's id ramp by each package's forward
    jparams = jax.tree.map(jnp.asarray, jconvert.fuse_llm_projections(
        jqs.smooth_quantize_for_serving(JLlamaConfig(**TINY3, **SERVE4), params, tok)))
    sgen, _ = tdc.llama3_backend(build(), tok, int4=True, int4_smooth=True, max_new_tokens=5)
    cfg = sgen.engine.llm.cfg
    assert (cfg.quantize, cfg.quantize_bits, cfg.fuse_proj, cfg.kv_cache_dtype) == \
        (True, 4, True, "int8")
    assert sgen.engine.llm.model.layers[0].mlp.gate_up_proj.scale.dim() == 2
    _generate_both(_jax_engine(jparams, **SERVE4), sgen.engine)


@pytest.mark.parametrize("quant", [False, True])
def test_fused_qkv_split_at_llama3_widths(quant):
    """One attention layer at the Llama3-8B widths (hidden 4096, 32 heads,
    8 KV heads: q 4096, k 1024, v 1024 columns): after
    `fuse_llm_projections_` (and, quant, `quantize_llm_int8` first) the
    fused product splits into the separate products (to fp32 rounding:
    the CPU's matrix product may block a wider N differently)."""
    cfg = LlamaConfig.llama3_8b(num_layers=1)
    layer = torch.nn.ModuleDict({"attn": LlamaAttention(cfg)})
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj"):
            getattr(layer.attn, name).weight.normal_(0, 0.02, generator=gen)
    if quant:
        tconvert.quantize_llm_int8(layer)
    x = torch.randn(1, 3, cfg.hidden_size, generator=gen)
    with torch.no_grad():
        want = [t.clone() for t in layer.attn.qkv(x)]
        tconvert.fuse_llm_projections_(layer)
        assert layer.attn.cfg.fuse_proj and not hasattr(layer.attn, "q_proj")
        got = layer.attn.qkv(x)
    n_out = (layer.attn.qkv_proj.q if quant else layer.attn.qkv_proj.weight.T).shape[1]
    assert n_out == 4096 + 2 * 1024
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
