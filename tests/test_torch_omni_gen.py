"""The port's OmniLMM-12B generator, chat and labeler against the JAX
package's, on the CPU (tiny widths, fp32, tests/fake_tokenizer.py).

- prompt building (`expand_question_multimodal`,
  `wrap_question_for_omni_lmm`, `omni_yesno_ids`) equal to the JAX one;
- `OmniLMMGenerator` on weights bridged from a flax tree, against the JAX
  generator on the same tree: greedy `generate` tokens equal (first logits
  within 1e-4 of max(1, max|JAX|)), autocheck scores through the shared
  prefix and the plain path within 1e-5 of JAX's and of each other;
  beams with the JAX beam step moved to the greedy columns (equal tokens);
  diverse_gen's shared (generate_repeated), continuous
  (generate_continuous) and plain paths, seeded;
- the int8 serving configuration (both towers int8, int8 KV, fp32 head)
  and fused decode (the JAX kernel in interpret mode): greedy tokens
  equal, autocheck within 1e-5;
- `OmniLMMChat` from a tiny checkpoint directory written here (fp32,
  `int8`, `int4`, `fused_decode`): greedy tokens equal to the JAX chat's
  on the same directory, the chat's answer equal to generate_beam's with
  `SamplingParams.chat_12b()`; `int4_smooth` (the LM smoothed first) too;
- the chat CLI's "12B" branch;
- `pipeline.stage_autocheck` with the OmniLMM labeler against the JAX
  orchestrator's on the same qas rows: the same rows, scores within 1e-5.
"""
import copy
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai import beam as jbeam
from rlaifv_tpu.genai import omni_gen as jgen_mod
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import omnilmm as jomni
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu_torch import chat as tchat
from rlaifv_tpu_torch import pipeline as tpipe
from rlaifv_tpu_torch.genai import omni_gen as tgen_mod
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import omnilmm as tomni
from rlaifv_tpu_torch.models.llama import LlamaConfig
from tests.fake_tokenizer import FakeTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import run_data_pipeline as jpipe  # noqa: E402

REL = 1e-4
SCORE_TOL = 1e-5
VOCAB = 512  # covers the fake tokenizer's ids (specials at 314-316)


def _scores_close(got, want, tol=SCORE_TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["answer"] == b["answer"]
        assert set(a["scores"]) == {"yes", "Yes", "no", "No"}
        for w in a["scores"]:
            assert abs(a["scores"][w] - b["scores"][w]) < tol, (w, a["scores"], b["scores"])
        assert {k: v for k, v in a.items() if k != "scores"} == \
            {k: v for k, v in b.items() if k != "scores"}


def test_prompt_building_equals_jax():
    tok = FakeTokenizer()
    for turns in ([{"role": "user", "content": "What is this?"}],
                  [{"role": "user", "content": "Look: <image> here"}]):
        assert tgen_mod.expand_question_multimodal(turns, 3) == \
            jgen_mod.expand_question_multimodal(turns, 3)
    for q in ("Q?", [{"role": "user", "content": "<image>\nIs it red?"}]):
        got = tgen_mod.wrap_question_for_omni_lmm(q, 4, tok)
        want = jgen_mod.wrap_question_for_omni_lmm(q, 4, tok)
        for k in ("input_ids", "labels"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert tgen_mod.omni_yesno_ids(tok) == jgen_mod.omni_yesno_ids(tok)


# ------------------------------------------------------------ generators


def _jcfg(**llm):
    base = jomni.OmniLMMConfig.tiny()
    return jomni.OmniLMMConfig(
        llm=JLlamaConfig.tiny(num_kv_heads=2, vocab_size=VOCAB, **llm),
        vision=base.vision, num_query=base.num_query)


def _tcfg(**llm):
    return tomni.OmniLMMConfig(llm=LlamaConfig.tiny(num_kv_heads=2, vocab_size=VOCAB, **llm),
                               vision=tomni.OmniLMMConfig.tiny().vision, num_query=4)


@pytest.fixture(scope="module")
def params():
    cfg = _jcfg()
    S = cfg.vision.image_size
    p = jomni.OmniLMMForCausalLM(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, cfg.num_query + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([1]))["params"]
    # scale up so the tiny random model's logits are not flat
    return jax.tree.map(lambda a: np.asarray(a) * 3.0, p)


def _gens(params, mode="float", fused=False):
    """The JAX and port generators on one tree; mode "int8": both towers
    int8, int8 KV, the head float (OmniLMMChat(int8=True)'s model)."""
    tok = FakeTokenizer()
    llm = {}
    jparams = params
    if mode == "int8":
        llm = dict(quantize=True, quantize_lm_head=False, kv_cache_dtype="int8",
                   fuse_proj=fused)
        qllm = jconvert.quantize_llm_int8(params["llm"], include_lm_head=False)
        if fused:
            qllm = jconvert.fuse_llm_projections(qllm)
        jparams = {**params, "llm": qllm,
                   "vision_tower": jconvert.quantize_vision_int8(params["vision_tower"])}
    jcfg, tcfg = _jcfg(**llm), _tcfg(**llm)
    if mode == "int8":
        jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, quantize=True))
        tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, quantize=True))
    S = jcfg.vision.image_size
    jgen = jgen_mod.OmniLMMGenerator(jomni.OmniLMMForCausalLM(jcfg),
                                     jax.tree.map(jnp.asarray, copy.deepcopy(jparams)), tok,
                                     image_size=S, checkpoint_name="tiny", fused_decode=fused)
    tmodel = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tcfg), jparams).eval()
    tgen = tgen_mod.OmniLMMGenerator(tmodel, tok, image_size=S, checkpoint_name="tiny",
                                     fused_decode=fused)
    return jgen, tgen


@pytest.fixture(scope="module")
def gens(params):
    return _gens(params)


@pytest.fixture(scope="module")
def int8_gens(params):
    return _gens(params, "int8")


def _items(n, same_image=False, seed=0, size=28):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    return [{"question": f"Is there object {i} here? Please answer yes or no.",
             "question_id": i,
             "image": image if same_image else rng.integers(0, 255, size=(size, size, 3),
                                                              dtype=np.uint8),
             "metainfos": {"ds_question_id": f"ds{i}"}} for i in range(n)]


def _greedy(gen, items, new=5):
    prompts, starts, images = gen._prepare(items)
    return gen.engine.generate(prompts, images=images, image_starts=starts,
                               sampling=SamplingParams.greedy(), max_new_tokens=new)


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_greedy_generate_matches_jax(gens, int8_gens, mode):
    jgen, tgen = gens if mode == "float" else int8_gens
    items = _items(3)
    want, got = _greedy(jgen, items), _greedy(tgen, items)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    ref = np.asarray(want.first_logits)
    np.testing.assert_allclose(got.first_logits, ref, rtol=0,
                               atol=REL * max(1.0, float(np.abs(ref).max())))
    rows = tgen.generate(items, sampling=SamplingParams.greedy(), max_new_tokens=5, batch_size=2)
    jrows = jgen.generate(items, sampling=SamplingParams.greedy(), max_new_tokens=5,
                          batch_size=2)
    assert [r[1] for r in rows] == [r[1] for r in jrows]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_autocheck_matches_jax(gens, int8_gens, mode, shared):
    """Facts about one image (one shared group, one with a longer question)
    plus two other images; the shared path equals the plain one too."""
    jgen, tgen = gens if mode == "float" else int8_gens
    items = _items(4, same_image=True) + _items(2, seed=1)
    items[1]["question"] = "Is there a very small red thing near the top? Please answer."
    got = tgen.autocheck(items, batch_size=2, shared_prefix=shared)
    _scores_close(got, jgen.autocheck(items, batch_size=2, shared_prefix=shared))
    if shared:
        _scores_close(got, tgen.autocheck(items, batch_size=2, shared_prefix=False))


def test_autocheck_shares_one_prefix_an_image(gens, monkeypatch):
    _, tgen = gens
    calls = []
    orig = tgen.engine.score_shared_prefix
    monkeypatch.setattr(tgen.engine, "score_shared_prefix",
                        lambda prefix, suffixes, **kw: calls.append((prefix, kw)) or
                        orig(prefix, suffixes, **kw))
    items = _items(3, same_image=True)
    tgen.autocheck(items)
    (prefix, kw), = calls
    # the prefix ends right after <im_end>: start + num_query + 1 tokens
    assert len(prefix) == kw["image_start"] + tgen.num_query + 1
    assert prefix[-1] == FakeTokenizer.SPECIALS["<im_end>"]


def test_generate_beam_matches_jax(gens, greedy_columns):
    jgen, tgen = gens
    items = _items(2)
    got = tgen.generate_beam(items, num_beams=3, max_new_tokens=5)
    assert [r[1] for r in got] == [r[1] for r in jgen.generate_beam(items, num_beams=3,
                                                                     max_new_tokens=5)]
    sampled = [tgen.generate_beam(items, num_beams=3, sampling=SamplingParams.chat_12b(),
                                  max_new_tokens=5, seed=3) for _ in range(2)]
    assert sampled[0] == sampled[1] and all(isinstance(r[1], str) for r in sampled[0])


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


def test_fused_decode_matches_jax(params, monkeypatch):
    """The int8 fused engines (the JAX kernel in interpret mode): greedy
    tokens equal, autocheck (plain path on both) within 1e-5; the port's
    fused generator takes generate for diverse_gen and autocheck."""
    jgen, tgen = _gens(params, "int8", fused=True)
    items = _items(2)
    want, got = _greedy(jgen, items, 4), _greedy(tgen, items, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _scores_close(tgen.autocheck(items, batch_size=2),
                  jgen.autocheck(items, batch_size=2, shared_prefix=False))
    rows = tgen.diverse_gen([items[0]] * 2, max_new_tokens=3)
    assert len(rows) == 2
    with pytest.raises(ValueError, match="per-layer"):
        tgen.generate_beam(items, max_new_tokens=2)


# ------------------------------------------------------------ checkpoints


def _write_omni_ckpt(path: str) -> str:
    """A tiny OmniLMM checkpoint in the reference layout (safetensors +
    config.json with eva_config and num_query), numpy from a seed."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(11)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa: E731
    H, D, NQ, I, ED, P, depth = 32, 32, 4, 64, 64, 7, 3
    sd = {"model.embed_tokens.weight": r(VOCAB, H), "model.norm.weight": 1 + r(H),
          "lm_head.weight": r(VOCAB, H)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": r(H, H),
                   p + "self_attn.k_proj.weight": r(H // 2, H),
                   p + "self_attn.v_proj.weight": r(H // 2, H),
                   p + "self_attn.o_proj.weight": r(H, H), p + "mlp.gate_proj.weight": r(I, H),
                   p + "mlp.up_proj.weight": r(I, H), p + "mlp.down_proj.weight": r(H, I),
                   p + "input_layernorm.weight": 1 + r(H),
                   p + "post_attention_layernorm.weight": 1 + r(H)})
    v = "model.vision_tower."
    sd.update({v + "patch_embed.proj.weight": r(D, 3, P, P), v + "patch_embed.proj.bias": r(D),
               v + "cls_token": r(1, 1, D), v + "pos_embed": r(1, 17, D),
               v + "norm.weight": 1 + r(D), v + "norm.bias": r(D)})
    for i in range(depth):
        p = f"{v}blocks.{i}."
        sd.update({p + "norm1.weight": 1 + r(D), p + "norm1.bias": r(D),
                   p + "norm2.weight": 1 + r(D), p + "norm2.bias": r(D),
                   p + "attn.qkv.weight": r(3 * D, D), p + "attn.q_bias": r(D),
                   p + "attn.v_bias": r(D), p + "attn.proj.weight": r(D, D),
                   p + "attn.proj.bias": r(D), p + "mlp.fc1.weight": r(ED, D),
                   p + "mlp.fc1.bias": r(ED), p + "mlp.fc2.weight": r(D, ED),
                   p + "mlp.fc2.bias": r(D)})
    m = "model.resampler."
    sd.update({m + "query": r(NQ, H), m + "pos_embed": r(NQ, H),
               m + "attn.in_proj_weight": r(3 * H, H), m + "attn.in_proj_bias": r(3 * H),
               m + "attn.out_proj.weight": r(H, H), m + "attn.out_proj.bias": r(H),
               m + "ln_q.weight": 1 + r(H), m + "ln_q.bias": r(H),
               m + "ln_kv.weight": 1 + r(H), m + "ln_kv.bias": r(H),
               m + "ln_post.weight": 1 + r(H), m + "ln_post.bias": r(H), m + "proj": r(H, H)})
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": VOCAB, "hidden_size": H, "intermediate_size": I,
                   "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
                   "max_position_embeddings": 512, "num_query": NQ,
                   "eva_config": {"image_size": 28, "patch_size": P, "embed_dim": D,
                                  "depth": depth, "num_heads": 4, "mlp_hidden": ED}}, f)
    return path


@pytest.fixture(scope="module")
def omni_ckpt(tmp_path_factory):
    return _write_omni_ckpt(str(tmp_path_factory.mktemp("omni") / "RLAIF-V-12B"))


CHAT_MODES = {"fp32": {}, "int8": dict(int8=True), "int4": dict(int4=True),
              "fused_decode": dict(fused_decode=True)}


@pytest.mark.parametrize("mode", list(CHAT_MODES))
def test_omnilmm_chat_matches_jax(omni_ckpt, mode):
    _omnilmm_chat_matches_jax(omni_ckpt, mode, CHAT_MODES[mode])


def _omnilmm_chat_matches_jax(omni_ckpt, mode, kw):
    tok = FakeTokenizer()
    chat = tgen_mod.OmniLMMChat(omni_ckpt, tokenizer=tok, max_new_tokens=5, image_size=28,
                                device="cpu", **kw)
    jchat = jgen_mod.OmniLMMChat(omni_ckpt, tokenizer=tok, max_new_tokens=5, image_size=28,
                                 **kw)
    llm = chat.gen.engine.llm.cfg
    assert chat.gen.model.cfg.llm.dtype == torch.float32
    if mode != "fp32":
        bits = 4 if mode == "int4" else 8
        assert llm.quantize and llm.quantize_bits == bits and not llm.quantize_lm_head
        assert llm.kv_cache_dtype == "int8" and chat.gen.model.cfg.vision.quantize_bits == bits
        qkv = chat.gen.model.vision_tower.blocks[0].attn.qkv
        assert qkv.q.dtype == torch.int8 and qkv.bias is not None
    assert llm.fuse_proj == (mode == "fused_decode")
    items = _items(2, seed=5)
    want, got = _greedy(jchat.gen, items, 4), _greedy(chat.gen, items, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    ref = np.asarray(want.first_logits)
    np.testing.assert_allclose(got.first_logits, ref, rtol=0,
                               atol=REL * max(1.0, float(np.abs(ref).max())))
    question = {"question": "What do you see?", "image": items[0]["image"]}
    if mode == "fused_decode":  # beams need the per-layer weights
        with pytest.raises(ValueError, match="per-layer"):
            chat.chat(question)
        return
    answer = chat.chat(question)
    beam = chat.gen.generate_beam([dict(question, question_id=0)], num_beams=3,
                                  sampling=SamplingParams.chat_12b(), max_new_tokens=5)
    assert answer == beam[0][1]


def test_omnilmm_chat_int4_smooth_raises(omni_ckpt):
    """int4_smooth=True raised NotImplementedError until
    models/quant_smooth.py was ported: it now runs the int4 path with the
    LM smoothed first (alpha 0.5, calibrated on the fake tokenizer's id
    ramp by each package's own forward), against the JAX chat as the int4
    mode is."""
    _omnilmm_chat_matches_jax(omni_ckpt, "int4", dict(int4=True, int4_smooth=True))


def test_chat_cli_12b_branch(omni_ckpt, monkeypatch, capsys):
    """A path holding "12B" loads OmniLMMChat (--load-8bit: both towers
    int8); `main` prints the chat's answer."""
    import transformers

    chat = tchat.RLAIFVChat(omni_ckpt, load_8bit=True, device="cpu", max_new_tokens=4,
                            tokenizer=FakeTokenizer())
    assert isinstance(chat.model, tgen_mod.OmniLMMChat)
    assert chat.model.gen.model.cfg.vision.quantize
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **kw: FakeTokenizer())
    image = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "examples", "test.jpeg")
    tchat.main(["--model-path", omni_ckpt, "--image", image, "--question", "Why?",
                "--max-new-tokens", "4", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    plain = tchat.RLAIFVChat(omni_ckpt, device="cpu", max_new_tokens=4,
                             tokenizer=FakeTokenizer())
    assert printed == plain.chat({"image": image, "question": "Why?"})


# ------------------------------------------------------------ the labeler


def test_stage_autocheck_with_omnilmm_matches_jax(gens, tmp_path):
    """The reference's labeler configuration: stage 3 of the pipeline
    scores the divide stage's yes/no questions with OmniLMM; the JAX
    orchestrator with the JAX generator writes the same rows."""
    from PIL import Image

    from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines

    jgen, tgen = gens
    rng = np.random.default_rng(9)
    rows = []
    for i in range(2):
        path = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8)).save(path)
        for j in range(3):
            rows.append({"question": f"Is there a thing {j}? Please answer yes or no.",
                         "question_id": i * 10 + j, "ds_question_id": f"ds{i}",
                         "image_path": path, "origin_question": "Describe the image.",
                         "facts": [f"fact {j}"]})
    qas = str(tmp_path / "answers.gq.qas.jsonl")
    write_jsonlines(qas, rows)
    got_dir, want_dir = tmp_path / "torch", tmp_path / "jax"
    got_dir.mkdir()
    want_dir.mkdir()
    got = tpipe.stage_autocheck(tgen, qas, str(got_dir), batch_size=2)
    want = jpipe.stage_autocheck(jgen, qas, str(want_dir), batch_size=2)
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.basename(got).startswith("autocheck_omni_")
    _scores_close(read_jsonlines(got), read_jsonlines(want))
