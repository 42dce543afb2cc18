"""The port's chat CLI (`python -m rlaifv_tpu_torch.chat`) and the
continuous branches of the generator and the divide-and-conquer backend, on
the CPU.

- The chat on a tiny LLaVA checkpoint written here (HF layout, vocabulary
  512 for tests/fake_tokenizer.py): its answer equals the decoded
  `generate_beam` (3 beams) of the same model, prompt and image, with a
  float or int8 cache and int8 weights; `main` prints it; each unported
  option raises NotImplementedError citing its ROADMAP number (the "12B"
  case: the chat branch and OmniLMM training are ported);
  without a card the entry point exits unless told `--device cpu`.
- `Llava15Generator.diverse_gen(continuous=True)` and
  `greedy_gen(continuous=True)` against the JAX generator's on bridged
  weights: greedy answers equal; sampled rows have the JAX rows' schema
  and order, and a seed fixes them.
- `llama3_backend(continuous=True)` in bf16, int8 and fused: generate_fn
  goes through `generate_continuous` with its `slots`, and its greedy
  tokens equal `generate`'s.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch import chat as tchat
from rlaifv_tpu_torch.genai import divide_conquer as tdc
from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from tests.fake_tokenizer import FakeTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(ROOT, "examples", "test.jpeg")
QUESTION = "What is in the image?"


def _write_ckpt(path, **config):
    """A tiny LLaVA checkpoint in the HF layout (safetensors + config.json)."""
    from safetensors.torch import save_file
    from transformers import CLIPVisionConfig as HFVisionConfig
    from transformers import CLIPVisionModel as HFVision
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM as HFLlama

    torch.manual_seed(0)
    llm = dict(vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=512)
    vision = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                  num_attention_heads=2, image_size=14, patch_size=7)
    sd = dict(HFLlama(HFLlamaConfig(**llm)).state_dict())
    for k, v in HFVision(HFVisionConfig(**vision)).state_dict().items():
        sd[f"model.vision_tower.vision_tower.{k}"] = v
    sd["model.mm_projector.0.weight"] = torch.randn(32, 16) * 0.1
    sd["model.mm_projector.0.bias"] = torch.zeros(32)
    sd["model.mm_projector.2.weight"] = torch.randn(32, 32) * 0.1
    sd["model.mm_projector.2.bias"] = torch.zeros(32)
    os.makedirs(path, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(path, "model.safetensors"))
    cfg = {k: v for k, v in llm.items() if k != "num_hidden_layers"}
    cfg.update(num_hidden_layers=2, rope_theta=1e4, rms_norm_eps=1e-6,
               mm_projector_type="mlp2x_gelu", mm_vision_select_layer=-1,
               vision_config=vision, **config)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_ckpt(str(tmp_path_factory.mktemp("chat") / "llava-tiny"))


def _beam_answer(path, max_new, **llm):
    """generate_beam (3 beams) on the checkpoint loaded as evals.vqa loads
    it, with the llava_v1 prompt the generator builds: the chat's answer."""
    from rlaifv_tpu_torch.evals.vqa import load_generator
    from rlaifv_tpu_torch.models.convert import (
        llava_config_from_hf,
        load_pretrained_llava,
    )

    if llm:
        dt = dict(dtype=torch.float32, param_dtype=torch.float32)
        cfg = llava_config_from_hf(path, llm=dict(dt, **llm), vision=dt)
        model = load_jax_params(LlavaForCausalLM(cfg), load_pretrained_llava(
            path, vision_layers_to_run=cfg.vision.layers_to_run,
            quantize_llm=bool(llm.get("quantize")))).eval()
        gen = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                               image_size=cfg.vision.image_size)
    else:
        gen = load_generator(path, "cpu", tokenizer=FakeTokenizer())
    prompts, starts, images = gen._prepare([{"question": QUESTION, "image": IMAGE}])
    res = gen.engine.generate_beam(prompts, images=images, image_starts=starts, num_beams=3,
                                   max_new_tokens=max_new)
    return gen.tokenizer.decode(res.tokens[0][:res.lengths[0]],
                                skip_special_tokens=True).strip()


@pytest.mark.parametrize("opts", [{}, {"kv_int8": True}, {"load_8bit": True}])
def test_chat_answer_equals_generate_beam(ckpt, opts):
    chat = tchat.RLAIFVChat(ckpt, device="cpu", max_new_tokens=6, tokenizer=FakeTokenizer(),
                            **opts)
    llm = {"kv_cache_dtype": "int8"} if opts.get("kv_int8") else {}
    if opts.get("load_8bit"):
        llm["quantize"] = True
        assert chat.model.model.llm.model.layers[0].attn.q_proj.q.dtype == torch.int8
    answer = chat.chat({"image": IMAGE, "question": QUESTION})
    assert isinstance(answer, str)
    assert answer == _beam_answer(ckpt, 6, **llm)


def test_chat_main_prints_the_answer(ckpt, monkeypatch, capsys):
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **kw: FakeTokenizer())
    tchat.main(["--model-path", ckpt, "--image", IMAGE, "--question", QUESTION,
                "--max-new-tokens", "6", "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == _beam_answer(ckpt, 6)


@pytest.mark.parametrize("case,item", [
    ("load_4bit", "#11"), ("lookup_decode", "#11"), ("12B", "#9"), ("minicpm", "#10"),
    ("anyres", "#8")])
def test_chat_unported_options_raise(ckpt, tmp_path, case, item):
    path, kw = ckpt, {}
    if case == "12B":
        # the chat's 12B branch is ported (tests/test_torch_omni_gen.py),
        # and so is OmniLMM-12B training, the rest of #9
        # (tests/test_torch_omni_train.py): the family resolves
        from rlaifv_tpu_torch.train.family import get_family

        assert get_family("omnilmm").name == "omnilmm"
        return
    if case in ("load_4bit", "lookup_decode"):
        kw[case] = True
    elif case == "anyres":
        path = _write_ckpt(str(tmp_path / "llava-anyres"), image_aspect_ratio="anyres")
    else:
        path = str(tmp_path / f"RLAIF-V-{case}")
    with pytest.raises(NotImplementedError, match=item):
        tchat.RLAIFVChat(path, device="cpu", tokenizer=FakeTokenizer(), **kw)


def test_chat_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry point would run")
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        tchat.main(["--model-path", "m"])


# ------------------------------------------------ the continuous branches


@pytest.fixture(scope="module")
def gens():
    cfg = JLlavaConfig.tiny()
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    params = JLlava(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
                              images=jnp.zeros((1, S, S, 3)),
                              image_starts=jnp.asarray([0]))["params"]
    tok = FakeTokenizer()
    jgen = JGenerator(JLlava(cfg), params, tok, P, image_size=S, checkpoint_name="t")
    tgen = Llava15Generator(load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval(),
                            tok, P, image_size=S, checkpoint_name="t")
    return cfg, jgen, tgen


def _items(cfg, questions, repeats=1):
    rng = np.random.default_rng(0)
    S = cfg.vision.image_size
    items = []
    for q, question in enumerate(questions):
        image = rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8)
        for r in range(repeats):
            items.append({"question": question, "question_id": f"{q}.{r}", "image": image,
                          "metainfos": {"ds_question_id": f"ds{q}"}})
    return items


def spy_runs(monkeypatch) -> list:
    """The ContinuousGenerator of every run from here on, in order."""
    made, run = [], ContinuousGenerator.run
    monkeypatch.setattr(ContinuousGenerator, "run",
                        lambda self, *a, **kw: made.append(self) or run(self, *a, **kw))
    return made


def test_greedy_gen_continuous_matches_jax(gens, monkeypatch):
    cfg, jgen, tgen = gens
    runs = spy_runs(monkeypatch)
    items = _items(cfg, ["Is object 0 present?", "What is there?", "Hi?",
                         "Describe the picture in a few words."])
    want = jgen.greedy_gen(items, max_new_tokens=6, batch_size=2, continuous=True)
    got = tgen.greedy_gen(items, max_new_tokens=6, batch_size=2, continuous=True)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["question_id"] for r in got] == [r["question_id"] for r in want]
    # and the batch path's answers
    batch = tgen.greedy_gen(items, max_new_tokens=6, batch_size=2)
    assert [r["answer"] for r in got] == [r["answer"] for r in batch]
    assert runs[0].stats["refill_waves"] >= 2


def test_diverse_gen_continuous_rows(gens, monkeypatch):
    """diverse_gen(continuous=True): the repeat groups refill through one
    window prefill a group (share_keys), the rows keep the JAX rows' order
    and fields, and a seed fixes the text."""
    cfg, jgen, tgen = gens
    items = _items(cfg, ["Is object 0 present?", "What is there?"], repeats=3)
    want = jgen.diverse_gen(items, max_new_tokens=5, batch_size=4, continuous=True)
    runs = spy_runs(monkeypatch)
    rows = tgen.diverse_gen(items, max_new_tokens=5, batch_size=4, seed=7, continuous=True)
    stats = runs[0].stats
    again = tgen.diverse_gen(items, max_new_tokens=5, batch_size=4, seed=7, continuous=True)
    assert [r["question_id"] for r in rows] == [r["question_id"] for r in want]
    assert [sorted(r) for r in rows] == [sorted(r) for r in want]
    assert [r["answer"] for r in rows] == [r["answer"] for r in again]
    assert stats["window_prefills"] == 2 and stats["prefills"] == 0, stats


TINY3 = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=8, num_kv_heads=2, max_position_embeddings=256,
             rope_theta=500000.0, rms_norm_eps=1e-5)


@pytest.mark.parametrize("quant", ["bf16", "int8", "fused"])
def test_llama3_backend_continuous(quant):
    """generate_fn runs through generate_continuous with the backend's
    slots; at T 0 its tokens equal the same engine's generate."""
    def build():
        model = LlamaForCausalLM(LlamaConfig(**TINY3))
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, 0.05, generator=g)
        return model.eval()

    tok = FakeTokenizer()
    gen, tmpl = tdc.llama3_backend(build(), tok, temperature=0.0, max_new_tokens=6,
                                   continuous=True, slots=2, int8=quant == "int8",
                                   fused_decode=quant == "fused")
    prompts = [tmpl(tdc.divide_messages(item)) for item in (
        {"question": "What is shown?", "answer": "A black cat on a mat."},
        {"question": "Describe it.", "answer": "Two dogs."},
        {"question": "P?", "answer": "Yes, it is."})]
    calls = []
    orig = gen.engine.generate_continuous
    gen.engine.generate_continuous = lambda *a, **kw: calls.append(kw) or orig(*a, **kw)
    out = gen(prompts)
    (kw,) = calls
    assert kw["slots"] == 2 and kw["max_new_tokens"] == 6
    assert len(out) == 3 and all(isinstance(s, str) for s in out)
    ids = [tok(p).input_ids for p in prompts]
    sp = SamplingParams(temperature=0.0, do_sample=False)
    want = gen.engine.generate(ids, sampling=sp, max_new_tokens=6)
    got = gen.engine.generate_continuous(ids, sampling=sp, max_new_tokens=6, slots=2)
    for i in range(3):
        n = int(want.lengths[i])
        assert int(got.lengths[i]) == n
        np.testing.assert_array_equal(got.tokens[i, :n], want.tokens[i, :n])
