"""The port's serving slice against the JAX package's, on the CPU.

The JAX side is the `tiny_gen` setup of tests/test_genai_pipeline.py
(LlavaConfig.tiny(), fp32, FakeTokenizer); its params are bridged into the
torch model, so both generators score and decode with the same weights.
Tolerances: 1e-5 on autocheck probabilities, 1e-4 on logits (fp32, sums in
another order). Sampled tokens are not compared - JAX and torch draw
different random bits from one seed - the filtered distribution is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.data.datasets import GenDataset
from rlaifv_tpu.genai import sampling as jsampling
from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.utils.file_io import read_jsonlines, write_jsonlines
from rlaifv_tpu_torch.genai import sampling as tsampling
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator, run
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from tests.fake_tokenizer import FakeTokenizer


@pytest.fixture(scope="module")
def gens():
    cfg = JLlavaConfig.tiny()
    jmodel = JLlava(cfg)
    P = cfg.num_image_tokens
    S = cfg.vision.image_size
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]),
    )["params"]
    tok = FakeTokenizer()
    jgen = JGenerator(jmodel, params, tok, P, image_size=S,
                      checkpoint_name="tiny-test")
    tmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    tgen = Llava15Generator(tmodel, tok, P, image_size=S,
                            checkpoint_name="tiny-test")
    return cfg, jgen, tgen


def _items(cfg, n, same_image=False):
    rng = np.random.default_rng(0)
    S = cfg.vision.image_size
    items = []
    for i in range(n):
        items.append({
            "question": f"Is object {i} present?",
            "question_id": i,
            "image": rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8),
            "metainfos": {"ds_question_id": f"ds{i}"},
        })
    if same_image:
        for it in items:
            it["image"] = items[0]["image"]
        items[2]["question"] = "Is there a very small red object near the top?"
    return items


@pytest.mark.parametrize("shared_prefix", [True, False])
def test_autocheck_matches_jax(gens, shared_prefix):
    cfg, jgen, tgen = gens
    items = _items(cfg, 4, same_image=True)
    want = jgen.autocheck(items, batch_size=2, shared_prefix=shared_prefix)
    got = tgen.autocheck(items, batch_size=2, shared_prefix=shared_prefix)
    for a, b in zip(want, got):
        assert a["answer"] == b["answer"]
        assert a["question_id"] == b["question_id"]
        for w in a["scores"]:
            assert abs(a["scores"][w] - b["scores"][w]) < 1e-5, (w, a, b)


def test_generate_greedy_matches_jax(gens):
    cfg, jgen, tgen = gens
    prompts, starts, images = tgen._prepare(_items(cfg, 2))
    prompts[1] = prompts[1][:-3]  # ragged lengths -> left padding
    kw = dict(images=images, image_starts=starts, max_new_tokens=6)
    want = jgen.engine.generate(prompts, **kw)
    got = tgen.engine.generate(prompts, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, atol=1e-4)


def test_generate_repeated_equals_generate(gens):
    """One prefill + copied cache + B=n decode reproduces generate() on n
    copies of the prompt (greedy: identical tokens)."""
    cfg, _, tgen = gens
    prompts, starts, images = tgen._prepare(_items(cfg, 1))
    n = 3
    plain = tgen.engine.generate(prompts * n, images=np.stack([images[0]] * n),
                                 image_starts=np.asarray([starts[0]] * n),
                                 max_new_tokens=6)
    rep = tgen.engine.generate_repeated(prompts[0], n=n, image=images[0],
                                        image_start=int(starts[0]),
                                        max_new_tokens=6)
    np.testing.assert_array_equal(plain.tokens, rep.tokens)
    np.testing.assert_array_equal(plain.lengths, rep.lengths)
    np.testing.assert_allclose(plain.first_logits, rep.first_logits, atol=1e-5)


def test_diverse_gen_rows_reproducible(gens):
    """Repeat-expanded items take generate_repeated, the singleton tail the
    batch path; rows keep order and schema, and a seed fixes the text."""
    cfg, _, tgen = gens
    base = _items(cfg, 2)
    items = [dict(base[0], question_id=f"0.{k}") for k in range(3)]
    items += [dict(base[1], question_id="1.0")]
    rows = tgen.diverse_gen(items, max_new_tokens=5, batch_size=2, seed=7)
    again = tgen.diverse_gen(items, max_new_tokens=5, batch_size=2, seed=7)
    assert [r["question_id"] for r in rows] == ["0.0", "0.1", "0.2", "1.0"]
    for r in rows:
        assert set(r) >= {"question_id", "ds_question_id", "raw_question",
                          "answer", "metainfos", "model_path"}
        assert isinstance(r["answer"], str) and r["model_path"] == "tiny-test"
    assert [r["answer"] for r in rows] == [r["answer"] for r in again]


@pytest.mark.parametrize("sp", [
    tsampling.SamplingParams.diverse_gen(),
    tsampling.SamplingParams.chat_12b(),
    tsampling.SamplingParams(temperature=0.9, top_k=5, top_p=0.5),
])
def test_sampling_transforms_match_jax(sp):
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=3.0, size=(4, 64)).astype(np.float32)
    seen = (rng.random((4, 64)) < 0.2).astype(np.int32)
    jsp = jsampling.SamplingParams(sp.temperature, sp.top_k, sp.top_p,
                                   sp.repetition_penalty, sp.do_sample)
    want = jsampling.filtered_logits(
        jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen),
                                           sp.repetition_penalty), jsp)
    got = tsampling.filtered_logits(
        tsampling.apply_repetition_penalty(torch.from_numpy(logits),
                                           torch.from_numpy(seen),
                                           sp.repetition_penalty), sp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    tok = tsampling.sample_token(g, torch.from_numpy(logits), sp)
    kept = got.numpy()[np.arange(4), tok.numpy()]
    assert (kept > tsampling.NEG_INF).all()  # draws only from kept tokens


@pytest.mark.parametrize("is_yesno", [True, False])
def test_run_writes_rank_shards(gens, tmp_path, is_yesno):
    """run() shards a repeat-expanded GenDataset over two ranks; the two
    files together hold every item once, in order."""
    cfg, _, tgen = gens
    S = cfg.vision.image_size
    qa = tmp_path / "qa.jsonl"
    write_jsonlines(str(qa), [{"question": f"Is object {i} present?"}
                              for i in range(2)])

    class _DS(GenDataset):
        def __getitem__(self, i):
            item = super().__getitem__(i)
            rng = np.random.default_rng(i // self.repeat_time)
            item["image"] = rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8)
            return item

    ds = _DS(str(qa), repeat_time=3)
    ans = str(tmp_path / "answers.jsonl")
    for rank in (0, 1):
        run(tgen, ds, ans, is_yesno=is_yesno, batch_size=4, max_tokens=3,
            rank=rank, world_size=2)
    rows = read_jsonlines(ans + ".rank0") + read_jsonlines(ans + ".rank1")
    assert [r["question_id"] for r in rows] == list(range(len(ds)))
    assert all(("scores" in r) == is_yesno for r in rows)


def test_unported_modes_raise(gens):
    cfg, _, tgen = gens
    items = _items(cfg, 1)
    with pytest.raises(NotImplementedError, match="#6"):
        tgen.greedy_gen(items, num_beams=3)
    with pytest.raises(NotImplementedError, match="#6"):
        tgen.diverse_gen(items, continuous=True)
    with pytest.raises(NotImplementedError, match="#6"):
        Llava15Generator(tgen.model, tgen.tokenizer, tgen.num_patches,
                         fused_decode=True)
