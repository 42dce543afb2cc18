"""The port's prompt-lookup decoding (genai/lookup_decode.py) against the
JAX package's, on the CPU at fp32.

- Greedy `lookup_generate` on a tiny Llama (text) and a tiny LLaVA (an image
  spliced into the prompt): the tokens and the number of window forwards
  (`n_steps`) equal the JAX `lookup_generate`'s on the same weights, and the
  tokens equal the port's own `DecodeEngine.generate` greedy (unpadded
  prompt bucket); with draft lengths 4 and 8, n-grams 2 and 3, a
  repetitive prompt (more than one token a step), an EOS reached mid-way
  (cut after it) and a prompt shorter than the n-gram.
- One host read a window: `Tensor.cpu` counted over a run.
- `_spec_accept_resample` against the target distribution by Monte Carlo
  (tests/test_lookup_decode.py:145's bound: total variation < 0.02 over
  20000 draws), with a point draft and with no draft (a == 0 always).
- The sampled path is fixed by its seed; repetition_penalty, a fused
  engine and an int8 cache raise ValueError, as the JAX module and the
  root chat.py do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.data.multimodal import expand_image_sentinels
from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.lookup_decode import lookup_generate as jlookup
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.genai.lookup_decode import _spec_accept_resample, lookup_generate
from rlaifv_tpu_torch.genai.sampling import SamplingParams
from rlaifv_tpu_torch.models.convert import load_jax_params, set_llm_config
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

TV_BOUND = 0.02
DRAWS = 20000


def _pair(seed, eos_id=-1):
    cfg = JLlamaConfig.tiny()
    params = JLlama(cfg).init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))["params"]
    model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny()), params).eval()
    return (JEngine(JLlama(cfg), params, eos_id=eos_id, pad_id=0),
            DecodeEngine(model, eos_id=eos_id, pad_id=0))


@pytest.fixture(scope="module")
def engines():
    return {seed: _pair(seed) for seed in (0, 3)}


def _greedy(eng, prompt, new, **media):
    res = eng.generate([prompt], max_new_tokens=new, prompt_bucket=len(prompt), **media)
    return [int(t) for t in res.tokens[0][:res.lengths[0]]]


def _prompt(seed, n, repeat=None):
    rng = np.random.default_rng(seed)
    base = list(map(int, rng.integers(5, 250, size=repeat or n)))
    return (base * (n // len(base) + 1))[:n]


@pytest.mark.parametrize("case", ["ngram2_k4", "ngram3_k8", "repetitive", "short_prompt"])
def test_greedy_lookup_matches_jax_and_generate(engines, case):
    seed, prompt, new, k, n = {
        "ngram2_k4": (0, _prompt(5, 13), 24, 4, 2),
        "ngram3_k8": (0, _prompt(5, 13), 24, 8, 3),
        "repetitive": (3, _prompt(9, 28, repeat=6), 32, 8, 2),
        "short_prompt": (0, [7, 9], 6, 4, 3),  # shorter than the n-gram
    }[case]
    jeng, teng = engines[seed]
    want = jlookup(jeng, prompt, max_new_tokens=new, draft_len=k, ngram=n)
    got = lookup_generate(teng, prompt, max_new_tokens=new, draft_len=k, ngram=n)
    assert got.tokens == want.tokens
    assert got.n_steps == want.n_steps and got.n_emitted == want.n_emitted
    assert got.tokens_per_step == want.tokens_per_step
    assert got.tokens == _greedy(teng, prompt, new)
    if case == "repetitive":  # the draft is accepted: fewer windows than tokens
        assert got.n_steps < len(got.tokens) and got.tokens_per_step > 1.0


def test_lookup_eos_truncation_matches_jax(engines):
    """EOS mid-way: lookup emits generate's tokens through the EOS, as the
    JAX function does."""
    jeng, teng = engines[0]
    prompt = _prompt(2, 10)
    eos = _greedy(teng, prompt, 8)[2]
    jeng2 = JEngine(jeng.model, jeng.params, eos_id=eos, pad_id=0)
    teng2 = DecodeEngine(teng.model, eos_id=eos, pad_id=0)
    want = jlookup(jeng2, prompt, max_new_tokens=16, draft_len=4, ngram=2)
    got = lookup_generate(teng2, prompt, max_new_tokens=16, draft_len=4, ngram=2)
    assert got.tokens == want.tokens and got.n_steps == want.n_steps
    assert got.tokens[-1] == eos and got.tokens == _greedy(teng2, prompt, 16)


def test_lookup_with_an_image_matches_jax():
    cfg = JLlavaConfig.tiny()
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    params = JLlava(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
                              images=jnp.zeros((1, S, S, 3)),
                              image_starts=jnp.asarray([0]))["params"]
    jeng = JEngine(JLlava(cfg), params, eos_id=-1, pad_id=0)
    teng = DecodeEngine(load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval(),
                        eos_id=-1, pad_id=0)
    ex = expand_image_sentinels([1, 5, -200, 6, 7, 5, 6], None, P)
    prompt, starts = ex["input_ids"].tolist(), [int(ex["image_start"])]
    img = np.random.default_rng(0).normal(size=(1, S, S, 3)).astype(np.float32)
    want = jlookup(jeng, prompt, images=img, image_starts=starts, max_new_tokens=12,
                   draft_len=4, ngram=2)
    got = lookup_generate(teng, prompt, images=img, image_starts=starts, max_new_tokens=12,
                          draft_len=4, ngram=2)
    assert got.tokens == want.tokens and got.n_steps == want.n_steps
    assert got.tokens == _greedy(teng, prompt, 12, images=img, image_starts=starts)


def test_one_host_read_a_window(engines, monkeypatch):
    _, teng = engines[3]
    reads, cpu = [], torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **kw: reads.append(1) or
                        cpu(self, *a, **kw))
    res = lookup_generate(teng, _prompt(9, 28, repeat=6), max_new_tokens=32)
    assert len(reads) == res.n_steps


def _tv(tokens, p):
    emp = np.bincount(tokens, minlength=len(p)) / len(tokens)
    return 0.5 * np.abs(emp - p).sum()


def test_spec_accept_resample_keeps_the_distribution():
    """The first emitted token (the accepted draft[0], else the residual
    draw) is distributed as softmax(fl[0]); with no draft a == 0 and the
    draw is plain sampling. DRAWS independent draws in one batched call
    (leading dimensions), and one unbatched call."""
    V, k = 8, 3
    fl = torch.from_numpy(np.random.default_rng(0).normal(0, 1.5, size=(k + 1, V))
                          .astype(np.float32))
    p0 = torch.softmax(fl[0], -1).numpy()
    g = torch.Generator().manual_seed(7)
    for draft, no_draft in ((torch.tensor([2, 5, 1]), False), (torch.full((k,), -1), True)):
        a, new = _spec_accept_resample(g, fl.expand(DRAWS, -1, -1), draft.expand(DRAWS, -1),
                                       eos_id=-1)
        assert a.shape == new.shape == (DRAWS,)
        if no_draft:
            assert (a == 0).all()
        toks = torch.where(a >= 1, draft[0], new).numpy()
        assert _tv(toks, p0) < TV_BOUND
        a1, new1 = _spec_accept_resample(g, fl, draft, eos_id=-1)
        assert a1.dim() == new1.dim() == 0 and 0 <= int(a1) <= k and 0 <= int(new1) < V


def test_sampled_lookup_seed_and_raises(engines):
    _, teng = engines[3]
    prompt = _prompt(4, 18, repeat=5)
    sp = SamplingParams(temperature=0.8, top_p=0.95)
    a = lookup_generate(teng, prompt, max_new_tokens=16, draft_len=4, sampling=sp, seed=11)
    b = lookup_generate(teng, prompt, max_new_tokens=16, draft_len=4, sampling=sp, seed=11)
    c = lookup_generate(teng, prompt, max_new_tokens=16, draft_len=4, sampling=sp, seed=12)
    assert a.tokens == b.tokens and a.n_steps == b.n_steps and len(a.tokens) == 16
    assert a.tokens != c.tokens or a.n_steps != c.n_steps
    greedy = lookup_generate(teng, prompt, max_new_tokens=8, sampling=SamplingParams.greedy())
    assert greedy.tokens == lookup_generate(teng, prompt, max_new_tokens=8).tokens
    with pytest.raises(ValueError, match="repetition_penalty"):
        lookup_generate(teng, prompt, sampling=SamplingParams(temperature=0.7,
                                                              repetition_penalty=1.1))
    fused = DecodeEngine.__new__(DecodeEngine)
    fused.fused_decode = True
    with pytest.raises(ValueError, match="per-layer"):
        lookup_generate(fused, prompt)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(ValueError, match="bf16 KV cache"):
        lookup_generate(DecodeEngine(set_llm_config(model, kv_cache_dtype="int8")), prompt)
