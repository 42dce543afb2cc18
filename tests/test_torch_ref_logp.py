"""The port's reference-logp precompute (rlaifv_tpu_torch/train/ref_logp.py,
DecodeEngine.score_pair_logps) against the JAX package's, on the CPU.

One flax tiny-LLaVA param tree is bridged into the torch model; the same
raw preference rows (numpy-seeded PNG images, FakeTokenizer) are scored by
`score_preference_rows` of both packages with the "xla", "fused" and
"compact" heads and on the shared-prefix path. A spy on
`DecodeEngine.score_pair_logps` proves the shared path scored the rows
instead of falling back to the plain scorer.

Tolerances (fp32 on both sides, the sums taken in other orders): sequence
sums atol 1e-4 (about 30 summed logps of ~-4), means and per-token logps
atol 1e-5; the shared path against the plain one, as the JAX package's own
parity test holds them (tests/test_pipeline.py): rtol/atol 1e-4 on sums and
means, rtol 1e-3 / atol 1e-4 per token.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.train import ref_logp as jref
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor
from rlaifv_tpu_torch.genai.engine import DecodeEngine
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.train import ref_logp as tref
from tests.fake_tokenizer import FakeTokenizer

SUM_ATOL, TOK_ATOL = 1e-4, 1e-5


def _png(rng, size):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def raw_rows(rng, n, img_size):
    """RLAIF-V parquet rows: question, chosen, rejected, image bytes."""
    return [{"idx": str(i), "question": f"What is in image {i}?",
             "chosen": f"A small {i} cat.", "rejected": f"A big {i} dog and a hat.",
             "image": {"bytes": _png(rng, img_size), "path": f"img{i}.png"},
             "image_path": f"img{i}.png", "origin_dataset": "unit",
             "origin_split": "{}"} for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    jcfg = JLlavaConfig.tiny()
    P, S = jcfg.num_image_tokens, jcfg.vision.image_size
    params = JLlava(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((2, P + 8), jnp.int32),
        images=jnp.zeros((2, S, S, 3)), image_starts=jnp.asarray([0, 0]))["params"]
    model = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    rows = raw_rows(np.random.default_rng(11), 5, S)
    kw = dict(max_len=320, num_patches=P, batch_pairs=2,
              image_processor=ClipImageProcessor(image_size=S), progress=False)
    return dict(jmodel=JLlava(jcfg), params=params, model=model, rows=rows, kw=kw)


def _close_rows(got, want, sum_atol, tok_atol, rtol=0.0, tok_rtol=0.0):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in (0, 1, 3, 4):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                       atol=sum_atol if k in (0, 3) else tok_atol)
        for k in (2, 5):
            assert len(a[k]) == len(b[k])
            np.testing.assert_allclose(a[k], b[k], rtol=tok_rtol, atol=tok_atol)


@pytest.mark.parametrize("head", ["xla", "fused", "compact"])
def test_plain_scorer_matches_jax(setup, head):
    kw = dict(setup["kw"], lm_head_impl=head, compact_len=32 if head == "compact" else 0)
    tok = FakeTokenizer()
    want = jref.score_preference_rows(setup["rows"], setup["jmodel"], setup["params"], tok,
                                      **kw)
    got = tref.score_preference_rows(setup["rows"], setup["model"], tok, **kw)
    _close_rows(got, want, SUM_ATOL, TOK_ATOL)


def test_shared_prefix_scorer_matches_jax_and_the_plain_path(setup, monkeypatch):
    shared_rows = []
    orig = DecodeEngine.score_pair_logps

    def spy(self, prefixes, *a, **kw):
        shared_rows.append(len(prefixes))
        return orig(self, prefixes, *a, **kw)

    monkeypatch.setattr(DecodeEngine, "score_pair_logps", spy)
    tok = FakeTokenizer()
    got = tref.score_preference_rows(setup["rows"], setup["model"], tok,
                                     shared_prefix=True, **setup["kw"])
    assert sum(shared_rows) == 5, f"the shared path scored {sum(shared_rows)}/5 rows"
    want = jref.score_preference_rows(setup["rows"], setup["jmodel"], setup["params"], tok,
                                      shared_prefix=True, **setup["kw"])
    _close_rows(got, want, SUM_ATOL, TOK_ATOL)
    plain = tref.score_preference_rows(setup["rows"], setup["model"], tok, **setup["kw"])
    _close_rows(got, plain, 1e-4, 1e-4, rtol=1e-4, tok_rtol=1e-3)


def test_rows_that_cannot_share_fall_back_with_the_given_head(setup, monkeypatch):
    """A row that cannot share (here: its split is refused) goes through the
    plain scorer with the requested head, the others through the engine."""
    calls = []
    orig = tref.score_preference_rows
    orig_split = tref._shared_split

    def spy(rows, *a, **kw):
        calls.append((len(rows), kw.get("lm_head_impl"), kw.get("shared_prefix")))
        return orig(rows, *a, **kw)

    splits = []

    def refuse_second(*a):
        splits.append(1)
        return None if len(splits) == 2 else orig_split(*a)

    monkeypatch.setattr(tref, "score_preference_rows", spy)
    monkeypatch.setattr(tref, "_shared_split", refuse_second)
    tok = FakeTokenizer()
    got = tref._score_rows_shared(
        setup["rows"][:3], setup["model"], tok, max_len=320,
        num_patches=setup["kw"]["num_patches"], batch_pairs=2, progress=False,
        lm_head_impl="fused", mm_cfg=_mm_cfg(setup))
    assert calls == [(1, "fused", False)]
    plain = orig(setup["rows"][:3], setup["model"], tok, **setup["kw"])
    _close_rows(got, plain, 1e-4, 1e-4, rtol=1e-4, tok_rtol=1e-3)


def _mm_cfg(setup):
    from rlaifv_tpu_torch.train.family import get_family

    return get_family("llava15").mm_cfg(setup["kw"]["image_processor"],
                                        setup["kw"]["num_patches"])


def test_inference_logp_writes_the_jax_parquet_layout(setup, tmp_path, monkeypatch):
    """Same files, columns and rows as the JAX writer. Over two processes
    (the collectives stubbed here; tests/test_torch_distributed.py runs two
    real ones) rank 1 scores its shard and writes nothing, and rank 0 writes
    the gathered rows as one process does."""
    import json

    import pandas as pd

    tok = FakeTokenizer()
    tref.inference_logp(setup["rows"], setup["model"], tok, str(tmp_path / "t"),
                        **{k: v for k, v in setup["kw"].items() if k != "progress"})
    jref.inference_logp(setup["rows"], setup["jmodel"], setup["params"], tok,
                        str(tmp_path / "j"),
                        **{k: v for k, v in setup["kw"].items() if k != "progress"})
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == ["RLAIF-V-Dataset-withlogp_000-5.parquet"]
    t = pd.read_parquet(tmp_path / "t" / names[0])
    j = pd.read_parquet(tmp_path / "j" / names[0])
    assert list(t.columns) == list(j.columns)
    for a, b in zip(t["logps"], j["logps"]):
        _close_rows([json.loads(a)["logps"]], [json.loads(b)["logps"]], SUM_ATOL, TOK_ATOL)

    from rlaifv_tpu_torch.core import distributed as dist

    kw = {k: v for k, v in setup["kw"].items() if k != "progress"}
    shards = {}
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "barrier", lambda name="": None)
    for rank in (1, 0):  # rank 1 first: rank 0's gather returns both shards

        def gather(obj, rank=rank):
            shards[rank] = obj
            return [shards.get(0, obj), shards[1]]  # rank 1 writes nothing

        monkeypatch.setattr(dist, "process_index", lambda rank=rank: rank)
        monkeypatch.setattr(dist, "all_gather_objects", gather)
        tref.inference_logp(setup["rows"], setup["model"], tok, str(tmp_path / f"w{rank}"),
                            **kw)
    assert not (tmp_path / "w1").exists()
    assert [len(shards[r]) for r in (0, 1)] == [3, 2]  # shard_indices(5, 2, r)
    w = pd.read_parquet(tmp_path / "w0" / names[0])
    assert w.drop(columns="logps").equals(t.drop(columns="logps"))
    for a, b in zip(w["logps"], t["logps"]):
        _close_rows([json.loads(a)["logps"]], [json.loads(b)["logps"]], SUM_ATOL, TOK_ATOL)
