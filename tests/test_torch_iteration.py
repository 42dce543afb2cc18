"""The port's iterative alignment driver against scripts/run_iteration.py.

Both drivers run two iterations on the same inputs, then resume: a tiny
fp32 LLaVA (the JAX params bridged into the port's model), the stub
generators of tests/test_pipeline_orchestrator.py (seeded numpy draws,
pointed at real images so the pairs can train) with a scripted greedy
answer length per call (the eval score is the answers' total length, lower
is better), tests/test_iteration.py's fact backends, and one seeded
`random.Random` for the pair sampling. Each iteration runs the data
pipeline, the reference-logp precompute, 4 DPO steps with checkpoints at 2
and 4, and the per-checkpoint eval. The port's driver writes the same stage
files (same names, same rows) and the same summaries, picks the same best
checkpoint (the second iteration promotes its earlier one), scores the same
reference logps (1e-4) and trains to the same losses (1e-3) and weights
(2e-3: a few AdamW steps at lr 1e-3 move a weight whose gradient is near
zero by up to 2 lr when its sign flips at rounding level). A resume skips
both iterations and restores the promoted weights exactly.
"""
import base64
import io
import json
import os
import random
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import run_iteration as jiter  # noqa: E402

from rlaifv_tpu.core.config import Config as JConfig  # noqa: E402
from rlaifv_tpu.data.image_processing import ClipImageProcessor as JProc  # noqa: E402
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig  # noqa: E402
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava  # noqa: E402
from rlaifv_tpu_torch import iteration as titer  # noqa: E402
from rlaifv_tpu_torch.core.config import Config as TConfig  # noqa: E402
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor as TProc  # noqa: E402
from rlaifv_tpu_torch.models.convert import llava_params_from_jax, load_jax_params  # noqa: E402
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM  # noqa: E402
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines  # noqa: E402
from tests.fake_tokenizer import FakeTokenizer  # noqa: E402
from tests.test_pipeline_orchestrator import StubGenerator  # noqa: E402

ANSWER_LENGTHS = [3, 2, 2, 5]  # per eval call: iter1 best step 4, iter2 best step 2


def _fact_backend(n_facts=3):
    def gen(prompts):
        out = []
        for p in prompts:
            h = zlib.crc32(p.encode())
            out.append("\n".join(f"- object {i} kind {(h >> (4 * i)) % 7} is visible."
                                 for i in range(1 + h % n_facts)))
        return out

    return gen, lambda messages: "T:" + messages[0]["content"]


class Stub(StubGenerator):
    """StubGenerator with real image paths and a scripted greedy_gen."""

    def __init__(self, seed, paths, lengths):
        super().__init__(seed)
        self.paths, self.lengths = paths, lengths

    def diverse_gen(self, items, **kw):
        rows = super().diverse_gen(items, **kw)
        for r, item in zip(rows, items):
            r["metainfos"]["image_path"] = self.paths[item["image_id"]]
        return rows

    def greedy_gen(self, items, *, max_new_tokens, batch_size, num_beams):
        n = next(self.lengths)
        return [{"question_id": it["question_id"], "raw_question": it["question"],
                 "answer": " ".join(["w"] * n)} for it in items]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("iterport")
    cfg = JLlavaConfig.tiny()
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    params = JLlava(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
                              images=jnp.zeros((1, S, S, 3)),
                              image_starts=jnp.asarray([0]))["params"]
    rng = np.random.default_rng(0)
    paths, ques, eval_rows = [], [], []
    for i in range(2):
        arr = rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8)
        paths.append(str(tmp / f"{i}.png"))
        Image.fromarray(arr).save(paths[-1])
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        ques.append({"question": f"Describe object {i} now", "image_id": i, "image": b64,
                     "ds_question_id": f"ds{i}"})
        eval_rows.append({"question_id": i, "question": f"What is in image {i}?",
                          "image": b64})
    write_jsonlines(str(tmp / "q.jsonl"), ques)
    return tmp, cfg, params, paths, str(tmp / "q.jsonl"), eval_rows


def _config(cls):
    c = cls()
    t = c.training
    t.max_steps = 4
    t.save_steps = 2  # checkpoints at steps 2 and 4 in each iteration
    t.learning_rate = 1e-3
    t.per_device_batch_pairs = 2
    t.mesh_dp = t.mesh_fsdp = t.mesh_tp = 1
    return c


def _run(driver, tmp, cfg, params, paths, ques, eval_rows, work, monkeypatch):
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: real(0))
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    lengths = iter(ANSWER_LENGTHS)
    make_generator = lambda weights: Stub(0, paths, lengths)  # noqa: E731
    kw = dict(labeler=Stub(1, paths, lengths), iterations=2, max_len=160, num_patches=P,
              sample_num=2, repeat=3, batch_size=4, max_tokens=4, eval_max_new_tokens=4)
    score = lambda answers: float(sum(len(a["text"]) for a in answers))  # noqa: E731
    if driver == "jax":
        return jiter.run_iterative_alignment(
            _config(JConfig), JLlava(cfg), params, FakeTokenizer(), JProc(image_size=S),
            make_generator, _fact_backend(), _fact_backend(), ques, eval_rows, score,
            work, **kw)
    model = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    out = titer.run_iterative_alignment(
        _config(TConfig), model, FakeTokenizer(), TProc(image_size=S), make_generator,
        _fact_backend(), _fact_backend(), ques, eval_rows, score, work, **kw)
    return out, model


def _logps(d):
    import pandas as pd

    files = sorted(f for f in os.listdir(d) if f.endswith(".parquet"))
    rows = pd.concat([pd.read_parquet(os.path.join(d, f)) for f in files])
    return [json.loads(s)["logps"] for s in rows["logps"]]


def _flat(x):
    return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in x])


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    tmp, cfg, params, paths, ques, eval_rows = setup
    mp = pytest.MonkeyPatch()
    try:
        jfinal, jhist = _run("jax", *setup, str(tmp / "jax"), mp)
        (tfinal, thist), tmodel = _run("torch", *setup, str(tmp / "torch"), mp)
    finally:
        mp.undo()
    return jfinal, jhist, tfinal, thist, tmodel


def test_same_summaries_and_best_checkpoints(setup, runs):
    tmp = setup[0]
    _, jhist, _, thist, _ = runs
    assert [h["best_step"] for h in thist] == [h["best_step"] for h in jhist] == [4, 2]
    for j, t in zip(jhist, thist):
        assert t["pairs_path"].replace(str(tmp / "torch"), "") == \
            j["pairs_path"].replace(str(tmp / "jax"), "")
        assert {k: v for k, v in t.items() if k != "pairs_path"} == \
            {k: v for k, v in j.items() if k != "pairs_path"}
        assert t["n_pairs"] > 0
    for it in (1, 2):
        with open(tmp / "torch" / f"iter{it}" / "summary.json") as f:
            assert json.load(f) == thist[it - 1]


@pytest.mark.parametrize("it", [1, 2])
def test_same_stage_files(setup, runs, it):
    tmp = setup[0]
    jdir, tdir = (tmp / d / f"iter{it}" / "results" for d in ("jax", "torch"))
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) and names
    for n in names:
        assert read_jsonlines(str(tdir / n)) == read_jsonlines(str(jdir / n)), n


@pytest.mark.parametrize("it", [1, 2])
def test_same_reference_logps_and_losses(setup, runs, it):
    tmp = setup[0]
    jdir, tdir = (tmp / d / f"iter{it}" for d in ("jax", "torch"))
    want, got = _logps(jdir / "logp_cache"), _logps(tdir / "logp_cache")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_flat(a), _flat(b), rtol=0, atol=1e-4)
    jm = [r for r in read_jsonlines(str(jdir / "train" / "metrics.jsonl")) if "loss" in r]
    tm = [r for r in read_jsonlines(str(tdir / "train" / "metrics.jsonl")) if "loss" in r]
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["loss"] for r in tm], [r["loss"] for r in jm],
                               rtol=0, atol=1e-3)


def test_promoted_weights_match_jax(runs):
    jfinal, _, tfinal, _, tmodel = runs
    want = llava_params_from_jax(jax.tree.map(np.asarray, jfinal))
    assert set(want) == set(tfinal)
    worst = max((tfinal[k].float() - want[k].float()).abs().max().item() for k in want)
    assert worst < 2e-3, worst
    for k, v in tmodel.state_dict().items():  # the model holds the promoted weights
        assert torch.equal(v, tfinal[k]), k


def test_resume_skips_both_iterations(setup, runs, capsys):
    tmp, cfg, params, paths, ques, eval_rows = setup
    _, _, tfinal, thist, _ = runs
    mp = pytest.MonkeyPatch()
    try:
        (final2, hist2), model2 = _run("torch", *setup, str(tmp / "torch"), mp)
    finally:
        mp.undo()
    assert capsys.readouterr().out.count("already done") == 2
    assert hist2 == thist
    for k, v in tfinal.items():
        assert torch.equal(final2[k], v), k
        assert torch.equal(model2.state_dict()[k], v), k
