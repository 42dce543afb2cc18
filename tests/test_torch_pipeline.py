"""The port's feedback-pipeline orchestrator against scripts/run_data_pipeline.py.

Both `run_pipeline`s run on the stub engines of
tests/test_pipeline_orchestrator.py (a seeded stub generator and labeler,
a fixed divide / changeq backend) in directories of their own. Every stage
file must carry the same name and the same rows on both sides: the stages
are copies over the same numpy/`random` code. `pairs/preference.py` samples
with an unseeded `random.Random`, so both runs get the same seeded one.
With a labeler that scores every fact alike no pair forms: the JAX
orchestrator raises in its length balance, the port writes an empty
balanced file (its one deliberate difference).
"""
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import run_data_pipeline as jpipe  # noqa: E402

from rlaifv_tpu_torch import pipeline as tpipe  # noqa: E402
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines  # noqa: E402
from tests.test_pipeline_orchestrator import StubGenerator, _stub_llm_backend  # noqa: E402


def _run(mod, tmp_path, name):
    ques = tmp_path / "q.jsonl"
    if not ques.exists():
        write_jsonlines(str(ques), [
            {"question": f"Describe image {i}.", "image_id": i} for i in range(4)
        ])
    ans_dir = str(tmp_path / name)
    out = mod.run_pipeline(StubGenerator(), StubGenerator(seed=1),
                           _stub_llm_backend(), _stub_llm_backend(),
                           str(ques), ans_dir, sample_num=2)
    return out, ans_dir


@pytest.fixture
def seeded_sampling(monkeypatch):
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: real(0))


def test_stage_files_match_jax(tmp_path, seeded_sampling):
    want_out, want_dir = _run(jpipe, tmp_path, "jax")
    got_out, got_dir = _run(tpipe, tmp_path, "torch")
    assert os.path.basename(got_out) == os.path.basename(want_out)
    assert got_out.endswith("_pair_diff1_samp2_balanceshort.jsonl")
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(want_dir))
    for suffix in (".llama3-8b_divide.jsonl", ".gq.jsonl", ".gq.qas.jsonl",
                   "_pair_diff1_samp2.jsonl", "_balanceshort.jsonl"):
        assert any(n.endswith(suffix) for n in names), suffix
    for n in names:
        got = read_jsonlines(os.path.join(got_dir, n))
        assert got == read_jsonlines(os.path.join(want_dir, n)), n
    assert read_jsonlines(got_out)  # pairs reached the end of the chain


def test_rerun_reuses_stage_files(tmp_path, seeded_sampling):
    """Idempotent resume: a second run over the same directory reuses the
    diverse-gen and autocheck files and the divide stage's answer files
    (resume by file), and returns the same path with the same rows."""
    out, ans_dir = _run(tpipe, tmp_path, "torch")
    rows = read_jsonlines(out)

    class Refuses(StubGenerator):
        def diverse_gen(self, items, **kw):
            raise AssertionError("diverse_gen ran again")

        def autocheck(self, items, **kw):
            raise AssertionError("autocheck ran again")

    def refuse(prompts):
        raise AssertionError("the divide stage generated again")

    out2 = tpipe.run_pipeline(Refuses(), Refuses(seed=1), (refuse, lambda m: ""),
                              (refuse, lambda m: ""), str(tmp_path / "q.jsonl"), ans_dir,
                              sample_num=2)
    assert out2 == out and read_jsonlines(out2) == rows


class AllYes(StubGenerator):
    def autocheck(self, items, **kw):
        rows = super().autocheck(items, **kw)
        for r in rows:
            r["scores"] = {"yes": 0.9, "Yes": 0.05, "no": 0.04, "No": 0.01}
        return rows


def test_no_pairs_gives_an_empty_balanced_file(tmp_path, seeded_sampling):
    ques = tmp_path / "q.jsonl"
    write_jsonlines(str(ques), [{"question": f"Describe image {i}.", "image_id": i}
                                for i in range(2)])
    args = lambda d: (StubGenerator(), AllYes(seed=1), _stub_llm_backend(),  # noqa: E731
                      _stub_llm_backend(), str(ques), str(tmp_path / d))
    with pytest.raises(ValueError):
        jpipe.run_pipeline(*args("jax"), sample_num=2)
    out = tpipe.run_pipeline(*args("torch"), sample_num=2)
    assert out.endswith("_pair_diff1_samp2_balanceshort.jsonl")
    assert read_jsonlines(out) == []
    assert read_jsonlines(out.replace(".jsonl", "_search_diff.jsonl")) == []
    assert read_jsonlines(out.replace("_balanceshort.jsonl", ".jsonl")) == []
