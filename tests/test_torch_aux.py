"""The port's aux modules: registry, TSV datasets, profiling, distributed.

The cases of tests/test_aux.py run on rlaifv_tpu_torch's modules, plus the
port's torch.profiler trace: a file under log_dir, with the annotated
regions nested inside it.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from rlaifv_tpu_torch.core import distributed as dist
from rlaifv_tpu_torch.core.distributed import all_gather_objects, barrier, is_primary
from rlaifv_tpu_torch.core.registry import Registry
from rlaifv_tpu_torch.data.tsv_data import (
    MultiDataSourceDataset,
    SingleDataSourceDataset,
    TSVFile,
    chunked_random_indices,
)
from rlaifv_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_registry():
    r = Registry("test")

    @r.register("a")
    def fn_a():
        return 1

    assert r["a"]() == 1
    assert "a" in r
    with pytest.raises(KeyError):
        r["missing"]
    with pytest.raises(KeyError):
        r.register("a")(fn_a)


def _write_tsv(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(row) + "\n")


def test_tsv_file_seek(tmp_path):
    p = str(tmp_path / "data.tsv")
    _write_tsv(p, [["a", "1"], ["b", "2"], ["c", "3"]])
    t = TSVFile(p)
    assert len(t) == 3
    assert t[1] == ["b", "2"]
    assert t[0] == ["a", "1"]  # seek backwards works
    assert os.path.exists(str(tmp_path / "data.lineidx"))


def test_tsv_file_reopens_after_fork(tmp_path):
    """The handle belongs to the process that opened it: a new pid reopens."""
    p = str(tmp_path / "data.tsv")
    _write_tsv(p, [["a"], ["b"]])
    t = TSVFile(p)
    assert t[1] == ["b"]
    first = t._fp
    t._pid = -1  # as seen from a forked child
    assert t[0] == ["a"] and t._fp is not first and t._pid == os.getpid()


def test_single_source_shards(tmp_path):
    p1, p2 = str(tmp_path / "s1.tsv"), str(tmp_path / "s2.tsv")
    _write_tsv(p1, [["r0"], ["r1"]])
    _write_tsv(p2, [["r2"], ["r3"], ["r4"]])
    ds = SingleDataSourceDataset("src", p1, p2)
    assert len(ds) == 5
    assert ds[1] == ["r1"] and ds[2] == ["r2"] and ds[4] == ["r4"]


def test_multi_source_interleave(tmp_path):
    pa, pb = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    _write_tsv(pa, [[f"a{i}"] for i in range(6)])
    _write_tsv(pb, [[f"b{i}"] for i in range(3)])
    a = SingleDataSourceDataset("a", pa)
    b = SingleDataSourceDataset("b", pb)
    ds = MultiDataSourceDataset([a, b], [2, 1])
    rows = [ds[i][0] for i in range(len(ds))]
    # pattern aabaab...: both sources in order, 2:1 ratio
    assert rows == ["a0", "a1", "b0", "a2", "a3", "b1", "a4", "a5", "b2"]


def test_chunked_random_indices():
    idx = chunked_random_indices(25, chunk_size=10, seed=0)
    assert sorted(idx) == list(range(25))
    # within-chunk shuffling only
    assert set(idx[:10]) == set(range(10))
    assert set(idx[20:]) == set(range(20, 25))


def test_step_timer():
    t = StepTimer()
    assert t.tick() is None
    assert t.tick() is not None
    assert t.throughput(4) > 0


def test_trace_noop_and_annotate(tmp_path):
    with trace(None):
        pass
    with trace(""):
        pass
    with annotate("region"):
        x = np.ones(3).sum()
    assert x == 3
    assert not os.listdir(tmp_path)


def test_trace_writes_a_file_with_nested_annotations(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with annotate("outer"):
            with annotate("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    events = {e["name"]: e for e in json.load(open(files[0]))["traceEvents"]
              if e.get("name") in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_is_written_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="inside"):
        with trace(log_dir):
            raise RuntimeError("inside")
    assert len(glob.glob(os.path.join(log_dir, "*.json"))) == 1


def test_distributed_single_process():
    assert is_primary()
    assert dist.process_index() == 0 and dist.process_count() == 1
    assert all_gather_objects({"a": 1}) == [{"a": 1}]
    barrier()  # no-op


def test_initialize_without_launcher_env_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    dist.initialize()
    assert not torch.distributed.is_initialized()


def test_assert_consistent_detects_divergence(monkeypatch):
    """RLAIFV_DISTRIBUTED_DEBUG guard: no-op single process / flag off;
    raises with per-process detail on divergent host state."""
    dist.assert_consistent({"seed": 1}, "cfg")  # single-process no-op

    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.delenv("RLAIFV_DISTRIBUTED_DEBUG", raising=False)
    monkeypatch.setattr(dist, "all_gather_objects", lambda blob: 1 / 0)
    dist.assert_consistent({"seed": 1}, "cfg")  # flag off -> no-op, no gather

    monkeypatch.setenv("RLAIFV_DISTRIBUTED_DEBUG", "1")
    monkeypatch.setattr(
        dist, "all_gather_objects", lambda blob: [blob, blob]
    )
    dist.assert_consistent({"seed": 1}, "cfg")  # consistent -> ok

    monkeypatch.setattr(
        dist, "all_gather_objects",
        lambda blob: [blob, blob.replace("1", "2")],
    )
    with pytest.raises(AssertionError, match="differs across processes"):
        dist.assert_consistent({"seed": 1}, "cfg")
