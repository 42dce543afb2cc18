"""rlaifv_tpu_torch/core/distributed.py and the precompute over processes.

One process: the collectives are no-ops. Two real processes on localhost
(tests/torch_two_process_worker.py, launched with torchrun's environment
variables, gloo, each with a 120 s timeout so that a hang cannot stall the
suite): initialize from the environment, a ragged all_gather_objects in
rank order, barrier, assert_consistent agreeing and diverging, the tiny
model's reference-logp precompute at world 2 against the one this process
writes at world 1 (bit-equal at batch_pairs 1, where both score the same
one-pair batches; within 1e-5 at batch_pairs 8, where the shards' batches
pad differently), and the trainer over both processes against one
(parallel/sharding.py: the config's mesh at world 2 is fsdp 2).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rlaifv_tpu_torch.core import distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_two_process_worker.py"
TIMEOUT = 120


def test_single_process_no_ops():
    dist.initialize()  # no launcher variables under pytest: nothing happens
    assert dist.process_index() == 0 and dist.process_count() == 1 and dist.is_primary()
    assert dist.all_gather_objects([1, {"a": 2}]) == [[1, {"a": 2}]]
    dist.barrier()
    dist.assert_consistent({"seed": 1})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = tmp_path_factory.mktemp("two")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2", "RLAIFV_DISTRIBUTED_DEBUG": "1", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(out)], cwd=ROOT,
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [json.load(open(out / f"rank{r}.json")) for r in range(2)]
    return out, ranks


def test_initialize_gather_and_barrier(two):
    _, ranks = two
    for r, res in enumerate(ranks):
        assert (res["rank"], res["count"], res["primary"]) == (r, 2, r == 0)
        assert res["backend"] == "gloo"
        assert res["gathered"] == [
            {"rank": q, "data": list(range(3 * q + 1)), "text": "x" * (1000 * (q + 1))}
            for q in range(2)]


def test_assert_consistent_over_two_processes(two):
    _, ranks = two
    for res in ranks:
        msg = res["diverging"]
        assert msg and "'diverging' differs across processes" in msg
        assert "process 0: {\"seed\": 0}" in msg and "process 1: {\"seed\": 1}" in msg


def _logps(path):
    import pandas as pd

    files = sorted(os.listdir(path))
    assert files == ["RLAIF-V-Dataset-withlogp_000-5.parquet"]
    frame = pd.read_parquet(os.path.join(path, files[0]))
    return frame, [json.loads(x)["logps"] for x in frame["logps"]]


@pytest.mark.parametrize("batch_pairs", [1, 8])
def test_inference_logp_world_two_writes_the_world_one_parquet(two, tmp_path, batch_pairs):
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_two_process_worker import tiny_setup

    from rlaifv_tpu_torch.train.ref_logp import inference_logp

    out, ranks = two
    assert ranks[0]["wrote"][str(batch_pairs)] == ["RLAIF-V-Dataset-withlogp_000-5.parquet"]
    model, tok, rows, kw = tiny_setup()
    inference_logp(rows, model, tok, str(tmp_path / "world1"), batch_pairs=batch_pairs, **kw)
    f1, want = _logps(tmp_path / "world1")
    f2, got = _logps(out / f"world2_b{batch_pairs}")
    assert list(f1["idx"]) == list(f2["idx"]) == [r["idx"] for r in rows]
    assert f1.drop(columns="logps").equals(f2.drop(columns="logps"))
    for a, b in zip(got, want):
        for k in (2, 5):
            assert len(a[k]) == len(b[k])
        if batch_pairs == 1:
            assert a == b
        else:
            for k in range(6):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_trainer_trains_over_two_processes(two, tmp_path):
    """Two steps of DPOTrainer over the two processes (the config's mesh:
    fsdp 2, two pairs a process) write the metrics of the same two steps of
    four pairs in one process, within tests/test_torch_train.py's metric
    tolerance (atol 1e-5 + rtol 1e-6)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_two_process_worker import tiny_setup, train_tiny

    out, ranks = two
    assert [res["trainer"] for res in ranks] == [2, 2]
    assert train_tiny(tiny_setup()[0], str(tmp_path)) == 2

    def logged(path):
        with open(path / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = logged(out / "train"), logged(tmp_path)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "steps_per_sec":
                assert abs(g[k] - w[k]) <= 1e-5 + 1e-6 * abs(w[k]), (g["step"], k, g[k], w[k])
