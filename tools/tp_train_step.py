"""One DPO training step of the seed-0 LLaVA-1.5-7B at full width, cut to
chip_smoke.py's MESH_TWO_LAYERS layers, tensor-parallel at mesh (1, 1, 2):
two processes over gloo groups on one card, each chip_smoke.py's 21c
worker (`mesh_worker`) with the mesh's tp axis at 2 in place of fsdp, so
both ranks train the same two pairs. For the tree at ROOT (default: this
checkout). The pairs' reference logps are constants (a step's time does
not depend on them). Prints each rank's step seconds, loss and grad norm
beside the card's name and power limit; compare two trees in one call:

    python3 tools/tp_train_step.py [ROOT]
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = Path(ARGS[0]).resolve() if ARGS else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def with_ref_logps(batch_fn):
    def batch(ref_logps):
        cfg, t, global_np, P = batch_fn(ref_logps)
        n = global_np["win_labels"].shape[0]
        for side in ("win", "rej"):
            global_np[f"ref_{side}_logp"] = np.full(n, -300.0, np.float32)
            global_np[f"ref_{side}_avg_logp"] = np.full(n, -1.0, np.float32)
            global_np[f"ref_{side}_per_token_logp"] = np.zeros(
                global_np[f"{side}_token_weight"].shape, np.float32)
        return cfg, t, global_np, P

    return batch


def worker(out_dir: str) -> None:
    create = cs.sharding.create_mesh
    cs.sharding.create_mesh = lambda dp, fsdp, tp, **kw: create(1, 1, cs.MESH_TWO_WORLD, **kw)
    cs._mesh_two_batch = with_ref_logps(cs._mesh_two_batch)
    cs.mesh_worker(out_dir)


def main() -> None:
    smi = cs.phase_environment()
    cs.phase_build()
    out = tempfile.mkdtemp(prefix="tp_train_step_")
    with open(os.path.join(out, "ref_logps.json"), "w") as f:
        json.dump([], f)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(cs._free_port()),
           "WORLD_SIZE": str(cs.MESH_TWO_WORLD)}
    procs = [subprocess.Popen([sys.executable, __file__, str(ROOT), "--worker", out],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(cs.MESH_TWO_WORLD)]
    try:
        codes = [p.wait(timeout=cs.MESH_TWO_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"tp train step: the workers exited {codes}")
    for r in range(cs.MESH_TWO_WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            rec = json.load(f)
        cs.log(f"[tp train step] {ROOT.name} rank {r}, mesh {rec['mesh']}, "
               f"{cs.MESH_TWO_LAYERS} layers: step {rec['times'][0]:.3f} s, loss "
               f"{rec['losses'][0]!r}, grad norm {rec['gnorms'][0]!r} | {smi}")


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(ARGS[1])
    else:
        main()
