"""One rank of tests/test_torch_mesh_train.py's runs over a (dp, fsdp, tp)
mesh (gloo on localhost, torchrun's environment variables).

    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=<n> RANK=<r> \
        python tests/torch_mesh_worker.py <inputs.pt> <out_dir>

`inputs.pt` (written by the test) holds the bridged tiny models' weights,
the collated global batches and the list of jobs; each job runs on a mesh
of the world's size, its model sharded by parallel/sharding.py:

- "step": the full fine-tune train step (make_dpo_train_step) for a few
  steps on this rank's pairs of the global batch (with "accum" k > 1, each
  a micro-step of MultiSteps(k)); process 0 keeps, after every step,
  the metrics, the whole gradients and the whole parameters;
- "lora": the LoRA step over the sharded base; every rank keeps its
  adapters and their reduced gradients after every step;
- "trainer": DPOTrainer.train from a config (gradient accumulation, a
  checkpoint), then a second trainer resuming that checkpoint in a copy of
  the directory; checks that the resumed state gathers back to the saved
  one bit for bit;
- "train": DPOTrainer.train from a config, into <out_dir>/<job>/; every
  rank keeps its shards of the parameters that tp leaves whole;
- "refuse": DPOTrainer on a config whose mesh is smaller than the world;
  keeps the ValueError.

Writes <out_dir>/<job>.rank<r>.pt. The worker imports neither jax nor the
JAX package.
"""
import os
import shutil
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from rlaifv_tpu_torch.core import distributed as dist  # noqa: E402
from rlaifv_tpu_torch.parallel import sharding  # noqa: E402
from rlaifv_tpu_torch.train import train_step as tts  # noqa: E402


def build(family: str, state, remat: bool = False, fuse: bool = False):
    """The tiny model of `family` with the test's bridged weights (LLaVA's
    with activation checkpointing when `remat`, its q/k/v and gate/up
    projections fused when `fuse`)."""
    if family == "omnilmm":
        from rlaifv_tpu_torch.models.omnilmm import OmniLMMConfig, OmniLMMForCausalLM

        model, adapter = OmniLMMForCausalLM(OmniLMMConfig.tiny()), tts.OmnilmmDPOAdapter
    else:
        from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

        model, adapter = LlavaForCausalLM(LlavaConfig.tiny(remat=remat)), tts.LlavaDPOAdapter
    model.load_state_dict(state)
    if fuse:
        from rlaifv_tpu_torch.models.convert import fuse_llm_projections_

        fuse_llm_projections_(model)
    return model, adapter(model)


def whole(plan, named):
    return {n: plan.full_tensor(n, t).detach().clone() for n, t in named}


def run_step(job, inputs):
    model, adapter = build(job["family"], inputs[job["family"]], job.get("remat", False),
                           job.get("fuse", False))
    mesh = sharding.create_mesh(*job["mesh"], device_type="cpu")
    sharding.shard_params(model, mesh)
    plan = sharding.mesh_plan(model)
    hp = tts.DPOHparams(**job["hp"])
    opt = tts.make_optimizer(model, job["lr"], total_steps=10)
    if job.get("accum", 1) > 1:
        opt = tts.MultiSteps(opt, job["accum"])
    step = tts.make_dpo_train_step(adapter, opt, hp)
    batch = tts.batch_to_device(sharding.shard_pairs(job["batch"], mesh), "cpu")
    out = {"metrics": [], "grads": [], "params": []}
    for _ in range(job["steps"]):
        out["metrics"].append({k: float(v) for k, v in step(batch).items()})
        named = list(model.named_parameters())
        out["grads"].append(whole(plan, [(n, p.grad) for n, p in named]))
        out["params"].append(whole(plan, named))
    return out


def run_lora(job, inputs):
    from rlaifv_tpu_torch.train.lora import lora_init

    model, adapter = build(job["family"], inputs[job["family"]])
    lora = lora_init(torch.Generator().manual_seed(0), model, r=4)
    mesh = sharding.create_mesh(*job["mesh"], device_type="cpu")
    sharding.shard_params(model, mesh)
    opt = tts.make_optimizer(lora, job["lr"], total_steps=10)
    step = tts.make_lora_dpo_train_step(adapter, opt, tts.DPOHparams(**job["hp"]), lora)
    batch = tts.batch_to_device(sharding.shard_pairs(job["batch"], mesh), "cpu")
    out = {"metrics": [], "grads": [], "lora": []}
    for _ in range(job["steps"]):
        out["metrics"].append({k: float(v) for k, v in step(batch).items()})
        named = tts.named_tensors(lora)  # the gradients as reduced over the mesh
        out["grads"].append({n: t.grad.clone() for n, t in named})
        out["lora"].append({n: t.detach().clone() for n, t in named})
    return out


def trainer(job, inputs, output_dir, max_steps):
    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.train.trainer import DPOTrainer

    config = Config()
    for key, val in job["training"].items():
        setattr(config.training, key, val)
    config.training.output_dir = output_dir
    config.training.max_steps = max_steps
    model, adapter = build(job["family"], inputs[job["family"]])
    coll = DPOCollator(pad_token_id=0, max_len=job["max_len"],
                       num_patches=model.cfg.num_image_tokens)
    return DPOTrainer(config, model, job["pairs"], coll, adapter=adapter)


def run_trainer(job, inputs, out_dir):
    first = os.path.join(out_dir, "trainer_first")
    trainer(job, inputs, first, job["stop_at"]).train()
    resumed = os.path.join(out_dir, "trainer_resumed")
    if dist.is_primary():
        shutil.rmtree(resumed, ignore_errors=True)
        shutil.copytree(first, resumed)
    dist.barrier()
    tr = trainer(job, inputs, resumed, job["max_steps"])
    restored = tr.ckpt.restore()
    state = tr._state_tree()  # gathered back from the shards just loaded
    same = None
    if dist.is_primary():
        got, want = (list(_tensors({k: s[k] for k in ("params", "opt_state")}))
                     for s in (state, restored))
        same = len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    steps = tr.train()
    return {"resume_exact": same, "steps": steps, "start": tr.start_step}


def run_train(job, inputs, out_dir):
    tr = trainer(job, inputs, os.path.join(out_dir, job["name"]), job["max_steps"])
    steps = tr.train()
    plan = sharding.mesh_plan(tr.model)
    return {"steps": steps,
            "whole_over_tp": {n: sharding.local_shard(p).detach().clone()
                              for n, p in tr.model.named_parameters()
                              if n not in plan.tp_dims}}


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif torch.is_tensor(tree):
        yield tree


def run_refuse(job, inputs, out_dir):
    try:
        trainer(job, inputs, os.path.join(out_dir, "refused"), 1)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def main(inputs_path: str, out_dir: str) -> None:
    dist.initialize()
    rank = dist.process_index()
    inputs = torch.load(inputs_path, weights_only=False)
    for job in inputs["jobs"][dist.process_count()]:
        kind = job["kind"]
        if kind == "step":
            res = run_step(job, inputs)
        elif kind == "lora":
            res = run_lora(job, inputs)
        elif kind == "trainer":
            res = run_trainer(job, inputs, out_dir)
        elif kind == "train":
            res = run_train(job, inputs, out_dir)
        else:
            res = run_refuse(job, inputs, out_dir)
        if rank == 0 or kind in ("lora", "train"):
            torch.save(res, os.path.join(out_dir, f"{job['name']}.rank{rank}.pt"))
        dist.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
