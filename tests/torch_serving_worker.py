"""One rank of tests/test_torch_sharded_serving.py's runs: the port's
DecodeEngine over a model sharded by parallel/sharding.py on a (1, 1, tp)
mesh (gloo on localhost, torchrun's environment variables).

    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=<n> RANK=<r> \
        python tests/torch_serving_worker.py <inputs.pt> <out_dir>

`inputs.pt` (written by the test) holds the bridged tiny models' float
weights and, per world size, the list of jobs. A job builds its model
("llama": the tiny Llama, "llama_wide": the tiny Llama at hidden 256 /
intermediate 512, "llava": the tiny LLaVA), quantises it whole when it
says so (models/convert.py, int8 or int4: the head kept float at int4),
fuses its projections when it says so, shards it at (1, 1, world) and
calls one engine method:

- "generate", "generate_continuous", "generate_beam",
  "score_shared_prefix": the entry point with the job's arguments
  ("sampling" a dict of SamplingParams fields); keeps the result, the
  cache's KV heads and, for a quantised model, whether every tp shard's
  q/scale gathers back to the whole model's integers and scales bit for
  bit;
- "fused": DecodeEngine(fused_decode=True) on the sharded model; keeps the
  ValueError.

With "fault", rank 0's all-reduce in the first layer's o projection
keeps its own partial product instead of the sum (the collective still
runs, so the ranks stay in step): a planted fault the test's checks must
catch.

Writes <out_dir>/<job>.rank<r>.pt. The worker imports neither jax nor the
JAX package.
"""
import os
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rlaifv_tpu_torch.core import distributed as dist  # noqa: E402
from rlaifv_tpu_torch.genai.engine import DecodeEngine  # noqa: E402
from rlaifv_tpu_torch.genai.sampling import SamplingParams  # noqa: E402
from rlaifv_tpu_torch.models import convert  # noqa: E402
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, QuantDense  # noqa: E402
from rlaifv_tpu_torch.parallel import sharding  # noqa: E402

WIDE = dict(hidden_size=256, intermediate_size=512)  # int4 groups of 128 split at tp 2


def build(job, inputs):
    family = job["family"]
    if family == "llava":
        from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

        model = LlavaForCausalLM(LlavaConfig.tiny(**job.get("cfg", {})))
    else:
        kw = {**(WIDE if family == "llama_wide" else {}), **job.get("cfg", {})}
        model = LlamaForCausalLM(LlamaConfig.tiny(**kw))
    model.load_state_dict(inputs[family])
    bits = job.get("bits")
    if bits == 8:
        convert.quantize_llm_int8(model)
    elif bits == 4:
        convert.quantize_llm_int4(model)
    if job.get("fuse"):
        convert.fuse_llm_projections_(model)
    return model.eval()


def quant_buffers(model):
    return {f"{n}.{b}": t.clone() for n, m in model.named_modules() if isinstance(m, QuantDense)
            for b, t in (("q", m.q), ("scale", m.scale))}


class _KeepPartial(torch.autograd.Function):
    """The planted fault: the all-reduce runs (into a copy), the rank keeps
    its own partial product."""

    @staticmethod
    def forward(ctx, x, group):
        torch.distributed.all_reduce(x.contiguous().clone(), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def plant_fault(model) -> None:
    llm = getattr(model, "llm", model)
    proj = llm.model.layers[0].attn.o_proj
    tp, linear = proj.tp, proj.tp.linear

    def faulty(mod, x):
        keep, sharding._ReduceFromTP = sharding._ReduceFromTP, _KeepPartial
        try:
            return linear(mod, x)
        finally:
            sharding._ReduceFromTP = keep

    tp.linear = faulty


def run(job, inputs):
    model = build(job, inputs)
    whole = quant_buffers(model)
    mesh = sharding.create_mesh(1, 1, dist.process_count(), device_type="cpu")
    sharding.shard_params(model, mesh)
    plan = sharding.mesh_plan(model)
    if job["method"] == "fused":
        try:
            DecodeEngine(model, eos_id=-1, pad_id=0, fused_decode=True)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    if job.get("fault") and dist.process_index() == 0:
        plant_fault(model)
    eng = DecodeEngine(model, eos_id=-1, pad_id=0)
    kw = dict(job.get("kwargs", {}))
    if "sampling" in kw:
        kw["sampling"] = SamplingParams(**kw["sampling"])
    out = getattr(eng, job["method"])(*job["args"], **kw)
    llm = getattr(model, "llm", model)
    res = {"kv_heads": llm.kv_heads(),
           "split": sorted(plan.tp_modules),
           "quant_exact": all(torch.equal(plan.full_tensor(n, t), whole[n])
                              for n, t in quant_buffers(model).items())}
    if isinstance(out, np.ndarray):
        res["logits"] = out
    else:
        res.update(tokens=out.tokens, lengths=out.lengths, first_logits=out.first_logits)
    return res


def main(inputs_path: str, out_dir: str) -> None:
    dist.initialize()
    rank = dist.process_index()
    inputs = torch.load(inputs_path, weights_only=False)
    for job in inputs["jobs"][dist.process_count()]:
        res = run(job, inputs)
        torch.save(res, os.path.join(out_dir, f"{job['name']}.rank{rank}.pt"))
        dist.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
