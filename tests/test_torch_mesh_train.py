"""DPO training over a (dp, fsdp, tp) mesh of processes (parallel/sharding.py,
the trainer's mesh), on the CPU over gloo.

tests/torch_mesh_worker.py runs each world once (2 processes: meshes
(1, 2, 1) and (1, 1, 2); 4 processes: (2, 2, 1), (1, 2, 2) and
(1, 1, 4)), spawned as
tests/test_torch_distributed.py spawns its worker, all of its jobs in that
one spawn. The tiny LLaVA's weights are the JAX init bridged into the port;
the tiny OmniLMM's are the port's seeded init. Every run trains on the same
global batch of 4 pairs, each rank on its pairs; one case checkpoints
every block's activations (remat), as the training configs do, and one
accumulates two micro-steps an update (MultiSteps) at (1, 2, 2).

Against the port's own one-process step (which tests/test_torch_train.py
holds to JAX), at that file's tolerances: the metrics of every step (atol
1e-5 + rtol 1e-6), the whole gradients of every step (atol 1e-5 + rtol 1e-4), and the
parameters after every step (atol 1e-6 + rtol 1e-5) with the one-process
optimizer fed the mesh run's gradients, as that file holds the optimizer
to optax on identical gradients (Adam divides each gradient element by its
own size, so two runs whose gradients differ by rounding drift apart
element by element; the gradients and the update are each held here).
At (1, 2, 2) the paired, token-weighted, remat case is also held to the
JAX sharded step on the 8-device virtual CPU mesh (`make_dpo_train_step`
under `create_mesh(1, 2, 2)`, `shard_params`, `shard_batch`): every step's
metrics from the whole step, and, from its two halves run sharded on the
mesh run's parameters, every step's gradients and the parameters after
the JAX update fed the mesh run's gradients, at the same tolerances.
LoRA: the adapters are identical on every rank and match
the one-process adapters. DPOTrainer.train with gradient accumulation 2
writes the one-process run's metrics.jsonl at (1, 2, 1) and at (1, 2, 2)
(there the tp ranks' copies of the weights tp leaves whole stay bit for
bit alike); the (1, 2, 1) checkpoint
resumes at world 2 and at world 1 to the saved state bit for bit and on
to the same metrics. The QLoRA config's mesh (1 x 1 x 1) refuses a world of
2 with a ValueError naming the fields (a deliberate difference from JAX).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.parallel import sharding as jsh
from rlaifv_tpu.train import train_step as jts
from rlaifv_tpu_torch.core.config import Config
from rlaifv_tpu_torch.data.collator import DPOCollator
from rlaifv_tpu_torch.models.convert import _torch_name, llava_params_from_jax, load_jax_params
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.models.omnilmm import (
    OmniLMMConfig,
    OmniLMMForCausalLM,
    init_omnilmm_weights_,
)
from rlaifv_tpu_torch.train import train_step as tts
from rlaifv_tpu_torch.train.lora import attach_lora, lora_init, lora_scaled
from rlaifv_tpu_torch.train.trainer import DPOTrainer
from rlaifv_tpu_torch.utils.synth import synth_omni_preference_pairs, synth_preference_pairs

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from torch_mesh_worker import build  # noqa: E402

WORKER = ROOT / "tests" / "torch_mesh_worker.py"
TIMEOUT = 300
LOSS_ATOL, METRIC_RTOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5
LR, STEPS, MAX_LEN = 1e-3, 3, 64

CASES = {  # hyper-parameters; "remat": activation checkpointing around every
    # block; "fuse": one qkv_proj and one gate_up_proj a layer
    "plain-sft": dict(beta=0.1, sft_weight=0.3),
    "paired-token-weighted-remat": dict(beta=0.1, dpo_token_weighted=True,
                                        shared_prefix_len="P", remat=True),
    "fused-projections": dict(beta=0.1, shared_prefix_len="P", fuse=True),
    # MultiSteps(k=2) over the sharded optimizer: the update clips by the
    # norm of the accumulated mean over the whole mesh
    "plain-sft-accum2": dict(beta=0.1, sft_weight=0.3, accum=2),
}
# both first cases at (1, 2, 2), one each at (1, 2, 1) and (2, 2, 1); at
# tp 2 each fused projection splits part by part; at tp 4 the tiny Llama's
# 2 KV heads do not split, so its attention takes the gathered route
# (column outputs all-gathered, the o projection's input sliced) while the
# MLP stays local
STEP_RUNS = [((1, 2, 1), "paired-token-weighted-remat"), ((2, 2, 1), "plain-sft"),
             ((1, 2, 2), "plain-sft"), ((1, 2, 2), "paired-token-weighted-remat"),
             ((1, 1, 2), "fused-projections"), ((1, 1, 4), "plain-sft"),
             ((1, 2, 2), "plain-sft-accum2")]
LORA_MESHES = [(1, 2, 1), (1, 2, 2)]
TRAINING = dict(per_device_batch_pairs=2, gradient_accumulation=2, learning_rate=LR,
                save_steps=100, logging_steps=1, seed=0, mesh_dp=1, mesh_fsdp=None,
                mesh_tp=1, warmup_ratio=0.0)
TRAINING_CLIP = Config().training.max_grad_norm


def _name(mesh, case):
    return f"step_{''.join(map(str, mesh))}_{case}"


def _hp(case, batch, n_img):
    kw = dict(CASES[case])
    for key in ("remat", "fuse", "accum"):
        kw.pop(key, None)
    if kw.get("shared_prefix_len") == "P":
        kw["shared_prefix_len"] = tts.derive_shared_prefix_len(batch, n_img)
        assert kw["shared_prefix_len"] > 0
    return kw


def _accum(case):
    return CASES[case].get("accum", 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, inputs, out):
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, str(WORKER), str(inputs), str(out)], cwd=ROOT,
                             env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def setup():
    jcfg = JLlavaConfig.tiny()
    cfg = LlavaConfig.tiny()
    coll = DPOCollator(pad_token_id=0, max_len=MAX_LEN, num_patches=cfg.num_image_tokens)
    batch = coll(synth_preference_pairs(cfg, 4, answer_len=6, question_len=4, seed=3))
    rng = np.random.default_rng(5)
    B, L = batch["win_labels"].shape
    for side in ("win", "rej"):
        batch[f"ref_{side}_per_token_logp"] = rng.normal(-2, 0.5, (B, L - 1)).astype(np.float32)
    jparams = JLlava(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"][:2]),
        images=jnp.asarray(batch["images"][:2]),
        image_starts=jnp.asarray(batch["image_starts"][:2]))["params"]
    llava = load_jax_params(LlavaForCausalLM(cfg), jparams).state_dict()

    ocfg = OmniLMMConfig.tiny()
    omni = init_omnilmm_weights_(OmniLMMForCausalLM(ocfg),
                                 torch.Generator().manual_seed(0)).state_dict()
    ocoll = DPOCollator(pad_token_id=0, max_len=MAX_LEN, num_patches=ocfg.num_image_tokens,
                        expand_images=False, image_patch_id=250)
    obatch = ocoll(synth_omni_preference_pairs(ocfg, 4, answer_len=6, question_len=4))
    return dict(jparams=jparams, jcfg=jcfg, llava=llava, omnilmm=omni, batch=batch,
                obatch=obatch, n_img=cfg.num_image_tokens,
                pairs=synth_preference_pairs(cfg, 8, answer_len=6, question_len=4))


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Both worlds spawned at once; -> the output dir."""
    out = tmp_path_factory.mktemp("mesh")
    s = setup
    step = lambda mesh, case: dict(  # noqa: E731
        kind="step", name=_name(mesh, case), family="llava15", mesh=mesh, lr=LR,
        steps=STEPS * _accum(case), batch=s["batch"], hp=_hp(case, s["batch"], s["n_img"]),
        remat=CASES[case].get("remat", False), fuse=CASES[case].get("fuse", False),
        accum=_accum(case))
    lora = lambda mesh: dict(  # noqa: E731
        kind="lora", name=f"lora_{''.join(map(str, mesh))}", family="llava15", mesh=mesh,
        lr=LR, steps=STEPS, batch=s["batch"], hp=dict(beta=0.1, sft_weight=0.3))
    qlora = Config.from_json(str(ROOT / "configs" / "llava15_dpo_qlora.json")).training
    trainer = dict(family="llava15", pairs=s["pairs"], max_len=MAX_LEN)
    jobs = {2: [step(m, c) for m, c in STEP_RUNS if np.prod(m) == 2]
            + [dict(kind="step", name="omni_121", family="omnilmm", mesh=(1, 2, 1), lr=LR,
                    steps=STEPS, batch=s["obatch"], hp=dict(beta=0.1, sft_weight=0.3)),
               lora((1, 2, 1)),
               dict(trainer, kind="trainer", name="trainer", training=TRAINING,
                    stop_at=2, max_steps=4),
               dict(trainer, kind="refuse", name="refuse",
                    training={k: getattr(qlora, k) for k in ("mesh_dp", "mesh_fsdp",
                                                             "mesh_tp")})],
            4: [step(m, c) for m, c in STEP_RUNS if np.prod(m) == 4] + [lora((1, 2, 2))]
            + [dict(trainer, kind="train", name="trainer_122",
                    training=dict(TRAINING, mesh_tp=2), max_steps=2)]}
    inputs = out / "inputs.pt"
    torch.save({"jobs": jobs, "llava15": s["llava"], "omnilmm": s["omnilmm"]}, inputs)
    procs = _spawn(2, inputs, out) + _spawn(4, inputs, out)
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
    return out


def _load(out, name, rank=0):
    return torch.load(out / f"{name}.rank{rank}.pt", weights_only=False)


def _close(got, want, atol, rtol, what):
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {n}")


def _check_against_one_process(family, state, batch, hp, res, remat=False, fuse=False,
                               accum=1):
    """The one-process step at every (micro-)step, its optimizer fed the
    mesh run's gradients."""
    model, adapter = build(family, state, remat, fuse)
    named = list(model.named_parameters())
    opt = tts.make_optimizer(model, LR, total_steps=10)
    if accum > 1:
        opt = tts.MultiSteps(opt, accum)
    b = tts.batch_to_device(batch, "cpu")
    for s in range(STEPS * accum):
        model.zero_grad(set_to_none=False)
        loss, metrics = tts.dpo_loss_from_batch(adapter, b, tts.DPOHparams(**hp))
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in named}
        metrics["grad_norm"] = tts.global_norm(grads.items())
        _close(res["metrics"][s], {k: float(v) for k, v in metrics.items()},
               LOSS_ATOL, METRIC_RTOL, f"step {s} metric")
        _close(res["grads"][s], grads, GRAD_ATOL, GRAD_RTOL, f"step {s} grad")
        opt.step([res["grads"][s][n] for n, _ in named])
        _close(res["params"][s], {n: p.detach() for n, p in named},
               PARAM_ATOL, PARAM_RTOL, f"step {s} param")


@pytest.mark.parametrize("mesh,case", STEP_RUNS, ids=[_name(m, c) for m, c in STEP_RUNS])
def test_sharded_step_matches_one_process(setup, runs, mesh, case):
    res = _load(runs, _name(mesh, case))
    assert len(res["metrics"]) == STEPS * _accum(case)
    _check_against_one_process("llava15", setup["llava"], setup["batch"],
                               _hp(case, setup["batch"], setup["n_img"]), res,
                               CASES[case].get("remat", False), CASES[case].get("fuse", False),
                               _accum(case))


def test_omnilmm_sharded_step_matches_one_process(setup, runs):
    _check_against_one_process("omnilmm", setup["omnilmm"], setup["obatch"],
                               dict(beta=0.1, sft_weight=0.3), _load(runs, "omni_121"))


def _to_flax(like, tensors):
    """A port state (torch names, (out, in) weights) as a flax tree shaped
    like `like`: the bridge of models/convert.py run backwards."""
    def leaf(path, val):
        dotted = ".".join(k.key for k in path)
        t = np.asarray(tensors[_torch_name(dotted)], dtype=np.float32)
        if dotted.endswith(".kernel"):
            t = t.T.reshape(val.shape)
        return jnp.asarray(t)

    return jax.tree_util.tree_map_with_path(leaf, like)


@pytest.mark.parametrize("case", ["paired-token-weighted-remat"])
def test_tp_step_matches_the_jax_sharded_step(setup, runs, case):
    """The whole JAX step (`make_dpo_train_step` under create_mesh(1, 2, 2))
    gives every step's metrics. Its two halves, run sharded on the mesh
    run's parameters of each step, hold the rest: the loss's value and
    gradient, and the update fed the mesh run's gradients (the optimizer
    state carried), against the mesh run's gradients and parameters."""
    res = _load(runs, _name((1, 2, 2), case))
    hp = jts.DPOHparams(**_hp(case, setup["batch"], setup["n_img"]))
    adapter = jts.LlavaDPOAdapter(JLlava(setup["jcfg"]))
    opt = jts.make_optimizer(LR, total_steps=10)
    step_fn = jax.jit(jts.make_dpo_train_step(adapter, opt, hp))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jts.dpo_loss_from_batch(adapter, p, b, hp), has_aux=True))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    mesh = jsh.create_mesh(dp=1, fsdp=2, tp=2)
    like = setup["jparams"]
    with mesh:
        params = jsh.shard_params(like, mesh)
        sb = jsh.shard_batch(setup["batch"], mesh)
        state = jts.DPOTrainState(jnp.int32(0), params, opt.init(params))
        opt_state = opt.init(params)
        for s in range(STEPS):
            state, metrics = step_fn(state, sb)
            _close(res["metrics"][s], {k: float(v) for k, v in metrics.items()},
                   LOSS_ATOL, METRIC_RTOL, f"step {s} metric")
            if s:
                params = jsh.shard_params(_to_flax(like, res["params"][s - 1]), mesh)
            (_, metrics), grads = grad_fn(params, sb)
            metrics["grad_norm"] = optax.global_norm(grads)
            _close(res["metrics"][s], {k: float(v) for k, v in metrics.items()},
                   LOSS_ATOL, METRIC_RTOL, f"step {s} metric of the halves")
            _close(res["grads"][s], llava_params_from_jax(jax.device_get(grads)),
                   GRAD_ATOL, GRAD_RTOL, f"step {s} grad")
            mesh_grads = jsh.shard_params(_to_flax(like, res["grads"][s]), mesh)
            params, opt_state = update(mesh_grads, opt_state, params)
            _close(res["params"][s], llava_params_from_jax(jax.device_get(params)),
                   PARAM_ATOL, PARAM_RTOL, f"step {s} param")


@pytest.mark.parametrize("mesh", LORA_MESHES, ids=lambda m: "".join(map(str, m)))
def test_lora_adapters_agree_across_ranks_and_with_one_process(setup, runs, mesh):
    name = f"lora_{''.join(map(str, mesh))}"
    ranks = [_load(runs, name, r) for r in range(int(np.prod(mesh)))]
    for r in ranks[1:]:
        for s in range(STEPS):
            for n, t in ranks[0]["lora"][s].items():
                assert torch.equal(r["lora"][s][n], t), (s, n)
    model, adapter = build("llava15", setup["llava"])
    model.requires_grad_(False)
    lora = lora_init(torch.Generator().manual_seed(0), model, r=4)
    named = tts.named_tensors(lora)
    for _, t in named:
        t.requires_grad_(True)
    opt = tts.make_optimizer(lora, LR, total_steps=10)
    b = tts.batch_to_device(setup["batch"], "cpu")
    for s in range(STEPS):
        for _, t in named:
            t.grad = None
        attach_lora(model, lora_scaled(lora))
        loss, metrics = tts.dpo_loss_from_batch(adapter, b, tts.DPOHparams(beta=0.1,
                                                                            sft_weight=0.3))
        loss.backward()
        attach_lora(model, None)
        grads = {n: t.grad.clone() for n, t in named}
        metrics["grad_norm"] = tts.global_norm(grads.items())
        _close(ranks[0]["metrics"][s], {k: float(v) for k, v in metrics.items()},
               LOSS_ATOL, METRIC_RTOL, f"step {s} metric")
        _close(ranks[0]["grads"][s], grads, GRAD_ATOL, GRAD_RTOL, f"step {s} grad")
        opt.step([ranks[0]["grads"][s][n] for n, _ in named])
        _close(ranks[0]["lora"][s], {n: t.detach() for n, t in named},
               PARAM_ATOL, PARAM_RTOL, f"step {s} adapter")


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close_logs(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "steps_per_sec":
                assert abs(g[k] - w[k]) <= LOSS_ATOL + METRIC_RTOL * abs(w[k]), \
                    (g["step"], k, g[k], w[k])


def _one_process_trainer(setup, output_dir, max_steps):
    config = Config()
    for key, val in TRAINING.items():
        setattr(config.training, key, val)
    config.training.per_device_batch_pairs *= 2  # the world-2 run's global batch
    config.training.output_dir = str(output_dir)
    config.training.max_steps = max_steps
    model, adapter = build("llava15", setup["llava"])
    coll = DPOCollator(pad_token_id=0, max_len=MAX_LEN, num_patches=setup["n_img"])
    return DPOTrainer(config, model, setup["pairs"], coll, adapter=adapter)


@pytest.fixture(scope="module")
def one_process_log(setup, tmp_path_factory):
    """The one-process trainer's metrics.jsonl: two updates of two
    micro-batches over the world-2 run's global batch."""
    out = tmp_path_factory.mktemp("one_process")
    _one_process_trainer(setup, out, 2).train()
    return _metrics(out / "metrics.jsonl")


def test_trainer_over_two_processes_writes_the_one_process_metrics(runs, one_process_log):
    got = _metrics(runs / "trainer_first" / "metrics.jsonl")
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    _close_logs(got, one_process_log)


def test_trainer_over_a_tp_mesh_with_accumulation_writes_the_one_process_metrics(
        runs, one_process_log):
    """(1, 2, 2) from training.mesh_tp 2 over 4 processes, gradient
    accumulation 2: the same global batch, so the same log. The update
    clips by the accumulated mean's norm over the whole mesh (a norm over
    this rank's tp slices alone would shrink the update and split the tp
    ranks' copies of the whole weights apart): the two tp ranks of each
    fsdp index hold those weights' shards bit for bit alike."""
    got = _metrics(runs / "trainer_122" / "metrics.jsonl")
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    assert min(r["grad_norm"] for r in got) > TRAINING_CLIP  # the micro-batches clip
    _close_logs(got, one_process_log)
    ranks = [_load(runs, "trainer_122", r)["whole_over_tp"] for r in range(4)]
    assert ranks[0]
    for a, b in ((0, 1), (2, 3)):  # rank = fsdp * 2 + tp
        for n, t in ranks[a].items():
            assert torch.equal(ranks[b][n], t), (a, b, n)


def test_world_two_checkpoint_resumes_at_world_one_and_two(setup, runs, tmp_path):
    res = _load(runs, "trainer")
    assert res["resume_exact"] and res["start"] == 4 and res["steps"] == 8
    shutil.copytree(runs / "trainer_first", tmp_path, dirs_exist_ok=True)
    tr = _one_process_trainer(setup, tmp_path, 4)
    assert tr.start_step == 4
    restored, state = tr.ckpt.restore(), tr._state_tree()
    for key in ("params",):
        for n, t in restored[key].items():
            assert torch.equal(state[key][n], t), n
    for key in ("mu", "nu"):
        for n, t in restored["opt_state"]["inner"][key].items():
            assert torch.equal(state["opt_state"]["inner"][key][n], t), n
    tr.train()
    want = [r for r in _metrics(tmp_path / "metrics.jsonl") if r["step"] > 4]
    got = [r for r in _metrics(runs / "trainer_resumed" / "metrics.jsonl") if r["step"] > 4]
    assert [r["step"] for r in got] == [5, 6, 7, 8]
    _close_logs(got, want)


def test_qlora_config_mesh_refuses_two_processes(runs):
    err = _load(runs, "refuse")["error"]
    assert err and "training.mesh_fsdp=1" in err and "2 processes" in err
