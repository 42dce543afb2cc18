"""Iterative RLAIF-V alignment driver on the port (the reference's x4
protocol, codified).

    python -m rlaifv_tpu_torch.iteration --config cfg.json --ques-file q.jsonl \
        --eval-file eval.jsonl --coco-path coco --divide-model <llama3> \
        --work-dir work [--device cpu]

Counterpart of scripts/run_iteration.py over rlaifv_tpu_torch, function for
function: the reference runs its iterations by hand (generate preference
data with the current policy, train DPO, score every saved checkpoint on
Object HalBench, and use "the best-performing checkpoint as the base model
of the next training iteration", ref README.md:205-221). Here:

  for it in 1..N:
    (1) data pipeline with the CURRENT policy     pipeline.run_pipeline
    (2) ref-logp precompute (frozen current policy), parquet cache contract
        (skip-if-exists, like muffin/data/datasets.py:35-48)
    (3) DPO training (checkpoints every save_steps)
    (4) eval answers per checkpoint -> score_answers -> pick the best
    (5) promote the best checkpoint's weights as the next iteration's policy

Every stage is resume-by-file: a finished iteration leaves summary.json and
is skipped on re-run (its promoted weights restored from the recorded best
checkpoint). Components are injected (generator factory, labeler, fact
backends, scorer), as in the JAX driver.

The port's model holds its weights: training updates it in place, so the
generator factory takes the model (the JAX one takes a params tree), and
the promoted policy is the model with the best checkpoint's weights loaded;
the driver returns that state dict (on the CPU). Checkpoints are the port's
(core/checkpoint.py); a JAX run's do not load here.
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
from typing import Callable, List, Sequence

import torch

from rlaifv_tpu_torch.core.checkpoint import CheckpointManager
from rlaifv_tpu_torch.pipeline import run_pipeline
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_json


def pairs_to_train_rows(pairs: Sequence[dict]) -> List[dict]:
    """Balanced-pair jsonl rows -> RLAIFVDataset parquet schema rows
    (question/chosen/rejected/image{bytes,path}/idx/origin_*,
    ref muffin/data/datasets.py:74-91). Images are reloaded from
    image_path, as the reference's training stage does."""
    rows = []
    for i, p in enumerate(pairs):
        with open(p["image_path"], "rb") as f:
            img_bytes = f.read()
        rows.append({
            "idx": str(p.get("idx", i)),
            "question": p["question"],
            "chosen": p["chosen"],
            "rejected": p["rejected"],
            "image": {"bytes": img_bytes, "path": p["image_path"]},
            "image_path": p["image_path"],
            "origin_dataset": p.get("origin_dataset", "rlaifv-iter"),
            "origin_split": p.get("origin_split", "{}"),
        })
    return rows


def _has_logp_parquet(cache_dir: str) -> bool:
    return bool(glob.glob(os.path.join(cache_dir, "*logp*.parquet")))


def _load_state(model, state: dict) -> None:
    """Copy a saved full fine-tune state dict into the model, in place."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(state[name])


def train_iteration(
    config,
    model,
    tokenizer,
    image_processor,
    pairs_path: str,
    iter_dir: str,
    *,
    max_len: int,
    num_patches: int,
    batch_pairs: int = 2,
):
    """Stages (2)+(3) for one iteration: frozen-policy ref-logp parquet
    (reused if present) then DPO training from it, the model trained in
    place. Returns the trainer (its checkpoints hold every saved step)."""
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.data.datasets import DPODataset
    from rlaifv_tpu_torch.train.ref_logp import inference_logp
    from rlaifv_tpu_torch.train.trainer import DPOTrainer

    cache_dir = os.path.join(iter_dir, "logp_cache")
    os.makedirs(cache_dir, exist_ok=True)
    if not _has_logp_parquet(cache_dir):
        rows = pairs_to_train_rows(read_jsonlines(pairs_path))
        model.eval()
        inference_logp(
            rows, model, tokenizer, cache_dir,
            max_len=max_len, num_patches=num_patches,
            batch_pairs=batch_pairs, image_processor=image_processor,
        )
    else:
        print(f"[iterate] reuse logp cache {cache_dir}", flush=True)

    mm_cfg = {
        "is_multimodal": True,
        "image_processor": image_processor,
        "image_token_len": num_patches,
        "use_im_start_end": False,
    }
    dataset = DPODataset(tokenizer, cache_dir, mm_cfg)
    collator = DPOCollator(
        pad_token_id=tokenizer.pad_token_id or 0,
        max_len=max_len, num_patches=num_patches,
    )
    cfg = copy.deepcopy(config)
    cfg.training.output_dir = os.path.join(iter_dir, "train")
    trainer = DPOTrainer(cfg, model, dataset, collator)
    trainer.train()
    model.eval()
    return trainer


def select_best_checkpoint(
    trainer,
    make_generator: Callable,
    eval_rows: Sequence[dict],
    score_answers: Callable[[List[dict]], float],
    *,
    num_beams: int = 1,
    max_new_tokens: int = 64,
    batch_size: int = 8,
):
    """Stage (4): load every saved checkpoint into the model, generate eval
    answers, score (LOWER is better — CHAIRs-style), return (best_step,
    best state dict on the CPU, scores), the best one left loaded. Ties
    break toward the later step (more training)."""
    from rlaifv_tpu_torch.evals.vqa import generate_answers

    model = trainer.model
    scores = {}
    best = (None, None, float("inf"))
    for step in trainer.ckpt.all_steps():
        state = trainer.ckpt.restore(step)
        _load_state(model, state["params"])
        gen = make_generator(model)
        answers = generate_answers(
            gen, list(eval_rows), num_beams=num_beams,
            max_new_tokens=max_new_tokens, batch_size=batch_size,
            model_id=f"step-{step}",
        )
        s = float(score_answers(answers))
        scores[step] = s
        print(f"[iterate] checkpoint {step}: score={s:.4f}", flush=True)
        if s <= best[2]:
            best = (step, state["params"], s)
    assert best[0] is not None, "no checkpoints were saved during training"
    _load_state(model, best[1])
    return best[0], best[1], scores


def run_iterative_alignment(
    config,
    model,
    tokenizer,
    image_processor,
    make_generator: Callable,  # (model) -> generator (policy role)
    divide_backend,
    changeq_backend,
    ques_path: str,
    eval_rows: Sequence[dict],
    score_answers: Callable[[List[dict]], float],
    work_dir: str,
    *,
    labeler=None,  # fixed labeler generator; None = the current policy labels
    iterations: int = 4,
    max_len: int = 2048,
    num_patches: int = 576,
    sample_num: int = 2,
    repeat: int = 10,
    batch_size: int = 8,
    max_tokens: int = 512,
    eval_num_beams: int = 1,
    eval_max_new_tokens: int = 64,
):
    """The full x`iterations` loop on `model` (updated in place). Returns
    (the final policy's state dict, history)."""
    history = []
    params = None
    for it in range(1, iterations + 1):
        iter_dir = os.path.join(work_dir, f"iter{it}")
        os.makedirs(iter_dir, exist_ok=True)
        summary_path = os.path.join(iter_dir, "summary.json")

        if os.path.exists(summary_path):
            # finished iteration: restore its promoted weights and move on
            with open(summary_path) as f:
                summary = json.load(f)
            mgr = CheckpointManager(os.path.join(iter_dir, "train", "checkpoints"))
            params = _restore_params_only(mgr, summary["best_step"])
            _load_state(model, params)
            history.append(summary)
            print(f"[iterate] iter{it} already done "
                  f"(best step {summary['best_step']}) — skipping", flush=True)
            continue

        policy = make_generator(model)
        pairs_path = run_pipeline(
            policy, labeler or policy, divide_backend, changeq_backend,
            ques_path, os.path.join(iter_dir, "results"),
            sample_num=sample_num, repeat=repeat, batch_size=batch_size,
            max_tokens=max_tokens,
        )

        trainer = train_iteration(
            config, model, tokenizer, image_processor,
            pairs_path, iter_dir,
            max_len=max_len, num_patches=num_patches,
        )

        best_step, params, scores = select_best_checkpoint(
            trainer, make_generator, eval_rows, score_answers,
            num_beams=eval_num_beams, max_new_tokens=eval_max_new_tokens,
            batch_size=batch_size,
        )

        summary = {
            "iteration": it,
            "pairs_path": pairs_path,
            "n_pairs": len(read_jsonlines(pairs_path)),
            "best_step": best_step,
            "scores": {str(k): v for k, v in scores.items()},
        }
        write_json(summary_path, summary)
        history.append(summary)
        print(f"[iterate] iter{it} done: best step {best_step} "
              f"score {scores[best_step]:.4f}", flush=True)

    if params is None:
        params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return params, history


def _restore_params_only(mgr, step: int):
    """The weights of a saved trainer state at `step` (the optimizer state
    is not needed to promote a policy)."""
    return mgr.restore(step)["params"]


def chair_scorer(coco_path: str, out_dir: str):
    """score_answers for the CLI: Object HalBench CHAIRs without the GPT
    extractor (lower is better), each scoring's files under out_dir."""
    from rlaifv_tpu_torch.evals.run_eval import eval_objhal
    from rlaifv_tpu_torch.utils.file_io import read_json, write_jsonlines

    calls = [0]

    def score(answers: List[dict]) -> float:
        calls[0] += 1
        d = os.path.join(out_dir, f"score{calls[0]}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "answers.jsonl")
        write_jsonlines(path, answers)
        out = eval_objhal(path, coco_path, d, use_gpt=False)
        return float(read_json(out)["overall_metrics"]["CHAIRs"])

    return score


def main(argv=None):
    ap = argparse.ArgumentParser(description="iterative RLAIF-V alignment on the port")
    ap.add_argument("--config", required=True,
                    help="train config json (model.model_name_or_path: the starting policy)")
    ap.add_argument("--ques-file", required=True)
    ap.add_argument("--eval-file", required=True, help="Object HalBench questions jsonl")
    ap.add_argument("--coco-path", required=True)
    ap.add_argument("--divide-model", required=True)
    ap.add_argument("--changeq-model", default=None)
    ap.add_argument("--labeler-model", default=None)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--eval-num-beams", type=int, default=3)
    ap.add_argument("--eval-max-new-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; no visible card is an error) or cpu")
    args = ap.parse_args(argv)

    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.evals.vqa import load_generator
    from rlaifv_tpu_torch.train.__main__ import resolve_device
    from rlaifv_tpu_torch.genai.divide_conquer import make_llama3_backend
    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.train.family import get_family

    device = resolve_device(args.device, "rlaifv_tpu_torch.iteration")
    config = Config.from_json(args.config)
    path = config.model.model_name_or_path
    policy = load_generator(path, device)
    model, tok = policy.model, policy.tokenizer
    tok.model_max_length = config.data.max_len
    cfg = model.cfg
    labeler = load_generator(args.labeler_model, device) if args.labeler_model else None

    def make_generator(m):
        return Llava15Generator(m, tok, cfg.num_image_tokens,
                                image_size=cfg.vision.image_size, checkpoint_name=path)

    divide = make_llama3_backend(args.divide_model, device=args.device)
    changeq = (make_llama3_backend(args.changeq_model, device=args.device)
               if args.changeq_model else divide)
    _, history = run_iterative_alignment(
        config, model, tok, get_family("llava15").image_processor(cfg.vision.image_size),
        make_generator, divide, changeq,
        args.ques_file, read_jsonlines(args.eval_file),
        chair_scorer(args.coco_path, os.path.join(args.work_dir, "eval")),
        args.work_dir, labeler=labeler, iterations=args.iterations,
        max_len=config.data.max_len, num_patches=cfg.num_image_tokens,
        eval_num_beams=args.eval_num_beams,
        eval_max_new_tokens=args.eval_max_new_tokens,
    )
    print(json.dumps(history, indent=2))


if __name__ == "__main__":
    main()
