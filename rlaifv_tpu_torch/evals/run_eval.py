# A copy of scripts/run_eval.py over rlaifv_tpu_torch, function for function
# and under the same names: the port keeps its own copy and imports nothing
# of the JAX package.
"""Evaluation orchestrator (replaces script/eval/*.sh) on the port.

    python -m rlaifv_tpu_torch.evals.run_eval {objhal,mmhal,refomb} \
        --answers a.jsonl --out-dir out [--coco-path coco] [--no-gpt]

Chains the judging of answer files (from `python -m
rlaifv_tpu_torch.evals.vqa`) -> GPT judge -> summary, for Object HalBench /
MMHal / RefoMB (ref: script/eval/eval_rlaifv_objhal.sh:36-71,
eval_rlaifv_mmhal.sh). No model runs here: Object HalBench with --no-gpt
is offline; MMHal and RefoMB call the judge through
evals/gpt_client.py's transport.
"""
from __future__ import annotations

import argparse
import json
import os

from rlaifv_tpu_torch.utils.file_io import (
    read_json_or_jsonlines,
    read_jsonlines,
    write_json,
    write_jsonlines,
)


def eval_objhal(answers_path: str, coco_path: str, out_dir: str,
                use_gpt: bool = True, gpt_model: str = "gpt-3.5-turbo-0613"):
    from rlaifv_tpu_torch.evals.gpt_client import Chat
    from rlaifv_tpu_torch.evals.object_halbench import evaluate
    from rlaifv_tpu_torch.evals.summaries import chair_summary

    rows = read_jsonlines(answers_path)
    answers = [
        {
            "image_id": r.get("image_id", r.get("question_id")),
            "question": r.get("prompt", r.get("question", "")),
            "caption": r.get("text", r.get("answer", "")),
        }
        for r in rows
    ]
    result = evaluate(
        answers, coco_path,
        chat=Chat(model=gpt_model) if use_gpt else None,
        use_gpt=use_gpt,
    )
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "hall_obj_halbench_answer.json")
    write_json(out, result)
    print(json.dumps(chair_summary(result["overall_metrics"]), indent=2))
    return out


def eval_mmhal(answers_path: str, out_dir: str,
               gpt_model: str = "gpt-4-1106-preview"):
    from rlaifv_tpu_torch.evals.gpt_client import Chat
    from rlaifv_tpu_torch.evals.mmhal import judge, load_answer_template, summarize

    template = load_answer_template()
    model_answers = read_json_or_jsonlines(answers_path)
    by_id = {
        r.get("question_id", i): r.get("text", r.get("model_answer", ""))
        for i, r in enumerate(model_answers)
    }
    rows = [
        dict(t, model_answer=by_id.get(i, "")) for i, t in enumerate(template)
    ]
    responses = judge(rows, chat=Chat(model=gpt_model))
    os.makedirs(out_dir, exist_ok=True)
    write_json(os.path.join(out_dir, "mmhal_review.json"), responses)
    summary = summarize(responses)
    print(json.dumps({k: v for k, v in summary.items() if k != "scores"},
                     indent=2))
    return summary


def eval_refomb(answers_path: str, out_dir: str,
                gpt_model: str = "gpt-4-1106-preview", seed: int = 0):
    from rlaifv_tpu_torch.evals.gpt_client import Chat
    from rlaifv_tpu_torch.evals.refomb import (
        judge_hallucination,
        judge_pairwise,
        load_dev_set,
        load_gpt4v_answers,
        summarize,
        summarize_hallucination,
    )

    dev = load_dev_set()
    gpt4v = {r.get("image_id", i): r for i, r in enumerate(load_gpt4v_answers())}
    model_answers = read_json_or_jsonlines(answers_path)
    items = []
    for i, (ref_row, ans) in enumerate(zip(dev, model_answers)):
        base = gpt4v.get(ref_row.get("image_id", i), {})
        items.append({
            "question": ref_row.get("question", ""),
            "description": ref_row.get("description",
                                       ref_row.get("reference", "")),
            "model_answer": ans.get("text", ans.get("answer", "")),
            "baseline_answer": base.get("answer", base.get("text", "")),
            "type_name": ref_row.get(
                "type_name", ref_row.get("type", "unknown")
            ),
        })
    chat = Chat(model=gpt_model)
    rows = judge_pairwise(items, chat=chat, seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    write_jsonlines(os.path.join(out_dir, "refomb_reviews.jsonl"), rows)
    # second pass (ref eval_hallucination.py): re-judge each review for
    # hallucination count only
    hall_rows = judge_hallucination(rows, chat=chat)
    write_jsonlines(
        os.path.join(out_dir, "refomb_reviews.hall.jsonl"), hall_rows
    )
    summary = {
        "pairwise": summarize(rows),
        "hallucination": summarize_hallucination(hall_rows),
    }
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("benchmark", choices=["objhal", "mmhal", "refomb"])
    ap.add_argument("--answers", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--coco-path", default=None)
    ap.add_argument("--gpt-model", default=None)
    ap.add_argument("--no-gpt", action="store_true")
    args = ap.parse_args(argv)

    if args.benchmark == "objhal":
        eval_objhal(args.answers, args.coco_path, args.out_dir,
                    use_gpt=not args.no_gpt,
                    gpt_model=args.gpt_model or "gpt-3.5-turbo-0613")
    elif args.benchmark == "mmhal":
        eval_mmhal(args.answers, args.out_dir,
                   gpt_model=args.gpt_model or "gpt-4-1106-preview")
    else:
        eval_refomb(args.answers, args.out_dir,
                    gpt_model=args.gpt_model or "gpt-4-1106-preview")


if __name__ == "__main__":
    main()
