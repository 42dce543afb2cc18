# A copy of rlaifv_tpu/evals/summaries.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Benchmark result summarizers (E3/E6 CLI equivalents).

Rebuild of ref eval/summarize_gpt_obj_halbench_review.py:10-62 (walks
hall_obj_halbench*.json checkpoints, prints CHAIR metrics incl. derived
F1s) and the MMHal score printer. Output numbers and derived formulas
match the reference exactly.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict


def chair_summary(metrics: Dict) -> Dict[str, float]:
    """Derived CHAIR report values (ref :38-51 — same F1 formulas)."""
    hall_response = metrics["CHAIRs_refine"] * 100
    obj_hall_rate = metrics["CHAIRi"] * 100
    correct_response = metrics["correct_rate"] * 100
    obj_correct_rate = metrics["object_correct_rate"] * 100
    obj_recall = metrics["obj_rec"] * 100
    coco_sentence_num = metrics["coco_sentence_num"]

    obj_f1 = (
        2 * obj_recall * obj_correct_rate / (obj_recall + obj_correct_rate)
        if obj_recall + obj_correct_rate else 0.0
    )
    res_denom = coco_sentence_num / 3 + correct_response
    res_f1 = (
        2 * (coco_sentence_num / 3) * correct_response / res_denom
        if res_denom else 0.0
    )
    return {
        "response_hall": hall_response,
        "object_hall": obj_hall_rate,
        "response_correct": correct_response,
        "object_correct": obj_correct_rate,
        "object_recall": obj_recall,
        "object_f1": obj_f1,
        "response_f1": res_f1,
        "avg_length": metrics["avg_word_len"],
        "coco_sentence_num": coco_sentence_num,
        "coco_word_count": metrics["coco_word_count"],
        "gt_word_count": metrics["gt_word_count"],
    }


def collect_obj_halbench_reviews(base_dir: str) -> Dict[str, Dict[int, Dict]]:
    """Walk hall_obj_halbench*.json files: model -> step -> metrics
    (ref :14-31; step parsed from 'checkpoint-N' path segments)."""
    patterns = ["*", "*/*", "*/*/*", "*/*/*/*", "*/*/*/*/*"]
    files = sum((glob.glob(os.path.join(base_dir, p)) for p in patterns), [])
    reviews = [
        f for f in files
        if f.endswith(".json") and "hall_obj_halbench" in os.path.basename(f)
    ]
    out: Dict[str, Dict[int, Dict]] = {}
    for path in sorted(reviews):
        data = json.load(open(path))
        parts = path.split("/")
        model = parts[-4] if len(parts) >= 4 else "model"
        step_part = parts[-2] if len(parts) >= 2 else "-1"
        try:
            step = int(step_part.split("-")[-1])
        except ValueError:
            step = -1
        out.setdefault(model, defaultdict(dict))[step] = data["overall_metrics"]
    return out


def print_obj_halbench(base_dir: str) -> None:
    results = collect_obj_halbench_reviews(base_dir)
    for model, by_step in results.items():
        print(f"\n===> {model}")
        for step in sorted(by_step):
            s = chair_summary(by_step[step])
            print(
                f"Response Hall   : {s['response_hall']:.2f}\n"
                f"Object Hall     : {s['object_hall']:.2f}\n\n"
                f"Response Correct: {s['response_correct']:.2f}\n"
                f"Object Correct  : {s['object_correct']:.2f}\n"
                f"Object Recall   : {s['object_recall']:.2f}\n"
                f"Average Length  : {s['avg_length']:.2f}\n"
                f"COCO Sent Number: {s['coco_sentence_num']}\n"
                f"COCO Word Number: {s['coco_word_count']}\n"
                f"GT Word Number  : {s['gt_word_count']}"
            )


if __name__ == "__main__":
    import sys

    print_obj_halbench(sys.argv[1])
