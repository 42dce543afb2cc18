# A copy of rlaifv_tpu/evals/refomb.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""RefoMB: pairwise GPT-4 judgment vs GPT-4V with hallucination counting.

Rebuild of ref eval/eval_RefoMB_p0.py (judge system prompt loaded verbatim
from data/refomb_judge_prompt.txt :14-17; [[A]]/[[B]]/[[C]] verdict
:45-56), the category win-rate report of eval/json_to_excel.py:8-17, and
the hallucination-only re-judge (`judge_hallucination` /
`summarize_hallucination`, ref eval/eval_hallucination.py:16-56,168-173:
the first pass's review text is re-judged for "which model has fewer
hallucinations" and scored as mean((score+1)/2)).
"""
from __future__ import annotations

import os
import random
import re
from concurrent.futures import ThreadPoolExecutor
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

from rlaifv_tpu_torch.evals.gpt_client import FAIL_SENTINEL, Chat
from rlaifv_tpu_torch.utils.file_io import read_jsonlines

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

CATEGORIES = [
    "Description-Simple", "Description-Complex",
    "Recognition-Simple", "Recognition-Complex",
    "Reasoning-Simple", "Reasoning-Complex",
    "Perception-Simple", "Perception-Complex",
]


def load_system_msg() -> str:
    with open(os.path.join(DATA_DIR, "refomb_judge_prompt.txt")) as f:
        return f.read()


def load_dev_set() -> List[dict]:
    return read_jsonlines(os.path.join(DATA_DIR, "RefoMB_dev.jsonl"))


def load_gpt4v_answers() -> List[dict]:
    return read_jsonlines(os.path.join(DATA_DIR, "gpt4v_RefoMB_dev_0521.jsonl"))


def build_query(
    question: str, description: str, answer_a: str, answer_b: str
) -> str:
    """Judge prompt body (ref construct_gpt4_query :22-44)."""
    system = load_system_msg()
    return f"""
    {system}

    [Beginning of the detailed description of the picture]
    {description}
    [End of the detailed description of the picture]

    [Beginning of the user's question]
    {question}
    [End of the user's question]

    [Beginning of Model A's answer]
    {answer_a}
    [End of Model A's answer]

    [Beginning of Model B's answer]
    {answer_b}
    [End of Model B's answer]
    """


def parse_verdict(output: str) -> Tuple[int, str]:
    """[[A]] -> -1, [[B]] -> +1, [[C]] -> 0 (ref post_process :47-58)."""
    match = re.findall(r"\[\[(A|B|C)\]\]", output)
    if not match:
        raise ValueError("no verdict marker in judge output")
    return {"A": -1, "B": 1, "C": 0}[match[0]], output


def judge_pairwise(
    items: Sequence[dict],
    chat: Optional[Chat] = None,
    max_workers: int = 32,
    seed: int = 0,
) -> List[dict]:
    """items: {'question','description','model_answer','baseline_answer',
    'type_name'}. Sides are randomized per item; 'model_is_A' records the
    assignment so scores can be oriented."""
    chat = chat or Chat(model="gpt-4-1106-preview")
    rng = random.Random(seed)
    assignments = [rng.random() < 0.5 for _ in items]

    def one(args):
        item, model_is_a = args
        a = item["model_answer"] if model_is_a else item["baseline_answer"]
        b = item["baseline_answer"] if model_is_a else item["model_answer"]
        prompt = build_query(item["question"], item["description"], a, b)
        text, _ = chat.chat_completion(
            [{"role": "user", "content": prompt}], temperature=0
        )
        row = dict(item)
        row["model_is_A"] = model_is_a
        row["judge_output"] = text
        if text == FAIL_SENTINEL:
            row["score"] = None
        else:
            try:
                raw, _ = parse_verdict(text)
                # orient: positive = our model wins
                row["score"] = -raw if model_is_a else raw
            except ValueError:
                row["score"] = None
        return row

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, zip(items, assignments)))


def load_hallucination_msg() -> str:
    with open(os.path.join(DATA_DIR, "refomb_hallucination_prompt.txt")) as f:
        return f.read()


def build_hallucination_query(review_text: str) -> str:
    """Re-judge prompt body (ref eval_hallucination.py:33-42)."""
    system = load_hallucination_msg()
    return f"""
    {system}

    [Beginning of the review text]
    {review_text}
    [End of the review text]

    """


def judge_hallucination(
    rows: Sequence[dict],
    chat: Optional[Chat] = None,
    max_workers: int = 32,
) -> List[dict]:
    """Second RefoMB pass (ref eval/eval_hallucination.py:16-56): each
    first-pass review text is re-judged for which model has FEWER
    hallucinations only. Rows are `judge_pairwise` outputs; the oriented
    `hall_score` is positive when our model hallucinates less (the review
    text names sides A/B, so orientation reuses each row's `model_is_A`).
    """
    chat = chat or Chat(model="gpt-4-1106-preview")

    def one(row):
        out = dict(row)
        review = row.get("judge_output")
        if review is None or review == FAIL_SENTINEL:
            out["hall_score"] = None
            return out
        prompt = build_hallucination_query(review)
        text, _ = chat.chat_completion(
            [{"role": "user", "content": prompt}], temperature=0
        )
        out["hall_judge_output"] = text
        if text == FAIL_SENTINEL:
            out["hall_score"] = None
        else:
            try:
                raw, _ = parse_verdict(text)
                out["hall_score"] = -raw if row.get("model_is_A") else raw
            except ValueError:
                out["hall_score"] = None
        return out

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, rows))


def summarize_hallucination(rows: Sequence[dict]) -> dict:
    """Hallucination score = mean((score+1)/2): 1.0 when our model always
    has fewer hallucinations, ties count 0.5 (ref eval_hallucination.py:
    168-173)."""
    scored = [r for r in rows if r.get("hall_score") is not None]
    per_cat = defaultdict(list)
    for r in scored:
        per_cat[r.get("type_name", "unknown")].append(
            (r["hall_score"] + 1) / 2.0
        )
    return {
        "total": len(scored),
        "skipped": len(rows) - len(scored),
        "hallucination_score": (
            sum((r["hall_score"] + 1) / 2.0 for r in scored)
            / max(len(scored), 1)
        ),
        "per_category": {
            cat: sum(v) / len(v) for cat, v in sorted(per_cat.items())
        },
    }


def summarize(rows: Sequence[dict]) -> dict:
    """Win/tie/loss overall + per category (ref json_to_excel.py:8-66)."""
    win = defaultdict(int)
    tie = defaultdict(int)
    loss = defaultdict(int)
    skipped = 0
    for row in rows:
        cat = row.get("type_name", "unknown")
        if row["score"] is None:
            skipped += 1
        elif row["score"] > 0:
            win[cat] += 1
        elif row["score"] == 0:
            tie[cat] += 1
        else:
            loss[cat] += 1
    total = sum(win.values()) + sum(tie.values()) + sum(loss.values())
    w, t = sum(win.values()), sum(tie.values())
    return {
        "total": total,
        "skipped": skipped,
        "win_rate": w / max(total, 1),
        "tie_rate": t / max(total, 1),
        # trustworthiness-style score: win=1, tie=0.5
        "overall_score": (w + 0.5 * t) / max(total, 1),
        "per_category": {
            cat: {"win": win[cat], "tie": tie[cat], "loss": loss[cat]}
            for cat in sorted(set(win) | set(tie) | set(loss))
        },
    }
