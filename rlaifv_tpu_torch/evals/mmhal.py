# A copy of rlaifv_tpu/evals/mmhal.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""MMHal-Bench: GPT-4 judge on 96 fixed questions (8 types × 12).

Rebuild of ref eval/eval_gpt_mmhal.py (judge prompt is loaded verbatim from
data/mmhal_judge_prompt.txt, extracted from :8-76) and
eval/summarize_gpt_mmhal_review.py:53-85 (average score, hallucination
rate, per-type averages). Response rows must follow the answer template
(data/mmhal-bench_answer_template.json order) — cardinality checked at 96
(ref :138).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from rlaifv_tpu_torch.evals.gpt_client import Chat

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
NUM_QUESTIONS = 96
NUM_TYPES = 8


def load_template() -> str:
    with open(os.path.join(DATA_DIR, "mmhal_judge_prompt.txt")) as f:
        return f.read()


def load_answer_template() -> List[dict]:
    with open(os.path.join(DATA_DIR, "mmhal-bench_answer_template.json")) as f:
        return json.load(f)


def judge(
    records: Sequence[dict],
    chat: Optional[Chat] = None,
    max_workers: int = 8,
) -> List[dict]:
    """records: template rows with 'model_answer' filled in. Returns raw
    OpenAI-response-shaped dicts (summarizer contract, ref :53-60)."""
    assert len(records) == NUM_QUESTIONS, (
        f"MMHal-Bench expects {NUM_QUESTIONS} rows, got {len(records)}"
    )
    chat = chat or Chat(model="gpt-4-1106-preview")
    template = load_template()

    def one(rec):
        prompt = template.format(
            rec["image_content"],
            rec["question"],
            rec["gt_answer"],
            rec["model_answer"],
        )
        text, usage = chat.chat_completion(
            [{"role": "user", "content": prompt}], temperature=0
        )
        return {
            "choices": [{"message": {"content": text}}],
            "usage": usage,
        }

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, records))


def parse_rating(text: str) -> int:
    """'Rating: k' extraction; ambiguous/absent -> 0 (ref summarize :57-69)."""
    found = [s for s in range(7) if f"rating: {s}" in text.lower()]
    return found[0] if len(found) == 1 else 0


def summarize(responses: Sequence[dict]) -> dict:
    scores = [
        parse_rating(r["choices"][0]["message"]["content"]) for r in responses
    ]
    hallucination = [int(s < 3) for s in scores]

    per_type = [[] for _ in range(NUM_TYPES)]
    for i, s in enumerate(scores[:NUM_QUESTIONS]):
        per_type[i % NUM_TYPES].append(s)

    # informativeness folds the hallucination axis out (ref :36-46)
    informativeness = [s - 3 if s >= 3 else s for s in scores]

    return {
        "average_score": float(np.mean(scores)),
        "hallucination_rate": float(np.mean(hallucination)),
        "scores_each_type": [
            float(np.mean(t)) if t else 0.0 for t in per_type
        ],
        "informativeness": float(np.mean(informativeness) / 3 * 100),
        "scores": scores,
    }
