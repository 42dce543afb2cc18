# A copy of rlaifv_tpu/pairs/construction.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Preference-pair candidate construction from autocheck fact scores.

Rebuild of the scoring core (ref: utils/pair_construction.py:1-117):
- per-fact yes/no probabilities -> binary label (p(yes)+p(Yes) > p(no)+p(No))
- answer score = sum(labels) - #facts  (== -#wrong-facts, :105)
- answers grouped by 'ds_question_id@origin_question'
- every C(n,2) combination with |score diff| >= diff becomes a
  (chosen, rejected) candidate (:36-79).
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def fact_label(scores: Dict[str, float]) -> int:
    yes = scores.get("yes", 0.0) + scores.get("Yes", 0.0)
    no = scores.get("no", 0.0) + scores.get("No", 0.0)
    return int(yes > no)


def answer_scores(
    fact_rows: Sequence[dict],
) -> Tuple[Dict, Dict, List[dict]]:
    """fact rows -> (answer_id -> score, answer_id -> {fact: '0'/'1'},
    rows with pred_label attached)."""
    labels_by_answer: Dict = defaultdict(list)
    judge_by_answer: Dict = defaultdict(dict)
    annotated = []
    for row in fact_rows:
        row = dict(row)
        label = fact_label(row["scores"])
        row["pred_label"] = label
        annotated.append(row)
        qid = row["question_id"]
        labels_by_answer[qid].append(label)
        fact_q = row.get("raw_question", row.get("question"))
        judge_by_answer[qid][fact_q] = "1" if label else "0"
    scores = {
        qid: sum(labels) - len(labels)
        for qid, labels in labels_by_answer.items()
    }
    return scores, dict(judge_by_answer), annotated


def group_answers_by_instruction(fact_rows: Sequence[dict]) -> Dict[str, List]:
    """'dsid@origin_question' -> unique answer question_ids (:22-33)."""
    groups: Dict[str, list] = defaultdict(list)
    for row in fact_rows:
        meta = row["metainfos"]
        ds_id = meta.get("ds_question_id", row.get("ds_question_id"))
        origin_q = meta["metainfos"]["origin_question"]
        groups[f"{ds_id}@{origin_q}"].append(row["question_id"])
    return {k: list(set(v)) for k, v in groups.items()}


def make_pair(a: dict, b: dict, diff: float) -> Optional[dict]:
    """Orientation + threshold (:36-48)."""
    delta = a["score"] - b["score"]
    if abs(delta) < diff:
        return None
    chosen, rejected = (a, b) if delta > 0 else (b, a)
    return {"chosen": chosen, "rejected": rejected}


def build_pairs(
    fact_rows: Sequence[dict], diff: float = 1, return_infos: bool = False
):
    """All qualifying (chosen, rejected) id pairs per instruction group."""
    scores, judges, annotated = answer_scores(fact_rows)
    groups = group_answers_by_instruction(fact_rows)

    pair_data = []
    for key, answer_ids in groups.items():
        for qa, qb in itertools.combinations(answer_ids, 2):
            pair = make_pair(
                {"question_id": qa, "score": scores[qa]},
                {"question_id": qb, "score": scores[qb]},
                diff,
            )
            if pair is not None:
                pair_data.append({
                    "ds_question_id": key,
                    "chosen": pair["chosen"],
                    "rejected": pair["rejected"],
                })
    if return_infos:
        return pair_data, judges, annotated
    return pair_data
