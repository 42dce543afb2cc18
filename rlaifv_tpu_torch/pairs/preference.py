# A copy of rlaifv_tpu/pairs/preference.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Join pair candidates back to full answers, emit training-ready jsonl.

Rebuild of the pair assembly stage (ref: utils/get_preference_pairs.py:
8-188): dedup repeated instructions, join candidate ids to the
divide-and-conquer answer rows with consistency asserts, sample <= N pairs
per instruction, preserve the side-file contract (.addcls / .addfactjudge).
"""
from __future__ import annotations

import argparse
import random
from collections import defaultdict
from typing import List, Sequence, Tuple

from rlaifv_tpu_torch.pairs.construction import build_pairs
from rlaifv_tpu_torch.utils.file_io import (
    read_json_or_jsonlines,
    write_jsonlines,
)


def dedup_instructions(
    answer_rows: Sequence[dict], fact_rows: Sequence[dict]
) -> Tuple[List[dict], List[dict]]:
    """Drop repeated (ds_question_id, raw_question) runs, keeping the first
    contiguous block (ref :9-33)."""
    kept_keys = []
    kept = []
    current = None
    for row in answer_rows:
        key = f"{row['ds_question_id']}@{row['raw_question']}"
        if key == current:
            kept.append(row)
        elif key not in kept_keys:
            kept_keys.append(key)
            current = key
            kept.append(row)
    ids = {row["question_id"] for row in kept}
    return kept, [r for r in fact_rows if r["question_id"] in ids]


def assemble_pairs(
    fact_rows: Sequence[dict],
    answer_rows: Sequence[dict],
    diff: float = 1,
):
    """Returns (pair jsonl rows, judges, annotated fact rows)."""
    answer_rows, fact_rows = dedup_instructions(answer_rows, fact_rows)
    by_id = {row["question_id"]: row for row in answer_rows}
    assert len(by_id) == len(answer_rows), "duplicate question_id in answers"

    candidates, judges, annotated = build_pairs(
        fact_rows, diff=diff, return_infos=True
    )

    pairs = []
    for cand in candidates:
        parts = cand["ds_question_id"].split("@")
        ds_question_id = "@".join(parts[:-1]) if len(parts) > 1 else parts[0]
        chosen = by_id[cand["chosen"]["question_id"]]
        rejected = by_id[cand["rejected"]["question_id"]]

        assert ds_question_id == str(chosen["ds_question_id"])
        assert ds_question_id == str(rejected["ds_question_id"])
        ch_q = chosen.get("question", chosen.get("raw_question"))
        rej_q = rejected.get("question", rejected.get("raw_question"))
        assert ch_q == rej_q, "pair crosses different questions"
        image_path = chosen["metainfos"]["image_path"]
        assert image_path == rejected["metainfos"]["image_path"]

        chosen_judge = judges[cand["chosen"]["question_id"]]
        reject_judge = judges[cand["rejected"]["question_id"]]
        # consistency: every non-empty fact must have a judgment (ref :111-117)
        if len(chosen_judge) != len([f for f in chosen["facts"] if f != ""]):
            continue
        if len(reject_judge) != len([f for f in rejected["facts"] if f != ""]):
            continue

        pairs.append({
            "image_id": image_path.split("/")[-1],
            "image_path": image_path,
            "ds_question_id": ds_question_id,
            "question": ch_q,
            "chosen": chosen["answer"],
            "rejected": rejected["answer"],
            "org_infos": {
                "ds_question_id": ds_question_id,
                "reference": chosen["metainfos"].get("reference", ""),
                "origin_file": chosen["metainfos"].get("origin_file", ""),
                "chosen_infos": {k: chosen[k] for k in ("facts", "changed_facts")
                                 if k in chosen},
                "rejected_infos": {k: rejected[k]
                                   for k in ("facts", "changed_facts")
                                   if k in rejected},
                "scores": {
                    "chosen": {"judge": chosen_judge,
                               "score": str(cand["chosen"]["score"])},
                    "rejected": {"judge": reject_judge,
                                 "score": str(cand["rejected"]["score"])},
                },
            },
        })
    return pairs, judges, annotated, answer_rows


def sample_pairs(pairs: Sequence[dict], sample_num: int, seed=None) -> List[dict]:
    """<= sample_num pairs per instruction (ref :154-168)."""
    rng = random.Random(seed)
    by_dsid = defaultdict(list)
    for p in pairs:
        by_dsid[p["ds_question_id"]].append(p)
    out = []
    for items in by_dsid.values():
        out += rng.sample(items, sample_num) if len(items) >= sample_num else items
    return out


def run(autocheck_path: str, divide_path: str, sample_num: int = 2,
        diff: float = 1) -> None:
    fact_rows = read_json_or_jsonlines(autocheck_path)
    answer_rows = read_json_or_jsonlines(divide_path)

    save_path = autocheck_path.replace(".jsonl", ".pair_diff1.jsonl")
    pairs, judges, annotated, kept_answers = assemble_pairs(
        fact_rows, answer_rows, diff=diff
    )
    write_jsonlines(save_path, pairs)
    write_jsonlines(save_path.replace(".jsonl", ".addcls.jsonl"), annotated)
    judged = [dict(r, fact_judge=judges[r["question_id"]]) for r in kept_answers]
    write_jsonlines(save_path.replace(".jsonl", ".addfactjudge.jsonl"), judged)

    sampled = sample_pairs(pairs, sample_num)
    write_jsonlines(
        autocheck_path.replace(".jsonl", f"_pair_diff1_samp{sample_num}.jsonl"),
        sampled,
    )
    print(f"pairs={len(pairs)} sampled={len(sampled)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--autocheck_path", type=str, required=True)
    ap.add_argument("--gpt_divide_gq_path", type=str, required=True)
    ap.add_argument("--sample_num", type=int, default=2)
    a = ap.parse_args()
    run(a.autocheck_path, a.gpt_divide_gq_path, a.sample_num)
