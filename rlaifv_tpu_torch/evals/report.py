# A copy of rlaifv_tpu/evals/report.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Tabular RefoMB report export (ref eval/json_to_excel.py).

The reference ships judged RefoMB rows to reviewers as two xlsx sheets: a
one-row win/loss/tie summary with per-category "w/l/t" cells
(json_to_excel.py:8-103 `jsonl_excel`) and a flattened per-row sheet with
the model answers / question / description parsed back out of the judge
prompt (json_to_excel.py:107-132 `jsonl_excel_all_data`). Here the same
tables are plain list-of-dict records written as CSV (stdlib csv — no
pandas/openpyxl dependency); every derived number matches the reference:
score = (win + tie/2) / total, category cells are "win/loss/tie" strings,
and the check columns re-sum the categories.

Row orientation: rows come from evals/refomb.py::judge_pairwise, where
score > 0 means OUR model wins (sides already de-randomized via
model_is_A), score == 0 tie, score < 0 loss, None skipped.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence

# ref json_to_excel.py:8-17 — the 8 RefoMB capability categories
CATEGORIES = (
    "Coarse Perception",
    "Fine-grained perception",
    "Relation reasoning",
    "Attribute reasoning",
    "Time series inference",
    "Mechanical logical reasoning",
    "Creative generation",
    "OCR",
)

# ref json_to_excel.py:113-125 — prompt section markers
_SECTIONS = {
    "model A answer": ("[Beginning of Model A's answer]",
                       "[End of Model A's answer]"),
    "model B answer": ("[Beginning of Model B's answer]",
                       "[End of Model B's answer]"),
    "question": ("[Beginning of the user's question]",
                 "[End of the user's question]"),
    "description": ("[Beginning of the detailed description of the picture]",
                    "[End of the detailed description of the picture]"),
}


def refomb_summary_table(rows: Sequence[dict]) -> List[Dict]:
    """One-row summary record (ref jsonl_excel count_excel columns)."""
    per_cat = {c: [0, 0, 0] for c in CATEGORIES}  # win, loss, tie
    w = l = t = 0
    for row in rows:
        s = row.get("score")
        if s is None:
            continue
        cat = per_cat.setdefault(row.get("type_name", "unknown"), [0, 0, 0])
        if s > 0:
            cat[0] += 1
            w += 1
        elif s < 0:
            cat[1] += 1
            l += 1
        else:
            cat[2] += 1
            t += 1
    total = w + l + t
    rec: Dict = {
        "model A": rows[0].get("modelA", "") if rows else "",
        "model B": rows[0].get("modelB", "") if rows else "",
        "win": w,
        "loss": l,
        "tie": t,
        # ref :74 — trustworthiness score, ties count half
        "score": (w + t / 2) / total if total else 0.0,
    }
    for cat, (cw, cl, ct) in per_cat.items():
        rec[cat] = f"{cw}/{cl}/{ct}"  # ref :80-88 "win/loss/tie" cells
    rec["WIN Check"] = sum(v[0] for v in per_cat.values())
    rec["LOSS Check"] = sum(v[1] for v in per_cat.values())
    rec["TIE Check"] = sum(v[2] for v in per_cat.values())
    rec["ALL Check"] = rec["WIN Check"] + rec["LOSS Check"] + rec["TIE Check"]
    return [rec]


def refomb_all_data_table(rows: Sequence[dict]) -> List[Dict]:
    """Per-row records with the judge-prompt sections parsed back out
    (ref jsonl_excel_all_data). Rows whose prompt lacks a marker keep ''
    for that column instead of raising (the reference would throw on
    .index — a judge-truncated prompt should not kill the export)."""
    out = []
    for row in rows:
        rec = {k: v for k, v in row.items() if k != "prompt"}
        prompt = row.get("prompt", "") or ""
        for col, (beg, end) in _SECTIONS.items():
            i = prompt.find(beg)
            j = prompt.find(end)
            rec[col] = prompt[i + len(beg): j] if 0 <= i and i < j else ""
        out.append(rec)
    return out


def write_csv(records: Sequence[Dict], path: str) -> None:
    """Write records as CSV; the header is the union of keys in first-seen
    order (rows with differing keys pad with '')."""
    cols: List[str] = []
    for rec in records:
        for k in rec:
            if k not in cols:
                cols.append(k)
    with open(path, "w", newline="", encoding="utf-8") as f:
        wr = csv.DictWriter(f, fieldnames=cols, restval="")
        wr.writeheader()
        for rec in records:
            wr.writerow({k: rec.get(k, "") for k in cols})


def export_refomb_reports(rows: Sequence[dict], base_path: str) -> List[str]:
    """Write <base>.summary.csv and <base>.all_data.csv; returns the paths
    (ref __main__ json_to_excel.py:135-147 writes .xlsx twins)."""
    paths = [f"{base_path}.summary.csv", f"{base_path}.all_data.csv"]
    write_csv(refomb_summary_table(rows), paths[0])
    write_csv(refomb_all_data_table(rows), paths[1])
    return paths
