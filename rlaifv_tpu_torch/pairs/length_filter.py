# A copy of rlaifv_tpu/pairs/length_filter.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Length-balance filter: sweep shorten-ratio, pick the most balanced cut.

Rebuild of ref utils/get_pairs_filter_shorten.py:6-89 — drop pairs where
the rejected answer is relatively much longer than the chosen one; sweep
the threshold 0..1 step 0.02 and keep the cut minimizing the win/lose
average-length gap (use_len) or the shorter/longer count gap.
"""
from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np

from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines


def _wlen(text: str) -> int:
    return len(text.split())


def filter_by_relative_length(pairs: Sequence[dict], max_ratio: float) -> List[dict]:
    out = []
    for p in pairs:
        cl, rl = _wlen(p["chosen"]), _wlen(p["rejected"])
        if (rl - cl) / float(rl) > max_ratio:
            continue
        if p["chosen"].strip() == p["rejected"].strip():
            continue
        out.append(p)
    return out


def statistics(pairs: Sequence[dict]) -> dict:
    n = len(pairs)
    cl = np.array([_wlen(p["chosen"]) for p in pairs], float)
    rl = np.array([_wlen(p["rejected"]) for p in pairs], float)
    return {
        "avg_win_len": cl.mean(),
        "avg_lose_len": rl.mean(),
        "shorten_portion": float((cl < rl).mean()),
        "longer_portion": float((cl > rl).mean()),
        "count": n,
    }


def search_balanced_cut(
    pairs: Sequence[dict], use_len: bool = True
) -> Tuple[List[dict], float, dict, List[dict]]:
    sweep = []
    for ratio in np.arange(0, 1, 0.02):
        remain = filter_by_relative_length(pairs, ratio)
        if not remain:
            continue
        s = statistics(remain)
        s["ratio"] = float(ratio)
        s["avg_diff_len"] = abs(s["avg_win_len"] - s["avg_lose_len"])
        s["avg_diff_len_portion"] = s["avg_diff_len"] / s["avg_lose_len"]
        s["diff_shorter_longer_portion"] = abs(
            s["shorten_portion"] - s["longer_portion"]
        )
        s["total_diff_portion"] = (
            s["avg_diff_len_portion"] if use_len
            else s["diff_shorter_longer_portion"]
        )
        sweep.append(s)
    best = min(sweep, key=lambda s: s["total_diff_portion"])
    final = filter_by_relative_length(pairs, best["ratio"])
    return final, best["ratio"], best, sweep


def run(path: str, save_path: str, use_len: bool = True) -> None:
    pairs = read_jsonlines(path)
    final, ratio, best, sweep = search_balanced_cut(pairs, use_len=use_len)
    print(f"ratio={ratio:.2f} kept={len(final)}/{len(pairs)} stats={best}")
    write_jsonlines(save_path, final)
    write_jsonlines(save_path.replace(".jsonl", "_search_diff.jsonl"), sweep)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", type=str, required=True)
    ap.add_argument("--save_path", type=str, required=True)
    a = ap.parse_args()
    run(a.path, a.save_path)
