# A copy of rlaifv_tpu/data/diff_lib.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Token-level diff between chosen/rejected sequences.

Drives the RLHF-V fine-grained token weighting: tokens inside *replaced*
spans (changed on both sides) get an up-weighted DPO contribution
(ref: utils/diff_lib.py:114-178 — `get_diff_ids`, `generate_modification_mapping`).

Semantics kept identical to the reference:
- matching blocks come from difflib.SequenceMatcher, blocks shorter than
  `min_match_size` are discarded (treated as part of the surrounding change);
- the gap spans between surviving matches are paired up across the two
  sequences; a pair counts as a modification only when BOTH gaps are
  non-empty (a replacement). Pure insertions/deletions are not weighted.
"""
from __future__ import annotations

import difflib
from typing import List, Sequence, Tuple

Span = Tuple[int, int]


def _matching_spans(
    a_seq: Sequence, b_seq: Sequence, min_match_size: int
) -> Tuple[List[Span], List[Span]]:
    sm = difflib.SequenceMatcher(None, a_seq, b_seq)
    blocks = sm.get_matching_blocks()
    # The final block is a zero-length sentinel; always keep it so the gap
    # after the last real match is represented.
    kept = [m for m in blocks[:-1] if m.size >= min_match_size] + [blocks[-1]]
    a_spans = [(m.a, m.a + m.size) for m in kept]
    b_spans = [(m.b, m.b + m.size) for m in kept]
    return a_spans, b_spans


def _interleave_gaps(matches: List[Span], total_len: int) -> List[Span]:
    """[gap0, match0, gap1, match1, ...] covering [0, total_len)."""
    spans: List[Span] = []
    cursor = 0
    for start, end in matches:
        spans.append((cursor, start))  # gap before this match (may be empty)
        spans.append((start, end))
        cursor = end
    spans.append((cursor, total_len))
    return spans


def generate_modification_mapping(
    a_seq: Sequence, b_seq: Sequence, min_match_size: int = 3
) -> dict:
    a_matches, b_matches = _matching_spans(a_seq, b_seq, min_match_size)
    a_all = _interleave_gaps(a_matches, len(a_seq))
    b_all = _interleave_gaps(b_matches, len(b_seq))
    mod_map = {}
    # Even indices are gaps (candidate modifications).
    for idx in range(0, min(len(a_all), len(b_all)), 2):
        a_gap, b_gap = a_all[idx], b_all[idx]
        if a_gap[0] != a_gap[1] and b_gap[0] != b_gap[1]:
            mod_map[a_gap] = b_gap
    return mod_map


def spans_to_ids(spans: Sequence[Span]) -> List[int]:
    ids: List[int] = []
    for start, end in spans:
        ids.extend(range(start, end))
    return ids


def get_diff_ids(
    a_seq: Sequence, b_seq: Sequence, min_match_size: int = 3
) -> Tuple[List[int], List[int]]:
    """Indices of modified tokens in each sequence (sorted, deduped)."""
    mod_map = generate_modification_mapping(a_seq, b_seq, min_match_size)
    a_ids = sorted(set(spans_to_ids(list(mod_map.keys()))))
    b_ids = sorted(set(spans_to_ids(list(mod_map.values()))))
    return a_ids, b_ids
