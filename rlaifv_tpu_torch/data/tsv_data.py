# A copy of rlaifv_tpu/data/tsv_data.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Seekable TSV shard datasets (legacy SFT-era multi-source pipeline).

Rebuild of the reference TSV layer (ref: muffin/data/tsv_file.py:36-106
seekable TSV + .lineidx; muffin/data/datasets.py:119-287 —
SingleDataSourceDataset over size-suffixed shards with border index,
MultiDataSourceDataset integer-weighted interleave, ChunckedRandomSampler
for >=50M-row corpora). Fork-safety: file handles reopen when the pid
changes (tsv_file.py:98-106).
"""
from __future__ import annotations

import bisect
import os
import random
from typing import List, Optional, Sequence


class TSVFile:
    """Random access into a TSV via a sibling .lineidx offsets file."""

    def __init__(self, tsv_path: str):
        self.tsv_path = tsv_path
        self.lineidx_path = os.path.splitext(tsv_path)[0] + ".lineidx"
        self._offsets: Optional[List[int]] = None
        self._fp = None
        self._pid = None

    @staticmethod
    def build_lineidx(tsv_path: str) -> str:
        out = os.path.splitext(tsv_path)[0] + ".lineidx"
        offsets = []
        with open(tsv_path, "rb") as f:
            pos = 0
            for line in f:
                offsets.append(pos)
                pos += len(line)
        with open(out, "w") as f:
            f.write("\n".join(str(o) for o in offsets))
        return out

    def _ensure(self):
        if self._offsets is None:
            if not os.path.exists(self.lineidx_path):
                self.build_lineidx(self.tsv_path)
            with open(self.lineidx_path) as f:
                self._offsets = [int(x) for x in f if x.strip()]
        if self._fp is None or self._pid != os.getpid():
            # reopen after fork (ref tsv_file.py:98-106)
            self._fp = open(self.tsv_path, "r")
            self._pid = os.getpid()

    def __len__(self) -> int:
        self._ensure()
        return len(self._offsets)

    def seek(self, idx: int) -> List[str]:
        self._ensure()
        self._fp.seek(self._offsets[idx])
        return [x.strip("\n") for x in self._fp.readline().split("\t")]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)


class SingleDataSourceDataset:
    """Multiple size-suffixed TSV shards behaving as one dataset
    (ref datasets.py:119-235: shard borders via cumulative sizes)."""

    def __init__(self, name: str, *shard_paths: str):
        self.name = name
        self.shards = [TSVFile(p) for p in shard_paths]
        sizes = [len(s) for s in self.shards]
        self.borders = [0]
        for s in sizes:
            self.borders.append(self.borders[-1] + s)

    def __len__(self) -> int:
        return self.borders[-1]

    def __getitem__(self, idx: int) -> List[str]:
        shard = bisect.bisect_right(self.borders, idx) - 1
        return self.shards[shard][idx - self.borders[shard]]


class MultiDataSourceDataset:
    """Integer-weighted interleave of several sources
    (ref datasets.py:237-287: a weight-sum-long pattern cycles through
    sources proportionally)."""

    def __init__(self, sources: Sequence, weights: Sequence[int]):
        assert len(sources) == len(weights) and all(
            isinstance(w, int) and w > 0 for w in weights
        )
        self.sources = list(sources)
        self.weights = list(weights)
        self.pattern = []
        for si, w in enumerate(weights):
            self.pattern.extend([si] * w)
        self.cycle = len(self.pattern)
        # positions within each source advance independently
        self._offsets_in_cycle = []
        counts = [0] * len(sources)
        for si in self.pattern:
            self._offsets_in_cycle.append(counts[si])
            counts[si] += 1
        self._per_cycle = counts

    def __len__(self) -> int:
        # cycles until the proportionally-scarcest source is exhausted
        cycles = min(
            len(s) // c for s, c in zip(self.sources, self._per_cycle)
        )
        return cycles * self.cycle

    def __getitem__(self, idx: int):
        cyc, pos = divmod(idx, self.cycle)
        si = self.pattern[pos]
        inner = cyc * self._per_cycle[si] + self._offsets_in_cycle[pos]
        return self.sources[si][inner]


def chunked_random_indices(total: int, chunk_size: int = 1_000_000,
                           seed: int = 0) -> List[int]:
    """Shuffle within chunks only — O(chunk) memory for 50M+ rows
    (ref ChunckedRandomSampler, datasets.py:94-116)."""
    rng = random.Random(seed)
    out: List[int] = []
    for start in range(0, total, chunk_size):
        block = list(range(start, min(start + chunk_size, total)))
        rng.shuffle(block)
        out.extend(block)
    return out
