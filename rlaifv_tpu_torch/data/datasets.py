# A copy of rlaifv_tpu/data/datasets.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Datasets: RLAIF-V parquet contract, generation inputs, shard math.

Rebuild of the reference data layer (ref: muffin/data/datasets.py:27-91
`RLAIFVDataset`, muffin/llava15_gen_data.py:64-150 `GenDataset` — one shared
implementation instead of three copies). torch-free: parquet via pyarrow,
images stay raw bytes until the image pipeline decodes them.

The parquet schema is kept byte-compatible with the reference so caches
interoperate: columns include question/chosen/rejected/image{bytes,path}/
idx/origin_dataset/origin_split/image_path and a json-encoded 'logps'
column holding [win_logp, win_avg_logp, win_per_token, rej_logp,
rej_avg_logp, rej_per_token] (datasets.py:74-91).
"""
from __future__ import annotations

import base64
import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np


def shard_indices(total: int, world_size: int, rank: int) -> range:
    """Contiguous per-rank shards, remainder spread over low ranks
    (ref: InferenceSampler._get_local_indices, muffin_inference_logp.py:63-72)."""
    base = total // world_size
    left = total % world_size
    sizes = [base + int(r < left) for r in range(world_size)]
    begin = sum(sizes[:rank])
    return range(begin, min(begin + sizes[rank], total))


def chunk_indices(total: int, chunk_num: int, chunk_idx: int) -> List[int]:
    """Strided chunking used by the MiniCPM-V engines
    (ref: minicpmv_diverse_gen.py:27-44 get_chunk/split_list)."""
    lists = [[] for _ in range(chunk_num)]
    for i in range(total):
        lists[i % chunk_num].append(i)
    return lists[chunk_idx]


def _load_parquet_rows(files: Sequence[str]) -> List[dict]:
    import pyarrow.parquet as pq

    rows: List[dict] = []
    for f in sorted(files):
        table = pq.read_table(f)
        rows.extend(table.to_pylist())
    return rows


class RLAIFVDataset:
    """Preference dataset over `*logp*.parquet` shards in data_dir.

    If no logp parquet exists, `score_fn(rows) -> None` (the reference-logp
    precompute, rlaifv_tpu_torch/train/ref_logp.py) is invoked once to produce
    them — the same lazy-cache contract as the reference (datasets.py:35-52).
    """

    def __init__(
        self,
        data_dir: str,
        score_fn: Optional[Callable[[str], None]] = None,
        raw_rows: Optional[List[dict]] = None,
    ):
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir

        files = self._logp_files()
        if not files:
            assert score_fn is not None, (
                "`score_fn` is mandatory when logps do not exist."
            )
            score_fn(data_dir)
            files = self._logp_files()
            assert files, "score_fn produced no '*logp*.parquet' files"
        self.rows = _load_parquet_rows(files)

    def _logp_files(self) -> List[str]:
        return [
            os.path.join(self.data_dir, f)
            for f in os.listdir(self.data_dir)
            if f.endswith(".parquet") and "logp" in f
        ]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> dict:
        sample = self.rows[index]
        image_field = sample["image"]
        image_bytes = (
            image_field["bytes"] if isinstance(image_field, dict) else image_field
        )

        data = {
            "image_bytes": image_bytes,
            "question": {"from": "human", "value": f"<image>\n{sample['question']}"},
            "chosen": {"from": "gpt", "value": sample["chosen"]},
            "rejected": {"from": "gpt", "value": sample["rejected"]},
            "idx": sample.get("idx"),
            "metainfo": {
                "origin_dataset": sample.get("origin_dataset"),
                "origin_split": sample.get("origin_split"),
                "origin_idx": sample.get("idx"),
                "image_id": sample.get("image_path"),
            },
        }
        logps = json.loads(sample["logps"])
        if isinstance(logps, dict):
            logps = logps["logps"]
        (
            data["ref_win_logp"],
            data["ref_win_avg_logp"],
            data["ref_win_per_token_logp"],
            data["ref_rej_logp"],
            data["ref_rej_avg_logp"],
            data["ref_rej_per_token_logp"],
        ) = logps
        return data


def write_logp_parquet(
    origin_rows: Sequence[dict],
    out_dir: str,
    logps: Sequence,
    overwrite_logps: bool = False,
    rows_per_file: int = 5000,
    basename: str = "RLAIF-V-Dataset-withlogp",
) -> List[str]:
    """Write rows + logps in the reference's chunked parquet layout
    (ref: muffin_inference_logp.py:283-313 — 5000-row files,
    '{basename}_{idx:03}-{n}.parquet', json-encoded logps column)."""
    import pandas as pd

    out = []
    for row, lp in zip(origin_rows, logps):
        new_row = dict(row)
        if "logps" in new_row and not overwrite_logps:
            raise ValueError(
                "Found existing logp data, pass overwrite_logps=True to force"
            )
        new_row["logps"] = json.dumps({"logps": list(lp)})
        out.append(new_row)

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for idx, start in enumerate(range(0, len(out), rows_per_file)):
        part = out[start : start + rows_per_file]
        path = os.path.join(out_dir, f"{basename}_{idx:03}-{len(part)}.parquet")
        pd.DataFrame(part).to_parquet(path)
        written.append(path)
    return written


class DPODataset:
    """RLAIFVDataset rows -> encoded (rej, win) pairs for the DPO collator
    (ref: muffin/train/train_llava15.py:124-146; the OmniLMM encode goes
    through omni_preprocess per the vestigial reference branch,
    omnilmm/train/train_utils.py:50-150 — see train/family.py)."""

    def __init__(self, tokenizer, data_dir: str, multimodal_cfg: dict,
                 score_fn=None, preprocess_func=None):
        from functools import partial as _partial

        from rlaifv_tpu_torch.data.preprocess import (
            encode_preference_sample,
            preprocess_v1,
        )

        self.tokenizer = tokenizer
        self.dataset = RLAIFVDataset(data_dir, score_fn=score_fn)
        self.multimodal_cfg = dict(multimodal_cfg)
        if preprocess_func is None:
            # llava15 default: keep the <image> sentinel for host expansion
            self.multimodal_cfg.setdefault("keep_image_tag", True)
            preprocess_func = _partial(preprocess_v1, has_image=True)
        self._encode = _partial(
            encode_preference_sample,
            tokenizer=tokenizer,
            multimodal_cfg=self.multimodal_cfg,
            preprocess_func=preprocess_func,
        )

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        # Retry neighboring rows on a corrupt sample (bad image bytes,
        # malformed logps) so one poisoned row out of 83k doesn't kill the
        # run (ref: muffin/data/datasets.py:196-205, err_count <= 3).
        err = None
        for attempt in range(4):
            try:
                return self._get_one((i + attempt) % len(self.dataset))
            except Exception as e:  # noqa: BLE001 — any decode failure
                err = e
                print(
                    f"[data] row {(i + attempt) % len(self.dataset)} failed "
                    f"({e!r}), trying next row",
                    flush=True,
                )
        raise RuntimeError(
            f"4 consecutive corrupt rows starting at index {i}"
        ) from err

    def _get_one(self, i: int):
        source = self.dataset[i]
        source = dict(source)
        source["image"] = source.pop("image_bytes")
        rej, win = self._encode(source)
        # attach cached reference logps from the parquet row
        for k in ("ref_win_logp", "ref_win_avg_logp", "ref_win_per_token_logp"):
            win[k] = source[k]
        for k in ("ref_rej_logp", "ref_rej_avg_logp", "ref_rej_per_token_logp"):
            rej[k] = source[k]
        return rej, win


class GenDataset:
    """QA jsonl/json -> items repeated `repeat_time` times for diverse
    sampling (ref: muffin/llava15_gen_data.py:64-150; the x10 repetition is
    index arithmetic, not data duplication)."""

    def __init__(
        self,
        qa_file: str,
        repeat_time: int = 10,
        chunk_num: int = 1,
        chunk_idx: int = 0,
        start: int = 0,
        end: Optional[int] = None,
    ):
        self.qa_file = qa_file
        if qa_file.endswith(".jsonl"):
            with open(qa_file) as f:
                self.qa_data = [json.loads(line) for line in f if line.strip()]
        else:
            with open(qa_file) as f:
                self.qa_data = json.load(f)
        self.qa_data = self.qa_data[start:end]
        self.repeat_time = repeat_time
        base = list(range(len(self.qa_data) * repeat_time))
        self.indices = (
            chunk_indices(len(base), chunk_num, chunk_idx)
            if chunk_num > 1
            else base
        )

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        flat = self.indices[i]
        item = dict(self.qa_data[flat // self.repeat_time])
        item["sample_idx"] = flat % self.repeat_time
        item["question_id"] = flat
        raw = item.get("image")
        if raw is None and item.get("image_path"):
            # rows may carry only a path (ref llava15_gen_data.py:107-128
            # loads from image_path when no inline payload exists)
            item["image"] = item["image_path"]
        elif raw is not None and not isinstance(raw, (bytes, bytearray)):
            # b64-encoded image payload (gen inputs carry b64 or a path)
            if isinstance(raw, str) and not os.path.exists(raw):
                item["image_bytes"] = base64.b64decode(raw)
        return item
