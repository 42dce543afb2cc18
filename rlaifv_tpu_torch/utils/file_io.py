# A copy of rlaifv_tpu/utils/file_io.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""json / jsonlines IO helpers (ref: utils/file_io.py:4-33)."""
from __future__ import annotations

import json
from typing import Iterable, List


def read_json(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def read_jsonlines(path: str) -> List:
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def write_jsonlines(path: str, rows: Iterable) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def read_json_or_jsonlines(path: str):
    try:
        return read_json(path)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return read_jsonlines(path)
