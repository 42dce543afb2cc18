"""Step checkpoints for the trainer: params + optimizer state + step
(+ the model's class and config, which export reads).

Counterpart of rlaifv_tpu/core/checkpoint.py with the same directory
layout (one directory per step, named by the step number, under the
manager's directory), the same `save_total_limit` rotation (the newest
steps are kept), `latest_step`, `restore` and `has_resumable_checkpoint`.
The file format is not orbax's: each step directory holds one
`torch.save` file, `state.pt`, of the trainer's state dict (tensors on the
CPU). A JAX checkpoint does not load here, nor the other way round.
Writes are synchronous; a step directory appears only once complete (it is
written under a temporary name and renamed). Over a mesh the trainer
gathers every tensor whole, one parameter at a time, and process 0 alone
calls `save`, so the file is the same at any mesh and resumes at any other
(`python -m rlaifv_tpu_torch.export` reads it alike).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 50):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        """Saved steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", n)
                      and os.path.exists(os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write `state` (a tree of tensors and Python values) for `step`,
        then drop the oldest steps beyond save_total_limit."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".{int(step)}.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.save_total_limit or None]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved state of `step` (default: the latest), tensors on the
        CPU; the caller copies them into its own."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(int(step)), STATE_FILE),
                          map_location="cpu", weights_only=True)


def has_resumable_checkpoint(output_dir: str) -> bool:
    """Auto-resume contract: resume iff a step checkpoint exists in
    output_dir (ref train_llava15.py:326-331 checks for 'checkpoint-*')."""
    if not os.path.isdir(output_dir):
        return False
    return any(re.fullmatch(r"\d+", n) for n in os.listdir(output_dir))
