"""Profiling / tracing hooks.

Counterpart of rlaifv_tpu/utils/profiling.py: `trace` records a
torch.profiler trace of the CPU and the card (CUDA activity when a card is
visible) while its block runs and writes it under `log_dir` as a
Chrome/Perfetto JSON file; `annotate` names a region in that timeline (and
in an NVTX timeline once CUDA is initialised); `StepTimer` is the JAX
package's, copied unchanged, and feeds the pairs/sec metric.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a CPU + device trace while the block runs (no-op if log_dir
    is empty); the trace lands in `log_dir/trace_<pid>_<ns>.json`."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace timeline."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StepTimer:
    """Wall-clock EMA of step latency + derived throughput."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._avg = dt if self._avg is None else (
                self.ema * self._avg + (1 - self.ema) * dt
            )
        self._last = now
        return dt

    @property
    def avg_seconds(self) -> Optional[float]:
        return self._avg

    def throughput(self, items_per_step: int) -> Optional[float]:
        if not self._avg:
            return None
        return items_per_step / self._avg
