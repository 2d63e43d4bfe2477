"""Tracing and throughput accounting (port of
``scream_tpu/utils/profiling.py``): a ``torch.profiler`` trace context that
writes a Chrome trace of the CPU and the card, named spans, and the
throughput meter the trainers use."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the CPU and, where there is one, the CUDA device into
    ``log_dir/trace.json`` (Chrome trace format; a no-op when None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span inside an active trace (``with annotate("icp"): ...``)."""
    from torch.profiler import record_function

    return record_function(name)


class ThroughputMeter:
    """Items/s over a sliding window of steps, the first ``warmup_steps``
    left out. The rate is right on the card only if the caller's steps end
    in a host read."""

    def __init__(self, warmup_steps: int = 1, window: int = 50):
        self.warmup_steps = warmup_steps
        self.window = window
        self._steps = 0
        self._events = []  # (t, items)

    def step(self, items: int = 1) -> None:
        self._steps += 1
        if self._steps <= self.warmup_steps:
            return
        self._events.append((time.perf_counter(), items))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def items_per_sec(self) -> float:
        if len(self._events) < 2:
            return float("nan")
        dt = self._events[-1][0] - self._events[0][0]
        items = sum(n for _, n in self._events[1:])
        return items / dt if dt > 0 else float("nan")

    def summary(self) -> Dict[str, float]:
        return {"items_per_sec": self.items_per_sec, "steps": float(self._steps)}
