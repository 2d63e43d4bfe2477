"""Progress and metrics logging (port of ``scream_tpu/utils/logging.py``):
an in-place progress bar as the reference prints (``utils.py:17-23``), a
JSONL metrics log, and a per-step wall-clock timer."""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


def progressbar(done: int, total: int, width: int = 30) -> str:
    filled = int(width * done / max(total, 1))
    return f"[{'█' * filled}{'░' * (width - filled)}] {done}/{total}"


class MetricsLogger:
    """Print each snapshot in place on stderr and, with ``jsonl_path``,
    append it to a JSONL file (closed by :meth:`close`)."""

    def __init__(self, jsonl_path: Optional[str] = None, print_every: int = 50):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._file = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        """Record and print one snapshot. Callers throttle the calls (the
        trainers gate on their batch counter against ``print_every``), so
        every call prints."""
        record = {"step": int(step), "prefix": prefix}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        parts = "  ".join(f"{k}: {float(v):.5f}" for k, v in metrics.items())
        print(f"\r{prefix} step {step}  {parts}", end="", file=sys.stderr)

    def close(self):
        if self._file:
            self._file.close()


class StepTimer:
    """Wall-clock per-step timing with the first ``warmup`` steps left out.
    On the card a step's time is only right if the step ends in a host read
    or a synchronize."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._t = None
        self._n = 0

    def tick(self):
        now = time.perf_counter()
        if self._t is not None:
            self._n += 1
            if self._n > self.warmup:
                self.times.append(now - self._t)
        self._t = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
