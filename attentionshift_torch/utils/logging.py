"""Training log utilities (TextLoggerHook / json log analog).

The port's own copy of ``attentionshift_tpu/utils/logging.py`` (plain
Python: the logger receives floats).

The reference logs smoothed loss dicts every 50 iters to stdout and a
json-lines file (`configs/_base_/default_runtime.py`); ``MetricLogger``
reproduces that: exponential/window smoothing per key, one-line console
format, optional jsonl sink for ``analyze_logs``-style tooling.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque

__all__ = ["MetricLogger", "get_logger"]


class _Smoothed:
    def __init__(self, window: int = 50):
        self.vals = deque(maxlen=window)

    def update(self, v: float):
        self.vals.append(float(v))

    @property
    def avg(self) -> float:
        return sum(self.vals) / max(len(self.vals), 1)


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, window: int = 50):
        self.meters = defaultdict(lambda: _Smoothed(window))
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.t_last = time.perf_counter()

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.meters[k].update(float(v))

    def line(self, epoch: int, it: int, total: int, lr: float | None = None) -> str:
        now = time.perf_counter()
        dt = now - self.t_last
        self.t_last = now
        parts = [f"Epoch [{epoch}][{it}/{total}]"]
        if lr is not None:
            parts.append(f"lr: {lr:.3e}")
        parts.append(f"time: {dt:.3f}")
        parts += [f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items())]
        if self.jsonl:
            rec = {k: m.avg for k, m in self.meters.items()}
            rec.update(epoch=epoch, iter=it, lr=lr, mode="train")
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        return ", ".join(parts)


def get_logger(name: str = "attentionshift_torch"):
    import logging

    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
