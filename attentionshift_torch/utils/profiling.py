"""Profiling utilities (reference: `mmdet/utils/profiling.py:10-39`,
`tools/analysis_tools/benchmark.py`).

Port of ``attentionshift_tpu/utils/profiling.py``: ``profile_time`` is
the host-side timing context (with ``sync`` it waits for the card's
queued work, ``torch.cuda.synchronize``, where the JAX package waits on
its effects); ``trace`` wraps ``torch.profiler`` and writes a Chrome
trace into ``log_dir``; ``Throughput`` accumulates images/sec like the
benchmark CLI.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["profile_time", "trace", "Throughput"]


@contextlib.contextmanager
def profile_time(name: str, stream=None, sync: bool = True, logger=None):
    """Time a block; with ``sync``, waits for the current card's pending
    work first (nothing to wait for without a card)."""
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    msg = f"{name}: {dt * 1000:.2f} ms"
    (logger.info if logger else print)(msg)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card where there is one) and
    write a Chrome trace, viewable in Perfetto, into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class Throughput:
    """Running images/sec meter (IterTimerHook analog)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.images = 0
        self.start = None

    def step(self, batch_size: int):
        self.count += 1
        if self.count == self.warmup:
            self.start = time.perf_counter()
            self.images = 0
        elif self.count > self.warmup:
            self.images += batch_size

    def rate(self) -> float:
        if self.start is None or self.images == 0:
            return 0.0
        return self.images / (time.perf_counter() - self.start)
