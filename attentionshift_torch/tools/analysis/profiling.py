"""Timing shared by the profiling tools (``profile_seed``,
``profile_backbone``, ``profile_stage_a``, ``profile_stage_bc``,
``calibrate_overhead``).

Each tool times a call as the JAX tools do: one call outside the clock
(it builds the kernels and warms the caches), then ``steps`` calls
between two synchronisations of the device, and the mean per call on
the host clock. On the CPU the synchronisation is a no-op.
"""

from __future__ import annotations

import time

import torch


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, steps: int, device: torch.device):
    """(ms per call, the last call's output) of ``fn()``."""
    out = fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn()
    synchronize(device)
    return (time.perf_counter() - t0) / steps * 1e3, out


def line(label: str, ms: float, width: int, digits: int = 2) -> str:
    """One line of a tool's table, in the JAX tool's format."""
    return f"{label:<{width}s} {ms:8.{digits}f} ms"
