"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A
request for the card on a machine without one raises: nothing falls
back to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "attentionshift_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
