"""Device selection for the port's entry points.

The entry points run on CUDA. The CPU is used only when the caller asks
for it (``device="cpu"``, as the tests do); a missing GPU is an error,
never a quiet fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a string or ``torch.device`` passes through.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
