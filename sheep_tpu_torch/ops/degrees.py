"""Degree accumulation (counterpart of ``sheep_tpu/ops/degrees.py``).

Endpoint counts by scatter-add; slot n absorbs the sentinel padding and a
self-loop counts twice. The reference accumulates in int32 on the TPU
(int64 is emulated there) and flushes into int64 host totals before any
vertex could reach 2^31 (``flush_every_for``). The H100 has native int64,
so the port accumulates in int64 on the device across the whole stream:
the totals are the same and the flush is not needed.
"""

from __future__ import annotations

import torch


def init_degrees(n: int, device) -> torch.Tensor:
    return torch.zeros(n + 1, dtype=torch.int64, device=device)


def degree_chunk(deg: torch.Tensor, edges: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Add the endpoint counts of one (C, 2) chunk into ``deg``
    (int64[n+1]) in place, and return it."""
    idx = edges.reshape(-1).long().clamp(0, n)
    return deg.index_add_(0, idx, torch.ones_like(idx))
