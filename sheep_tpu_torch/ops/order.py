"""Global elimination order (counterpart of ``sheep_tpu/ops/order.py``).

Vertices sorted by (degree asc, id asc): a stable argsort breaks ties by
index, that is by id. The reference sorts int32 keys, replacing totals past
int32 range by their stable ranks (``rank_clip_i32``); that keeps the
order of every pair and breaks ties by id in both cases, so a stable sort
of the int64 totals here gives the identical order.
"""

from __future__ import annotations

import torch


def elimination_order(deg: torch.Tensor, n: int):
    """deg: int[>= n] -> (pos int32[n+1], order int32[n+1]).

    pos[v] = elimination rank of v; order[p] = vertex at rank p; both carry
    the sentinel slot n (pos[n] = order[n] = n)."""
    dev = deg.device
    order = torch.argsort(deg[:n], stable=True).to(torch.int32)
    pos = torch.empty(n + 1, dtype=torch.int32, device=dev)
    pos[order.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    pos[n] = n
    sentinel = torch.full((1,), n, dtype=torch.int32, device=dev)
    return pos, torch.cat([order, sentinel])
