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
    (int64[n+1], or the sharded driver's int32 partials) in place, and
    return it."""
    idx = edges.reshape(-1).long().clamp(0, n)
    return deg.index_add_(0, idx, torch.ones_like(idx, dtype=deg.dtype))


# The quality advisor (the reference's, ``sheep_tpu/ops/degrees.py:39``).
# Label-propagation refinement recovers community structure only while the
# average intra-community degree a part stays at or above about 1 (the JAX
# package's BASELINE.md "SBM quality"); the advisor prices that signal from
# 2E/V and picks a hierarchy that keeps every level above it.
LP_SIGNAL_THRESHOLD = 1.0

# the repair knobs of the recipe: warm-start refinement at the full k, and
# a balance budget that leaves the repair headroom
ADVISED_FINAL_REFINE = 10
ADVISED_BALANCE = 1.05


def intra_signal(n: int, m: int, k: int) -> float:
    """The advisor's signal: average degree (2E/V) a part at ``k``."""
    return (2.0 * m / max(n, 1)) / max(k, 1)


def _prime_factors(k: int) -> list:
    out = []
    d = 2
    while d * d <= k:
        while k % d == 0:
            out.append(d)
            k //= d
        d += 1
    if k > 1:
        out.append(k)
    return out


def _equal_factors(k: int, nlevels: int):
    """k as ``nlevels`` near-equal integer factors, largest first, or None
    when k has fewer prime factors than levels."""
    primes = _prime_factors(k)
    if len(primes) < nlevels:
        return None
    buckets = [1] * nlevels
    for p in sorted(primes, reverse=True):
        buckets[buckets.index(min(buckets))] *= p
    return sorted(buckets, reverse=True)


def factor_levels(k: int, cap: int):
    """The fewest near-equal levels with every factor <= ``cap``, or None
    when there is no such split (k prime and above the cap)."""
    import math

    if k <= cap:
        return [k]
    if cap < 2:
        cap = 2
    nlevels = max(2, math.ceil(math.log(k) / math.log(cap)))
    while nlevels <= k.bit_length() + 1:
        fac = _equal_factors(k, nlevels)
        if fac is None:
            return None
        if fac[0] <= cap:
            return fac
        nlevels += 1
    return None


def advise_recipe(n: int, m, k: int,
                  threshold: float = LP_SIGNAL_THRESHOLD) -> dict:
    """The advisor's verdict for a flat build at ``k``: ``mode`` "flat"
    (run as asked), "hier" (flat refinement will stall; ``k_levels``,
    ``final_refine`` and ``balance`` carry the recipe) or "unknown" (``m``
    is None: the edge count is not known in O(1))."""
    if m is None:
        return {"mode": "unknown", "signal": None, "k": int(k)}
    sig = intra_signal(n, m, k)
    out = {"mode": "flat", "signal": round(sig, 4),
           "threshold": threshold, "k": int(k)}
    if k < 4 or sig >= threshold:
        return out
    avg_deg = 2.0 * m / max(n, 1)
    levels = factor_levels(int(k), max(2, int(avg_deg / threshold)))
    if levels is None or len(levels) < 2:
        return out
    out.update(mode="hier", k_levels=levels,
               final_refine=ADVISED_FINAL_REFINE, balance=ADVISED_BALANCE)
    return out
