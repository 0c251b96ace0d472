"""Elimination-forest build as a data-parallel fixpoint (counterpart of a
subset of ``sheep_tpu/ops/elim.py``).

The carried forest is the position-space table P (P[p] = elimination
position of the parent of the vertex at rank p, n = none); a chunk's edges
are oriented to position pairs (lo, hi) with lo < hi and folded by rounds:

    scatter-min   P[lo] <- min(P[lo], hi)
    retire        a slot whose hi is the new minimum at lo is represented
                  by the table; if it displaced an older parent, the slot
                  is reused for the displaced constraint (now, old)
    climb         every other slot moves lo up to its highest ancestor
                  still earlier than hi, by binary lifting

until no slot changes. The fixpoint is the unique elimination forest of
the inserted constraint multiset, whatever the order of folding, so the
port's rounds are the reference's rounds, slot for slot.

A round of the exact descent is K1 (:func:`gather_clip`) for the table
read before the scatter, the scatter-min, and the two kernels of
``ops/lift.py``: ``lift_stack`` squares the table into the lifting stack
with an on-device depth cut, and ``climb_tail`` climbs, retires and
counts in one pass. The stream descent sends every gather through K1.
On CPU tensors each kernel's plain version runs instead. The JAX
``lax.while_loop`` of :func:`batch_segment_fixpoint` becomes a Python
loop that reads the round's control word (``changed`` with the stack rows
in use, retired and live counts) once per round; those reads are counted
in ``host_syncs``. Tables and blocks are updated in place
(the reference's arrays are immutable and it donates them instead).

Sentinel encoding: index n means "none"; pos[n] = order[n] = n; inert
edges are (n, n).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sheep_tpu_torch.ops import lift
from sheep_tpu_torch.ops.gather import gather_clip

NO_PARENT = -1

# exact descent keeps lift_levels tables of 4*(n+1) bytes live at once;
# beyond this budget the fixpoint switches to the O(V) stream descent
EXACT_TABLE_BYTES = 1 << 30

# None, or a list to which batch_segment_fixpoint appends (depth, live
# slots) for every round it runs
ROUND_LOG = None


def pow2_at_least(x: int, floor: int = 1) -> int:
    """Smallest power of two >= max(x, 1), raised to at least ``floor``."""
    return max(floor, 1 << max(0, (max(int(x), 1) - 1).bit_length()))


def _resolve(n: int, lift_levels: int, descent: str):
    if lift_levels <= 0:
        lift_levels = max(1, int(n).bit_length())
    if descent == "auto":
        table_bytes = lift_levels * 4 * (n + 1)
        descent = "exact" if table_bytes <= EXACT_TABLE_BYTES else "stream"
    return lift_levels, descent


def orient_edges_pos(edges: torch.Tensor, pos: torch.Tensor, n: int):
    """(..., 2) edges -> oriented positions (loP, hiP), loP < hiP;
    self-loops and padding become the inert (n, n)."""
    e = edges.to(torch.int32)
    u = e[..., 0].clamp(0, n).long()
    v = e[..., 1].clamp(0, n).long()
    pu, pv = pos[u], pos[v]
    lo = torch.minimum(pu, pv)
    hi = torch.maximum(pu, pv)
    bad = lo == hi
    return lo.masked_fill_(bad, n), hi.masked_fill_(bad, n)


def orient_chunks_batch_pos(chunks: torch.Tensor, pos: torch.Tensor, n: int):
    """(N, C, 2) stacked padded chunks -> [N, C] position blocks (loB, hiB),
    one independent active buffer per row (the reference's ``vmap`` is the
    leading dimension here)."""
    return orient_edges_pos(chunks, pos, n)


def dead_slot_spread(C: int, n: int, device) -> torch.Tensor:
    """int64[C] scatter targets for dead slots, built once per build.

    Dead slots are (n, n): all of them aiming the atomic min at P[n]
    serializes the atomics on one address (measured: most of a round's
    device time at RMAT-22). Their min with n is a no-op wherever it
    lands, since every entry of P is <= n, so slot i aims at i % (n+1)."""
    return torch.arange(C, device=device) % (n + 1)


class _pos_round_body:
    """One fixpoint round over position-space state (lo, hi, P).

    ``_pos_round_body(n, lift_levels, descent)(lo, hi, P, spread) ->
    (out_lo, out_hi, P, changed)``; ``spread`` is :func:`dead_slot_spread`
    for the row length. P is updated in place and ``changed`` is a 0-d
    view of the round's control word ``ctl`` = int32 [rows, changed,
    retired, live] (``ops/lift.py``), on P's device, which the caller
    reads once a round. The exact descent's stack and ``ctl`` are
    allocated at the first call and reused by every later one."""

    def __init__(self, n: int, lift_levels: int, descent: str):
        self.n, self.lift_levels, self.descent = n, lift_levels, descent
        self.ctl = self.stack = None

    def __call__(self, lo, hi, P, spread):
        n = self.n
        if self.ctl is None:
            self.ctl = lift.new_ctl(P.device)
            if self.descent == "exact":
                self.stack = lift.new_stack(len(P), self.lift_levels,
                                            P.device)
        old_at_lo = gather_clip(P, lo)  # parent position BEFORE the round
        # a min is order-independent, so the atomic scatter is bit-exact
        target = torch.where(lo == n, spread, lo.long())
        P.scatter_reduce_(0, target, hi, reduce="amin", include_self=True)
        if self.descent == "exact":
            lift.lift_stack(P, self.stack, self.ctl)
            out_lo, out_hi = lift.climb_tail(lo, hi, old_at_lo, P,
                                             self.stack, self.ctl)
        else:
            out_lo, out_hi = self._stream(lo, hi, P, old_at_lo)
        return out_lo, out_hi, P, self.ctl[lift.CHANGED]

    def _stream(self, lo, hi, P, old_at_lo):
        """Stream descent: square in place, one table live, every gather
        through K1; fills ``ctl`` with rows L - 1 (depth L) and the counts."""
        t = P
        cur = lo
        for j in range(self.lift_levels):
            cand = gather_clip(t, cur)
            cur = torch.where(cand < hi, cand, cur)
            if j < self.lift_levels - 1:
                t = gather_clip(t, t)
        out_lo, out_hi, changed, retired, live = lift.finish_round(
            lo, hi, cur, gather_clip(P, lo), old_at_lo, self.n)
        self.ctl[lift.ROWS] = self.lift_levels - 1
        torch.stack((changed.to(torch.int32), retired, live),
                    out=self.ctl[lift.CHANGED:])
        return out_lo, out_hi


def batch_segment_fixpoint(P: torch.Tensor, loB: torch.Tensor,
                           hiB: torch.Tensor, n: int, spread: torch.Tensor,
                           lift_levels: int = 0, descent: str = "auto",
                           batch_rounds: int = 0, stats=None):
    """Advance through the rows of the [N, C] blocks, one round per step:
    a row is done when a round changes nothing, and is then stored
    all-sentinel; the call returns when every row is done or
    ``batch_rounds`` rounds are spent, leaving the blocks resumable.
    ``spread`` is :func:`dead_slot_spread` for the row length.

    Returns ``(loB, hiB, P, sv)`` with ``sv`` int32[4] = (segments_done,
    rounds, live, retired), as the reference. P, loB and hiB are updated
    in place. Each round's control word is read once, and each read adds
    one to ``stats["host_syncs"]``; the rounds' depths and live slots go
    to ``stats`` (``depth_sum``, ``depth_max``, ``live_sum``,
    ``live_max``)."""
    N = loB.shape[0]
    lift_levels, descent = _resolve(n, lift_levels, descent)
    if batch_rounds <= 0:
        batch_rounds = 32 * N
    body = _pos_round_body(n, lift_levels, descent)
    if stats is None:
        stats = {}
    retired = i = rounds = 0
    lo, hi = loB[0], hiB[0]
    while i < N and rounds < batch_rounds:
        lo2, hi2, P, _ = body(lo, hi, P, spread)
        # the one read of the round
        rows, changed, retired_r, live = body.ctl.tolist()
        depth = rows + 1
        if ROUND_LOG is not None:
            ROUND_LOG.append((depth, live))
        rounds += 1
        retired += retired_r
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
        stats["depth_sum"] = stats.get("depth_sum", 0) + depth
        stats["depth_max"] = max(stats.get("depth_max", 0), depth)
        stats["live_sum"] = stats.get("live_sum", 0) + live
        stats["live_max"] = max(stats.get("live_max", 0), live)
        if not changed:
            loB[i] = n
            hiB[i] = n
            i += 1
            if i < N:
                lo, hi = loB[i], hiB[i]
        else:
            lo, hi = lo2, hi2
    if i < N:  # budget spent mid-row: store the working buffer back
        loB[i] = lo
        hiB[i] = hi
    sv = torch.tensor([i, rounds, 0, retired], dtype=torch.int32,
                      device=P.device)
    sv[2] = (loB != n).sum()
    return loB, hiB, P, sv


def _resolve_batch_rounds(batch_rounds: int, segment_rounds: int,
                          N: int) -> int:
    """Per-execution round budget: default ``segment_rounds * N``, never
    below N, so one execution can always cross the whole block."""
    if batch_rounds <= 0:
        batch_rounds = max(1, segment_rounds) * max(N, 1)
    return max(batch_rounds, max(N, 1))


def fold_segments_pipelined(P: torch.Tensor, staged, n: int,
                            lift_levels: int = 0, segment_rounds: int = 2,
                            descent: str = "auto", batch_rounds: int = 0,
                            stats=None):
    """Fold a stream of staged [N, C] blocks at depth 1: the reference's
    ``fold_segments_pipelined`` with ``inflight=1`` and no donation. Each
    group is issued, its stats word confirmed, and a group whose round
    budget ran out is re-queued on the current table until it drains;
    leftovers go before the next group. ``staged`` yields ``(loB, hiB)``.
    Returns ``(P, rounds)``."""
    if stats is None:
        stats = {}
    t_start = time.perf_counter()
    total = 0
    spread = None
    for loB, hiB in staged:
        if spread is None:  # every staged block has the same row length
            spread = dead_slot_spread(loB.shape[1], n, P.device)
        N = int(loB.shape[0])
        done = 0
        while done < N:
            loB, hiB, P, sv = batch_segment_fixpoint(
                P, loB, hiB, n, spread, lift_levels=lift_levels,
                descent=descent,
                batch_rounds=_resolve_batch_rounds(batch_rounds,
                                                   segment_rounds, N),
                stats=stats)
            done, r, live, retired = sv.tolist()  # the stats-word pull
            stats["host_syncs"] = stats.get("host_syncs", 0) + 1
            stats["batch_execs"] = stats.get("batch_execs", 0) + 1
            stats["batch_retired"] = stats.get("batch_retired", 0) + retired
            stats["device_rounds"] = stats.get("device_rounds", 0) + r
            total += r
    stats["t_batch_s"] = stats.get("t_batch_s", 0.0) + \
        time.perf_counter() - t_start
    return P, total


def minp_to_parent(minp, order, n: int) -> np.ndarray:
    """Vertex-space minp encoding -> parent array (int64[n], -1 roots) on
    the host."""
    if isinstance(minp, torch.Tensor):
        minp = minp.cpu().numpy()
    if isinstance(order, torch.Tensor):
        order = order.cpu().numpy()
    minp = np.asarray(minp[:n])
    order = np.asarray(order)
    parent = np.where(minp < n, order[np.minimum(minp, n)], NO_PARENT)
    return parent.astype(np.int64)
