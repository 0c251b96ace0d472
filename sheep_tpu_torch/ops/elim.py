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
read before the scatter, ``scatter_min`` (``ops/fixpoint.py``), and the
two kernels of ``ops/lift.py``: ``lift_stack`` squares the table into the
lifting stack with an on-device depth cut, and ``climb_tail`` climbs,
retires, counts and ends the round in one pass. The stream descent
climbs a level at a time (``fixpoint.climb_level``) and squares through
K1. On CPU tensors each kernel's plain version runs instead.

The JAX ``lax.while_loop`` of :func:`batch_segment_fixpoint` becomes an
execution that the host enqueues whole, ``batch_rounds`` rounds each
ended in ``climb_tail``'s last block (``fixpoint.round_end_plain`` on the
CPU), with its stop conditions in a state tensor on the device: the host
reads nothing per round, and one stats word per execution, one execution
behind at pipeline depth >= 2 (:func:`fold_segments_pipelined`). Tables
and blocks are updated in place (the reference's arrays are immutable and
it donates them instead); the comment above
:func:`fold_segments_pipelined` says why that keeps its semantics.

Sentinel encoding: index n means "none"; pos[n] = order[n] = n; inert
edges are (n, n).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

from sheep_tpu_torch.ops import fixpoint, lift
from sheep_tpu_torch.ops.gather import gather_clip

NO_PARENT = -1

# exact descent keeps lift_levels tables of 4*(n+1) bytes live at once;
# beyond this budget the fixpoint switches to the O(V) stream descent
EXACT_TABLE_BYTES = 1 << 30


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


class _pos_round_body:
    """One fixpoint round over position-space state.

    ``_pos_round_body(n, lift_levels, descent)(loB, hiB, P, state,
    batch_rounds)`` runs the round on the row of the [N, C] blocks that
    the execution ``state`` picks (``ops/fixpoint.py``): P and that row
    are updated in place, the round's control word ``ctl`` = int32 [rows,
    changed, retired, live, tickets] (``ops/lift.py``) is filled, and the
    round is counted into the state of an execution with a budget of
    ``batch_rounds`` rounds; every step does nothing once the execution
    has stopped, and nothing is read back. Called with 1-D
    ``(lo, hi, P)`` it is one free-standing round and returns ``(out_lo,
    out_hi, P, changed)``, ``changed`` a 0-d view of ``ctl``. The stack,
    ``ctl`` and the stream descent's climb buffer are allocated at the
    first call and reused by every later one."""

    def __init__(self, n: int, lift_levels: int, descent: str):
        self.n, self.lift_levels, self.descent = n, lift_levels, descent
        self.ctl = self.stack = self.cur = None

    def __call__(self, lo, hi, P, state=None, batch_rounds=None):
        if state is None:
            loB, hiB = lo[None].clone(), hi[None].clone()
            self(loB, hiB, P, fixpoint.new_state(1, P.device), 1)
            return loB[0], hiB[0], P, self.ctl[lift.CHANGED]
        if batch_rounds is None:
            raise ValueError("_pos_round_body: an execution state needs its "
                             "budget, batch_rounds")
        if self.ctl is None:
            self.ctl = lift.new_ctl(P.device)
            exact = self.descent == "exact"
            self.stack = lift.new_stack(
                len(P), self.lift_levels if exact else 1, P.device)
            if not exact:
                self.cur = torch.empty(lo.shape[-1], dtype=torch.int32,
                                       device=P.device)
        old_at_lo = gather_clip(P, lo, state)  # parent position BEFORE
        fixpoint.scatter_min(P, lo, hi, state)
        if self.descent == "exact":
            lift.lift_stack(P, self.stack, self.ctl, state)
            lift.climb_rows(lo, hi, old_at_lo, P, self.stack, self.ctl,
                            state, batch_rounds)
        else:
            self._stream(lo, hi, P, old_at_lo, state, batch_rounds)

    def _stream(self, loB, hiB, P, old_at_lo, state, batch_rounds):
        """Stream descent: square in place, one table live, the climb a
        level at a time (``fixpoint.climb_level``), the squaring through
        K1; ``ctl`` gets rows L - 1 (depth L) and the counts."""
        L = self.lift_levels
        self.ctl.zero_()
        # a fill kernel: an indexed store of a Python int would copy it
        # from the host and wait
        self.ctl.narrow(0, lift.ROWS, 1).fill_(L - 1)
        t, cur = P, loB
        for j in range(L):
            fixpoint.climb_level(t, cur, hiB, self.cur, state)
            cur = self.cur
            if j < L - 1:
                t = gather_clip(t, t, state)
        lift.climb_rows(loB, hiB, old_at_lo, P, self.stack, self.ctl, state,
                        batch_rounds, pre=self.cur)


def batch_segment_fixpoint(P: torch.Tensor, loB: torch.Tensor,
                           hiB: torch.Tensor, n: int, lift_levels: int = 0,
                           descent: str = "auto", batch_rounds: int = 0,
                           state: torch.Tensor = None):
    """Enqueue one execution over the rows of the [N, C] blocks: exactly
    ``batch_rounds`` rounds (default 32 N), each ended in
    ``climb_tail``'s last block (by ``fixpoint.round_end_plain`` on the
    CPU), then ``fixpoint.exec_finish``. A row is done when a round
    changes nothing; the rounds after the last row is done, or after the
    budget is spent mid-row, change nothing. Nothing is read back: the
    stop conditions, the counts and the per-round log live in the
    execution's ``state`` (``fixpoint.new_state(batch_rounds)``, made here
    when None). The blocks always hold resumable state: the round
    writes its row back in place, and the rows that converged are stored
    all-sentinel at the end.

    Returns ``(loB, hiB, P, sv)`` with ``sv`` int32[4] = (segments_done,
    rounds, live, retired) on P's device, as the reference. P, loB and
    hiB are updated in place."""
    N = loB.shape[0]
    lift_levels, descent = _resolve(n, lift_levels, descent)
    if batch_rounds <= 0:
        batch_rounds = 32 * N
    if state is None:
        state = fixpoint.new_state(batch_rounds, P.device)
    body = _pos_round_body(n, lift_levels, descent)
    for _ in range(batch_rounds):
        body(loB, hiB, P, state, batch_rounds)
    sv = fixpoint.exec_finish(loB, hiB, state, n)
    return loB, hiB, P, sv


def _resolve_batch_rounds(batch_rounds: int, segment_rounds: int,
                          N: int) -> int:
    """Per-execution round budget: default ``segment_rounds * N``, never
    below N, so one execution can always cross the whole block."""
    if batch_rounds <= 0:
        batch_rounds = max(1, segment_rounds) * max(N, 1)
    return max(batch_rounds, max(N, 1))


def _t_ms(stats: dict, key: str, dt_s: float) -> None:
    """Accumulate a millisecond counter unrounded."""
    stats[key] = stats.get(key, 0.0) + dt_s * 1e3


@contextlib.contextmanager
def sync_debug(device, mode):
    """On CUDA, ``torch.cuda.set_sync_debug_mode(mode)`` for the block
    ("error": an op that synchronizes with the device raises, "default":
    nothing is checked); nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class _Readback:
    """An execution's state and stats word on their way to the host. On
    CUDA: ``non_blocking`` copies into pinned buffers of its own, and an
    event recorded right after them, so that :meth:`wait` waits for this
    execution only, never for one enqueued after it. On the CPU the
    tensors are already on the host."""

    def __init__(self, state: torch.Tensor, sv: torch.Tensor):
        self.device, self.event = state.device, None
        if state.device.type != "cuda":
            self.state, self.sv = state, sv
            return
        self.state = torch.empty(state.shape, dtype=state.dtype,
                                 pin_memory=True)
        self.sv = torch.empty(sv.shape, dtype=sv.dtype, pin_memory=True)
        self.state.copy_(state, non_blocking=True)
        self.sv.copy_(sv, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self):
        """The host copies ``(state, sv)``, once the execution is done."""
        if self.event is not None:
            # the designed read of the pipeline, one per confirmed
            # execution: it waits on this execution's event alone
            with sync_debug(self.device, "default"):
                self.event.synchronize()
        return self.state, self.sv


# The in-flight dispatch pipeline (the reference's block comment at
# sheep_tpu/ops/elim.py:605-631). The host keeps a bounded FIFO (depth D)
# of issued executions whose stats words are not read yet, chains each new
# execution on the table the previous one leaves, and reads the words
# one-behind. A new group is issued assuming the executions ahead of it
# drain their blocks; when a read shows one did not (budget spent), its
# blocks are re-queued on the current table, which reorders the folding
# but cannot change the result: the fixpoint is the unique forest of the
# inserted constraint multiset. At the end of the stream the pipeline
# speculates the other way and issues the newest execution's re-dispatch
# before reading; if the read says it drained, the speculative executions
# are discarded unread: drained blocks are all-sentinel, and re-running
# them re-confirms each row in one round and leaves the table as it is.
#
# In place, and why that keeps the reference's semantics. The reference's
# arrays are immutable (and donated along the chain); here P and every
# staged block are updated in place, and every execution runs on the one
# current stream, in issue order. An execution therefore reads its blocks
# and P exactly as the executions issued before it left them, which is
# what the reference passes it as values: a group's first execution reads
# the fresh blocks, a speculative re-dispatch or a re-queued leftover
# reads the blocks its source execution left (nothing else names them in
# between: a speculation is issued only on the newest execution's blocks,
# and a leftover is queued only when no speculation of it is in flight),
# and every execution reads the table of the chain tip, which is P. A
# discarded speculation ran on all-sentinel blocks, so it changed neither
# them nor P. The host reads each execution's stats word from its own
# pinned copy, behind its own event, never from the blocks or P.

def fold_segments_pipelined(P: torch.Tensor, staged, n: int,
                            inflight: int = 1, lift_levels: int = 0,
                            segment_rounds: int = 2, descent: str = "auto",
                            batch_rounds: int = 0, max_rounds: int = 1 << 20,
                            stats=None, on_confirm=None, on_flush=None,
                            round_log=None):
    """Fold a stream of staged [N, C] oriented position blocks with up to
    ``inflight`` executions in flight (the reference's function of the same
    name; see the comment above for the speculation, discard and in-place
    model). ``inflight=1`` is the synchronous execute/read/decide loop; the
    entry points resolve their auto depth to 2 on CUDA
    (``backends.torch_backend.resolve_inflight``).

    ``staged`` yields ``(loB, hiB)`` or ``(loB, hiB, tag)``; the blocks are
    updated in place. ``on_confirm(tag, rounds, P)`` runs after each stats
    read (``tag`` for a group's first execution, else None) with the chain
    tip table P, still being updated by executions in flight; a truthy
    return asks for a flush barrier: no new groups, everything issued is
    drained (leftovers included), then ``on_flush(P)`` gets a table that
    holds every confirmed group's constraints, with the sync guard lifted.
    ``round_log``, a list, receives (depth, live slots) of every counted
    round of the confirmed executions. Returns ``(P, total_rounds)``.

    Counters in ``stats``, as the reference's: ``host_syncs`` (one read per
    confirmed execution), ``batch_execs``, ``batch_retired``,
    ``device_rounds``, ``host_blocked_ms`` (wall inside the blocking
    reads), ``device_gap_ms`` (wall from a read that emptied the FIFO to
    the next issue), ``inflight_discards`` (speculative executions never
    read), ``batch_incomplete_segments`` on the ``max_rounds`` backstop;
    and the port's ``rounds_enqueued`` (rounds issued, no-op and
    discarded ones included) and the rounds' ``depth_sum``,
    ``depth_max``, ``live_sum``, ``live_max``. On CUDA the loop runs
    under ``sync_debug(..., "error")``: any op that waits for the device
    raises, except the one designed read per execution."""
    if inflight < 1:
        raise ValueError("inflight must be >= 1")
    if stats is None:
        stats = {}
    for key in ("host_blocked_ms", "device_gap_ms"):
        stats.setdefault(key, 0.0)
    stats.setdefault("inflight_discards", 0)
    fifo: deque = deque()       # issued, unread executions
    leftovers: deque = deque()  # blocks of partly drained executions
    it = iter(staged)
    t_start = time.perf_counter()
    tip = {"rec": None, "idle_since": None, "flushing": False}
    total = 0

    def pull_group():
        try:
            return next(it)
        except StopIteration:
            return None

    def issue(loB, hiB, kind, tag):
        now = time.perf_counter()
        if tip["idle_since"] is not None:
            _t_ms(stats, "device_gap_ms", now - tip["idle_since"])
            tip["idle_since"] = None
        N = int(loB.shape[0])
        rounds = _resolve_batch_rounds(batch_rounds, segment_rounds, N)
        state = fixpoint.new_state(rounds, P.device)
        _, _, _, sv = batch_segment_fixpoint(
            P, loB, hiB, n, lift_levels=lift_levels, descent=descent,
            batch_rounds=rounds, state=state)
        stats["rounds_enqueued"] = stats.get("rounds_enqueued", 0) + rounds
        rec = {"lo": loB, "hi": hiB, "kind": kind, "tag": tag, "N": N,
               "read": _Readback(state, sv)}
        tip["rec"] = rec
        fifo.append(rec)

    def confirm(rec):
        """The blocking read of one execution's stats word."""
        nonlocal total
        t_pull = time.perf_counter()
        state, sv = rec["read"].wait()
        done, r, live, retired = (int(x) for x in sv.tolist())
        now = time.perf_counter()
        _t_ms(stats, "host_blocked_ms", now - t_pull)
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
        stats["batch_execs"] = stats.get("batch_execs", 0) + 1
        stats["batch_retired"] = stats.get("batch_retired", 0) + retired
        stats["device_rounds"] = stats.get("device_rounds", 0) + r
        for key, at, agg in (("depth_sum", fixpoint.DEPTH_SUM, sum),
                             ("depth_max", fixpoint.DEPTH_MAX, max),
                             ("live_sum", fixpoint.LIVE_SUM, sum),
                             ("live_max", fixpoint.LIVE_MAX, max)):
            stats[key] = agg((stats.get(key, 0), int(state[at])))
        if round_log is not None:
            round_log.extend(fixpoint.round_log(state, r))
        total += r
        if not fifo:
            # nothing in flight: the device idles until the next issue
            tip["idle_since"] = now
        drained = done >= rec["N"]
        if drained:
            # speculative re-dispatches of these blocks re-confirm them:
            # discard them unread
            while fifo and fifo[0]["kind"] == "spec":
                fifo.popleft()
                stats["inflight_discards"] += 1
            if not fifo:
                tip["idle_since"] = time.perf_counter()
        elif not (fifo and fifo[0]["kind"] == "spec"):
            # budget spent and no speculation of these blocks in flight:
            # re-queue them on the current table
            leftovers.append((rec["lo"], rec["hi"]))
        if on_confirm is not None and on_confirm(
                rec["tag"] if rec["kind"] == "group" else None, r, P):
            tip["flushing"] = True
        return drained

    nxt = pull_group()
    with sync_debug(P.device, "error"):
        while True:
            while len(fifo) < inflight:
                if leftovers:
                    issue(*leftovers.popleft(), "left", None)
                elif tip["flushing"]:
                    break  # flush barrier: only drain what is in flight
                elif nxt is not None:
                    # issue the group before pulling the next one, so the
                    # device folds while the host stages
                    issue(nxt[0], nxt[1], "group",
                          nxt[2] if len(nxt) > 2 else None)
                    nxt = pull_group()
                elif fifo:
                    # stream drained: speculate that the newest execution
                    # does not drain its blocks
                    issue(tip["rec"]["lo"], tip["rec"]["hi"], "spec", None)
                else:
                    break
            if not fifo:
                if tip["flushing"]:
                    tip["flushing"] = False
                    if on_flush is not None:
                        with sync_debug(P.device, "default"):
                            on_flush(P)
                    if nxt is not None:
                        continue
                break
            confirm(fifo.popleft())
            if total >= max_rounds:
                # backstop: drain and count what is in flight, then flag
                # the undrained remainder (a lower bound: the rest of the
                # stream is never staged)
                while fifo:
                    confirm(fifo.popleft())
                pending = len(leftovers) + (1 if nxt is not None else 0)
                if pending:
                    stats["batch_incomplete_segments"] = pending
                break
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
