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
retires, counts and ends the round in one pass. A round of the stream
descent is K1, ``scatter_min``, ``stream_descent`` (the climb level by
level and the squaring on two rows, in one launch) and ``climb_tail`` on
its climbed positions: four launches. On CPU tensors each kernel's plain
version runs instead.

The JAX ``lax.while_loop`` of :func:`batch_segment_fixpoint` becomes an
execution that the host enqueues whole, ``batch_rounds`` rounds each
ended in ``climb_tail``'s last block (``fixpoint.round_end_plain`` on the
CPU), with its stop conditions in a state tensor on the device: the host
reads nothing per round, and one stats word per execution, one execution
behind at pipeline depth >= 2 (:func:`fold_segments_pipelined`). Tables
and blocks are updated in place (the reference's arrays are immutable and
it donates them instead); the comment above
:func:`fold_segments_pipelined` says why that keeps its semantics.

The adaptive per-segment driver (:func:`fold_edges_adaptive_pos`, the
reference's other build path) folds one chunk's active buffer by short
segments with one read a segment: warm rounds on the stream descent,
stale rounds (``lift_stack`` once a segment, ``climb_tail`` each round),
the live pairs compacted (``ops/compact.py``), the tail finished by the
native Liu pass on the host (``core/native.py``) or by jump-mode rounds
(``climb_tail``'s jump mode, ``climb_jumps``).

Sentinel encoding: index n means "none"; pos[n] = order[n] = n; inert
edges are (n, n).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

from sheep_tpu_torch.core import native
from sheep_tpu_torch.ops import compact, fixpoint, lift
from sheep_tpu_torch.ops.gather import gather_clip
from sheep_tpu_torch.utils import fault

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
    out_hi, P, changed)``, ``changed`` a 0-d view of ``ctl``. ``ctl`` and
    the stack, or the stream descent's buffers (``lift.new_descent``), are
    allocated at the first call and reused by every later one."""

    def __init__(self, n: int, lift_levels: int, descent: str):
        self.n, self.lift_levels, self.descent = n, lift_levels, descent
        self.ctl = self.stack = self.scratch = None

    def __call__(self, lo, hi, P, state=None, batch_rounds=None):
        if state is None:
            loB, hiB = lo[None].clone(), hi[None].clone()
            self(loB, hiB, P, fixpoint.new_state(1, P.device), 1)
            return loB[0], hiB[0], P, self.ctl[lift.CHANGED]
        if batch_rounds is None:
            raise ValueError("_pos_round_body: an execution state needs its "
                             "budget, batch_rounds")
        L = self.lift_levels
        if self.ctl is None:
            self.ctl = lift.new_ctl(P.device)
            if self.descent == "exact":
                self.stack = lift.new_stack(len(P), L, P.device)
            else:
                self.scratch = lift.new_descent(len(P), lo.shape[-1], L,
                                                P.device)
        old_at_lo = gather_clip(P, lo, state)  # parent position BEFORE
        fixpoint.scatter_min(P, lo, hi, state)
        if self.descent == "exact":
            lift.lift_stack(P, self.stack, self.ctl, state)
            lift.climb_rows(lo, hi, old_at_lo, P, self.stack, self.ctl,
                            state, batch_rounds)
        else:
            # ctl gets rows L - 1 (the reference's depth L), pre the climb
            pre = lift.stream_descent(P, lo, hi, L, self.scratch, self.ctl,
                                      state)
            lift.climb_rows(lo, hi, old_at_lo, P, None, self.ctl, state,
                            batch_rounds, pre=pre)


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
    _enqueue_rounds(_pos_round_body(n, lift_levels, descent), loB, hiB, P,
                    state, batch_rounds)
    sv = fixpoint.exec_finish(loB, hiB, state, n)
    return loB, hiB, P, sv


def _enqueue_rounds(body, loB, hiB, P, state, budget: int) -> None:
    """``budget`` rounds of ``body`` on one execution. On CUDA every
    round is enqueued: a stopped execution's launches write nothing, and
    reading its state would wait for the card. On the CPU the state is
    read for free, so the loop ends with the execution."""
    on_cpu = P.device.type == "cpu"
    for _ in range(budget):
        if on_cpu and fixpoint.stopped(state):
            return
        body(loB, hiB, P, state, budget)


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
        with torch.cuda.device(state.device):
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
    tip = {"rec": None, "idle_since": None, "flushing": False, "issued": 0}
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
        # the dispatch's injection point: its fault unwinds the driver
        # with the chain un-drained, as an allocation failure in an
        # execution does
        tip["issued"] += 1
        fault.maybe_fail("dispatch", tip["issued"], kinds=("oom", "device"))
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


def fold_segments_batch(P: torch.Tensor, loB: torch.Tensor,
                        hiB: torch.Tensor, n: int, lift_levels: int = 0,
                        segment_rounds: int = 2, descent: str = "auto",
                        batch_rounds: int = 0, max_rounds: int = 1 << 20,
                        stats=None):
    """Fold one staged [N, C] block to its fixpoint, synchronously: the
    reference's ``fold_segments_batch``, which is
    :func:`fold_segments_pipelined` at depth 1 over the one block (one
    stats read an execution). ``P`` and the block are updated in place.
    Returns ``(P, total_rounds)``."""
    return fold_segments_pipelined(
        P, iter([(loB, hiB)]), n, inflight=1, lift_levels=lift_levels,
        segment_rounds=segment_rounds, descent=descent,
        batch_rounds=batch_rounds, max_rounds=max_rounds, stats=stats)



# -- the adaptive per-segment driver ----------------------------------------
#
# The reference's other build path (sheep_tpu/ops/elim.py:206-420 and
# :1055-1760), which it runs at dispatch_batch == 1 == inflight and by
# default on cpu-jax: one short segment of rounds on one active buffer at a
# time, one read of its stats word a segment, and host decisions between
# segments: cheap warm rounds first, stale lifting tables, compaction of
# the live pairs into a smaller buffer, then the tail handed to the native
# Liu pass on the host (or carried into the next chunk, or resolved in a
# worker thread), or, with no host tail, jump-mode rounds on the small
# buffer. A segment is a one-row execution of the batched machinery
# (``fixpoint.new_state``, ``exec_finish``) whose round budget is the
# segment's, so its rounds are the reference's ``_run_segment`` rounds,
# the round that changes nothing included. Its buffers are allocated per
# segment, at the buffer's current size.

def _run_segment(body, P: torch.Tensor, loP: torch.Tensor, hiP: torch.Tensor,
                 n: int, segment_rounds: int):
    """At most ``segment_rounds`` rounds of ``body`` over the 1-D active
    buffer (loP, hiP), ending after the first round that changes nothing.
    Returns ``(loP, hiP, P, sv)``, all updated in place, with ``sv`` int32[3]
    = (changed, rounds, live) on P's device, as the reference's
    ``_run_segment``: ``changed`` 0 once a round changed nothing, ``live``
    the live slots left."""
    loB, hiB = loP.view(1, -1), hiP.view(1, -1)
    state = fixpoint.new_state(segment_rounds, P.device)
    _enqueue_rounds(body, loB, hiB, P, state, segment_rounds)
    sv = fixpoint.exec_finish(loB, hiB, state, n)
    # a one-row execution: done is 1 exactly when a round changed nothing
    return loP, hiP, P, torch.cat((1 - sv[:1], sv[1:3]))


def fold_segment_pos(P, loP, hiP, n: int, lift_levels: int = 0,
                     segment_rounds: int = 32, descent: str = "auto"):
    """At most ``segment_rounds`` fresh rounds (:class:`_pos_round_body`)
    over the active buffer; the reference's function of the same name.
    Returns ``(loP, hiP, P, sv)`` (:func:`_run_segment`)."""
    lift_levels, descent = _resolve(n, lift_levels, descent)
    return _run_segment(_pos_round_body(n, lift_levels, descent), P, loP,
                        hiP, n, segment_rounds)


def build_lift_tables(P: torch.Tensor, n: int, lift_levels: int = 0):
    """The exact descent's lifting stack of the table P as it is now, for
    the stale rounds of one or more segments: ``(stack, ctl)``, the stack
    rows t_1 .. t_{d-1} (``lift.lift_stack``, its depth cut exact) and a
    control word whose ROWS holds d - 1. The reference's tuple of L - 1
    tables (its levels above d equal t_{d-1}, which the climb need not
    apply again)."""
    lift_levels, _ = _resolve(n, lift_levels, "exact")
    stack = lift.new_stack(len(P), lift_levels, P.device)
    ctl = lift.new_ctl(P.device)
    lift.lift_stack(P, stack, ctl)
    return stack, ctl


class _pos_round_body_stale:
    """The stale round (the reference's ``_pos_round_body_stale``): K1 for
    the table before the scatter, ``scatter_min``, then ``climb_tail`` over
    a stack built earlier (:func:`build_lift_tables`) and level 0 from the
    current table. The stack's depth in ``ctl[ROWS]`` is kept; the round's
    own words are zeroed each round."""

    def __init__(self, n: int, tables):
        self.stack, self.ctl = tables

    def __call__(self, loB, hiB, P, state, batch_rounds):
        self.ctl.narrow(0, lift.CHANGED, lift.CTL_WORDS - lift.CHANGED) \
            .zero_()
        old_at_lo = gather_clip(P, loB, state)
        fixpoint.scatter_min(P, loB, hiB, state)
        lift.climb_rows(loB, hiB, old_at_lo, P, self.stack, self.ctl, state,
                        batch_rounds)


def fold_segment_pos_stale(P, loP, hiP, tables, n: int,
                           segment_rounds: int = 32):
    """At most ``segment_rounds`` stale rounds over the stack ``tables``
    (:func:`build_lift_tables`), which the caller may reuse across
    segments. The same unique fixpoint; other round counts than fresh
    rounds."""
    return _run_segment(_pos_round_body_stale(n, tables), P, loP, hiP, n,
                        segment_rounds)


def fold_segment_pos_hoisted(P, loP, hiP, n: int, lift_levels: int = 0,
                             segment_rounds: int = 32):
    """:func:`fold_segment_pos_stale` on a stack built from the segment's
    entry table."""
    return fold_segment_pos_stale(P, loP, hiP,
                                  build_lift_tables(P, n, lift_levels), n,
                                  segment_rounds)


class _pos_small_round_body:
    """The jump-mode round of small buffers (the reference's
    ``_pos_small_round_body``): K1, ``scatter_min``, then ``climb_jumps``:
    ``jumps`` single parent steps over the current table, no O(V) stack."""

    def __init__(self, n: int, jumps: int):
        self.jumps, self.ctl = jumps, None

    def __call__(self, loB, hiB, P, state, batch_rounds):
        if self.ctl is None:
            self.ctl = lift.new_ctl(P.device)
        self.ctl.zero_()
        old_at_lo = gather_clip(P, loB, state)
        fixpoint.scatter_min(P, loB, hiB, state)
        lift.climb_rows(loB, hiB, old_at_lo, P, None, self.ctl, state,
                        batch_rounds, jumps=self.jumps)


def fold_segment_small_pos(P, loP, hiP, n: int, jumps: int = 8,
                           segment_rounds: int = 64):
    """At most ``segment_rounds`` jump-mode rounds; the reference's
    function of the same name."""
    return _run_segment(_pos_small_round_body(n, jumps), P, loP, hiP, n,
                        segment_rounds)


def _order_host(pos_host, n: int) -> np.ndarray:
    """Inverse permutation of pos_host with the sentinel slot appended."""
    order_host = np.empty(n + 1, dtype=np.int64)
    order_host[np.asarray(pos_host)] = np.arange(n, dtype=np.int64)
    order_host[n] = n
    return order_host


def _resolve_on_host(P_np, lo_np, hi_np, n: int, pos_host):
    """The native Liu pass over the table and the live pairs, on host
    arrays: ``(parent, new_parent)``, vertex space (int64, -1 roots)."""
    mask = lo_np != n
    pos_host = np.asarray(pos_host)
    order_host = _order_host(pos_host, n)
    edges = np.stack([order_host[lo_np[mask]], order_host[hi_np[mask]]],
                     axis=1)
    pp = P_np[pos_host]
    parent = np.where(pp < n, order_host[np.minimum(pp, n)],
                      NO_PARENT).astype(np.int64)
    return parent, native.build_elim_tree(edges, pos_host, parent.copy())


def _host_tail_finish_pos(P, loP, hiP, n: int, size: int, pos_host,
                          stats=None):
    """Finish the fixpoint on the host: the live pairs compacted to
    ``size`` (``compact_live``), the table and the pairs pulled, the native
    Liu pass, the new table pushed back (a new tensor on P's device).
    ``stats`` gets the seconds of the host's part, the pass and the array
    work around it, as ``t_host_tail_native_s``."""
    clo, chi = compact.compact_live(loP, hiP, n, size)
    P_np, lo_np, hi_np = P.cpu().numpy(), clo.cpu().numpy(), \
        chi.cpu().numpy()
    t0 = time.perf_counter()
    _, parent = _resolve_on_host(P_np, lo_np, hi_np, n, pos_host)
    if stats is not None:
        stats["t_host_tail_native_s"] = \
            stats.get("t_host_tail_native_s", 0.0) + time.perf_counter() - t0
    pos_host = np.asarray(pos_host)
    newP = np.full(n + 1, n, dtype=np.int32)
    has = parent >= 0
    newP[pos_host[has]] = pos_host[parent[has]]
    return torch.from_numpy(newP).to(P.device)


def host_tail_delta(P_snap, loP, hiP, n: int, pos_host):
    """Resolve a fixpoint tail on the host and return it as delta
    constraints: the (position, new parent position) pairs whose parent the
    native pass changed, int32 host arrays. Folded into any later fold they
    give the same unique fixpoint. The inputs are host arrays or CPU
    tensors that no one updates any more (:class:`TailOverlap` hands it
    host copies)."""
    def host(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    parent, new_parent = _resolve_on_host(host(P_snap), host(loP), host(hiP),
                                          n, pos_host)
    ch = np.nonzero(new_parent != parent)[0]
    # links are only ever added or improved, never removed
    assert len(ch) == 0 or new_parent[ch].min() >= 0
    pos_host = np.asarray(pos_host)
    return pos_host[ch].astype(np.int32), \
        pos_host[new_parent[ch]].astype(np.int32)


def pad_actives_pow2(dlo, dhi, n: int, device, floor: int = 1 << 14):
    """Host (dlo, dhi) constraints as an active buffer on ``device``, padded
    with (n, n) to a power-of-two length (at least ``floor``)."""
    size = pow2_at_least(max(1, len(dlo)), floor=floor)
    out_lo = np.full(size, n, dtype=np.int32)
    out_hi = np.full(size, n, dtype=np.int32)
    out_lo[:len(dlo)] = dlo
    out_hi[:len(dhi)] = dhi
    return torch.from_numpy(out_lo).to(device), \
        torch.from_numpy(out_hi).to(device)


def _host_copies(*ts):
    """Host copies of the tensors as they stand in stream order now, and
    the event after which they are complete (None on the CPU). The port's
    tables are updated in place by later folds, so a worker must not read
    them: on CUDA the copies go into pinned buffers behind the work
    enqueued so far, on the CPU they are clones."""
    if ts[0].device.type != "cuda":
        return [t.clone() for t in ts], None
    out = []
    for t in ts:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ready = torch.cuda.Event()
    ready.record()
    return out, ready


def _tail_job(copies, ready, n: int, pos_host):
    if ready is not None:
        ready.synchronize()
    return host_tail_delta(*copies, n, pos_host)


class TailOverlap:
    """Host tails resolved in one worker thread while the device folds the
    next chunk (the reference's class of the same name): :meth:`submit` a
    tail, :meth:`drain` finished resolutions, :meth:`take_inject` them as
    one padded active buffer on ``device``. A context manager, so that the
    worker is joined when the driving loop raises."""

    def __init__(self, n: int, pos_host, device):
        from concurrent.futures import ThreadPoolExecutor

        self.n, self.pos_host, self.device = n, pos_host, device
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: list = []   # in-flight futures, FIFO
        self._deltas: list = []    # resolved (dlo, dhi) awaiting injection

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._executor.shutdown(wait=True)
        return False

    def submit(self, P, loP, hiP) -> None:
        """Queue a live tail; the worker reads host copies taken now, in
        stream order, not the tensors (:func:`_host_copies`)."""
        copies, ready = _host_copies(P, loP, hiP)
        self._pending.append(self._executor.submit(
            _tail_job, copies, ready, self.n, self.pos_host))

    def drain(self, block: bool) -> None:
        while self._pending and (block or self._pending[0].done()):
            d = self._pending.pop(0).result()
            if len(d[0]):
                self._deltas.append(d)

    def take_inject(self):
        """All drained deltas as one padded (loP, hiP) buffer, or None."""
        if not self._deltas:
            return None
        dlo = np.concatenate([d[0] for d in self._deltas])
        dhi = np.concatenate([d[1] for d in self._deltas])
        self._deltas.clear()
        return pad_actives_pow2(dlo, dhi, self.n, self.device)


def _seed_ms_counters(stats: dict) -> None:
    for key in ("host_blocked_ms", "device_gap_ms", "h2d_staged_ms",
                "h2d_blocked_ms"):
        stats.setdefault(key, 0.0)


# the adaptive fold's fixed settings, the reference's defaults: the round
# backstop, the buffer size at and below which segments run in jump mode,
# and the single steps of a jump-mode round
MAX_ROUNDS = 1 << 20
SMALL_SIZE = 1 << 14
SMALL_JUMPS = 16


def _fold_adaptive(P, loP, hiP, n: int, lift_levels: int,
                   segment_rounds: int, host_tail: bool,
                   host_tail_threshold: int, warm_schedule: tuple, pos_host,
                   stats, carry_out: bool, stale_reuse: int):
    """The adaptive loop (the reference's
    ``_fold_adaptive_pos_impl_body``): returns ``(P, total, carry)``,
    ``carry`` None (converged or finished on the host) or the compacted
    still-live pairs (``carry_out``). One segment a turn, each ended by one
    read of its stats word:

    - warm: ``warm_schedule`` segments first, stream descent at few levels;
    - full: stale rounds on a stack rebuilt every ``stale_reuse`` segments
      (exact descent, segments of more than one round), else fresh rounds;
    - small (buffer <= ``SMALL_SIZE``): jump-mode rounds;

    then: stop once a segment changed nothing or nothing is live; at
    ``live <= host_tail_threshold`` (0: auto, max(2^16, size/8)) carry the
    tail out or finish it on the host; at ``live <= size/2`` compact the
    buffer to max(SMALL_SIZE, 2 live) rounded up to a power of two. The
    host tail needs ``pos_host`` and the native library (its build raises
    when it fails); ``host_tail=False`` is the way to jump mode."""
    for entry in warm_schedule:
        wr, wl = entry
        if wr < 1 or wl < 1:
            raise ValueError(
                f"warm_schedule entries must be (rounds >= 1, "
                f"lift_levels >= 1); got {tuple(entry)!r}")
    if host_tail and pos_host is None:
        raise ValueError("a host tail needs pos_host; pass host_tail=False "
                         "for jump-mode rounds instead")
    if host_tail:
        native.load()  # builds the native pass now, or raises
    if stats is None:
        stats = {}
    _seed_ms_counters(stats)
    total = 0
    size = int(loP.shape[0])
    if host_tail_threshold <= 0:
        host_tail_threshold = max(1 << 16, size // 8)
    warm = list(warm_schedule)
    tables = None
    segs_on_stack = 0

    def t_add(key: str, dt: float) -> None:
        stats[key] = stats.get(key, 0.0) + dt

    def count(key: str, by: int = 1) -> None:
        stats[key] = stats.get(key, 0) + by

    prev_ready = None  # when the previous segment's stats read returned
    while True:
        t0 = time.perf_counter()
        if prev_ready is not None:
            _t_ms(stats, "device_gap_ms", t0 - prev_ready)
        if warm and size > SMALL_SIZE:
            wrounds, wlevels = warm.pop(0)
            seg = min(wrounds, MAX_ROUNDS - total)
            loP, hiP, P, sv = fold_segment_pos(
                P, loP, hiP, n, lift_levels=wlevels, segment_rounds=seg,
                descent="stream")
            count("warm_segments")
            t_key = "t_warm_s"
        elif size > SMALL_SIZE:
            seg = min(segment_rounds, MAX_ROUNDS - total)
            rl, rd = _resolve(n, lift_levels, "auto")
            if rd == "exact" and seg > 1:
                if stale_reuse > 1:
                    if tables is None or segs_on_stack >= stale_reuse:
                        tables = None  # free the old stack first
                        tables = build_lift_tables(P, n, rl)
                        segs_on_stack = 0
                        count("stack_rebuilds")
                    loP, hiP, P, sv = fold_segment_pos_stale(
                        P, loP, hiP, tables, n, segment_rounds=seg)
                    segs_on_stack += 1
                else:
                    loP, hiP, P, sv = fold_segment_pos_hoisted(
                        P, loP, hiP, n, lift_levels=rl, segment_rounds=seg)
            else:
                loP, hiP, P, sv = fold_segment_pos(
                    P, loP, hiP, n, lift_levels=lift_levels,
                    segment_rounds=seg)
            count("full_segments")
            t_key = "t_full_s"
        else:
            seg = min(max(segment_rounds, 64), MAX_ROUNDS - total)
            loP, hiP, P, sv = fold_segment_small_pos(
                P, loP, hiP, n, jumps=SMALL_JUMPS, segment_rounds=seg)
            count("small_segments")
            t_key = "t_small_s"
        # the one designed read of a segment
        t_pull = time.perf_counter()
        changed, r, live = sv.tolist()
        prev_ready = time.perf_counter()
        _t_ms(stats, "host_blocked_ms", prev_ready - t_pull)
        count("host_syncs")
        t_add(t_key, time.perf_counter() - t0)
        total += r
        count("device_rounds", r)
        if not changed or live == 0 or total >= MAX_ROUNDS:
            return P, total, None
        if live <= host_tail_threshold:
            if carry_out:
                count("carried_tails")
                count("carried_live", live)
                cap = min(pow2_at_least(live, floor=1 << 14), size)
                return P, total, compact.compact_live(loP, hiP, n, cap)
            if host_tail:
                count("host_tails")
                count("host_tail_live", live)
                pull = pow2_at_least(live, floor=1 << 14)
                t0 = time.perf_counter()
                P = _host_tail_finish_pos(P, loP, hiP, n, min(pull, size),
                                          pos_host, stats)
                t_add("t_host_tail_s", time.perf_counter() - t0)
                return P, total, None
        if size > SMALL_SIZE and live <= size // 2:
            new_size = pow2_at_least(2 * live, floor=SMALL_SIZE)
            if new_size < size:
                loP, hiP = compact.compact_live(loP, hiP, n, new_size)
                size = new_size
                count("compactions")


# the options of the adaptive fold and their defaults, the reference's
ADAPTIVE_DEFAULTS = {"lift_levels": 0, "segment_rounds": 2,
                     "host_tail": True, "host_tail_threshold": 0,
                     "warm_schedule": (), "pos_host": None, "stats": None,
                     "stale_reuse": 1}


def _adaptive_options(opts: dict) -> dict:
    unknown = sorted(set(opts) - set(ADAPTIVE_DEFAULTS))
    if unknown:
        raise TypeError(f"unknown options: {unknown}")
    return {**ADAPTIVE_DEFAULTS, **opts}


def fold_edges_adaptive_pos(P, loP, hiP, n: int, **opts):
    """Fold the active buffer (loP, hiP) into P with the adaptive driver
    (:func:`_fold_adaptive`; options and defaults in
    ``ADAPTIVE_DEFAULTS``, the reference's). P and the buffer are updated
    in place until a compaction or a host tail replaces them. Returns
    ``(P, total_rounds)``."""
    P, total, _ = _fold_adaptive(P, loP, hiP, n, carry_out=False,
                                 **_adaptive_options(opts))
    return P, total


def fold_edges_adaptive_pos_carry(P, loP, hiP, n: int, **opts):
    """:func:`fold_edges_adaptive_pos` that hands the tail on instead of
    finishing it on the host: returns ``(P, total_rounds, (carry_lo,
    carry_hi))``, the still-live pairs compacted (empty when converged),
    for the caller to fold with the next chunk."""
    P, total, carry = _fold_adaptive(P, loP, hiP, n, carry_out=True,
                                     **_adaptive_options(opts))
    if carry is None:
        empty = torch.zeros(0, dtype=torch.int32, device=P.device)
        carry = (empty, empty.clone())
    return P, total, carry


def build_chunk_step_adaptive_pos(P, chunk, pos, pos_host, n: int,
                                  carry=None, carry_out: bool = False,
                                  **opts):
    """One streaming step of the adaptive build: orient the (C, 2) chunk,
    append ``carry`` (a previous fold's still-live pairs) when given, and
    fold; ``carry_out``: :func:`fold_edges_adaptive_pos_carry`, returning
    ``(P, rounds, carry)``, else :func:`fold_edges_adaptive_pos`, returning
    ``(P, rounds)``."""
    loP, hiP = orient_edges_pos(chunk, pos, n)
    if carry is not None and len(carry[0]):
        loP = torch.cat([loP, carry[0]])
        hiP = torch.cat([hiP, carry[1]])
    fold = fold_edges_adaptive_pos_carry if carry_out \
        else fold_edges_adaptive_pos
    return fold(P, loP, hiP, n, pos_host=pos_host, **opts)


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
