"""The vertex-sharded build (counterpart of ``sheep_tpu/parallel/bigv.py``).

For graphs whose vertex tables do not fit one device: every
vertex-indexed table (degrees, pos, the position-space forest P, the
assignment) is cut into contiguous blocks of B = ceil((n + 1) / D) rows,
shard s owning rows [s B, (s + 1) B), so a shard's table memory is
O(n / D). There is ONE distributed forest: every shard's active
constraints fold into it through routed collectives, and no partial
trees are merged. A fixpoint round, on every shard at once:

  1. routed scatter-min  the (loP, hiP) requests all-gathered; each owner
                         folds those that hit its block into its rows of
                         P and answers the pre- and post-round parents;
                         the answers come back by all-to-all and a min
                         (``ops/routed.py``: ``owned_scatter_min``,
                         ``routed_step``)
  2. the climb           routed P lookups: stream-descent lifting with
                         routed squarings at width B while the active
                         width is above ``TAIL_Q``, ``jumps - 1``
                         single-step lookups below it (``owned_gather``,
                         ``routed_step``)
  3. the local rewrite   retire, displace, became-loop, and the live
                         slots counted (``routed_round_end``); the psum
                         of the shards' counts decides whether the
                         segment goes on

A card holds the blocks of its shards as one (S, B) buffer (the shards of
one device are consecutive in the mesh), and each routed kernel is one
launch a card for all of them. Across cards the collectives are device
copies. On one card that holds every shard its (D, B) buffer is the whole
table, so the min over the owners' answers to a request is the table's
own entry: a round there is one host call (``routed.CardRound``) of a
cooperative scatter-min, ``routed_climb`` launches that read the card's
tables (a tail round's whole jump climb in one), ``routed_square``
launches for the squarings, and the round's end: 4 launches a tail round,
2L + 2 a lifting round of L levels.

The host drives the fixpoint in segments of at most ``segment_rounds``
rounds: it enqueues the segment's whole budget of rounds, every kernel of
a round returns at once after the segment has stopped (the segment state
of ``ops/routed.py``, one a card, its live words shared by device
copies), and it reads the state once a segment, under torch.cuda's sync
debug mode "error". The elimination order and the split run on the host
over O(n) arrays, as in the reference.

Several processes (``torch.distributed``): process p holds the blocks of
its ``n_local`` contiguous shards, the collectives cross the processes
(the live words of a round by one all-gather), the host tables are
assembled by an allgather of the processes' blocks, checkpoints hold each
process's own blocks, and a round never runs as one ``CardRound`` (no
card holds every shard). Each process synthesizes its own round-robin
chunks of a device stream on its cards; the residency manager and the
in-process retry are single-process only, as in the reference.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from sheep_tpu_torch import obs
from sheep_tpu_torch.io.devicestream import is_device_stream
from sheep_tpu_torch.ops import compact as compact_ops
from sheep_tpu_torch.ops import routed
from sheep_tpu_torch.ops.elim import _Readback, pow2_at_least, sync_debug
from sheep_tpu_torch.parallel.mesh import (Mesh, all_gather, all_to_all,
                                           process_allgather, psum)


def _card_view(views: list) -> torch.Tensor:
    """The (D, S, W) view of S requesters' (D, W) answers that lie evenly
    spaced in one storage (what ``all_to_all`` leaves for one device)."""
    v0 = views[0]
    step = views[1].storage_offset() - v0.storage_offset() \
        if len(views) > 1 else v0.shape[1]
    for i, v in enumerate(views):
        if v.untyped_storage().data_ptr() != \
                v0.untyped_storage().data_ptr() or \
                v.storage_offset() != v0.storage_offset() + i * step or \
                v.stride() != v0.stride():
            raise ValueError("the answers of a card are not one buffer")
    d, w = v0.shape
    return v0.as_strided((d, len(views), w), (v0.stride(0), step, 1))


class BigVPipeline:
    """The vertex-sharded build for a fixed (n, chunk_edges, mesh).

    ``jumps``: single-step climbs a tail round (the active width at most
    ``TAIL_Q``); bulk rounds climb by stream-descent lifting over
    ``lift_levels`` levels (0: n.bit_length()). ``hoist_bytes``: the
    device bytes a shard may spend on a lifting stack built once a
    segment (``SHEEP_BIGV_HOIST_BYTES`` is the default's fallback, 0 the
    per-round squaring). ``card_rounds``: each fixpoint round one
    :class:`~sheep_tpu_torch.ops.routed.CardRound`, which needs one device
    that holds every shard; None, the default, takes it on one CUDA card
    (True on a one-device CPU mesh runs its plain version)."""

    # the compaction's floor and the width below which rounds climb by
    # jumps (the reference's constants)
    MIN_Q = 1 << 9
    TAIL_Q = 1 << 13

    def __init__(self, n: int, chunk_edges: int, mesh, jumps: int = 128,
                 max_rounds: int = 1 << 20, segment_rounds: int = 16,
                 dedup_compact: bool = True, lift_levels: int = 0,
                 hoist_bytes: Optional[int] = None,
                 card_rounds: Optional[bool] = None):
        self.mesh = Mesh(mesh)
        d = self.mesh.size
        self.n = n
        self.cs = chunk_edges
        self.n_devices = d
        self.jumps = jumps
        self.max_rounds = max_rounds
        self.B = -(-(n + 1) // d)  # owned rows a shard
        self.rows = d * self.B      # padded global table length
        self.segment_rounds = segment_rounds
        self.dedup_compact = dedup_compact
        self.lift_levels = lift_levels if lift_levels > 0 \
            else max(1, int(n).bit_length())
        # an explicit value wins over the variable, which is the
        # default's fallback only
        self.hoist_bytes = hoist_bytes if hoist_bytes is not None \
            else int(os.environ.get("SHEEP_BIGV_HOIST_BYTES", "0"))
        self.hoist_levels = min(self.lift_levels - 1,
                                max(0, self.hoist_bytes // (4 * self.B)))
        # this process holds n_local contiguous shards, the first global
        # shard index base
        self.procs, self.proc = self.mesh.procs, self.mesh.proc
        self.n_local, self.base = len(self.mesh), self.mesh.base
        self.home = self.mesh[0]
        # the cards: (device, first global shard, shards), each device's
        # shards consecutive in the mesh
        cards: list = []
        for s, dev in enumerate(self.mesh, self.base):
            if cards and cards[-1][0] == dev:
                cards[-1][2] += 1
            elif any(c[0] == dev for c in cards):
                raise ValueError("the shards of a device must be "
                                 "consecutive in the mesh")
            else:
                cards.append([dev, s, 1])
        self.cards = [tuple(c) for c in cards]
        one = len(self.cards) == 1 and self.procs == 1
        if card_rounds and not one:
            raise ValueError("card_rounds needs one device that holds "
                             "every shard")
        self.card_rounds = one and self.home.type == "cuda" \
            if card_rounds is None else card_rounds

    # -- the collectives over the cards' buffers ---------------------------
    def _shards(self, blocks: list) -> list:
        """Per-shard views (rows) of per-card (S, ...) buffers."""
        return [b[i] for b, (_, _, S) in zip(blocks, self.cards)
                for i in range(S)]

    def _gather(self, blocks: list) -> list:
        """The all-gather of the shards' rows of per-card (S, W) buffers:
        one (D, W) block a card."""
        got = all_gather(self._shards(blocks), self.mesh)
        return [got[first - self.base] for _, first, _ in self.cards]

    def _exchange(self, answers: list) -> list:
        """The all-to-all of per-card (S, D, W) answers: one (D, S, W)
        view a card, its requesters' answers from every owner."""
        got = all_to_all(self._shards(answers), self.mesh)
        return [_card_view(got[first - self.base:first - self.base + S])
                for _, first, S in self.cards]

    def _lookup(self, tables: list, reqs: list, states=None) -> list:
        """``_lookup``: each card's (D, S, W) answers to its shards'
        requests ``reqs`` (S, W) against the block-sharded ``tables``."""
        g = self._gather(reqs)
        st = states or [None] * len(self.cards)
        return self._exchange([
            routed.owned_gather(t, first, q, self.n, s)
            for t, q, s, (_, first, _) in zip(tables, g, st, self.cards)])

    def _scatter_min(self, P: list, lo: list, hi: list, states) -> tuple:
        """``_scatter_min``: every shard's (lo -> hi) requests folded into
        the block-sharded P (in place); each card's (D, S, Q) answers
        before and after the fold to its shards' requests. Across
        processes the requests cross as one (lo | hi) gather and the
        answers as one (old | new) exchange: two collectives, not four."""
        if self.procs > 1:
            q = lo[0].shape[-1]
            g = self._gather([torch.cat([a, b], dim=-1)
                              for a, b in zip(lo, hi)])
            answers = [routed.owned_scatter_min(
                t, first, x[:, :q].contiguous(), x[:, q:].contiguous(),
                self.n, s) for t, x, s, (_, first, _) in
                zip(P, g, states, self.cards)]
            both = self._exchange([torch.cat(a, dim=-1) for a in answers])
            return [x[..., :q] for x in both], [x[..., q:] for x in both]
        glo, ghi = self._gather(lo), self._gather(hi)
        answers = [routed.owned_scatter_min(t, first, a, b, self.n, s)
                   for t, a, b, s, (_, first, _) in
                   zip(P, glo, ghi, states, self.cards)]
        return (self._exchange([a[0] for a in answers]),
                self._exchange([a[1] for a in answers]))

    def _resolve(self, tables: list, reqs: list) -> list:
        """``table[q]`` for every request of ``reqs`` (S, W) a card."""
        out = []
        for rep, q in zip(self._lookup(tables, reqs), reqs):
            got = torch.empty_like(q)
            routed.routed_step(rep, got)
            out.append(got)
        return out

    def _share_words(self, states: list) -> None:
        """Every card's live words copied into every other card's state
        (device copies: the psum's inputs); across processes, one
        all-gather of the words."""
        W = routed.WORDS
        if self.procs > 1:
            words = [st[W + first + i:W + first + i + 1]
                     for st, (_, first, S) in zip(states, self.cards)
                     for i in range(S)]
            got = all_gather(words, self.mesh)
            for st, (_, first, _) in zip(states, self.cards):
                st[W:].copy_(got[first - self.base].reshape(-1))
            return
        if len(self.cards) == 1:
            return
        for st, (_, first, S) in zip(states, self.cards):
            mine = st[W + first:W + first + S]
            for other in states:
                if other is not st:
                    other[W + first:W + first + S].copy_(mine)

    # -- the steps -----------------------------------------------------------
    def _ids(self, batch: list) -> list:
        """Each card's (S, C, 2) batch as (S, 2C) endpoint requests,
        clipped to [0, n] (u, v interleaved)."""
        return [b.reshape(b.shape[0], -1).clamp(0, self.n).to(torch.int32)
                .contiguous() for b in batch]

    def deg_zeros(self) -> list:
        """Per-card degree accumulators: S B owned rows and one spare slot
        that takes the requests a card does not own."""
        return [torch.zeros(S * self.B + 1, dtype=torch.int32, device=dev)
                for dev, _, S in self.cards]

    def deg_step(self, deg: list, batch: list) -> list:
        """The owned scatter-add of a batch's endpoints (clipped to
        [0, n]: slot n takes the padding, a self-loop counts twice)."""
        B = self.B
        for acc, g, (_, first, S) in zip(deg, self._gather(self._ids(batch)),
                                         self.cards):
            local = g.reshape(-1).long() - first * B
            spare = S * B
            local = torch.where((local >= 0) & (local < spare), local, spare)
            acc.index_add_(0, local, torch.ones_like(local,
                                                     dtype=torch.int32))
        return deg

    def orient_step(self, pos: list, batch: list):
        """A batch's endpoints -> oriented position pairs (loP, hiP) a
        card (S, C): two routed pos lookups; self-loops and sentinels
        become (n, n)."""
        n = self.n
        los, his = [], []
        for p in self._resolve(pos, self._ids(batch)):
            pu, pv = p[:, 0::2], p[:, 1::2]
            bad = (pu == pv) | (pu == n) | (pv == n)
            los.append(torch.minimum(pu, pv).masked_fill_(bad, n))
            his.append(torch.maximum(pu, pv).masked_fill_(bad, n))
        return los, his

    def score_step(self, batch: list, assign: list, k: int = 0,
                   keys: Optional[list] = None) -> torch.Tensor:
        """(cut, total) of a batch, summed over the cards (int64[2] on the
        home device), from routed part lookups; with ``keys`` (a list),
        each card's comm-volume keys (vertex * k + foreign part of the cut
        edges, distinct) are appended to it on the home device."""
        n = self.n
        parts = []
        for b, a in zip(batch, self._resolve(assign, self._ids(batch))):
            u, v = b[..., 0], b[..., 1]
            valid = (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)
            au, av = a[:, 0::2], a[:, 1::2]
            cut = valid & (au != av)
            parts.append(torch.stack([cut.sum(), valid.sum()]))
            if keys is not None:
                got = torch.cat([u[cut].long() * k + av[cut].long(),
                                 v[cut].long() * k + au[cut].long()])
                keys.append(torch.unique(got).to(self.home))
        return psum(parts, self.mesh)[0]

    def _program(self, P: list, bufs, stack) -> list:
        """The climb of a round as steps over per-card tables: (CLIMB, t)
        a lookup of t at the slots' cur and the rewrite below hi; (SQUARE,
        src, dst) dst = src[src]. ``jumps - 1`` lookups of P (tail); L
        lookups with a squaring between two (bulk); or P, the hoisted
        stack's levels, then the levels past the cap squared each round
        from the deepest hoisted table (``stack``, built once a segment).
        The squarings alternate between the two ``bufs``, so none reads
        the buffer it writes."""
        C, S = routed.CLIMB, routed.SQUARE
        if bufs is None:
            return [(C, P)] * (self.jumps - 1)
        if stack is None:
            prog, t = [], P
            for j in range(self.lift_levels):
                prog.append((C, t))
                if j < self.lift_levels - 1:
                    prog.append((S, t, bufs[j % 2]))
                    t = bufs[j % 2]
            return prog
        prog = [(C, t) for t in [P] + stack]
        t = stack[-1]
        for j in range(self.lift_levels - 1 - self.hoist_levels):
            prog += [(S, t, bufs[j % 2]), (C, bufs[j % 2])]
            t = bufs[j % 2]
        return prog

    def _hoist(self, P) -> list:
        """The stale lifting stack of a segment: ``hoist_levels`` routed
        squarings of the table (on one card that holds every shard, each a
        ``routed_square`` of the card's table)."""
        stack, t = [], P
        for _ in range(self.hoist_levels):
            if self.card_rounds:
                nxt = [routed.routed_square(t[0], self.n)]
            else:
                nxt = []
                for rep, (dev, _, S) in zip(self._lookup(t, t), self.cards):
                    out = torch.empty((S, self.B), dtype=torch.int32,
                                      device=dev)
                    routed.routed_step(rep, out)
                    nxt.append(out)
            stack.append(nxt)
            t = nxt
        return stack

    def fold_segment(self, P: list, lo: list, hi: list, lift: bool) -> tuple:
        """One segment: at most ``segment_rounds`` routed rounds over the
        cards' (S, Q) slots, lifting (``lift``) or by jumps, P, lo and hi
        updated in place. Every round is enqueued; the kernels of the
        rounds after the segment stopped do nothing. Returns (rounds, live,
        max_live), the segment state's one read: the rounds run, the psum
        of the live slots after the last round, the pmax of a shard's.
        With ``card_rounds`` each round is one
        :class:`~sheep_tpu_torch.ops.routed.CardRound`, which reads the
        card's own table and moves no answers; otherwise the collectives
        move the requests and answers between the cards."""
        n, d, seg = self.n, self.n_devices, self.segment_rounds
        st = [routed.new_state(d, dev) for dev, _, _ in self.cards]
        stack = self._hoist(P) if lift and self.hoist_levels else None
        bufs = [[torch.empty((S, self.B), dtype=torch.int32, device=dev)
                 for dev, _, S in self.cards] for _ in range(2)] \
            if lift else None
        program = self._program(P, bufs, stack)
        for s, lo_c, (_, first, _) in zip(st, lo, self.cards):
            routed.count_live(lo_c, n, first, s)
        self._share_words(st)
        for s, (_, first, S) in zip(st, self.cards):
            routed.account(s, first, S, seg, start=True)
        # on the CPU the host reads the state for free: the rounds after
        # the stop are skipped there
        cpu = self.home.type == "cpu"
        if self.card_rounds:
            rnd = routed.CardRound(
                P[0], lo[0], hi[0], n,
                [(step[0], *[t[0] for t in step[1:]]) for step in program],
                st[0], seg)
        else:
            rnd = functools.partial(
                self._round, P, lo, hi, [torch.empty_like(x) for x in lo],
                [torch.empty_like(x) for x in lo], program, st)
        for _ in range(seg):
            rnd()
            if cpu and bool(st[0][routed.STOP]):
                break
        # the designed read of the segment
        host, _ = _Readback(st[0], st[0]).wait()
        return (int(host[routed.ROUNDS]), int(host[routed.LIVE]),
                int(host[routed.MAX_LIVE]))

    def _round(self, P, lo, hi, cur, new, program, st) -> None:
        """One round through the collectives, card after card: the
        scatter-min, the climb's first step from its post-round answers,
        the climb ``program``, the round's end, the live words shared and
        the accounting."""
        n, seg = self.n, self.segment_rounds
        rep_old, rep_new = self._scatter_min(P, lo, hi, st)
        for c, rep in enumerate(rep_new):
            routed.routed_step(rep, cur[c], hi[c], lo[c], store=new[c],
                               state=st[c])
        for step in program:
            if step[0] == routed.CLIMB:
                for c, rep in enumerate(self._lookup(step[1], cur, st)):
                    routed.routed_step(rep, cur[c], hi[c], cur[c],
                                       state=st[c])
            else:
                _, src, dst = step
                for c, rep in enumerate(self._lookup(src, src, st)):
                    routed.routed_step(rep, dst[c], state=st[c])
        for c, (_, first, _) in enumerate(self.cards):
            routed.routed_round_end(rep_old[c], new[c], cur[c], lo[c], hi[c],
                                    n, first, st[c])
        self._share_words(st)
        for s, (_, first, S) in zip(st, self.cards):
            routed.account(s, first, S, seg)

    def compact_step(self, lo: list, hi: list, to_size: int):
        """Each shard's live pairs (distinct with ``dedup_compact``) packed
        in (lo, hi) order into ``to_size`` slots, then (n, n)."""
        out_lo, out_hi = [], []
        for lo_c, hi_c in zip(lo, hi):
            got = [compact_ops.compact_live(a, b, self.n, to_size,
                                            dedup=self.dedup_compact)
                   for a, b in zip(lo_c, hi_c)]
            out_lo.append(torch.stack([g[0] for g in got]))
            out_hi.append(torch.stack([g[1] for g in got]))
        return out_lo, out_hi

    # the reference's cost model of the collectives, so that
    # collective_ops and collective_bytes are its numbers
    def _round_cost(self, q: int, jumps: int, lift: bool):
        """(collective ops, bytes a shard receives) of one round at active
        width q: the scatter-min's two all-gathers and two all-to-alls,
        then ``jumps - 1`` lookup pairs, or L lookup pairs and the
        per-round squaring pairs at width B."""
        d = self.n_devices
        if lift:
            L, K = self.lift_levels, self.hoist_levels
            ops = 4 + 2 * L + 2 * (L - 1 - K)
            words = d * (4 * q + 2 * L * q + 2 * (L - 1 - K) * self.B)
        else:
            ops = 4 + 2 * (jumps - 1)
            words = d * ops * q
        return ops, 4 * words

    def _segment_cost(self, lift: bool):
        """(ops, bytes a shard) of a segment's hoisted stack."""
        if not lift or not self.hoist_levels:
            return 0, 0
        K = self.hoist_levels
        return 2 * K, 4 * self.n_devices * 2 * K * self.B

    def build_step(self, P: list, pos: list, batch: list,
                   stats: Optional[dict] = None) -> tuple:
        """Fold one batch (a (S, C, 2) tensor a card) into the distributed
        forest P (in place) in segments: lifting rounds while the active
        width is above ``TAIL_Q``, jump rounds below it, the slots
        compacted to ``pow2_at_least(2 max_live, MIN_Q)`` once the largest
        shard's live count is at most half the width. Returns (P, rounds).
        ``stats`` gets the reference's counters: collective_ops,
        collective_bytes, folded_bytes, host_syncs, device_rounds,
        q_rounds, compactions."""
        if stats is None:
            stats = {}
        lo, hi = self.orient_step(pos, batch)
        size = int(lo[0].shape[-1])
        stats["collective_ops"] = stats.get("collective_ops", 0) + 4
        stats["collective_bytes"] = stats.get("collective_bytes", 0) \
            + 4 * 4 * self.n_devices * size
        stats["folded_bytes"] = stats.get("folded_bytes", 0) \
            + sum(int(b.numel()) for b in batch) * 4 * self.procs
        total = 0
        with sync_debug(self.home, "error"):
            while True:
                lift = size > self.TAIL_Q
                jumps = 0 if lift else self.jumps
                r, live, ml = self.fold_segment(P, lo, hi, lift)
                total += r
                stats["host_syncs"] = stats.get("host_syncs", 0) + 1
                stats["device_rounds"] = stats.get("device_rounds", 0) + r
                ops, byts = self._round_cost(size, jumps, lift)
                seg_ops, seg_bytes = self._segment_cost(lift)
                stats["collective_ops"] += ops * r + seg_ops
                stats["collective_bytes"] += byts * r + seg_bytes
                stats["q_rounds"] = stats.get("q_rounds", 0) + size * r
                if live == 0 or total >= self.max_rounds:
                    return P, total
                if size > self.MIN_Q and ml <= size // 2:
                    new_size = pow2_at_least(2 * ml, floor=self.MIN_Q)
                    if new_size < size:
                        lo, hi = self.compact_step(lo, hi, new_size)
                        size = new_size
                        stats["compactions"] = \
                            stats.get("compactions", 0) + 1

    # -- host-side helpers ---------------------------------------------------
    def _put(self, batch) -> list:
        """A host (D, C, 2) batch, or per-shard device tensors (device
        synthesis), as one (S, C, 2) int32 tensor a card."""
        base = self.base
        if isinstance(batch, (list, tuple)):
            return [torch.stack(list(batch[f - base:f - base + S])).to(dev)
                    for dev, f, S in self.cards]
        return [torch.from_numpy(np.ascontiguousarray(
            batch[f - base:f - base + S], dtype=np.int32)).to(dev)
            for dev, f, S in self.cards]

    def _local_span(self):
        """This process's row span of a (rows,) block-sharded table."""
        w = self.n_local * self.B
        return self.proc * w, (self.proc + 1) * w

    def _local_block(self, blocks: list) -> np.ndarray:
        """Host copy of this process's rows of per-card blocks."""
        return np.concatenate([b.reshape(-1)[:S * self.B].cpu().numpy()
                               for b, (_, _, S) in zip(blocks, self.cards)])

    def _allgather_table(self, local: np.ndarray) -> np.ndarray:
        """The full (rows,) host table from the processes' local blocks:
        one allgather, the same table on every process (one process: its
        own)."""
        if self.procs == 1:
            return local
        return process_allgather(local).reshape(-1)

    def _place(self, local: np.ndarray) -> list:
        """A (rows,) host table as its per-card (S, B) blocks."""
        B, base = self.B, self.base
        return [torch.from_numpy(np.ascontiguousarray(
            local[(f - base) * B:(f - base + S) * B], dtype=np.int32)
            .reshape(S, B)).to(dev) for dev, f, S in self.cards]

    def _shard_table(self, host_table: np.ndarray) -> list:
        """An int32[n + 1] host table padded to (rows,) with the sentinel
        and placed block-sharded."""
        padded = np.full(self.rows, self.n, np.int32)
        padded[: self.n + 1] = host_table
        a, b = self._local_span()
        return self._place(padded[a:b])

    # -- the whole build ----------------------------------------------------
    def run(self, stream, k: int, alpha: float = 1.0,
            weights: Optional[str] = "unit", comm_volume: bool = False,
            timings: Optional[dict] = None, checkpointer=None,
            resume: bool = False) -> dict:
        """Degrees, host order, build, host split and score over the
        stream: the reference's ``BigVPipeline.run``. Checkpoints hold the
        local blocks (``deg_local``, int32 when the stream's edge bound
        proves no count can reach 2^31, else int64; ``ptable_local``),
        state format ``bigv-pos``; ``resume`` restarts from the latest.
        A build step is retried in process on an out-of-memory fault
        (``SHEEP_FAULT_INJECT=oom@dispatch:N``, or a real one at any point
        of the step): the step folds into a copy of the forest and of its
        counters, kept only when it succeeds, so a retry starts from the
        tables before the batch."""
        from sheep_tpu_torch.core import pure
        from sheep_tpu_torch.ops import score as score_ops
        from sheep_tpu_torch.ops.split import tree_split_host
        from sheep_tpu_torch.parallel.pipeline import (
            _PassThrough, device_lockstep_batches, iter_batches_lockstep,
            union_key_count, use_byte_range)
        from sheep_tpu_torch.utils import checkpoint as ckpt
        from sheep_tpu_torch.utils import retry as retry_mod
        from sheep_tpu_torch.utils import watchdog as wd_mod
        from sheep_tpu_torch.utils.fault import maybe_fail
        from sheep_tpu_torch.utils.prefetch import prefetch

        t = timings if timings is not None else {}
        n, cs, d = self.n, self.cs, self.n_devices
        home = self.home
        policy = retry_mod.RetryPolicy()
        bkinds = ("kill", "stall")
        # the in-process retry runs in one process only: a retry on one
        # rank would skew the collectives
        okinds = ("oom",) if self.procs == 1 else ()

        def _guarded(fn, where, stats):
            if self.procs > 1:
                return fn()
            while True:
                try:
                    return fn()
                except Exception as exc:  # noqa: BLE001, classified here
                    cls = retry_mod.classify(exc)
                    if not policy.admit(cls):
                        raise
                    stats["dispatch_retries"] = \
                        stats.get("dispatch_retries", 0) + 1
                    policy.backoff(cls, exc, where=where)

        def batches(start_chunk=0, src=None):
            src = stream if src is None else src
            if is_device_stream(src):
                return _PassThrough(device_lockstep_batches(
                    src, cs, self.n_local, n, self.mesh,
                    start_chunk=start_chunk, stats=build_stats,
                    proc=self.proc, procs=self.procs))
            return prefetch(iter_batches_lockstep(
                src, cs, self.n_local, n, self.proc, self.procs,
                start_chunk=start_chunk,
                byte_range=use_byte_range(src, self.procs)))

        ckpt_degraded0 = ckpt.degraded_events()
        meta = ckpt.stream_meta(stream, k, cs, weights=weights, alpha=alpha,
                                comm_volume=comm_volume,
                                state_format="bigv-pos",
                                devices=d, procs=self.procs,
                                text_byte_range=use_byte_range(
                                    stream, self.procs))
        state = ckpt.resume_state(checkpointer, meta, resume,
                                  raise_on_mismatch=self.procs == 1)
        if self.procs > 1 and checkpointer is not None and resume:
            state = ckpt.reconcile_multihost_resume(checkpointer, state,
                                                    meta)
        from_phase = ckpt.phase_index(state.phase) if state else 0

        root_sp = obs.begin("partition", backend="torch-bigv", k=int(k),
                            n=int(n), devices=int(d))
        stats_acc = obs.stats_accumulator()
        m_cheap = stream.num_edges_cheap
        obs.progress(backend="torch-bigv", k=int(k), edges_total=m_cheap)

        # one record across the passes: the ingest counters add up
        # wherever batches are made
        build_stats: dict = {}
        # an explicit SHEEP_CACHE_BYTES budget keeps the build's host
        # batches on the cards for the score pass and for retries
        rm = None
        if self.procs == 1 and not is_device_stream(stream):
            from sheep_tpu_torch.utils.residency import manager_from_env
            rm = manager_from_env(stats=build_stats)
        # a delta: stream's order comes from its base segment's degrees;
        # build and score stream the whole surviving multiset
        anchored = bool(getattr(stream, "order_anchor", False))
        deg_src = stream.anchor_stream() if anchored else None

        # pass 1: degrees, block-sharded int32 on the cards, folded into
        # the host's local block before any count could reach 2^31
        t0 = time.perf_counter()
        sp = obs.begin("degrees+sort")
        obs.progress(phase="degrees", chunks_done=0, edges_done=0)
        flush_every = max(1, (2**31 - 1) // max(2 * cs * d, 1))
        if state:
            deg_local = state.arrays["deg_local"].copy()
        else:
            ub = stream.num_edges_upper_bound
            deg_dtype = np.int64 if ub is None or 2 * ub >= 2**31 \
                else np.int32
            deg_local = np.zeros(self.n_local * self.B, dtype=deg_dtype)
        if from_phase == 0:
            start = state.chunk_idx if state else 0
            deg = self.deg_zeros()
            since = nb = 0
            with wd_mod.watched(self.procs, "bigv-degrees",
                                self.proc) as wd, \
                    batches(start, src=deg_src) as pf:
                for batch in pf:
                    deg = self.deg_step(deg, self._put(batch))
                    since += 1
                    nb += 1
                    wd.touch(f"degrees batch {nb}")
                    maybe_fail("degrees", nb, kinds=("kill", "stall"))
                    obs.chunk_progress(nb * d, cs, m_cheap)
                    at_ckpt = (checkpointer is not None and
                               checkpointer.due_span((nb - 1) * d, nb * d))
                    if since >= flush_every or at_ckpt:
                        deg_local += self._local_block(deg).astype(
                            deg_local.dtype)
                        deg = self.deg_zeros()
                        since = 0
                    if at_ckpt:
                        checkpointer.save("degrees", start + nb * d,
                                          {"deg_local": deg_local}, meta)
            deg_local += self._local_block(deg).astype(deg_local.dtype)
            deg = None
        deg_host = self._allgather_table(deg_local)[:n]

        # the elimination order on the host: one stable argsort over the
        # degrees (ties by id); only pos goes to the cards
        order = np.argsort(deg_host, kind="stable")
        pos_np = np.empty(n, dtype=np.int32)
        pos_np[order] = np.arange(n, dtype=np.int32)
        order_np = np.full(n + 1, n, dtype=np.int32)
        order_np[:n] = order
        del order
        pos_pad = np.empty(n + 1, dtype=np.int32)
        pos_pad[:n] = pos_np
        pos_pad[n] = n
        pos = self._shard_table(pos_pad)
        del pos_pad
        t["degrees+sort"] = time.perf_counter() - t0
        sp.end()

        # pass 2: the one distributed forest (position-indexed table)
        t0 = time.perf_counter()
        sp = obs.begin("build")
        obs.progress(phase="build", chunks_done=0, edges_done=0)
        launches0 = self._launches()
        total_rounds = 0
        if state and from_phase >= 2:
            P = self._place(state.arrays["ptable_local"])
        else:
            if state and state.phase == "build":
                P = self._place(state.arrays["ptable_local"])
                start = state.chunk_idx
            else:
                P = self._shard_table(np.full(n + 1, n, np.int32))
                start = 0
            nb = 0
            with wd_mod.watched(self.procs, "bigv-build",
                                self.proc) as wd, batches(start) as pf:
                for batch in pf:
                    seg_sp = obs.begin("segment", i=nb)

                    def _step(b=batch, i=nb, key=start + nb * d):
                        maybe_fail("dispatch", i + 1, kinds=okinds)
                        dev = rm.get(key) if rm is not None else None
                        if dev is None:
                            dev = self._put(b)
                            if rm is not None:
                                rm.admit(key, dev, int(b.nbytes))
                        # the folds write P in place: the step works on a
                        # copy (the reference's programs donate nothing,
                        # so its retry also starts from the pre-batch P)
                        work = [p.clone() for p in P]
                        trial = dict(build_stats)
                        got = self.build_step(work, pos, dev, stats=trial)
                        build_stats.update(trial)
                        return got

                    try:
                        P, rounds = _guarded(_step, "bigv.build",
                                             build_stats)
                        total_rounds += rounds
                        stats_acc.absorb(build_stats)
                        seg_sp.end(rounds=int(rounds))
                    finally:
                        # balances the span when a fault unwinds mid-batch
                        seg_sp.end()
                    nb += 1
                    wd.touch(f"build batch {nb}")
                    obs.chunk_progress(nb * d, cs, m_cheap)
                    maybe_fail("build", nb, kinds=bkinds)
                    if checkpointer is not None and \
                            checkpointer.due_span((nb - 1) * d, nb * d):
                        checkpointer.save(
                            "build", start + nb * d,
                            {"deg_local": deg_local,
                             "ptable_local": self._local_block(P)}, meta)
                        if rm is not None:
                            # a checkpoint is the eviction point: no retry
                            # reads behind it
                            rm.boundary(start + nb * d)
        P_host = self._allgather_table(self._local_block(P))[: n + 1]
        launches = self._launches()
        for key in launches:
            build_stats[f"{key}_launches"] = launches[key] - launches0[key]
        t["build"] = time.perf_counter() - t0
        stats_acc.absorb(build_stats)
        sp.end(fixpoint_rounds=int(total_rounds))

        # the split on the host: parent[v] = order[P[pos[v]]]
        t0 = time.perf_counter()
        sp = obs.begin("split")
        pp = P_host[pos_np]
        parent = np.where(pp < n, order_np[np.minimum(pp, n)], -1)
        del pp, order_np
        w = deg_host.astype(np.float64) if weights == "degree" else None
        assign_host = tree_split_host(parent, pos_np, k, weights=w,
                                      alpha=alpha)
        assign = self._shard_table(np.concatenate(
            [assign_host.astype(np.int32), np.zeros(1, np.int32)]))
        t["split"] = time.perf_counter() - t0
        sp.end()

        # pass 3: the score, from routed part lookups, summed over the
        # cards
        t0 = time.perf_counter()
        sp = obs.begin("score")
        obs.progress(phase="score", chunks_done=0, edges_done=0)
        acc = torch.zeros(2, dtype=torch.int64, device=home)
        cv_chunks: list = []
        start = 0
        if state and state.phase == "score":
            start = state.chunk_idx
            acc += torch.tensor([int(state.arrays["cut"]),
                                 int(state.arrays["total"])],
                                dtype=torch.int64, device=home)
            if comm_volume:
                cv_chunks.append(torch.from_numpy(np.asarray(
                    state.arrays["cv_keys"], np.int64)).to(home))
        nb = 0
        with wd_mod.watched(self.procs, "bigv-score",
                            self.proc) as wd, batches(start) as pf:
            for batch in pf:
                key = start + nb * d
                dev = rm.get(key) if rm is not None else None
                if dev is None:
                    dev = self._put(batch)
                    if rm is not None:
                        rm.admit(key, dev, int(batch.nbytes))
                keys = [] if comm_volume else None
                acc += self.score_step(dev, assign, k, keys)
                if comm_volume:
                    for got in keys:
                        score_ops.accumulate_cv_keys(cv_chunks, got)
                nb += 1
                wd.touch(f"score batch {nb}")
                maybe_fail("score", nb, kinds=("kill", "stall"))
                obs.chunk_progress(nb * d, cs, m_cheap)
                if checkpointer is not None and \
                        checkpointer.due_span((nb - 1) * d, nb * d):
                    cut_now, total_now = acc.tolist()
                    kept = ckpt.save_score_state(
                        checkpointer, start + nb * d, cut_now, total_now,
                        [score_ops.comm_volume_keys(cv_chunks).cpu()
                         .numpy()],
                        {"deg_local": deg_local,
                         "ptable_local": self._local_block(P)}, meta,
                        comm_volume)
                    cv_chunks = [torch.from_numpy(c).to(home) for c in kept]
                    if rm is not None:
                        rm.boundary(start + nb * d)
        cut, total = (int(x) for x in acc.tolist())
        cv = None
        if comm_volume and self.procs > 1:
            cv = union_key_count(
                score_ops.comm_volume_keys(cv_chunks).cpu().numpy(), home)
        elif comm_volume:
            cv = score_ops.comm_volume(cv_chunks)
        balance = pure.part_balance(
            assign_host, k, deg_host if weights == "degree" else None)
        t["score"] = time.perf_counter() - t0
        sp.end()
        root_sp.end()
        if checkpointer is not None:
            checkpointer.clear()
        if ckpt.degraded_events() > ckpt_degraded0:
            build_stats["checkpoint_degraded"] = \
                ckpt.degraded_events() - ckpt_degraded0
        return {
            "assignment": assign_host, "parent": parent.astype(np.int64),
            "pos": pos_np, "degrees": deg_host, "edge_cut": cut,
            "total_edges": total, "balance": balance, "comm_volume": cv,
            "k": k, "fixpoint_rounds": total_rounds,
            "build_stats": build_stats,
        }

    @staticmethod
    def _launches() -> dict:
        return {**routed.LAUNCHES, **compact_ops.LAUNCHES}
