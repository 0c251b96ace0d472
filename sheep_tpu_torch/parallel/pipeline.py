"""The sharded multi-device build (counterpart of
``sheep_tpu/parallel/pipeline.py``).

Edge chunks go round-robin to the shards of a :class:`~sheep_tpu_torch.
parallel.mesh.Mesh`, one chunk a shard a batch; each shard folds its
chunks into a forest of its own with the port's kernels; the forests are
merged by a butterfly; the score is summed over the shards. The three
crossings of the reference:

  1. shard scatter   host batches of D padded chunks, row i copied to
                     shard i's device (device streams synthesize row i
                     there with ``hash_chunk``)
  2. tree merge      log2(D) host-driven rounds: shard i sends its forest
                     to shard i ^ 2^r (``ppermute``), as boundary pairs
                     when the forests are sparse, else as the whole
                     table, and folds what it receives with the adaptive
                     fold; after the last round every shard holds the
                     global forest
  3. score           per-shard (cut, total), summed (``psum``)

Degrees are per-shard int32 partial counts, summed and flushed into int64
host totals before any count could reach 2^31.

State is a list of per-shard tensors: the position-space tables P (one
int32[n+1] a shard), the active buffers, the batches. The folds run on
each shard in turn and their stats words are reduced across the shards
(``pmax`` of changed, rounds and live; in the batched fold ``pmin`` of the
segments done and ``psum`` of the retired slots) into one word on the
first shard's device, read once: every host decision is the same for all
shards, so they stay in lockstep and the counters are the reference's.
The port folds in place where the reference donates its buffers: a
discarded speculative execution ran on drained (all-sentinel) blocks and
changed nothing, and a group's blocks are made fresh for it.

Several processes (``torch.distributed``, ``parallel/mesh.py``): each
holds ``n_local`` contiguous shards of the mesh, chunks go round robin
over the processes first (``iter_batches_lockstep``; plain text by byte
span), every process yields the same number of batches (stragglers pad
with all-sentinel ones), the collectives cross the processes, and the
merged forest is global shard 0's, broadcast. A device stream's chunks
are synthesized by each process on its own shards, its round-robin share
(``device_lockstep_batches``). The residency manager and the in-process
retry are single-process only, as in the reference: a fault kills every
process and the run resumes from its checkpoints, the processes agreeing
on one step first
(``utils/checkpoint.reconcile_multihost_resume``).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from sheep_tpu_torch import obs
from sheep_tpu_torch.io.devicestream import (is_device_stream,
                                             note_device_chunks)
from sheep_tpu_torch.ops import compact as compact_ops
from sheep_tpu_torch.ops import degrees as degrees_ops
from sheep_tpu_torch.ops import elim as elim_ops
from sheep_tpu_torch.ops import order as order_ops
from sheep_tpu_torch.ops import score as score_ops
from sheep_tpu_torch.parallel.mesh import (Mesh, pmax, pmin, ppermute, psum,
                                           shard0)


def chunk_batches(stream, chunk_edges: int, n_devices: int, n: int,
                  shard: int = 0, num_shards: int = 1, start_chunk: int = 0,
                  byte_range: bool = False):
    """Group the chunk stream into (D, C, 2) int32 host batches, one chunk
    a shard, padded with the sentinel vertex n: worker ``shard`` of
    ``num_shards`` takes its chunks of the stream (``EdgeStream.chunks``).
    Yields (batch, count)."""
    from sheep_tpu_torch.backends.torch_backend import pad_chunk

    batch = np.full((n_devices, chunk_edges, 2), n, dtype=np.int32)
    filled = 0
    for chunk in stream.chunks(chunk_edges, shard=shard,
                               num_shards=num_shards,
                               start_chunk=start_chunk,
                               byte_range=byte_range):
        batch[filled] = pad_chunk(chunk, chunk_edges, n)
        filled += 1
        if filled == n_devices:
            yield batch, filled
            batch = np.full((n_devices, chunk_edges, 2), n, dtype=np.int32)
            filled = 0
    if filled:
        yield batch, filled


def use_byte_range(stream, procs: int) -> bool:
    """Plain text files in multi-process runs split by byte span (the
    reference's rule); a single process never does."""
    return (procs > 1 and getattr(stream, "path", None) is not None
            and stream.fmt == "text")


def iter_batches_lockstep(stream, cs: int, rows: int, n: int, proc: int,
                          procs: int, start_chunk: int = 0,
                          byte_range: bool = False):
    """(rows, C, 2) host batches of process ``proc``'s share of the
    stream. With several processes every one yields the same number of
    batches, so the per-batch collectives stay in lockstep: stragglers pad
    with all-sentinel batches. The count comes from the stream's length
    (chunk i is process i % procs's), or, for byte spans, from one
    allgather of every process's own chunk count (local chunk j of
    process p is global chunk j * procs + p, so ``start_chunk`` skips as
    in the round-robin case)."""
    gen = (b for b, _ in chunk_batches(
        stream, cs, rows, n, shard=proc, num_shards=procs,
        start_chunk=start_chunk, byte_range=byte_range))
    if procs == 1:
        yield from gen
        return
    if byte_range:
        from sheep_tpu_torch.parallel.mesh import process_allgather

        mine = -(-stream.count_edges_in_span(proc, procs) // cs)
        counts = process_allgather(
            np.array([mine], dtype=np.int64)).reshape(-1)

        def owned(p):
            done = max(0, (start_chunk - p + procs - 1) // procs)
            return max(0, int(counts[p]) - done)
    else:
        total = -(-stream.num_edges // cs)

        def owned(p):  # chunks i in [start_chunk, total), i % procs == p
            full = max(0, (total - p + procs - 1) // procs)
            done = max(0, (start_chunk - p + procs - 1) // procs)
            return full - done

    nb = max(-(-owned(p) // rows) for p in range(procs))
    produced = 0
    for b in gen:
        yield b
        produced += 1
    empty = np.full((rows, cs, 2), n, np.int32)
    for _ in range(nb - produced):
        yield empty


def union_key_count(keys: np.ndarray, device=None) -> int:
    """The distinct comm-volume keys over every process, each of which saw
    its own chunks' cut edges: one padded allgather of the local keys (the
    reference's), then their union counted by ``torch.unique`` on
    ``device`` (None: the CPU): on an H100 machine's host, numpy's
    ``np.unique`` (its hashing path) took 17.2 s over the two processes'
    keys of the s22 build, most of that build's wall."""
    import torch

    from sheep_tpu_torch.parallel.mesh import process_allgather

    keys = np.asarray(keys, np.int64)
    lens = process_allgather(np.array([len(keys)], np.int64))
    pad = np.full(max(1, int(lens.max())), -1, np.int64)
    pad[:len(keys)] = keys
    every = process_allgather(pad)
    every = torch.from_numpy(every[every >= 0]).to(
        "cpu" if device is None else device)
    return int(torch.unique(every).numel())


def device_lockstep_batches(stream, cs: int, rows: int, n: int, mesh,
                            start_chunk: int = 0, stats=None,
                            proc: int = 0, procs: int = 1):
    """Batches synthesized on the shards' devices from a device stream
    (``io/devicestream.py``): batch b is a list whose row j is made by the
    stream's ``device_chunk`` (``hash_chunk``) on local shard j's device.
    That row is process ``proc``'s local chunk ``b * rows + j`` of the
    round robin, global chunk ``first + (b * rows + j) * procs`` where
    ``first`` is its first chunk at or past ``start_chunk``; with one
    process, global chunk ``start_chunk + b * rows + j``. Every process
    yields the same number of batches, and an index past the stream's end
    synthesizes the all-sentinel chunk, so the batches equal the host
    path's padded ones (:func:`iter_batches_lockstep`); no host bytes
    cross. Only real chunks are counted, those of every process, so each
    one reports the run's total."""
    total = stream.num_chunks(cs)

    def owned(p):  # chunks i in [start_chunk, total), i % procs == p
        return len(range(start_chunk + (p - start_chunk) % procs, total,
                         procs))

    first = start_chunk + (proc - start_chunk) % procs
    counts = [owned(p) for p in range(procs)]
    n_batches = max(-(-c // rows) for c in counts)
    for b in range(n_batches):
        shards = [stream.device_chunk(first + (b * rows + j) * procs, cs,
                                      n, dev)
                  for j, dev in enumerate(mesh)]
        note_device_chunks(stats, sum(min(rows, max(0, c - b * rows))
                                      for c in counts))
        yield shards


class _PassThrough:
    """The prefetcher's surface (with, iter, close) over a plain
    generator, for device-synthesized batches: there is no host read to
    overlap, and a worker's queue would hold device batches that no
    memory model counts."""

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return iter(self._gen)

    def close(self) -> None:
        close = getattr(self._gen, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "_PassThrough":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _grouped(iterable, batch: int):
    """Lists of up to ``batch`` consecutive items."""
    buf: list = []
    for item in iterable:
        buf.append(item)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf


class ShardedPipeline:
    """The sharded build for a fixed (n, chunk_edges, mesh)."""

    SMALL_SIZE = 1 << 14

    def __init__(self, n: int, chunk_edges: int, mesh, lift_levels: int = 0,
                 segment_rounds: int = 32, warm_schedule=((1, 8),),
                 dispatch_batch: int = 1, inflight: int = 1):
        """``dispatch_batch`` > 1 or ``inflight`` > 1 select the batched
        fold (N staged batches an execution, up to ``inflight`` executions
        in flight, one reduced stats word read an execution); otherwise
        each batch is folded by the adaptive per-segment loop. A resource
        fault in :meth:`run` may lower both for the rest of this
        pipeline's life."""
        self.n = n
        self.cs = chunk_edges
        self.mesh = Mesh(mesh)
        self.lift_levels = lift_levels
        self.dispatch_batch = max(1, int(dispatch_batch))
        if inflight < 1:
            raise ValueError("inflight must be >= 1 here (backends "
                             "resolve 0 = auto before constructing)")
        self.inflight = int(inflight)
        self.segment_rounds = segment_rounds
        self.warm_schedule = tuple(warm_schedule)
        # this process holds n_local contiguous shards of the d of the mesh
        d = self.mesh.size
        self.n_devices = d
        self.rounds = max(1, math.ceil(math.log2(d))) if d > 1 else 0
        self.procs, self.proc = self.mesh.procs, self.mesh.proc
        self.n_local = len(self.mesh)
        self.home = self.mesh[0]
        self._warm = [(wr, wl) for wr, wl in self.warm_schedule]

    # -- placement -------------------------------------------------------
    def _rows(self, arr) -> list:
        """Row i of a host array as a tensor of its own on shard i."""
        return [torch.from_numpy(np.array(arr[i], copy=True)).to(dev)
                for i, dev in enumerate(self.mesh)]

    def put_batch(self, batch) -> list:
        """A host (D, C, 2) batch, or a list of per-shard tensors (device
        synthesis), as one tensor a shard on the shard's device."""
        if isinstance(batch, (list, tuple)):
            return [t.to(dev) for t, dev in zip(batch, self.mesh)]
        return self._rows(batch)

    def put_replicated(self, arr) -> list:
        """One copy of a host array a device, handed to each shard."""
        host = torch.from_numpy(np.array(arr, copy=True))
        on = {}
        return [on.setdefault(dev, host.to(dev)) for dev in self.mesh]

    def replicate(self, t: torch.Tensor) -> list:
        """A tensor on the home device, replicated to each shard's."""
        on = {t.device: t}
        return [on.setdefault(dev, t.to(dev)) for dev in self.mesh]

    def init_degrees(self) -> list:
        return [torch.zeros(self.n + 1, dtype=torch.int32, device=dev)
                for dev in self.mesh]

    def init_forest(self) -> list:
        return [torch.full((self.n + 1,), self.n, dtype=torch.int32,
                           device=dev) for dev in self.mesh]

    # -- the per-shard steps ---------------------------------------------
    def deg_step(self, deg_all: list, batch_dev: list) -> list:
        for deg, chunk in zip(deg_all, batch_dev):
            degrees_ops.degree_chunk(deg, chunk, self.n)
        return deg_all

    def deg_reduce(self, deg_all: list) -> torch.Tensor:
        """The shards' int32 partial counts summed (int32, on the home
        device; the flush cadence keeps every sum below 2^31)."""
        return psum(deg_all, self.mesh)[0]

    def make_order(self, deg_total: list):
        """(pos, order), each replicated, from the int32 totals."""
        pos, order = order_ops.elimination_order(deg_total[0], self.n)
        return self.replicate(pos), self.replicate(order)

    def orient_step(self, batch_dev: list, pos: list):
        out = [elim_ops.orient_edges_pos(c, p, self.n)
               for c, p in zip(batch_dev, pos)]
        return [o[0] for o in out], [o[1] for o in out]

    def _fold_step(self, kind, P_all, lo_all, hi_all):
        """One segment on every shard: ``kind`` is "full", "small" or a
        warm (rounds, levels) entry. Returns the reduced word (any
        changed, max rounds, max live), int32[3] on the home device."""
        n, seg = self.n, self.segment_rounds
        svs = []
        for i in range(self.n_local):
            if kind == "small":
                lo2, hi2, Pn, sv = elim_ops.fold_segment_small_pos(
                    P_all[i], lo_all[i], hi_all[i], n,
                    segment_rounds=max(seg, 64))
            elif kind == "full":
                lo2, hi2, Pn, sv = elim_ops.fold_segment_pos(
                    P_all[i], lo_all[i], hi_all[i], n,
                    lift_levels=self.lift_levels, segment_rounds=seg)
            else:
                wr, wl = kind
                lo2, hi2, Pn, sv = elim_ops.fold_segment_pos(
                    P_all[i], lo_all[i], hi_all[i], n, lift_levels=wl,
                    segment_rounds=wr, descent="stream")
            P_all[i], lo_all[i], hi_all[i] = Pn, lo2, hi2
            svs.append(sv)
        return pmax(svs, self.mesh)[0]

    def live_count(self, lo_all: list) -> torch.Tensor:
        """The largest live count of the shards' buffers (0-d int32)."""
        return pmax([(lo != self.n).sum(dtype=torch.int32)
                     for lo in lo_all], self.mesh)[0]

    def compact_step(self, lo_all: list, hi_all: list, to_size: int):
        """Every shard's live pairs packed into ``to_size`` slots by
        ``compact_live``, duplicates kept as the reference's sharded
        compaction keeps them."""
        out = [compact_ops.compact_live(lo, hi, self.n, to_size,
                                        dedup=False)
               for lo, hi in zip(lo_all, hi_all)]
        return [o[0] for o in out], [o[1] for o in out]

    def exchange(self, P_all: list, cap0: int, r: int):
        """Butterfly round ``r``: shard i sends its forest to shard
        i ^ 2^r and receives the partner's as active constraints (in
        position space an entry p -> P[p] is the constraint (p, P[p])).
        ``cap0`` > 0 is the compact payload's capacity at round 0,
        doubling each round: the (position, parent) pairs of the first
        cap non-sentinel entries, the rest (n, n); 0, or a capacity whose
        pairs would outweigh the table, sends the table. A shard without a
        partner receives zeros, which become (n, n), as do entries >= n."""
        n, d = self.n, self.n_devices
        perm = [(i, i ^ (1 << r)) for i in range(d) if (i ^ (1 << r)) < d]
        cap = min(cap0 << r, n + 1) if cap0 else n + 1
        compact = 2 * cap < n + 1
        payload = []
        for table in P_all:
            if compact:
                dev = table.device
                mask = table[:n] != n
                rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
                slot = torch.where(mask & (rank < cap), rank, cap).long()
                sel = torch.full((cap + 1,), n, dtype=torch.int32,
                                 device=dev)
                # unselected entries land in the spare slot cap
                sel.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                                   device=dev))
                sel = sel[:cap]
                payload.append(torch.stack([sel, table[sel.long()]]))
            else:
                payload.append(table)
        recv = ppermute(payload, perm, self.mesh)
        lo_all, hi_all = [], []
        for i, got in enumerate(recv, self.mesh.base):
            if (i ^ (1 << r)) >= d:
                got.fill_(n)
            if compact:
                lo, hi = got[0], got[1]
                bad = (lo >= n) | (hi >= n)
                lo = torch.where(bad, n, lo)
                hi = torch.where(bad, n, hi)
            else:
                p = torch.arange(n + 1, dtype=torch.int32, device=got.device)
                has = got < n
                lo = torch.where(has, p, n)
                hi = torch.where(has, got, n)
            lo_all.append(lo)
            hi_all.append(hi)
        return lo_all, hi_all

    def to_minp(self, P: torch.Tensor, pos: list) -> torch.Tensor:
        """A position-space table -> the vertex-space minp (the
        checkpoints' and the result's encoding)."""
        return P[pos[0].long()]

    def max_occupancy(self, P_all: list) -> torch.Tensor:
        """The largest count of non-sentinel forest entries of a shard."""
        return pmax([(P[:self.n] != self.n).sum(dtype=torch.int32)
                     for P in P_all], self.mesh)[0]

    def score_step(self, batch_dev: list, assign: list) -> torch.Tensor:
        """(cut, total) of one batch summed over the shards, int64[2] on
        the home device."""
        parts = [torch.stack(score_ops.score_chunk(c, a, self.n))
                 for c, a in zip(batch_dev, assign)]
        return psum(parts, self.mesh)[0]

    def orient_batch_step(self, blocks_dev: list, pos: list):
        out = [elim_ops.orient_chunks_batch_pos(b, p, self.n)
               for b, p in zip(blocks_dev, pos)]
        return [o[0] for o in out], [o[1] for o in out]

    def fold_batch_step(self, P_all: list, loB_all: list, hiB_all: list):
        """One batched execution on every shard (``batch_segment_fixpoint``
        with the budget of ``segment_rounds`` a staged batch), in place.
        Returns the reduced word int32[4] on the home device: segments
        done (pmin: the slowest shard decides), rounds and live (pmax),
        retired (psum)."""
        br = max(1, self.segment_rounds) * self.dispatch_batch
        svs = []
        for P, loB, hiB in zip(P_all, loB_all, hiB_all):
            _, _, _, sv = elim_ops.batch_segment_fixpoint(
                P, loB, hiB, self.n, lift_levels=self.lift_levels,
                batch_rounds=br)
            svs.append(sv)
        m = self.mesh
        return torch.stack([pmin([s[0] for s in svs], m)[0],
                            pmax([s[1] for s in svs], m)[0],
                            pmax([s[2] for s in svs], m)[0],
                            psum([s[3] for s in svs], m)[0]])

    # -- the drivers -----------------------------------------------------
    def build_step_batch(self, P_all: list, blocks_dev: list, pos: list,
                         stats=None) -> list:
        """Fold ``dispatch_batch`` staged batches, a (N, C, 2) block a
        shard, into the shards' forests: one reduced stats word read an
        execution, up to ``inflight`` executions in flight. Each new one
        re-dispatches the blocks as the one before it leaves them, before
        that one's word is read; once a word shows every shard's block
        drained, the executions still unread are discarded (they ran on
        all-sentinel blocks and changed nothing). Returns P_all."""
        from sheep_tpu_torch.utils import fault

        loB, hiB = self.orient_batch_step(blocks_dev, pos)
        if stats is not None:
            elim_ops._seed_ms_counters(stats)
            stats["folded_bytes"] = stats.get("folded_bytes", 0) \
                + sum(int(b.numel()) for b in blocks_dev) * 4 * self.procs
        fifo: deque = deque()
        idle_since = None
        issued = 0
        with elim_ops.sync_debug(self.home, "error"):
            while True:
                while len(fifo) < self.inflight:
                    # the dispatch's injection point: its fault unwinds
                    # the group with executions in flight
                    issued += 1
                    # recoverable kinds only in one process: a retry on
                    # one rank would skew the collectives
                    fault.maybe_fail("dispatch", issued,
                                     kinds=("oom", "device")
                                     if self.procs == 1 else ())
                    if idle_since is not None and stats is not None:
                        elim_ops._t_ms(stats, "device_gap_ms",
                                       time.perf_counter() - idle_since)
                    idle_since = None
                    word = self.fold_batch_step(P_all, loB, hiB)
                    fifo.append(elim_ops._Readback(word, word))
                t_pull = time.perf_counter()
                _, word = fifo.popleft().wait()
                done, r, live, ret = (int(x) for x in word.tolist())
                now = time.perf_counter()
                if not fifo:
                    idle_since = now
                if stats is not None:
                    elim_ops._t_ms(stats, "host_blocked_ms", now - t_pull)
                    stats["host_syncs"] = stats.get("host_syncs", 0) + 1
                    stats["batch_execs"] = stats.get("batch_execs", 0) + 1
                    stats["batch_retired"] = \
                        stats.get("batch_retired", 0) + ret
                    stats["device_rounds"] = \
                        stats.get("device_rounds", 0) + r
                if done >= self.dispatch_batch:
                    if fifo and stats is not None:
                        stats["inflight_discards"] = \
                            stats.get("inflight_discards", 0) + len(fifo)
                    fifo.clear()
                    return P_all

    def _fold_actives(self, P_all: list, lo_all: list, hi_all: list,
                      skip_warm: bool = False, stats=None) -> list:
        """The adaptive fold of per-shard active buffers of one width:
        warm segments first (unless ``skip_warm``: a merge's buffer), full
        segments, jump-mode segments once the width is at most
        ``SMALL_SIZE``; after each, one read of the reduced word, and the
        buffers compacted to a power of two above twice the largest live
        count once it falls to a quarter of the width. ``stats`` gets
        ``host_syncs`` and ``device_rounds`` (the max over the shards)."""
        size = int(lo_all[0].shape[-1])
        warm = [] if skip_warm else list(self._warm)
        while True:
            if warm and size > self.SMALL_SIZE:
                kind = warm.pop(0)
            elif size <= self.SMALL_SIZE:
                kind = "small"
            else:
                kind = "full"
            changed, rounds, live = self._fold_step(
                kind, P_all, lo_all, hi_all).tolist()
            if stats is not None:
                stats["host_syncs"] = stats.get("host_syncs", 0) + 1
                stats["device_rounds"] = \
                    stats.get("device_rounds", 0) + rounds
            if not changed:
                return P_all
            if size > self.SMALL_SIZE and live <= size // 4:
                lo_all, hi_all, size = self._compact_to(
                    lo_all, hi_all, live, size)

    def _compact_to(self, lo_all: list, hi_all: list, live: int,
                    size: int):
        """Compact the buffers to the power of two at least ``2 * live``
        (at least ``SMALL_SIZE``), when that is smaller than ``size``."""
        new_size = elim_ops.pow2_at_least(2 * live, floor=self.SMALL_SIZE)
        if new_size >= size:
            return lo_all, hi_all, size
        lo_all, hi_all = self.compact_step(lo_all, hi_all, new_size)
        return lo_all, hi_all, new_size

    def build_step(self, P_all: list, batch_dev: list, pos: list,
                   stats=None) -> list:
        """Fold one batch into the shards' forests (the adaptive fold);
        ``stats`` also gets the staged edge bytes (``folded_bytes``)."""
        lo_all, hi_all = self.orient_step(batch_dev, pos)
        if stats is not None:
            stats["folded_bytes"] = stats.get("folded_bytes", 0) \
                + sum(int(b.numel()) for b in batch_dev) * 4 * self.procs
        return self._fold_actives(P_all, lo_all, hi_all, stats=stats)

    def merge(self, P_all: list, stats: Optional[dict] = None,
              consume: bool = False) -> torch.Tensor:
        """The global forest (position space, on the home device: global
        shard 0's, broadcast to every process) from the shards' forests,
        by the butterfly: log2(D) exchange rounds, each
        followed by the adaptive fold of what was received, right-sized
        first from its live count. One occupancy read picks the payload:
        compact pairs at capacity ``pow2_at_least(max occupancy, 1024)``
        doubling each round, while twice that is below n + 1, else the
        dense table. ``stats`` gets ``merge_payload_bytes`` (the bytes
        the rounds ship) and ``merge_mode``. The shards' tables are left
        as they were unless ``consume`` (a checkpoint merges mid-build
        and the build goes on from the unmerged forests, as the
        reference's)."""
        n = self.n
        cap0 = 0
        if self.rounds:
            if not consume:
                P_all = [P.clone() for P in P_all]
            c = elim_ops.pow2_at_least(int(self.max_occupancy(P_all)),
                                       floor=1024)
            if 2 * c < n + 1:
                cap0 = c
        for r in range(self.rounds):
            lo_all, hi_all = self.exchange(P_all, cap0, r)
            live = int(self.live_count(lo_all))
            if live == 0:
                continue
            lo_all, hi_all, _ = self._compact_to(
                lo_all, hi_all, live, int(lo_all[0].shape[-1]))
            P_all = self._fold_actives(P_all, lo_all, hi_all,
                                       skip_warm=True)
        if stats is not None:
            total = 0
            for r in range(self.rounds):
                cap = min(cap0 << r, n + 1) if cap0 else n + 1
                words = 2 * cap if 2 * cap < n + 1 else n + 1
                links = sum(1 for i in range(self.n_devices)
                            if (i ^ (1 << r)) < self.n_devices)
                total += 4 * words * links
            stats["merge_payload_bytes"] = \
                stats.get("merge_payload_bytes", 0) + total
            stats["merge_mode"] = "compact" if cap0 else "dense"
        return shard0(P_all, self.mesh)

    # -- batch supply ----------------------------------------------------
    def _use_byte_range(self, stream) -> bool:
        return use_byte_range(stream, self.procs)

    def _device_synth(self, stream) -> bool:
        return is_device_stream(stream)

    def iter_batches(self, stream, start_chunk: int = 0, stats=None):
        """Host (D, C, 2) batches, or per-shard device lists from a
        device stream."""
        if self._device_synth(stream):
            yield from device_lockstep_batches(
                stream, self.cs, self.n_local, self.n, self.mesh,
                start_chunk=start_chunk, stats=stats, proc=self.proc,
                procs=self.procs)
            return
        yield from iter_batches_lockstep(
            stream, self.cs, self.n_local, self.n, self.proc, self.procs,
            start_chunk=start_chunk, byte_range=self._use_byte_range(stream))

    def _staged_batches(self, stream, start_chunk: int = 0, stats=None,
                        group: int = 0):
        """The batches as a context manager: host batches read, parsed and
        padded on a prefetch worker, device batches made as they are
        taken; ``group`` > 0 yields lists of up to that many batches."""
        from sheep_tpu_torch.utils.prefetch import prefetch

        it = self.iter_batches(stream, start_chunk=start_chunk, stats=stats)
        if group:
            it = _grouped(it, group)
        if self._device_synth(stream):
            return _PassThrough(it)
        return prefetch(it)

    def _stage_group(self, group: list) -> list:
        """A group of N batches as one (N, C, 2) block a shard."""
        if isinstance(group[0], (list, tuple)):
            return [torch.stack([b[i] for b in group]).to(dev)
                    for i, dev in enumerate(self.mesh)]
        return self._rows(np.stack(group, axis=1))

    # -- the whole build -------------------------------------------------
    def run(self, stream, k: int, alpha: float = 1.0,
            weights: Optional[str] = "unit", comm_volume: bool = False,
            timings: Optional[dict] = None, checkpointer=None,
            resume: bool = False) -> dict:
        """Degrees, build and merge, split, score over the stream: the
        reference's ``ShardedPipeline.run``. ``timings`` gets each pass's
        seconds; ``checkpointer`` saves every ``checkpointer.every``
        chunks (the merged forest, not the per-shard stack), ``resume``
        restarts from its latest step (with several processes, the step
        they agree on). In one process the build is one retryable attempt
        from its last snapshot (``utils/retry.py``: an out-of-memory
        fault spills the cached batches or halves the dispatch knobs, a
        device loss saves the snapshot and checks the device); with
        several, a fault raises on its process and the watchdog ends the
        others."""
        from sheep_tpu_torch.backends.torch_backend import LAUNCH_KEYS
        from sheep_tpu_torch.core import pure
        from sheep_tpu_torch.ops import (fixpoint as fixpoint_ops,
                                         gather as gather_ops,
                                         lift as lift_ops)
        from sheep_tpu_torch.ops.split import tree_split_host
        from sheep_tpu_torch.utils import checkpoint as ckpt
        from sheep_tpu_torch.utils import retry as retry_mod
        from sheep_tpu_torch.utils import watchdog as wd_mod
        from sheep_tpu_torch.utils.fault import maybe_fail

        t = timings if timings is not None else {}
        n, cs, d = self.n, self.cs, self.n_devices
        home = self.home
        ckpt_degraded0 = ckpt.degraded_events()
        meta = ckpt.stream_meta(stream, k, cs, weights=weights, alpha=alpha,
                                comm_volume=comm_volume,
                                state_format="sharded", devices=d,
                                procs=self.procs,
                                text_byte_range=self._use_byte_range(stream))
        # several processes: a mismatch raises on all of them, in the
        # reconcile, and a one-step skew of their saves resumes at the
        # step they share
        state = ckpt.resume_state(checkpointer, meta, resume,
                                  raise_on_mismatch=self.procs == 1)
        if self.procs > 1 and checkpointer is not None and resume:
            state = ckpt.reconcile_multihost_resume(checkpointer, state,
                                                    meta)
        from_phase = ckpt.phase_index(state.phase) if state else 0

        root_sp = obs.begin("partition", backend="torch-sharded", k=int(k),
                            n=int(n), devices=int(d),
                            dispatch_batch=int(self.dispatch_batch),
                            inflight=int(self.inflight))
        stats_acc = obs.stats_accumulator()
        merge_acc = obs.stats_accumulator()
        m_cheap = stream.num_edges_cheap
        obs.progress(backend="torch-sharded", k=int(k), edges_total=m_cheap)

        # one record across the passes: the ingest counters add up
        # wherever batches are made
        build_stats: dict = {}
        # an explicit SHEEP_CACHE_BYTES budget keeps the build's host
        # batches on the shards for the score pass and for retries
        rm = None
        if self.procs == 1 and not self._device_synth(stream):
            from sheep_tpu_torch.utils.residency import manager_from_env
            rm = manager_from_env(stats=build_stats)
        # a delta: stream's order comes from its base segment's degrees;
        # build and score stream the whole surviving multiset
        anchored = bool(getattr(stream, "order_anchor", False))
        deg_stream = stream.anchor_stream() if anchored else stream

        # pass 1: degrees, int32 a shard, flushed into int64 host totals
        # before any count could reach 2^31
        t0 = time.perf_counter()
        sp = obs.begin("degrees+sort")
        obs.progress(phase="degrees", chunks_done=0, edges_done=0)
        flush_every = max(1, (2**31 - 1) // max(2 * cs * d, 1))
        if state:
            deg_host = state.arrays["deg"].copy()
        else:
            deg_host = np.zeros(n, dtype=np.int64)
        if from_phase == 0:
            start = state.chunk_idx if state else 0
            deg_all = self.init_degrees()
            since = batches = 0
            with wd_mod.watched(self.procs, "sharded-degrees",
                                self.proc) as wd, \
                    self._staged_batches(deg_stream, start,
                                         build_stats) as pf:
                for batch in pf:
                    deg_all = self.deg_step(deg_all, self.put_batch(batch))
                    since += 1
                    batches += 1
                    wd.touch(f"degrees batch {batches}")
                    maybe_fail("degrees", batches, kinds=("kill", "stall"))
                    obs.chunk_progress(batches * d, cs, m_cheap)
                    # the cadence is in chunks (a batch is d chunks)
                    at_ckpt = (checkpointer is not None and
                               checkpointer.due_span((batches - 1) * d,
                                                     batches * d))
                    if since >= flush_every or at_ckpt:
                        deg_host += self.deg_reduce(deg_all)[:n].cpu() \
                            .numpy().astype(np.int64)
                        deg_all = self.init_degrees()
                        since = 0
                    if at_ckpt:
                        checkpointer.save("degrees", start + batches * d,
                                          {"deg": deg_host}, meta)
            deg_host += self.deg_reduce(deg_all)[:n].cpu().numpy() \
                .astype(np.int64)
        # positions are ordinal: rank-compress totals past int32
        if deg_host.size and deg_host.max() >= 2**31:
            deg_rank = np.argsort(np.argsort(deg_host, kind="stable"),
                                  kind="stable")
        else:
            deg_rank = deg_host
        deg_total = self.put_replicated(
            np.concatenate([deg_rank, [0]]).astype(np.int32))
        pos, order = self.make_order(deg_total)
        order_host = order[0].cpu().numpy()
        t["degrees+sort"] = time.perf_counter() - t0
        sp.end()

        # pass 2: per-shard forests, then the butterfly merge; checkpoints
        # and the result keep the vertex-space minp
        t0 = time.perf_counter()
        sp = obs.begin("build+merge")
        obs.progress(phase="build", chunks_done=0, edges_done=0)
        counters = (gather_ops.LAUNCHES, lift_ops.LAUNCHES,
                    fixpoint_ops.LAUNCHES, compact_ops.LAUNCHES)
        launches0 = {key: v for c in counters for key, v in c.items()}
        merge_stats: dict = {}
        # the in-process retry runs in one process only: more keep the
        # kill and resume contract (and the watchdog's stall)
        bkinds = ("kill", "oom", "device", "stall") if self.procs == 1 \
            else ("kill", "stall")
        if state and from_phase >= 2:
            merged_minp = torch.from_numpy(
                np.asarray(state.arrays["merged"], np.int32)).to(home)
        else:
            # one retryable attempt from the snapshot (the merged forest
            # and the next chunk, a checkpoint's payload): merging is
            # associative and idempotent, so re-seeding shard 0 with it
            # and the others empty reaches the same fixpoint
            snap = {"idx": 0, "merged": None}
            if state and state.phase == "build":
                snap["idx"] = state.chunk_idx
                snap["merged"] = state.arrays["merged_partial"]

            def checkpoint_at(P_all, idx):
                partial = self.to_minp(
                    self.merge(P_all, stats=merge_stats), pos).cpu().numpy()
                snap["idx"] = idx
                snap["merged"] = partial
                checkpointer.save("build", idx,
                                  {"deg": deg_host,
                                   "merged_partial": partial}, meta)

            def build_attempt():
                fa = np.full((self.n_local, n + 1), n, np.int32)
                # the snapshot seeds global shard 0 alone
                if snap["merged"] is not None and self.proc == 0:
                    fa[0] = np.asarray(snap["merged"],
                                       dtype=np.int32)[order_host]
                P_all = self._rows(fa)
                start = snap["idx"]
                batches = 0
                with wd_mod.watched(self.procs, "sharded-build",
                                    self.proc) as wd:
                    if self.dispatch_batch > 1 or self.inflight > 1:
                        nb = self.dispatch_batch
                        build_stats["dispatch_batch"] = nb
                        build_stats["inflight_depth"] = self.inflight
                        empty = None
                        devsynth = self._device_synth(stream)
                        with self._staged_batches(stream, start,
                                                  build_stats,
                                                  group=nb) as pf:
                            for group in pf:
                                gl = len(group)
                                if gl < nb:
                                    if empty is None:
                                        # an all-sentinel batch, on the
                                        # shards when they synthesize
                                        empty = [torch.full(
                                            (cs, 2), n, dtype=torch.int32,
                                            device=dev)
                                            for dev in self.mesh] \
                                            if devsynth else np.full(
                                                (self.n_local, cs, 2), n,
                                                np.int32)
                                    group = group + [empty] * (nb - gl)
                                before = batches
                                dsp = obs.begin("dispatch", i=before,
                                                batches=gl)
                                try:
                                    P_all = self.build_step_batch(
                                        P_all, self._stage_group(group),
                                        pos, stats=build_stats)
                                finally:
                                    stats_acc.absorb(build_stats)
                                    dsp.end()
                                batches += gl
                                wd.touch(f"build batch {batches}")
                                obs.chunk_progress(batches * d, cs,
                                                   m_cheap)
                                for b in range(before + 1, batches + 1):
                                    maybe_fail("build", b, kinds=bkinds)
                                if checkpointer is not None and \
                                        checkpointer.due_span(
                                            before * d, batches * d):
                                    checkpoint_at(P_all,
                                                  start + batches * d)
                    else:
                        with self._staged_batches(stream, start,
                                                  build_stats) as pf:
                            for batch in pf:
                                seg_sp = obs.begin("segment", i=batches)
                                try:
                                    key = start + batches * d
                                    dev_batch = rm.get(key) \
                                        if rm is not None else None
                                    if dev_batch is None:
                                        dev_batch = self.put_batch(batch)
                                        if rm is not None:
                                            rm.admit(key, dev_batch,
                                                     int(batch.nbytes))
                                    P_all = self.build_step(
                                        P_all, dev_batch, pos,
                                        stats=build_stats)
                                finally:
                                    seg_sp.end()
                                batches += 1
                                wd.touch(f"build batch {batches}")
                                obs.chunk_progress(batches * d, cs,
                                                   m_cheap)
                                maybe_fail("build", batches, kinds=bkinds)
                                if checkpointer is not None and \
                                        checkpointer.due_span(
                                            (batches - 1) * d,
                                            batches * d):
                                    checkpoint_at(P_all,
                                                  start + batches * d)
                                    if rm is not None:
                                        # a checkpoint is the eviction
                                        # point: no retry reads behind it
                                        rm.boundary(start + batches * d)
                return P_all

            def on_resource():
                # the folds are in place: the memory model's donation
                nxt = retry_mod.degrade_dispatch(
                    n, cs, self.dispatch_batch, self.inflight, True,
                    build_stats, snap["idx"], residency=rm)
                if nxt is not None:
                    self.dispatch_batch, self.inflight = nxt

            def save_snapshot():
                if checkpointer is not None and \
                        snap["merged"] is not None:
                    checkpointer.save(
                        "build", snap["idx"],
                        {"deg": deg_host,
                         "merged_partial": snap["merged"]}, meta)

            def on_device_loss():
                retry_mod.recover_device_loss(build_stats, snap["idx"],
                                              save_snapshot,
                                              device=self.mesh.distinct())

            policy = retry_mod.RetryPolicy()
            while True:
                try:
                    P_all = build_attempt()
                    break
                except Exception as exc:  # noqa: BLE001, classified there
                    if self.procs > 1:
                        raise
                    retry_mod.handle_build_fault(
                        policy, exc, "sharded.build", build_stats,
                        on_resource=on_resource,
                        on_device_loss=on_device_loss)
                    stats_acc.absorb(build_stats)
            msp = obs.begin("merge", devices=int(d))
            merged_minp = self.to_minp(
                self.merge(P_all, stats=merge_stats, consume=True), pos)
            del P_all
            if home.type == "cuda":
                for dev in self.mesh.distinct():
                    torch.cuda.synchronize(dev)
            merge_acc.absorb(merge_stats)
            msp.end()
        launches = {key: v for c in counters for key, v in c.items()}
        for key, name in LAUNCH_KEYS.items():
            build_stats[key] = launches[name] - launches0[name]
        t["build+merge"] = time.perf_counter() - t0
        stats_acc.absorb(build_stats)
        sp.end()

        # the split, on the host
        t0 = time.perf_counter()
        with obs.span("split"):
            parent = elim_ops.minp_to_parent(merged_minp, order_host, n)
            pos_host = pos[0][:n].cpu().numpy()
            w = deg_host.astype(np.float64) if weights == "degree" else None
            assign_host = tree_split_host(parent, pos_host, k, weights=w,
                                          alpha=alpha)
            assign = self.put_replicated(
                np.concatenate([assign_host.astype(np.int32),
                                np.zeros(1, np.int32)]))
            t["split"] = time.perf_counter() - t0

        # pass 3: the score, summed over the shards
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
                cv_chunks.append(torch.from_numpy(
                    np.asarray(state.arrays["cv_keys"], np.int64)).to(home))
        batches = 0
        merged_host = None
        with wd_mod.watched(self.procs, "sharded-score",
                            self.proc) as wd, \
                self._staged_batches(stream, start, build_stats) as pf:
            for batch in pf:
                key = start + batches * d
                dev_batch = rm.get(key) if rm is not None else None
                if dev_batch is None:
                    dev_batch = self.put_batch(batch)
                    if rm is not None:
                        rm.admit(key, dev_batch, int(batch.nbytes))
                acc += self.score_step(dev_batch, assign)
                if comm_volume:
                    for c, a in zip(dev_batch, assign):
                        score_ops.accumulate_cv_keys(
                            cv_chunks,
                            score_ops.cut_pair_keys(c, a, n, k).to(home))
                batches += 1
                wd.touch(f"score batch {batches}")
                maybe_fail("score", batches, kinds=("kill", "stall"))
                obs.chunk_progress(batches * d, cs, m_cheap)
                if checkpointer is not None and \
                        checkpointer.due_span((batches - 1) * d,
                                              batches * d):
                    if merged_host is None:
                        merged_host = merged_minp.cpu().numpy()
                    cut_now, total_now = acc.tolist()
                    keys = score_ops.comm_volume_keys(cv_chunks) \
                        .cpu().numpy()
                    kept = ckpt.save_score_state(
                        checkpointer, start + batches * d, cut_now,
                        total_now, [keys],
                        {"deg": deg_host, "merged": merged_host},
                        meta, comm_volume)
                    cv_chunks = [torch.from_numpy(c).to(home) for c in kept]
                    if rm is not None:
                        rm.boundary(start + batches * d)
        cut, total = (int(x) for x in acc.tolist())
        cv = None
        if comm_volume and self.procs > 1:
            cv = union_key_count(
                score_ops.comm_volume_keys(cv_chunks).cpu().numpy(), home)
        elif comm_volume:
            cv = score_ops.comm_volume(cv_chunks)
        balance = pure.part_balance(assign_host, k,
                                    deg_host if weights == "degree"
                                    else None)
        t["score"] = time.perf_counter() - t0
        sp.end()
        root_sp.end()
        if checkpointer is not None:
            checkpointer.clear()
        if ckpt.degraded_events() > ckpt_degraded0:
            build_stats["checkpoint_degraded"] = \
                ckpt.degraded_events() - ckpt_degraded0
        return {
            "assignment": assign_host, "parent": parent, "pos": pos_host,
            "degrees": deg_host, "edge_cut": cut, "total_edges": total,
            "balance": balance, "comm_volume": cv, "k": k,
            "merge_stats": merge_stats, "build_stats": build_stats,
        }

