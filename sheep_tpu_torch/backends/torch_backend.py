"""Single-device PyTorch backend (counterpart of ``TpuBackend.partition`` in
``sheep_tpu/backends/tpu_backend.py``).

  degrees   scatter-add per chunk, int64 on the device
  sort      stable argsort of the degrees -> pos / order
  build     the fixpoint, by one of the reference's two drivers:
            batched: [N, C] position blocks of ``dispatch_batch`` chunks,
              up to ``inflight`` executions in flight
              (``elim.fold_segments_pipelined``);
            per segment, when N == 1 == D: one chunk at a time through the
              adaptive driver (``elim.build_chunk_step_adaptive_pos``:
              warm, stale and jump-mode segments, compaction, the host
              tail, or ``carry_tail`` / ``tail_overlap``)
  split     tree split on the host
  score     per-chunk cut counts and comm-volume keys on the device, for
            one assignment or, in ``partition_multi`` and
            ``score_stream``, several in one pass

Chunks are padded to a fixed (C, 2) shape with the sentinel vertex n, and
the last group of ``dispatch_batch`` chunks is filled with all-sentinel
chunks as the reference stages it, so the fixpoint runs the same rounds.
Streams that can synthesize chunks on the device (``io/devicestream.py``)
do so and never stage, each chunk counted in ``device_stream_chunks``;
others are read and padded on a worker thread and copied over through
the staged H2D ring (``utils/prefetch.py``), ``h2d_ring`` blocks ahead. ``inflight`` and ``h2d_ring`` of 0 resolve as the
reference's accelerator defaults: 2 on CUDA, 1 on the CPU;
``dispatch_batch`` of 0 as its auto sizing (:func:`resolve_dispatch_batch`:
1 on the CPU, which selects the per-segment driver there as in cpu-jax).

As the reference's, a partition keeps the padded chunks on the device
across its three passes within a budget (``cache_chunks``; the residency
tier of ``utils/residency.py``, spilling and reloading when the stream
outgrows it; the budget is the card's memory less the build's model on
CUDA, 0 on the CPU, ``SHEEP_CACHE_BYTES`` when set); it saves and resumes
chunk-level checkpoints (``utils/checkpoint.py``; the batched build only
at the pipeline's flush barrier); and it runs the build as one retryable
attempt from its last confirmed snapshot, spilling the cached chunks and
then halving the dispatch batch, depth or ring after an out-of-memory
fault, saving the snapshot and checking the device after a device loss
(``utils/retry.py``). The injection points of ``utils/fault.py`` are the
reference's: ``degrees``, ``build`` and ``score`` a chunk, ``dispatch`` an
execution issued.

A ``delta:`` stream (``io/deltalog.py``, ``order_anchor``) takes the
anchored order: its degrees pass reads the base segment alone, past the
chunk cache. ``partition_update`` folds a resident partition's delta
epochs (``sheep_tpu_torch/incremental.py``) through :meth:`_fold_delta`:
the delta's chunks, in groups of the dispatch batch, through the batched
fixpoint at depth 1 into the converged table.
"""

from __future__ import annotations

import gc
import os
import time
from contextlib import closing, nullcontext

import numpy as np
import torch

from sheep_tpu_torch import obs
from sheep_tpu_torch.core import pure
from sheep_tpu_torch.device import resolve_device
from sheep_tpu_torch.io.devicestream import (is_device_stream,
                                             note_device_chunks)
from sheep_tpu_torch.ops import compact as compact_ops
from sheep_tpu_torch.ops import degrees as degrees_ops
from sheep_tpu_torch.ops import elim as elim_ops
from sheep_tpu_torch.ops import gather as gather_ops
from sheep_tpu_torch.ops import lift as lift_ops
from sheep_tpu_torch.ops import order as order_ops
from sheep_tpu_torch.ops import score as score_ops
from sheep_tpu_torch.ops import split as split_ops
from sheep_tpu_torch.ops import fixpoint as fixpoint_ops
from sheep_tpu_torch.types import PartitionResult, check_vertex_range
from sheep_tpu_torch.utils.prefetch import H2DRing, prefetch
from sheep_tpu_torch.utils.residency import ResidencyManager


# diagnostics key -> kernel: the build's launches of each kernel
LAUNCH_KEYS = {"gather_launches": "gather_clip",
               "scatter_launches": "scatter_min",
               "lift_launches": "lift_stack",
               "stream_descent_launches": "stream_descent",
               "climb_launches": "climb_tail",
               "exec_finish_launches": "exec_finish",
               "climb_jumps_launches": "climb_jumps",
               "compact_launches": "compact_live"}


def pad_chunk(chunk: np.ndarray, size: int, n: int) -> np.ndarray:
    """Pad a (c, 2) chunk to (size, 2) int32 with the sentinel vertex n."""
    c = np.asarray(chunk, dtype=np.int64)
    if np.any(c >= np.iinfo(np.int32).max):
        raise ValueError("vertex id >= 2^31 in chunk; ids must fit int32")
    out = np.full((size, 2), n, dtype=np.int32)
    out[: len(c)] = c
    return out


def device_chunks(stream, cs: int, n: int, device, ring: int = 1,
                  stats=None, start_chunk: int = 0):
    """Padded (cs, 2) int32 chunks on ``device``, in stream order from
    chunk ``start_chunk`` (the reference's ``_upload_chunks``). A stream
    with ``device_chunk`` synthesizes them in place; any other is read and
    padded on a worker thread and staged through an :class:`H2DRing` of
    depth ``ring`` (counters into ``stats``)."""
    if is_device_stream(stream):
        for i in range(start_chunk, stream.num_chunks(cs)):
            note_device_chunks(stats)
            yield stream.device_chunk(i, cs, n, device)
        return
    with prefetch(pad_chunk(c, cs, n)
                  for c in stream.chunks(cs, start_chunk=start_chunk)) as pf, \
            H2DRing(pf, device, depth=ring, stats=stats) as staged:
        yield from staged


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _residency_chunks(stream, cs: int, n: int, device, rm, start_chunk: int,
                      ring: int = 1, stats=None):
    """Chunks served through a :class:`ResidencyManager` (the reference's
    ``_residency_chunks``): resident ones from the device, and from the
    first miss on read from the stream again, each offered for residence.
    The chunk just served stays leased until the next admission, so the
    eviction that admission may trigger does not count it reclaimable."""
    idx = start_chunk
    leased = None
    try:
        while True:
            ref = rm.get(idx)
            if ref is None:
                break
            rm.lease(idx)
            if leased is not None:
                rm.release(leased)
            leased = idx
            yield ref
            idx += 1
        if not rm.complete:
            for d in device_chunks(stream, cs, n, device, ring, stats, idx):
                if leased is not None:
                    rm.release(leased)
                    leased = None
                rm.admit(idx, d, _nbytes(d))
                rm.lease(idx)
                leased = idx
                yield d
                idx += 1
            if start_chunk == 0:
                rm.note_stream_end(idx)
    finally:
        if leased is not None:
            rm.release(leased)


class _ChunkCache:
    """A prefix of a stream's padded chunks kept on the device within
    ``budget`` bytes (the reference's ``_ChunkCache``): the served
    engine's cache, shared by the jobs of one input. Chunk i is cached
    only once chunks [0, i) are, so the cache is always a prefix of the
    stream; ``complete`` once it holds the whole stream."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self.chunks: list = []
        self.complete = False


class _ChunkCacheReader:
    """A read-only view of another job's :class:`_ChunkCache` (the
    reference's ``_ChunkCacheReader``): it serves the cached prefix and
    never appends, so a cache has one writer and any number of readers.
    Its budget of -1 stops :func:`_device_chunks` from growing it at the
    first chunk; a reader that outruns the writer streams the rest
    itself. The daemon's one dispatch thread makes every access, so no
    lock is needed."""

    budget = -1

    def __init__(self, cache: _ChunkCache):
        self._cache = cache

    @property
    def chunks(self):
        return self._cache.chunks

    @property
    def used(self):
        return self._cache.used

    @property
    def complete(self):
        return self._cache.complete


def _device_chunks(stream, cs: int, n: int, device, cache, start_chunk: int,
                   ring: int = 1, stats=None):
    """Padded (cs, 2) int32 chunks on the device from ``start_chunk``,
    through ``cache`` (the reference's ``_device_chunks``): a
    :class:`ResidencyManager`, a prefix :class:`_ChunkCache` or a
    :class:`_ChunkCacheReader` of one, or None. A prefix cache serves and
    fills only from the stream's head."""
    if isinstance(cache, ResidencyManager):
        yield from _residency_chunks(stream, cs, n, device, cache,
                                     start_chunk, ring, stats)
        return
    if cache is None or start_chunk != 0:
        yield from device_chunks(stream, cs, n, device, ring, stats,
                                 start_chunk)
        return
    yield from cache.chunks
    if cache.complete:
        return
    grow = True
    for d in device_chunks(stream, cs, n, device, ring, stats,
                           len(cache.chunks)):
        nb = _nbytes(d)
        if grow and cache.used + nb <= cache.budget:
            cache.chunks.append(d)
            cache.used += nb
        else:
            grow = False
        yield d
    if grow:
        cache.complete = True


def _grouped(blocks, batch: int):
    """Host (cs, 2) blocks stacked ``batch`` at a time into (g, cs, 2)
    blocks, the last one short."""
    group: list = []
    for b in blocks:
        group.append(b)
        if len(group) == batch:
            yield np.stack(group)
            group = []
    if group:
        yield np.stack(group)


def _device_chunk_groups(stream, cs: int, n: int, device, cache,
                         start_chunk: int, batch: int, ring: int = 1,
                         stats=None):
    """Lists of up to ``batch`` padded (cs, 2) int32 chunks on the device,
    the served engine's staged groups (the reference's
    ``_device_chunk_groups``). A host stream read past any cache is
    read, padded and stacked a whole group at a time on a worker thread
    and staged through the :class:`H2DRing`, ``ring`` groups ahead;
    device streams and cached chunks are grouped from the chunk
    iterator."""
    if batch <= 1:
        for d in _device_chunks(stream, cs, n, device, cache, start_chunk,
                                ring, stats):
            yield [d]
        return
    if cache is None and not is_device_stream(stream):
        with prefetch(_grouped((pad_chunk(c, cs, n) for c in stream.chunks(
                cs, start_chunk=start_chunk)), batch)) as pf, \
                H2DRing(pf, device, depth=max(1, ring),
                        stats=stats) as staged:
            for block in staged:
                yield list(block.unbind(0))
        return
    group: list = []
    for d in _device_chunks(stream, cs, n, device, cache, start_chunk, ring,
                            stats):
        group.append(d)
        if len(group) == batch:
            yield group
            group = []
    if group:
        yield group


def resolve_inflight(inflight: int, device) -> int:
    """Pipeline depth: an explicit D >= 1 passes; 0 (auto) is 2 on CUDA
    (one execution running while the previous one's stats word is read)
    and 1 on the CPU, as the reference's ``resolve_inflight``."""
    if inflight != 0:
        return max(1, int(inflight))
    return 2 if torch.device(device).type == "cuda" else 1


def resolve_h2d_ring(h2d_ring: int, device) -> int:
    """Staged H2D ring depth: an explicit D >= 1 passes; 0 (auto) is 2 on
    CUDA and 1 on the CPU, as the reference's ``resolve_h2d_ring``.
    Device streams never stage, whatever this says."""
    if h2d_ring != 0:
        return max(1, int(h2d_ring))
    return 2 if torch.device(device).type == "cuda" else 1


def device_memory_bytes(device) -> int:
    """The card's memory, ``total_memory`` of its properties: what stands
    for the reference's ``bytes_limit`` (the JAX allocator's limit) in the
    dispatch-batch model."""
    return int(torch.cuda.get_device_properties(device).total_memory)


def resolve_dispatch_batch(dispatch_batch: int, n: int, cs: int, device,
                           inflight: int = 1, donate: bool = False,
                           h2d_ring: int = 0) -> int:
    """Dispatch batch N, as the reference's ``resolve_dispatch_batch``: an
    explicit N >= 1 passes; 0 (auto) is 1 on the CPU (the per-segment
    driver) and on CUDA the largest power of two up to 16 whose build
    phase fits 0.9 of the card's memory by the model
    (``utils/membudget.dispatch_batch_for``)."""
    if dispatch_batch != 0:
        return max(1, int(dispatch_batch))
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    from sheep_tpu_torch.utils.membudget import dispatch_batch_for

    return dispatch_batch_for(int(0.9 * device_memory_bytes(device)), n, cs,
                              inflight=inflight, donate=donate,
                              h2d_ring=h2d_ring)


def _chunk_cache_budget(n: int, chunk_edges: int, device,
                        dispatch_batch: int = 1, inflight: int = 1,
                        donate: bool = False, h2d_ring: int = 0) -> int:
    """Device bytes the chunk cache may hold (the reference's
    ``_chunk_cache_budget``): ``SHEEP_CACHE_BYTES`` when set, on any
    device; else 0 on the CPU, where a cache would copy the stream in host
    memory to save a copy that does not exist; else 0.9 of the card's
    memory less the build's modeled peak and 1 GiB."""
    from sheep_tpu_torch.utils.membudget import build_phase_bytes

    env = os.environ.get("SHEEP_CACHE_BYTES")
    if env is not None:
        return max(0, int(env))
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    reserve = build_phase_bytes(
        n, chunk_edges, dispatch_batch=dispatch_batch, inflight=inflight,
        donate=donate, h2d_ring=h2d_ring)["total_bytes"] + (1 << 30)
    return max(0, int(0.9 * device_memory_bytes(device)) - reserve)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _score_chunks(chunks, parts: dict, n: int, comm_volume: bool, cut: dict,
                  total: torch.Tensor, cv_keys: dict, chunk_done=None) -> None:
    """Score every assignment of ``parts`` ({k: int32[n+1] on the device})
    against each chunk, into ``cut`` ({k: 0-d int64}), ``total`` and the
    key lists ``cv_keys`` in place; ``chunk_done()`` runs after each
    chunk."""
    for chunk in chunks:
        for i, (k, a) in enumerate(parts.items()):
            c, tt = score_ops.score_chunk(chunk, a, n)
            cut[k] += c
            if i == 0:
                total += tt
            if comm_volume:
                score_ops.accumulate_cv_keys(
                    cv_keys[k], score_ops.cut_pair_keys(chunk, a, n, k))
        if chunk_done is not None:
            chunk_done()


class TorchBackend:
    name = "torch"
    supports_checkpoint = True
    # partition_update folds delta epochs into a resident partition
    supports_incremental = True

    def __init__(self, chunk_edges: int = 1 << 22, dispatch_batch: int = 0,
                 alpha: float = 1.0, device=None, inflight: int = 0,
                 h2d_ring: int = 0, lift_levels: int = 0,
                 segment_rounds: int = 2, warm_schedule=None,
                 host_tail_threshold: int = -1, carry_tail=None,
                 tail_overlap=None, stale_reuse: int = 1,
                 cache_chunks: bool = True):
        """The reference's knobs and defaults. ``dispatch_batch``,
        ``inflight`` and ``h2d_ring`` of 0 are auto. The per-segment
        driver's: ``segment_rounds`` (rounds a segment; also the batched
        round budget a chunk), ``warm_schedule`` ((rounds, levels), ...;
        None: ((1, 8),)), ``host_tail_threshold`` (-1: C/2 on CUDA, auto
        on the CPU), ``carry_tail`` / ``tail_overlap`` (the per-chunk tail
        strategies; either one selects the per-segment driver),
        ``stale_reuse`` (full segments a lifting stack), ``lift_levels``
        (0: from n). ``cache_chunks`` keeps the chunks on the device
        across the passes, within the budget of
        :func:`_chunk_cache_budget`."""
        if dispatch_batch < 0:
            raise ValueError("dispatch_batch must be >= 0 (0 = auto)")
        if inflight < 0:
            raise ValueError("inflight must be >= 0 (0 = auto)")
        if h2d_ring < 0:
            raise ValueError("h2d_ring must be >= 0 (0 = auto)")
        if lift_levels < 0 or segment_rounds < 1 or stale_reuse < 1:
            raise ValueError("lift_levels must be >= 0, segment_rounds and "
                             "stale_reuse >= 1")
        if dispatch_batch > 1 and (carry_tail or tail_overlap):
            raise ValueError("dispatch_batch > 1 folds whole segments on "
                             "device; it excludes the per-chunk tail "
                             "strategies (carry_tail / tail_overlap)")
        if inflight > 1 and (carry_tail or tail_overlap):
            raise ValueError("inflight > 1 pipelines whole batched "
                             "executions; it excludes the per-chunk tail "
                             "strategies (carry_tail / tail_overlap)")
        if carry_tail and tail_overlap:
            raise ValueError("carry_tail and tail_overlap are mutually "
                             "exclusive tail strategies")
        self.inflight = int(inflight)
        self.h2d_ring = int(h2d_ring)
        self.chunk_edges = int(chunk_edges)
        self.dispatch_batch = int(dispatch_batch)
        self.alpha = alpha
        self.device = resolve_device(device)
        self.lift_levels = int(lift_levels)
        self.segment_rounds = int(segment_rounds)
        self.warm_schedule = ((1, 8),) if warm_schedule is None \
            else tuple(tuple(w) for w in warm_schedule)
        self.host_tail_threshold = int(host_tail_threshold)
        self.carry_tail = bool(carry_tail)
        self.tail_overlap = bool(tail_overlap)
        self.stale_reuse = int(stale_reuse)
        self.cache_chunks = bool(cache_chunks)


    def _tail_strategy(self) -> bool:
        return self.carry_tail or self.tail_overlap

    def partition_update(self, state, adds=None, deletes=None, **opts):
        """Apply one delta epoch to a resident
        :class:`~sheep_tpu_torch.incremental.PartitionState` (from
        :func:`~sheep_tpu_torch.incremental.begin_incremental`):
        :func:`~sheep_tpu_torch.incremental.apply_update` with ``opts``
        (``epoch``, ``score``, ``compact``, ``comm_volume``)."""
        from sheep_tpu_torch import incremental

        return incremental.apply_update(self, state, adds=adds,
                                        deletes=deletes, **opts)

    def _fold_delta(self, state, edges) -> None:
        """Fold a host batch of edges into ``state.minp``, the converged
        table, under the state's anchored order: the batch padded into
        power-of-two chunks (at least 2^10 edges, so the shapes stay few),
        staged in groups of the dispatch batch, each group oriented and
        folded by the batched fixpoint at depth 1 (one stats read an
        execution). The table goes up once and comes back once. Rounds add
        up in ``state.stats["update_rounds"]``, the fixpoint's counters in
        ``state.stats``."""
        n = state.n
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if not len(e):
            return
        dev = self.device
        cs = elim_ops.pow2_at_least(min(len(e), self.chunk_edges),
                                    floor=1 << 10)
        batch = 1 if self.dispatch_batch == 0 and self._tail_strategy() \
            else resolve_dispatch_batch(self.dispatch_batch, n, cs, dev)
        sentinel = np.asarray([n], np.int64)
        pos = torch.from_numpy(np.concatenate(
            [state.pos, sentinel]).astype(np.int32)).to(dev)
        P = torch.from_numpy(np.ascontiguousarray(
            state.minp[np.concatenate([state.order, sentinel])])).to(dev)
        stats = state.stats
        for g0 in range(0, len(e), batch * cs):
            group = np.stack([pad_chunk(e[off: off + cs], cs, n) for off
                              in range(g0, min(len(e), g0 + batch * cs),
                                       cs)])
            loB, hiB = elim_ops.orient_chunks_batch_pos(
                torch.from_numpy(group).to(dev), pos, n)
            P, rounds = elim_ops.fold_segments_batch(
                P, loB, hiB, n, segment_rounds=self.segment_rounds,
                stats=stats)
            stats["update_rounds"] = stats.get("update_rounds", 0) + rounds
        # the update's product: the one read of the table
        state.minp = P[pos.long()].cpu().numpy()

    def _staged_groups(self, chunks, cs: int, n: int, pos: torch.Tensor,
                       N: int):
        """([N, C] oriented position blocks, real chunks in the group), one
        per group of N chunks; the last group is filled with all-sentinel
        chunks."""
        dev = self.device
        group: list = []
        for chunk in chunks:
            group.append(chunk)
            if len(group) == N:
                yield (*elim_ops.orient_chunks_batch_pos(
                    torch.stack(group), pos, n), N)
                group = []
        if group:
            real = len(group)
            sentinel = torch.full((cs, 2), n, dtype=torch.int32, device=dev)
            group += [sentinel] * (N - real)
            yield (*elim_ops.orient_chunks_batch_pos(
                torch.stack(group), pos, n), real)

    def _build_per_segment(self, P, chunks, cs: int, n: int, pos, pos_host,
                           stats, carry=None, chunk_done=None, start=0,
                           stats_acc=obs.NULL_STATS):
        """The build at N == 1 == D, as the reference's: each chunk through
        the adaptive driver, its tail finished on the host, carried into
        the next chunk (``carry_tail``, the first from ``carry``) or
        resolved in a worker thread and folded back as delta pairs
        (``tail_overlap``); a carried tail left at the end is folded last.
        ``chunk_done(P, carry, flush)`` runs after each chunk and returns
        P; ``flush(P)``, given under ``tail_overlap``, folds every tail in
        flight into P and returns it. Each chunk's fold is a ``segment``
        span (``i``: its index in the stream, from ``start``), which
        ``stats_acc`` feeds ``stats`` into. Returns
        ``(P, total_rounds)``."""
        dev = self.device
        tail_at = self.host_tail_threshold
        if tail_at < 0:
            tail_at = cs // 2 if dev.type == "cuda" else 0
        fold_kw = dict(lift_levels=self.lift_levels,
                       segment_rounds=self.segment_rounds,
                       host_tail_threshold=tail_at,
                       stale_reuse=self.stale_reuse, stats=stats)
        overlap = self.tail_overlap and not self.carry_tail
        total = 0
        with (elim_ops.TailOverlap(n, pos_host, dev) if overlap
              else nullcontext()) as ov:

            def flush(P):
                # the saved state, and the end of the stream, must hold
                # the whole constraint multiset
                nonlocal total
                ov.drain(True)
                inj = ov.take_inject()
                if inj is not None:
                    P, rounds = elim_ops.fold_edges_adaptive_pos(
                        P, inj[0], inj[1], n, pos_host=pos_host, **fold_kw)
                    total += rounds
                return P

            for i, padded in enumerate(chunks, start):
                seg_sp = obs.begin("segment", i=i)
                try:
                    if overlap:
                        # resolved tails, without waiting, join this fold
                        ov.drain(False)
                        carry = ov.take_inject()
                    step = elim_ops.build_chunk_step_adaptive_pos(
                        P, padded, pos, pos_host, n, carry=carry,
                        carry_out=self.carry_tail or overlap,
                        warm_schedule=self.warm_schedule, **fold_kw)
                    if self.carry_tail:
                        P, rounds, carry = step
                    elif overlap:
                        P, rounds, tail = step
                        carry = None
                        if len(tail[0]):
                            stats["overlap_tails"] = \
                                stats.get("overlap_tails", 0) + 1
                            ov.submit(P, tail[0], tail[1])
                    else:
                        P, rounds = step
                    total += rounds
                    stats_acc.absorb(stats)
                    seg_sp.end(rounds=rounds)
                except BaseException as exc:
                    # a fault that unwinds the fold closes its span, so a
                    # recovered run still renders a whole tree
                    seg_sp.end(error=type(exc).__name__)
                    raise
                if chunk_done is not None:
                    P = chunk_done(P, carry, flush if overlap else None)
            if overlap:
                P = flush(P)
        if self.carry_tail and carry is not None and len(carry[0]):
            P, rounds = elim_ops.fold_edges_adaptive_pos(
                P, carry[0], carry[1], n, pos_host=pos_host, **fold_kw)
            total += rounds
        return P, total

    def partition(self, stream, k: int, weights: str = "unit",
                  comm_volume: bool = True, keep_tree: bool = False,
                  round_log=None, checkpointer=None,
                  resume: bool = False) -> PartitionResult:
        """``round_log``, a list, receives (depth, live slots) of every
        counted fixpoint round of the batched driver, from the executions'
        device logs (the per-segment driver logs none). ``checkpointer``
        (a :class:`~sheep_tpu_torch.utils.checkpoint.Checkpointer`) saves
        the run every ``checkpointer.every`` chunks; ``resume`` starts from
        its latest step, which must be of this run (the reference's
        fingerprint and format, so a step of either package resumes in the
        other)."""
        from sheep_tpu_torch.utils import checkpoint as ckpt
        from sheep_tpu_torch.utils import retry as retry_mod
        from sheep_tpu_torch.utils.fault import maybe_fail

        dev = self.device
        ckpt_degraded0 = ckpt.degraded_events()
        # auto defers to an explicit per-chunk tail strategy, as the
        # reference's
        inflight = 1 if self.inflight == 0 and self._tail_strategy() \
            else resolve_inflight(self.inflight, dev)
        t = {}
        cs = stream.clamp_chunk_edges(self.chunk_edges)
        t0 = time.perf_counter()
        n = stream.num_vertices
        check_vertex_range(n)
        # the trace's spans and events, as the reference's; each value
        # passed to them is a host number already
        root_sp = obs.begin("partition", backend=self.name, k=int(k),
                            n=int(n), chunk_edges=int(cs))
        stats_acc = obs.stats_accumulator()
        m_cheap = stream.num_edges_cheap
        obs.progress(backend=self.name, k=int(k), edges_total=m_cheap,
                     chunks_total=-(-m_cheap // cs) if m_cheap else None)
        carry_mode = self.carry_tail
        meta = ckpt.stream_meta(stream, k, cs, weights=weights,
                                alpha=self.alpha, comm_volume=comm_volume,
                                state_format="minp_carry" if carry_mode
                                else "minp")
        state = ckpt.resume_state(checkpointer, meta, resume)
        from_phase = ckpt.phase_index(state.phase) if state else 0
        ring = resolve_h2d_ring(self.h2d_ring, dev)
        # the model counts the ring only for streams that stage
        ring_model = 0 if is_device_stream(stream) else ring
        if self.dispatch_batch == 0 and self._tail_strategy():
            batch = 1
        else:
            # donation as the reference's default: the batched path
            # updates its buffers in place
            batch = resolve_dispatch_batch(
                self.dispatch_batch, n, cs, dev, inflight=inflight,
                donate=True, h2d_ring=ring_model)
        donate = batch > 1 or inflight > 1
        cache_budget = _chunk_cache_budget(
            n, cs, dev, dispatch_batch=batch, inflight=inflight,
            donate=donate, h2d_ring=ring_model) if self.cache_chunks else 0
        # one record across the three streaming passes: the ingest and
        # residency counters add up wherever chunks cross, the build adds
        # its own
        stats: dict = {"dispatch_batch": batch, "inflight_depth": inflight,
                       "h2d_staged_ms": 0.0, "h2d_blocked_ms": 0.0}
        cache = ResidencyManager(cache_budget, stats=stats) \
            if cache_budget > 0 else None

        def chunks(start: int, ring: int):
            return closing(_device_chunks(stream, cs, n, dev, cache, start,
                                          ring, stats))

        def boundary(confirmed: int) -> None:
            # a checkpoint is the residency tier's eviction point: no retry
            # reads the chunks behind it again
            if cache is not None:
                cache.boundary(confirmed)

        sp = obs.begin("degrees")
        obs.progress(phase="degrees", chunks_done=0, edges_done=0)
        deg = degrees_ops.init_degrees(n, dev)
        deg_saved = state.arrays["deg"] if state else None
        # a delta: stream's order comes from its base segment's degrees
        # (into the whole vertex space), read past the cache: the cache
        # holds the surviving multiset the build and the score read
        anchored = bool(getattr(stream, "order_anchor", False))
        if from_phase == 0:
            start = state.chunk_idx if state else 0
            idx = start
            with (closing(_device_chunks(stream.anchor_stream(), cs, n, dev,
                                         None, start, ring, stats))
                  if anchored else chunks(start, ring)) as it:
                for chunk in it:
                    degrees_ops.degree_chunk(deg, chunk, n)
                    idx += 1
                    maybe_fail("degrees", idx - start)
                    obs.chunk_progress(idx, cs, m_cheap)
                    if checkpointer is not None and \
                            checkpointer.due(idx - start):
                        # the device keeps int64 totals: the saved ones
                        # are pulled as they stand
                        now = deg[:n].cpu().numpy()
                        if deg_saved is not None:
                            now = now + deg_saved
                        checkpointer.save("degrees", idx, {"deg": now}, meta)
                        boundary(idx)
        if deg_saved is not None:
            deg[:n] += torch.from_numpy(deg_saved).to(dev)
        deg_host = deg[:n].cpu().numpy()
        t["degrees"] = time.perf_counter() - t0
        sp.end()

        t0 = time.perf_counter()
        with obs.span("sort"):
            pos, order = order_ops.elimination_order(deg, n)
            del deg
            _sync(dev)
            t["sort"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sp = obs.begin("build")
        obs.progress(phase="build", chunks_done=0, edges_done=0)
        counters = (gather_ops.LAUNCHES, lift_ops.LAUNCHES,
                    fixpoint_ops.LAUNCHES, compact_ops.LAUNCHES)
        launches0 = {k: v for c in counters for k, v in c.items()}
        pos_l = pos.long()
        pos_host = pos[:n].cpu().numpy()
        total_rounds = 0
        if state and from_phase >= 2:
            minp = torch.from_numpy(state.arrays["minp"]).to(dev)
        else:
            # The build is one retryable attempt from ``snap``, the last
            # confirmed state (vertex-space minp and the next chunk, a
            # checkpoint's payload, banked at every save). Out of memory:
            # spill the cached chunks or halve a dispatch knob, then fold
            # again from the snapshot; device loss: save the snapshot,
            # check the device, fold again. The forest is the same either
            # way: it is the unique fixpoint of the constraint multiset at
            # any batch shape.
            snap = {"idx": 0, "minp": None, "carry": None}
            if state and state.phase == "build":
                snap["idx"] = state.chunk_idx
                snap["minp"] = state.arrays["minp"]
                if carry_mode and "carry_lo" in state.arrays:
                    snap["carry"] = (state.arrays["carry_lo"],
                                     state.arrays["carry_hi"])
            cfg = {"batch": batch, "inflight": inflight, "ring": ring}

            def save(idx: int, arrays: dict) -> None:
                snap["idx"] = idx
                snap["minp"] = arrays["minp"]
                if carry_mode:
                    snap["carry"] = (arrays["carry_lo"], arrays["carry_hi"])
                if checkpointer is not None:
                    checkpointer.save("build", idx, arrays, meta)
                boundary(idx)

            def attempt():
                nonlocal total_rounds
                start = idx = snap["idx"]
                if snap["minp"] is not None:
                    P = torch.from_numpy(snap["minp"]).to(dev)[order.long()]
                else:
                    P = torch.full((n + 1,), n, dtype=torch.int32,
                                   device=dev)
                carry = None
                if carry_mode and snap["carry"] is not None:
                    carry = tuple(torch.from_numpy(c).to(dev)
                                  for c in snap["carry"])
                N, D = cfg["batch"], cfg["inflight"]
                stats["dispatch_batch"], stats["inflight_depth"] = N, D
                if N == 1 and D == 1:
                    def chunk_done(P, carry, flush):
                        nonlocal idx
                        idx += 1
                        obs.chunk_progress(idx, cs, m_cheap)
                        maybe_fail("build", idx - start,
                                   kinds=("kill", "oom", "device"))
                        if checkpointer is not None and \
                                checkpointer.due(idx - start):
                            if flush is not None:
                                P = flush(P)
                            arrays = {"deg": deg_host,
                                      "minp": P[pos_l].cpu().numpy()}
                            if carry_mode:
                                arrays["carry_lo"] = carry[0].cpu().numpy()
                                arrays["carry_hi"] = carry[1].cpu().numpy()
                            save(idx, arrays)
                        return P

                    with chunks(start, cfg["ring"]) as it:
                        P, rounds = self._build_per_segment(
                            P, it, cs, n, pos, pos_host, stats, carry,
                            chunk_done, start, stats_acc)
                    total_rounds += rounds
                    return P

                # rolling dispatch spans tile the build confirm to
                # confirm: issue and confirm interleave across groups, so
                # spans a group would not nest
                dsp = obs.begin("dispatch", i=idx)

                def confirmed(real, rounds, tipP):
                    # asks for a flush barrier when a checkpoint is due:
                    # mid-pipeline the tip table can miss a confirmed
                    # group's leftovers still queued, so the save waits
                    # for flushed(), after the driver drains them
                    nonlocal idx, dsp
                    stats_acc.absorb(stats)
                    dsp.end(rounds=rounds)
                    due = False
                    if real is not None:
                        prev = idx
                        idx += real
                        obs.chunk_progress(idx, cs, m_cheap)
                        for i in range(prev + 1, idx + 1):
                            maybe_fail("build", i - start,
                                       kinds=("kill", "oom", "device"))
                        due = checkpointer is not None and \
                            checkpointer.due_span(prev - start, idx - start)
                    dsp = obs.begin("dispatch", i=idx)
                    return due

                def flushed(tipP):
                    # drained: idx, advanced through every group confirmed
                    # in the drain, and the table agree
                    save(idx, {"deg": deg_host,
                               "minp": tipP[pos_l].cpu().numpy()})

                try:
                    with chunks(start, cfg["ring"]) as groups, \
                            closing(self._staged_groups(groups, cs, n, pos,
                                                        N)) as staged:
                        # a fold that stops early leaves both generators
                        # open: closing them stops the prefetch worker and
                        # the ring
                        P, rounds = elim_ops.fold_segments_pipelined(
                            P, staged, n, inflight=D,
                            lift_levels=self.lift_levels,
                            segment_rounds=self.segment_rounds, stats=stats,
                            on_confirm=confirmed, on_flush=flushed,
                            round_log=round_log)
                except BaseException as exc:
                    dsp.end(error=type(exc).__name__)
                    raise
                # the span the last confirm opened covers the drain's end
                dsp.end()
                stats_acc.absorb(stats)
                total_rounds += rounds
                return P

            def on_resource():
                # spill before shrink: the cached chunks come back for
                # free; only with nothing left to spill does a knob halve
                nonlocal cache
                nxt = retry_mod.degrade_dispatch(
                    n, cs, cfg["batch"], cfg["inflight"], donate, stats,
                    snap["idx"],
                    h2d_ring=None if ring_model == 0 else cfg["ring"],
                    residency=cache)
                if cache is not None and cache.budget <= 0:
                    cache = None
                if nxt is not None:
                    cfg["batch"], cfg["inflight"] = nxt[0], nxt[1]
                    if len(nxt) > 2:
                        cfg["ring"] = nxt[2]

            def save_snapshot():
                if checkpointer is not None and snap["minp"] is not None:
                    arrays = {"deg": deg_host, "minp": snap["minp"]}
                    if carry_mode and snap["carry"] is not None:
                        arrays["carry_lo"], arrays["carry_hi"] = snap["carry"]
                    checkpointer.save("build", snap["idx"], arrays, meta)

            policy = retry_mod.RetryPolicy()
            while True:
                try:
                    P = attempt()
                    break
                except Exception as exc:  # noqa: BLE001, classified there
                    retry_mod.handle_build_fault(
                        policy, exc, "torch.build", stats,
                        on_resource=on_resource,
                        on_device_loss=lambda: retry_mod.recover_device_loss(
                            stats, snap["idx"], save_snapshot, device=dev))
                    stats_acc.absorb(stats)
                # the failed attempt's tensors die with the frames its
                # exception held: collect them before the next allocates
                gc.collect()
            # a degraded ring carries into the score pass, which runs
            # outside the retry
            ring = cfg["ring"]
            minp = P[pos_l]
            del P
        _sync(dev)
        launches = {k: v for c in counters for k, v in c.items()}
        for key, name in LAUNCH_KEYS.items():
            stats[key] = launches[name] - launches0[name]
        t["build"] = time.perf_counter() - t0
        # the launches ride the build span's counters on the card
        stats_acc.absorb(stats)
        sp.end(fixpoint_rounds=int(total_rounds))

        t0 = time.perf_counter()
        with obs.span("split"):
            parent = elim_ops.minp_to_parent(minp, order, n)
            w = deg_host.astype(np.float64) if weights == "degree" else None
            assign_host = split_ops.tree_split_host(
                parent, pos_host, k, weights=w, alpha=self.alpha)
            t["split"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sp = obs.begin("score")
        obs.progress(phase="score", chunks_done=0, edges_done=0)
        parts = {k: torch.from_numpy(np.concatenate(
            [assign_host.astype(np.int32), np.zeros(1, np.int32)])).to(dev)}
        cut = {k: torch.zeros((), dtype=torch.int64, device=dev)}
        total = torch.zeros((), dtype=torch.int64, device=dev)
        cv_keys: dict = {k: []}
        start = 0
        if state and state.phase == "score":
            start = state.chunk_idx
            cut[k] += int(state.arrays["cut"])
            total += int(state.arrays["total"])
            if comm_volume:
                cv_keys[k].append(
                    torch.from_numpy(state.arrays["cv_keys"]).to(dev))
        idx = start
        minp_host = None

        def score_done():
            nonlocal idx, minp_host
            idx += 1
            maybe_fail("score", idx - start)
            obs.chunk_progress(idx, cs, m_cheap)
            if checkpointer is not None and checkpointer.due(idx - start):
                if minp_host is None:
                    minp_host = minp.cpu().numpy()
                keys = score_ops.comm_volume_keys(cv_keys[k]).cpu().numpy()
                kept = ckpt.save_score_state(
                    checkpointer, idx, int(cut[k]), int(total), [keys],
                    {"deg": deg_host, "minp": minp_host}, meta, comm_volume)
                cv_keys[k] = [torch.from_numpy(c).to(dev) for c in kept]
                boundary(idx)

        with chunks(start, ring) as it:
            _score_chunks(it, parts, n, comm_volume, cut, total, cv_keys,
                          score_done)
        cv = score_ops.comm_volume(cv_keys[k]) if comm_volume else None
        # the score pass re-streams: its counters reach the final totals
        stats_acc.absorb(stats)
        balance = pure.part_balance(assign_host, k, w)
        t["score"] = time.perf_counter() - t0
        sp.end()
        root_sp.end()
        if checkpointer is not None:
            checkpointer.clear()
        if ckpt.degraded_events() > ckpt_degraded0:
            # a lossy recovery in this run
            stats["checkpoint_degraded"] = \
                ckpt.degraded_events() - ckpt_degraded0

        diagnostics = {"fixpoint_rounds": float(total_rounds)}
        diagnostics.update({key: (round(float(v), 3)
                                  if key.startswith("t_") or
                                  key.endswith("_ms") else float(v))
                            for key, v in stats.items()})
        edge_cut, total = int(cut[k]), int(total)
        return PartitionResult(
            assignment=assign_host, k=k, edge_cut=edge_cut,
            total_edges=total, cut_ratio=edge_cut / max(total, 1),
            balance=balance, comm_volume=cv,
            phase_times=t, backend=f"{self.name}:{dev.type}",
            diagnostics=diagnostics,
            tree={"parent": parent, "pos": pos_host, "deg": deg_host}
            if keep_tree else None)

    def score_stream(self, stream, assignments: dict,
                     comm_volume: bool = True, weights=None,
                     stats=None) -> dict:
        """Score assignments ({k: int array[n]}) against the stream in one
        pass over its device chunks, every assignment against each chunk:
        {k: (cut, total, balance, comm volume)}, as the reference's
        ``score_stream`` (``sheep_tpu/backends/base.py:136``). ``weights``
        weigh the balance (None: unit); ``stats`` takes the H2D ring's
        counters."""
        dev = self.device
        n = stream.num_vertices
        cs = stream.clamp_chunk_edges(self.chunk_edges)
        parts = {k: torch.from_numpy(np.concatenate(
            [np.asarray(a, dtype=np.int32), np.zeros(1, np.int32)])).to(dev)
            for k, a in assignments.items()}
        cut = {k: torch.zeros((), dtype=torch.int64, device=dev)
               for k in parts}
        total = torch.zeros((), dtype=torch.int64, device=dev)
        cv_keys: dict = {k: [] for k in parts}
        with closing(device_chunks(stream, cs, n, dev,
                                   resolve_h2d_ring(self.h2d_ring, dev),
                                   stats)) as it:
            _score_chunks(it, parts, n, comm_volume, cut, total, cv_keys)
        total = int(total)
        return {k: (int(cut[k]), total,
                    pure.part_balance(assignments[k], k, weights),
                    score_ops.comm_volume(cv_keys[k]) if comm_volume
                    else None) for k in parts}
    def partition_multi(self, stream, ks, weights: str = "unit",
                        comm_volume: bool = True) -> list:
        """One result per k in ``ks`` from one build, as the reference's
        ``Partitioner.partition_multi``: the first k is a
        ``keep_tree=True`` partition, every further k a re-split of its
        forest by the native split, all of them scored in one more pass
        over the stream."""
        ks = [int(k) for k in ks]
        if not ks:
            raise ValueError("ks must be non-empty")
        first = self.partition(stream, ks[0], weights=weights,
                               comm_volume=comm_volume, keep_tree=True)
        out = [first]
        if len(ks) == 1:
            return out
        tree = first.tree
        w = tree["deg"].astype(np.float64) if weights == "degree" else None
        split_s, assigns = {}, {}
        for k in ks[1:]:
            t0 = time.perf_counter()
            assigns[k] = split_ops.tree_split_host(
                tree["parent"], tree["pos"], k, weights=w, alpha=self.alpha)
            split_s[k] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = self.score_stream(stream, assigns, comm_volume=comm_volume,
                                   weights=w)
        score_s = time.perf_counter() - t0
        for k in ks[1:]:
            cut, total, balance, cv = scored[k]
            out.append(PartitionResult(
                assignment=assigns[k], k=k, edge_cut=cut, total_edges=total,
                cut_ratio=cut / max(total, 1), balance=balance,
                comm_volume=cv, phase_times={
                    "split": split_s[k], "score": score_s / len(ks[1:])},
                backend=first.backend, tree=tree))
        return out
