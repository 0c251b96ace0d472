"""Partition refinement: capacity-capped label propagation on the device
(counterpart of ``sheep_tpu/ops/refine.py``).

After a build, a few rounds move vertices to the part most of their
neighbours are in, under a balance cap. A half-round is one streamed pass
of the edges into an (n+1, k) neighbour-part histogram
(:func:`neighbor_hist_chunk`), its row statistics (:func:`hist_stats`) and
one capacity-ranked move plan (:func:`plan_moves`) for the vertices of one
parity. A full round is scored, and a round that does not lower the cut is
rolled back and ends the refinement, so the refined cut is never worse
than the input.

The three device programs are the kernels of ``csrc/refine.cu`` on CUDA
tensors and their plain PyTorch versions (``*_plain``) on CPU tensors;
anything else raises. ``LAUNCHES`` counts the wrappers' calls that launch
them (``neighbor_hist`` is four launches a call, ``hist_stats`` one).

The histogram kernel drops invalid edges (an end outside [0, n), or a
self-loop) where the reference adds them to the sentinel row n (the row of
vertex n, or row vb in blocked mode): that row is never read, since the
planner and the move accounting skip vid == n and the cut comes from the
fused counts. So every result equals the reference's but that row of the
histogram, and its row statistics.

The weighted planner :func:`plan_moves_weighted` is plain PyTorch on both
devices, in float32 as the reference has it: its prefix sums, and so its
accepted set, are exact while the total weight is below 2^24 (beyond it
the reference's own host and device planners disagree too).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from sheep_tpu_torch import obs

LAUNCHES = {"neighbor_hist": 0, "hist_stats": 0, "plan_moves": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("refine")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sheep_refine_hist.argtypes = [p, ll, p, i, i, i, ll, ll, p, p, p,
                                          ll, p, p]
        lib.sheep_refine_hist.restype = i
        lib.sheep_refine_hist_meta_words.argtypes = []
        lib.sheep_refine_hist_meta_words.restype = i
        lib.sheep_refine_stats.argtypes = [p, ll, i, p, p, p, p, p, p]
        lib.sheep_refine_stats.restype = i
        lib.sheep_refine_plan_rows.argtypes = [ll]
        lib.sheep_refine_plan_rows.restype = ll
        for name in ("digits", "part_words", "ctl_words"):
            getattr(lib, f"sheep_refine_plan_{name}").restype = i
        lib.sheep_refine_plan.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p,
                                          p]
        lib.sheep_refine_plan.restype = i
        lib.sheep_refine_error_string.argtypes = [i]
        lib.sheep_refine_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.sheep_refine_error_string(rc).decode())


def _vector(name: str, t: torch.Tensor, length: int, dtype=torch.int32):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or \
            len(t) < length:
        raise ValueError(f"{name} must be a contiguous {dtype} vector of at "
                         f"least {length} entries")


def _device(what: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: the tensors lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


# -- the neighbour-part histogram ------------------------------------------

def _check_hist(hist, rows: int, k: int, chunk, assign, n: int, counts):
    if hist.dtype != torch.int32 or hist.dim() != 2 or \
            tuple(hist.shape) != (rows, k) or not hist.is_contiguous():
        raise ValueError(f"neighbor_hist: hist must be a contiguous int32 "
                         f"({rows}, {k}) tensor")
    if chunk.dtype != torch.int32 or chunk.dim() != 2 or \
            chunk.shape[1] != 2 or not chunk.is_contiguous():
        raise ValueError("neighbor_hist: chunk must be a contiguous int32 "
                         "(C, 2) tensor")
    _vector("neighbor_hist: assign", assign, n + 1)
    if not 0 <= n < 2**31 or k < 1:
        raise ValueError("neighbor_hist: n or k out of range")
    tensors = [hist, chunk, assign]
    if counts is not None:
        if counts.dtype != torch.int64 or counts.shape != (2,) or \
                not counts.is_contiguous():
            raise ValueError("neighbor_hist: counts must be int64[2]")
        tensors.append(counts)
    return _device("neighbor_hist", *tensors)


def neighbor_hist_plain(hist, chunk, assign, n: int, k: int, base: int = 0,
                        vb: int = None, counts=None):
    """The plain version of :func:`neighbor_hist_chunk` (``vb`` None) and
    :func:`neighbor_hist_block` (rows [base, base+vb) of the (vb, k)
    ``hist``), in place; invalid edges are dropped."""
    u, v = chunk[:, 0].long(), chunk[:, 1].long()
    valid = (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)
    u, v = u[valid], v[valid]
    pu, pv = assign[u].long(), assign[v].long()
    if counts is not None:
        counts[0] += (pu != pv).sum()
        counts[1] += valid.sum()
    rows = torch.cat([u, v]) - base
    cols = torch.cat([pv, pu])
    if vb is not None:
        keep = (rows >= 0) & (rows < vb)
        rows, cols = rows[keep], cols[keep]
    flat = hist.view(-1)
    flat.index_add_(0, rows * k + cols,
                    torch.ones(len(rows), dtype=torch.int32,
                               device=hist.device))
    return hist


def neighbor_hist_chunk(hist, chunk, assign, n: int, k: int, counts=None,
                        scratch=None):
    """Add one padded (C, 2) int32 chunk into the (n+1, k) int32 histogram
    ``hist`` in place: hist[u, assign[v]] and hist[v, assign[u]] for each
    valid edge; ``counts`` (int64[2]), when given, gains the chunk's (cut,
    total) under the same mask. On CUDA the call's scratch comes from
    ``scratch`` (a :class:`HistScratch`) when given. Returns ``hist``."""
    dev = _check_hist(hist, n + 1, k, chunk, assign, n, counts)
    if dev.type == "cpu":
        return neighbor_hist_plain(hist, chunk, assign, n, k, counts=counts)
    _hist(hist, chunk, assign, n, k, 0, 0, counts, scratch)
    return hist


def neighbor_hist_block(hist, chunk, assign, base: int, n: int, k: int,
                        vb: int, scratch=None):
    """Blocked variant: only the rows [base, base+vb) of the histogram,
    into the (vb, k) int32 ``hist`` in place. Returns ``hist``."""
    if vb < 1 or base < 0:
        raise ValueError("neighbor_hist_block: vb must be >= 1, base >= 0")
    dev = _check_hist(hist, vb, k, chunk, assign, n, None)
    if dev.type == "cpu":
        return neighbor_hist_plain(hist, chunk, assign, n, k, base, vb)
    _hist(hist, chunk, assign, n, k, base, vb, None, scratch)
    return hist


def _hist(hist, chunk, assign, n, k, base, vb, counts, scratch) -> None:
    lib = _lib()
    dev = hist.device
    if scratch is None:
        scratch = HistScratch(len(chunk), dev)
    elif scratch.meta.device != dev:
        raise ValueError("neighbor_hist: the scratch is on another device")
    words = scratch.words_for(len(chunk))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sheep_refine_hist(
            chunk.data_ptr(), len(chunk), assign.data_ptr(), n, k,
            int(vb > 0), base, vb, hist.data_ptr(),
            None if counts is None else counts.data_ptr(), words.data_ptr(),
            len(words), scratch.meta.data_ptr(), stream)
        if rc != 0:
            scratch.meta.zero_()  # a failed call may leave totals behind
        _check(lib, rc, "neighbor_hist launch")
    LAUNCHES["neighbor_hist"] += 1


class HistScratch:
    """The scratch of :func:`neighbor_hist_chunk` and
    :func:`neighbor_hist_block` on CUDA: a uint32 word (held as int32) for
    each of the chunk's two updates an edge, binned by row range, and the
    buckets' metadata (totals, starts, cursors, work items), zeroed here
    once: every call leaves it ready for the next. The words grow to the
    largest chunk seen. Calls that share one must be in stream order."""

    def __init__(self, chunk_edges: int, dev):
        lib = _lib()
        self.words = torch.empty(max(1, 2 * chunk_edges), dtype=torch.int32,
                                 device=dev)
        self.meta = torch.zeros(lib.sheep_refine_hist_meta_words(),
                                dtype=torch.int32, device=dev)

    def words_for(self, chunk_edges: int) -> torch.Tensor:
        if len(self.words) < 2 * chunk_edges:
            self.words = torch.empty(2 * chunk_edges, dtype=torch.int32,
                                     device=self.words.device)
        return self.words


# -- row statistics --------------------------------------------------------

def hist_stats_plain(hist, cur_part):
    """The plain version of :func:`hist_stats`."""
    best = torch.argmax(hist, dim=1, keepdim=True)
    bestv = hist.gather(1, best)[:, 0]
    idx = cur_part.long().clamp(0, hist.shape[1] - 1)[:, None]
    cur = hist.gather(1, idx)[:, 0]
    return best[:, 0].int(), bestv, cur, bestv - cur


def hist_stats(hist, cur_part):
    """(rows, k) int32 histogram -> int32 (best, bestv, cur, gain): the
    first argmax of each row, its count, the count at the row's current
    part ``cur_part`` (int32[rows]) and bestv - cur."""
    if hist.dtype != torch.int32 or hist.dim() != 2 or \
            not hist.is_contiguous() or hist.shape[1] < 1:
        raise ValueError("hist_stats: hist must be a contiguous int32 "
                         "(rows, k) tensor, k >= 1")
    rows, k = hist.shape
    _vector("hist_stats: cur_part", cur_part, rows)
    dev = _device("hist_stats", hist, cur_part)
    if dev.type == "cpu":
        return hist_stats_plain(hist, cur_part[:rows])
    lib = _lib()
    out = [torch.empty(rows, dtype=torch.int32, device=dev)
           for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.sheep_refine_stats(
            hist.data_ptr(), rows, k, cur_part.data_ptr(),
            *(t.data_ptr() for t in out), stream), "hist_stats launch")
    LAUNCHES["hist_stats"] += 1
    return tuple(out)


# -- the move planners ------------------------------------------------------

def _lexsort(gain, part_key):
    """The order of ``jnp.lexsort((-gain, part_key))``: stable, by
    part_key, then by descending gain."""
    first = torch.sort(-gain.long(), stable=True).indices
    return first[torch.sort(part_key[first], stable=True).indices]


def _plan_common(best, gain, assign, parity: int, n: int, k: int):
    dev = best.device
    vid = torch.arange(n + 1, device=dev)
    cur = assign[:n + 1]
    want = (gain > 0) & (vid < n) & ((vid % 2) == parity)
    part_key = torch.where(want, best.long(), k)
    order = _lexsort(gain, part_key)
    pk_sorted = part_key[order]
    starts = torch.searchsorted(pk_sorted,
                                torch.arange(k, device=dev))
    pk_c = pk_sorted.clamp(0, k - 1)
    in_range = (cur[:n] >= 0) & (cur[:n] < k)
    return vid, cur, order, pk_sorted, starts, pk_c, in_range


def plan_moves_plain(best, gain, assign, cap: int, parity: int, n: int,
                     k: int):
    """The plain version of :func:`plan_moves`."""
    vid, cur, order, pk, starts, pk_c, in_range = _plan_common(
        best, gain, assign, parity, n, k)
    loads = torch.zeros(k, dtype=torch.int64, device=best.device)
    loads.index_add_(0, cur[:n][in_range].long(),
                     torch.ones(int(in_range.sum()), dtype=torch.int64,
                                device=best.device))
    head = (int(cap) - loads).clamp(min=0)
    rank = vid - starts[pk_c]
    ok = (pk < k) & (rank < head[pk_c])
    allowed = torch.zeros(n + 1, dtype=torch.bool, device=best.device)
    allowed[order] = ok
    return torch.where(allowed, best, cur).int()


def plan_moves(best, gain, assign, cap: int, parity: int, n: int, k: int,
               scratch=None):
    """One parity half-round of capacity-capped moves: a vertex of the
    parity whose ``gain`` is positive wants to move to ``best``; the
    movers of each target part, ranked by descending gain (then vertex
    id), are accepted while their rank is below ``cap`` less the part's
    load, so no part grows past ``cap``. ``best``, ``gain`` and ``assign``
    are int32[n+1]; returns the new int32[n+1] assignment. On CUDA the
    call's buffers come from ``scratch`` (a :class:`PlanScratch` for the
    same n and k) when given."""
    for name, t in (("best", best), ("gain", gain), ("assign", assign)):
        _vector(f"plan_moves: {name}", t, n + 1)
    if not 0 <= n < 2**31 - 1 or not 1 <= k < 2**31 - 1 or \
            parity not in (0, 1) or not -2**31 <= int(cap) < 2**31:
        raise ValueError("plan_moves: n, k, cap or parity out of range")
    dev = _device("plan_moves", best, gain, assign)
    if dev.type == "cpu":
        return plan_moves_plain(best, gain, assign, cap, parity, n, k)
    lib = _lib()
    if scratch is None:
        scratch = PlanScratch(n, k, dev)
    elif (scratch.n, scratch.k, scratch.hist.device) != (n, k, dev):
        raise ValueError("plan_moves: the scratch is for another n, k or "
                         "device")
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.sheep_refine_plan(
            best.data_ptr(), gain.data_ptr(), assign.data_ptr(), n, k,
            int(cap), parity, scratch.hist.data_ptr(),
            scratch.part.data_ptr(), scratch.ctl.data_ptr(),
            scratch.cand.data_ptr(), out.data_ptr(), stream),
            "plan_moves launch")
    LAUNCHES["plan_moves"] += 1
    return out


class PlanScratch:
    """The scratch of :func:`plan_moves` calls on CUDA at one n and k: the
    parts' selection counters (int32, a bin row, the loads, movers and
    threshold words of each part, and the control words), zero when made
    and left zero by every call, and the candidates (int32[4] a row of the
    parity)."""

    def __init__(self, n: int, k: int, dev):
        lib = _lib()
        self.n, self.k = n, k
        self.hist = torch.zeros(k * lib.sheep_refine_plan_digits(),
                                dtype=torch.int32, device=dev)
        self.part = torch.zeros(lib.sheep_refine_plan_part_words() * k,
                                dtype=torch.int32, device=dev)
        self.ctl = torch.zeros(lib.sheep_refine_plan_ctl_words(),
                               dtype=torch.int32, device=dev)
        self.cand = torch.empty(4 * max(1, lib.sheep_refine_plan_rows(n)),
                                dtype=torch.int32, device=dev)


def plan_moves_weighted(best, gain, assign, w, cap, parity: int, n: int,
                        k: int):
    """Weighted variant of :func:`plan_moves`, plain PyTorch on any
    device, in float32 as the reference's: each part's headroom is in
    vertex weight ``w`` (float32[n+1]), and its accepted movers are the
    longest gain-descending prefix whose cumulative weight fits it."""
    vid, cur, order, pk, starts, pk_c, in_range = _plan_common(
        best, gain, assign, parity, n, k)
    wf = w.float()
    loads = torch.zeros(k, dtype=torch.float32, device=best.device)
    loads.index_add_(0, cur[:n][in_range].long(), wf[:n][in_range])
    cap32 = torch.tensor(np.float32(cap), device=best.device)
    head = (cap32 - loads).clamp(min=0.0)
    w_sorted = torch.where(pk < k, wf[order], 0.0)
    csum = torch.cumsum(w_sorted, 0)
    base = torch.where(starts > 0, csum[(starts - 1).clamp(min=0)], 0.0)
    within = csum - base[pk_c]
    ok = (pk < k) & (within <= head[pk_c])
    allowed = torch.zeros(n + 1, dtype=torch.bool, device=best.device)
    allowed[order] = ok
    return torch.where(allowed, best, cur).int()


def plan_moves_host(best: np.ndarray, gain: np.ndarray, assign: np.ndarray,
                    cap, parity: int, n: int, k: int,
                    w: np.ndarray = None) -> np.ndarray:
    """Numpy mirror of :func:`plan_moves` / :func:`plan_moves_weighted`,
    for graphs whose O(V) planning buffers exceed the device budget."""
    vid = np.arange(n + 1, dtype=np.int64)
    cur = assign[:n + 1]
    want = (gain > 0) & (vid < n) & ((vid % 2) == parity)
    part_key = np.where(want, best, k)
    order = np.lexsort((-gain, part_key))
    pk = part_key[order]
    starts = np.searchsorted(pk, np.arange(k))
    pk_c = np.clip(pk, 0, k - 1)
    if w is None:
        loads = np.bincount(cur[:n], minlength=k)
        head = np.maximum(cap - loads, 0)
        rank = np.arange(n + 1) - starts[pk_c]
        ok = (pk < k) & (rank < head[pk_c])
    else:
        wf = w.astype(np.float32)
        loads = np.bincount(cur[:n], weights=wf[:n],
                            minlength=k).astype(np.float32)
        head = np.maximum(np.float32(cap) - loads, 0.0)
        w_sorted = np.where(pk < k, wf[order], 0.0).astype(np.float32)
        csum = np.cumsum(w_sorted, dtype=np.float32)
        base = np.where(starts > 0, csum[np.maximum(starts - 1, 0)],
                        np.float32(0.0))
        within = csum - base[pk_c]
        ok = (pk < k) & (within <= head[pk_c])
    allowed = np.zeros(n + 1, bool)
    allowed[order] = ok
    return np.where(allowed, best, cur).astype(np.int32)


def _move_accounting(gain, before, after, parity: int, n: int):
    """(wanted, applied) of one half-round: positive-gain movers of the
    parity, and labels that changed. wanted - applied is the count the
    capacity cap refused."""
    vid = torch.arange(len(gain), device=gain.device)
    wanted = int(((gain > 0) & (vid < n) & ((vid % 2) == parity)).sum())
    applied = int((before != after).sum())
    return wanted, applied


def move_rescore_host(src, dst, prev, new, in_changed) -> int:
    """Exact edge-cut change of a batch of part moves from the moved
    vertices' arcs alone (the incremental scorer's move accounting):
    ``(src, dst)`` are the surviving arcs leaving the changed set (masked
    here by ``in_changed[src]``), ``prev``/``new`` the assignments before
    and after, ``in_changed`` a bool[V] of the vertices whose label moved.
    An edge with both ends changed comes as two arcs whose even sum is
    halved; self-loop arcs add 0 on both sides."""
    s = np.asarray(src)
    d = np.asarray(dst)
    if not len(s):
        return 0
    keep = in_changed[s]
    s, d = s[keep], d[keep]
    diff = ((new[s] != new[d]).astype(np.int64)
            - (prev[s] != prev[d]).astype(np.int64))
    both = in_changed[d]
    twice = int(diff[both].sum())
    assert twice % 2 == 0  # symmetric arcs: the both-changed sum is even
    return int(diff[~both].sum()) + twice // 2


# -- the refinement --------------------------------------------------------

def spool_stream(stream, n: int, chunk_edges: int = 1 << 22,
                 spool_dir: str = None):
    """Write a stream that is costly to regenerate to a temporary binary
    file once; returns (file-backed stream, its path), or (stream, None)
    when the edge bound is unknown, the file would take more than half of
    the free space of the spool directory, or the write fails with an
    ``OSError``. A partial file is always removed."""
    from sheep_tpu_torch.io.edgestream import EdgeStream

    wide = n > 0xFFFFFFFF
    dt = np.uint64 if wide else np.uint32
    ub = getattr(stream, "num_edges_upper_bound", None)
    target = spool_dir or tempfile.gettempdir()
    need = None if ub is None else 2 * dt().itemsize * ub
    try:
        free = shutil.disk_usage(target).free
    except OSError:
        free = 0
    if need is None or need > free // 2:
        why = "unknown edge bound" if need is None \
            else f"{need >> 20} MiB needed, {free >> 20} MiB free"
        print(f"refine: not spooling ({why})", file=sys.stderr)
        return stream, None
    fd = path = None
    try:
        fd, path = tempfile.mkstemp(suffix=".bin64" if wide else ".bin32",
                                    prefix="sheep_spool_", dir=spool_dir)
        with os.fdopen(fd, "wb", buffering=1 << 20) as f:
            fd = None
            for c in stream.chunks(chunk_edges):
                f.write(np.ascontiguousarray(
                    np.asarray(c, np.int64).astype(dt)).tobytes())
        return EdgeStream.open(path, n_vertices=n), path
    except BaseException as e:
        if fd is not None:
            os.close(fd)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass
        if not isinstance(e, OSError):
            raise
        print(f"refine: stream spool failed ({e}); streaming direct",
              file=sys.stderr)
        return stream, None


def refine_assignment(assign: np.ndarray, stream, n: int, k: int,
                      rounds: int = 3, alpha: float = 1.10,
                      chunk_edges: int = 1 << 22,
                      budget_bytes: int = 4 << 30,
                      plan_budget_bytes: int = 4 << 30,
                      min_block: int = 1 << 16,
                      weights: np.ndarray = None,
                      spool: bool = True, spool_dir: str = None,
                      device=None):
    """Refine a host assignment; returns (new int32 assignment, stats),
    as the reference's ``refine_assignment``.

    Each round: two parity half-rounds of histogram and capped moves,
    then a score; a round that does not lower the cut is rolled back and
    refinement stops. The cap is ``int(alpha * ceil(n / k))`` vertices a
    part (with ``weights``: ``float32(alpha * total weight / k)``). With
    a full histogram (4 (n+1) k bytes within ``budget_bytes``) the passes
    are 2R+1, each round's first histogram pass scoring the previous
    round; otherwise the histogram is taken in blocks of vb rows, with
    1 + R (2B+1) passes for B blocks. Moves are planned on the host when
    40 (n+1) bytes exceed ``plan_budget_bytes``. A generator stream is
    spooled to a temporary file first (``spool=False`` opts out) and the
    file removed at the end. Runs on ``device`` (None: CUDA); chunks of a
    file stream stage through the H2D ring at its auto depth."""
    from sheep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    spool_path = None
    if spool and getattr(stream, "fmt", None) == "generator":
        stream, spool_path = spool_stream(stream, n, chunk_edges, spool_dir)
    try:
        out, stats = _refine_impl(assign, stream, n, k, rounds, alpha,
                                  chunk_edges, budget_bytes,
                                  plan_budget_bytes, min_block, weights,
                                  dev)
        stats["refine_spooled"] = int(spool_path is not None)
        return out, stats
    finally:
        if spool_path:
            try:
                os.unlink(spool_path)
            except OSError:
                pass


def _refine_impl(assign, stream, n, k, rounds, alpha, chunk_edges,
                 budget_bytes, plan_budget_bytes, min_block, weights, dev):
    from sheep_tpu_torch.backends.torch_backend import (device_chunks,
                                                        resolve_h2d_ring)
    from sheep_tpu_torch.ops import score as score_ops

    host_plan = 10 * 4 * (n + 1) > plan_budget_bytes
    vb = 0  # 0: one full-width histogram
    if 4 * (n + 1) * k > budget_bytes:
        vb = max(min_block, budget_bytes // (4 * k))
        if vb >= n + 1:
            vb = 0
    cs = stream.clamp_chunk_edges(chunk_edges)
    ring = resolve_h2d_ring(0, dev)

    def chunks():
        return device_chunks(stream, cs, n, dev, ring)

    hist = torch.zeros((vb or n + 1, k), dtype=torch.int32, device=dev)
    hist_scratch = HistScratch(cs, dev) if dev.type == "cuda" else None

    def score(a_try):
        """The exact edge cut of ``a_try`` in one pass (blocked mode)."""
        cut = torch.zeros((), dtype=torch.int64, device=dev)
        for c in chunks():
            cut += score_ops.score_chunk(c, a_try, n)[0]
        return int(cut)

    def gains(a_try):
        """(best, gain, cut) over all vertices: one histogram pass, its
        cut fused; or ceil((n+1)/vb) blocked passes with cut None."""
        if not vb:
            hist.zero_()
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
            for c in chunks():
                neighbor_hist_chunk(hist, c, a_try, n, k, counts, hist_scratch)
            b, _, _, g = hist_stats(hist, a_try)
            return b, g, int(counts[0])
        best = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        gain = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        for base in range(0, n + 1, vb):
            hist.zero_()
            for c in chunks():
                neighbor_hist_block(hist, c, a_try, base, n, k, vb,
                                    hist_scratch)
            span = min(vb, n + 1 - base)
            b, _, _, g = hist_stats(hist[:span], a_try[base:base + span])
            best[base:base + span] = b
            gain[base:base + span] = g
        return best, gain, None

    if weights is not None:
        w_host = np.concatenate([np.asarray(weights, np.float32),
                                 np.zeros(1, np.float32)])
        w_dev = torch.from_numpy(w_host).to(dev)
        cap = np.float32(alpha * float(np.sum(weights)) / k)
    else:
        cap = int(alpha * (-(-n // k)))

    scratch = PlanScratch(n, k, dev) \
        if dev.type == "cuda" and not host_plan and weights is None else None

    def plan(b, g, a_try, parity):
        if host_plan:
            return torch.from_numpy(plan_moves_host(
                b.cpu().numpy(), g.cpu().numpy(), a_try.cpu().numpy(),
                float(cap) if weights is not None else int(cap), parity, n,
                k, w=None if weights is None else w_host)).to(dev)
        if weights is not None:
            return plan_moves_weighted(b, g, a_try, w_dev, cap, parity, n,
                                       k)
        return plan_moves(b, g, a_try, cap, parity, n, k, scratch)

    a_dev = torch.from_numpy(np.concatenate(
        [np.asarray(assign, np.int32), np.zeros(1, np.int32)])).to(dev)
    stats = {"refine_rounds_run": 0,
             "refine_hist_blocks": -(-(n + 1) // vb) if vb else 1,
             "refine_host_plan": int(host_plan),
             "refine_moves_wanted": 0, "refine_moves_applied": 0,
             "refine_moves_capacity_blocked": 0}
    best = a_try = a_dev
    best_cut = None
    pending = None  # move accounting of the round awaiting its score
    sp = obs.begin("refine", k=k, rounds_cap=rounds)
    try:
        for it in range(rounds + 1):
            if vb:
                b = g = None
                cut_now = score(a_try)
            else:
                b, g, cut_now = gains(a_try)
            if best_cut is None:
                best_cut = cut_now
                stats["refine_cut_before"] = cut_now
                sp.annotate(cut_before=cut_now)
            else:
                accepted = cut_now < best_cut
                if pending is not None:
                    # the round's ledger row, a rejected round's too; only
                    # an accepted round's moves are in the result
                    obs.event("refine_round", cut=cut_now,
                              gain=best_cut - cut_now, accepted=accepted,
                              **pending)
                    if accepted:
                        for key in ("wanted", "applied",
                                    "capacity_blocked"):
                            stats[f"refine_moves_{key}"] += \
                                pending[f"moves_{key}"]
                            obs.inc(f"refine_moves_{key}",
                                    pending[f"moves_{key}"])
                    pending = None
                if accepted:
                    best_cut, best = cut_now, a_try
                    stats["refine_rounds_run"] += 1
                else:
                    break  # roll back: the refined cut never regresses
            if it == rounds:
                break
            if vb:
                b, g, _ = gains(a_try)
            prev = a_try
            a_try = plan(b, g, a_try, 0)
            w0, m0 = _move_accounting(g, prev, a_try, 0, n)
            b, g, _ = gains(a_try)
            prev = a_try
            a_try = plan(b, g, a_try, 1)
            w1, m1 = _move_accounting(g, prev, a_try, 1, n)
            wanted, applied = w0 + w1, m0 + m1
            pending = {"round": it, "moves_wanted": wanted,
                       "moves_applied": applied,
                       "moves_capacity_blocked": max(0, wanted - applied)}
    finally:
        sp.end(rounds_run=stats["refine_rounds_run"], cut_after=best_cut,
               moves_capacity_blocked=stats[
                   "refine_moves_capacity_blocked"])
    del hist, scratch, hist_scratch
    stats["refine_cut_after"] = best_cut
    return best[:n].cpu().numpy(), stats
