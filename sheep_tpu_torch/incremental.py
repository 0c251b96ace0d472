"""Incremental repartitioning of a mutating graph (the port's copy of
``sheep_tpu/incremental.py``).

The elimination fixpoint is order-independent in its constraint multiset,
so a converged table absorbs a batch of new edges as one more segment
batch: O(delta) device work in place of an O(E) rebuild.

:class:`PartitionState`
    A resident partition: the anchored elimination order, the converged
    table (vertex-space ``minp``), the anchor's degrees, the applied delta
    history (adds and tombstones) and the epoch. O(V + delta) host memory;
    the base graph is re-streamed, never held.

:func:`begin_incremental` / :func:`state_from_build`
    A state from a fresh build (``keep_tree=True``).

``backend.partition_update(state, adds, deletes)``
    One epoch (:func:`apply_update`): the adds folded into the table by
    the backend's ``_fold_delta`` (the batched fixpoint on the card), the
    deletes tombstoned, the epoch advanced, compaction past the staleness
    threshold, and with ``score`` the re-split and re-scored result.

The contract, as the reference's:

- *Adds* are exact: after epochs 1..N the table is bit-identical to a
  one-shot build of ``delta:LOG@N`` (same anchored order, same constraint
  multiset, unique fixpoint).
- *Deletes* tombstone (a forest does not un-fold); the partition serves
  the stale tree until **compaction**. Full compaction rebuilds the
  surviving multiset with a fresh (re-anchored) order, bit-identical to a
  clean build of the survivors. Subtree compaction keeps the anchored order
  and refolds only the edges of the tree-split parts the tombstones touch:
  an approximation held to a score bound in the tests.
- A staleness counter (``stale_deletes`` against ``compact_threshold``,
  default 20% of the surviving edges) forces compaction in
  :func:`apply_update`.

**Incremental scoring.** The first scored :func:`refresh` runs a full
scoring pass and seeds a score cache: a symmetrized ``.csr`` adjacency of
the base (:class:`_SurvivorIndex`, ``io/csr.py``) and (cut, total) a k
under the assignments they were scored with. Each :func:`apply_update`
folds its delta's effect into them (``ops/score.edge_effect_host``), and a
later :func:`refresh` rescores only the arcs of the vertices whose part
moved (``ops/refine.move_rescore_host``): equal to the full pass, which
``SHEEP_SCORE_AUDIT=1`` runs beside it and raises on any difference.
``comm_volume=True`` takes the full pass (distinct pairs do not update
incrementally) and re-seeds; :func:`rebase_state` drops the cache.

The full pass is the backend's ``score_stream`` (on the card for a CUDA
backend). Snapshots (:func:`save_state`, :func:`load_state`) are the
reference's npz format and ``STATE_VERSION``, so each package loads the
other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from sheep_tpu_torch import obs

NO_PARENT = -1


def _parent_from_minp(minp: np.ndarray, order: np.ndarray,
                      n: int) -> np.ndarray:
    """Vertex-space minp (int32[n+1], n = none) -> parent int64[n]."""
    m = np.asarray(minp[:n])
    has = m < n
    parent = np.full(n, NO_PARENT, dtype=np.int64)
    parent[has] = order[m[has]]
    return parent


def _minp_from_parent(parent: np.ndarray, pos: np.ndarray,
                      n: int) -> np.ndarray:
    minp = np.full(n + 1, n, dtype=np.int32)
    has = parent >= 0
    minp[:n][has] = pos[parent[has]]
    return minp


@dataclasses.dataclass
class PartitionState:
    """One resident partition (see the module docstring)."""

    n: int
    ks: List[int]
    weights: str
    alpha: float
    chunk_edges: int
    backend_name: str
    pos: np.ndarray            # int64[n], anchored elimination order
    deg_anchor: np.ndarray     # int64[n], the degrees the order anchors to
    minp: np.ndarray           # int32[n+1], the converged table
    total_edges: int           # surviving multiset size
    base: object = None        # re-openable base stream
    base_spec: Optional[str] = None
    epoch: int = 0
    anchored_at_epoch: int = 0
    adds: List[np.ndarray] = dataclasses.field(default_factory=list)
    tombs: List[np.ndarray] = dataclasses.field(default_factory=list)
    # tombstones since the last compaction: subtree compaction's dirty
    # set and the staleness numerator
    pending_tombs: List[np.ndarray] = dataclasses.field(
        default_factory=list)
    stale_deletes: int = 0
    compactions: int = 0
    compact_threshold: Optional[int] = None  # None: 20% of survivors
    stats: dict = dataclasses.field(default_factory=dict)
    _order: Optional[np.ndarray] = None
    # the score cache (_seed_score_cache), never saved: a loaded snapshot
    # seeds it again with one full pass
    _score: Optional[dict] = None

    @property
    def order(self) -> np.ndarray:
        """order[p] = vertex at rank p (the inverse of pos), cached."""
        if self._order is None or len(self._order) != self.n:
            order = np.empty(self.n, dtype=np.int64)
            order[self.pos] = np.arange(self.n, dtype=np.int64)
            self._order = order
        return self._order

    def tomb_array(self, pending_only: bool = False) -> np.ndarray:
        src = self.pending_tombs if pending_only else self.tombs
        if not src:
            return np.zeros((0, 2), np.int64)
        return np.concatenate(src, axis=0)

    def adds_array(self) -> np.ndarray:
        if not self.adds:
            return np.zeros((0, 2), np.int64)
        return np.concatenate(self.adds, axis=0)

    def resolved_compact_threshold(self) -> int:
        if self.compact_threshold is not None:
            return int(self.compact_threshold)
        return max(1024, int(self.total_edges) // 5)

    def survivor_stream(self):
        """An edge stream of the surviving multiset: the base filtered by
        the tombstones, then the applied adds."""
        from sheep_tpu_torch.io.deltalog import filter_tombstones
        from sheep_tpu_torch.io.edgestream import EdgeStream

        state = self

        def factory():
            cs = state.chunk_edges
            # state.tombs holds base tombstones only (deletes were resolved
            # against the pending adds when applied, deltalog.cancel_adds):
            # a tombstone must not reach a later epoch's add
            yield from filter_tombstones(state.base.chunks(cs),
                                         state.tomb_array())
            for a in state.adds:
                for off in range(0, len(a), cs):
                    yield a[off: off + cs]

        return EdgeStream.from_generator(
            factory, n_vertices=self.n,
            num_edges=max(0, int(self.total_edges)))


def state_from_build(stream, ks, weights: str, alpha: float,
                     chunk_edges: int, backend_name: str, pos, deg, minp,
                     total_edges: int,
                     base_spec: Optional[str] = None) -> PartitionState:
    """A finished build's products as a resident state. After a ``delta:``
    input, the log's adds, tombstones and epoch seed the state, so the
    state and the one-shot build describe the same multiset."""
    n = int(stream.num_vertices)
    st = PartitionState(
        n=n, ks=[int(k) for k in ks], weights=str(weights),
        alpha=float(alpha), chunk_edges=int(chunk_edges),
        backend_name=str(backend_name),
        pos=np.asarray(pos, dtype=np.int64)[:n],
        deg_anchor=np.asarray(deg, dtype=np.int64)[:n].copy(),
        minp=np.asarray(minp, dtype=np.int32),
        total_edges=int(total_edges), base=stream, base_spec=base_spec)
    if getattr(stream, "order_anchor", False):
        # the base is the anchor segment; the log's surviving adds and
        # tombstones are in the build already
        st.base = stream.base
        st.base_spec = getattr(stream, "base_spec", base_spec)
        if len(stream.adds):
            st.adds = [np.asarray(stream.adds, np.int64)]
        if len(stream.tombs):
            st.tombs = [np.asarray(stream.tombs, np.int64)]
        st.epoch = int(stream.epoch)
    if st.base_spec is None:
        # a file's path re-opens it on load_state; an in-memory base stays
        # None and must be handed back to load_state
        st.base_spec = getattr(st.base, "path", None)
    return st


def begin_incremental(input_or_stream, ks, backend=None,
                      weights: str = "unit", alpha: float = 1.0,
                      comm_volume: bool = False, **opts):
    """Build the base partition and return ``(state, result)``.
    ``input_or_stream`` is anything :func:`open_input` takes (a ``delta:``
    spec resumes at the log's last epoch) or an open stream; ``backend`` a
    :class:`~sheep_tpu_torch.backends.torch_backend.TorchBackend` or a
    :class:`~sheep_tpu_torch.backends.torch_sharded_backend.
    TorchShardedBackend` or a :class:`~sheep_tpu_torch.backends.
    torch_bigv_backend.TorchBigVBackend`, or a name, ``"torch"`` (also
    None), ``"torch-sharded"`` or ``"torch-bigv"``, for one made from
    ``opts`` (``device``, ``n_devices`` and the constructor's other
    keywords). The state's ``alpha`` is the backend's, as the reference
    takes it."""
    from sheep_tpu_torch.backends.torch_backend import TorchBackend
    from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
    from sheep_tpu_torch.backends.torch_sharded_backend import \
        TorchShardedBackend
    from sheep_tpu_torch.io.edgestream import open_input

    if isinstance(ks, int):
        ks = [ks]
    ks = [int(k) for k in ks]
    base_spec = None
    if isinstance(input_or_stream, (str, os.PathLike)):
        base_spec = os.fspath(input_or_stream)
        stream = open_input(base_spec)
    else:
        stream = input_or_stream
    if backend is None or backend == TorchBackend.name:
        be = TorchBackend(**opts)
    elif backend == TorchShardedBackend.name:
        be = TorchShardedBackend(**opts)
    elif backend == TorchBigVBackend.name:
        be = TorchBigVBackend(**opts)
    elif isinstance(backend, str):
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{TorchBackend.name!r}, "
                         f"{TorchShardedBackend.name!r} and "
                         f"{TorchBigVBackend.name!r}")
    else:
        be = backend
    if not getattr(be, "supports_incremental", False):
        raise ValueError(f"backend {be.name!r} does not support "
                         f"incremental updates (supports_incremental)")
    res = be.partition(stream, ks[0], weights=weights,
                       comm_volume=comm_volume, keep_tree=True)
    tree = res.tree
    n = int(stream.num_vertices)
    minp = _minp_from_parent(np.asarray(tree["parent"], np.int64),
                             np.asarray(tree["pos"], np.int64), n)
    state = state_from_build(
        stream, ks, weights, alpha, getattr(be, "chunk_edges", 1 << 22),
        be.name, tree["pos"], tree["deg"], minp, res.total_edges,
        base_spec=base_spec)
    state.alpha = float(getattr(be, "alpha", alpha))
    return state, res


def _validate_delta(edges, n: int, what: str) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if len(e) and (e.min() < 0 or e.max() >= n):
        raise ValueError(
            f"delta {what} reference vertex {int(e.max())} outside the "
            f"resident vertex space [0, {n}); build the base with "
            f"--num-vertices headroom to admit new vertices")
    return e


# -- incremental scoring: the survivor index and the per-k accumulators --

# arcs a multiplicity lookup gathers at once (8 B each, twice)
_GATHER_ARCS = 1 << 24


class _SurvivorIndex:
    """Symmetrized ``.csr`` adjacency of the resident BASE stream, in a
    temporary file: each base edge gives both arcs, so ``arcs_from``
    enumerates every base occurrence touching a vertex set, once a
    direction, without streaming E edges. Built once a base, dropped with
    the cache; the adds and tombstones live on the cache, and the file
    never changes. A self-loop gives two ``u -> u`` arcs, so the base
    multiplicity of {a, b} is the count of b in a's arcs (halved when
    a == b)."""

    def __init__(self, state: PartitionState):
        import tempfile
        import weakref

        from sheep_tpu_torch.io import csr as csr_mod
        from sheep_tpu_torch.io.edgestream import EdgeStream

        base = state.base
        cs = state.chunk_edges

        def factory():
            for chunk in base.chunks(cs):
                e = np.asarray(chunk, np.int64).reshape(-1, 2)
                if len(e):
                    yield np.concatenate([e, e[:, ::-1]], axis=0)

        fd, path = tempfile.mkstemp(prefix="sheep_symadj_", suffix=".csr")
        os.close(fd)
        csr_mod.write_csr(path, EdgeStream.from_generator(
            factory, n_vertices=state.n), n_vertices=state.n)
        self.path = path
        self.csr = csr_mod.CsrGraph(path)
        self._finalizer = weakref.finalize(
            self, _SurvivorIndex._cleanup, self.csr, path)

    @staticmethod
    def _cleanup(csr, path: str) -> None:
        csr.close()
        try:
            os.unlink(path)
        except OSError:
            pass

    def drop(self) -> None:
        self._finalizer()

    def multiplicities(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The base multiset's count of each undirected key {a[i], b[i]},
        read from the shorter of the two arc lists (each holds the count),
        gathering at most ``_GATHER_ARCS`` arcs at a time."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        indptr = self.csr.indptr
        da = np.asarray(indptr[a + 1] - indptr[a], np.int64)
        db = np.asarray(indptr[b + 1] - indptr[b], np.int64)
        swap = db < da
        x, y = np.where(swap, b, a), np.where(swap, a, b)
        deg = np.minimum(da, db)
        cum = np.cumsum(deg)
        out = np.zeros(len(a), np.int64)
        i = 0
        while i < len(a):
            done = int(cum[i - 1]) if i else 0
            j = max(i + 1, int(np.searchsorted(cum, done + _GATHER_ARCS,
                                               side="right")))
            _, dst = self.csr.arcs_from(x[i:j])
            pair = np.repeat(np.arange(j - i), deg[i:j])
            out[i:j] = np.bincount(pair[dst == y[i:j][pair]],
                                   minlength=j - i)
            i = j
        out[a == b] //= 2
        return out


def _drop_score_cache(state: PartitionState) -> None:
    sc = state._score
    if sc is None:
        return
    if sc.get("index") is not None:
        sc["index"].drop()
    state._score = None


def _fire(fired: dict, index: _SurvivorIndex, tombs) -> np.ndarray:
    """Which base tombstones of ``tombs``, in order, remove a base
    occurrence: one of {a, b} fires while its key's fired count in
    ``fired`` is below the base multiplicity (an unmatched tombstone
    removes nothing, as ``filter_tombstones`` has it); a self-loop never
    scores. Counts the fired ones into ``fired``."""
    t = np.asarray(tombs, np.int64).reshape(-1, 2)
    out = np.zeros(len(t), dtype=bool)
    rows = np.flatnonzero(t[:, 0] != t[:, 1])
    if not len(rows):
        return out
    pairs = np.sort(t[rows], axis=1)
    keys, kid, count = np.unique(pairs, axis=0, return_inverse=True,
                                 return_counts=True)
    kid = kid.reshape(-1)
    prior = np.fromiter((fired.get(k, 0) for k in map(tuple,
                                                       keys.tolist())),
                        np.int64, len(keys))
    new = np.minimum(count, index.multiplicities(keys[:, 0], keys[:, 1])
                     - prior)
    # the first new[k] tombstones of each key fire
    order = np.argsort(kid, kind="stable")
    start = np.zeros(len(keys), np.int64)
    np.cumsum(count[:-1], out=start[1:])
    rank = np.arange(len(order)) - start[kid[order]]
    out[rows[order[rank < new[kid[order]]]]] = True
    for k, f, c in zip(map(tuple, keys.tolist()), prior.tolist(),
                       new.tolist()):
        if c:
            fired[k] = f + c
    return out


def _seed_score_cache(state: PartitionState, assigns: dict,
                      scored: dict) -> None:
    """(Re)seed the score cache after a FULL pass: ``index`` (the base's
    symmetrized CSR), ``fired`` (tombstone key -> base occurrences it
    removed), ``ov`` (the pending adds' symmetrized arcs, or None to
    rebuild from ``state.adds``), and ``prev`` / ``cut`` / ``total``, the
    assignments the accumulators are exact under. An index that cannot be
    built leaves the cache unset, and each refresh takes the full pass."""
    sc = state._score
    if sc is None:
        try:
            index = _SurvivorIndex(state)
        except Exception:  # noqa: BLE001, the full pass stays correct
            state._score = None
            return
        fired: dict = {}
        _fire(fired, index, state.tomb_array())
        sc = state._score = {"index": index, "fired": fired, "ov": None,
                             "ov_adds": -1}
    sc["prev"] = {k: np.array(a, copy=True) for k, a in assigns.items()}
    sc["cut"] = {k: int(scored[k][0]) for k in assigns}
    sc["total"] = int(next(iter(scored.values()))[1])


def _account_adds(state: PartitionState, adds: np.ndarray) -> None:
    """Fold an add batch into the accumulators under the cached
    assignments, right after ``state.adds.append(adds)``."""
    sc = state._score
    if sc is None or "prev" not in sc:
        return
    from sheep_tpu_torch.ops.score import edge_effect_host

    valid, cuts = edge_effect_host(adds, sc["prev"], state.n)
    sc["total"] += valid
    for k, c in cuts.items():
        sc["cut"][k] += c
    if sc.get("ov") is not None and sc.get("ov_adds") == len(state.adds) - 1:
        sc["ov"].append(np.concatenate([adds, adds[:, ::-1]], axis=0))
        sc["ov_adds"] = len(state.adds)
    else:
        sc["ov"] = None  # rebuilt at the next rescore


def _account_dels(state: PartitionState, dels: np.ndarray,
                  base_tombs: np.ndarray) -> None:
    """Fold a delete batch into the accumulators, right after
    ``cancel_adds`` resolved it: a delete that cancelled a pending add
    removes an edge with its endpoints; a base tombstone removes one base
    occurrence while the base multiplicity lasts."""
    sc = state._score
    if sc is None or "prev" not in sc:
        return
    from sheep_tpu_torch.ops.score import edge_effect_host

    prev, n = sc["prev"], state.n
    dv, dc = edge_effect_host(dels, prev, n)
    bv, bc = edge_effect_host(base_tombs, prev, n)
    # the cancelled adds: the deletes less the base-resolved rest
    sc["total"] -= dv - bv
    for k in dc:
        sc["cut"][k] -= dc[k] - bc[k]
    t = np.asarray(base_tombs, np.int64).reshape(-1, 2)
    t = t[_fire(sc["fired"], sc["index"], t)]
    sc["total"] -= len(t)
    for k, p in prev.items():
        sc["cut"][k] -= int(np.count_nonzero(p[t[:, 0]] != p[t[:, 1]]))
    sc["ov"] = None  # cancel_adds rewrote state.adds


def _drop_fired_arcs(src: np.ndarray, dst: np.ndarray, fired: dict,
                     n: int) -> tuple:
    """Remove the fired tombstones' occurrences from a base arc gather:
    the first ``fired`` arcs of each ordered pair go (occurrences of a
    pair are interchangeable for scoring)."""
    rem: dict = {}
    for (a, b), c in fired.items():
        rem[a * n + b] = rem.get(a * n + b, 0) + c
        rem[b * n + a] = rem.get(b * n + a, 0) + c
    from sheep_tpu_torch.io.deltalog import KeyFilter

    keys = src * np.int64(n) + dst
    rem_keys = np.fromiter(rem.keys(), np.int64, len(rem))
    cand = np.flatnonzero(KeyFilter(rem_keys).maybe(keys))
    hidx = cand[np.isin(keys[cand], rem_keys)]
    if not len(hidx):
        return src, dst
    hk = keys[hidx]
    order = np.argsort(hk, kind="stable")
    sk = hk[order]
    boundary = np.empty(len(sk), bool)
    boundary[0] = True
    np.not_equal(sk[1:], sk[:-1], out=boundary[1:])
    gid = np.cumsum(boundary) - 1
    counts = np.bincount(gid)
    starts = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(len(sk), dtype=np.int64) - starts[gid]
    remv = np.array([rem[int(x)] for x in sk[boundary]], dtype=np.int64)
    keep = np.ones(len(keys), bool)
    keep[hidx[order]] = rank >= remv[gid]
    return src[keep], dst[keep]


def _survivor_arcs_from(state: PartitionState, changed: np.ndarray) -> tuple:
    """Every surviving arc leaving ``changed`` as (src, dst): the base
    gather less the fired tombstones, and the pending adds' arcs."""
    sc = state._score
    src, dst = sc["index"].csr.arcs_from(changed)
    if sc["fired"] and len(src):
        src, dst = _drop_fired_arcs(src, dst, sc["fired"], state.n)
    if sc.get("ov") is None or sc.get("ov_adds") != len(state.adds):
        sc["ov"] = [np.concatenate([a, a[:, ::-1]], axis=0)
                    for a in state.adds]
        sc["ov_adds"] = len(state.adds)
    if sc["ov"]:
        mask = np.zeros(state.n, bool)
        mask[changed] = True
        parts_s, parts_d = [src], [dst]
        for arcs in sc["ov"]:
            m = mask[arcs[:, 0]]
            if m.any():
                parts_s.append(arcs[m, 0])
                parts_d.append(arcs[m, 1])
        src = np.concatenate(parts_s)
        dst = np.concatenate(parts_d)
    return src, dst


def _rescore_incremental(state: PartitionState, assigns: dict, w,
                         backend=None) -> dict:
    """The O(delta) scored refresh: the accumulators carry the multiset's
    change already, so only the moves remain; the arcs of the vertices
    whose part moved are rescored, a k. Returns ``{k: (cut, total,
    balance, None)}`` as a full pass does, the balance from the same
    ``part_balance`` call. A backend with ``_move_rescore`` (the sharded
    one) rescores every moved k at once over its shards, counted in
    ``score_distributed``."""
    from sheep_tpu_torch.core import pure
    from sheep_tpu_torch.ops.refine import move_rescore_host

    sc = state._score
    prev, cut = sc["prev"], sc["cut"]
    masks = {k: prev[k] != a for k, a in assigns.items()}
    union = np.zeros(state.n, bool)
    for m in masks.values():
        union |= m
    changed = np.flatnonzero(union)
    if len(changed):
        src, dst = _survivor_arcs_from(state, changed)
        hook = getattr(backend, "_move_rescore", None)
        ks_m = [k for k in assigns if masks[k].any()]
        if hook is not None and ks_m:
            deltas = hook(src, dst, {k: prev[k] for k in ks_m},
                          {k: assigns[k] for k in ks_m},
                          {k: masks[k] for k in ks_m})
            for k in ks_m:
                cut[k] += deltas[k]
            state.stats["score_distributed"] = \
                state.stats.get("score_distributed", 0) + 1
        else:
            for k in ks_m:
                cut[k] += move_rescore_host(src, dst, prev[k], assigns[k],
                                            masks[k])
    out = {}
    for k, a in assigns.items():
        prev[k] = np.array(a, copy=True)
        out[k] = (int(cut[k]), int(sc["total"]), pure.part_balance(a, k, w),
                  None)
    return out


def apply_update(backend, state: PartitionState, adds=None, deletes=None,
                 epoch: Optional[int] = None, score: bool = True,
                 compact: str = "auto", comm_volume: bool = False):
    """Apply one delta epoch (module docstring). Returns the refreshed
    result (a list when the state has several ks) with ``score``, else
    None. An ``epoch`` at or below the state's is a no-op returning None
    (a replayed epoch is applied once)."""
    if compact not in ("auto", "never", "force"):
        raise ValueError(f"bad compact mode {compact!r}")
    if epoch is not None and int(epoch) <= state.epoch:
        return None
    t0 = time.perf_counter()
    n = state.n
    adds = _validate_delta(adds if adds is not None else [], n, "adds")
    dels = _validate_delta(deletes if deletes is not None else [], n,
                           "deletes")
    sp = obs.begin("partition_update",
                   epoch=int(epoch or state.epoch + 1), adds=len(adds),
                   dels=len(dels))
    try:
        if len(adds):
            backend._fold_delta(state, adds)
            state.adds.append(adds)
            state.total_edges += len(adds)
            _account_adds(state, adds)
        if len(dels):
            from sheep_tpu_torch.io.deltalog import cancel_adds

            # resolved now, against the multiset as it stands: pending adds
            # first (they leave the survivors; the folded tree keeps them
            # until compaction), the rest tombstone base occurrences, as
            # net_effect resolves the one-shot log
            state.adds, base_tombs = cancel_adds(state.adds, dels)
            if len(base_tombs):
                state.tombs.append(base_tombs)
            state.pending_tombs.append(dels)
            state.stale_deletes += len(dels)
            state.total_edges = max(0, state.total_edges - len(dels))
            _account_dels(state, dels, base_tombs)
        state.epoch = int(epoch) if epoch is not None else state.epoch + 1
        for key, v in (("updates", 1), ("delta_adds", len(adds)),
                       ("delta_deletes", len(dels))):
            state.stats[key] = state.stats.get(key, 0) + v
        forced = compact == "force" or (
            compact == "auto"
            and state.stale_deletes > state.resolved_compact_threshold())
        if forced:
            compact_state(backend, state,
                          mode="auto" if compact == "auto" else "full")
        obs.event("delta_epoch_applied", epoch=state.epoch, adds=len(adds),
                  dels=len(dels), stale_deletes=state.stale_deletes,
                  compacted=bool(forced))
    finally:
        sp.end()
    state.stats["update_fold_s"] = round(
        state.stats.get("update_fold_s", 0.0) + time.perf_counter() - t0, 6)
    if not score:
        return None
    return refresh(backend, state, comm_volume=comm_volume)


def refresh(backend, state: PartitionState, comm_volume: bool = False):
    """The resident table as scored results: the tree split a k (O(V)),
    then the O(delta) rescore (cache seeded, no comm volume) or one full
    scoring pass of the survivors by ``backend.score_stream``, which seeds
    the cache. Both give the same numbers; ``SHEEP_SCORE_AUDIT=1`` runs the
    full pass beside the rescore and raises on any difference. Returns one
    result, or a list for several ks."""
    from sheep_tpu_torch.ops.split import tree_split_host
    from sheep_tpu_torch.types import PartitionResult

    t0 = time.perf_counter()
    n = state.n
    parent = _parent_from_minp(state.minp, state.order, n)
    w = state.deg_anchor.astype(np.float64) \
        if state.weights == "degree" else None
    assigns = {k: tree_split_host(parent, state.pos, k, weights=w,
                                  alpha=state.alpha)
               for k in state.ks}
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = state._score
    if sc is not None and "prev" in sc and not comm_volume:
        scored = _rescore_incremental(state, assigns, w, backend=backend)
        state.stats["score_incremental"] = \
            state.stats.get("score_incremental", 0) + 1
        if os.environ.get("SHEEP_SCORE_AUDIT", "") not in ("", "0"):
            full = backend.score_stream(state.survivor_stream(), assigns,
                                        comm_volume=False, weights=w)
            for k in state.ks:
                if tuple(scored[k]) != tuple(full[k]):
                    raise RuntimeError(
                        f"SHEEP_SCORE_AUDIT: incremental score diverged at "
                        f"epoch {state.epoch} k={k}: incremental="
                        f"{scored[k]} full={full[k]}")
    else:
        scored = backend.score_stream(state.survivor_stream(), assigns,
                                      comm_volume=comm_volume, weights=w)
        state.stats["score_full"] = state.stats.get("score_full", 0) + 1
        _seed_score_cache(state, assigns, scored)
    score_s = time.perf_counter() - t0
    state.stats["update_score_s"] = round(
        state.stats.get("update_score_s", 0.0) + score_s, 6)
    diag = {"epoch": float(state.epoch),
            "stale_deletes": float(state.stale_deletes),
            "compactions": float(state.compactions),
            **{k: float(v) for k, v in state.stats.items()
               if isinstance(v, (int, float))}}
    out = []
    for k in state.ks:
        cut, total, balance, cv = scored[k]
        out.append(PartitionResult(
            assignment=assigns[k], k=k, edge_cut=cut, total_edges=total,
            cut_ratio=cut / max(total, 1), balance=balance, comm_volume=cv,
            phase_times={"split": split_s / len(state.ks),
                         "score": score_s / len(state.ks)},
            backend=state.backend_name, diagnostics=dict(diag)))
    # the scored pass knows the surviving count exactly (an unmatched
    # tombstone removed nothing): the staleness threshold prices it
    state.total_edges = int(out[0].total_edges)
    return out[0] if len(out) == 1 else out


def compact_state(backend, state: PartitionState, mode: str = "auto") -> str:
    """Compaction (module docstring): ``full`` re-anchors on the survivors'
    degrees and refolds everything, ``subtree`` keeps the anchored order
    and refolds the edges of the parts the pending tombstones dirtied,
    ``auto`` takes subtree while at most a quarter of the parts are dirty.
    Returns the mode that ran ("noop" when nothing changed since the
    anchor)."""
    if mode not in ("auto", "full", "subtree"):
        raise ValueError(f"bad compact mode {mode!r}")
    pending = state.tomb_array(pending_only=True)
    if mode == "auto":
        mode = "full"
        if len(pending):
            k0 = state.ks[0]
            parts, _ = _dirty_parts(state, pending, k0)
            if len(parts) <= max(1, k0 // 4):
                mode = "subtree"
        elif state.epoch == state.anchored_at_epoch:
            state.pending_tombs = []
            state.stale_deletes = 0
            return "noop"
    sp = obs.begin("compact", mode=mode, pending_deletes=int(len(pending)))
    try:
        if mode == "full":
            _compact_full(backend, state)
        else:
            _compact_subtree(backend, state, pending)
    finally:
        sp.end()
    state.pending_tombs = []
    state.stale_deletes = 0
    state.compactions += 1
    state.stats["compactions"] = state.compactions
    obs.event("compacted", mode=mode, epoch=state.epoch,
              compactions=state.compactions)
    return mode


def _dirty_parts(state: PartitionState, pending: np.ndarray, k: int) -> tuple:
    """(dirty part ids, the assignment): a part is dirty when a pending
    tombstone's endpoint lies in it."""
    from sheep_tpu_torch.ops.split import tree_split_host

    parent = _parent_from_minp(state.minp, state.order, state.n)
    w = state.deg_anchor.astype(np.float64) \
        if state.weights == "degree" else None
    assign = tree_split_host(parent, state.pos, k, weights=w,
                             alpha=state.alpha)
    return set(np.unique(assign[pending.reshape(-1)]).tolist()), assign


def _compact_full(backend, state: PartitionState) -> None:
    """The backend's one-shot build of the survivors, re-anchored: equal to
    a build from scratch by construction."""
    res = backend.partition(state.survivor_stream(), state.ks[0],
                            weights=state.weights, comm_volume=False,
                            keep_tree=True)
    tree = res.tree
    n = state.n
    state.pos = np.asarray(tree["pos"], np.int64)[:n]
    state._order = None
    state.deg_anchor = np.asarray(tree["deg"], np.int64)[:n].copy()
    state.minp = _minp_from_parent(np.asarray(tree["parent"], np.int64),
                                   state.pos, n)
    state.total_edges = int(res.total_edges)
    state.anchored_at_epoch = state.epoch
    state.stats["compact_full"] = state.stats.get("compact_full", 0) + 1


def _compact_subtree(backend, state: PartitionState,
                     pending: np.ndarray) -> None:
    """The local repair under the anchored order: drop the table entries of
    the dirty parts' vertices (and of clean vertices whose parent is
    dirty), then refold every surviving edge with an end in a dirty part,
    in batches of up to 4 chunks a fold. A clean part's fill routed
    through a deleted edge can linger until a full compaction: the mode is
    score-bounded, not exact."""
    n = state.n
    dirty, assign = _dirty_parts(state, pending, state.ks[0])
    dirty_mask = np.isin(assign, np.asarray(sorted(dirty),
                                            dtype=assign.dtype))
    minp = state.minp.copy()
    # the kept table holds constraints inside the clean region only
    parent = _parent_from_minp(minp, state.order, n)
    has = parent >= 0
    parent_dirty = np.zeros(n, dtype=bool)
    parent_dirty[has] = dirty_mask[parent[has]]
    minp[:n][dirty_mask | parent_dirty] = n
    state.minp = minp
    cs = state.chunk_edges
    refolded = 0
    batch: list = []
    batch_n = 0

    def _flush():
        # one fold a batch: each fold moves the O(V) table up and back
        nonlocal refolded, batch, batch_n
        if batch:
            backend._fold_delta(state, np.concatenate(batch))
            refolded += batch_n
            batch, batch_n = [], 0

    for chunk in state.survivor_stream().chunks(cs):
        e = np.asarray(chunk, np.int64).reshape(-1, 2)
        if not len(e):
            continue
        sub = e[dirty_mask[e[:, 0]] | dirty_mask[e[:, 1]]]
        if len(sub):
            batch.append(sub)
            batch_n += len(sub)
            if batch_n >= 4 * cs:
                _flush()
    _flush()
    state.stats["compact_subtree"] = state.stats.get("compact_subtree", 0) + 1
    state.stats["compact_refolded_edges"] = \
        state.stats.get("compact_refolded_edges", 0) + refolded


def rebase_state(backend, state: PartitionState, base_out: str) -> str:
    """Full compaction, then the surviving multiset written as a fresh
    ``.csr`` base at ``base_out`` (atomically) and the add and tombstone
    history dropped, so the filter and the history stay O(recent). The
    caller orders the durability around it (a snapshot naming the new base
    before the old one is deleted). The score cache is dropped. Returns
    ``base_out``."""
    from sheep_tpu_torch.io import csr as csr_mod
    from sheep_tpu_torch.io.edgestream import EdgeStream

    pending = state.tomb_array(pending_only=True)
    sp = obs.begin("compact", mode="rebase",
                   pending_deletes=int(len(pending)))
    try:
        _compact_full(backend, state)
        csr_mod.write_csr(base_out, state.survivor_stream(),
                          n_vertices=state.n, chunk_edges=state.chunk_edges)
        state.base = EdgeStream.open(base_out)
        state.base_spec = base_out
        state.adds = []
        state.tombs = []
        state.pending_tombs = []
        state.stale_deletes = 0
        _drop_score_cache(state)
    finally:
        sp.end()
    state.compactions += 1
    state.stats["compactions"] = state.compactions
    state.stats["rebase"] = state.stats.get("rebase", 0) + 1
    obs.event("compacted", mode="rebase", epoch=state.epoch,
              compactions=state.compactions, base=base_out)
    return base_out


# -- snapshots: the reference's npz format -----------------------------------

STATE_VERSION = 1


def save_state(state: PartitionState, path: str) -> None:
    """An atomic snapshot (tmp, fsync, rename) of the arrays and the meta.
    The base stream is not saved: :func:`load_state` re-opens
    ``base_spec`` (or takes an open stream)."""
    meta = {"v": STATE_VERSION, "n": state.n, "ks": state.ks,
            "weights": state.weights, "alpha": state.alpha,
            "chunk_edges": state.chunk_edges,
            "backend_name": state.backend_name,
            "base_spec": state.base_spec, "epoch": state.epoch,
            "anchored_at_epoch": state.anchored_at_epoch,
            "stale_deletes": state.stale_deletes,
            "compactions": state.compactions,
            "compact_threshold": state.compact_threshold,
            "total_edges": state.total_edges}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, meta=np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8),
                 pos=state.pos, deg_anchor=state.deg_anchor, minp=state.minp,
                 adds=state.adds_array(), tombs=state.tomb_array(),
                 pending_tombs=state.tomb_array(pending_only=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_state(path: str, base=None) -> PartitionState:
    """Reload a snapshot; ``base`` stands for re-opening ``base_spec``
    (which an in-memory base does not have)."""
    from sheep_tpu_torch.io.edgestream import open_input

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        if int(meta.get("v", 0)) > STATE_VERSION:
            raise ValueError(f"{path}: resident state v{meta.get('v')} is "
                             f"newer than this reader")
        arrays = {k: z[k] for k in ("pos", "deg_anchor", "minp", "adds",
                                    "tombs", "pending_tombs")}
    if base is None:
        if not meta.get("base_spec"):
            raise ValueError(f"{path}: state has no base_spec; pass the "
                             f"base stream explicitly")
        base = open_input(meta["base_spec"])
    st = PartitionState(
        n=int(meta["n"]), ks=[int(k) for k in meta["ks"]],
        weights=meta["weights"], alpha=float(meta["alpha"]),
        chunk_edges=int(meta["chunk_edges"]),
        backend_name=meta["backend_name"],
        pos=arrays["pos"].astype(np.int64),
        deg_anchor=arrays["deg_anchor"].astype(np.int64),
        minp=arrays["minp"].astype(np.int32),
        total_edges=int(meta["total_edges"]), base=base,
        base_spec=meta.get("base_spec"), epoch=int(meta["epoch"]),
        anchored_at_epoch=int(meta.get("anchored_at_epoch", 0)),
        stale_deletes=int(meta["stale_deletes"]),
        compactions=int(meta["compactions"]),
        compact_threshold=meta.get("compact_threshold"))
    for name in ("adds", "tombs", "pending_tombs"):
        if len(arrays[name]):
            setattr(st, name,
                    [arrays[name].astype(np.int64).reshape(-1, 2)])
    return st
