"""Edge-cut scoring (counterpart of ``score_chunk`` and the comm-volume keys
of ``sheep_tpu/ops/score.py``).

Per chunk: part lookups for both endpoints and predicated counts under the
validity mask (endpoints in [0, n), no self-loop). Comm volume is the
number of distinct (vertex, foreign part) pairs over cut edges, encoded as
int64 keys ``vertex * k + foreign_part`` and uniqued on the device (the
reference pulls them to the host and uniques there; the count is the
same).
"""

from __future__ import annotations

import torch

# pending keys are compacted (sort + unique) once the accumulator holds
# more than this many (1 GiB of int64 keys)
CV_COMPACT_ENTRIES = 1 << 27


def _endpoint_parts(edges: torch.Tensor, assign: torch.Tensor, n: int):
    e = edges.to(torch.int32)
    u, v = e[:, 0], e[:, 1]
    valid = (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)
    pu = assign[u.clamp(0, n).long()]
    pv = assign[v.clamp(0, n).long()]
    return u, v, valid, pu, pv


def score_chunk(edges: torch.Tensor, assign: torch.Tensor, n: int):
    """(cut, total) counts of one (C, 2) chunk as 0-d int64 tensors.
    ``assign`` is int32[n+1]; padding is any endpoint outside [0, n)."""
    _, _, valid, pu, pv = _endpoint_parts(edges, assign, n)
    return (valid & (pu != pv)).sum(), valid.sum()


def cut_pair_keys(edges: torch.Tensor, assign: torch.Tensor, n: int,
                  k: int) -> torch.Tensor:
    """The chunk's distinct comm-volume keys (int64, on the chunk's
    device)."""
    u, v, valid, pu, pv = _endpoint_parts(edges, assign, n)
    cut = valid & (pu != pv)
    keys = torch.cat([u[cut].long() * k + pv[cut].long(),
                      v[cut].long() * k + pu[cut].long()])
    return torch.unique(keys)


def accumulate_cv_keys(cv_chunks: list, keys: torch.Tensor) -> list:
    """Append a chunk's keys; compact in place (sort + unique on the keys'
    device) once the pending tail after the compacted head exceeds the
    cap, bounding memory at O(distinct + cap)."""
    cv_chunks.append(keys)
    if len(cv_chunks) > 1 and \
            sum(len(c) for c in cv_chunks[1:]) > CV_COMPACT_ENTRIES:
        merged = torch.unique(torch.cat(cv_chunks))
        cv_chunks.clear()
        cv_chunks.append(merged)
    return cv_chunks


def comm_volume_keys(cv_chunks: list) -> torch.Tensor:
    """The distinct keys over all accumulated chunks, sorted (int64; a
    score checkpoint saves them)."""
    if not cv_chunks:
        return torch.zeros(0, dtype=torch.int64)
    return torch.unique(torch.cat(cv_chunks))


def comm_volume(cv_chunks: list) -> int:
    """Number of distinct keys over all accumulated chunks."""
    return int(comm_volume_keys(cv_chunks).numel())


def part_loads_accounting(assign, k: int, weights=None,
                          cap: float = None) -> dict:
    """Balance and capacity accounting of one assignment (the reference's
    ``part_loads_accounting``, host numpy): the spread of the part loads
    and, with ``cap``, how many parts sit at or above it and their share
    of the load. A part at the cap can only shrink under a
    capacity-respecting repair, so cut held behind such parts belongs to
    the balance budget."""
    import numpy as np

    a = np.asarray(assign)
    if weights is None:
        loads = np.bincount(a, minlength=k).astype(np.float64)
    else:
        loads = np.bincount(a, weights=np.asarray(weights, np.float64),
                            minlength=k)
    total = float(loads.sum())
    mean = total / max(k, 1)
    out = {"balance": float(loads.max() / mean) if mean > 0 else 1.0,
           "max_load": float(loads.max()), "min_load": float(loads.min()),
           "empty_parts": int((loads == 0).sum())}
    if cap is not None:
        at_cap = loads >= float(cap)
        out["cap"] = float(cap)
        out["parts_at_capacity"] = int(at_cap.sum())
        out["frozen_load_fraction"] = round(
            float(loads[at_cap].sum() / total) if total else 0.0, 6)
    return out


def edge_effect_host(edges, assignments: dict, n: int) -> tuple:
    """``(valid count, {k: cut count})`` of a delta batch under existing
    assignments, on the host, with :func:`score_chunk`'s validity mask
    (endpoints in [0, n), no self-loop): the O(delta) accounting that keeps
    an incrementally maintained (cut, total) equal to a full scoring
    pass."""
    import numpy as np

    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u, v = e[:, 0], e[:, 1]
    valid = (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)
    uc, vc = u[valid], v[valid]
    cuts = {k: int(np.count_nonzero(a[uc] != a[vc]))
            for k, a in assignments.items()}
    return int(np.count_nonzero(valid)), cuts


def move_rescore_sharded(src, dst, prevs: dict, news: dict, masks: dict,
                         mesh) -> dict:
    """The cut deltas ``{k: delta}`` of a batch of part moves, every k at
    once, from per-shard partial sums reduced once over the ``mesh``: the
    reference's ``move_rescore_sharded`` (``sheep_tpu/ops/score.py:227``),
    the sharded twin of :func:`~sheep_tpu_torch.ops.refine.
    move_rescore_host`. The arcs (src, dst) are padded with the sentinel
    n to a power of two a shard (at least 2^10) and split into contiguous
    blocks, one a shard; each shard sums, a k, the kept arcs' change of
    cut where the far end did not move (not-both) and where it did
    (both), and one ``psum`` adds the shards. The both-moved sum counts
    each edge from both ends, so it is halved after the reduction, where
    it is even. ``prevs`` / ``news`` / ``masks`` are ``{k: array[n]}``
    for the ks whose assignment moved."""
    import numpy as np

    from sheep_tpu_torch.ops.elim import pow2_at_least
    from sheep_tpu_torch.parallel.mesh import psum

    ks = list(prevs)
    out = {k: 0 for k in ks}
    s = np.asarray(src)
    d = np.asarray(dst)
    if not len(s) or not ks:
        return out
    n = int(len(next(iter(prevs.values()))))
    shards = len(mesh)
    per = pow2_at_least(-(-len(s) // shards), floor=1 << 10)
    su = np.full(per * shards, n, np.int64)
    du = np.full(per * shards, n, np.int64)
    su[:len(s)] = s
    du[:len(d)] = d
    kk = len(ks)
    prev_t = np.zeros((kk, n + 1), np.int32)
    new_t = np.zeros((kk, n + 1), np.int32)
    mask_t = np.zeros((kk, n + 1), bool)
    for i, k in enumerate(ks):
        prev_t[i, :n] = prevs[k]
        new_t[i, :n] = news[k]
        mask_t[i, :n] = masks[k]
    tables = {}
    parts = []
    for i, dev in enumerate(mesh):
        if dev not in tables:
            tables[dev] = tuple(torch.from_numpy(t).to(dev)
                                for t in (prev_t, new_t, mask_t))
        prev_, new_, mask_ = tables[dev]
        s_l = torch.from_numpy(su[i * per:(i + 1) * per]).to(dev)
        d_l = torch.from_numpy(du[i * per:(i + 1) * per]).to(dev)
        keep = mask_[:, s_l]
        both = mask_[:, d_l]
        diff = (new_[:, s_l] != new_[:, d_l]).to(torch.int32) \
            - (prev_[:, s_l] != prev_[:, d_l]).to(torch.int32)
        dk = torch.where(keep, diff, 0)
        s_nb = torch.where(both, 0, dk).sum(1, dtype=torch.int32)
        s_b = torch.where(both, dk, 0).sum(1, dtype=torch.int32)
        parts.append(torch.stack([s_nb, s_b], 1))
    part = psum(parts)[0].cpu().numpy()
    for i, k in enumerate(ks):
        s_nb, s_b = int(part[i, 0]), int(part[i, 1])
        assert s_b % 2 == 0
        out[k] = s_nb + s_b // 2
    return out
