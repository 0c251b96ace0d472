"""Hierarchical partitioning, k = k1 * k2 * ... one level at a time
(counterpart of ``sheep_tpu/hierarchy.py``).

Refinement recovers community structure only while the average
intra-community degree a part stays above about 1, so a large flat k
stalls where a split into levels does not: partition and refine at k1,
then partition each part's induced subgraph at the remaining levels, and
label vertex v as ``part(v) * prod(k_rest) + subpart(v)``.

Each level's intra edges are spilled, relabelled to the part's dense local
ids, into one ``.bin32`` shard a part (8 bytes an intra edge of the
current level) in one streaming pass, with at most 64 files open; each
shard is then a file-backed stream of its own, and is removed once its
subtree is done. The spill directory is removed when the run ends or
fails.

``balance=BETA`` budgets the end-to-end bound as BETA**(1/levels) a level
and clamps each level's refine cap to it; ``final_refine=N`` runs N
warm-start refine rounds at the full k after assembly. The result carries
the level ledger: the cut of each level, summing to the final cut.

The reference's checkpoint and multi-process options are not ported
(ROADMAP Queue 1 items 5 and 7); this signature does not take them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import OrderedDict

import numpy as np

_SPILL_MAX_FDS = 64


def level_ledger(stream, final, k_levels, edge_cut: int, total: int,
                 chunk_edges: int = 1 << 22, device=None) -> list:
    """The cut of a hierarchical assignment by level: row d counts the
    edges whose endpoint labels first differ at level d (level 0: between
    top-level parts). One scoring pass of the level-prefix labels
    ``final // prod(k_levels[d+1:])`` (cut only); the deepest prefix is
    ``final``, whose cut is ``edge_cut``. Levels with k = 1 fold into their
    parent row. The rows sum to ``edge_cut``."""
    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    rows = []
    to_score = {}
    kp = 1
    suffix = int(np.prod(k_levels))
    for d, kd in enumerate(k_levels):
        kp *= int(kd)
        suffix //= int(kd)
        if kd <= 1:
            continue
        rows.append({"level": d, "k": kp})
        if suffix > 1:
            to_score[kp] = (np.asarray(final, np.int64)
                            // suffix).astype(np.int32)
    if not rows:
        rows = [{"level": 0, "k": kp}]
    cum = {}
    if to_score:
        scored = TorchBackend(chunk_edges=chunk_edges,
                              device=device).score_stream(
            stream, to_score, comm_volume=False)
        cum = {k: scored[k][0] for k in to_score}
    cum[kp] = int(edge_cut)
    prev = 0
    for row in rows:
        c = int(cum.get(row["k"], edge_cut))
        row["cut"] = c - prev
        row["cut_ratio"] = round(row["cut"] / max(total, 1), 6)
        row["cut_cum"] = c
        prev = c
    return rows


def _spill_intra(stream, assign, k1, chunk_edges, tmpdir, local_id):
    """One streaming pass: each part's intra edges, relabelled to the
    part's local ids, appended to ``tmpdir/p{p}.bin32``; returns the
    per-part paths (every part gets a file, maybe empty). Each chunk is
    grouped by part once (a stable argsort and a boundary search); at most
    ``_SPILL_MAX_FDS`` files are open, least recently used closed first."""
    paths = [os.path.join(tmpdir, f"p{p}.bin32") for p in range(k1)]
    for p in paths:
        open(p, "wb").close()
    lru: OrderedDict = OrderedDict()

    def handle(p):
        f = lru.get(p)
        if f is not None:
            lru.move_to_end(p)
            return f
        if len(lru) >= _SPILL_MAX_FDS:
            _, old = lru.popitem(last=False)
            old.close()
        f = lru[p] = open(paths[p], "ab", buffering=1 << 16)
        return f

    try:
        for c in stream.chunks(chunk_edges):
            e = np.asarray(c, np.int64).reshape(-1, 2)
            pu = assign[e[:, 0]]
            keep = pu == assign[e[:, 1]]
            e = e[keep]
            pu = pu[keep]
            if not len(e):
                continue
            grp = np.argsort(pu, kind="stable")
            lo = local_id[e[grp]].astype(np.uint32)
            bounds = np.searchsorted(pu[grp], np.arange(k1 + 1))
            for p in range(k1):
                a, b = bounds[p], bounds[p + 1]
                if b > a:
                    handle(p).write(lo[a:b].tobytes())
    finally:
        for f in lru.values():
            f.close()
    return paths


def _hier_assign(stream, k_levels, refine, refine_alpha, chunk_edges,
                 tmpdir, opts, timings=None, spill_bytes=None, depth=0):
    """The assignment of ``stream`` at k = prod(k_levels), recursing.
    ``timings`` gathers ``level{d}_partition`` / ``level{d}_spill``
    seconds, ``spill_bytes`` the ``level{d}_spill_bytes``."""
    from sheep_tpu_torch import _partition_stream
    from sheep_tpu_torch.io.edgestream import EdgeStream

    def t_add(key, dt):
        if timings is not None:
            timings[key] = round(timings.get(key, 0.0) + dt, 3)

    n = stream.num_vertices
    k1 = k_levels[0]
    k_sub = int(np.prod(k_levels[1:])) if len(k_levels) > 1 else 1
    t0 = time.perf_counter()
    # inner levels' comm volume is not needed: the final score counts it
    res = _partition_stream(stream, k1, refine=refine,
                            refine_alpha=refine_alpha,
                            chunk_edges=chunk_edges,
                            **{**opts, "comm_volume": False})
    assign = np.asarray(res.assignment, np.int32)
    t_add(f"level{depth}_partition", time.perf_counter() - t0)
    if len(k_levels) == 1:
        return assign

    # dense local ids: vertex v is the local_id[v]-th member of its part
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k1).astype(np.int64)
    offsets = np.zeros(k1 + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    local_id = np.empty(n, np.int32)
    local_id[order] = (np.arange(n, dtype=np.int64)
                       - np.repeat(offsets[:-1], counts)).astype(np.int32)
    level_dir = tempfile.mkdtemp(prefix="lvl_", dir=tmpdir)
    try:
        t0 = time.perf_counter()
        paths = _spill_intra(stream, assign, k1, chunk_edges, level_dir,
                             local_id)
        t_add(f"level{depth}_spill", time.perf_counter() - t0)
        if spill_bytes is not None:
            key = f"level{depth}_spill_bytes"
            spill_bytes[key] = spill_bytes.get(key, 0) + sum(
                os.path.getsize(p) for p in paths)
        del local_id
        final = np.zeros(n, np.int32)
        for p in range(k1):
            members = order[offsets[p]:offsets[p + 1]]
            if len(members) == 0:
                pass
            elif len(members) <= k_sub:
                # a tiny part: round-robin keeps every label in [0, k_sub);
                # a final refine repairs these where a better part exists
                final[members] = p * k_sub + np.arange(
                    len(members), dtype=np.int32) % k_sub
            else:
                sub = EdgeStream.open(paths[p], n_vertices=len(members))
                sub_assign = _hier_assign(sub, k_levels[1:], refine,
                                          refine_alpha, chunk_edges, tmpdir,
                                          opts, timings=timings,
                                          spill_bytes=spill_bytes,
                                          depth=depth + 1)
                final[members] = p * k_sub + sub_assign
                os.remove(paths[p])  # subtree done: reclaim its shard
    finally:
        shutil.rmtree(level_dir, ignore_errors=True)
    return final


def partition_hierarchical(path, k_levels, device=None, refine=8,
                           refine_alpha: float = 1.10,
                           chunk_edges: int = 1 << 22,
                           balance: float | None = None,
                           final_refine: int = 0,
                           spill_dir: str | None = None,
                           n_vertices: int | None = None,
                           refine_budget_bytes: int = 4 << 30, **opts):
    """Partition into prod(k_levels) parts, one level at a time, as the
    reference's ``partition_hierarchical``. ``refine`` rounds run at every
    level; ``balance=BETA`` sets each level's split alpha to
    min(BETA**(1/levels) - 1, 1) and clamps ``refine_alpha`` to
    BETA**(1/levels) (it excludes an explicit ``alpha``); ``final_refine``
    adds warm-start rounds at the full k, capped at ``balance`` (or
    ``refine_alpha``), with ``refine_budget_bytes`` for its histogram.
    ``opts`` are :func:`sheep_tpu_torch.partition`'s (``weights``,
    ``alpha``, ``comm_volume`` and the build's knobs); any other raises
    ``TypeError``. Runs on ``device`` (None: CUDA). Returns a
    PartitionResult over the full stream with its backend tagged
    ``+hier[...]``, the level seconds in ``phase_times`` and the ledger in
    ``diagnostics``."""
    import dataclasses

    from sheep_tpu_torch import comm_volume_of, refine_result
    from sheep_tpu_torch.backends.torch_backend import TorchBackend
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.ops.score import part_loads_accounting
    from sheep_tpu_torch.types import PartitionResult

    k_levels = [int(k) for k in k_levels]
    if len(k_levels) < 1 or any(k < 1 for k in k_levels):
        raise ValueError(f"k_levels must be positive ints, got {k_levels}")
    k_total = int(np.prod(k_levels))
    build = {key: v for key, v in opts.items()
             if key not in ("weights", "alpha", "comm_volume")}
    # the build's options are checked, and the device resolved, up front
    be = TorchBackend(chunk_edges=chunk_edges, device=device, **build)
    opts = {**opts, "device": be.device}
    if balance is not None:
        if balance <= 1.0:
            raise ValueError(f"balance must be > 1, got {balance}")
        if "alpha" in opts and opts["alpha"] != 1.0:
            raise ValueError("balance sets the per-level alpha; do not "
                             "also pass alpha")
        beta_level = balance ** (1.0 / len(k_levels))
        opts["alpha"] = min(beta_level - 1.0, 1.0)
        # a level's refine must not void the budget it refines under
        refine_alpha = min(refine_alpha, beta_level)
    comm_volume = opts.get("comm_volume", True)
    weights = opts.get("weights", "unit")

    tmp_root = tempfile.mkdtemp(prefix="sheep_hier_", dir=spill_dir)
    timings: dict = {}
    spill_bytes: dict = {}
    try:
        with open_input(path, n_vertices=n_vertices) as es:
            final = _hier_assign(es, k_levels, refine, refine_alpha,
                                 chunk_edges, tmp_root, dict(opts),
                                 timings=timings, spill_bytes=spill_bytes)
            w = None
            if weights == "degree":
                # balance is scored with the weights the levels used
                t0 = time.perf_counter()
                n = es.num_vertices
                w = np.zeros(n, dtype=np.int64)
                for c in es.chunks(chunk_edges):
                    w += np.bincount(np.asarray(c, np.int64).ravel(),
                                     minlength=n)[:n]
                timings["degrees_weights"] = round(
                    time.perf_counter() - t0, 3)
            # with a final refine coming, the comm volume waits for its
            # result
            t0 = time.perf_counter()
            cut, total, balance_got, cv = be.score_stream(
                es, {k_total: final},
                comm_volume=comm_volume and not final_refine,
                weights=w)[k_total]
            timings["score"] = round(time.perf_counter() - t0, 3)
            tag = f"{be.name}:{be.device.type}+hier{k_levels}"
            res = PartitionResult(
                assignment=final, k=k_total, edge_cut=cut,
                total_edges=total, cut_ratio=cut / max(total, 1),
                balance=balance_got, comm_volume=cv, phase_times=timings,
                backend=tag, diagnostics=spill_bytes)
            if final_refine:
                t0 = time.perf_counter()
                res = refine_result(
                    res, es, rounds=final_refine,
                    alpha=balance if balance is not None else refine_alpha,
                    weights=weights, degrees=w,
                    budget_bytes=refine_budget_bytes, device=be.device)
                res.phase_times["final_refine"] = round(
                    time.perf_counter() - t0, 3)
                if comm_volume:
                    t0 = time.perf_counter()
                    res = dataclasses.replace(
                        res, comm_volume=comm_volume_of(
                            res.assignment, es, es.num_vertices, k_total,
                            chunk_edges, device=be.device))
                    res.phase_times["comm_volume"] = round(
                        time.perf_counter() - t0, 3)
            # the ledger prices what ships: the cut of each level, and the
            # parts at the full k's cap
            t0 = time.perf_counter()
            ledger = level_ledger(es, res.assignment, k_levels,
                                  res.edge_cut, res.total_edges,
                                  chunk_edges=chunk_edges, device=be.device)
            alpha_rep = balance if balance is not None else refine_alpha
            cap = (alpha_rep * (-(-len(res.assignment) // k_total))
                   if w is None else
                   alpha_rep * float(np.sum(w)) / k_total)
            acct = part_loads_accounting(res.assignment, k_total,
                                         weights=w, cap=cap)
            for row in ledger:
                res.diagnostics[f"cut_level{row['level']}"] = row["cut"]
                res.diagnostics[f"cut_ratio_level{row['level']}"] = \
                    row["cut_ratio"]
            res.diagnostics["ledger_parts_at_capacity"] = \
                acct["parts_at_capacity"]
            res.diagnostics["ledger_frozen_load_fraction"] = \
                acct["frozen_load_fraction"]
            if final_refine:
                before = res.diagnostics.get("refine_cut_before")
                after = res.diagnostics.get("refine_cut_after")
                if before is not None and after is not None:
                    res.diagnostics["final_refine_repaired"] = \
                        int(before - after)
            timings["ledger"] = round(time.perf_counter() - t0, 3)
            return res
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
