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

With a checkpointer the run recovers at two granularities, as the
reference's: inside level 0 at chunk granularity (its partition saves
into the nested ``level0/`` domain, under fault scope ``level0``), and at
the top level's part boundaries (phase ``hier``: the level-0 assignment,
the partial final one and the manifest of the spill shards, which then
live under ``<checkpoint dir>/hier_spill_p<process>``, are kept on a fault
and reused on resume; ``level`` is the injection point, a part). A shard
missing or torn on resume rebuilds the level from scratch, with a
warning.

Several processes (``backend="torch-sharded"`` or ``"torch-bigv"`` over a
mesh of several processes, ``nprocs`` of them): every level's partition
runs through that backend across the processes, and every process spills
its own copy of the shards and replays the same recursion, so the
collectives stay in lockstep. A resume agrees on one level-boundary step
(``utils/checkpoint.reconcile_multihost_resume``), and the spill-damage
verdict is allgathered: one process rebuilding level 0 alone would cross
the others' collectives.
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
import time
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np

from sheep_tpu_torch import obs

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


def _save_hier(checkpointer, parts_done, assign, final, spill_names,
               spill_sizes, meta):
    """The level-boundary checkpoint (phase ``hier``, chunk index = the
    next top-level part): the level-0 assignment, the partial final one,
    and the spill shards' names and byte sizes (-1: consumed by a finished
    subtree), as the reference saves them."""
    checkpointer.save(
        "hier", int(parts_done),
        {"assign": np.asarray(assign, np.int32),
         "final": np.asarray(final, np.int32),
         "level": np.int64(0),
         "spill_names": np.asarray(list(spill_names)),
         "spill_sizes": np.asarray(spill_sizes, np.int64)}, meta)


def _spill_manifest_problem(level_dir, names, sizes, parts_done):
    """None when every shard still pending exists at its recorded size;
    else what is wrong (the caller rebuilds the level, with a warning)."""
    for p, (name, size) in enumerate(zip(names, sizes)):
        if p < parts_done or int(size) < 0:
            continue
        shard = os.path.join(level_dir, str(name))
        try:
            got = os.path.getsize(shard)
        except OSError:
            return f"spill shard {name} missing"
        if got != int(size):
            return f"spill shard {name} is {got} bytes, manifest says " \
                   f"{int(size)}"
    return None


def _hier_assign(stream, k_levels, refine, refine_alpha, chunk_edges,
                 tmpdir, opts, timings=None, spill_bytes=None, depth=0,
                 checkpointer=None, resume=False, meta=None, nprocs=1):
    """The assignment of ``stream`` at k = prod(k_levels), recursing.
    ``timings`` gathers ``level{d}_partition`` / ``level{d}_spill``
    seconds, ``spill_bytes`` the ``level{d}_spill_bytes``.
    ``checkpointer`` (depth 0 only) arms the recovery of the module
    docstring; ``meta`` is the fingerprint its saves carry; ``nprocs`` >
    1 makes the resume and the spill verdict collective."""
    from sheep_tpu_torch import _partition_stream
    from sheep_tpu_torch.io.edgestream import EdgeStream
    from sheep_tpu_torch.utils import checkpoint as ckpt_mod
    from sheep_tpu_torch.utils import fault

    def t_add(key, dt):
        if timings is not None:
            timings[key] = round(timings.get(key, 0.0) + dt, 3)

    n = stream.num_vertices
    k1 = k_levels[0]
    k_sub = int(np.prod(k_levels[1:])) if len(k_levels) > 1 else 1
    state = ckpt_mod.resume_state(checkpointer, meta, resume,
                                  raise_on_mismatch=nprocs == 1)
    if nprocs > 1 and checkpointer is not None and resume:
        state = ckpt_mod.reconcile_multihost_resume(checkpointer, state,
                                                    meta)
    level_dir = None
    if checkpointer is not None:
        # the shards' home, the same across resumes; the inner levels'
        # transient directories of a killed attempt are reclaimed
        level_dir = os.path.join(tmpdir, "level0_shards")
        for stale in glob.glob(os.path.join(tmpdir, "lvl_*")):
            shutil.rmtree(stale, ignore_errors=True)
    parts_done = 0
    spill_names: list = []
    spill_sizes = np.zeros(0, np.int64)
    if state is not None:
        assign = np.asarray(state.arrays["assign"], np.int32)
        final = np.asarray(state.arrays["final"], np.int32).copy()
        parts_done = int(state.chunk_idx)
        spill_names = [str(x) for x in state.arrays["spill_names"]]
        spill_sizes = np.asarray(state.arrays["spill_sizes"],
                                 np.int64).copy()
        problem = _spill_manifest_problem(level_dir, spill_names,
                                          spill_sizes, parts_done)
        if nprocs > 1:
            # a rebuild adds collective work: every process rebuilds, or
            # none (the reconcile agreed on the step, so all reach this)
            from sheep_tpu_torch.parallel.mesh import process_allgather

            bad = process_allgather(
                np.array([1 if problem is not None else 0], np.int64))
            if bad.any() and problem is None:
                problem = "a peer process reported spill damage"
        if problem is not None:
            ckpt_mod._warn(f"hierarchy resume: {problem}; rebuilding the "
                           f"level from scratch")
            state = None
        else:
            # a level-boundary checkpoint makes the level-0 domain
            # obsolete
            checkpointer.child("level0").clear(force=True)
    level0_ck = None
    if state is None:
        if checkpointer is not None:
            level0_ck = checkpointer.child("level0")
        t0 = time.perf_counter()
        # inner levels' comm volume is not needed: the final score counts
        # it
        with fault.scope("level0") if depth == 0 else nullcontext(), \
                obs.span("hier_partition", level=depth, k=k1):
            res = _partition_stream(stream, k1, refine=refine,
                                    refine_alpha=refine_alpha,
                                    chunk_edges=chunk_edges,
                                    checkpointer=level0_ck, resume=resume,
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
    if state is None:
        local_id = np.empty(n, np.int32)
        local_id[order] = (np.arange(n, dtype=np.int64)
                           - np.repeat(offsets[:-1], counts)).astype(np.int32)
        if level_dir is None:
            level_dir = tempfile.mkdtemp(prefix="lvl_", dir=tmpdir)
        else:
            os.makedirs(level_dir, exist_ok=True)
        t0 = time.perf_counter()
        sp = obs.begin("hier_spill", level=depth, parts=k1)
        try:
            paths = _spill_intra(stream, assign, k1, chunk_edges, level_dir,
                                 local_id)
        finally:
            sp.end()
        t_add(f"level{depth}_spill", time.perf_counter() - t0)
        if spill_bytes is not None:
            key = f"level{depth}_spill_bytes"
            spill_bytes[key] = spill_bytes.get(key, 0) + sum(
                os.path.getsize(p) for p in paths)
        del local_id
        final = np.zeros(n, np.int32)
        parts_done = 0
        if checkpointer is not None:
            spill_names = [os.path.basename(p) for p in paths]
            spill_sizes = np.array([os.path.getsize(p) for p in paths],
                                   np.int64)
            # bank level 0 and the shards before the level-0 chunk
            # checkpoints go: at no instant is level 0 only in memory
            _save_hier(checkpointer, 0, assign, final, spill_names,
                       spill_sizes, meta)
            level0_ck.clear(force=True)
    else:
        paths = [os.path.join(level_dir, nm) for nm in spill_names]

    start_parts = parts_done
    pending_rm: list = []
    prev_rm: list = []

    def save_boundary(p_next):
        # consumed shards leave the manifest one save before they leave
        # the disk: a resume may fall back to the previous step, whose
        # manifest still names them
        for q in pending_rm:
            spill_sizes[q] = -1
        _save_hier(checkpointer, p_next, assign, final, spill_names,
                   spill_sizes, meta)
        for q in prev_rm:
            try:
                os.remove(paths[q])
            except OSError:
                pass
        prev_rm[:] = pending_rm
        pending_rm.clear()

    ok = False
    try:
        for p in range(parts_done, k1):
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
                if checkpointer is None:
                    os.remove(paths[p])  # subtree done: reclaim its shard
                else:
                    pending_rm.append(p)
            if checkpointer is not None and (
                    p == k1 - 1 or checkpointer.due_span(p, p + 1)):
                save_boundary(p + 1)
            if depth == 0:
                fault.maybe_fail("level", p + 1 - start_parts)
        ok = True
    finally:
        # with a checkpointer, a fault leaves the shards for the resume
        if ok or checkpointer is None:
            shutil.rmtree(level_dir, ignore_errors=True)
    return final


def partition_hierarchical(path, k_levels, device=None, refine=8,
                           refine_alpha: float = 1.10,
                           chunk_edges: int = 1 << 22,
                           balance: float | None = None,
                           final_refine: int = 0,
                           spill_dir: str | None = None,
                           n_vertices: int | None = None,
                           refine_budget_bytes: int = 4 << 30,
                           checkpointer=None, resume: bool = False,
                           nprocs: int = 1, **opts):
    """Partition into prod(k_levels) parts, one level at a time, as the
    reference's ``partition_hierarchical``. ``refine`` rounds run at every
    level; ``balance=BETA`` sets each level's split alpha to
    min(BETA**(1/levels) - 1, 1) and clamps ``refine_alpha`` to
    BETA**(1/levels) (it excludes an explicit ``alpha``); ``final_refine``
    adds warm-start rounds at the full k, capped at ``balance`` (or
    ``refine_alpha``), with ``refine_budget_bytes`` for its histogram.
    ``opts`` are :func:`sheep_tpu_torch.partition`'s (``weights``,
    ``alpha``, ``comm_volume``, ``backend``, ``n_devices`` and the
    build's knobs); any other raises ``TypeError``. Every level's
    partition runs through ``backend``; the scores, the refinement and
    the ledger run on ``device``. ``checkpointer``/``resume`` make the run
    recoverable (module docstring); a run that succeeds clears its
    checkpoint, the level-0 domain and the spill shards. ``nprocs`` > 1:
    the processes of a multi-process mesh, which reconcile a resume's
    step collectively. Runs on ``device`` (None: CUDA).
    Returns a PartitionResult over the full stream with its backend tagged
    ``+hier[...]``, the level seconds in ``phase_times`` and the ledger in
    ``diagnostics``."""
    import dataclasses

    import sheep_tpu_torch
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
             if key not in ("weights", "alpha", "comm_volume", "backend",
                            "n_devices")}
    inner = opts.get("backend", "torch")
    if inner not in sheep_tpu_torch.BACKENDS:
        raise ValueError(f"unknown backend {inner!r}; the port has "
                         f"{', '.join(sheep_tpu_torch.BACKENDS)}")
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

    if checkpointer is not None:
        # the shards outlive the process to be resumable
        tmp_root = os.path.join(checkpointer.dir,
                                f"hier_spill_p{checkpointer.process}")
        os.makedirs(tmp_root, exist_ok=True)
    else:
        tmp_root = tempfile.mkdtemp(prefix="sheep_hier_", dir=spill_dir)
    timings: dict = {}
    spill_bytes: dict = {}
    try:
        with open_input(path, n_vertices=n_vertices) as es:
            meta = None
            if checkpointer is not None:
                from sheep_tpu_torch.utils import checkpoint as ckpt_mod

                # every option that changes the result, as the flat
                # build's fingerprint
                meta = ckpt_mod.stream_meta(
                    es, k_total, chunk_edges, weights=weights,
                    alpha=opts.get("alpha", 1.0), comm_volume=comm_volume,
                    state_format="hier", k_levels=k_levels,
                    refine=int(refine), refine_alpha=float(refine_alpha),
                    final_refine=int(final_refine), inner_backend=inner)
            final = _hier_assign(es, k_levels, refine, refine_alpha,
                                 chunk_edges, tmp_root, dict(opts),
                                 timings=timings, spill_bytes=spill_bytes,
                                 checkpointer=checkpointer, resume=resume,
                                 meta=meta, nprocs=nprocs)
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
            tag = f"{inner}:{be.device.type}+hier{k_levels}"
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
            repaired = None
            if final_refine:
                before = res.diagnostics.get("refine_cut_before")
                after = res.diagnostics.get("refine_cut_after")
                if before is not None and after is not None:
                    repaired = int(before - after)
                    res.diagnostics["final_refine_repaired"] = repaired
            timings["ledger"] = round(time.perf_counter() - t0, 3)
            obs.event(
                "quality_ledger", k=k_total,
                k_levels=[int(x) for x in k_levels],
                edge_cut=int(res.edge_cut),
                total_edges=int(res.total_edges),
                cut_ratio=round(float(res.cut_ratio), 6),
                balance=round(float(res.balance), 4),
                levels=[{kk: int(v) if kk != "cut_ratio" else v
                         for kk, v in row.items()} for row in ledger],
                final_refine_repaired=repaired,
                parts_at_capacity=acct["parts_at_capacity"],
                frozen_load_fraction=acct["frozen_load_fraction"])
            if checkpointer is not None:
                # success: the boundary state, the level-0 domain and the
                # spill root go
                checkpointer.clear(force=True)
                shutil.rmtree(os.path.join(checkpointer.dir, "level0"),
                              ignore_errors=True)
                shutil.rmtree(tmp_root, ignore_errors=True)
            return res
    finally:
        if checkpointer is None:
            # a checkpointed run that failed keeps its shards for the
            # resume
            shutil.rmtree(tmp_root, ignore_errors=True)
