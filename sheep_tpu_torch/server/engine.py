"""One served partition job as a cooperative step generator (the port's
counterpart of ``sheep_tpu/server/engine.py``).

A job is a GENERATOR over the port's ops: each ``yield`` marks one unit
of device work done (a degrees chunk, a staged build group, a scoring
chunk), and the scheduler steps the admitted jobs round-robin on its
one dispatch thread. Groups of different jobs alternate on the one
stream, each folding into its own carried table; each job's fixpoint is
the unique forest of its own constraint multiset, so the interleave
cannot change it, and no job reads another's table.

The build is the batched driver of the port's CLI build: each group of
``dispatch_batch`` padded chunks (the last filled with all-sentinel
chunks) is oriented by ``elim.orient_chunks_batch_pos`` and folded to
its fixpoint by ``elim.fold_segments_batch``, which reads one stats word
an execution; a step is one confirmed group, so nothing of a job is in
flight between its steps and the cooperative kernels of a round (the
ladder, ``stream_descent``, ``compact_live``) never see another job's
work in between. That is the CLI build at pipeline depth 1 (``--inflight
1``), execution for execution, with the same launches; the engine
always folds at that depth, and ``inflight_depth`` says so. The degree
totals are exact int64 host sums (flushed on the reference's cadence),
the order is the stable sort of their rank-clipped keys, and the split
and the scores are the port's, so a served job's forest, assignment and
scores are those of the port's CLI build and of the reference's served
job.

Faults degrade the job, not the daemon: each group folds under the
job's own :class:`~sheep_tpu_torch.utils.retry.RetryPolicy`; an
out-of-memory fault sheds the shared chunk cache and halves the job's
dispatch batch, and the group folds again from a copy of the table taken
before it (the fold updates the table in place), so the retry is
bit-identical. Read faults are absorbed by the edge stream's bounded
retry. A spent budget fails the job.

Cancellation: the scheduler closes the generator; ``GeneratorExit``
unwinds through the ``finally`` blocks below, which close the chunk
iterators (and with them the prefetch workers and the staging ring),
end the phase spans and, on CUDA, wait for the job's queued work before
its tensors are released.

Durability: a durable scheduler hands each job its own
:class:`~sheep_tpu_torch.utils.checkpoint.Checkpointer` domain. The
engine saves at chunk and group boundaries on its cadence (the
reference's phases, arrays and fingerprint) and resumes from the newest
intact step: the degree totals are exact integer sums, a build resume
folds the remaining groups into the restored table, a score resume
restores the per-k counters and the forest. A resumed job is therefore
bit-identical to an uninterrupted one. :meth:`request_checkpoint` arms
an off-cadence save at the next boundary, the graceful drain's hook.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sheep_tpu_torch import obs
from sheep_tpu_torch.backends.torch_backend import (LAUNCH_KEYS,
                                                    _device_chunk_groups,
                                                    _device_chunks,
                                                    resolve_dispatch_batch,
                                                    resolve_h2d_ring)
from sheep_tpu_torch.core import pure
from sheep_tpu_torch.io.devicestream import is_device_stream
from sheep_tpu_torch.io.edgestream import open_input
from sheep_tpu_torch.ops import compact as compact_ops
from sheep_tpu_torch.ops import degrees as degrees_ops
from sheep_tpu_torch.ops import elim as elim_ops
from sheep_tpu_torch.ops import fixpoint as fixpoint_ops
from sheep_tpu_torch.ops import gather as gather_ops
from sheep_tpu_torch.ops import lift as lift_ops
from sheep_tpu_torch.ops import order as order_ops
from sheep_tpu_torch.ops import score as score_ops
from sheep_tpu_torch.ops import split as split_ops
from sheep_tpu_torch.ops import synth as synth_ops
from sheep_tpu_torch.types import PartitionResult, check_vertex_range
from sheep_tpu_torch.utils import checkpoint as ckpt_mod
from sheep_tpu_torch.utils import retry as retry_mod

# diagnostics key -> kernel: every kernel a served job launches (the
# build's, as the CLI build counts them, and the device streams' hash)
SERVED_LAUNCH_KEYS = {**LAUNCH_KEYS, "hash_launches": "hash_chunk"}


def launch_counts() -> dict:
    """{kernel: launches so far in this process} of the served kernels."""
    out = {}
    for counter in (gather_ops.LAUNCHES, lift_ops.LAUNCHES,
                    fixpoint_ops.LAUNCHES, compact_ops.LAUNCHES,
                    synth_ops.LAUNCHES):
        out.update(counter)
    return out


class JobEngine:
    """Drives one admitted job on ``device``; see the module docstring.
    ``job`` is a :class:`sheep_tpu_torch.server.scheduler.Job`; ``cache``
    an optional shared chunk cache of this input (a ``_ChunkCache`` or a
    reader of one); ``checkpointer`` an optional per-job recovery domain,
    with ``resume`` asking for a resume from its newest intact step."""

    def __init__(self, job, device, cache=None, checkpointer=None,
                 resume: bool = False):
        self.job = job
        self.device = torch.device(device)
        self.cache = cache
        self.ckpt = checkpointer
        self.resume = bool(resume)
        # the graceful drain's handshake: request_checkpoint() arms a save
        # at the next boundary, the save sets suspend_ready, and the
        # scheduler parks the job (set under the scheduler's lock, read by
        # the dispatch thread between steps)
        self._ckpt_request = False
        self.suspend_ready = False
        # the live dispatch knobs: an out-of-memory fault halves them and
        # the staging loop restages at the new shape
        self.batch: Optional[int] = None
        self.ring: int = 1
        self._n = 0
        self._cs = 0
        self._build_idx = 0
        self._dev_stream = False
        self._out = None

    # -- durability hooks ----------------------------------------------
    def request_checkpoint(self) -> None:
        """Arm a save at the next chunk or group boundary, whatever the
        cadence: the scheduler's graceful-drain hook."""
        if self.ckpt is not None:
            self._ckpt_request = True
        else:
            self.suspend_ready = True  # nothing to save: park now

    def _due(self, done: int) -> bool:
        return self.ckpt is not None and (self.ckpt.due(done)
                                          or self._ckpt_request)

    def _save(self, phase: str, idx: int, arrays: dict, meta) -> None:
        self.ckpt.save(phase, int(idx), arrays, meta)
        stats = self.job.stats
        stats["ckpt_saves"] = stats.get("ckpt_saves", 0) + 1
        if self._ckpt_request:
            self._ckpt_request = False
            self.suspend_ready = True

    def _save_score(self, idx: int, minp_host, deg_host, cut: dict,
                    total, cv_keys: dict, rounds: int, meta) -> None:
        """A score-phase save: the per-k cut counters, the total, the
        forest and each k's comm-volume keys, compacted into the
        checkpoint and carried on compacted (the reference's arrays)."""
        arrays = {"minp": np.asarray(minp_host),
                  "deg": np.asarray(deg_host),
                  "total": np.int64(int(total)),
                  "rounds": np.int64(rounds)}
        for k, c in cut.items():
            arrays[f"cut_k{k}"] = np.int64(int(c))
            if self.job.spec.comm_volume:
                keys = score_ops.comm_volume_keys(cv_keys[k])
                arrays[f"cv_k{k}"] = keys.cpu().numpy()
                cv_keys[k] = [keys.to(self.device)]
        self._save("score", idx, arrays, meta)

    # -- fault hooks (the job degrades; the daemon goes on) --------------
    def _on_resource(self):
        # DETACH from the shared chunk cache rather than clear it in place:
        # a suspended chunk iterator may be part way through its list. The
        # cache_shed flag tells the scheduler to drop the whole entry at
        # finalize, so its memory goes with the engines' references.
        if self.cache is not None:
            self.cache = None
            self.job.cache_shed = True
        nxt = retry_mod.degrade_dispatch(
            self._n, self._cs, self.batch or 1, 1, False, self.job.stats,
            self._build_idx,
            h2d_ring=None if self._dev_stream else self.ring)
        if nxt is not None:
            self.batch = nxt[0]
            if len(nxt) > 2:
                self.ring = nxt[2]

    def _on_device_loss(self):
        # this job's tensors died with the device, so its retries usually
        # run out and it FAILS; the check lets the daemon serve the next
        # job if the device answers (a durable daemon resumes this one
        # from its last checkpoint on restart)
        retry_mod.recover_device_loss(self.job.stats, self._build_idx,
                                      device=self.device)

    def _enter_phase(self, phase: str) -> None:
        # the job's live progress: set at phase entry (the scheduler
        # confirms it from each step's yield) and recorded as an event
        self.job.phase = phase
        obs.event("job_phase", job=self.job.id, phase=phase)

    def _phase_span(self, name: str):
        tid = getattr(self.job, "trace_id", None)
        return obs.begin_detached(
            name, parent=self.job.span_id,
            **({"trace": tid} if tid else {}))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the job -----------------------------------------------------------
    def steps(self):
        """The step generator; sets ``job.results`` before it finishes.
        The launches of the served kernels during each step are this
        job's (one thread runs every step) and add up in the job's stats
        under the CLI build's keys."""
        stats = self.job.stats
        inner = self._steps()
        try:
            while True:
                before = launch_counts()
                try:
                    phase = next(inner)
                except StopIteration:
                    break
                finally:
                    after = launch_counts()
                    for key, name in SERVED_LAUNCH_KEYS.items():
                        stats[key] = stats.get(key, 0) + \
                            after[name] - before[name]
                yield phase
        finally:
            inner.close()
        self._results()

    def _steps(self):
        job = self.job
        spec = job.spec
        stats = job.stats
        dev = self.device
        stats_acc = obs.stats_accumulator()
        policy = retry_mod.RetryPolicy()
        t_phase: dict = {}
        finished = False
        with open_input(spec.input, n_vertices=spec.num_vertices) as es:
            try:
                yield from self._run(es, job, spec, stats, dev, stats_acc,
                                     policy, t_phase)
                finished = True
            finally:
                if not finished:
                    # cancelled, expired or failed: the job's queued work
                    # finishes before its tensors are released
                    self._sync()

    def _run(self, es, job, spec, stats, dev, stats_acc, policy, t_phase):
        n = es.num_vertices
        check_vertex_range(n)
        cs = es.clamp_chunk_edges(spec.chunk_edges)
        self._n, self._cs = n, cs
        # device streams (rmat-hash: ...) synthesize their chunks on the
        # card; host formats stage through the ring as in the CLI build.
        # The ring resolves before the batch, so the auto sizing counts
        # its staged blocks.
        self._dev_stream = is_device_stream(es)
        self.ring = resolve_h2d_ring(spec.h2d_ring, dev)
        self.batch = resolve_dispatch_batch(
            spec.dispatch_batch, n, cs, dev, inflight=1,
            h2d_ring=0 if self._dev_stream else self.ring)
        stats["dispatch_batch"] = self.batch
        stats["inflight_depth"] = 1
        job.n_vertices = n

        # ---- durable resume ----------------------------------------------
        meta = None
        state = None
        if self.ckpt is not None:
            # every option that changes the result is in the fingerprint;
            # a mismatch (the input changed under the journaled job)
            # raises and FAILS the job: resuming would corrupt it
            meta = ckpt_mod.stream_meta(
                es, k=int(spec.ks[0]), chunk_edges=cs, weights=spec.weights,
                alpha=spec.alpha, comm_volume=spec.comm_volume,
                ks=[int(k) for k in spec.ks],
                segment_rounds=int(spec.segment_rounds), served=1)
            state = ckpt_mod.resume_state(self.ckpt, meta, self.resume)
            if state is not None:
                stats["resume_phase_idx"] = float(
                    ckpt_mod.phase_index(state.phase))
                stats["resume_chunk_idx"] = float(state.chunk_idx)
        resume_phase = state.phase if state is not None else None

        # ---- degrees -----------------------------------------------------
        t0 = time.perf_counter()
        deg_host = np.zeros(n, dtype=np.int64)
        if resume_phase in (None, "degrees"):
            deg_start = 0
            if resume_phase == "degrees":
                deg_host = state.arrays["deg"].astype(np.int64)
                deg_start = int(state.chunk_idx)
            self._enter_phase("degrees")
            sp = self._phase_span("degrees")
            deg = degrees_ops.init_degrees(n, dev)
            flush_every = degrees_ops.flush_every_for(cs)
            since = 0
            idx = deg_start
            chunks = _device_chunks(es, cs, n, dev, self.cache, deg_start,
                                    self.ring, stats)
            try:
                for padded in chunks:
                    degrees_ops.degree_chunk(deg, padded, n)
                    since += 1
                    idx += 1
                    at_ckpt = self._due(idx - deg_start)
                    if since >= flush_every or at_ckpt:
                        # flushes are exact: integer sums are associative
                        deg_host += deg[:n].cpu().numpy()
                        deg.zero_()
                        since = 0
                    if at_ckpt:
                        self._save("degrees", idx, {"deg": deg_host}, meta)
                    stats_acc.absorb(stats)
                    yield "degrees"
            finally:
                chunks.close()
                sp.end()
            deg_host += deg[:n].cpu().numpy()
            del deg
        else:
            # a build or score resume: the finished totals ride in every
            # later phase's checkpoint
            deg_host = state.arrays["deg"].astype(np.int64)
        t_phase["degrees"] = time.perf_counter() - t0

        # ---- sort (one step; recomputed on resume: the order is a
        # function of the degree totals) -----------------------------------
        t0 = time.perf_counter()
        self._enter_phase("sort")
        sp = self._phase_span("sort")
        try:
            keys = torch.from_numpy(np.ascontiguousarray(
                degrees_ops.rank_clip_i32(deg_host))).to(dev)
            pos, order = order_ops.elimination_order(keys, n)
            del keys
            pos_host = pos[:n].cpu().numpy()
        finally:
            sp.end()
        t_phase["sort"] = time.perf_counter() - t0
        yield "sort"

        # ---- build: staged groups, each folded to its fixpoint ------------
        total_rounds = 0
        if resume_phase == "score":
            # the build finished before the save; its forest rides in the
            # score checkpoint
            minp_host = state.arrays["minp"]
            total_rounds = int(state.arrays.get("rounds", 0))
            t_phase["build"] = 0.0
        else:
            t0 = time.perf_counter()
            self._enter_phase("build")
            sp = self._phase_span("build")
            if resume_phase == "build":
                P = torch.from_numpy(np.ascontiguousarray(
                    state.arrays["p"], dtype=np.int32)).to(dev)
                self._build_idx = int(state.chunk_idx)
                total_rounds = int(state.arrays.get("rounds", 0))
            else:
                P = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
                self._build_idx = 0
            sentinel = None

            def fold(group) -> int:
                # the fold updates P and the blocks in place: a retry
                # starts again from the table as it stood and the group's
                # chunks, bit-identically
                nonlocal P
                stacked = torch.stack(group)
                snap = P.clone()
                while True:
                    try:
                        loB, hiB = elim_ops.orient_chunks_batch_pos(
                            stacked, pos, n)
                        P, rounds = elim_ops.fold_segments_batch(
                            P, loB, hiB, n,
                            segment_rounds=spec.segment_rounds, stats=stats)
                        return rounds
                    except Exception as exc:  # noqa: BLE001, classified
                        retry_mod.handle_build_fault(
                            policy, exc, f"sheepd.{job.id}.build", stats,
                            on_resource=self._on_resource,
                            on_device_loss=self._on_device_loss)
                        P = snap.clone()

            try:
                while True:
                    batch, ring = self.batch, self.ring
                    groups = _device_chunk_groups(
                        es, cs, n, dev, self.cache, self._build_idx, batch,
                        ring, stats)
                    restage = False
                    try:
                        for group in groups:
                            gl = len(group)
                            if gl < batch:
                                if sentinel is None:
                                    sentinel = torch.full(
                                        (cs, 2), n, dtype=torch.int32,
                                        device=dev)
                                group = group + [sentinel] * (batch - gl)
                            total_rounds += fold(group)
                            prev = self._build_idx
                            self._build_idx += gl
                            if self.ckpt is not None and (
                                    self.ckpt.due_span(prev,
                                                       self._build_idx)
                                    or self._ckpt_request):
                                # the confirmed table: nothing is in
                                # flight after a fold
                                self._save(
                                    "build", self._build_idx,
                                    {"p": P.cpu().numpy(), "deg": deg_host,
                                     "rounds": np.int64(total_rounds)},
                                    meta)
                            stats_acc.absorb(stats)
                            yield "build"
                            if self.batch != batch or self.ring != ring:
                                # degraded: restage the rest at the new
                                # shape (closing the supplier drains its
                                # staged blocks)
                                restage = True
                                break
                    finally:
                        groups.close()
                    if not restage:
                        break
            finally:
                sp.end(rounds=int(total_rounds))
            minp_host = P[pos.long()].cpu().numpy()
            del P
            t_phase["build"] = time.perf_counter() - t0
        stats["fixpoint_rounds"] = float(total_rounds)

        # ---- split (host, each k) -----------------------------------------
        t0 = time.perf_counter()
        self._enter_phase("split")
        sp = self._phase_span("split")
        try:
            parent = elim_ops.minp_to_parent(minp_host, order, n)
            w = deg_host.astype(np.float64) \
                if spec.weights == "degree" else None
            assigns = {k: split_ops.tree_split_host(
                parent, pos_host, k, weights=w, alpha=spec.alpha)
                for k in spec.ks}
        finally:
            sp.end()
        t_phase["split"] = time.perf_counter() - t0
        yield "split"

        # ---- score: one pass over the stream for every k ------------------
        t0 = time.perf_counter()
        self._enter_phase("score")
        sp = self._phase_span("score")
        parts = {k: torch.from_numpy(np.concatenate(
            [a.astype(np.int32), np.zeros(1, np.int32)])).to(dev)
            for k, a in assigns.items()}
        cut = {k: torch.zeros((), dtype=torch.int64, device=dev)
               for k in assigns}
        total = torch.zeros((), dtype=torch.int64, device=dev)
        cv_keys: dict = {k: [] for k in assigns}
        score_start = 0
        if resume_phase == "score":
            score_start = int(state.chunk_idx)
            total += int(state.arrays["total"])
            for k in assigns:
                cut[k] += int(state.arrays[f"cut_k{k}"])
                if spec.comm_volume:
                    cv_keys[k] = [torch.from_numpy(
                        state.arrays[f"cv_k{k}"]).to(dev)]
        elif self.ckpt is not None:
            # the build's completion is banked at score entry: a crash
            # before the first cadence save must not fold the build's
            # tail again from an older build checkpoint
            self._save_score(0, minp_host, deg_host, cut, total, cv_keys,
                             total_rounds, meta)
        idx = score_start
        chunks = _device_chunks(es, cs, n, dev, self.cache, score_start,
                                self.ring, stats)
        try:
            for padded in chunks:
                for i, (k, a) in enumerate(parts.items()):
                    c, tt = score_ops.score_chunk(padded, a, n)
                    cut[k] += c
                    if i == 0:
                        total += tt
                    if spec.comm_volume:
                        score_ops.accumulate_cv_keys(
                            cv_keys[k],
                            score_ops.cut_pair_keys(padded, a, n, k))
                idx += 1
                if self._due(idx - score_start):
                    self._save_score(idx, minp_host, deg_host, cut, total,
                                     cv_keys, total_rounds, meta)
                stats_acc.absorb(stats)
                yield "score"
        finally:
            chunks.close()
            sp.end()
        cut = {k: int(c) for k, c in cut.items()}
        total = int(total)
        cv = {k: score_ops.comm_volume(cv_keys[k]) for k in assigns} \
            if spec.comm_volume else None
        t_phase["score"] = time.perf_counter() - t0

        if spec.resident:
            # the finished build as a resident incremental state: the
            # converged table the tenant streams delta epochs at, its
            # score cache seeded from this full scoring pass, so the
            # first scored epoch is O(delta) too
            from sheep_tpu_torch import incremental as inc_mod

            job.incremental_state = inc_mod.state_from_build(
                es, spec.ks, spec.weights, spec.alpha, cs, "sheepd",
                pos_host, deg_host, minp_host, total, base_spec=spec.input)
            inc_mod._seed_score_cache(
                job.incremental_state, assigns,
                {k: (cut[k], total) for k in spec.ks})
        self._out = (assigns, cut, total, cv, deg_host, t_phase)

    def _results(self) -> None:
        job = self.job
        spec = job.spec
        assigns, cut, total, cv, deg_host, t_phase = self._out
        results = []
        for k in spec.ks:
            bal = pure.part_balance(
                assigns[k], k,
                deg_host if spec.weights == "degree" else None)
            results.append(PartitionResult(
                assignment=assigns[k], k=k, edge_cut=cut[k],
                total_edges=total, cut_ratio=cut[k] / max(total, 1),
                balance=bal, comm_volume=None if cv is None else cv[k],
                phase_times=dict(t_phase), backend="sheepd",
                diagnostics={kk: (round(float(v), 3)
                                  if str(kk).startswith("t_")
                                  or str(kk).endswith("_ms")
                                  else float(v))
                             for kk, v in job.stats.items()
                             if isinstance(v, (int, float))}))
        for r in results:
            # the job's final scores, in the trace and its flight ring the
            # moment they exist
            obs.event("job_quality", job=job.id, k=int(r.k),
                      cut_ratio=round(float(r.cut_ratio), 6),
                      balance=round(float(r.balance), 4),
                      edge_cut=int(r.edge_cut))
        job.results = results
