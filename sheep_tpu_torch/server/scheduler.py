"""Multi-tenant job queue, admission and the interleaving dispatch loop
(the port's counterpart of ``sheep_tpu/server/scheduler.py``).

The scheduler owns every job from submit to terminal state:

**Admission.** Each job's device footprint is modeled up front with the
model the backends size their dispatch batch by
(``utils/membudget.build_phase_bytes`` at the job's resolved batch),
against the daemon's budget: an explicit ``budget_bytes``, else
``SHEEP_CACHE_BYTES``, else 0.9 of the card's memory
(``device_memory_bytes``); on the CPU there is no budget unless
``SHEEP_CACHE_BYTES`` is set. A job over the whole budget is first shed
down the halving an out-of-memory fault would force
(``membudget.degraded_dispatch``), then admitted spilled (every knob at
1, no shared chunk cache), and REJECTED only when even that floor does
not fit; a job that fits the budget but not the headroom stays QUEUED
until earlier jobs release their reservation.

**Interleave.** Admitted jobs step round-robin on one thread, the only
thread that touches a tensor: each step is one unit of device work of a
:class:`~sheep_tpu_torch.server.engine.JobEngine`, so groups of
different jobs alternate on the one stream, each folding into its own
table (interleaved == solo, bit for bit). Handler threads only take the
lock and read host state.

**Warm state.** The port has no jit; what a cold daemon pays for once
is building and loading the native libraries of ``ops/_build.py``.
``jit_compiles`` keeps its name on the wire and counts the libraries
that were compiled or loaded (``_build.COUNTS``) while the job's steps
ran, so a warm repeat request reports 0.

**Deadlines and cancellation.** Both cut a job between steps: its step
generator is closed (the engine's ``finally`` blocks stop its prefetch
workers, end its spans and wait for its queued work) and only that job
changes state.

**Durability.** With a journal (:mod:`sheep_tpu_torch.server.journal`)
every job is write-ahead logged from submit to terminal and gets a
per-job :class:`~sheep_tpu_torch.utils.checkpoint.Checkpointer` domain
under ``checkpoint_dir``; the constructor replays the journal of the
prior incarnation, queued jobs queue again and running ones resume from
their checkpoints, bit-identically. ``reattach_or_submit`` makes a
retried submit idempotent by spec digest; ``shutdown_suspend`` is the
graceful drain. A resident job's delta epochs fold through the port's
own backends (``update_backend``: ``torch``, ``torch-sharded`` or
``torch-bigv``) on the dispatch thread.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import torch

from sheep_tpu_torch import obs
from sheep_tpu_torch.device import resolve_device
from sheep_tpu_torch.obs.flightrec import FlightRecorder
from sheep_tpu_torch.obs.metrics import MetricRegistry
from sheep_tpu_torch.server import journal as journal_mod
from sheep_tpu_torch.server import protocol
from sheep_tpu_torch.server.engine import JobEngine
from sheep_tpu_torch.server.protocol import (CANCELLED, DEADLINE_EXCEEDED,
                                             DONE, FAILED, QUEUED, REJECTED,
                                             RUNNING, TERMINAL_STATES,
                                             JobSpec)


def compile_cache_sizes() -> dict:
    """{"built": n, "loaded": n}: the native libraries this process has
    compiled and loaded (``ops/_build.py``), the warm-state evidence a
    repeat job adds nothing to."""
    from sheep_tpu_torch.ops import _build

    return dict(_build.COUNTS)


def resolve_budget_bytes(budget_bytes: Optional[int] = None,
                         device="cpu") -> Optional[int]:
    """The daemon's admission budget: an explicit value wins, then
    ``SHEEP_CACHE_BYTES`` (0 there means no chunk cache, not an
    unlimited admission, so it falls through), then 0.9 of the card's
    memory on CUDA; None = unlimited (the CPU, where device memory is the
    host's and the model would gate nothing real)."""
    if budget_bytes is not None:
        return int(budget_bytes) if budget_bytes > 0 else None
    env = os.environ.get("SHEEP_CACHE_BYTES")
    if env is not None:
        try:
            val = int(env)
        except ValueError:
            val = 0
        if val > 0:
            return val
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from sheep_tpu_torch.backends.torch_backend import device_memory_bytes

    return int(0.9 * device_memory_bytes(device))


class Job:
    """One submitted job: spec + lifecycle + results. State transitions
    happen only under the scheduler's lock."""

    def __init__(self, job_id: str, spec: JobSpec, n_vertices: int,
                 modeled_bytes: Optional[int]):
        self.id = job_id
        self.spec = spec
        self.state = QUEUED
        self.error: Optional[str] = None
        self.submit_t = time.time()
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None
        self.deadline_t = None if spec.deadline_s is None \
            else self.submit_t + spec.deadline_s
        self.n_vertices = n_vertices
        self.modeled_bytes = modeled_bytes
        self.stats: dict = {}
        self.results: Optional[list] = None
        self.gen = None           # the engine step generator, once running
        self.span = None          # detached obs span for the job tree
        self.span_id = None
        # propagated wire trace context: the client-minted
        # 32-hex trace id + the client's 16-hex parent span id. The
        # job span starts with these as remote_parent attrs and the
        # flight ring learns the trace id, so one trace id correlates
        # this replica's spans/dumps with the client's route spans.
        self.trace_id: Optional[str] = None
        self.trace_parent: Optional[str] = None
        self.cancel_requested = False
        self.steps = 0
        # live phase name (degrees/sort/build/split/score): written by
        # the engine at phase entry and confirmed by the scheduler from
        # the step generator's yield values — the per-job progress
        # signal `sheep-submit --watch` and the job gauges poll
        self.phase: Optional[str] = None
        # per-step compile-cache delta sum (None until started): the
        # dispatch thread serializes steps, so attributing each step's
        # global cache growth to the job that ran it is EXACT even
        # under interleaving — a finalize-time delta would blame one
        # job for every concurrent job's compiles
        self.jit_compiles: Optional[int] = None
        # the engine shed the shared chunk cache under memory pressure;
        # the scheduler drops the cache entry at finalize so its memory is
        # released and future jobs start a fresh cache
        self.cache_shed = False
        # admitted in spilled mode: over the budget at every
        # dispatch shape, so it runs at the irreducible floor — no
        # shared chunk cache lease, every overlap knob at 1
        self.spilled = False
        # ---- durability -----------------------------------
        # deterministic submit identity (spec + input content), the
        # reattach key; journaled at submit
        self.digest: Optional[str] = None
        # per-job Checkpointer domain + the live engine (the graceful
        # drain's request_checkpoint handle), set at start
        self.ckpt = None
        self.engine = None
        # True once a graceful drain parked this job with its state on
        # disk (non-terminal: the journal replays it as resumable)
        self.suspended = False
        # a job replayed as terminal from the journal carries result
        # SUMMARIES only (assignment arrays are not journaled)
        self.replayed_results: Optional[list] = None
        # ---- resident partition ---------------------------
        # the engine parks the finished build's incremental state here
        # (spec.resident only); finalize adopts it as resident_state,
        # which update/epoch/compact verbs then mutate on the dispatch
        # thread. A restarted daemon reloads it lazily from the
        # resident-state snapshot; journaled_epoch is the journal's
        # floor for the resumed epoch.
        self.incremental_state = None
        self.resident_state = None
        self.resident_released = False
        self.journaled_epoch = 0
        self._upd_backend = None

    def journal_spec(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self.spec)

    def descriptor(self, with_results: bool = False) -> dict:
        d = {"job_id": self.id, "tenant": self.spec.tenant,
             "input": self.spec.input, "k": list(self.spec.ks),
             "state": self.state, "submit_t": round(self.submit_t, 3),
             "n_vertices": int(self.n_vertices),
             "modeled_bytes": self.modeled_bytes, "steps": self.steps}
        if self.phase is not None:
            d["phase"] = self.phase
        if self.error is not None:
            d["error"] = self.error
        if self.deadline_t is not None:
            d["deadline_t"] = round(self.deadline_t, 3)
        if self.start_t is not None:
            d["start_t"] = round(self.start_t, 3)
        if self.end_t is not None:
            d["end_t"] = round(self.end_t, 3)
            base = self.start_t if self.start_t is not None \
                else self.submit_t
            d["wall_s"] = round(self.end_t - base, 4)
        if self.jit_compiles is not None:
            d["jit_compiles"] = self.jit_compiles
        if self.spec.resident:
            d["resident"] = not self.resident_released
            st = self.resident_state
            d["epoch"] = int(st.epoch) if st is not None \
                else int(self.journaled_epoch)
        if self.state == DONE and self.results is not None:
            d["results"] = []
            for r in self.results:
                row = r.summary()
                if with_results and self.spec.return_assignment:
                    row["assignment"] = protocol.encode_assignment(
                        r.assignment)
                d["results"].append(row)
        elif self.state == DONE and self.replayed_results is not None:
            # journal-replayed completion: scores survive the restart,
            # assignment payloads do not (use job.output for those)
            d["results"] = [dict(row) for row in self.replayed_results]
        return d


class Scheduler:
    """See module docstring. Thread model: any number of submitter
    threads (the daemon's connection handlers) call submit/cancel/wait;
    ONE dispatch thread calls :meth:`run`. All shared state is guarded
    by ``self._lock`` (the condition's lock). ``device`` is where the
    jobs run: CUDA unless the caller passes ``"cpu"`` (None needs a
    GPU and raises without one). The constructor installs no signal
    handler; the daemon's ``main`` does."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 root_span_id=None, journal=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 16, result_store=None,
                 device=None):
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.budget = resolve_budget_bytes(budget_bytes, self.device)
        self.root_span_id = root_span_id
        self._jobs: "OrderedDict[str, Job]" = OrderedDict()
        self._pending: deque = deque()
        self._active: deque = deque()   # admitted; round-robin order
        self._ids = itertools.count(1)
        self._stop = False
        self._draining = False
        # resident-partition work items (update/epoch/compact verbs):
        # handler threads enqueue + wait, the ONE dispatch
        # thread executes — delta folds share the dispatch chain with
        # job steps, never a second thread on the device
        self._updates: deque = deque()
        # ---- durability: crash-safe journal + per-job
        # checkpoint domains. journal is a JobJournal or a path; with
        # one set, every job is journaled submit->terminal and the
        # constructor REPLAYS the prior incarnation's journal:
        # journaled queued jobs re-enter the queue, journaled running
        # jobs re-enter it flagged resumable (their engines resume
        # from the per-job checkpoints under checkpoint_dir), and
        # terminal jobs stay queryable with their journaled scores.
        self.journal = None
        self.ckpt_dir = checkpoint_dir
        self.ckpt_every = max(1, int(checkpoint_every))
        self._suspending = False
        self._suspend_deadline = 0.0
        self._restarts = 0
        self._caches: "OrderedDict[tuple, dict]" = OrderedDict()
        # ---- fleet warm path: content-addressed result
        # store. A repeat submit whose digest hits answers DONE at
        # admission — zero dispatch steps, zero recompiles, the exact
        # packed assignment the original build produced. Accepts a
        # ResultStore or a directory path.
        if isinstance(result_store, str):
            from sheep_tpu_torch.server.resultstore import ResultStore

            result_store = ResultStore(result_store)
        self.result_store = result_store
        self._rc_evictions_seen = 0
        self.totals = {"submitted": 0, "done": 0, "failed": 0,
                       "cancelled": 0, "rejected": 0,
                       "deadline_exceeded": 0}
        self.started_t = time.time()
        # ---- live telemetry plane -------------------------
        # Typed metric registry: the `metrics` verb and the daemon's
        # HTTP /metrics listener render this; the collector absorbs
        # queue/reservation/cache state, per-active-job progress, the
        # active tracer's CounterRegistry and device memory as live
        # gauges at scrape time.
        self.metrics = MetricRegistry()
        self._m_submitted = self.metrics.counter(
            "sheepd_jobs_submitted_total",
            "jobs accepted at the protocol boundary", ("tenant",))
        self._m_terminal = self.metrics.counter(
            "sheepd_jobs_terminal_total",
            "jobs reaching a terminal state", ("tenant", "state"))
        self._m_rejected = self.metrics.counter(
            "sheepd_admission_rejected_total",
            "jobs the admission budget rejected outright", ("tenant",))
        self._m_retries = self.metrics.counter(
            "sheepd_dispatch_retries_total",
            "dispatch retries absorbed inside served jobs", ("tenant",))
        self._m_steps = self.metrics.counter(
            "sheepd_steps_total",
            "dispatch steps executed (one staged group of device work)",
            ("tenant",))
        self._m_latency = self.metrics.histogram(
            "sheepd_request_latency_seconds",
            "queued->done request latency (the SLO series)", ("tenant",))
        self._m_queue_wait = self.metrics.histogram(
            "sheepd_queue_wait_seconds",
            "submit->start admission wait", ("tenant",))
        self._m_step_s = self.metrics.histogram(
            "sheepd_step_seconds", "one dispatch step", ("phase",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        # ---- durability plane: restart visibility --------
        self._m_restarts = self.metrics.counter(
            "sheepd_restarts_total",
            "daemon restarts observed in this journal lineage "
            "(prior daemon_start records at replay)")
        self._m_resumed = self.metrics.counter(
            "sheepd_jobs_resumed_total",
            "journaled RUNNING jobs re-admitted at startup to resume "
            "from their checkpoints")
        self._m_reattached = self.metrics.counter(
            "sheepd_submits_reattached_total",
            "idempotent resubmissions matched to an existing job by "
            "digest", ("tenant",))
        # ---- fleet plane: result-cache visibility --------
        self._m_rc_hits = self.metrics.counter(
            "sheepd_result_cache_hits_total",
            "submits answered from the content-addressed result store "
            "(zero build steps, zero recompiles)", ("tenant",))
        self._m_rc_misses = self.metrics.counter(
            "sheepd_result_cache_misses_total",
            "submits that probed the result store and built", ("tenant",))
        self._m_rc_evictions = self.metrics.counter(
            "sheepd_result_cache_evictions_total",
            "result-store entries evicted oldest-first under the "
            "byte cap")
        # ---- incremental plane: resident partitions ------
        self._m_updates = self.metrics.counter(
            "sheep_updates_total",
            "delta epochs applied to resident partitions", ("tenant",))
        self._m_update_latency = self.metrics.histogram(
            "sheep_update_latency_seconds",
            "one update verb: fold + (optional) refresh wall",
            ("tenant",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        self._m_compactions = self.metrics.counter(
            "sheep_compactions_total",
            "resident-partition compactions (tombstone repair)",
            ("tenant", "mode"))
        # ---- O(delta) plane: streamed epochs + fairness --
        self._m_update_throttled = self.metrics.counter(
            "sheepd_update_throttled_total",
            "update items deferred to a later dispatch cycle by the "
            "per-tenant byte budget", ("tenant",))
        self._m_update_score = self.metrics.histogram(
            "sheepd_update_score_seconds",
            "scored-refresh wall per update epoch (incremental "
            "rescoring makes this O(delta), not O(edges))",
            ("tenant",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        # ---- quality plane: partition QUALITY is a live,
        # scrapeable series, not just a number in a result payload —
        # per-tenant cut/balance distributions at DONE, plus per-job
        # gauges for recent results via the collector below, so a
        # fleet dashboard catches "this tenant's cuts got worse" the
        # same way it catches latency regressions.
        from sheep_tpu_torch.obs.metrics import (DEFAULT_BALANCE_BUCKETS,
                                           DEFAULT_RATIO_BUCKETS)

        self._m_quality_cut = self.metrics.histogram(
            "sheep_quality_cut_ratio",
            "final cut ratio of DONE jobs, one observation per "
            "result k", ("tenant",), buckets=DEFAULT_RATIO_BUCKETS)
        self._m_quality_balance = self.metrics.histogram(
            "sheep_quality_balance",
            "final balance of DONE jobs, one observation per result k",
            ("tenant",), buckets=DEFAULT_BALANCE_BUCKETS)
        # ---- fleet observability plane: the SLO layer's
        # missing denominator — every answered wire request by verb
        # and outcome (tools/slo_check.py divides error outcomes by
        # the total for the error-rate bound)
        self._m_requests = self.metrics.counter(
            "sheepd_requests_total",
            "wire requests answered, by verb and outcome (ok|error)",
            ("verb", "outcome"))
        self.metrics.add_collector(self._collect_live_gauges)
        # Always-on flight recorder: bounded per-job rings fed by
        # obs.event, dumped on job failure / fault injection / shutdown
        # — post-mortem forensics without full tracing on every request
        self.flight = obs.install_flight(FlightRecorder())
        # on-demand torch.profiler capture state (the `profile` verb):
        # armed under the lock, driven by the dispatch thread only
        self._profile: Optional[dict] = None
        self._profiler = None
        self.last_profile: Optional[dict] = None
        if journal is not None:
            self._recover(journal)

    # ------------------------------------------------------------------
    # durability: journal replay at startup
    # ------------------------------------------------------------------
    def _recover(self, journal) -> None:
        """Open (or adopt) the journal, replay the prior incarnation's
        records, and re-seed the queue: queued jobs re-admit as
        submitted, running jobs re-admit flagged resumable (their
        engines resume from the per-job checkpoints), terminal jobs
        stay queryable with journaled scores. Runs in the constructor
        — before any handler thread exists; the lock is uncontended
        but keeps every shared-state mutation lexically guarded."""
        with self._lock:
            if isinstance(journal, str):
                journal = journal_mod.JobJournal(journal)
            self.journal = journal
            replay = journal.replay()
            self._restarts = replay.daemon_starts
            resumed = 0
            for rj in replay.jobs:
                try:
                    spec = JobSpec(
                        **{k: v for k, v in rj.spec.items()
                           if k in JobSpec.__dataclass_fields__})
                except (TypeError, ValueError) as e:
                    journal_mod._warn(
                        f"journaled spec of {rj.job_id} does not "
                        f"reconstruct ({type(e).__name__}: {e}); "
                        f"dropped")
                    continue
                job = Job(rj.job_id, spec, rj.n_vertices,
                          rj.modeled_bytes)
                job.digest = rj.digest
                job.submit_t = rj.submit_t
                # resident lineage: the journal's epoch
                # floor; the state snapshot (>= this epoch — it is
                # saved BEFORE the journal record) loads lazily on
                # the first update/epoch/compact touch
                job.journaled_epoch = rj.delta_epoch
                job.resident_released = rj.resident_released
                job.deadline_t = None if spec.deadline_s is None \
                    else rj.submit_t + spec.deadline_s
                self._jobs[job.id] = job
                self.totals["submitted"] += 1
                if rj.terminal:
                    job.state = rj.state
                    job.error = rj.error
                    job.end_t = rj.end_t
                    job.replayed_results = rj.results
                    self.totals[rj.state] = \
                        self.totals.get(rj.state, 0) + 1
                else:
                    # both queued and running replay into the queue; a
                    # running job's per-job checkpoint dir makes its
                    # restart a RESUME, not a rebuild (and a running
                    # job that never checkpointed degrades to a clean
                    # start — the graceful fallback, never a loss of
                    # the job)
                    job.state = QUEUED
                    self._pending.append(job)
                    if rj.state == RUNNING:
                        resumed += 1
                        job.stats["journal_resumed"] = 1
                obs.event("job_recovered", job=job.id,
                          tenant=spec.tenant, state=job.state,
                          journaled_state=rj.state)
            if replay.jobs or replay.daemon_starts:
                import sys

                print(f"sheepd: journal replayed {len(replay.jobs)} "
                      f"job(s) ({len(self._pending)} re-admitted, "
                      f"{resumed} resumable) after "
                      f"{replay.daemon_starts} prior start(s)",
                      file=sys.stderr, flush=True)
            self._ids = itertools.count(replay.next_id)
            if replay.daemon_starts:
                self._m_restarts.inc(replay.daemon_starts)
            if resumed:
                self._m_resumed.inc(resumed)
            journal.append({"rec": "daemon_start", "t": time.time(),
                            "pid": os.getpid()}, fsync=True)

    # ------------------------------------------------------------------
    # submit-side API (connection handler threads)
    # ------------------------------------------------------------------
    def submit(self, spec: JobSpec, digest: Optional[str] = None,
               trace=None) -> Job:
        """Validate + model + enqueue. Raises ProtocolError on inputs
        that cannot be opened (answered ok=false; no job is created) —
        admission-budget verdicts come back as a REJECTED job instead,
        so they are queryable like any other terminal state. ``digest``
        lets reattach_or_submit hand over the identity it already
        computed (and matched against) instead of hashing twice.
        ``trace`` is the request's parsed wire trace context — a
        ``(trace_id, parent_span)`` pair — threaded into
        the job span and flight ring."""
        if digest is None:
            digest = journal_mod.job_digest(spec)
        n = self._probe_num_vertices(spec)
        modeled, batch, rejected_why, spilled = self._model(spec, n)
        hit = None
        if self.result_store is not None and not spec.resident:
            # fleet warm path: a digest hit answers DONE
            # from the store before admission ever reserves device
            # memory. Resident jobs never consult the store — their
            # value is the carried incremental state, which a cached
            # answer lacks. The read happens OFF-lock (file IO).
            try:
                hit = self.result_store.get(digest)
            except ValueError as e:
                # strict IO policy: a damaged entry refuses to serve —
                # this submit fails loudly instead of silently
                # rebuilding (quarantine policy reports a miss instead)
                raise protocol.ProtocolError(str(e)) from None
        with self._lock:
            if self._stop or self._draining or self._suspending:
                raise protocol.ProtocolError("daemon is shutting down")
            job = Job(f"j{next(self._ids)}", spec, n, modeled)
            job.digest = digest
            if trace is not None:
                job.trace_id, job.trace_parent = trace
                self.flight.set_trace(job.id, job.trace_id)
            # the admission pre-shed: run at the degraded batch that
            # fits (the same knob an OOM would halve mid-run)
            if batch is not None and batch != spec.dispatch_batch:
                job.spec.dispatch_batch = batch
                job.stats["admission_dispatch_batch"] = batch
            if spilled:
                # over-budget job admitted in spilled mode:
                # every overlap knob pinned to 1 and NO shared chunk
                # cache lease — the floor the admission model priced
                job.spec.dispatch_batch = 1
                job.spec.inflight = 1
                job.spec.h2d_ring = 1
                job.spilled = True
                job.stats["admission_spilled"] = 1
            self._jobs[job.id] = job
            self.totals["submitted"] += 1
            self._m_submitted.inc(tenant=spec.tenant)
            if hit is not None:
                pass  # served from the store after the submit WAL below
            elif rejected_why is not None:
                job.state = REJECTED
                job.error = rejected_why
                job.end_t = time.time()
                self.totals["rejected"] += 1
                self._m_rejected.inc(tenant=spec.tenant)
                self._m_terminal.inc(tenant=spec.tenant, state=REJECTED)
            else:
                if self.result_store is not None and not spec.resident:
                    self._m_rc_misses.inc(tenant=spec.tenant)
                self._pending.append(job)
            if self.journal is not None:
                # the WAL's admission promise: once the client holds
                # this job id, a crash cannot lose the job (fsync'd
                # BEFORE the response leaves; the pre-shed spec is
                # journaled so the replayed run models identically)
                self.journal.append(
                    {"rec": "submit", "job_id": job.id,
                     "t": job.submit_t, "tenant": spec.tenant,
                     "digest": digest, "n_vertices": int(n),
                     "modeled_bytes": modeled, "state": job.state,
                     **({"error": job.error} if job.error else {}),
                     "spec": job.journal_spec()}, fsync=True)
            obs.event("job_submit", job=job.id, tenant=spec.tenant,
                      input=spec.input, k=list(spec.ks), state=job.state,
                      modeled_bytes=modeled,
                      **({"trace": job.trace_id}
                         if job.trace_id else {}))
            if hit is not None:
                self._serve_from_store_locked(job, hit)
            self._cond.notify_all()
            return job

    def _serve_from_store_locked(self, job: Job, entry: dict) -> None:
        """Adopt a result-store hit as this job's DONE terminal:
        reconstruct the PartitionResult rows from the
        stored summaries + packed assignments (bit-identical — the
        store kept the exact payload the original build answered),
        then run the normal finalize: terminal WAL, output write,
        quality series, retention. Zero dispatch steps and zero jit
        compiles by construction — the job never enters the queue."""
        from sheep_tpu_torch.types import PartitionResult

        results = []
        for row in entry.get("results") or []:
            results.append(PartitionResult(
                assignment=protocol.decode_assignment(row["assignment"]),
                k=int(row["k"]), edge_cut=int(row["edge_cut"]),
                total_edges=int(row["total_edges"]),
                cut_ratio=float(row["cut_ratio"]),
                balance=float(row["balance"]),
                comm_volume=row.get("comm_volume"),
                phase_times=dict(row.get("phase_times") or {}),
                backend=str(row.get("backend", "sheepd")),
                diagnostics=dict(row.get("diagnostics") or {})))
        job.results = results
        job.jit_compiles = 0
        job.stats["result_cache_hit"] = 1
        self._m_rc_hits.inc(tenant=job.spec.tenant)
        obs.event("result_cache_hit", job=job.id,
                  tenant=job.spec.tenant, digest=job.digest,
                  **({"trace": job.trace_id} if job.trace_id else {}))
        self._finalize_locked(job, DONE)

    def reattach_or_submit(self, spec: JobSpec, trace=None):
        """Idempotent resubmission: match the spec's digest
        against existing jobs and return ``(job, True)`` for a live or
        completed twin instead of double-building — the contract a
        client's retried submit leans on across a daemon restart. A
        failed/cancelled/rejected twin does NOT match (retrying those
        is exactly what a fresh submit is for). The check-then-submit
        window is unlocked (submit probes the input off-lock), so two
        simultaneous first-time reattach submits may both build — the
        retried-client scenario this exists for is serial.

        A matched twin with no trace of its own ADOPTS the retried
        request's trace context: a failover resubmit that
        reattaches to a journal-replayed job still names the fleet
        request in that replica's trace and flight dumps."""
        digest = journal_mod.job_digest(spec)
        with self._lock:
            for job in reversed(self._jobs.values()):
                if job.digest == digest \
                        and job.state in (QUEUED, RUNNING, DONE):
                    if trace is not None and job.trace_id is None:
                        job.trace_id, job.trace_parent = trace
                        self.flight.set_trace(job.id, job.trace_id)
                        if job.span is not None:
                            job.span.annotate(
                                trace=job.trace_id,
                                **({"remote_parent": job.trace_parent}
                                   if job.trace_parent else {}))
                    self._m_reattached.inc(tenant=spec.tenant)
                    obs.event("job_reattach", job=job.id,
                              tenant=spec.tenant, state=job.state,
                              **({"trace": job.trace_id}
                                 if job.trace_id else {}))
                    return job, True
        return self.submit(spec, digest=digest, trace=trace), False

    def record_request(self, verb: str, outcome: str) -> None:
        """Tally one answered wire request into
        ``sheepd_requests_total{verb,outcome}`` — the
        error-rate numerator/denominator the SLO gate reads. Called by
        the daemon's connection handlers; label values are free-form
        but bounded in practice (verb comes from protocol.OPS or
        "malformed", outcome is ok|error)."""
        self._m_requests.inc(verb=str(verb), outcome=str(outcome))

    def _probe_num_vertices(self, spec: JobSpec) -> int:
        from sheep_tpu_torch.io.edgestream import open_input

        try:
            with open_input(spec.input,
                            n_vertices=spec.num_vertices) as es:
                return int(es.num_vertices)
        except Exception as e:
            raise protocol.ProtocolError(
                f"cannot open job input {spec.input!r}: "
                f"{type(e).__name__}: {str(e)[:200]}") from None

    def _model(self, spec: JobSpec, n: int):
        """(modeled_bytes, pre-shed dispatch_batch or None, reject
        reason or None, spilled bool) for admission. Models at the
        REQUESTED chunk size (clamping only shrinks it —
        conservative), with the same staged-H2D-ring term the engine
        will actually run: device-stream inputs stage
        nothing, host-format ones hold ring x batch blocks on the card —
        reserving without that term would admit jobs whose real
        footprint exceeds the budget and re-create the OOM churn
        admission exists to prevent.

        Spilled-mode admission: a job the halving ladder
        cannot fit even at dispatch_batch=1 is admitted at the
        IRREDUCIBLE floor — batch=1, inflight=1, ring depth 1, zero
        resident chunk bytes (the engine runs without the shared chunk
        cache; every pass streams from disk) — instead of rejected.
        The build is bit-identical at any dispatch shape (the fixpoint
        invariant), so spilled mode trades only wall time for
        admission. Rejection remains only for jobs whose floor itself
        exceeds the budget."""
        from sheep_tpu_torch.backends.torch_backend import (
            resolve_dispatch_batch, resolve_h2d_ring)
        from sheep_tpu_torch.io.devicestream import is_device_stream
        from sheep_tpu_torch.io.edgestream import open_input
        from sheep_tpu_torch.utils import membudget

        cs = spec.chunk_edges
        try:
            with open_input(spec.input,
                            n_vertices=spec.num_vertices) as es:
                dev_stream = is_device_stream(es)
        except Exception:
            dev_stream = False  # _probe_num_vertices already rejected
        ring = 0 if dev_stream else resolve_h2d_ring(spec.h2d_ring,
                                                     self.device)
        # the engine folds each group before it issues the next
        # (depth 1), so one execution's blocks are live at a time
        infl = 1
        batch = resolve_dispatch_batch(spec.dispatch_batch, n, cs,
                                       self.device, inflight=infl,
                                       h2d_ring=ring)
        if self.budget is None:
            return None, None, None, False

        def total(b):
            return membudget.build_phase_bytes(
                n, cs, dispatch_batch=b, inflight=infl,
                h2d_ring=ring)["total_bytes"]

        m = total(batch)
        shed = None
        while m > self.budget:
            nxt = membudget.degraded_dispatch(n, cs, batch, 1)
            if nxt is None:
                # spilled mode: the irreducible footprint — every
                # overlap knob at 1, nothing resident (resident_bytes
                # names the term it zeroes: the job runs cache-less,
                # streaming each pass from the disk tier)
                floor = membudget.build_phase_bytes(
                    n, cs, dispatch_batch=1, inflight=1,
                    h2d_ring=min(1, ring),
                    resident_bytes=0)["total_bytes"]
                if floor <= self.budget:
                    return floor, 1, None, True
                return m, None, (
                    f"modeled device footprint {m:,} bytes exceeds the "
                    f"admission budget {self.budget:,} even spilled "
                    f"(floor {floor:,} at dispatch_batch=1, inflight=1 "
                    f"with nothing resident; V={n:,}, "
                    f"chunk_edges={cs:,}); shrink the graph/chunk or "
                    f"raise the budget"), False
            batch = nxt[0]
            shed = batch
            m = total(batch)
        return m, shed, None, False

    @staticmethod
    def _is_resident(job: Job) -> bool:
        """A DONE resident job whose partition is still held — its
        modeled bytes stay charged to the admission budget (the
        resident state re-enters device memory on every update fold),
        until the tenant releases it via cancel."""
        return (job.spec.resident and job.state == DONE
                and not job.resident_released)

    def _reserved_locked(self) -> int:
        with self._lock:
            active = sum(j.modeled_bytes or 0 for j in self._active)
            resident = sum(j.modeled_bytes or 0
                           for j in self._jobs.values()
                           if self._is_resident(j))
            return active + resident

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, job_id: str) -> Optional[str]:
        """Request cancellation; returns the job's (possibly already
        terminal) state, or None for an unknown id. A queued job is
        finalized immediately — cancellation FREES THE QUEUE without
        waiting for a dispatch cycle. A RUNNING job's cancel is
        asynchronous (the returned state is still ``running``): the
        dispatch loop finalizes it before its next step — observe the
        terminal state with :meth:`wait`."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job.state in TERMINAL_STATES:
                if self._is_resident(job):
                    # cancel on a DONE resident job RELEASES the
                    # residency: reservation freed, state dropped,
                    # snapshot removed, release journaled (replay
                    # must not re-charge the budget)
                    job.resident_released = True
                    job.resident_state = None
                    job.incremental_state = None
                    path = self._resident_path(job.id)
                    if path is not None:
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                    if self.journal is not None:
                        self.journal.append(
                            {"rec": "resident_release",
                             "job_id": job.id, "t": time.time()},
                            fsync=True)
                    obs.event("resident_release", job=job.id,
                              tenant=job.spec.tenant)
                    self._cond.notify_all()
                return job.state
            if job.state == QUEUED:
                try:
                    self._pending.remove(job)
                except ValueError:
                    pass
                self._finalize_locked(job, CANCELLED)
            else:
                job.cancel_requested = True
                self._cond.notify_all()
            return job.state

    def wait(self, job_id: str, timeout_s: Optional[float] = None):
        """Block until the job is terminal (or timeout); returns the
        Job, or None for an unknown id."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._lock:
            while True:
                job = self._jobs.get(job_id)
                if job is None or job.state in TERMINAL_STATES:
                    return job
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return job
                self._cond.wait(timeout=0.1 if remaining is None
                                else min(0.1, remaining))

    def stats(self) -> dict:
        with self._lock:
            by_state: dict = {}
            for job in self._jobs.values():
                by_state[job.state] = by_state.get(job.state, 0) + 1
            reserved = self._reserved_locked()
            resident = sum(1 for j in self._jobs.values()
                           if self._is_resident(j))
            return {
                "uptime_s": round(time.time() - self.started_t, 1),
                "budget_bytes": self.budget,
                "reserved_bytes": reserved,
                "resident_partitions": resident,
                "durable": self.journal is not None,
                "restarts": self._restarts,
                "jobs": dict(self.totals),
                "jobs_by_state": by_state,
                "queued": len(self._pending),
                "active": len(self._active),
                "compile_cache": compile_cache_sizes(),
                "chunk_caches": len(self._caches),
                "flight_dumps": self.flight.dumps,
                # a COPY, internals stripped: the live dict is mutated
                # by the dispatch thread while a handler serializes
                "profile": (None if (self._profile or self.last_profile)
                            is None else
                            {k: v for k, v in
                             (self._profile
                              or self.last_profile).items()
                             if k != "remaining"}),
            }

    def shutdown(self, drain: bool = False) -> None:
        """Stop the dispatch loop. ``drain`` finishes the jobs already
        accepted first; otherwise every non-terminal job is cancelled
        on the next cycle (their spans close — a clean shutdown leaves
        ZERO unclosed spans)."""
        with self._lock:
            if drain:
                self._draining = True
            else:
                self._stop = True
            self._cond.notify_all()

    def shutdown_suspend(self, grace_s: float = 10.0) -> None:
        """Graceful drain: stop
        admitting, checkpoint each running job at its next flush
        barrier, journal the handoff, then let :meth:`run` return —
        running jobs stay NON-terminal (journal state ``running``), so
        the next incarnation resumes them where they parked. Queued
        jobs stay queued. Falls back to plain cancel-shutdown when the
        scheduler is not durable (nothing could resume them)."""
        with self._lock:
            if self.journal is None:
                self._stop = True
            elif not self._suspending:
                self._suspending = True
                self._suspend_deadline = \
                    time.monotonic() + max(0.0, float(grace_s))
                obs.event("daemon_suspend_begin",
                          grace_s=float(grace_s),
                          active=len(self._active),
                          queued=len(self._pending))
            self._cond.notify_all()

    def _park_locked(self, job: Job) -> None:
        """Suspend one running job with its state on disk: out of the
        round-robin, span ended (state=suspended — a graceful drain
        leaves zero unclosed spans), job NON-terminal. The generator
        unwind happens outside the lock, like every close."""
        with self._lock:
            try:
                self._active.remove(job)
            except ValueError:
                pass
            job.suspended = True
            job.engine = None
            if job.span is not None:
                job.span.end(state="suspended", steps=job.steps)
                job.span = None
            obs.event("job_suspend", job=job.id,
                      tenant=job.spec.tenant, steps=job.steps,
                      phase=job.phase)

    def _suspend_cycle(self) -> bool:
        """One dispatch-loop pass of the graceful drain: arm each
        active engine's next-barrier checkpoint, park the ones whose
        save landed (or everything, once the grace deadline passes),
        and keep stepping the rest. True = fully parked, journal the
        handoff, run() should return."""
        to_park = []
        step_more = []
        with self._lock:
            timed_out = time.monotonic() >= self._suspend_deadline
            for job in list(self._active):
                eng = job.engine
                if eng is not None and job.ckpt is not None \
                        and not timed_out:
                    eng.request_checkpoint()
                    if not eng.suspend_ready:
                        step_more.append(job)
                        continue
                # saved (or nothing to save / out of grace: the last
                # cadence checkpoint still makes restart a resume)
                to_park.append(job)
            for job in to_park:
                self._park_locked(job)
            done = not self._active
        for job in to_park:
            self._close_gen(job)
        if done:
            with self._lock:
                suspended = [j.id for j in self._jobs.values()
                             if j.suspended]
                queued = [j.id for j in self._pending]
                if self.journal is not None:
                    self.journal.append(
                        {"rec": "drain", "t": time.time(),
                         "suspended": suspended, "queued": queued},
                        fsync=True)
                obs.event("daemon_suspend_done",
                          suspended=len(suspended), queued=len(queued))
            return True
        for job in step_more:
            self._step(job)
        return False

    # ------------------------------------------------------------------
    # live telemetry: /metrics exposition + heartbeat feed
    # ------------------------------------------------------------------
    def render_metrics(self) -> str:
        """The Prometheus exposition document the `metrics` verb and
        the daemon's HTTP listener answer."""
        return self.metrics.render()

    def service_pressure(self) -> dict:
        """Cheap live queue-depth/active-job sample — the heartbeat's
        service-pressure fields when running inside sheepd."""
        with self._lock:
            return {"queue_depth": len(self._pending),
                    "active_jobs": len(self._active)}

    def _collect_live_gauges(self):
        """Scrape-time collector: queue/reservation/cache state,
        per-active-job progress, the active tracer's CounterRegistry
        absorbed as live gauges (not just span-boundary deltas), and
        device-memory stats. Runs on the scraping thread; everything
        under the lock is a handful of len()s."""
        with self._lock:
            active = list(self._active)
            residents = [j for j in self._jobs.values()
                         if self._is_resident(j)]
            samples = [
                ("sheepd_queue_depth", {}, len(self._pending)),
                ("sheepd_active_jobs", {}, len(active)),
                ("sheepd_reserved_bytes", {}, self._reserved_locked()),
                ("sheepd_resident_partitions", {}, len(residents)),
                ("sheepd_chunk_caches", {}, len(self._caches)),
                ("sheepd_uptime_seconds", {},
                 round(time.time() - self.started_t, 1)),
                # no _total suffix: collector samples render as gauges,
                # and a _total-named gauge trips OpenMetrics linting
                ("sheepd_flight_dumps", {}, self.flight.dumps),
            ]
            if self.budget is not None:
                reserved = self._reserved_locked()
                samples.append(("sheepd_budget_bytes", {}, self.budget))
                samples.append(("sheepd_headroom_bytes", {},
                                self.budget - reserved))
            for job in active:
                labels = {"job": job.id, "tenant": job.spec.tenant}
                samples.append(("sheepd_job_steps", labels, job.steps))
            for job in residents:
                st = job.resident_state
                samples.append(
                    ("sheepd_resident_epoch",
                     {"job": job.id, "tenant": job.spec.tenant},
                     int(st.epoch) if st is not None
                     else int(job.journaled_epoch)))
            # per-job quality gauges: the most recent DONE
            # jobs' final scores, scrapeable per job/tenant/k. Bounded
            # to the 32 newest COMPLETIONS (submit order would let a
            # long-queued early job push the one that just finished
            # out of the scrape) so a long-lived daemon's scrape does
            # not grow with terminal-retention history.
            done = sorted((j for j in self._jobs.values()
                           if j.state == DONE and j.results),
                          key=lambda j: j.end_t or 0.0)
            for job in done[-32:]:
                for r in job.results:
                    labels = {"job": job.id, "tenant": job.spec.tenant,
                              "k": str(r.k)}
                    samples.append(("sheep_quality_job_cut_ratio",
                                    labels, float(r.cut_ratio)))
                    samples.append(("sheep_quality_job_balance",
                                    labels, float(r.balance)))
        store = self.result_store
        if store is not None:
            # file IO (listdir + stat) — outside the lock by design
            samples.append(("sheepd_result_cache_bytes", {},
                            store.bytes_used))
        for name, n in compile_cache_sizes().items():
            samples.append(("sheepd_compile_cache_entries",
                            {"program": name}, n))
        tracer = obs.get_tracer()
        if tracer is not None:
            for k, v in tracer.counters.snapshot().items():
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    samples.append(("sheep_run_counter",
                                    {"name": str(k)}, v))
        from sheep_tpu_torch.utils.metrics import device_memory_stats

        for k, v in (device_memory_stats(self.device) or {}).items():
            samples.append((f"sheepd_device_{k}", {}, v))
        return samples

    # ------------------------------------------------------------------
    # on-demand device profiling (the `profile` verb)
    # ------------------------------------------------------------------
    def arm_profile(self, profile_dir: str, steps: int = 8) -> dict:
        """Arm a torch.profiler capture of the next ``steps`` dispatch
        steps into ``profile_dir``. Returns the armed descriptor; the
        capture itself is driven by the dispatch thread (profiling a
        live daemon must not add a second thread touching the device).
        One capture at a time — overlapping captures would interleave
        in one trace directory and attribute nothing."""
        try:
            steps = int(steps)
        except (TypeError, ValueError):
            raise protocol.ProtocolError(
                "profile steps must be an integer") from None
        if steps < 1:
            raise protocol.ProtocolError("profile steps must be >= 1")
        with self._lock:
            if self._stop or self._draining:
                raise protocol.ProtocolError("daemon is shutting down")
            if self._profile is not None:
                raise protocol.ProtocolError(
                    "a profile capture is already "
                    f"{self._profile.get('state', 'armed')} "
                    f"(dir {self._profile.get('dir')!r})")
            self._profile = {"dir": str(profile_dir), "state": "armed",
                             "steps_requested": steps,
                             "remaining": steps}
            info = {k: v for k, v in self._profile.items()
                    if k != "remaining"}
        obs.event("profile_armed", dir=str(profile_dir), steps=steps)
        return info

    def _profile_tick_begin(self) -> None:
        # dispatch thread only (the sole state-transitioner once
        # armed): start the armed capture at a step boundary so the
        # trace holds WHOLE steps. Dict mutations happen under the
        # lock — stats() snapshots this dict from handler threads.
        prof = self._profile
        if prof is None or prof["state"] != "armed":
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(prof["dir"], exist_ok=True)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        except Exception as e:  # profiler unavailable: verb answered,
            with self._lock:    # daemon unharmed
                prof["state"] = "error"
                prof["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                self.last_profile = {k: v for k, v in prof.items()
                                     if k != "remaining"}
                self._profile = None
            obs.event("profile_error", dir=prof["dir"],
                      error=prof["error"])
            return
        with self._lock:
            prof["state"] = "capturing"
        obs.event("profile_start", dir=prof["dir"],
                  steps=prof["steps_requested"])

    def _profile_tick_end(self) -> None:
        prof = self._profile
        if prof is None or prof["state"] != "capturing":
            return
        with self._lock:
            prof["remaining"] -= 1
            finished = prof["remaining"] <= 0
        if finished:
            self._finish_profile()

    def _finish_profile(self, aborted: bool = False) -> None:
        prof = self._profile
        if prof is None:
            return
        try:
            profiler, self._profiler = self._profiler, None
            profiler.stop()
            profiler.export_chrome_trace(
                os.path.join(prof["dir"], "sheepd_trace.json"))
            state = "aborted" if aborted else "done"
            err = None
        except Exception as e:
            state = "error"
            err = f"{type(e).__name__}: {str(e)[:200]}"
        with self._lock:
            prof["state"] = state
            if err is not None:
                prof["error"] = err
            prof["steps_captured"] = \
                prof["steps_requested"] - max(0, prof["remaining"])
            self.last_profile = {k: v for k, v in prof.items()
                                 if k != "remaining"}
            self._profile = None
        obs.event("profile_done", dir=prof["dir"], state=state,
                  steps_captured=prof["steps_captured"])

    # ------------------------------------------------------------------
    # resident partitions: the update/epoch/compact verbs
    # ------------------------------------------------------------------
    def _resident_path(self, job_id: str) -> Optional[str]:
        if self.ckpt_dir is None:
            return None
        return os.path.join(self.ckpt_dir, f"{job_id}.resident.npz")

    def update(self, job_id: str, adds=None, dels=None,
               epoch=None, score: bool = False, compact: str = "auto",
               log: Optional[str] = None,
               timeout_s: float = 600.0) -> dict:
        """Apply one delta epoch (or a daemon-side delta log's pending
        epochs) to a resident partition. Handler-thread API: the fold
        itself runs on the dispatch thread (one device chain)."""
        return self._submit_item(
            {"kind": "update", "job_id": job_id, "adds": adds,
             "dels": dels, "epoch": epoch, "score": bool(score),
             "compact": str(compact), "log": log}, timeout_s)

    def epoch_info(self, job_id: str,
                   timeout_s: float = 600.0) -> dict:
        return self._submit_item(
            {"kind": "epoch", "job_id": job_id}, timeout_s)

    def compact_resident(self, job_id: str, mode: str = "auto",
                         score: bool = False,
                         timeout_s: float = 600.0) -> dict:
        return self._submit_item(
            {"kind": "compact", "job_id": job_id, "mode": str(mode),
             "score": bool(score)}, timeout_s)

    def _submit_item(self, item: dict, timeout_s: float) -> dict:
        item["evt"] = threading.Event()
        # fairness bookkeeping: every queued item carries
        # its tenant and payload size so _service_updates can enforce
        # per-tenant byte budgets without re-locking the job table
        nb = 0
        for k in ("adds", "dels"):
            if item.get(k) is not None:
                nb += 16 * len(item[k])
        item["bytes"] = nb
        with self._lock:
            if self._stop or self._suspending:
                raise protocol.ProtocolError("daemon is shutting down")
            job = self._jobs.get(item["job_id"])
            if job is None:
                raise protocol.ProtocolError(
                    f"unknown job {item['job_id']!r}")
            item["tenant"] = job.spec.tenant
            self._updates.append(item)
            self._cond.notify_all()
        if not item["evt"].wait(timeout=timeout_s):
            with self._lock:
                try:
                    # still queued: dequeue it so the abandoned
                    # request cannot fire AFTER the client was told
                    # it timed out (a blind retry of an un-epoched
                    # update would then double-fold)
                    self._updates.remove(item)
                    dequeued = True
                except ValueError:
                    dequeued = False  # already executing
                item["abandoned"] = True
            if dequeued:
                raise protocol.ProtocolError(
                    f"{item['kind']} timed out after {timeout_s}s "
                    f"waiting for the dispatch thread; the request "
                    f"was dequeued — safe to retry")
            raise protocol.ProtocolError(
                f"{item['kind']} timed out after {timeout_s}s "
                f"mid-execution; it may still apply — query `epoch` "
                f"before retrying an un-epoched update")
        if item.get("error") is not None:
            raise protocol.ProtocolError(item["error"])
        return item["result"]

    def _service_updates(self) -> None:
        """Dispatch-thread drain of the resident-partition work queue
        (between job-step cycles, same thread as every device fold).

        Fairness: ``SHEEP_UPDATE_BYTES_PER_CYCLE`` caps the
        delta bytes each tenant may fold per drain cycle. A tenant
        streaming huge epochs exhausts its budget and its remaining
        items are DEFERRED to the next cycle (counted in
        ``sheepd_update_throttled_total``), letting other tenants' —
        and the build queue's — work interleave. Budgets reset every
        cycle, so deferred items always make progress; unset or 0
        means unlimited (a plain FIFO drain)."""
        try:
            budget = int(os.environ.get(
                "SHEEP_UPDATE_BYTES_PER_CYCLE", "0") or "0")
        except ValueError:
            budget = 0
        spent: dict = {}
        while True:
            with self._lock:
                item = None
                for i, it in enumerate(self._updates):
                    t = it.get("tenant", "default")
                    if budget <= 0 or spent.get(t, 0) < budget \
                            or it.get("abandoned"):
                        item = it
                        del self._updates[i]
                        break
                if item is None:
                    # every queued tenant exhausted its cycle budget:
                    # leave the rest queued, one throttle tick per
                    # deferred item, pick them up next cycle
                    for it in self._updates:
                        self._m_update_throttled.inc(
                            tenant=it.get("tenant", "default"))
                    return
                if item.get("abandoned"):
                    continue  # its waiter already gave up
                spent[item.get("tenant", "default")] = \
                    spent.get(item.get("tenant", "default"), 0) \
                    + int(item.get("bytes", 0))
            try:
                with self.flight.job_context(item["job_id"]):
                    item["result"] = self._do_item(item)
                item["error"] = None
            except protocol.ProtocolError as e:
                item["error"] = str(e)
            except Exception as e:  # noqa: BLE001 — answered, not fatal
                item["error"] = (f"internal: {type(e).__name__}: "
                                 f"{str(e)[:300]}")
            finally:
                item["evt"].set()

    def _ensure_resident_state(self, job: Job):
        """The job's live resident state, lazily reloaded from its
        snapshot after a restart (the snapshot is written BEFORE each
        journaled delta_epoch, so its epoch >= the journal floor —
        'resumes at its last applied epoch'). Dispatch thread only."""
        from sheep_tpu_torch import incremental

        if not job.spec.resident:
            raise protocol.ProtocolError(
                f"job {job.id} was not submitted resident")
        if job.resident_released:
            raise protocol.ProtocolError(
                f"job {job.id}'s resident partition was released")
        if job.state != DONE:
            raise protocol.ProtocolError(
                f"job {job.id} is {job.state}; a resident partition "
                f"exists only after the build is done")
        if job.resident_state is not None:
            return job.resident_state
        path = self._resident_path(job.id)
        if path is None or not os.path.exists(path):
            raise protocol.ProtocolError(
                f"job {job.id} has no resident state on disk "
                f"(non-durable daemon restarted, or state lost); "
                f"rebuild with a fresh resident submit")
        job.resident_state = incremental.load_state(path)
        if job.resident_state.epoch < job.journaled_epoch:
            # the journal promised an epoch the snapshot predates —
            # never silently serve the older state
            raise protocol.ProtocolError(
                f"resident snapshot of {job.id} is at epoch "
                f"{job.resident_state.epoch} but the journal floors "
                f"{job.journaled_epoch}; state dir damaged")
        obs.event("resident_resumed", job=job.id,
                  epoch=int(job.resident_state.epoch))
        return job.resident_state

    def _update_backend_for(self, job: Job):
        """The port's backend that folds this resident job's delta
        epochs, on the scheduler's device (``update_backend``)."""
        if job._upd_backend is None:
            from sheep_tpu_torch import _backend

            spec = job.spec
            name = protocol.normalize_update_backend(spec.update_backend)
            job._upd_backend = _backend(
                self.device, spec.chunk_edges, 0, spec.alpha, 0, 0,
                {"segment_rounds": spec.segment_rounds}, name)
        return job._upd_backend

    def _persist_resident(self, job: Job,
                          journal_epoch: bool = True) -> None:
        """Snapshot the resident state, then (optionally) journal the
        applied epoch — strictly in that order, so a replayed journal
        never names an epoch the snapshot lacks. Dispatch thread only
        (the sole state mutator), and the O(V) array write + fsync
        deliberately runs OUTSIDE the scheduler lock: a multi-second
        snapshot of a big resident table must not stall every
        ping/status/submit handler. Only the journal append and the
        epoch-floor bookkeeping take the lock."""
        from sheep_tpu_torch import incremental

        with self._lock:
            if job.resident_released:
                return  # cancel raced us before the write: nothing
            st = job.resident_state
            path = self._resident_path(job.id)
        if st is None or path is None:
            return
        incremental.save_state(st, path)
        with self._lock:
            if job.resident_released:
                # cancel released the residency DURING the write: the
                # unlink it did must win — remove the snapshot we just
                # resurrected and journal nothing
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
            if journal_epoch and self.journal is not None:
                self.journal.append(
                    {"rec": "delta_epoch", "job_id": job.id,
                     "epoch": int(st.epoch), "t": time.time()},
                    fsync=True)
            job.journaled_epoch = max(job.journaled_epoch,
                                      int(st.epoch))

    def _do_item(self, item: dict) -> dict:
        from sheep_tpu_torch import incremental

        with self._lock:
            job = self._jobs.get(item["job_id"])
        if job is None:
            raise protocol.ProtocolError(
                f"unknown job {item['job_id']!r}")
        state = self._ensure_resident_state(job)
        tenant = job.spec.tenant
        if item["kind"] == "epoch":
            return {"job_id": job.id, "epoch": int(state.epoch),
                    "anchored_at_epoch": int(state.anchored_at_epoch),
                    "stale_deletes": int(state.stale_deletes),
                    "compactions": int(state.compactions),
                    "n_vertices": int(state.n),
                    "total_edges": int(state.total_edges)}
        backend = self._update_backend_for(job)
        if item["kind"] == "compact":
            t0 = time.perf_counter()
            old_base = None
            if item["mode"] == "rebase":
                mode, old_base = self._rebase_resident(state, job,
                                                       backend)
            else:
                mode = incremental.compact_state(backend, state,
                                                 mode=item["mode"])
            if mode != "noop":
                self._m_compactions.inc(tenant=tenant, mode=mode)
            out = {"job_id": job.id, "mode": mode,
                   "epoch": int(state.epoch),
                   "compactions": int(state.compactions),
                   "wall_s": round(time.perf_counter() - t0, 4)}
            if mode == "rebase":
                out["base"] = state.base_spec
            if item.get("score"):
                out["results"] = self._refresh_results(
                    backend, state, job)
            self._persist_resident(job)
            if old_base is not None:
                # drop the superseded rebase artifact only AFTER the
                # snapshot + journal referencing the new base are
                # durable — a crash in between leaves both bases on
                # disk, never neither
                try:
                    os.unlink(old_base)
                except OSError:
                    pass
            return out
        # ---- update -------------------------------------------------
        t0 = time.perf_counter()
        epochs = []
        if item.get("log"):
            from sheep_tpu_torch.io.deltalog import DeltaLogReader

            reader = DeltaLogReader(item["log"])
            base = reader.header["base_spec"]
            if state.base_spec is not None \
                    and base != state.base_spec:
                raise protocol.ProtocolError(
                    f"delta log {item['log']!r} logs over {base!r}, "
                    f"not this partition's base "
                    f"{state.base_spec!r}")
            epochs = list(reader.epochs(start_epoch=state.epoch))
        else:
            epochs = [(item.get("epoch"), item.get("adds"),
                       item.get("dels"))]
        compactions0 = int(state.compactions)
        applied = 0
        for ep, adds, dels in epochs:
            before = int(state.epoch)
            backend.partition_update(
                state, adds=adds, deletes=dels, epoch=ep,
                score=False, compact=item.get("compact", "auto"))
            if int(state.epoch) != before:
                # count applied BATCHES, not the epoch-number delta:
                # explicit epochs may be sparse (1 then 5 is legal)
                applied += 1
        if applied > 0:
            self._m_updates.inc(applied, tenant=tenant)
            comp = int(state.compactions) - compactions0
            if comp:
                self._m_compactions.inc(comp, tenant=tenant,
                                        mode="auto")
            self._persist_resident(job)
        out = {"job_id": job.id, "epoch": int(state.epoch),
               "applied": applied > 0, "epochs_applied": applied,
               "stale_deletes": int(state.stale_deletes),
               "compactions": int(state.compactions)}
        if item.get("score"):
            ts = time.perf_counter()
            out["results"] = self._refresh_results(backend, state, job)
            self._m_update_score.observe(time.perf_counter() - ts,
                                         tenant=tenant)
        self._m_update_latency.observe(time.perf_counter() - t0,
                                       tenant=tenant)
        obs.event("job_update", job=job.id, tenant=tenant,
                  epoch=int(state.epoch), applied=applied)
        return out

    def _refresh_results(self, backend, state, job: Job) -> list:
        """Split + score the current resident table; the job's result
        rows update so wait/status serve the newest scores."""
        from sheep_tpu_torch import incremental

        res = incremental.refresh(backend, state,
                                  comm_volume=job.spec.comm_volume)
        results = res if isinstance(res, list) else [res]
        with self._lock:
            job.results = results
        for r in results:
            self._m_quality_cut.observe(float(r.cut_ratio),
                                        tenant=job.spec.tenant)
            self._m_quality_balance.observe(float(r.balance),
                                            tenant=job.spec.tenant)
            obs.event("job_quality", job=job.id, k=int(r.k),
                      cut_ratio=round(float(r.cut_ratio), 6),
                      balance=round(float(r.balance), 4),
                      edge_cut=int(r.edge_cut))
        return [r.summary() for r in results]

    def _rebase_resident(self, state, job: Job, backend):
        """Compact mode ``rebase``: rewrite the resident
        base + folded deltas into a fresh CSR artifact under the
        checkpoint dir, so the served partition's read path stops
        paying for history. Explicit opt-in only — ``auto`` never
        escalates to it. Returns ``("rebase", old_artifact_or_None)``;
        the caller unlinks the superseded artifact only after the new
        snapshot + journal record are durable."""
        from sheep_tpu_torch import incremental

        if self.ckpt_dir is None:
            raise protocol.ProtocolError(
                "compact mode 'rebase' needs a durable daemon "
                "(--state-dir / --checkpoint-dir): the rewritten "
                "base is a disk artifact")
        old = state.base_spec
        base_out = os.path.join(
            self.ckpt_dir, f"{job.id}.base.e{int(state.epoch)}.csr")
        incremental.rebase_state(backend, state, base_out)
        owned = None
        if isinstance(old, str) and old != base_out \
                and os.path.isfile(old) \
                and os.path.dirname(os.path.abspath(old)) \
                == os.path.abspath(self.ckpt_dir):
            # only reap artifacts WE wrote (a prior rebase): a base
            # outside the ckpt dir is user input, never ours to delete
            owned = old
        return "rebase", owned

    # ------------------------------------------------------------------
    # the dispatch loop (one thread)
    # ------------------------------------------------------------------
    def run(self) -> None:
        """Round-robin dispatch until shutdown; see module docstring."""
        try:
            while True:
                to_close: list = []
                with self._lock:
                    self._expire_locked()
                    if self._stop:
                        for job in list(self._pending):
                            self._pending.remove(job)
                            self._finalize_locked(job, CANCELLED)
                        for job in list(self._active):
                            self._finalize_locked(job, CANCELLED)
                            to_close.append(job)
                if self._stop:
                    for job in to_close:
                        self._close_gen(job)
                    return
                if self._suspending:
                    # graceful drain: no admissions, checkpoint + park
                    # the active jobs, exit once everything is parked
                    if self._suspend_cycle():
                        return
                    continue
                with self._lock:
                    self._admit_locked()
                    if self._draining and not self._pending \
                            and not self._active:
                        return
                    idle = not self._active and not self._updates
                    capturing = self._profile is not None \
                        and self._profile["state"] == "capturing"
                    if idle and not capturing:
                        # bounded wait: queued-job deadlines tick
                        # while idle
                        self._cond.wait(timeout=0.1)
                    cycle = [] if idle else list(self._active)
                if idle:
                    if capturing:
                        # the job set drained mid-capture: there is no
                        # Kth step coming — stop the profiler now (an
                        # open capture grows host memory forever and
                        # blocks every re-arm)
                        self._finish_profile(aborted=True)
                    continue
                for job in cycle:
                    self._step(job)
                # resident-partition verbs drain between step cycles:
                # delta folds share the one dispatch chain
                self._service_updates()
        finally:
            self._teardown_telemetry()

    def _teardown_telemetry(self) -> None:
        """Dispatch-loop exit sweep: stop a mid-flight profiler
        capture, dump the flight recorder (shutdown is a dump trigger
        — the daemon's last moments are forensics too), release the
        process-wide recorder slot."""
        prof = self._profile
        if prof is not None and prof.get("state") == "capturing":
            self._finish_profile(aborted=True)
        with self._lock:
            pending_items = list(self._updates)
            self._updates.clear()
        for item in pending_items:
            # answer every parked update verb: a handler thread must
            # never ride its full timeout because the loop exited
            item["error"] = "daemon is shutting down"
            item["evt"].set()
        self.flight.dump_all(reason="shutdown")
        if obs.get_flight() is self.flight:
            obs.uninstall_flight()
        with self._lock:
            if self.journal is not None:
                self.journal.close()

    def _expire_locked(self) -> None:
        # reentrant re-acquire (RLock): callers already hold the lock;
        # taking it here too keeps every mutation lexically guarded
        with self._lock:
            now = time.time()
            for job in [j for j in self._pending
                        if j.deadline_t is not None
                        and now >= j.deadline_t]:
                self._pending.remove(job)
                self._finalize_locked(job, DEADLINE_EXCEEDED)

    def _admit_locked(self) -> None:
        with self._lock:
            while self._pending:
                job = self._pending[0]
                if self.budget is not None:
                    # resident partitions count: their tables re-enter
                    # device memory on every update fold
                    reserved = self._reserved_locked()
                    if (self._active or reserved) and \
                            reserved + (job.modeled_bytes or 0) \
                            > self.budget:
                        if not self._active \
                                and not job.stats.get(
                                    "blocked_by_resident"):
                            # nothing running will ever free these
                            # bytes — only a tenant releasing a
                            # resident partition can; say so ONCE so
                            # the wait is diagnosable, not silent
                            job.stats["blocked_by_resident"] = 1
                            obs.event("admission_blocked_by_resident",
                                      job=job.id,
                                      tenant=job.spec.tenant,
                                      reserved_bytes=int(reserved),
                                      budget_bytes=int(self.budget))
                        break  # fits the budget, not current headroom
                self._pending.popleft()
                self._start_locked(job)

    def _start_locked(self, job: Job) -> None:
        with self._lock:
            job.state = RUNNING
            job.start_t = time.time()
            job.jit_compiles = 0
            self._m_queue_wait.observe(job.start_t - job.submit_t,
                                       tenant=job.spec.tenant)
            job.span = obs.begin_detached(
                f"job:{job.id}", parent=self.root_span_id,
                remote_parent=({"trace": job.trace_id,
                                "span": job.trace_parent}
                               if job.trace_id else None),
                job=job.id, tenant=job.spec.tenant, input=job.spec.input,
                k=list(job.spec.ks))
            job.span_id = getattr(job.span, "id", None)
            cache = self._lease_cache_locked(job)
            if self.ckpt_dir is not None:
                # per-job recovery domain: job ids are stable across
                # restarts (the journal floors the id counter), so a
                # re-admitted job finds exactly its own prior state;
                # resume=True is a no-op on an empty domain
                from sheep_tpu_torch.utils.checkpoint import Checkpointer

                job.ckpt = Checkpointer(
                    os.path.join(self.ckpt_dir, job.id),
                    every=self.ckpt_every)
            engine = JobEngine(job, self.device, cache=cache,
                               checkpointer=job.ckpt,
                               resume=job.ckpt is not None)
            job.engine = engine
            job.gen = engine.steps()
            if self.journal is not None:
                # buffered, not fsync'd: losing this record merely
                # replays the job as queued (a clean re-start)
                self.journal.append({"rec": "state", "job_id": job.id,
                                     "state": RUNNING,
                                     "t": job.start_t})
            self._active.append(job)
            obs.event("job_admit", job=job.id, tenant=job.spec.tenant,
                      modeled_bytes=job.modeled_bytes,
                      active=len(self._active))
            self._cond.notify_all()

    def _step(self, job: Job) -> None:
        cut = None
        with self._lock:
            if job.state != RUNNING:
                return
            if job.cancel_requested:
                self._finalize_locked(job, CANCELLED)
                cut = job
            elif job.deadline_t is not None \
                    and time.time() >= job.deadline_t:
                self._finalize_locked(job, DEADLINE_EXCEEDED)
                cut = job
        if cut is not None:
            # the unwind (prefetch-worker joins) runs OUTSIDE the lock
            # so a slow close cannot stall ping/status/submit handlers
            self._close_gen(cut)
            return
        # the device work happens OUTSIDE the lock: submits/cancels/
        # waits from handler threads must never block on a fold. Steps
        # are serialized on this one thread, so the compile-cache
        # growth across ONE step belongs to exactly this job — the
        # exact per-job jit attribution under interleaving. The same
        # serialization makes the flight-recorder job context exact:
        # every event the engine/retry layer emits during THIS next()
        # lands in THIS job's ring.
        self._profile_tick_begin()
        jit0 = sum(compile_cache_sizes().values())
        t_step = time.perf_counter()
        try:
            try:
                with self.flight.job_context(job.id):
                    phase = next(job.gen)
            finally:
                grew = sum(compile_cache_sizes().values()) - jit0
                if grew and job.jit_compiles is not None:
                    job.jit_compiles += grew
                self._profile_tick_end()
            self._m_step_s.observe(time.perf_counter() - t_step,
                                   phase=str(phase))
            self._m_steps.inc(tenant=job.spec.tenant)
            with self._lock:
                job.steps += 1
                job.phase = str(phase)
            return
        except StopIteration:
            outcome, error = DONE, None
        except Exception as exc:  # noqa: BLE001 — job fault, not ours
            outcome = FAILED
            error = f"{type(exc).__name__}: {str(exc)[:300]}"
        with self._lock:
            self._finalize_locked(job, outcome, error)
        if outcome == DONE and job.resident_state is not None:
            # the adopted resident partition's initial snapshot —
            # outside the lock, on the dispatch thread
            self._persist_resident(job, journal_epoch=False)
        if outcome == DONE:
            # fleet warm path: publish strictly AFTER the
            # fsync'd journal terminal, outside the lock, on the
            # dispatch thread — a kill -9 between the two resolves to
            # a rebuild on the next identical submit, never a torn or
            # unjournaled answer
            self._publish_result(job)
        if outcome == FAILED:
            # forensics: the job's last N buffered events (terminal
            # event included — job_done landed in the ring at
            # finalize), dumped into the trace sink OUTSIDE the lock:
            # a slow trace write must not wedge every handler thread
            self.flight.dump(job.id, reason="job_failed:"
                             f"{(error or '?')[:120]}")
        self._close_gen(job)

    def _publish_result(self, job: Job) -> None:
        """Persist a DONE job's results into the content-addressed
        store. Best-effort: a failed publish costs the next
        identical submit a rebuild, never an error."""
        store = self.result_store
        if store is None or job.spec.resident or not job.results \
                or not job.digest:
            return
        rows = []
        for r in job.results:
            row = r.summary()
            row["assignment"] = protocol.encode_assignment(r.assignment)
            rows.append(row)
        try:
            ok = store.put(job.digest, {
                "t": job.end_t or time.time(),
                "tenant": job.spec.tenant,
                "n_vertices": int(job.n_vertices), "results": rows})
        except (OSError, ValueError) as e:
            obs.event("result_cache_error", job=job.id,
                      error=f"{type(e).__name__}: {str(e)[:200]}")
            return
        delta = store.evictions - self._rc_evictions_seen
        if delta > 0:
            self._m_rc_evictions.inc(delta)
            self._rc_evictions_seen = store.evictions
        if ok:
            obs.event("result_cache_store", job=job.id,
                      digest=job.digest, bytes=store.bytes_used)

    def lookup_digest(self, digest) -> bool:
        """The ``lookup`` verb: does this replica's result
        store hold an entry for ``digest``? Advisory — a damaged entry
        reports a miss here (the submit path applies the full
        strict/quarantine contract when it actually serves)."""
        store = self.result_store
        if store is None or not isinstance(digest, str):
            return False
        try:
            return store.get(digest) is not None
        except ValueError:
            return False

    # terminal jobs retained for status/wait queries; beyond this the
    # oldest are evicted (with their result arrays) — a resident
    # daemon must not grow host memory monotonically with traffic
    MAX_TERMINAL_RETAINED = 512

    def _finalize_locked(self, job: Job, state: str,
                         error: Optional[str] = None) -> None:
        """Terminal transition: release the reservation + cache lease,
        end the job span, account, evict old terminal jobs, notify.
        Does NOT close the step generator — the dispatch thread does
        that OUTSIDE the lock (:meth:`_close_gen`): the unwind joins
        prefetch workers and must not stall every handler thread."""
        with self._lock:
            if job.state in TERMINAL_STATES:
                return
            job.state = state
            job.error = error
            job.end_t = time.time()
            try:
                self._active.remove(job)
            except ValueError:
                pass
            self._release_cache_locked(job)
            if state == DONE:
                self._write_output(job)
            if state == DONE and job.spec.resident \
                    and job.incremental_state is not None:
                # adopt the engine's incremental state as the resident
                # partition; the initial snapshot is
                # written by _step AFTER this lock releases (an O(V)
                # disk write must not stall the handler threads) —
                # until it lands, a crash replays the job as DONE
                # with no resident state, the documented non-durable
                # degradation
                job.resident_state = job.incremental_state
                job.incremental_state = None
            self.totals[state] = self.totals.get(state, 0) + 1
            self._m_terminal.inc(tenant=job.spec.tenant, state=state)
            if state == DONE:
                # the SLO series: queued->done, queue wait included —
                # the client asked for a result at submit, not at start
                self._m_latency.observe(job.end_t - job.submit_t,
                                        tenant=job.spec.tenant)
                for r in job.results or []:
                    # the quality plane: every result k is
                    # one observation in the tenant's cut/balance
                    # distributions
                    self._m_quality_cut.observe(
                        float(r.cut_ratio), tenant=job.spec.tenant)
                    self._m_quality_balance.observe(
                        float(r.balance), tenant=job.spec.tenant)
            retries = job.stats.get("dispatch_retries")
            if isinstance(retries, (int, float)) and retries:
                self._m_retries.inc(int(retries), tenant=job.spec.tenant)
            if self.journal is not None:
                results = None
                if state == DONE and job.results:
                    results = [r.summary() for r in job.results]
                self.journal.append(
                    {"rec": "terminal", "job_id": job.id,
                     "state": state, "t": job.end_t,
                     **({"error": error} if error else {}),
                     **({"results": results} if results else {})},
                    fsync=True)
            if job.ckpt is not None:
                # terminal jobs leave no checkpoint residue: the
                # per-job domain dies with the job (a replayed
                # terminal never resumes)
                try:
                    job.ckpt.clear(force=True)
                    os.rmdir(job.ckpt.dir)
                except OSError:
                    pass
                job.ckpt = None
            job.engine = None
            if job.span is not None:
                cost = {k: job.stats[k]
                        for k in ("device_rounds", "host_syncs",
                                  "batch_execs", "dispatch_retries")
                        if k in job.stats}
                job.span.end(state=state,
                             jit_compiles=job.jit_compiles, **cost)
            obs.event("job_done", job=job.id, tenant=job.spec.tenant,
                      state=state, error=error,
                      jit_compiles=job.jit_compiles,
                      steps=job.steps)
            if state == DONE:
                # healthy jobs leave no ring behind: failed/cancelled
                # rings are worth retaining for the shutdown sweep, a
                # done job's is just noise
                self.flight.forget(job.id)
            terminal = [jid for jid, j in self._jobs.items()
                        if j.state in TERMINAL_STATES
                        and not self._is_resident(j)]
            for jid in terminal[:max(0, len(terminal)
                                     - self.MAX_TERMINAL_RETAINED)]:
                del self._jobs[jid]
            self._cond.notify_all()

    def _close_gen(self, job: Job) -> None:
        """Unwind a finalized job's step generator (engine finallys:
        chunk/group iterators close, prefetch workers cancel + join,
        phase spans end). Dispatch-thread only — generators are never
        touched from handler threads — and deliberately outside the
        scheduler lock (a stuck reader's bounded join must not freeze
        the API)."""
        gen, job.gen = job.gen, None
        if gen is None:
            return
        try:
            gen.close()
        except Exception as e:  # unwind failure: on record, not fatal
            import sys

            obs.event("job_unwind_error", job=job.id,
                      error=f"{type(e).__name__}: {str(e)[:200]}")
            print(f"sheepd: unwind of {job.id} raised "
                  f"{type(e).__name__}: {str(e)[:200]}", file=sys.stderr)

    def _write_output(self, job: Job) -> None:
        if not job.spec.output or not job.results:
            return
        from sheep_tpu_torch.io.formats import write_partition

        try:
            for r in job.results:
                path = job.spec.output
                if len(job.results) > 1:
                    root, ext = os.path.splitext(path)
                    path = f"{root}.k{r.k}{ext}"
                write_partition(path, r.assignment)
        except Exception as e:
            job.error = (f"partition finished but output write failed: "
                         f"{type(e).__name__}: {str(e)[:200]}")

    # ------------------------------------------------------------------
    # shared device chunk cache (one filler + any readers per input)
    # ------------------------------------------------------------------
    def _lease_cache_locked(self, job: Job):
        """The daemon-held device chunk cache for this job's input, or
        None. The backends' prefix-fill invariant assumes a single
        FILLER, so the first job on an input leases the cache itself
        (it appends); concurrent jobs on the same input get a
        read-only view that serves the cached prefix and
        streams the rest without ever appending — interleaved jobs
        share the resident chunks instead of the second one
        re-streaming everything. All access stays on the one dispatch
        thread, so reads and fills never race. Budget comes from the
        backends' own rule (0 on the CPU, where "device" memory is
        the host's)."""
        from sheep_tpu_torch.backends.torch_backend import (
            _ChunkCache, _ChunkCacheReader, _chunk_cache_budget)

        if job.spilled:
            # spilled-mode admission priced this job at the cache-less
            # floor; leasing resident chunks would put back exactly the
            # bytes the admission model zeroed out
            return None
        with self._lock:
            key = (job.spec.input, job.spec.chunk_edges,
                   job.n_vertices)
            entry = self._caches.get(key)
            if entry is None:
                budget = _chunk_cache_budget(
                    job.n_vertices, job.spec.chunk_edges, self.device,
                    dispatch_batch=max(1, job.spec.dispatch_batch))
                if budget <= 0:
                    return None
                entry = {"cache": _ChunkCache(budget),
                         "filler": None, "readers": set()}
                self._caches[key] = entry
                # bound resident inputs — but never evict a HELD
                # entry: its chunks are pinned by the running engines
                # anyway, and dropping the entry would orphan the
                # lease and invite a duplicate cache for the same key
                evictable = [k for k, e in self._caches.items()
                             if e["filler"] is None
                             and not e["readers"] and k != key]
                while len(self._caches) > 4 and evictable:
                    del self._caches[evictable.pop(0)]
            if entry["filler"] is None:
                entry["filler"] = job.id
                return entry["cache"]
            entry["readers"].add(job.id)
            return _ChunkCacheReader(entry["cache"])

    def _release_cache_locked(self, job: Job) -> None:
        with self._lock:
            for key, entry in list(self._caches.items()):
                if entry["filler"] == job.id:
                    entry["filler"] = None
                    if job.cache_shed:
                        # the engine detached under memory pressure:
                        # drop the entry so its memory dies with the
                        # engines' references and the next job on this
                        # input starts a fresh, freshly-budgeted cache
                        # (live readers keep serving their view — it
                        # references the cache object directly)
                        del self._caches[key]
                else:
                    entry["readers"].discard(job.id)
