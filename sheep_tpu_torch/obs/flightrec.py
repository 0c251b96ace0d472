"""Always-on bounded flight recorder (the port's copy of
``sheep_tpu/obs/flightrec.py``).

Full tracing (``--trace``) prices every span and counter onto every
request; with it off, a failed served job used to die with no record
of its last moments. The flight recorder is the middle path: a ring
buffer of the last N span/counter/fault events per job (plus one
global daemon ring), fed by the same :func:`sheep_tpu_torch.obs.event`
facade the fault/retry/scheduler paths already call, cheap enough to
leave on for every request — one dict build and one deque append per
event, zero I/O — and dumped to the trace sink only when something
goes wrong:

- a job reaches FAILED (the scheduler dumps that job's ring);
- a fault is injected (``fault_inject``/``chaos_inject`` events
  trigger an immediate dump, so the ring's tail at the moment of
  injection is preserved even if retries later succeed);
- the daemon shuts down (the global ring + any still-active jobs).

A dump is one ``flight_dump`` trace event carrying the buffered
events; ``tools/trace_report.py --last-errors`` renders them next to
the UNCLOSED-span forensics. With no tracer installed the dump
degrades to one compact stderr line — post-mortem evidence beats
silence even untraced.

Event routing: an event carrying a ``job`` field lands in that job's
ring; otherwise it lands in the ring of the thread's current job
context (the scheduler brackets each dispatch step with
:meth:`FlightRecorder.job_context`, so engine/retry events emitted
mid-step attribute correctly without every call site learning about
jobs), else in the global ring.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import List, Optional

# events that ARE the forensic payload of a dump; recording one
# triggers an immediate dump of the owning ring
DUMP_TRIGGER_EVENTS = frozenset({"fault_inject", "chaos_inject"})

# never recorded: a dump re-entering the recorder would nest dumps
# inside dumps forever
_SELF_EVENTS = frozenset({"flight_dump"})

GLOBAL_RING = "_daemon"


class FlightRecorder:
    """Bounded per-job + global event rings; see module docstring.

    Memory bound is hard: at most ``max_jobs`` job rings of
    ``per_job`` events each plus one ``global_events`` ring — oldest
    job rings are evicted wholesale when a new job would exceed the
    cap, so a resident daemon cannot grow with traffic."""

    def __init__(self, per_job: int = 64, max_jobs: int = 64,
                 global_events: int = 256):
        self.per_job = int(per_job)
        self.max_jobs = int(max_jobs)
        self._lock = threading.Lock()
        self._rings: "OrderedDict[str, deque]" = OrderedDict()
        self._global: deque = deque(maxlen=int(global_events))
        self._ctx = threading.local()
        # job id -> propagated trace id: bounded by the
        # ring eviction below, so it cannot grow with traffic either
        self._traces: dict = {}
        self.dumps = 0  # dumps emitted (scrape-able via collector)

    # -- context -------------------------------------------------------
    def current_job(self) -> Optional[str]:
        """The calling thread's job context, if any — captured by
        worker-spawning primitives (utils/prefetch.py) so events
        emitted on THEIR threads still attribute to the job whose step
        created them."""
        return getattr(self._ctx, "job", None)

    @contextmanager
    def job_context(self, job_id: str):
        """Attribute events recorded on THIS thread (without an
        explicit ``job`` field) to ``job_id`` for the duration — the
        scheduler wraps each dispatch step in one."""
        prev = getattr(self._ctx, "job", None)
        self._ctx.job = job_id
        try:
            yield
        finally:
            self._ctx.job = prev

    # -- recording -----------------------------------------------------
    def record(self, kind: str, fields: dict) -> None:
        """One event into the owning ring (see module docstring for
        routing). Called by the obs facade on EVERY obs.event — must
        stay allocation-light and never raise."""
        if kind in _SELF_EVENTS:
            return
        job = fields.get("job") or getattr(self._ctx, "job", None)
        rec = {"t": round(time.time(), 3), "ev": kind}
        rec.update(fields)
        with self._lock:
            if job is None:
                self._global.append(rec)
            else:
                ring = self._rings.get(job)
                if ring is None:
                    ring = deque(maxlen=self.per_job)
                    self._rings[job] = ring
                    while len(self._rings) > self.max_jobs:
                        evicted, _ = self._rings.popitem(last=False)
                        self._traces.pop(evicted, None)
                ring.append(rec)
        if kind in DUMP_TRIGGER_EVENTS:
            self.dump(job, reason=f"{kind}:"
                      f"{fields.get('kind', fields.get('phase', '?'))}")

    def events(self, job_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            if job_id is None:
                return list(self._global)
            return list(self._rings.get(job_id, ()))

    def set_trace(self, job_id: str, trace_id: Optional[str]) -> None:
        """Associate a propagated trace id with ``job_id``
        so that job's dumps can name the fleet request the ring
        belonged to (``trace_report --last-errors`` prints it)."""
        if not trace_id:
            return
        with self._lock:
            self._traces[job_id] = str(trace_id)

    def forget(self, job_id: str) -> None:
        with self._lock:
            self._rings.pop(job_id, None)
            self._traces.pop(job_id, None)

    def jobs(self) -> List[str]:
        with self._lock:
            return list(self._rings)

    # -- dumping -------------------------------------------------------
    def dump(self, job_id: Optional[str] = None,
             reason: str = "") -> Optional[dict]:
        """Emit one ``flight_dump`` record for the named ring (global
        when None) through the active tracer — or one compact stderr
        line when untraced. Returns the record (None when the ring is
        empty: nothing happened, nothing to dump)."""
        evs = self.events(job_id)
        if not evs:
            return None
        rec = {"job": job_id or GLOBAL_RING, "reason": reason,
               "n_events": len(evs), "events": evs}
        with self._lock:
            trace = self._traces.get(job_id) if job_id else None
            self.dumps += 1
        if trace:
            rec["trace"] = trace
        from sheep_tpu_torch import obs

        tr = obs.get_tracer()
        if tr is not None:
            try:
                tr.emit("flight_dump", **rec)
            except Exception:
                pass  # forensics must never become the failure
        else:
            tail = ", ".join(e["ev"] for e in evs[-8:])
            print(f"sheep flight-recorder [{rec['job']}] {reason}: "
                  f"last {len(evs)} events: {tail}",
                  file=sys.stderr)
        return rec

    def dump_all(self, reason: str = "shutdown") -> int:
        """Dump the global ring plus every retained job ring (the
        daemon-shutdown sweep); returns how many dumps were emitted."""
        n = 0
        for jid in [None] + self.jobs():
            if self.dump(jid, reason=reason) is not None:
                n += 1
        return n
