"""sheep_tpu_torch.obs — the observability of a run (the port's copy of
``sheep_tpu/obs/__init__.py``).

One module-level tracer that the backend, the drivers, the fault layer,
refinement, the hierarchy and the CLI report through:

- **spans**: timed intervals written as JSONL with parent ids, so a run
  renders as a tree (``tools/trace_report.py``);
- **counters**: a registry the drivers' stats dicts (``host_syncs``,
  ``device_rounds`` ...) absorb into, sampled as deltas at span
  boundaries and live by the heartbeat;
- **heartbeat**: a thread writing periodic progress records;
- **manifest**: config, versions, git SHA and the device of each traced
  run.

The instrumentation calls are unconditional at the call sites and cost
one read of a module global while tracing is off. Install a tracer (the
CLI's ``--trace``, or :func:`tracing`) and the same call sites write the
whole trace. Every value they pass is a host number already: an
instrumentation point never reads the device.

    from sheep_tpu_torch import obs

    acc = obs.stats_accumulator()            # one a stats dict
    with obs.span("build"):
        for i, chunk in enumerate(chunks):
            sp = obs.begin("segment", i=i)
            ...fold...
            acc.absorb(build_stats)
            obs.chunk_progress(i + 1, chunk_edges)
            sp.end(rounds=r)

The reference's flight recorder, metric registry and federation serve its
daemon, which the port does not have yet; :func:`flight_job` and
:func:`flight_job_context` stand for them as no-ops.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import IO, Optional, Union

from sheep_tpu_torch.obs.heartbeat import Heartbeat  # noqa: F401
from sheep_tpu_torch.obs.manifest import (collect_manifest,  # noqa: F401
                                          emit_manifest)
from sheep_tpu_torch.obs.tracer import (NULL_SPAN, NULL_STATS,  # noqa: F401
                                        CounterRegistry, NullSpan, Span,
                                        StatsAccumulator, Tracer)

_TRACER: Optional[Tracer] = None


def flight_job() -> Optional[str]:
    """The calling thread's flight-recorder job: None, there is none."""
    return None


def flight_job_context(job_id: Optional[str]):
    """A no-op context (no flight recorder in the port yet)."""
    return nullcontext()


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide active tracer."""
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> Optional[Tracer]:
    """Deactivate (and return) the active tracer without closing it."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """A context-manager span under the active tracer (the shared no-op
    while tracing is off)."""
    t = _TRACER
    return t.span(name, **attrs) if t is not None else NULL_SPAN


def begin(name: str, **attrs):
    """A started span, ended by ``.end()``: the form that brackets an
    existing block without re-indenting it."""
    t = _TRACER
    return t.begin(name, **attrs) if t is not None else NULL_SPAN


def begin_detached(name: str, parent=None, remote_parent=None, **attrs):
    """A started detached span, parented to ``parent`` (a span or its id;
    None: a root) instead of the calling thread's stack, and never on that
    stack (see :meth:`Tracer.begin_detached`)."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    if isinstance(parent, (Span, NullSpan)):
        parent = getattr(parent, "id", None)
    return t.begin_detached(name, parent=parent,
                            remote_parent=remote_parent, **attrs)


def current_span_id():
    """The calling thread's innermost open span id (None untraced or at a
    root)."""
    t = _TRACER
    return t.current_span_id() if t is not None else None


def absorb(stats: dict) -> None:
    """One overwrite-merge of a stats dict into the registry. A run's
    cumulative stats dict, absorbed chunk by chunk, goes through a
    :func:`stats_accumulator` instead, so that several runs sum."""
    t = _TRACER
    if t is not None:
        t.counters.absorb(stats)


def stats_accumulator():
    """A :class:`StatsAccumulator` on the active tracer's registry (the
    shared no-op while tracing is off): one a stats dict, made at the
    start of the run that owns it."""
    t = _TRACER
    return StatsAccumulator(t.counters) if t is not None else NULL_STATS


def inc(name: str, v=1) -> None:
    t = _TRACER
    if t is not None:
        t.counters.inc(name, v)


def gauge(name: str, v) -> None:
    t = _TRACER
    if t is not None:
        t.counters.gauge(name, v)


def progress(**fields) -> None:
    """Update the heartbeat's progress fields."""
    t = _TRACER
    if t is not None:
        t.progress.update(fields)


def chunk_progress(idx: int, chunk_edges: int, edges_total=None) -> None:
    """A chunk loop's progress: chunks done and the edges they imply
    (capped at the stream's total when it is known)."""
    t = _TRACER
    if t is None:
        return
    done = idx * chunk_edges
    t.progress.update(chunks_done=idx,
                      edges_done=min(done, edges_total)
                      if edges_total else done)


def event(name: str, **fields) -> None:
    """A free-form record through the active tracer (a no-op while
    tracing is off)."""
    t = _TRACER
    if t is not None:
        t.emit(name, **fields)


@contextmanager
def tracing(dest: Union[str, IO], heartbeat_secs: Optional[float] = None,
            device=None):
    """Scoped tracing for tests and tools: a fresh :class:`Tracer` on
    ``dest`` (a path or a writable handle), with a heartbeat when
    ``heartbeat_secs`` is given (its memory from ``device``); the previous
    tracer comes back and this one is closed on exit."""
    global _TRACER
    prev = _TRACER
    t = Tracer(dest)
    _TRACER = t
    hb = Heartbeat(t, heartbeat_secs, device=device).start() \
        if heartbeat_secs else None
    try:
        yield t
    finally:
        if hb is not None:
            hb.stop()
        _TRACER = prev
        t.close()
