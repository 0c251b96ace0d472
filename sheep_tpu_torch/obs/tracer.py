"""Hierarchical span tracer and counter registry (the port's copy of
``sheep_tpu/obs/tracer.py``).

A traced run renders as a tree: every span carries an id and its parent's
id, so ``span("build") > span("segment", i=k)`` nests in the JSONL as it
nested in time. The records are the reference's:

    {"event": "span_start", "ts": ..., "span": "build", "id": 3,
     "parent": 1, ...attrs}
    {"event": "span_end", "ts": ..., "span": "build", "id": 3,
     "parent": 1, "secs": 8.21, "counters": {"host_syncs": 4, ...}}

``counters`` on span_end is the delta of the tracer's registry between
the span's start and its end; ``error`` names the exception that unwound
a span used as a context manager. A span that never ends (the process was
killed) leaves its span_start as the last word on where the run died,
which ``tools/trace_report.py`` flags ``UNCLOSED``. Closing the tracer
writes one ``counters`` record of the final totals.

Spans are context managers, and also expose ``start()``/``end()`` so that
a loop can bracket its work without re-indenting
(``sp = obs.begin("segment", i=k); ...; sp.end(rounds=r)``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import IO, Optional, Union

from sheep_tpu_torch.utils.metrics import MetricsWriter


class CounterRegistry(dict):
    """Named counters and gauges. A plain dict on purpose: the drivers'
    stats dicts (``stats["host_syncs"]`` in ``ops/elim.py``) absorb
    without adaptation, and ``snapshot``/``delta`` give the spans and the
    heartbeat their view."""

    def inc(self, name: str, v=1) -> None:
        self[name] = self.get(name, 0) + v

    def gauge(self, name: str, v) -> None:
        self[name] = v

    def absorb(self, stats: dict) -> None:
        """Overwrite-merge a cumulative stats dict: re-absorbing the same
        dict is idempotent, the registry holds its latest totals."""
        for k, v in stats.items():
            self[k] = v

    def snapshot(self) -> dict:
        return dict(self)

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Numeric keys: after - before (left out when zero). Other keys
        (mode strings): included when changed."""
        out = {}
        for k, v in after.items():
            v0 = before.get(k, 0 if isinstance(v, (int, float))
                            and not isinstance(v, bool) else None)
            if (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and isinstance(v0, (int, float))
                    and not isinstance(v0, bool)):
                d = v - v0
                if d:
                    out[k] = round(d, 6) if isinstance(d, float) else d
            elif v0 != v:
                out[k] = v
        return out


class StatsAccumulator:
    """Bridge from one run's cumulative stats dict into a registry.

    A stats dict grows within one partition call, and each call starts a
    fresh one: several calls under one tracer (the hierarchy's levels, the
    CLI's runs) must sum into the registry, not overwrite it. Each
    ``absorb`` adds only the increment since this accumulator's previous
    one; create one per stats dict, at the start of the run that owns it.
    Non-numeric values overwrite."""

    __slots__ = ("_reg", "_last")

    def __init__(self, registry: CounterRegistry):
        self._reg = registry
        self._last: dict = {}

    def absorb(self, stats: dict) -> None:
        for k, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                prev = self._last.get(k, 0)
                if not isinstance(prev, (int, float)) \
                        or isinstance(prev, bool):
                    prev = 0
                d = v - prev
                if d:
                    self._reg[k] = self._reg.get(k, 0) + d
            else:
                self._reg[k] = v
            self._last[k] = v


class NullStatsAccumulator:
    __slots__ = ()

    def absorb(self, stats: dict) -> None:
        pass


NULL_STATS = NullStatsAccumulator()

# no explicit parent given: take the calling thread's enclosing span (None
# is a valid explicit parent, a root)
_STACK_PARENT = object()


class Span:
    """One traced interval, a context manager or ``start()``/``end()``.

    By default a span parents to the enclosing span on its thread's stack
    and joins that stack. A detached span (``attach=False``, its parent
    given) does neither: the form for intervals that interleave on one
    thread instead of nesting."""

    __slots__ = ("_tracer", "name", "attrs", "id", "parent", "_t0",
                 "_snap", "_done", "_parent_arg", "_attach")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 parent=_STACK_PARENT, attach: bool = True):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = None
        self.parent = None
        self._t0 = 0.0
        self._snap: dict = {}
        self._done = False
        self._parent_arg = parent
        self._attach = attach

    def start(self) -> "Span":
        tr = self._tracer
        self.parent = tr._current_id() \
            if self._parent_arg is _STACK_PARENT else self._parent_arg
        self.id = tr._next_id()
        self._snap = tr.counters.snapshot()
        if self._attach:
            tr._push(self.id)
        tr.emit("span_start", span=self.name, id=self.id,
                parent=self.parent, **self.attrs)
        self._t0 = time.perf_counter()
        return self

    def annotate(self, **attrs) -> None:
        """Attributes for the span_end record of a running span (its
        span_start is out already)."""
        self.attrs.update(attrs)

    def end(self, **extra) -> None:
        if self._done or self.id is None:
            return
        self._done = True
        tr = self._tracer
        secs = time.perf_counter() - self._t0
        if self._attach:
            tr._pop(self.id)
        fields = dict(span=self.name, id=self.id, parent=self.parent,
                      secs=round(secs, 6), **self.attrs)
        fields.update(extra)
        delta = CounterRegistry.delta(self._snap, tr.counters)
        if delta:
            fields["counters"] = delta
        tr.emit("span_end", **fields)

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, et, ev, tb) -> bool:
        self.end(**({"error": et.__name__} if et is not None else {}))
        return False


class NullSpan:
    """The span of an untraced run: every operation is a no-op on a shared
    instance."""

    __slots__ = ()

    def start(self) -> "NullSpan":
        return self

    def annotate(self, **attrs) -> None:
        pass

    def end(self, **extra) -> None:
        pass

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = NullSpan()


class Tracer:
    """JSONL sink of one run's spans, counters and heartbeats.

    Span ids come from an atomic counter and the span stack is
    thread-local: a span opened on a worker thread parents to that
    thread's enclosing span, or to none. ``progress`` is a plain dict that
    the instrumented loops update and the heartbeat thread reads, single
    fields only. The :class:`MetricsWriter` underneath serializes
    concurrent emits."""

    def __init__(self, dest: Union[str, IO]):
        self._mw = MetricsWriter(dest)
        self.counters = CounterRegistry()
        self.progress: dict = {}
        self.heartbeat = None  # a Heartbeat its owner starts and stops
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._closed = False

    def emit(self, event: str, **fields) -> None:
        self._mw.emit(event, **fields)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def begin(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs).start()

    def begin_detached(self, name: str, parent=None,
                       remote_parent=None, **attrs) -> Span:
        """A detached span: explicit ``parent`` id (None: a root), on no
        thread's stack. ``remote_parent``, a propagated
        ``{"trace": ..., "span": ...}`` of another process, adds the
        ``trace`` and ``remote_parent`` attributes that
        ``tools/trace_report.py --stitch`` grafts by (an all-zero remote
        span id: the caller had no span of its own)."""
        if remote_parent:
            attrs = dict(attrs)
            tid = remote_parent.get("trace")
            if tid:
                attrs.setdefault("trace", tid)
            rp = remote_parent.get("span")
            if rp and set(str(rp)) != {"0"}:
                attrs.setdefault("remote_parent", str(rp))
        return Span(self, name, attrs, parent=parent, attach=False).start()

    def current_span_id(self) -> Optional[int]:
        """The calling thread's innermost open span id (None at a root)."""
        return self._current_id()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _current_id(self) -> Optional[int]:
        st = self._stack()
        return st[-1] if st else None

    def _next_id(self) -> int:
        return next(self._ids)  # itertools.count: atomic under the GIL

    def _push(self, span_id: int) -> None:
        self._stack().append(span_id)

    def _pop(self, span_id: int) -> None:
        st = self._stack()
        # an end out of order (a leaked handle) pops through to its span,
        # so later parents stay right
        while st and st[-1] != span_id:
            st.pop()
        if st:
            st.pop()

    def close(self) -> None:
        """Write the final counter totals (one ``counters`` record) and
        close the sink."""
        if self._closed:
            return
        self._closed = True
        if self.counters:
            self.emit("counters", **self.counters.snapshot())
        self._mw.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
