"""Typed live-metric registry with Prometheus text rendering (the
port's copy of ``sheep_tpu/obs/metrics.py``; its rendering is the
reference's, ``tests/golden/metrics_prom.txt``).

The obs spine's :class:`~sheep_tpu_torch.obs.tracer.CounterRegistry` is a
*trace* artifact: its values surface as span-boundary deltas and
heartbeat snapshots inside a JSONL file that tools read after the fact.
A scraper (or the ROADMAP's future membudget-aware router) needs the
opposite shape — typed, labeled, LIVE series answered at poll time:

- :class:`Counter` — monotonically increasing totals (jobs submitted,
  admission rejections, dispatch retries);
- :class:`Gauge` — point-in-time levels (queue depth, reserved bytes,
  device-memory headroom);
- :class:`Histogram` — fixed-bucket latency distributions with
  cumulative ``_bucket``/``_sum``/``_count`` rendering and quantile
  estimation, the SLO primitive (per-tenant request latency
  queued->done).

All three support Prometheus-style labels; :class:`MetricRegistry`
owns them and renders the exposition text
(``text/plain; version=0.0.4``) that the sheepd ``metrics`` verb and
the ``GET /metrics`` HTTP listener answer. ``add_collector`` registers
scrape-time callbacks so values that already live elsewhere — the
scheduler's queue/reservation state, the active tracer's
CounterRegistry, the card's memory stats — are absorbed as live gauges
at poll time instead of being mirrored on every mutation.

Deliberately dependency-free (stdlib only): the thin client and
``sheeptop`` parse/render these without an accelerator stack, and the
disabled path costs nothing (no instrument exists unless something
created it).
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# SLO-ish request-latency buckets: sub-10ms protocol ops through
# multi-minute cold builds. Fixed (not configurable per call site) so
# series from different daemons always merge.
DEFAULT_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

# Cut-ratio buckets for the sheep_quality_* histograms:
# log-ish spacing over [0, 1] — planted-recovery cuts live at 0.01-0.1,
# expander cuts at 0.9+, and the interesting regressions are small
# relative moves near the bottom. Fixed for the same merge reason.
DEFAULT_RATIO_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.4,
    0.6, 0.8, 0.95)

# Balance buckets: 1.0 is perfect, the --balance contract band is
# 1.05-1.3, and past 2 the split is degenerate.
DEFAULT_BALANCE_BUCKETS = (
    1.01, 1.02, 1.05, 1.1, 1.2, 1.3, 1.5, 2.0, 3.0, 5.0)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary counter key into a legal metric name."""
    name = _NAME_FIX.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v) -> str:
    """Prometheus sample value: integers without a trailing .0, floats
    via repr (full precision), +Inf spelled the exposition way."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names: Tuple[str, ...], values: Tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Shared shape: one metric family = name + help + label names +
    a dict of label-value tuples -> sample state. The registry's lock
    guards every mutation (scrapes race increments from the dispatch
    and handler threads). Scalar-valued kinds (counter/gauge) share
    the render/value implementations; Histogram overrides render."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...], lock: threading.Lock):
        if not _NAME_OK.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._samples: Dict[Tuple, object] = {}

    def _key(self, labels: dict) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(labels[n] for n in self.labelnames)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()

    def value(self, **labels):
        with self._lock:
            return self._samples.get(self._key(labels), 0)

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted(self._samples.items())
        for key, v in items:
            out.append(f"{self.name}"
                       f"{_label_str(self.labelnames, key)} {_fmt(v)}")


class Counter(_Metric):
    """Monotonic total. ``inc`` only — a counter that can go down is a
    gauge wearing the wrong type and breaks every rate() query."""

    kind = "counter"

    def inc(self, v=1, **labels) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0) + v


class Gauge(_Metric):
    """Point-in-time level; ``set`` wins, ``inc``/``dec`` for levels
    maintained by paired events."""

    kind = "gauge"

    def set(self, v, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._samples[key] = v

    def inc(self, v=1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0) + v

    def dec(self, v=1, **labels) -> None:
        self.inc(-v, **labels)

    def remove(self, **labels) -> None:
        """Drop one labeled series (a finished job's progress gauge
        must leave the scrape, not freeze at its last value)."""
        with self._lock:
            self._samples.pop(self._key(labels), None)


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (NOT cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram. ``buckets`` are the finite upper bounds
    (ascending); a +Inf bucket is always appended. Prometheus ``le``
    semantics: an observation equal to a bound lands in THAT bucket
    (v <= upper). Rendering is cumulative, as scrapers expect."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(float(b) for b in
                   (DEFAULT_LATENCY_BUCKETS if buckets is None
                    else buckets))
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])) \
                or any(math.isinf(b) for b in bs):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"finite strictly-ascending uppers; "
                             f"+Inf is implicit")
        self.buckets = bs  # finite uppers; index len(bs) is +Inf

    def observe(self, v, **labels) -> None:
        key = self._key(labels)
        v = float(v)
        # bisect_left gives the first bucket whose upper >= v, which is
        # exactly `le` membership; past the end = the +Inf bucket
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            st = self._samples.get(key)
            if st is None:
                st = self._samples[key] = _HistState(
                    len(self.buckets) + 1)
            st.counts[idx] += 1
            st.sum += v
            st.count += 1

    def snapshot(self, **labels) -> Optional[dict]:
        """{"cum": cumulative counts incl +Inf, "sum": s, "count": n}
        for one labeled series, or None when never observed."""
        with self._lock:
            st = self._samples.get(self._key(labels))
            if st is None:
                return None
            counts = list(st.counts)
            total, s = st.count, st.sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"cum": cum, "sum": s, "count": total}

    def quantile(self, q: float, **labels) -> Optional[float]:
        snap = self.snapshot(**labels)
        if snap is None or snap["count"] == 0:
            return None
        return quantile_from_cumulative(self.buckets, snap["cum"], q)

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = [(k, list(st.counts), st.sum, st.count)
                     for k, st in sorted(self._samples.items())]
        uppers = [_fmt(b) for b in self.buckets] + ["+Inf"]
        for key, counts, s, n in items:
            acc = 0
            for upper, c in zip(uppers, counts):
                acc += c
                names = self.labelnames + ("le",)
                out.append(f"{self.name}_bucket"
                           f"{_label_str(names, key + (upper,))} {acc}")
            ls = _label_str(self.labelnames, key)
            out.append(f"{self.name}_sum{ls} {_fmt(s)}")
            out.append(f"{self.name}_count{ls} {n}")


def quantile_from_cumulative(uppers, cum_counts, q: float
                             ) -> Optional[float]:
    """Estimate the q-quantile from cumulative bucket counts (finite
    ``uppers`` + one trailing +Inf count), linearly interpolating
    within the landing bucket — the promql ``histogram_quantile``
    estimator, reusable by sheeptop on parsed scrape text. An estimate
    that lands in the +Inf bucket returns the largest finite upper
    (the honest answer: "at least this")."""
    if not cum_counts:
        return None
    total = cum_counts[-1]
    if total <= 0:
        return None
    q = min(1.0, max(0.0, float(q)))
    rank = q * total
    for i, c in enumerate(cum_counts):
        if c >= rank and c > 0:
            if i >= len(uppers):     # +Inf bucket
                return float(uppers[-1]) if uppers else None
            lo = float(uppers[i - 1]) if i > 0 else 0.0
            hi = float(uppers[i])
            prev = cum_counts[i - 1] if i > 0 else 0
            in_bucket = c - prev
            if in_bucket <= 0:
                return hi
            frac = (rank - prev) / in_bucket
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
    return float(uppers[-1]) if uppers else None


class MetricRegistry:
    """Typed metric families + scrape-time collectors, rendered as one
    Prometheus text document. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent by name; a kind or label mismatch on an
    existing name raises — two call sites disagreeing about a metric's
    type is a bug, not a merge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, _Metric]" = {}
        self._collectors: List[Callable[[], object]] = []

    # -- registration --------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) \
                        or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn: Callable[[], object]) -> None:
        """Register a scrape-time callback. It may return a plain
        ``{name: value}`` dict (rendered as unlabeled gauges) or an
        iterable of ``(name, labels_dict, value)`` samples. A collector
        that raises is skipped for that scrape (a flaky device-memory
        probe must not take down the whole exposition)."""
        with self._lock:
            self._collectors.append(fn)

    # -- rendering -----------------------------------------------------
    def render(self) -> str:
        """The full exposition document: registered families in
        registration order, then collector gauges grouped by name."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: List[str] = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m.render(out)
        collected: "Dict[str, List[Tuple[Tuple, Tuple, object]]]" = {}
        for fn in collectors:
            try:
                produced = fn()
            except Exception:
                continue  # one flaky probe must not kill the scrape
            if produced is None:
                continue
            if isinstance(produced, dict):
                produced = [(k, {}, v) for k, v in produced.items()]
            for name, labels, value in produced:
                if not isinstance(value, (int, float)) \
                        or isinstance(value, bool):
                    continue
                name = sanitize_name(name)
                names = tuple(sorted(labels))
                vals = tuple(labels[n] for n in names)
                collected.setdefault(name, []).append(
                    (names, vals, value))
        for name in sorted(collected):
            out.append(f"# TYPE {name} gauge")
            for names, vals, value in sorted(collected[name]):
                out.append(f"{name}{_label_str(names, vals)} "
                           f"{_fmt(value)}")
        return "\n".join(out) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r'\\(.)')


def _unescape_label(s: str) -> str:
    # one scan, not sequential replaces: '\\' followed by 'n' is a
    # literal backslash + n, and a chained .replace would eat half of
    # the escaped backslash and fabricate a newline
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), s)


def parse_prometheus(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """Parse exposition text back into ``{name: [(labels, value)]}`` —
    what sheeptop (and tests) consume. Tolerant: comment and
    unparseable lines are skipped, values that aren't numbers are
    skipped. ``+Inf``/``NaN`` come back as the float they are."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        raw = m.group("value")
        try:
            value = float(raw.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            continue
        labels = {}
        if m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def histogram_series_quantile(samples: List[Tuple[dict, float]],
                              q: float,
                              match: Optional[dict] = None
                              ) -> Optional[float]:
    """Quantile straight from parsed ``<name>_bucket`` samples (the
    sheeptop path): filter by the ``match`` labels, order by ``le``,
    interpolate. Returns None when no matching buckets exist."""
    rows = []
    for labels, value in samples:
        if match is not None and any(labels.get(k) != v
                                     for k, v in match.items()):
            continue
        le = labels.get("le")
        if le is None:
            continue
        rows.append((float(le.replace("+Inf", "inf")), value))
    if not rows:
        return None
    rows.sort()
    uppers = [u for u, _ in rows if not math.isinf(u)]
    cum = [int(c) for _, c in rows]
    return quantile_from_cumulative(uppers, cum, q)
