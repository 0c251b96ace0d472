"""The served engine's wire protocol (the port's copy of
``sheep_tpu/server/protocol.py``): newline-delimited JSON over a local
socket, byte for byte the reference's, so that either package's client
talks to either package's daemon.

The one difference is ``update_backend``, the backend a resident job's
delta epochs fold with: the port's backends are ``torch``,
``torch-sharded`` and ``torch-bigv``, and the reference's names ``tpu``,
``tpu-sharded`` and ``tpu-bigv`` are accepted as theirs
(:data:`UPDATE_BACKEND_ALIASES`). ``pure`` and ``cpu`` name backends the
port does not have and are refused. A job's digest
(``journal.job_digest``) is taken over the reference's names, so the
same request has the same digest in both packages.

One request per line, one response per line, strictly in order per
connection (a client may pipeline). Every response carries ``ok``:
``{"ok": true, ...}`` or ``{"ok": false, "error": "..."}`` — a
malformed request is answered, never dropped, and never kills the
connection, let alone the daemon.

Requests (``op`` selects):

    {"op": "ping"}
    {"op": "submit", "tenant": "alice", "job": {...JobSpec fields...},
     "reattach": false}
    {"op": "status", "job_id": "j3"}
    {"op": "wait",   "job_id": "j3", "timeout_s": 30}
    {"op": "cancel", "job_id": "j3"}
    {"op": "list"}
    {"op": "stats"}
    {"op": "metrics"}
    {"op": "profile", "dir": "/tmp/prof", "steps": 8}
    {"op": "update",  "job_id": "j3", "adds": {edges b64},
     "dels": {edges b64}, "epoch": 7, "score": false}
    {"op": "update",  "job_id": "j3", "log": "/path/g.dlog"}
    {"op": "update",  "job_id": "j3", "stream": "begin"}
    {"op": "update",  "txn": "u1", "stream": "chunk",
     "adds": {edges b64}, "dels": {edges b64}}
    {"op": "update",  "txn": "u1", "stream": "commit", "epoch": 7,
     "score": false, "compact": "auto"}
    {"op": "update",  "txn": "u1", "stream": "abort"}
    {"op": "epoch",   "job_id": "j3"}
    {"op": "compact", "job_id": "j3", "mode": "auto", "score": false}
    {"op": "shutdown", "drain": false, "suspend": false}
    {"op": "lookup", "digest": "<hex job digest>"}

Fleet verbs: ``lookup`` asks whether this replica's
content-addressed result store holds an entry for a job digest —
``{"ok": true, "hit": true|false}`` — without submitting anything. A
multi-endpoint client probes every replica with it first; a hit
short-circuits headroom routing entirely (the repeat submit answers
from the store with zero build steps and zero recompiles).

Incremental verbs: a job submitted with ``"resident":
true`` keeps its converged partition state resident after DONE —
admission keeps charging its modeled bytes to the membudget model
until the tenant releases it (``cancel`` on the DONE job). The tenant
then streams deltas at it: ``update`` folds an epoch of adds /
tombstones into the carried table in O(Δ) (inline base64 edge
payloads, bounded by the 1 MiB request line — ~20k edges per request
— or ``"log"`` naming a daemon-side delta log whose epochs past the
resident epoch all apply). Explicit ``epoch`` numbers make updates
IDEMPOTENT: an epoch at or below the resident epoch answers
``applied: false`` without refolding — the retry/replay contract.
``epoch`` queries the resident epoch/staleness; ``compact`` runs the
tombstone compaction (``mode`` auto/full/subtree, plus ``rebase`` on
a durable daemon: full compaction that REWRITES the base into a fresh
CSR artifact under the checkpoint dir, so the tombstone filter and
anchored history stay O(recent)). On a durable daemon every applied
epoch checkpoints the resident state and journals a ``delta_epoch``
record, so a SIGKILL'd daemon resumes the resident partition at its
last applied epoch bit-identically.

Chunked update framing: one epoch larger than the 1 MiB
request line streams through ``update`` sub-verbs selected by
``stream``. ``begin`` (carries ``job_id``) opens a transaction and
answers ``{"txn": "u1"}``; any number of ``chunk`` requests append
inline ``adds``/``dels`` payloads (each request still under the line
cap) to that txn; ``commit`` applies the accumulated delta as ONE
epoch through the normal update path (same answer shape, same
idempotent ``epoch`` semantics) and ``abort`` discards it.
Transactions are connection-scoped and staged host-side only: a
client that dies mid-stream (no commit) changes NOTHING — the
resident stays at its prior epoch and the whole txn is idempotently
retryable from ``begin``. Accumulation per txn is capped
(:data:`MAX_UPDATE_TXN_BYTES`) so a runaway stream cannot balloon the
daemon's host memory.

Durability verbs: ``submit`` with ``"reattach": true`` is
IDEMPOTENT — the daemon digests the spec (plus the input's content
identity) and, when a queued/running/done twin exists (journaled jobs
from before a restart included), answers that job's id with
``"reattached": true`` instead of building again; failed/cancelled/
rejected twins do not match (a fresh submit is the retry for those).
``shutdown`` with ``"suspend": true`` (durable daemons only;
``grace_s`` optional) is the graceful drain: stop admitting,
checkpoint running jobs at their next flush barrier, journal the
handoff, exit 0 — the restarted daemon resumes them. Job ids are
stable across restarts (the journal floors the id counter), so a
pre-restart ``job_id`` keeps working in status/wait/cancel; a
journal-replayed DONE job answers its journaled result summaries,
without assignment payloads (use ``output`` for those).

Trace context: every request may carry an optional
top-level ``trace`` field — a W3C-traceparent-shaped string
``"00-<32 hex trace id>-<16 hex parent span id>-01"`` minted by the
client once per LOGICAL request (a fleet submit keeps one trace id
across failover resubmits; waits/updates reuse the submit's). The
daemon threads it into the job's detached span and flight-recorder
ring, so one trace id stitches the client's route/failover spans and
every replica's job spans into one cross-process tree
(``tools/trace_report.py --stitch``). An all-zero parent span id
means "the client had no span of its own" (untraced client); the
trace id still correlates. The field is OPTIONAL and additive: old
clients never send it, old daemons ignore it — it is not a job field
and never affects the job digest (:func:`make_traceparent` /
:func:`parse_traceparent` are the codec).

Telemetry verbs: ``metrics`` answers ``{"ok": true,
"content_type": ..., "text": "<Prometheus exposition>"}`` — the same
document the daemon's optional HTTP ``GET /metrics`` listener
(``--metrics-port``) serves, with per-tenant request-latency
histograms, queue/reservation gauges and per-active-job progress.
``profile`` arms an on-demand ``torch.profiler`` capture of the next
``steps`` dispatch steps into ``dir`` (daemon-side path); the answer
confirms arming, capture progress is queryable under ``stats``'s
``profile`` field. Job descriptors carry live ``phase`` + ``steps``
progress fields while running (what ``sheep-submit --watch`` and
``sheeptop`` poll).

Job lifecycle (:data:`JOB_STATES`)::

    queued ----> running ----> done | failed | deadline_exceeded
       |            |
       |            +--------> cancelled
       +--> cancelled | rejected

``rejected`` is the admission scheduler's verdict for a job whose
modeled device footprint exceeds the daemon's whole budget even at the
fully degraded dispatch shape (membudget.build_phase_bytes at
dispatch_batch=1); ``queued`` jobs fit the budget but not the current
free headroom and run when earlier jobs release it.

Deadline semantics: ``deadline_s`` is measured from SUBMIT (queue wait
counts — the client asked for a result by then, not for a start). An
expired job reports ``deadline_exceeded`` whether it was still queued
or mid-build; expiry cancels only that job's step generator, never the
dispatch chain (other jobs' carried tables are untouched).

Assignments travel base64-packed (little-endian int32) only when the
submitter asked (``return_assignment``) — scores always travel.
"""

from __future__ import annotations

import base64
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# terminal states never transition again
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
DEADLINE_EXCEEDED = "deadline_exceeded"
REJECTED = "rejected"

JOB_STATES = (QUEUED, RUNNING, DONE, FAILED, CANCELLED,
              DEADLINE_EXCEEDED, REJECTED)
TERMINAL_STATES = (DONE, FAILED, CANCELLED, DEADLINE_EXCEEDED, REJECTED)

OPS = ("ping", "submit", "status", "wait", "cancel", "list", "stats",
       "metrics", "profile", "update", "epoch", "compact", "shutdown",
       "lookup")

MAX_REQUEST_BYTES = 1 << 20  # one request line; jobs are specs, not data

# chunked-update framing: the sub-verbs of {"op": "update",
# "stream": ...} and the per-transaction staging cap — 256 MiB of raw
# edge payload (16 bytes/edge, ~16M edges) per uncommitted txn
UPDATE_STREAM_VERBS = ("begin", "chunk", "commit", "abort")
MAX_UPDATE_TXN_BYTES = 256 << 20


class ProtocolError(ValueError):
    """Malformed request — answered with ok=false, never fatal."""


# the port's update backends, and the reference's names for them
UPDATE_BACKENDS = ("torch", "torch-sharded", "torch-bigv")
UPDATE_BACKEND_ALIASES = {"tpu": "torch", "tpu-sharded": "torch-sharded",
                          "tpu-bigv": "torch-bigv"}
# the reference's name of each port backend: what the digest hashes
REFERENCE_BACKEND_NAMES = {v: k for k, v in UPDATE_BACKEND_ALIASES.items()}


def normalize_update_backend(name) -> str:
    """The port's name of an ``update_backend``: a port name passes, a
    reference name maps to the port's; anything else, ``pure`` and
    ``cpu`` included, raises :class:`ProtocolError`."""
    name = str(name)
    name = UPDATE_BACKEND_ALIASES.get(name, name)
    if name not in UPDATE_BACKENDS:
        raise ProtocolError(
            f"job.update_backend must be one of "
            f"{'/'.join(UPDATE_BACKENDS)} (or the reference's "
            f"{'/'.join(UPDATE_BACKEND_ALIASES)}); got {name!r}")
    return name


# -- trace context ------------------------------------------
# W3C-traceparent-shaped: version "00", 32-hex trace id, 16-hex parent
# span id, flags "01" (sampled — sheep traces everything it traces).
_NO_SPAN = "0" * 16
_TRACEPARENT_RE = re.compile(
    r"^00-(?P<trace>[0-9a-f]{32})-(?P<span>[0-9a-f]{16})-[0-9a-f]{2}$")


def mint_trace_id() -> str:
    """A fresh 32-hex trace id — one per LOGICAL client request (a
    failover resubmit is the same logical request and reuses it)."""
    return os.urandom(16).hex()


def make_traceparent(trace_id: str, span_id=None) -> str:
    """Render the wire ``trace`` field. ``span_id`` is the client-side
    parent span id — an int (local tracer span id), a hex string, or
    None for "no client span" (encoded as the all-zero span id)."""
    if span_id is None:
        span = _NO_SPAN
    elif isinstance(span_id, int):
        span = format(span_id & ((1 << 64) - 1), "016x")
    else:
        span = str(span_id).lower().rjust(16, "0")[-16:]
    return f"00-{trace_id}-{span}-01"


def parse_traceparent(value) -> Tuple[str, Optional[str]]:
    """Validate a wire ``trace`` field -> ``(trace_id, parent_span)``
    with ``parent_span`` None when the client sent the all-zero span
    id. Malformed values raise :class:`ProtocolError` — a daemon must
    answer "bad trace context", never silently mis-correlate."""
    if not isinstance(value, str):
        raise ProtocolError("trace must be a traceparent string")
    m = _TRACEPARENT_RE.match(value.lower())
    if m is None:
        raise ProtocolError(
            f"trace {value!r} is not 00-<32hex>-<16hex>-<2hex>")
    tid = m.group("trace")
    if set(tid) == {"0"}:
        raise ProtocolError("trace id must not be all zeros")
    span = m.group("span")
    return tid, (None if span == _NO_SPAN else span)


@dataclass
class JobSpec:
    """One partition request, validated at the protocol boundary so the
    scheduler only ever sees well-formed work."""

    input: str
    ks: list
    tenant: str = "default"
    chunk_edges: int = 1 << 22
    dispatch_batch: int = 0        # 0 = auto (membudget-sized)
    h2d_ring: int = 0              # 0 = auto (staged H2D ring depth)
    inflight: int = 0              # 0 = auto (in-job pipeline depth)
    segment_rounds: int = 2
    alpha: float = 1.0
    weights: str = "unit"
    comm_volume: bool = False
    num_vertices: Optional[int] = None
    deadline_s: Optional[float] = None
    output: Optional[str] = None   # daemon-side partition map path
    return_assignment: bool = False
    # hold the converged partition state resident after DONE so the
    # tenant can stream delta epochs at it; the reservation
    # stays charged until released via cancel
    resident: bool = False
    # backend the resident update path folds delta epochs with: the
    # sharded names route each epoch through the sharded lockstep fold
    # and the distributed rescore
    update_backend: str = "torch"
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        # a spec journaled by the reference names its own backends
        self.update_backend = UPDATE_BACKEND_ALIASES.get(
            self.update_backend, self.update_backend)

    @classmethod
    def from_request(cls, body: dict, tenant: str = "default") -> "JobSpec":
        if not isinstance(body, dict):
            raise ProtocolError("job must be an object")
        if not body.get("input"):
            raise ProtocolError("job.input is required")
        ks = body.get("k", body.get("ks"))
        if isinstance(ks, int):
            ks = [ks]
        if not isinstance(ks, list) or not ks \
                or not all(isinstance(k, int) and k >= 1 for k in ks):
            raise ProtocolError("job.k must be a positive int or a "
                               "non-empty list of them")
        ks = list(dict.fromkeys(ks))  # dupes would alias result rows
        known = {"input", "k", "ks", "chunk_edges", "dispatch_batch",
                 "h2d_ring", "inflight", "segment_rounds", "alpha",
                 "weights", "comm_volume", "num_vertices", "deadline_s",
                 "output", "return_assignment", "resident",
                 "update_backend"}
        unknown = set(body) - known
        if unknown:
            raise ProtocolError(f"unknown job field(s): {sorted(unknown)}")
        spec = cls(
            input=str(body["input"]), ks=ks, tenant=str(tenant),
            chunk_edges=int(body.get("chunk_edges", 1 << 22)),
            dispatch_batch=int(body.get("dispatch_batch", 0)),
            h2d_ring=int(body.get("h2d_ring", 0)),
            inflight=int(body.get("inflight", 0)),
            segment_rounds=int(body.get("segment_rounds", 2)),
            alpha=float(body.get("alpha", 1.0)),
            weights=str(body.get("weights", "unit")),
            comm_volume=bool(body.get("comm_volume", False)),
            num_vertices=(None if body.get("num_vertices") is None
                          else int(body["num_vertices"])),
            deadline_s=(None if body.get("deadline_s") is None
                        else float(body["deadline_s"])),
            output=(None if body.get("output") is None
                    else str(body["output"])),
            return_assignment=bool(body.get("return_assignment", False)),
            resident=bool(body.get("resident", False)),
            update_backend=str(body.get("update_backend", "torch")),
        )
        if spec.chunk_edges < 1:
            raise ProtocolError("job.chunk_edges must be >= 1")
        if spec.dispatch_batch < 0:
            raise ProtocolError("job.dispatch_batch must be >= 0 "
                               "(0 = auto)")
        if spec.h2d_ring < 0:
            raise ProtocolError("job.h2d_ring must be >= 0 (0 = auto)")
        if spec.inflight < 0:
            raise ProtocolError("job.inflight must be >= 0 (0 = auto)")
        if spec.weights not in ("unit", "degree"):
            raise ProtocolError("job.weights must be 'unit' or 'degree'")
        if spec.deadline_s is not None and spec.deadline_s <= 0:
            raise ProtocolError("job.deadline_s must be > 0 seconds")
        if spec.alpha <= 0:
            raise ProtocolError("job.alpha must be > 0")
        spec.update_backend = normalize_update_backend(spec.update_backend)
        return spec


def encode_edges(edges) -> dict:
    """(m, 2) int edge array -> {"b64": ..., "m": ..., "dtype":
    "int64"} — the delta payload codec of the ``update`` verb.
    Bounded by MAX_REQUEST_BYTES at the line layer (~20k edges per
    request); stream larger deltas as multiple epochs or via the
    daemon-side ``log`` form."""
    e = np.asarray(edges, dtype="<i8").reshape(-1, 2)
    return {"b64": base64.b64encode(e.tobytes()).decode("ascii"),
            "m": int(len(e)), "dtype": "int64"}


def decode_edges(doc) -> np.ndarray:
    if doc is None:
        return np.zeros((0, 2), np.int64)
    if not isinstance(doc, dict) or "b64" not in doc:
        raise ProtocolError("edge payload must be {b64, m, dtype}")
    raw = base64.b64decode(doc["b64"])
    e = np.frombuffer(raw, dtype="<i8").astype(np.int64)
    if e.size != 2 * int(doc.get("m", e.size // 2)):
        raise ProtocolError(
            f"edge payload holds {e.size // 2} pairs, header says "
            f"{doc.get('m')}")
    return e.reshape(-1, 2)


def encode_assignment(assignment) -> dict:
    """int array[V] -> {"b64": ..., "n": V, "dtype": "int32"}."""
    a = np.asarray(assignment, dtype="<i4")
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "n": int(a.size), "dtype": "int32"}


def decode_assignment(doc: dict) -> np.ndarray:
    raw = base64.b64decode(doc["b64"])
    a = np.frombuffer(raw, dtype="<i4").astype(np.int32)
    if a.size != int(doc["n"]):
        raise ProtocolError(f"assignment payload holds {a.size} entries, "
                            f"header says {doc['n']}")
    return a


def dumps(doc: dict) -> bytes:
    return (json.dumps(doc, separators=(",", ":")) + "\n").encode()


def parse_request(line: bytes) -> dict:
    if len(line) > MAX_REQUEST_BYTES:
        raise ProtocolError("request line exceeds 1 MiB")
    try:
        doc = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad JSON request: {e}") from None
    if not isinstance(doc, dict):
        raise ProtocolError("request must be a JSON object")
    op = doc.get("op")
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r}; want one of {OPS}")
    return doc


def read_line(sock_file) -> Optional[bytes]:
    """One protocol line from a socket makefile; None on clean EOF.
    Bounded: a peer streaming an endless unterminated line cannot grow
    memory past the request cap."""
    line = sock_file.readline(MAX_REQUEST_BYTES + 2)
    if not line:
        return None
    if not line.endswith(b"\n") and len(line) > MAX_REQUEST_BYTES:
        raise ProtocolError("unterminated request line exceeds 1 MiB")
    return line.rstrip(b"\n")
