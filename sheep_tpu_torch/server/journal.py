"""Crash-safe job journal for sheepd (the port's copy of
``sheep_tpu/server/journal.py``; a journal written by either package
replays the same in the other).

An append-only, newline-JSON write-ahead log of every job's lifecycle,
so a daemon crash or redeploy loses NOTHING that was admitted: on
startup the scheduler replays the journal, re-admits journaled queued
jobs, and re-admits journaled RUNNING jobs whose engines then resume
from their per-job checkpoints (``utils/checkpoint.Checkpointer``
child domains under the daemon's checkpoint dir).

Record grammar (one JSON object per line, ``rec`` selects)::

    {"v": 1, "rec": "daemon_start", "t": ..., "pid": ...}
    {"v": 1, "rec": "submit", "job_id": "j3", "t": ..., "tenant": ...,
     "digest": ..., "n_vertices": ..., "modeled_bytes": ...,
     "state": "queued"|"rejected", "error": ..., "spec": {...}}
    {"v": 1, "rec": "state", "job_id": "j3", "state": "running",
     "t": ...}
    {"v": 1, "rec": "terminal", "job_id": "j3", "state": "done",
     "t": ..., "error": ..., "results": [summaries]}
    {"v": 1, "rec": "drain", "t": ..., "suspended": [...],
     "queued": [...]}

Durability contract: ``submit`` and ``terminal`` records are fsync'd
(admission and terminal are the promises a client acts on); ``state``
records are buffered-flushed only — losing one merely replays the job
as queued, which the resume path treats as a clean start.

Replay is torn-tail tolerant like the edgestream's
``SHEEP_IO_POLICY=quarantine`` contract: a crash mid-append leaves at
most one torn trailing line, which replay drops with a warning. Damage
*before* the tail follows the IO policy proper (strict = raise,
quarantine = warn + skip). Records from a NEWER journal version, or of
an unknown ``rec`` kind, are skipped with a warning — never a crash —
so an old daemon can land on a newer journal without eating it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

JOURNAL_VERSION = 1

# record kinds this version understands; anything else is skipped
# with a warning on replay (forward compatibility, never a crash).
# delta_epoch / resident_release journal a RESIDENT
# partition's lifecycle: each applied delta epoch is fsync'd AFTER
# its state checkpoint lands, so a killed daemon resumes the resident
# partition at its last applied epoch; release frees the reservation.
# Both arrive after the job's DONE terminal — replay applies them
# post-terminal, unlike state records.
REC_KINDS = ("daemon_start", "submit", "state", "terminal", "drain",
             "delta_epoch", "resident_release")

_TERMINAL = ("done", "failed", "cancelled", "deadline_exceeded",
             "rejected")


class JournalError(ValueError):
    """Journal damage before the tail under SHEEP_IO_POLICY=strict."""


def _warn(msg: str) -> None:
    """Replay degradation warning: stderr + a trace event (no-op
    untraced), mirroring checkpoint.py's degradation trail."""
    import sys

    print(f"journal warning: {msg}", file=sys.stderr)
    from sheep_tpu_torch import obs

    obs.event("journal_degraded", message=msg)


def job_digest(spec) -> str:
    """Deterministic identity of one submit: the full JobSpec plus the
    input file's content identity (size + mtime when it is a path —
    synthetic ``rmat-hash:``-style specs are self-identifying). A
    client that retries a submit against a restarted daemon sends
    ``reattach`` and this digest matches it to the journaled job
    instead of double-building."""
    body: Dict = dataclasses.asdict(spec)
    body.pop("extra", None)
    # hashed under the reference's backend names: the same request has
    # the same digest in either package
    from sheep_tpu_torch.server.protocol import REFERENCE_BACKEND_NAMES

    body["update_backend"] = REFERENCE_BACKEND_NAMES.get(
        body["update_backend"], body["update_backend"])
    try:
        st = os.stat(spec.input)
        body["_file_size"] = int(st.st_size)
        body["_file_mtime_ns"] = int(st.st_mtime_ns)
    except OSError:
        pass
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()


@dataclasses.dataclass
class ReplayedJob:
    """One job's latest journaled state after replay."""

    job_id: str
    tenant: str
    spec: Dict                      # JobSpec fields, as journaled
    digest: Optional[str]
    submit_t: float
    n_vertices: int
    modeled_bytes: Optional[int]
    state: str                      # queued/running or a terminal state
    error: Optional[str] = None
    end_t: Optional[float] = None
    results: Optional[List[Dict]] = None   # summaries (terminal done)
    # resident-partition lineage: the last journaled
    # applied delta epoch, and whether the residency was released
    delta_epoch: int = 0
    resident_released: bool = False

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL


@dataclasses.dataclass
class Replay:
    """What a journal replays to: jobs in submit order, the id counter
    floor, and how many daemon incarnations came before this one."""

    jobs: List[ReplayedJob]
    next_id: int
    daemon_starts: int
    warnings: List[str]


class JobJournal:
    """Appender + replayer for one journal file. Appends are whole
    lines through one handle (O_APPEND semantics), so concurrent
    handler threads under the scheduler lock can never interleave
    partial records; fsync policy is per-record (see module doc)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._repair_tail()
        self._f = open(path, "a", encoding="utf-8")

    def _repair_tail(self) -> None:
        """Heal a torn tail BEFORE appending: a crash mid-append leaves
        a final line with no newline, and appending after it would glue
        the next record onto the fragment — turning a tolerated
        torn-tail into permanent mid-file damage that a strict-policy
        replay would refuse forever. A parseable unterminated record
        just gets its newline (the data is intact); garbage is
        truncated away, exactly what replay would have dropped."""
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            return
        with f:
            data = f.read()
        if not data or data.endswith(b"\n"):
            return
        cut = data.rfind(b"\n") + 1
        tail = data[cut:]
        try:
            json.loads(tail.decode("utf-8"))
            with open(self.path, "ab") as f:
                f.write(b"\n")
                f.flush()
                os.fsync(f.fileno())
            return
        except (ValueError, UnicodeDecodeError):
            pass
        _warn(f"{self.path}: truncating torn trailing record "
              f"({len(tail)} bytes) before appending")
        with open(self.path, "r+b") as f:
            f.truncate(cut)
            f.flush()
            os.fsync(f.fileno())

    def append(self, rec: Dict, fsync: bool = False) -> None:
        rec = {"v": JOURNAL_VERSION, **rec}
        self._f.write(json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True) + "\n")
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    # -- replay --------------------------------------------------------
    def replay(self) -> Replay:
        return replay(self.path)


def replay(path: str) -> Replay:
    """Replay a journal into per-job latest state (see module doc for
    the tolerance contract). Missing or empty journal = clean start."""
    from sheep_tpu_torch.io.edgestream import _io_policy

    warnings: List[str] = []

    def warn(msg: str) -> None:
        warnings.append(msg)
        _warn(msg)

    jobs: "Dict[str, ReplayedJob]" = {}
    order: List[str] = []
    daemon_starts = 0
    max_id = 0
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except FileNotFoundError:
        return Replay(jobs=[], next_id=1, daemon_starts=0,
                      warnings=warnings)
    for i, line in enumerate(lines):
        at_tail = i == len(lines) - 1
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except ValueError as e:
            # a torn TAIL is the expected crash artifact (the append
            # died mid-line) — always dropped with a warning; damage
            # before the tail follows the IO policy proper
            if at_tail or not line.endswith("\n"):
                warn(f"{path}: torn trailing record dropped ({e})")
                continue
            if _io_policy() == "strict":
                raise JournalError(
                    f"{path}: damaged journal record at line {i + 1} "
                    f"({e}) (set SHEEP_IO_POLICY=quarantine to skip "
                    f"it and continue)") from None
            warn(f"{path}: damaged record at line {i + 1} skipped "
                 f"({e})")
            continue
        v = rec.get("v")
        if not isinstance(v, int) or v > JOURNAL_VERSION:
            warn(f"{path}: record v{v!r} from a newer sheep_tpu_torch "
                 f"skipped (this daemon speaks v{JOURNAL_VERSION})")
            continue
        kind = rec.get("rec")
        if kind not in REC_KINDS:
            warn(f"{path}: unknown record kind {kind!r} skipped")
            continue
        if kind == "daemon_start":
            daemon_starts += 1
            continue
        if kind == "drain":
            continue  # informational: the handoff itself changes no job
        job_id = rec.get("job_id")
        if not isinstance(job_id, str) or not job_id:
            warn(f"{path}: {kind} record without job_id skipped")
            continue
        if kind == "submit":
            if job_id in jobs:
                warn(f"{path}: duplicate submit for {job_id} skipped")
                continue
            spec = rec.get("spec")
            if not isinstance(spec, dict) or not spec.get("input"):
                warn(f"{path}: submit for {job_id} carries no usable "
                     f"spec; skipped")
                continue
            jobs[job_id] = ReplayedJob(
                job_id=job_id,
                tenant=str(rec.get("tenant", "default")),
                spec=spec,
                digest=rec.get("digest"),
                submit_t=float(rec.get("t", 0.0)),
                n_vertices=int(rec.get("n_vertices", 0)),
                modeled_bytes=rec.get("modeled_bytes"),
                state=str(rec.get("state", "queued")),
                error=rec.get("error"),
            )
            order.append(job_id)
            if job_id.startswith("j"):
                try:
                    max_id = max(max_id, int(job_id[1:]))
                except ValueError:
                    pass
            continue
        job = jobs.get(job_id)
        if job is None:
            warn(f"{path}: {kind} record for unjournaled job "
                 f"{job_id} skipped")
            continue
        if kind == "delta_epoch":
            # arrives AFTER the job's DONE terminal by design (a
            # resident partition only exists once built); the newest
            # epoch wins (epochs never rewind at the appender)
            job.delta_epoch = max(job.delta_epoch,
                                  int(rec.get("epoch", 0)))
            continue
        if kind == "resident_release":
            job.resident_released = True
            continue
        if job.terminal:
            # first terminal wins: a duplicate terminal (crash between
            # the journal write and the ack) must not flip the state
            warn(f"{path}: {kind} record for already-terminal "
                 f"{job_id} skipped")
            continue
        if kind == "state":
            job.state = str(rec.get("state", job.state))
        else:  # terminal
            job.state = str(rec.get("state", "failed"))
            job.error = rec.get("error")
            job.end_t = float(rec.get("t", 0.0)) or None
            res = rec.get("results")
            job.results = res if isinstance(res, list) else None
    return Replay(jobs=[jobs[j] for j in order], next_id=max_id + 1,
                  daemon_starts=daemon_starts, warnings=warnings)
