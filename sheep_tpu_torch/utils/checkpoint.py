"""Checkpoint and resume (the port's copy of ``sheep_tpu/utils/checkpoint.py``,
in its format, version 3).

A partial elimination forest is mergeable state, so the unit of recovery
is the chunk: every ``every`` chunks a run saves ``(phase, next chunk
index, O(V) arrays)``, and a restart re-opens the stream at that chunk
(``chunks(cs, start_chunk=...)``) and goes on. A save costs O(V) bytes
whatever the edge count.

The arrays go to a uniquely named ``.npz`` written through a temporary
file and ``os.replace``; the manifest, replaced the same way, names it and
the step before it, whose file is kept, so a crash at any instant leaves
an intact checkpoint. A corrupt or truncated ``.npz`` falls back to the
previous step and a torn manifest to a clean start, with a warning on
stderr, counted by :func:`degraded_events`.

The port writes what the JAX package writes: the same manifest fields, the
same run fingerprint (:func:`stream_meta`) and the same array names and
dtypes (``deg`` int64[n]; ``minp`` int32[n+1], the forest in vertex
space; ``carry_lo``/``carry_hi`` in carry mode; ``cut``, ``total`` and the
int64 comm-volume keys ``cv_keys`` = vertex * k + foreign part in the
score phase), so either package resumes the other's checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

from sheep_tpu_torch import obs

FORMAT_VERSION = 3

# the pipeline's phases and the hierarchy's level-boundary phase; a run
# that succeeds clears its checkpoint instead of saving a last phase
PHASES = ("degrees", "build", "score", "hier")

# recoveries that degraded in this process (the backend reports the ones
# of its run as ``checkpoint_degraded``)
_DEGRADED_EVENTS = 0


def degraded_events() -> int:
    """How many checkpoint recoveries degraded in this process so far."""
    return _DEGRADED_EVENTS


def _warn(msg: str) -> None:
    global _DEGRADED_EVENTS
    _DEGRADED_EVENTS += 1
    print(f"checkpoint warning: {msg}", file=sys.stderr)
    obs.event("checkpoint_degraded", message=msg)


def phase_index(phase: str) -> int:
    return PHASES.index(phase)


@dataclasses.dataclass
class CheckpointState:
    phase: str
    chunk_idx: int  # the next chunk to process in ``phase``
    arrays: Dict[str, np.ndarray]
    meta: Dict

    def matches(self, meta: Dict) -> bool:
        """Exact dict equality: a run resumes only a checkpoint of the same
        inputs and options."""
        return self.meta == meta


class Checkpointer:
    """Checkpoints of one process under a directory. ``every`` is the
    cadence in chunks; ``auto_clear=False`` makes the run's closing
    :meth:`clear` a no-op (a nested domain, which its owner clears with
    ``clear(force=True)``)."""

    def __init__(self, directory: str, every: int = 64, process: int = 0,
                 auto_clear: bool = True):
        if every < 1:
            raise ValueError("checkpoint cadence must be >= 1 chunk")
        self.dir = directory
        self.every = int(every)
        self.process = int(process)
        self.auto_clear = bool(auto_clear)
        os.makedirs(directory, exist_ok=True)

    def child(self, name: str, auto_clear: bool = False) -> "Checkpointer":
        """A checkpointer under the subdirectory ``name``, same cadence and
        process: the hierarchy hands one to its level-0 partition."""
        return Checkpointer(os.path.join(self.dir, name), every=self.every,
                            process=self.process, auto_clear=auto_clear)

    def due(self, chunks_done: int) -> bool:
        return chunks_done > 0 and chunks_done % self.every == 0

    def due_span(self, before: int, after: int) -> bool:
        """True when the chunk window (before, after] crosses a cadence
        boundary: the test for progress in strides of several chunks."""
        return after // self.every > before // self.every

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, f"sheep_ckpt_p{self.process}.json")

    def _data_name(self, phase: str, chunk_idx: int) -> str:
        return f"sheep_ckpt_p{self.process}_{phase}_{chunk_idx}.npz"

    def save(self, phase: str, chunk_idx: int,
             arrays: Dict[str, np.ndarray],
             meta: Optional[Dict] = None) -> None:
        """Persist a step atomically; the manifest keeps the step before it
        as ``previous``, and both data files stay."""
        if phase not in PHASES:
            raise ValueError(f"unknown checkpoint phase {phase!r}")
        name = self._data_name(phase, chunk_idx)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, name))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        prev = None
        old = self._read_manifest(quiet=True)
        if old is not None:
            prev = {"phase": old["phase"], "chunk_idx": old["chunk_idx"],
                    "data": old["data"]}
        manifest = {
            "version": FORMAT_VERSION,
            "phase": phase,
            "chunk_idx": int(chunk_idx),
            "data": name,
            "previous": prev,
            "meta": meta or {},
        }
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        keep = {name}
        if prev is not None:
            keep.add(prev["data"])
        self._sweep(keep=keep)

    def _read_manifest(self, quiet: bool = False) -> Optional[Dict]:
        """The manifest, or None when there is none, it is torn, or it is
        of another format version (warned unless ``quiet``: a save peeking
        at the old manifest is not a recovery)."""
        try:
            with open(self._manifest_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            if not quiet:
                _warn(f"manifest {self._manifest_path} is torn/unreadable; "
                      f"starting clean")
            return None
        if manifest.get("version") != FORMAT_VERSION:
            if not quiet:
                _warn(f"checkpoint format v{manifest.get('version')} != "
                      f"v{FORMAT_VERSION}; starting clean (checkpoints are "
                      f"not portable across versions)")
            return None
        return manifest

    def _load_entry(self, entry: Dict,
                    meta: Dict) -> Optional[CheckpointState]:
        data_path = os.path.join(self.dir, entry["data"])
        try:
            with np.load(data_path) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as exc:  # noqa: BLE001
            # a truncated .npz fails as BadZipFile, EOFError, zlib.error or
            # ValueError by where the bytes stop: this step is gone either
            # way, and the caller falls back
            _warn(f"checkpoint data {entry.get('data')} unreadable "
                  f"({type(exc).__name__}: {exc})")
            return None
        return CheckpointState(phase=entry["phase"],
                               chunk_idx=int(entry["chunk_idx"]),
                               arrays=arrays, meta=meta)

    def load(self) -> Optional[CheckpointState]:
        """The newest intact step: the latest, else the previous one, else
        None (a clean start), each fallback warned, never raised."""
        manifest = self._read_manifest()
        if manifest is None:
            return None
        meta = manifest.get("meta", {})
        for entry in (manifest, manifest.get("previous")):
            if not entry:
                continue
            state = self._load_entry(entry, meta)
            if state is not None:
                return state
        _warn(f"no intact checkpoint under {self.dir} (process "
              f"{self.process}); resuming as a clean start")
        return None

    def load_at(self, phase: str,
                chunk_idx: int) -> Optional[CheckpointState]:
        """The step (``phase``, ``chunk_idx``) when it is the latest or the
        kept previous one; None otherwise."""
        manifest = self._read_manifest()
        if manifest is None:
            return None
        meta = manifest.get("meta", {})
        for entry in (manifest, manifest.get("previous")):
            if entry and entry["phase"] == phase \
                    and int(entry["chunk_idx"]) == int(chunk_idx):
                return self._load_entry(entry, meta)
        return None

    def clear(self, force: bool = False) -> None:
        """Drop this process's checkpoint (with ``auto_clear=False`` only
        when ``force``)."""
        if not self.auto_clear and not force:
            return
        self._sweep(keep=set())
        try:
            os.remove(self._manifest_path)
        except FileNotFoundError:
            pass

    def _sweep(self, keep: set) -> None:
        """Remove this process's data files but ``keep``."""
        prefix = f"sheep_ckpt_p{self.process}_"
        for fname in os.listdir(self.dir):
            if fname.startswith(prefix) and fname.endswith(".npz") \
                    and fname not in keep:
                try:
                    os.remove(os.path.join(self.dir, fname))
                except FileNotFoundError:
                    pass


def stream_meta(stream, k: int, chunk_edges: int, weights: str,
                alpha: float, comm_volume: bool, **extra) -> Dict:
    """The run's fingerprint, stored in the manifest; a resume refuses a
    checkpoint whose fingerprint differs. Every option that changes the
    result is in it, and the input's identity: a file's size and mtime, a
    hash of an in-memory array's first and last 4096 edges, a synthetic
    stream's ``content_fingerprint()``, or a hash of a generator's first
    block; the keys and values are the JAX package's."""
    meta = {
        "path": getattr(stream, "path", None),
        "n_vertices": int(stream.num_vertices),
        "k": int(k),
        "chunk_edges": int(chunk_edges),
        "weights": str(weights),
        "alpha": float(alpha),
        "comm_volume": bool(comm_volume),
    }
    if meta["path"] is not None:
        try:
            st = os.stat(meta["path"])
            meta["file_size"] = int(st.st_size)
            meta["file_mtime_ns"] = int(st.st_mtime_ns)
        except OSError:
            pass
    elif getattr(stream, "_edges", None) is not None:
        e = stream._edges
        sample = np.ascontiguousarray(np.concatenate([e[:4096], e[-4096:]]))
        meta["content_sha1"] = hashlib.sha1(sample.tobytes()).hexdigest()
    elif getattr(stream, "content_fingerprint", None) is not None:
        meta["content_sha1"] = str(stream.content_fingerprint())
    elif getattr(stream, "_factory", None) is not None:
        first = next(iter(stream._factory()), None)
        if first is not None:
            sample = np.ascontiguousarray(
                np.asarray(first, dtype=np.int64)[:4096])
            meta["content_sha1"] = hashlib.sha1(sample.tobytes()).hexdigest()
    m = stream.num_edges_cheap
    if m is not None:
        meta["num_edges"] = int(m)
    meta.update(extra)
    return meta


def compact_cv_keys(cv_chunks) -> np.ndarray:
    """The accumulated comm-volume keys (host arrays) as one sorted unique
    int64 array. One array already strictly increasing (the device's
    ``torch.unique``) is that array: the host sort is skipped, which at
    s22 costs seconds on the card's host."""
    if not cv_chunks:
        return np.zeros(0, np.int64)
    if len(cv_chunks) == 1:
        keys = np.asarray(cv_chunks[0], np.int64)
        if bool(np.all(keys[1:] > keys[:-1])):
            return keys
    return np.unique(np.concatenate(cv_chunks))


def save_score_state(checkpointer: Checkpointer, chunk_idx: int, cut: int,
                     total: int, cv_chunks, extra_arrays: Dict, meta: Dict,
                     comm_volume: bool):
    """The score phase's checkpoint: compact the key accumulator, save it
    with the counters, and return the list to carry on with (empty without
    ``comm_volume``)."""
    keys = compact_cv_keys(cv_chunks)
    checkpointer.save(
        "score", chunk_idx,
        {**extra_arrays, "cut": np.int64(cut), "total": np.int64(total),
         "cv_keys": keys}, meta)
    return [keys] if comm_volume else []


# what resume_state(raise_on_mismatch=False) returns for a checkpoint
# of another run: a multi-process caller hands it to
# reconcile_multihost_resume, which raises on every process (one process
# raising alone would leave the others waiting in their first collective)
MISMATCHED = object()


def resume_state(checkpointer: Optional[Checkpointer], meta: Dict,
                 resume: bool, raise_on_mismatch: bool = True):
    """The state to resume from: None without a checkpointer, without
    ``resume`` or with nothing saved; a ``ValueError`` when the saved
    fingerprint is not this run's, or :data:`MISMATCHED` instead when not
    ``raise_on_mismatch``."""
    if checkpointer is None or not resume:
        return None
    state = checkpointer.load()
    if state is None:
        return None
    if not state.matches(meta):
        if not raise_on_mismatch:
            return MISMATCHED
        raise ValueError(
            "checkpoint does not match this run "
            f"(saved {state.meta}, current {meta}); "
            "pass a fresh --checkpoint-dir or drop --resume. Note: "
            "upgrading sheep_tpu can change automatic chunk sizing "
            "(part of the fingerprint), in which case restart fresh — "
            "checkpoints are not portable across versions")
    # where a killed run restarted: the seam trace_report shows beside the
    # killed attempt's unclosed spans
    obs.event("resume", phase=state.phase, chunk_idx=int(state.chunk_idx),
              process=checkpointer.process)
    return state


def reconcile_multihost_resume(checkpointer: Checkpointer, state,
                               meta: Dict) -> Optional[CheckpointState]:
    """One resume step for every process (the reference's
    ``reconcile_multihost_resume``). A crash between two processes' saves
    leaves their manifests one step apart; resuming from different steps
    would desynchronize the collectives. The processes allgather their
    latest (phase, chunk) and fall back to the least, which each holds as
    its latest or its kept previous step; a process with no checkpoint
    means a fresh start for all. Whether every process can load that
    step is allgathered too, so a step that is gone, or a fingerprint
    mismatch on one process (``state is MISMATCHED``), raises
    ``ValueError`` on every process."""
    from sheep_tpu_torch.parallel.mesh import process_allgather

    mismatched = state is MISMATCHED
    own = ((phase_index(state.phase), state.chunk_idx)
           if state and not mismatched else (-1, -1))
    steps = process_allgather(np.array(own, dtype=np.int64))
    lo_phase, lo_chunk = sorted(map(tuple, steps.reshape(-1, 2).tolist()))[0]
    fresh = lo_phase < 0
    candidate: Optional[CheckpointState] = None
    if not fresh:
        if (lo_phase, lo_chunk) == own:
            candidate = state
        else:
            candidate = checkpointer.load_at(PHASES[lo_phase], lo_chunk)
        if candidate is not None and not candidate.matches(meta):
            candidate = None
    ok = (fresh or candidate is not None) and not mismatched
    every = process_allgather(np.array([1 if ok else 0], dtype=np.int64))
    if not every.all():
        raise ValueError(
            f"cannot resume: common step {(lo_phase, lo_chunk)} is not "
            f"retained, does not match this run, or a local checkpoint "
            f"fingerprint-mismatched on some process "
            f"(this process has {own}, ok={ok}, mismatched={mismatched}); "
            "pass a fresh --checkpoint-dir or drop --resume")
    return None if fresh else candidate
