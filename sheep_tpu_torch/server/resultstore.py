"""Content-addressed result store for sheepd (the port's copy of
``sheep_tpu/server/resultstore.py``; the entries are the same bytes).

Persists each DONE job's final assignment + score rows keyed by the
journal's deterministic spec+input digest (:func:`journal.job_digest`),
so a repeat ``submit`` for the same digest answers from the store with
zero dispatch steps and zero recompiles, bit-identical to the original
build.

Layout: one JSON file per digest under ``<state_dir>/results/``::

    {"v": 1, "digest": ..., "t": ..., "tenant": ..., "n_vertices": ...,
     "results": [{...summary fields..., "assignment": {b64,n,dtype}}],
     "sha": sha256-over-the-canonical-body-without-"sha"}

Durability contract (mirrors the journal's):

* **Atomic publish** — entries land via tmp-write + fsync +
  ``os.replace``; a kill -9 mid-write leaves only a ``.tmp`` orphan
  (swept on open), never a half-visible entry.
* **Self-verifying reads** — every load recomputes the embedded body
  checksum. Damage (torn tail, partial write, bit rot) follows
  ``SHEEP_IO_POLICY``: strict raises :class:`ResultStoreError`,
  quarantine warns, removes the entry and reports a miss — the same
  quarantine-or-raise contract as journal replay. A damaged cache
  entry can only ever cost a rebuild, never serve a wrong answer.
* **Journal-linked ordering** — the scheduler publishes an entry only
  AFTER the job's fsync'd journal terminal, so a crash between the two
  resolves to a rebuild on the next identical submit (the journal's
  DONE carries summaries but no assignment payload), never a torn or
  unjournaled answer.

Capacity: ``max_bytes`` bounds the directory; ``put`` evicts
oldest-first (entry mtime — publish order) until the new entry fits.
``max_bytes=0`` disables the store (every get misses, puts no-op).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

STORE_VERSION = 1
_SUFFIX = ".json"
_TMP_SUFFIX = ".tmp"


class ResultStoreError(ValueError):
    """Store entry damage under SHEEP_IO_POLICY=strict."""


def _warn(msg: str) -> None:
    """Degradation warning: stderr + trace event (no-op untraced),
    mirroring journal._warn."""
    import sys

    print(f"resultstore warning: {msg}", file=sys.stderr)
    from sheep_tpu_torch import obs

    obs.event("resultstore_degraded", message=msg)


def _body_sha(body: Dict) -> str:
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class ResultStore:
    """Digest-keyed entry directory with bounded bytes and
    oldest-first eviction. All methods are safe to call from the
    dispatch thread and handler threads under the scheduler lock; the
    store itself does no locking (one writer by construction — entries
    are immutable once published)."""

    def __init__(self, root: str, max_bytes: int = 256 << 20):
        self.root = root
        self.max_bytes = int(max_bytes)
        self.evictions = 0
        if self.max_bytes > 0:
            os.makedirs(root, exist_ok=True)
            self._sweep_tmp()

    # -- internals -----------------------------------------------------
    def _path(self, digest: str) -> str:
        # digests are hex sha1 from journal.job_digest; refuse anything
        # that could traverse out of the store directory
        if not digest or not all(c in "0123456789abcdef" for c in digest):
            raise ValueError(f"bad digest {digest!r}")
        return os.path.join(self.root, digest + _SUFFIX)

    def _sweep_tmp(self) -> None:
        """Drop publish orphans from a crash mid-write; they were never
        visible and carry no promise."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if name.endswith(_TMP_SUFFIX):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass

    def _entries(self):
        """[(mtime, size, path)] oldest first; best-effort (a racing
        eviction simply shortens the list)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            p = os.path.join(self.root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((st.st_mtime_ns, int(st.st_size), p))
        out.sort()
        return out

    def _damaged(self, path: str, why: str) -> None:
        from sheep_tpu_torch.io.edgestream import _io_policy

        if _io_policy() == "strict":
            raise ResultStoreError(
                f"{path}: damaged result-store entry ({why}) (set "
                f"SHEEP_IO_POLICY=quarantine to drop it and rebuild)")
        _warn(f"{path}: damaged entry dropped ({why}); the job rebuilds")
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- public API ----------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def get(self, digest: str) -> Optional[Dict]:
        """The stored entry body for ``digest``, or None (miss). A
        checksum-damaged entry is a miss under quarantine policy and a
        :class:`ResultStoreError` under strict."""
        if self.max_bytes <= 0:
            return None
        path = self._path(digest)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (ValueError, UnicodeDecodeError, OSError) as e:
            self._damaged(path, f"unparseable: {e}")
            return None
        if not isinstance(doc, dict) or not isinstance(doc.get("sha"), str):
            self._damaged(path, "missing checksum")
            return None
        v = doc.get("v")
        if not isinstance(v, int) or v > STORE_VERSION:
            _warn(f"{path}: entry v{v!r} from a newer sheep_tpu_torch "
                  f"skipped (this daemon speaks v{STORE_VERSION})")
            return None
        body = {k: doc[k] for k in doc if k != "sha"}
        if _body_sha(body) != doc["sha"]:
            self._damaged(path, "checksum mismatch")
            return None
        if doc.get("digest") != digest:
            self._damaged(path, f"digest mismatch ({doc.get('digest')!r})")
            return None
        return doc

    def put(self, digest: str, entry: Dict) -> bool:
        """Publish ``entry`` (checksummed, atomic). Evicts oldest
        entries until the new one fits; an entry larger than the whole
        cap is refused (False) rather than flushing the store for a
        single tenant's giant assignment."""
        if self.max_bytes <= 0:
            return False
        path = self._path(digest)
        body = dict(entry)
        body["v"] = STORE_VERSION
        body["digest"] = digest
        body.pop("sha", None)
        body["sha"] = _body_sha({k: body[k] for k in body if k != "sha"})
        blob = (json.dumps(body, sort_keys=True, separators=(",", ":"))
                + "\n").encode("utf-8")
        if len(blob) > self.max_bytes:
            _warn(f"{digest}: entry of {len(blob)} bytes exceeds the "
                  f"{self.max_bytes}-byte store cap; not cached")
            return False
        # oldest-first eviction until the new entry fits the cap
        entries = self._entries()
        used = sum(size for _, size, _ in entries)
        for _, size, old in entries:
            if used + len(blob) <= self.max_bytes:
                break
            if old == path:
                used -= size  # replacing ourselves frees our old bytes
                continue
            try:
                os.unlink(old)
            except OSError:
                continue
            used -= size
            self.evictions += 1
        tmp = path + _TMP_SUFFIX
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(blob.decode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            _warn(f"{digest}: publish failed ({e}); the entry is skipped")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True
