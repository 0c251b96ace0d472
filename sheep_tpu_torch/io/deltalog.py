"""Delta log: the append-log input of a mutating graph (the port's copy of
``sheep_tpu/io/deltalog.py``, the same bytes on disk, so either package
reads the other's logs).

Layout::

    header:  magic b"SHEEPDLG" | u32 version | u32 header_len |
             [v2+: u64 epoch_floor] |
             base_spec utf-8 (header_len - fixed bytes)
    records: 24-byte little-endian records, appended forever:
             u64 u | u64 v | u32 epoch | u16 op | u16 flags

Version 1 has no ``epoch_floor`` (implicitly 0). Version 2 carries the
compaction floor that :meth:`DeltaLogWriter.rewrite_base` stamps when it
rewrites the surviving multiset into a fresh base; writers emit v1
whenever the floor is 0.

``op`` is 0 (ADD) or 1 (DEL); ``epoch`` never decreases, and one epoch is
one applied delta batch. A DEL tombstones ONE occurrence of the undirected
edge {u, v} from the multiset as it stands: it cancels the latest pending
earlier ADD first, and a base edge otherwise.

Damage goes through ``SHEEP_IO_POLICY`` as every other input's does
(``io/edgestream.py``): a torn trailing record, a short read (the log
shrank under a reader) and an epoch that decreases are never folded in;
strict raises :class:`~sheep_tpu_torch.io.edgestream.CorruptStreamError`,
quarantine keeps the intact prefix and writes a ``chunk_quarantined``
event.

:class:`DeltaLogStream` (the ``delta:LOG[@EPOCH]`` input) streams the
surviving multiset, base minus tombstones plus surviving adds, with the
ANCHORED elimination order: the degrees pass reads the base segment alone
(``order_anchor``, :meth:`DeltaLogStream.anchor_stream`), which is what
makes the incremental path (``sheep_tpu_torch/incremental.py``)
bit-identical to a one-shot build of the same log.

The multiset algebra (:func:`net_effect`, :func:`cancel_adds`,
:func:`filter_tombstones`) gives the reference's answers record for
record; it resolves keys with numpy and walks in Python only the records
whose key a delete names, where the reference walks every one.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Optional

import numpy as np

MAGIC = b"SHEEPDLG"
VERSION = 2
HEADER_FIXED = 16       # magic + u32 version + u32 header_len
HEADER_FIXED_V2 = 24    # ... + u64 epoch_floor

OP_ADD = 0
OP_DEL = 1

RECORD_DTYPE = np.dtype([("u", "<u8"), ("v", "<u8"),
                         ("epoch", "<u4"), ("op", "<u2"),
                         ("flags", "<u2")])
RECORD_BYTES = RECORD_DTYPE.itemsize  # 24
MAX_BASE_SPEC_BYTES = 1 << 16

# undirected keys pack as lo << 32 | hi while every id is below this
_KEY_IDS = 1 << 32

class KeyFilter:
    """A membership prefilter over a set of 64-bit keys: a bit table of
    their Fibonacci hashes, about 16 bits a key, so that :meth:`maybe`
    passes every member and about one non-member in 16 to an exact
    search."""

    _MUL = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, keys: np.ndarray):
        bits = max(10, min(26, (16 * len(keys)).bit_length()))
        self._shift = np.uint64(64 - bits)
        self._mark = np.zeros(1 << bits, dtype=bool)
        self._mark[self._slot(keys)] = True

    def _slot(self, keys: np.ndarray) -> np.ndarray:
        return (np.asarray(keys).view(np.uint64) * self._MUL) >> self._shift

    def maybe(self, keys: np.ndarray) -> np.ndarray:
        """A bool mask: true for every member of the set."""
        return self._mark[self._slot(keys)]


def _quarantine_or_raise(msg: str, **fields) -> None:
    from sheep_tpu_torch.io.edgestream import _quarantine_or_raise as q

    q(msg, **fields)


def write_header(path: str, base_spec: str, epoch_floor: int = 0) -> None:
    """Write a fresh log header (fsync'd); a floor above 0 writes v2."""
    spec_b = base_spec.encode("utf-8")
    if not spec_b or len(spec_b) > MAX_BASE_SPEC_BYTES:
        raise ValueError(f"bad delta-log base spec ({len(spec_b)} bytes)")
    epoch_floor = int(epoch_floor)
    if epoch_floor < 0:
        raise ValueError(f"negative epoch floor {epoch_floor}")
    version = 2 if epoch_floor else 1
    fixed = HEADER_FIXED_V2 if epoch_floor else HEADER_FIXED
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(version).tobytes())
        f.write(np.uint32(fixed + len(spec_b)).tobytes())
        if epoch_floor:
            f.write(np.uint64(epoch_floor).tobytes())
        f.write(spec_b)
        f.flush()
        os.fsync(f.fileno())


def read_header(path: str) -> dict:
    """{"version", "base_spec", "header_len", "epoch_floor"}; a file that
    is not a delta log raises ValueError."""
    with open(path, "rb") as f:
        fixed = f.read(HEADER_FIXED)
        if len(fixed) < HEADER_FIXED or fixed[:8] != MAGIC:
            raise ValueError(f"{path}: not a sheep delta log (bad magic)")
        version = int(np.frombuffer(fixed[8:12], "<u4")[0])
        header_len = int(np.frombuffer(fixed[12:16], "<u4")[0])
        if version > VERSION:
            raise ValueError(f"{path}: delta log v{version} is newer "
                             f"than this reader (v{VERSION})")
        fixed_len = HEADER_FIXED_V2 if version >= 2 else HEADER_FIXED
        if not fixed_len <= header_len <= fixed_len + MAX_BASE_SPEC_BYTES:
            raise ValueError(f"{path}: impossible delta-log header "
                             f"length {header_len}")
        epoch_floor = 0
        if version >= 2:
            floor_b = f.read(8)
            if len(floor_b) != 8:
                raise ValueError(f"{path}: truncated delta-log header")
            epoch_floor = int(np.frombuffer(floor_b, "<u8")[0])
        spec_b = f.read(header_len - fixed_len)
        if len(spec_b) != header_len - fixed_len:
            raise ValueError(f"{path}: truncated delta-log header")
    return {"version": version, "base_spec": spec_b.decode("utf-8"),
            "header_len": header_len, "epoch_floor": epoch_floor}


class DeltaLogWriter:
    """Appender: one :meth:`append` batch per (op, epoch); epochs never
    decrease and default to last + 1. Appends are fsync'd by default: an
    acknowledged epoch is durable."""

    def __init__(self, path: str, base_spec: Optional[str] = None):
        self.path = path
        if os.path.exists(path) and os.path.getsize(path) > 0:
            hdr = read_header(path)
            if base_spec is not None and base_spec != hdr["base_spec"]:
                raise ValueError(f"{path} already logs deltas over "
                                 f"{hdr['base_spec']!r}, not {base_spec!r}")
            self.base_spec = hdr["base_spec"]
            self.epoch_floor = int(hdr.get("epoch_floor", 0))
            # the tail record holds the last epoch (epochs never
            # decrease); only a damaged body pays the validated read
            body = os.path.getsize(path) - hdr["header_len"]
            if body and body % RECORD_BYTES == 0:
                with open(path, "rb") as f:
                    f.seek(hdr["header_len"] + body - RECORD_BYTES)
                    tail = np.fromfile(f, dtype=RECORD_DTYPE, count=1)
                self.last_epoch = max(int(tail["epoch"][0]),
                                      self.epoch_floor)
            else:
                recs = DeltaLogReader(path).records()
                self.last_epoch = max(
                    int(recs["epoch"][-1]) if len(recs) else 0,
                    self.epoch_floor)
        else:
            if base_spec is None:
                raise ValueError("a new delta log needs base_spec")
            write_header(path, base_spec)
            self.base_spec = base_spec
            self.epoch_floor = 0
            self.last_epoch = 0
        self._f = open(path, "ab")

    def append(self, edges, op: int = OP_ADD, epoch: Optional[int] = None,
               fsync: bool = True) -> int:
        """Append (m, 2) edges as ``op`` records stamped ``epoch`` (default:
        a fresh epoch); returns the epoch used."""
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if op not in (OP_ADD, OP_DEL):
            raise ValueError(f"bad delta op {op!r}")
        if np.any(e < 0):
            raise ValueError("delta edges must have non-negative ids")
        epoch = self.last_epoch + 1 if epoch is None else int(epoch)
        if epoch < self.last_epoch:
            raise ValueError(f"epoch {epoch} < last epoch "
                             f"{self.last_epoch} (epochs never rewind)")
        rec = np.zeros(len(e), dtype=RECORD_DTYPE)
        rec["u"] = e[:, 0].astype(np.uint64)
        rec["v"] = e[:, 1].astype(np.uint64)
        rec["epoch"] = np.uint32(epoch)
        rec["op"] = np.uint16(op)
        self._f.write(rec.tobytes())
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
        self.last_epoch = epoch
        return epoch

    def append_epoch(self, adds=None, dels=None) -> int:
        """One new epoch: adds, then dels; the last batch written carries
        the epoch's one fsync."""
        epoch = self.last_epoch + 1
        has_adds = adds is not None and len(adds)
        has_dels = dels is not None and len(dels)
        if has_adds:
            self.append(adds, OP_ADD, epoch=epoch, fsync=not has_dels)
        if has_dels:
            self.append(dels, OP_DEL, epoch=epoch)
        self.last_epoch = epoch
        return epoch

    def rewrite_base(self, base_out: str,
                     n_vertices: Optional[int] = None) -> str:
        """Log compaction: write the surviving multiset (base and log) as a
        ``.csr`` base at ``base_out``, then rewrite this log in place as an
        empty v2 log over it whose ``epoch_floor`` is the last epoch, so
        the next epoch appended is floor + 1. The base lands atomically
        first; the header's rename is the commit point, so a kill leaves
        either the old pair or the new one. The old base is the caller's to
        delete."""
        from sheep_tpu_torch.io import csr as csr_mod

        stream = DeltaLogStream(self.path)
        n = stream.num_vertices if n_vertices is None else int(n_vertices)
        csr_mod.write_csr(base_out, stream, n_vertices=n)
        floor = max(self.last_epoch, stream.epoch)
        tmp = self.path + ".rewrite.tmp"
        write_header(tmp, base_out, epoch_floor=floor)
        self.close()
        os.replace(tmp, self.path)
        dfd = os.open(os.path.dirname(os.path.abspath(self.path)) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._f = open(self.path, "ab")
        self.base_spec = base_out
        self.epoch_floor = floor
        self.last_epoch = floor
        return base_out

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "DeltaLogWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class DeltaLogReader:
    """Validated records: damage goes through the IO policy, and the one
    physical read runs under the bounded transient-read retry."""

    def __init__(self, path: str):
        self.path = path
        self.header = read_header(path)
        self._records: Optional[np.ndarray] = None

    def records(self) -> np.ndarray:
        """The validated record array (``RECORD_DTYPE``), the intact prefix
        under quarantine; cached."""
        if self._records is not None:
            return self._records
        from sheep_tpu_torch.io.edgestream import (_read_retry_policy,
                                                   _retrying)

        hlen = self.header["header_len"]
        body = os.path.getsize(self.path) - hlen
        torn = body % RECORD_BYTES
        if torn:
            _quarantine_or_raise(
                f"{self.path}: {body} delta-log body bytes is not a "
                f"multiple of the {RECORD_BYTES}-byte record "
                f"({torn} torn trailing bytes)",
                path=self.path, torn_bytes=int(torn))
        count = body // RECORD_BYTES

        def _read():
            with open(self.path, "rb") as f:
                f.seek(hlen)
                return np.fromfile(f, dtype=RECORD_DTYPE, count=count)

        recs = _retrying(_read_retry_policy(), _read, f"read {self.path}")
        if len(recs) != count:
            _quarantine_or_raise(
                f"{self.path}: short read (wanted {count} delta "
                f"records, got {len(recs)}) — log truncated mid-pass",
                path=self.path, expected=int(count), got=int(len(recs)))
        if len(recs):
            ep = recs["epoch"].astype(np.int64)
            bad = np.nonzero(np.diff(ep) < 0)[0]
            if len(bad):
                at = int(bad[0]) + 1
                _quarantine_or_raise(
                    f"{self.path}: epoch rewinds at record {at} "
                    f"({int(ep[at])} after {int(ep[at - 1])}) — "
                    f"corrupt log; keeping the intact prefix",
                    path=self.path, record=at)
                recs = recs[:at]
            bad_op = np.nonzero(~np.isin(recs["op"], (OP_ADD, OP_DEL)))[0]
            if len(bad_op):
                at = int(bad_op[0])
                _quarantine_or_raise(
                    f"{self.path}: unknown delta op "
                    f"{int(recs['op'][at])} at record {at}; keeping "
                    f"the intact prefix", path=self.path, record=at)
                recs = recs[:at]
        self._records = recs
        return recs

    @property
    def max_epoch(self) -> int:
        recs = self.records()
        floor = int(self.header.get("epoch_floor", 0))
        return max(int(recs["epoch"][-1]) if len(recs) else 0, floor)

    def epochs(self, start_epoch: int = 0,
               up_to: Optional[int] = None) -> Iterator[tuple]:
        """(epoch, adds (a, 2) int64, dels (d, 2) int64) for each distinct
        epoch in (start_epoch, up_to]."""
        recs = self.records()
        if up_to is not None:
            recs = recs[recs["epoch"] <= up_to]
        recs = recs[recs["epoch"] > start_epoch]
        if not len(recs):
            return
        ep = recs["epoch"].astype(np.int64)
        bounds = np.nonzero(np.diff(ep))[0] + 1
        for seg in np.split(np.arange(len(recs)), bounds):
            r = recs[seg]
            e = np.stack([r["u"].astype(np.int64),
                          r["v"].astype(np.int64)], axis=1)
            is_add = r["op"] == OP_ADD
            yield int(r["epoch"][0]), e[is_add], e[~is_add]


# -- the multiset algebra of the one-shot stream and the incremental state --

def _norm_key(u, v) -> tuple:
    u, v = int(u), int(v)
    return (u, v) if u <= v else (v, u)


def _packed_keys(e: np.ndarray):
    """Undirected keys lo << 32 | hi (uint64) of (m, 2) edges, or None when
    an id falls outside [0, 2^32), where the caller walks every row."""
    if not len(e):
        return np.zeros(0, np.uint64)
    if int(e.min()) < 0 or int(e.max()) >= _KEY_IDS:
        return None
    lo = np.minimum(e[:, 0], e[:, 1]).astype(np.uint64)
    hi = np.maximum(e[:, 0], e[:, 1]).astype(np.uint64)
    return (lo << np.uint64(32)) | hi


def _resolve(adds: np.ndarray, dels: np.ndarray, add_pos=None,
             del_pos=None) -> tuple:
    """The reference's stack walk over the rows whose key a delete names:
    each delete cancels the latest still-pending add of its key that comes
    before it, else it tombstones the base. ``add_pos``/``del_pos`` place
    adds and deletes in one record order (None: every add before every
    delete). Returns (cancelled add-row mask, unmatched delete rows)."""
    cancelled = np.zeros(len(adds), dtype=bool)
    add_keys, del_keys = _packed_keys(adds), _packed_keys(dels)
    if add_keys is None or del_keys is None:
        cand = np.arange(len(adds))
    else:
        cand = np.flatnonzero(np.isin(add_keys, del_keys))
    if add_pos is None:
        add_pos = np.full(len(adds), -1, dtype=np.int64)
        del_pos = np.arange(len(dels), dtype=np.int64)
    # the candidate adds and every delete, merged in record order
    events = sorted([(int(add_pos[i]), 0, int(i)) for i in cand]
                    + [(int(del_pos[j]), 1, j) for j in range(len(dels))])
    stacks: dict = {}
    unmatched = []
    for _, is_del, i in events:
        if is_del:
            stack = stacks.get(_norm_key(dels[i, 0], dels[i, 1]))
            if stack:
                cancelled[stack.pop()] = True
            else:
                unmatched.append(i)
        else:
            stacks.setdefault(_norm_key(adds[i, 0], adds[i, 1]),
                              []).append(i)
    return cancelled, unmatched


def _norm_rows(e: np.ndarray) -> np.ndarray:
    out = np.empty((len(e), 2), dtype=np.int64)
    np.minimum(e[:, 0], e[:, 1], out=out[:, 0])
    np.maximum(e[:, 0], e[:, 1], out=out[:, 1])
    return out


def net_effect(records) -> tuple:
    """(surviving adds (a, 2) int64, base tombstones (t, 2) int64) of a
    validated record array, replayed in log order: a DEL removes one
    occurrence of its edge from the multiset as it stood at that record,
    cancelling the latest still-pending EARLIER add, else tombstoning the
    base; it never reaches forward to a later add. Surviving adds keep
    their orientation and order; tombstones are (min, max) in record
    order."""
    recs = np.asarray(records)
    e = np.stack([recs["u"].astype(np.int64), recs["v"].astype(np.int64)],
                 axis=1)
    is_add = recs["op"] == OP_ADD
    add_i, del_i = np.flatnonzero(is_add), np.flatnonzero(~is_add)
    adds, dels = e[add_i], e[del_i]
    cancelled, unmatched = _resolve(adds, dels, add_i, del_i)
    return adds[~cancelled], _norm_rows(dels[unmatched])


def cancel_adds(adds_list, dels) -> tuple:
    """Resolve a delete batch against the pending ADD arrays, in order:
    each delete cancels the LATEST still-pending add of its undirected key;
    the rest come back as base tombstones, (min, max). The apply-time twin
    of :func:`net_effect`. Returns (new adds list, with emptied arrays
    dropped, base tombstones (t, 2) int64)."""
    d = np.asarray(dels, np.int64).reshape(-1, 2)
    sizes = [len(a) for a in adds_list]
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1, 2)
                           for a in adds_list]) if adds_list \
        else np.zeros((0, 2), np.int64)
    cancelled, unmatched = _resolve(flat, d)
    keep = np.split(~cancelled, np.cumsum(sizes)[:-1])
    return ([a[m] for a, m in zip(adds_list, keep) if m.any()],
            _norm_rows(d[unmatched]))


def _filter_rows(chunks, tombs) -> Iterator[np.ndarray]:
    """:func:`filter_tombstones` one row at a time (ids past 2^32)."""
    from collections import Counter

    pending = Counter(_norm_key(u, v) for u, v in tombs.tolist())
    for c in chunks:
        e = np.asarray(c, dtype=np.int64).reshape(-1, 2)
        if sum(pending.values()) == 0 or not len(e):
            yield e
            continue
        keep = np.ones(len(e), dtype=bool)
        for i, (u, v) in enumerate(e.tolist()):
            k = _norm_key(u, v)
            if pending.get(k, 0) > 0:
                pending[k] -= 1
                keep[i] = False
        yield e[keep]


def filter_tombstones(chunks, tombs) -> Iterator[np.ndarray]:
    """``chunks`` with one occurrence a tombstone removed, the first in
    stream order (undirected match, multiset semantics); a tombstone that
    matches nothing removes nothing."""
    if tombs is None or not len(tombs):
        yield from chunks
        return
    t = np.asarray(tombs, np.int64).reshape(-1, 2)
    tkeys = _packed_keys(t)
    if tkeys is None:
        yield from _filter_rows(chunks, t)
        return
    keys, pending = np.unique(tkeys, return_counts=True)
    left = int(pending.sum())
    # a bit table of the keys' hashes passes the few candidate edges to the
    # exact search (a false positive costs one lookup)
    prefilter = KeyFilter(keys)
    for c in chunks:
        e = np.asarray(c, dtype=np.int64).reshape(-1, 2)
        if left == 0 or not len(e):
            yield e
            continue
        ek = _packed_keys(e)
        if ek is None:
            # a row past 32-bit ids matches no tombstone
            ok = np.flatnonzero((e.min(axis=1) >= 0)
                                & (e.max(axis=1) < _KEY_IDS))
            ek = np.zeros(len(e), np.uint64)
            ek[ok] = _packed_keys(e[ok])
            mask = np.zeros(len(e), bool)
            mask[ok] = prefilter.maybe(ek[ok])
        else:
            mask = prefilter.maybe(ek)
        cand = np.flatnonzero(mask)
        ck = ek[cand]
        at = np.minimum(np.searchsorted(keys, ck), len(keys) - 1)
        found = (keys[at] == ck) & (pending[at] > 0)
        hit, at = cand[found], at[found]
        if not len(hit):
            yield e
            continue
        # the occurrences of a key in stream order: the first pending[k]
        # go
        kid = at
        order = np.argsort(kid, kind="stable")
        sk = kid[order]
        first = np.ones(len(sk), dtype=bool)
        np.not_equal(sk[1:], sk[:-1], out=first[1:])
        start = np.flatnonzero(first)
        rank = np.arange(len(sk)) - np.repeat(start, np.diff(
            np.append(start, len(sk))))
        drop = rank < pending[sk]
        keep = np.ones(len(e), dtype=bool)
        keep[hit[order[drop]]] = False
        np.subtract.at(pending, sk[drop], 1)
        left -= int(drop.sum())
        yield e[keep]


class DeltaLogStream:
    """The one-shot view of base ∪ log: an edge stream of the surviving
    multiset at ``up_to`` (default: the whole log) with the anchored
    elimination order (module docstring). It streams as one shard."""

    order_anchor = True

    def __init__(self, path: str, up_to: Optional[int] = None,
                 n_vertices: Optional[int] = None):
        from sheep_tpu_torch.io.edgestream import open_input

        self.path = path
        self.reader = DeltaLogReader(path)
        self.base_spec = self.reader.header["base_spec"]
        if self.base_spec.startswith("delta:"):
            raise ValueError(f"{path}: delta logs do not nest")
        self.base = open_input(self.base_spec)
        self.up_to = up_to
        floor = int(self.reader.header.get("epoch_floor", 0))
        if up_to is not None and up_to < floor:
            raise ValueError(
                f"{path}: epoch {up_to} predates the compaction floor "
                f"{floor} — that history was rewritten into the base "
                f"(rewrite_base)")
        recs = self.reader.records()
        if up_to is not None:
            recs = recs[recs["epoch"] <= up_to]
        self.epoch = max(int(recs["epoch"][-1]) if len(recs) else 0, floor)
        self.adds, self.tombs = net_effect(recs)
        n = int(self.base.num_vertices)
        if len(self.adds):
            n = max(n, int(self.adds.max()) + 1)
        if len(self.tombs):
            n = max(n, int(self.tombs.max()) + 1)
        if n_vertices is not None:
            if n_vertices < n:
                raise ValueError(f"--num-vertices {n_vertices} is below "
                                 f"the delta-log vertex space ({n})")
            n = n_vertices
        self._n = n

    @property
    def num_vertices(self) -> int:
        return self._n

    @property
    def num_edges_cheap(self) -> Optional[int]:
        base = self.base.num_edges_cheap
        if base is None:
            return None
        # an upper estimate when a tombstone matches nothing: a sizing
        # and progress hint, like every cheap count
        return max(0, base + len(self.adds) - len(self.tombs))

    @property
    def num_edges(self) -> int:
        cheap = self.num_edges_cheap
        if cheap is not None:
            return cheap
        return sum(len(c) for c in self.chunks())

    @property
    def num_edges_upper_bound(self) -> Optional[int]:
        base = self.base.num_edges_upper_bound
        if base is None:
            return None
        return base + len(self.adds)

    def clamp_chunk_edges(self, chunk_edges: int, parts: int = 1,
                          floor: int = 1024) -> int:
        from sheep_tpu_torch.io.edgestream import EdgeStream

        return EdgeStream.clamp_chunk_edges(self, chunk_edges, parts, floor)

    def content_fingerprint(self) -> str:
        st = os.stat(self.path)
        blob = (f"{self.base_spec}|{st.st_size}|{st.st_mtime_ns}|"
                f"{self.epoch}")
        return hashlib.sha1(blob.encode()).hexdigest()

    def __enter__(self) -> "DeltaLogStream":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def anchor_chunks(self, chunk_edges: int,
                      start_chunk: int = 0) -> Iterator[np.ndarray]:
        """The order anchor: the base segment's chunks alone, what the
        degrees pass of a delta-log build streams (into this stream's whole
        vertex space, so vertices the log introduced rank at degree 0)."""
        yield from self.base.chunks(chunk_edges, start_chunk=start_chunk)

    def anchor_stream(self):
        """The base stream (a device stream stays one for the anchor
        pass)."""
        return self.base

    def chunks(self, chunk_edges: int = 1 << 22, start_chunk: int = 0,
               shard: int = 0, num_shards: int = 1,
               byte_range: bool = False) -> Iterator[np.ndarray]:
        if num_shards != 1:
            raise NotImplementedError("delta: inputs stream as one shard")
        idx = 0
        for c in filter_tombstones(self.base.chunks(chunk_edges),
                                   self.tombs):
            if idx >= start_chunk:
                yield c
            idx += 1
        for off in range(0, len(self.adds), chunk_edges):
            if idx >= start_chunk:
                yield self.adds[off: off + chunk_edges]
            idx += 1

    def read_all(self) -> np.ndarray:
        out = list(self.chunks())
        if not out:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(out, axis=0)


def open_delta(spec_rest: str,
               n_vertices: Optional[int] = None) -> DeltaLogStream:
    """``delta:LOG[@EPOCH]`` -> :class:`DeltaLogStream` (the surviving
    multiset up to EPOCH, default all)."""
    path, sep, ep = spec_rest.rpartition("@")
    up_to = None
    if sep and ep.isdigit():
        up_to = int(ep)
    else:
        path = spec_rest
    if not path or not os.path.exists(path):
        raise ValueError(f"delta log {path!r} does not exist "
                         f"(want delta:LOG[@EPOCH])")
    return DeltaLogStream(path, up_to=up_to, n_vertices=n_vertices)
