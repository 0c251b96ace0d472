"""Chunked edge streams of the port (a subset of ``sheep_tpu/io/edgestream.py``).

Every stream provides ``num_vertices``, ``num_edges_cheap``,
``num_edges_upper_bound``, ``clamp_chunk_edges`` and ``chunks(cs)``, which
yields (<= cs, 2) int64 host arrays: chunk i holds edges [i*cs, (i+1)*cs)
in stream order, exactly as the reference cuts them, so the fixpoint sees
the same segments and counts the same rounds. Text (plain or gzip) is parsed by the port's copy
of the reference's native parser, so both read the same edges from the
same file; ``.csr`` files are read through ``io/csr.py``; a generator
stream regroups the blocks of a re-openable factory. ``chunks(cs,
start_chunk=i)`` starts at chunk i, where a resumed run goes on.

Faults, as the reference handles them (``sheep_tpu/io/edgestream.py``):
every physical open and read runs under the bounded retry of
``utils/retry.py`` (a transient ``OSError`` backs off and reads again, from
an explicit offset), and binary streams are validated: a torn trailing
record, or a short read when the file shrank under a pass, is never
folded in. ``SHEEP_IO_POLICY`` says what happens instead:

    strict      (default) raise :class:`CorruptStreamError`
    quarantine  warn on stderr, drop the damaged bytes and go on over the
                intact prefix
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, Optional

import numpy as np

from sheep_tpu_torch import obs
from sheep_tpu_torch.io import formats

IO_POLICY_ENV = "SHEEP_IO_POLICY"


class CorruptStreamError(ValueError):
    """Torn, corrupt or shrunken input under the strict IO policy."""


def _io_policy() -> str:
    v = os.environ.get(IO_POLICY_ENV, "strict") or "strict"
    if v not in ("strict", "quarantine"):
        raise ValueError(f"bad {IO_POLICY_ENV}={v!r}; "
                         f"want 'strict' or 'quarantine'")
    return v


def _quarantine_or_raise(msg: str, **fields) -> None:
    """Apply the IO policy to a detected corruption: raise (strict), or
    warn, write the ``chunk_quarantined`` event with ``fields`` and let
    the caller go on (quarantine)."""
    if _io_policy() == "strict":
        raise CorruptStreamError(
            msg + " (set SHEEP_IO_POLICY=quarantine to drop the "
                  "damaged bytes and continue)")
    import sys

    print(f"edgestream quarantine: {msg}", file=sys.stderr)
    obs.event("chunk_quarantined", message=msg, **fields)


def _read_retry_policy():
    """A fresh read retry budget a pass, with the build's knobs."""
    from sheep_tpu_torch.utils.retry import RetryPolicy

    return RetryPolicy()


def _retrying(policy, fn, where: str):
    """``fn()``, a physical open or read, under the bounded transient
    retry; other errors, and a spent budget, propagate."""
    from sheep_tpu_torch.utils.retry import TRANSIENT, classify

    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001, classified below
            if classify(exc) != TRANSIENT or not policy.admit(TRANSIENT):
                raise
            policy.backoff(TRANSIENT, exc, where=where)


class EdgeStream:
    """A re-openable stream over a file, an in-memory edge array or a
    generator factory."""

    def __init__(self, path: Optional[str] = None,
                 edges: Optional[np.ndarray] = None,
                 n_vertices: Optional[int] = None, factory=None,
                 num_edges: Optional[int] = None):
        if sum(x is not None for x in (path, edges, factory)) != 1:
            raise ValueError("exactly one of path / edges / factory "
                             "required")
        self.path = path
        self._edges = None if edges is None \
            else np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self._factory = factory
        self.fmt = formats.detect_format(path) if path \
            else ("generator" if factory else "memory")
        self._n_vertices = n_vertices
        self._n_edges = num_edges

    @classmethod
    def open(cls, path: str, n_vertices: Optional[int] = None):
        return cls(path=path, n_vertices=n_vertices)

    @classmethod
    def from_array(cls, edges: np.ndarray, n_vertices: Optional[int] = None):
        return cls(edges=edges, n_vertices=n_vertices)

    @classmethod
    def from_generator(cls, factory, n_vertices: Optional[int] = None,
                       num_edges: Optional[int] = None):
        """A stream over ``factory()``, which must return a fresh iterator
        of (c, 2) integer arrays each call (a build makes three passes);
        its blocks are regrouped into the caller's chunks."""
        return cls(factory=factory, n_vertices=n_vertices,
                   num_edges=num_edges)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _pair_bytes(self) -> int:
        return 8 if self.fmt == "bin32" else 16

    @property
    def num_edges_cheap(self) -> Optional[int]:
        """The edge count when it costs O(1): memory, binary, ``.csr`` and
        sized generator streams; None where it needs a pass (text, gzip
        text, unsized generators)."""
        if self._edges is not None:
            return len(self._edges)
        if self._n_edges is not None:
            return self._n_edges
        if self.fmt in ("bin32", "bin64", "csr"):
            return self.num_edges_upper_bound
        return None

    @property
    def num_edges_upper_bound(self) -> Optional[int]:
        """Exact for memory, binary, ``.csr`` and sized generator streams;
        for text the floor of 4 bytes per edge line ("0 1\\n"), +1 for a
        missing final newline; None for gzip text and unsized
        generators."""
        if self._edges is not None:
            return len(self._edges)
        if self._factory is not None:
            return self._n_edges
        if self.fmt == "csr":
            from sheep_tpu_torch.io import csr

            return csr.read_header(self.path).n_edges
        if self.fmt == "text-gz":
            return None
        size = os.path.getsize(self.path)
        if self.fmt == "text":
            return (size + 1) // 4
        return size // self._pair_bytes()

    def clamp_chunk_edges(self, chunk_edges: int, parts: int = 1,
                          floor: int = 1024) -> int:
        """``chunk_edges`` shrunk for small streams by the O(1) size bound,
        divided over ``parts`` shards (the reference's rule, so the chunk
        sizes and the checkpoints' fingerprints agree)."""
        bound = self.num_edges_upper_bound
        if bound is None:
            return chunk_edges
        return min(chunk_edges, max(floor, -(-bound // parts)))

    @property
    def num_vertices(self) -> int:
        """max vertex id + 1: from a ``.csr`` header, else one streaming
        pass, unless given."""
        if self._n_vertices is None:
            if self.fmt == "csr":
                from sheep_tpu_torch.io import csr

                self._n_vertices = csr.read_header(self.path).n_vertices
                return self._n_vertices
            m = -1
            for chunk in self.chunks(1 << 22):
                if len(chunk):
                    m = max(m, int(chunk.max()))
            self._n_vertices = m + 1
        return self._n_vertices

    @property
    def num_edges(self) -> int:
        """The exact edge count: O(1) where ``num_edges_cheap`` has it,
        else one counting pass, kept (the lockstep batch count of a
        multi-process run over text or an unsized generator)."""
        cheap = self.num_edges_cheap
        if cheap is not None:
            return cheap
        if getattr(self, "_counted", None) is None:
            self._counted = sum(len(c) for c in self.chunks(1 << 22))
        return self._counted

    def chunks(self, chunk_edges: int = 1 << 22, start_chunk: int = 0,
               shard: int = 0, num_shards: int = 1,
               byte_range: bool = False) -> Iterator[np.ndarray]:
        """Chunks ``start_chunk``, ``start_chunk + 1``, ... of ``chunk_edges``
        edges (the global chunk index of a checkpoint). ``shard`` of
        ``num_shards`` keeps chunk i when ``i % num_shards == shard``
        (round robin over the workers); ``byte_range`` (plain text only)
        parses only the worker's byte span of the file instead, its local
        chunk j carrying the global index ``j * num_shards + shard``
        (the reference's ``chunks``; binary, memory and gzip streams
        ignore the flag)."""
        cs = int(chunk_edges)
        start = int(start_chunk)
        if not 0 <= shard < num_shards:
            raise ValueError(f"bad shard {shard}/{num_shards}")
        if num_shards == 1:
            own = None
        else:
            def own(idx):
                return _owns(idx, shard, num_shards, start)
        if self._factory is not None:
            yield from _regroup(self._factory(), cs, start, own)
        elif self._edges is not None:
            for idx, off in enumerate(range(start * cs, len(self._edges),
                                            cs), start):
                if own is None or own(idx):
                    yield self._edges[off:off + cs]
        elif self.fmt == "text" and byte_range:
            yield from self._chunks_text_span(cs, shard, num_shards, start)
        elif self.fmt == "text":
            yield from _regroup(_text_blocks(lambda: open(self.path, "rb")),
                                cs, start, own)
        elif self.fmt == "text-gz":
            # one sequential gzip member: every worker decompresses it and
            # keeps its round-robin chunks
            yield from _regroup(
                _text_blocks(lambda: gzip.open(self.path, "rb")), cs, start,
                own)
        elif self.fmt == "csr":
            yield from self._chunks_csr(cs, start, own)
        else:
            yield from self._chunks_binary(cs, start, own)

    def count_edges_in_span(self, shard: int, num_shards: int) -> int:
        """Edges in worker ``shard``'s byte span of a text file (one pass
        over the span, kept): what the processes of a byte-range run
        allgather to agree on their batch count."""
        key = (shard, num_shards)
        if not hasattr(self, "_span_counts"):
            self._span_counts: dict = {}
        if key not in self._span_counts:
            self._span_counts[key] = sum(
                len(c) for c in self.chunks(1 << 22, shard=shard,
                                            num_shards=num_shards,
                                            byte_range=True))
        return self._span_counts[key]

    def _chunks_text_span(self, cs: int, shard: int, num_shards: int,
                          start: int):
        """Only this worker's byte span [size * shard / P, size * (shard
        + 1) / P) of a text file, parsed by the native parser (the
        reference's ``_chunks_text_span``). A line belongs to the span of
        its first byte: a span entered mid-line skips to the next line,
        and a line that straddles the span's end is finished past it.
        Local chunk j is kept when its global index ``j * P + shard``
        is at least ``start``."""
        from sheep_tpu_torch.core import native

        size = os.path.getsize(self.path)
        lo = size * shard // num_shards
        hi = size * (shard + 1) // num_shards

        def spans():
            with open(self.path, "rb") as f:
                if lo > 0:
                    f.seek(lo - 1)
                    if f.read(1) != b"\n":
                        f.readline()  # the previous span's line
                tail = b""
                while f.tell() < hi:
                    block = f.read(min(TEXT_BLOCK_BYTES, hi - f.tell()))
                    if not block:
                        break
                    data = tail + block
                    edges, consumed = native.parse_text(data)
                    tail = data[consumed:]
                    if len(edges):
                        yield edges
                if tail:  # the line over the span's end, or EOF's
                    data = tail + f.readline()
                    if not data.endswith(b"\n"):
                        data += b"\n"
                    edges, _ = native.parse_text(data)
                    if len(edges):
                        yield edges

        yield from _regroup(spans(), cs, 0,
                            lambda j: j * num_shards + shard >= start)

    def _chunks_binary(self, cs: int, start: int, own=None):
        """Validated reads under the read retry: a torn trailing record and
        a short read go through the IO policy; ``"read"`` is the injection
        point, counted a physical read. ``own(i)``: keep chunk i (None:
        every chunk)."""
        from sheep_tpu_torch.utils import fault

        dtype = np.dtype("<u4") if self.fmt == "bin32" else np.dtype("<u8")
        pair = self._pair_bytes()
        policy = _read_retry_policy()
        size = os.path.getsize(self.path)
        if size % pair:
            # the edge count floors a torn record away: without this check
            # the damage would be a silent truncation
            _quarantine_or_raise(
                f"{self.path}: {size} bytes is not a multiple of the "
                f"{pair}-byte edge record ({size % pair} torn trailing "
                f"bytes)", path=self.path, torn_bytes=size % pair)
        total = size // pair
        with _retrying(policy, lambda: open(self.path, "rb"),
                       f"open {self.path}") as f:
            reads = 0
            for off in range(start * cs, total, cs):
                if own is not None and not own(off // cs):
                    continue
                reads += 1
                count = min(cs, total - off)

                def _read(off=off, count=count, reads=reads):
                    fault.maybe_fail("read", reads, kinds=("read",))
                    f.seek(off * pair)
                    return np.fromfile(f, dtype=dtype, count=2 * count)

                flat = _retrying(policy, _read,
                                 f"read {self.path} chunk {off // cs}")
                if len(flat) != 2 * count:
                    # the file shrank under the pass: never fold a half
                    # read; quarantine keeps the intact pairs before it
                    _quarantine_or_raise(
                        f"{self.path}: short read at chunk {off // cs} "
                        f"(wanted {count} edges at offset {off * pair}, "
                        f"got {len(flat) // 2} intact pairs) — stream "
                        f"truncated mid-pass", path=self.path,
                        chunk=off // cs, expected=int(count),
                        got=int(len(flat) // 2))
                    flat = flat[: 2 * (len(flat) // 2)]
                    if len(flat):
                        yield flat.reshape(-1, 2).astype(np.int64)
                    return
                yield flat.reshape(-1, 2).astype(np.int64)

    def _chunks_csr(self, cs: int, start: int, own=None):
        """Chunk i is the edge ids [i*cs, (i+1)*cs) of the file, as the
        reference's ``_chunks_csr`` cuts them."""
        from sheep_tpu_torch.io import csr

        g = csr.CsrGraph(self.path)
        try:
            total = g.n_edges
            for off in range(start * cs, total, cs):
                if own is None or own(off // cs):
                    yield g.edge_slice(off, min(off + cs, total))
        finally:
            g.close()


def _owns(idx: int, shard: int, num_shards: int, start: int) -> bool:
    """Chunk ``idx`` is worker ``shard``'s: at or past ``start`` and its
    turn of the round robin."""
    return idx >= start and idx % num_shards == shard


def _regroup(blocks, cs: int, start: int = 0, own=None):
    """Variable-size (c, 2) edge blocks regrouped into chunks of ``cs``
    edges and a last, shorter one, from chunk ``start`` on, or those
    chunks i with ``own(i)`` when given (the reference's
    ``EdgeStream._regroup``)."""
    if own is None:
        def own(idx):
            return idx >= start
    pend: list = []
    pend_n = 0
    idx = 0
    for block in blocks:
        block = np.asarray(block, dtype=np.int64).reshape(-1, 2)
        pend.append(block)
        pend_n += len(block)
        while pend_n >= cs:
            cat = np.concatenate(pend)
            if own(idx):
                yield cat[:cs]
            pend = [cat[cs:]]
            pend_n = len(pend[0])
            idx += 1
    if pend_n and own(idx):
        yield np.concatenate(pend)


TEXT_BLOCK_BYTES = 1 << 24


def _text_blocks(open_fn):
    """The edges of a text stream (``open_fn()`` opens it in binary, plain
    or gzip), one array per block of ``TEXT_BLOCK_BYTES`` read, as the
    reference's ``EdgeStream._text_blocks`` cuts them: the incomplete line
    at the end of a block is carried into the next, and a last line with
    no newline is parsed with one appended. Reads run under the read
    retry, each from an explicit seek to the bytes consumed so far (a
    failed read may have consumed bytes); a stream that cannot seek is not
    retried. ``"read"`` is the injection point, counted a block. A failed
    build of the native parser raises."""
    from sheep_tpu_torch.core import native
    from sheep_tpu_torch.utils import fault

    tail = b""
    policy = _read_retry_policy()
    nblocks = 0
    pos = 0  # bytes consumed, in the (decompressed) stream
    with _retrying(policy, open_fn, "open text stream") as f:
        try:
            seekable = bool(f.seekable())
        except Exception:  # noqa: BLE001, a stream without the query
            seekable = False
        while True:
            nblocks += 1

            def _read(nblocks=nblocks, pos=pos):
                fault.maybe_fail("read", nblocks, kinds=("read",))
                if seekable:
                    f.seek(pos)
                return f.read(TEXT_BLOCK_BYTES)

            block = _retrying(policy, _read, f"read text block {nblocks}") \
                if seekable else _read()
            pos += len(block)
            data = tail + block
            if not data:
                return
            if block:
                edges, consumed = native.parse_text(data)
                tail = data[consumed:]
            else:  # the last line, without its newline
                edges, _ = native.parse_text(data + b"\n")
            yield edges
            if not block:
                return


# the planted family's second structural knob and its stream class
_PLANTED = {"sbm-hash": ("BLOCKS", "SbmHashStream"),
            "plsbm-hash": ("BLOCKS", "PowerlawSbmHashStream"),
            "bipartite-hash": ("BLOCKS", "BipartiteHashStream"),
            "nearclique-hash": ("CLIQUE_BITS", "NearCliqueStream")}


def open_input(spec, n_vertices: Optional[int] = None):
    """Open an ``--input`` value with the reference's grammar:

    - ``rmat-hash:SCALE[:EF[:SEED]]``: counter-hash R-MAT (SCALE 1..32),
      chunks synthesized on the card;
    - ``rmat:SCALE[:EF[:SEED]]``: the PCG replay generator (SCALE 1..40);
    - ``sbm-hash:SCALE:BLOCKS:POUT[:EF[:SEED]]``, ``plsbm-hash:...``,
      ``bipartite-hash:...`` and ``nearclique-hash:SCALE:CLIQUE_BITS:POUT
      [:EF[:SEED]]``: the planted family (SCALE 1..31);
    - ``delta:LOG[@EPOCH]``: a mutating graph, the surviving multiset of
      a base input and an append-log of epoch-stamped add and tombstone
      records (``io/deltalog.py``), up to EPOCH when given; its builds
      take the anchored elimination order (the base segment's degrees);
    - anything else: a graph file path (text, gzip text, ``.bin32``,
      ``.bin64``, ``.csr``).

    A given ``n_vertices`` must not contradict a synthetic spec's
    2**SCALE."""
    from sheep_tpu_torch.io import generators

    spec = os.fspath(spec)
    kind, _, rest = spec.partition(":")
    if kind == "delta" and rest:
        from sheep_tpu_torch.io.deltalog import open_delta

        return open_delta(rest, n_vertices=n_vertices)
    if kind in _PLANTED and rest:
        argname, clsname = _PLANTED[kind]
        shape = f"{kind}:SCALE:{argname}:POUT[:EF[:SEED]]"
        parts = rest.split(":")
        if not 3 <= len(parts) <= 5:
            raise ValueError(
                f"bad synthetic input spec {spec!r}; want {shape}")
        try:
            scale, arg = int(parts[0]), int(parts[1])
            p_out = float(parts[2])
            ef = int(parts[3]) if len(parts) > 3 else 16
            seed = int(parts[4]) if len(parts) > 4 else 0
        except ValueError:
            raise ValueError(
                f"bad synthetic input spec {spec!r}; want {shape} "
                f"(POUT a float, the rest integers)")
        if not (1 <= scale <= 31) or ef < 1:
            raise ValueError(f"bad synthetic input spec {spec!r}: "
                             f"need 1 <= SCALE <= 31 and EF >= 1")
        _check_n_vertices(spec, scale, n_vertices)
        # the blocks / clique_bits / p_out checks are each class's
        return getattr(generators, clsname)(scale, arg, p_out,
                                            edge_factor=ef, seed=seed)
    if kind in ("rmat-hash", "rmat") and rest:
        parts = rest.split(":")
        if len(parts) > 3:
            raise ValueError(
                f"bad synthetic input spec {spec!r}; want "
                f"{kind}:SCALE[:EF[:SEED]] (got {len(parts)} fields)")
        try:
            scale = int(parts[0])
            ef = int(parts[1]) if len(parts) > 1 else 16
            seed = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            raise ValueError(
                f"bad synthetic input spec {spec!r}; want "
                f"{kind}:SCALE[:EF[:SEED]] with integer fields")
        # rmat-hash accumulates vertex bits in uint32; the PCG path in int64
        max_scale = 32 if kind == "rmat-hash" else 40
        if not (1 <= scale <= max_scale) or ef < 1:
            raise ValueError(f"bad synthetic input spec {spec!r}: "
                             f"need 1 <= SCALE <= {max_scale} and EF >= 1")
        _check_n_vertices(spec, scale, n_vertices)
        if kind == "rmat-hash":
            return generators.RmatHashStream(scale, ef, seed=seed)
        return EdgeStream.from_generator(
            lambda: generators.rmat_stream(scale, ef, seed=seed),
            n_vertices=1 << scale, num_edges=ef << scale)
    return EdgeStream.open(spec, n_vertices=n_vertices)


def _check_n_vertices(spec: str, scale: int, n_vertices) -> None:
    if n_vertices is not None and n_vertices != 1 << scale:
        raise ValueError(
            f"--num-vertices {n_vertices} contradicts {spec!r} "
            f"(2**{scale} = {1 << scale} vertices)")
