"""Chunked edge streams of the port (a subset of ``sheep_tpu/io/edgestream.py``).

Every stream provides ``num_vertices``, ``num_edges_cheap``,
``num_edges_upper_bound``, ``clamp_chunk_edges`` and ``chunks(cs)``, which
yields (<= cs, 2) int64 host arrays: chunk i holds edges [i*cs, (i+1)*cs)
in stream order, exactly as the reference cuts them, so the fixpoint sees
the same segments and counts the same rounds. Text (plain or gzip) is parsed by the port's copy
of the reference's native parser, so both read the same edges from the
same file; ``.csr`` files are read through ``io/csr.py``; a generator
stream regroups the blocks of a re-openable factory.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, Optional

import numpy as np

from sheep_tpu_torch.io import formats


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

    def clamp_chunk_edges(self, chunk_edges: int, floor: int = 1024) -> int:
        bound = self.num_edges_upper_bound
        if bound is None:
            return chunk_edges
        return min(chunk_edges, max(floor, bound))

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

    def chunks(self, chunk_edges: int = 1 << 22) -> Iterator[np.ndarray]:
        cs = int(chunk_edges)
        if self._factory is not None:
            yield from _regroup(self._factory(), cs)
        elif self._edges is not None:
            for off in range(0, len(self._edges), cs):
                yield self._edges[off:off + cs]
        elif self.fmt == "text":
            yield from _regroup(_text_blocks(lambda: open(self.path, "rb")),
                                cs)
        elif self.fmt == "text-gz":
            yield from _regroup(
                _text_blocks(lambda: gzip.open(self.path, "rb")), cs)
        elif self.fmt == "csr":
            yield from self._chunks_csr(cs)
        else:
            yield from self._chunks_binary(cs)

    def _chunks_binary(self, cs: int):
        dtype = np.dtype("<u4") if self.fmt == "bin32" else np.dtype("<u8")
        pair = self._pair_bytes()
        size = os.path.getsize(self.path)
        if size % pair:
            raise ValueError(f"{self.path}: {size} bytes is not a multiple "
                             f"of the {pair}-byte edge record")
        total = size // pair
        with open(self.path, "rb") as f:
            for off in range(0, total, cs):
                count = min(cs, total - off)
                f.seek(off * pair)
                flat = np.fromfile(f, dtype=dtype, count=2 * count)
                if len(flat) != 2 * count:
                    raise ValueError(f"{self.path}: short read at edge "
                                     f"{off}; the file changed mid-pass")
                yield flat.reshape(-1, 2).astype(np.int64)

    def _chunks_csr(self, cs: int):
        """Chunk i is the edge ids [i*cs, (i+1)*cs) of the file, as the
        reference's ``_chunks_csr`` cuts them."""
        from sheep_tpu_torch.io import csr

        g = csr.CsrGraph(self.path)
        try:
            total = g.n_edges
            for off in range(0, total, cs):
                yield g.edge_slice(off, min(off + cs, total))
        finally:
            g.close()


def _regroup(blocks, cs: int):
    """Variable-size (c, 2) edge blocks regrouped into chunks of ``cs``
    edges and a last, shorter one (the reference's
    ``EdgeStream._regroup``)."""
    pend: list = []
    pend_n = 0
    for block in blocks:
        block = np.asarray(block, dtype=np.int64).reshape(-1, 2)
        pend.append(block)
        pend_n += len(block)
        while pend_n >= cs:
            cat = np.concatenate(pend)
            yield cat[:cs]
            pend = [cat[cs:]]
            pend_n = len(pend[0])
    if pend_n:
        yield np.concatenate(pend)


TEXT_BLOCK_BYTES = 1 << 24


def _text_blocks(open_fn):
    """The edges of a text stream (``open_fn()`` opens it in binary, plain
    or gzip), one array per block of ``TEXT_BLOCK_BYTES`` read, as the
    reference's ``EdgeStream._text_blocks`` cuts them: the incomplete line
    at the end of a block is carried into the next, and a last line with
    no newline is parsed with one appended. A failed build of the native
    parser raises."""
    from sheep_tpu_torch.core import native

    tail = b""
    with open_fn() as f:
        while True:
            block = f.read(TEXT_BLOCK_BYTES)
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
    - anything else: a graph file path (text, gzip text, ``.bin32``,
      ``.bin64``, ``.csr``).

    ``delta:`` inputs are not ported and raise. A given ``n_vertices``
    must not contradict a synthetic spec's 2**SCALE."""
    from sheep_tpu_torch.io import generators

    spec = os.fspath(spec)
    kind, _, rest = spec.partition(":")
    if kind == "delta" and rest:
        raise ValueError(f"{spec!r}: delta-log inputs are not ported yet "
                         f"(ROADMAP Queue 1 item 6)")
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
