"""Reader of the JAX package's memory-mapped CSR files (counterpart of
``CsrHeader``, ``read_header`` and ``CsrGraph`` in ``sheep_tpu/io/csr.py``).

Layout (little-endian, a 32-byte header)::

    magic    8s   = b"SHEEPCSR"
    version  u32  = 1
    flags    u32    bit0: indices are int64 (else int32)
    n_vertices u64
    n_edges    u64
    indptr   int64[n_vertices + 1]
    indices  int32|int64[n_edges]

Vertex ``u`` owns edge ids ``[indptr[u], indptr[u+1])``; ``indices`` holds
their destinations. Edge ids address the stream, so a chunk of edges
``[start, end)`` is one ``searchsorted`` on the mapped ``indptr`` away.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"SHEEPCSR"
VERSION = 1
_HEADER = struct.Struct("<8sIIQQ")
HEADER_BYTES = _HEADER.size  # 32
FLAG_WIDE = 1  # indices stored as int64


class CsrHeader:
    __slots__ = ("n_vertices", "n_edges", "wide")

    def __init__(self, n_vertices: int, n_edges: int, wide: bool):
        self.n_vertices = n_vertices
        self.n_edges = n_edges
        self.wide = wide

    @property
    def indptr_offset(self) -> int:
        return HEADER_BYTES

    @property
    def indices_offset(self) -> int:
        return HEADER_BYTES + 8 * (self.n_vertices + 1)

    @property
    def indices_dtype(self) -> np.dtype:
        return np.dtype("<i8") if self.wide else np.dtype("<i4")


def read_header(path: str) -> CsrHeader:
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    if len(raw) < HEADER_BYTES:
        raise ValueError(f"{path!r}: truncated CSR header")
    magic, version, flags, n, e = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"{path!r}: not a SHEEPCSR file (magic {magic!r})")
    if version != VERSION:
        raise ValueError(f"{path!r}: CSR version {version} "
                         f"(this build reads {VERSION})")
    return CsrHeader(n, e, bool(flags & FLAG_WIDE))


class CsrGraph:
    """Read-only memory map of a ``.csr`` file, held while it lives."""

    def __init__(self, path: str):
        self.path = path
        self.header = h = read_header(path)
        self._indptr = np.memmap(path, dtype="<i8", mode="r",
                                 offset=h.indptr_offset,
                                 shape=(h.n_vertices + 1,))
        self._indices = np.memmap(path, dtype=h.indices_dtype, mode="r",
                                  offset=h.indices_offset,
                                  shape=(h.n_edges,))

    @property
    def n_vertices(self) -> int:
        return self.header.n_vertices

    @property
    def n_edges(self) -> int:
        return self.header.n_edges

    def edge_slice(self, start: int, end: int) -> np.ndarray:
        """Edges with ids in ``[start, end)`` as an (end-start, 2) int64
        array: O(log V) to find the vertex span, then O(output)."""
        e = self.header.n_edges
        start = max(0, min(start, e))
        end = max(start, min(end, e))
        if end == start:
            return np.zeros((0, 2), dtype=np.int64)
        indptr = self._indptr
        lo = int(np.searchsorted(indptr, start, side="right")) - 1
        hi = int(np.searchsorted(indptr, end, side="left")) - 1
        starts = np.maximum(np.asarray(indptr[lo:hi + 1], dtype=np.int64),
                            start)
        ends = np.minimum(np.asarray(indptr[lo + 1:hi + 2], dtype=np.int64),
                          end)
        out = np.empty((end - start, 2), dtype=np.int64)
        out[:, 0] = np.repeat(np.arange(lo, hi + 1, dtype=np.int64),
                              ends - starts)
        out[:, 1] = self._indices[start:end]
        return out

    def close(self) -> None:
        # the maps are released when nothing refers to them
        self._indptr = self._indices = None
