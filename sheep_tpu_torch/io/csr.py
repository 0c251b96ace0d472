"""Memory-mapped CSR graph files (the port's copy of ``sheep_tpu/io/csr.py``:
the same bytes, so either package reads and writes the other's).

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
``[start, end)`` is one ``searchsorted`` on the mapped ``indptr`` away, and
the arcs leaving a vertex set are one gather (:meth:`CsrGraph.arcs_from`,
what the incremental scorer reads). Duplicates and self-loops are kept;
edges regroup under their source, in input order within a vertex.

    python -m sheep_tpu_torch.io.csr INPUT OUTPUT.csr [NUM_VERTICES]
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Optional

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

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr

    def neighbors(self, u: int) -> np.ndarray:
        return np.asarray(
            self._indices[self._indptr[u]:self._indptr[u + 1]],
            dtype=np.int64)

    def arcs_from(self, vertices: np.ndarray) -> tuple:
        """Every arc leaving ``vertices`` as ``(src, dst)`` int64 arrays,
        one fancy-index over the mapped ``indices``."""
        vs = np.asarray(vertices, dtype=np.int64).reshape(-1)
        z = np.zeros(0, dtype=np.int64)
        if not len(vs):
            return z, z
        starts = np.asarray(self._indptr[vs], dtype=np.int64)
        counts = np.asarray(self._indptr[vs + 1], dtype=np.int64) - starts
        total = int(counts.sum())
        if total == 0:
            return z, z
        src = np.repeat(vs, counts)
        # each vertex's start broadcast along its run of arcs
        cum = np.zeros(len(vs), dtype=np.int64)
        np.cumsum(counts[:-1], out=cum[1:])
        eid = (np.arange(total, dtype=np.int64)
               - np.repeat(cum, counts) + np.repeat(starts, counts))
        return src, np.asarray(self._indices[eid], dtype=np.int64)

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


def write_csr(path: str, stream, n_vertices: Optional[int] = None,
              chunk_edges: int = 1 << 22) -> CsrHeader:
    """Write any edge stream as a ``.csr`` file in two passes (out-degrees,
    then each chunk's destinations scattered into their sources' slots
    through a write cursor a vertex), with O(V) host memory. The file lands
    in ``path + '.tmp'`` and is renamed over ``path`` when whole."""
    n = stream.num_vertices if n_vertices is None else n_vertices
    deg = np.zeros(n, dtype=np.int64)
    e_total = 0
    for chunk in stream.chunks(chunk_edges):
        if len(chunk) == 0:
            continue
        if int(chunk.min()) < 0 or int(chunk.max()) >= n:
            raise ValueError(f"edge endpoint out of range [0, {n})")
        deg += np.bincount(np.asarray(chunk[:, 0], dtype=np.int64),
                           minlength=n)
        e_total += len(chunk)
    wide = n > np.iinfo(np.int32).max
    header = CsrHeader(n, e_total, wide)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, FLAG_WIDE if wide else 0, n,
                             e_total))
        indptr.astype("<i8", copy=False).tofile(f)
        f.truncate(header.indices_offset
                   + e_total * header.indices_dtype.itemsize)
    cursor = indptr[:-1].copy()
    if e_total:
        mm = np.memmap(tmp, dtype=header.indices_dtype, mode="r+",
                       offset=header.indices_offset, shape=(e_total,))
        for chunk in stream.chunks(chunk_edges):
            if len(chunk) == 0:
                continue
            u = np.asarray(chunk[:, 0], dtype=np.int64)
            v = np.asarray(chunk[:, 1], dtype=np.int64)
            order = np.argsort(u, kind="stable")
            us = u[order]
            # each edge's rank in its vertex's run of this chunk
            boundary = np.empty(len(us), dtype=bool)
            boundary[0] = True
            np.not_equal(us[1:], us[:-1], out=boundary[1:])
            group_start = np.maximum.accumulate(
                np.where(boundary, np.arange(len(us)), 0))
            mm[cursor[us] + np.arange(len(us)) - group_start] = v[order]
            cursor[us[boundary]] += np.diff(
                np.append(np.flatnonzero(boundary), len(us)))
        mm.flush()
        del mm
    if not np.array_equal(cursor, indptr[1:]):
        raise RuntimeError("CSR conversion: stream changed between passes")
    os.replace(tmp, path)
    return header


def main(argv=None) -> int:
    """Convert any input (a file or a synthetic spec) to CSR."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print("usage: python -m sheep_tpu_torch.io.csr INPUT OUTPUT.csr "
              "[NUM_VERTICES]", file=sys.stderr)
        return 2
    from sheep_tpu_torch.io.edgestream import open_input

    n = int(argv[2]) if len(argv) == 3 else None
    h = write_csr(argv[1], open_input(argv[0], n_vertices=n))
    print(f"wrote {argv[1]}: {h.n_vertices} vertices, {h.n_edges} edges, "
          f"{'int64' if h.wide else 'int32'} indices")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
