"""Chunked edge streams of the port (a subset of ``sheep_tpu/io/edgestream.py``).

Every stream provides ``num_vertices``, ``clamp_chunk_edges`` and
``chunks(cs)``, which yields (<= cs, 2) int64 host arrays: chunk i holds
edges [i*cs, (i+1)*cs) in stream order, exactly as the reference cuts them,
so the fixpoint sees the same segments and counts the same rounds. Text
is parsed by the port's copy of the reference's native parser, so both
read the same edges from the same file.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from sheep_tpu_torch.io import formats


class EdgeStream:
    """A re-openable stream over a file or an in-memory edge array."""

    def __init__(self, path: Optional[str] = None,
                 edges: Optional[np.ndarray] = None,
                 n_vertices: Optional[int] = None):
        if (path is None) == (edges is None):
            raise ValueError("exactly one of path / edges required")
        self.path = path
        self._edges = None if edges is None \
            else np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.fmt = formats.detect_format(path) if path else "memory"
        self._n_vertices = n_vertices

    @classmethod
    def open(cls, path: str, n_vertices: Optional[int] = None):
        return cls(path=path, n_vertices=n_vertices)

    @classmethod
    def from_array(cls, edges: np.ndarray, n_vertices: Optional[int] = None):
        return cls(edges=edges, n_vertices=n_vertices)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _pair_bytes(self) -> int:
        return 8 if self.fmt == "bin32" else 16

    def num_edges_upper_bound(self) -> int:
        """Exact for memory and binary streams; for text the floor of 4
        bytes per edge line ("0 1\\n"), +1 for a missing final newline."""
        if self._edges is not None:
            return len(self._edges)
        size = os.path.getsize(self.path)
        if self.fmt == "text":
            return (size + 1) // 4
        return size // self._pair_bytes()

    def clamp_chunk_edges(self, chunk_edges: int, floor: int = 1024) -> int:
        return min(chunk_edges, max(floor, self.num_edges_upper_bound()))

    @property
    def num_vertices(self) -> int:
        """max vertex id + 1 (one streaming pass unless given)."""
        if self._n_vertices is None:
            m = -1
            for chunk in self.chunks(1 << 22):
                if len(chunk):
                    m = max(m, int(chunk.max()))
            self._n_vertices = m + 1
        return self._n_vertices

    def chunks(self, chunk_edges: int) -> Iterator[np.ndarray]:
        cs = int(chunk_edges)
        if self._edges is not None:
            for off in range(0, len(self._edges), cs):
                yield self._edges[off:off + cs]
        elif self.fmt == "text":
            yield from self._chunks_text(cs)
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

    def _chunks_text(self, cs: int):
        """Text through the native parser (``core/native.parse_text``, the
        reference's grammar), block by block, regrouped into chunks of
        ``cs`` edges."""
        pend: list = []
        pend_n = 0
        for edges in _text_blocks(self.path):
            pend.append(edges)
            pend_n += len(edges)
            while pend_n >= cs:
                cat = np.concatenate(pend)
                yield cat[:cs]
                pend = [cat[cs:]]
                pend_n = len(pend[0])
        if pend_n:
            yield np.concatenate(pend)


TEXT_BLOCK_BYTES = 1 << 24


def _text_blocks(path: str):
    """The edges of a text file, one array per block of
    ``TEXT_BLOCK_BYTES`` read, as the reference's
    ``EdgeStream._text_blocks`` cuts them: the incomplete line at the end
    of a block is carried into the next, and a last line with no newline
    is parsed with one appended. A failed build of the native parser
    raises."""
    from sheep_tpu_torch.core import native

    tail = b""
    with open(path, "rb") as f:
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


def open_input(spec, n_vertices: Optional[int] = None):
    """Open an ``--input`` value: ``rmat-hash:SCALE[:EF[:SEED]]`` or a
    graph file path (text, ``.bin32``, ``.bin64``). Other specs raise
    ``ValueError``."""
    spec = os.fspath(spec)
    kind, _, rest = spec.partition(":")
    if kind == "rmat-hash" and rest:
        from sheep_tpu_torch.io.generators import RmatHashStream

        parts = rest.split(":")
        try:
            if len(parts) > 3:
                raise ValueError
            scale = int(parts[0])
            ef = int(parts[1]) if len(parts) > 1 else 16
            seed = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            raise ValueError(f"bad synthetic input spec {spec!r}; want "
                             f"rmat-hash:SCALE[:EF[:SEED]] with integers")
        if not (1 <= scale <= 31) or ef < 1:
            raise ValueError(f"bad synthetic input spec {spec!r}: need "
                             f"1 <= SCALE <= 31 and EF >= 1")
        if n_vertices is not None and n_vertices != 1 << scale:
            raise ValueError(f"n_vertices {n_vertices} contradicts {spec!r}")
        return RmatHashStream(scale, ef, seed=seed)
    if ":" in spec and not os.path.exists(spec):
        raise ValueError(f"unsupported input spec {spec!r}; the port reads "
                         f"rmat-hash:SCALE[:EF[:SEED]] and edge-list files")
    return EdgeStream.open(spec, n_vertices=n_vertices)
