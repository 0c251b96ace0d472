"""On-disk graph formats of the port (a subset of ``sheep_tpu/io/formats.py``).

- text edge list (``.edges``/``.txt``/``.el``/``.snap``), plain or gzip
  (``.edges.gz`` etc., "text-gz"): one ``u v`` pair per line; ``#``/``%``
  comments, blank and malformed lines are skipped, extra columns ignored
  (the grammar is the native parser's, ``csrc/sheep_core.cpp``
  ``sheep_parse_text``).
- binary edge list: raw little-endian pairs, ``.bin32``/``.bin`` uint32,
  ``.bin64`` uint64.
- ``.csr``: the JAX package's memory-mapped CSR file (read by
  ``io/csr.py``).
- partition map: ``.parts`` text (line i = part of vertex i) or ``.pbin``
  raw little-endian int32.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

TEXT_EXTS = (".edges", ".txt", ".el", ".snap")
BIN32_EXTS = (".bin32", ".bin")
BIN64_EXTS = (".bin64",)
CSR_EXTS = (".csr",)


def detect_format(path: str) -> str:
    base, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext == ".gz":
        inner = os.path.splitext(base)[1].lower()
        if inner in TEXT_EXTS:
            return "text-gz"
        raise ValueError(
            f"gzip is supported for text edge lists only, not {inner!r} "
            f"({path!r}); decompress binary formats first")
    if ext in TEXT_EXTS:
        return "text"
    if ext in BIN32_EXTS:
        return "bin32"
    if ext in BIN64_EXTS:
        return "bin64"
    if ext in CSR_EXTS:
        return "csr"
    raise ValueError(f"unknown graph format for {path!r} (ext {ext!r})")


def write_edges(path: str, edges: np.ndarray) -> None:
    """Text (gzip with a fixed header, so equal edges give equal bytes) or
    binary; ``.csr`` files are not written by the port."""
    fmt = detect_format(path)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if fmt in ("text", "text-gz"):
        text = "".join(f"{u} {v}\n" for u, v in e).encode()
        if fmt == "text-gz":
            with open(path, "wb") as raw, gzip.GzipFile(
                    filename="", fileobj=raw, mode="wb", mtime=0) as f:
                f.write(text)
        else:
            with open(path, "wb") as f:
                f.write(text)
    elif fmt == "csr":
        raise ValueError("the port does not write .csr files")
    else:
        np.ascontiguousarray(
            e, dtype="<u4" if fmt == "bin32" else "<u8").tofile(path)


def write_partition(path: str, assignment: np.ndarray) -> None:
    if path.endswith(".pbin"):
        np.ascontiguousarray(assignment, dtype="<i4").tofile(path)
    else:
        with open(path, "w") as f:
            f.write("".join(f"{int(p)}\n" for p in assignment))


def read_partition(path: str) -> np.ndarray:
    if path.endswith(".pbin"):
        return np.fromfile(path, dtype=np.dtype("<i4")).astype(np.int32)
    with open(path) as f:
        return np.array([int(x) for x in f.read().split()], dtype=np.int32)
