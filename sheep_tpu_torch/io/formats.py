"""On-disk graph formats of the port (a subset of ``sheep_tpu/io/formats.py``).

- text edge list (``.edges``/``.txt``/``.el``/``.snap``): one ``u v`` pair
  per line; ``#``/``%`` comments, blank and malformed lines are skipped,
  extra columns ignored (the grammar is the native parser's,
  ``csrc/sheep_core.cpp`` ``sheep_parse_text``).
- binary edge list: raw little-endian pairs, ``.bin32``/``.bin`` uint32,
  ``.bin64`` uint64.
- partition map: ``.parts`` text (line i = part of vertex i) or ``.pbin``
  raw little-endian int32.
"""

from __future__ import annotations

import os

import numpy as np

TEXT_EXTS = (".edges", ".txt", ".el", ".snap")
BIN32_EXTS = (".bin32", ".bin")
BIN64_EXTS = (".bin64",)


def detect_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in TEXT_EXTS:
        return "text"
    if ext in BIN32_EXTS:
        return "bin32"
    if ext in BIN64_EXTS:
        return "bin64"
    raise ValueError(f"unknown graph format for {path!r} (ext {ext!r}); "
                     f"the port reads text, .bin32 and .bin64 edge lists")


def write_edges(path: str, edges: np.ndarray) -> None:
    fmt = detect_format(path)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if fmt == "text":
        with open(path, "w") as f:
            for u, v in e:
                f.write(f"{u} {v}\n")
    else:
        np.ascontiguousarray(
            e, dtype="<u4" if fmt == "bin32" else "<u8").tofile(path)


def write_partition(path: str, assignment: np.ndarray) -> None:
    if path.endswith(".pbin"):
        np.ascontiguousarray(assignment, dtype="<i4").tofile(path)
    else:
        with open(path, "w") as f:
            f.write("".join(f"{int(p)}\n" for p in assignment))
