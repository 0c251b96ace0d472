"""ctypes loader for the port's native host code (``csrc/sheep_core.cpp``;
counterpart of ``tree_split``, ``parse_text``, ``build_elim_tree``,
``rmat_hash_range`` and ``sbm_hash_range`` in ``sheep_tpu/core/native.py``).

The library is built with the host C++ compiler at first use (no
``nvcc``), by ``sheep_tpu_torch.ops._build``. A failed build or load
raises: the port has no quiet fallback to the Python split, no Python
text parser, and no fixpoint host tail without the native pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

ABI_VERSION = 5

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")


class _f64p_or_null(_f64p):
    """float64 ndpointer that also accepts None, passed as NULL (unit
    weights)."""

    @classmethod
    def from_param(cls, obj):
        if obj is None:
            return None
        return _f64p.from_param(obj)


_LIB: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with its C signatures
    declared (cached)."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("sheep_core")
        lib.sheep_core_abi_version.restype = ctypes.c_int64
        if lib.sheep_core_abi_version() != ABI_VERSION:
            raise RuntimeError("sheep_core ABI mismatch: the built library "
                               "does not match core/native.py")
        c_i64 = ctypes.c_int64
        lib.sheep_tree_split.argtypes = [_i64p, _i64p, _f64p_or_null, c_i64,
                                         c_i64, ctypes.c_double, _i32p]
        lib.sheep_tree_split.restype = ctypes.c_int
        lib.sheep_parse_text.argtypes = [ctypes.c_char_p, c_i64, _i64p,
                                         c_i64, ctypes.POINTER(c_i64)]
        lib.sheep_parse_text.restype = c_i64
        lib.sheep_build_elim_tree.argtypes = [_i64p, c_i64, _i64p, c_i64,
                                              _i64p]
        lib.sheep_build_elim_tree.restype = ctypes.c_int
        u32 = ctypes.c_uint32
        lib.sheep_rmat_hash_range.argtypes = [c_i64, c_i64, c_i64, _u32p,
                                              _u32p, u32, u32, u32, _i64p]
        lib.sheep_rmat_hash_range.restype = None
        lib.sheep_sbm_hash_range.argtypes = [c_i64, c_i64, _u32p, _u32p,
                                             u32, c_i64, c_i64, _i64p]
        lib.sheep_sbm_hash_range.restype = None
        _LIB = lib
    return _LIB


def tree_split(parent: np.ndarray, pos: np.ndarray, k: int,
               weights: Optional[np.ndarray] = None,
               alpha: float = 1.0) -> np.ndarray:
    """The greedy k-way split of the forest (``parent``, ``pos``), bit-equal
    to :func:`sheep_tpu_torch.core.pure.tree_split`. ``pos`` must be a
    permutation of ``range(len(parent))``, and each vertex's parent (a
    negative parent marks a root) must come after it in ``pos``. The C
    code checks both as it goes, since it indexes by them; arguments that
    break this raise ValueError."""
    lib = load()
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    n = len(parent)
    if len(pos) != n:
        raise ValueError(f"tree_split: parent has {n} entries, pos "
                         f"{len(pos)}")
    if k < 1:
        raise ValueError(f"tree_split: k must be >= 1, got {k}")
    # weights=None -> NULL: unit weights without an O(n) array of ones
    w = None if weights is None \
        else np.ascontiguousarray(weights, dtype=np.float64)
    if w is not None and len(w) != n:
        raise ValueError(f"tree_split: {len(w)} weights for {n} vertices")
    assign = np.empty(n, dtype=np.int32)
    rc = lib.sheep_tree_split(parent, pos, w, n, k, alpha, assign)
    if rc == -1:
        raise ValueError(f"tree_split: pos is not a permutation of "
                         f"range({n})")
    if rc == -2:
        raise ValueError(f"tree_split: parent is not a forest in pos order "
                         f"(a parent >= {n}, or not after its child)")
    return assign


def parse_text(data: bytes):
    """The complete lines of a text block -> ``(edges, consumed)``: int64
    (m, 2) edges in the reference's text grammar (``csrc/sheep_core.cpp``
    ``sheep_parse_text``) and the bytes of ``data`` they came from; the
    rest is an incomplete last line."""
    lib = load()
    cap = len(data) // 3 + 1  # a line that holds an edge is >= 4 bytes
    out = np.empty((cap, 2), dtype=np.int64)
    consumed = ctypes.c_int64(0)
    count = lib.sheep_parse_text(data, len(data), out.reshape(-1), cap,
                                 ctypes.byref(consumed))
    return out[:count].copy(), consumed.value


def build_elim_tree(edges: np.ndarray, pos: np.ndarray,
                    parent: Optional[np.ndarray] = None) -> np.ndarray:
    """Extend the elimination forest ``parent`` (int64[n], -1 for a root;
    all roots when None) with the constraints of ``edges`` (m, 2) under
    the elimination positions ``pos``, by the reference's native Liu pass
    (``csrc/sheep_core.cpp`` ``sheep_build_elim_tree``). A contiguous
    int64 ``parent`` is updated in place and returned. Self-loops and ids
    outside [0, n) are skipped; a ``pos`` that is not a permutation of
    ``range(n)``, or a parent >= n, raises ValueError."""
    lib = load()
    e = np.ascontiguousarray(np.asarray(edges).reshape(-1, 2),
                             dtype=np.int64)
    p = np.ascontiguousarray(pos, dtype=np.int64)
    n = len(p)
    if parent is None:
        parent = np.full(n, -1, dtype=np.int64)
    else:
        parent = np.ascontiguousarray(parent, dtype=np.int64)
    if len(parent) != n:
        raise ValueError(f"build_elim_tree: parent has {len(parent)} "
                         f"entries, pos {n}")
    rc = lib.sheep_build_elim_tree(e.reshape(-1), len(e), p, n, parent)
    if rc == -1:
        raise ValueError(f"build_elim_tree: pos is not a permutation of "
                         f"range({n})")
    if rc == -2:
        raise ValueError(f"build_elim_tree: a parent is >= {n}")
    return parent


def rmat_hash_range(scale: int, start: int, count: int, keys, keys2,
                    thresholds) -> np.ndarray:
    """Edges [start, start+count) of the counter-hash R-MAT stream, (count,
    2) int64, by the native loop: bit-equal to
    ``io/generators.py _rmat_hash_uv``. ``keys`` / ``keys2`` are the
    per-level uint32 constants, ``thresholds`` (t_u, t_v0, t_v1)."""
    lib = load()
    out = np.empty((count, 2), dtype=np.int64)
    lib.sheep_rmat_hash_range(
        scale, start, count, np.ascontiguousarray(keys, dtype=np.uint32),
        np.ascontiguousarray(keys2, dtype=np.uint32), *map(int, thresholds),
        out.reshape(-1))
    return out


def sbm_hash_range(start: int, count: int, keys, keys2, t_out: int,
                   n_blocks: int, block_bits: int) -> np.ndarray:
    """Edges [start, start+count) of the counter-hash planted partition,
    (count, 2) int64, by the native loop: bit-equal to
    ``io/generators.py _sbm_hash_uv``."""
    lib = load()
    out = np.empty((count, 2), dtype=np.int64)
    lib.sheep_sbm_hash_range(
        start, count, np.ascontiguousarray(keys, dtype=np.uint32),
        np.ascontiguousarray(keys2, dtype=np.uint32), int(t_out),
        int(n_blocks), int(block_bits), out.reshape(-1))
    return out
