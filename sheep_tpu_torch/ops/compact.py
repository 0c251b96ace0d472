"""Live-pair compaction of the adaptive fixpoint driver (counterpart of
``compact_actives(..., dedup=True)`` and ``count_live_distinct``,
``sheep_tpu/ops/elim.py:1055`` and ``:1089``).

``compact_live(lo, hi, n, size)`` packs the live (lo, hi) constraints of
a round's slots into ``size`` slots: duplicate pairs are dropped, the
rest come in ascending (lo, hi) order, and the slots after them hold the
inert (n, n). The fixpoint depends only on the set of live constraints,
so a compacted buffer folds to the same forest. On CUDA tensors it runs
the kernels of ``csrc/compact.cu``: :func:`sort_keys` packs each pair
into one key ``lo << b | hi`` (b the bits of n) and sorts the keys alone
over their 2b bits (cub's radix sort, where the JAX package's
``lax.sort`` orders two keys), then :func:`compact_sorted` keeps the
live first pair of each run. On CPU tensors it runs
:func:`compact_live_plain`; anything else raises. ``LAUNCHES`` counts
the launches of the whole compaction (one a call).
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"compact_live": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _packed(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (lo.long() << 32) | hi.long()


def compact_live_plain(lo: torch.Tensor, hi: torch.Tensor, n: int,
                       size: int):
    """The plain version of :func:`compact_live`."""
    key = torch.sort(_packed(lo, hi)).values
    slo, shi = (key >> 32).int(), (key & 0xFFFFFFFF).int()
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    sel = ((slo != n) & first).nonzero().squeeze(1)[:size]
    out_lo = torch.full((size,), n, dtype=torch.int32, device=lo.device)
    out_hi = torch.full((size,), n, dtype=torch.int32, device=lo.device)
    out_lo[:len(sel)] = slo[sel]
    out_hi[:len(sel)] = shi[sel]
    return out_lo, out_hi


def count_live_distinct(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """(live pairs, distinct live pairs), as two Python ints."""
    key = torch.unique(_packed(lo[lo != n], hi[lo != n]))
    return int((lo != n).sum()), int(key.numel())


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("compact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ull = ctypes.c_ulonglong
        lib.sheep_compact_sort_bytes.argtypes = [ll, i,
                                                 ctypes.POINTER(ull)]
        lib.sheep_compact_sort_bytes.restype = i
        lib.sheep_compact_sort.argtypes = [p, p, ll, i, p, p, p, ull, p]
        lib.sheep_compact_sort.restype = i
        lib.sheep_compact_live.argtypes = [p, ll, i, i, p, p, p, ll, p]
        lib.sheep_compact_live.restype = i
        lib.sheep_compact_tile.restype = ll
        lib.sheep_compact_error_string.argtypes = [i]
        lib.sheep_compact_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.sheep_compact_error_string(rc).decode())


def key_bits(n: int) -> int:
    """b, the bits of a half of the packed key ``lo << b | hi``: enough
    for n, the largest value a half holds."""
    return max(1, int(n).bit_length())


def compact_live(lo: torch.Tensor, hi: torch.Tensor, n: int, size: int):
    """``(out_lo, out_hi)`` int32[size]: the distinct live pairs of the
    1-D slots (lo, hi) in ascending order, then (n, n); pairs past
    ``size`` are dropped (the caller sizes it above the live count).
    Entries must lie in [0, n], lo == n only on a dead slot (n, n)."""
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"compact_live: {name} must be a contiguous "
                             f"int32 vector")
    if lo.shape != hi.shape or lo.device != hi.device:
        raise ValueError("compact_live: lo and hi differ in shape or device")
    if not 0 <= n < 2**31 or size < 0 or len(lo) >= 2**31:
        raise ValueError("compact_live: n, size or the slots out of range")
    if lo.device.type == "cpu":
        return compact_live_plain(lo, hi, n, size)
    if lo.device.type != "cuda":
        raise ValueError(f"compact_live: unsupported device {lo.device}")
    out = _compact_sorted(sort_keys(lo, hi, n), n, size)
    LAUNCHES["compact_live"] += 1
    return out


def sort_keys(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """The sort of :func:`compact_live` on CUDA: the pairs packed as
    ``lo << b | hi`` (b = :func:`key_bits`), ascending, int64 (the keys
    are below 2^62, so signed and unsigned order agree)."""
    lib = _lib()
    m, b = len(lo), key_bits(n)
    dev = lo.device
    temp_bytes = ctypes.c_ulonglong(0)
    _check(lib, lib.sheep_compact_sort_bytes(m, 2 * b,
                                             ctypes.byref(temp_bytes)),
           "compact_live's sort sizing")
    temp = torch.empty(max(1, temp_bytes.value), dtype=torch.uint8,
                       device=dev)
    packed = torch.empty(m, dtype=torch.int64, device=dev)
    key = torch.empty(m, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.sheep_compact_sort(
            lo.data_ptr(), hi.data_ptr(), m, b, packed.data_ptr(),
            key.data_ptr(), temp.data_ptr(), temp_bytes.value, stream),
            "compact_live's sort")
    return key


def compact_sorted(key: torch.Tensor, n: int, size: int):
    """The compaction of :func:`compact_live` on CUDA after its sort:
    ``key`` the ascending packed keys of :func:`sort_keys` (int64,
    contiguous). Counted in ``LAUNCHES`` as one compaction."""
    out = _compact_sorted(key, n, size)
    LAUNCHES["compact_live"] += 1
    return out


def _compact_sorted(key: torch.Tensor, n: int, size: int):
    if key.dtype != torch.int64 or key.dim() != 1 or \
            not key.is_contiguous() or key.device.type != "cuda":
        raise ValueError("compact_sorted: key must be a contiguous int64 "
                         "CUDA vector")
    lib = _lib()
    tile = lib.sheep_compact_tile()
    dev = key.device
    scratch = torch.empty(-(-len(key) // tile) + 1, dtype=torch.int32,
                          device=dev)
    out_lo = torch.empty(size, dtype=torch.int32, device=dev)
    out_hi = torch.empty(size, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.sheep_compact_live(
            key.data_ptr(), len(key), n, key_bits(n), scratch.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), size, stream),
            "compact_live launch")
    return out_lo, out_hi
