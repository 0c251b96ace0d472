"""Live-pair compaction of the adaptive fixpoint driver (counterpart of
``compact_actives(..., dedup=True)`` and ``count_live_distinct``,
``sheep_tpu/ops/elim.py:1055`` and ``:1089``).

``compact_live(lo, hi, n, size)`` packs the live (lo, hi) constraints of
a round's slots into ``size`` slots: duplicate pairs are dropped, the
rest come in ascending (lo, hi) order, and the slots after them hold the
inert (n, n). With ``dedup=False`` (the sharded driver's compaction,
``compact_actives(..., dedup=False)``) the duplicates stay, so that the
live counts after it, which steer the driver, are the reference's. The
fixpoint depends only on the set of live constraints, so a compacted
buffer folds to the same forest. On CUDA tensors it runs
the kernels of ``csrc/compact.cu``: the live pairs packed as keys ``lo <<
b | hi`` (b the bits of n, where the JAX package's ``lax.sort`` orders
two keys), a stable radix sort of those keys alone, and the first pair
of each run, all in one cooperative kernel launch, with the live count
kept on the card. On CPU tensors it runs
:func:`compact_live_plain`; anything else raises. ``LAUNCHES`` counts
the wrapper's calls that launch the kernels (one a compaction).
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
                       size: int, dedup: bool = True):
    """The plain version of :func:`compact_live`."""
    key = torch.sort(_packed(lo, hi)).values
    slo, shi = (key >> 32).int(), (key & 0xFFFFFFFF).int()
    first = torch.ones_like(key, dtype=torch.bool)
    if dedup:
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
_CTL = {}


def _lib():
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("compact")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sheep_compact_live.argtypes = [p, p, ll, i, i, p, p, p, p, p, ll,
                                           i, p]
        lib.sheep_compact_live.restype = i
        lib.sheep_compact_passes.argtypes = [i]
        lib.sheep_compact_passes.restype = i
        lib.sheep_compact_ctl_words.restype = i
        lib.sheep_compact_look_stride.argtypes = [ll]
        lib.sheep_compact_look_stride.restype = ll
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


def _ctl(dev: torch.device, stream: int) -> torch.Tensor:
    """The control words of the calls on one stream: zero when made, and
    every call leaves them zero (calls on one stream run in turn)."""
    key = (dev.index, stream)
    if key not in _CTL:
        _CTL[key] = torch.zeros(_lib().sheep_compact_ctl_words(),
                                dtype=torch.int32, device=dev)
    return _CTL[key]


def compact_live(lo: torch.Tensor, hi: torch.Tensor, n: int, size: int,
                 dedup: bool = True):
    """``(out_lo, out_hi)`` int32[size]: the distinct live pairs of the
    1-D slots (lo, hi) (all of them without ``dedup``) in ascending order,
    then (n, n); pairs past ``size`` are dropped (the caller sizes it
    above the live count).
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
        return compact_live_plain(lo, hi, n, size, dedup)
    if lo.device.type != "cuda":
        raise ValueError(f"compact_live: unsupported device {lo.device}")
    lib = _lib()
    m, b, dev = len(lo), key_bits(n), lo.device
    passes = lib.sheep_compact_passes(b)
    stride = lib.sheep_compact_look_stride(m)
    keys = torch.empty(2 * max(m, 1), dtype=torch.int64, device=dev)
    look = torch.empty((passes + 1) * stride, dtype=torch.int64, device=dev)
    out_lo = torch.empty(size, dtype=torch.int32, device=dev)
    out_hi = torch.empty(size, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.sheep_compact_live(
            lo.data_ptr(), hi.data_ptr(), m, n, b, keys.data_ptr(),
            look.data_ptr(), _ctl(dev, stream).data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), size, int(bool(dedup)),
            stream),
            "compact_live launch")
    LAUNCHES["compact_live"] += 1
    return out_lo, out_hi
