"""Clip-mode int32 gather (counterpart of ``sheep_tpu/ops/pallas_gather.py``).

``gather_clip(table, idx)`` computes ``table[clip(idx, 0, len(table)-1)]``.
On CUDA tensors it launches kernel K1 (``csrc/gather.cu``); on CPU tensors
it runs the plain PyTorch version :func:`gather_clip_plain`. Anything else
raises. The exact-descent round reads P through it before the scatter;
the stream descent sends every one of its table gathers through it.

In a fixpoint round K1 is given the execution's state
(``ops/fixpoint.py``): it then does nothing once the execution has
stopped, and a 2-D ``idx`` is the [N, C] block whose row the execution
picks.

``LAUNCHES["gather_clip"]`` counts K1 launches, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sheep_tpu_torch.ops import fixpoint

LAUNCHES = {"gather_clip": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def gather_clip_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1."""
    return table[idx.clamp(0, len(table) - 1).long()]


def _check(table: torch.Tensor, idx: torch.Tensor, state) -> None:
    for name, t in (("table", table), ("idx", idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"gather_clip: {name} must be int32, "
                            f"got {t.dtype}")
        if t.dim() != 1 and not (t is idx and t.dim() == 2 and
                                 state is not None):
            raise ValueError(f"gather_clip: {name} must be 1-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gather_clip: {name} must be contiguous")
    if table.device != idx.device:
        raise ValueError(f"gather_clip: table on {table.device}, idx on "
                         f"{idx.device}")
    if len(table) >= 2**31:
        raise ValueError("gather_clip: table must hold < 2^31 entries")
    if len(table) == 0 and idx.numel():
        raise ValueError("gather_clip: empty table")
    if state is not None:
        fixpoint.check_state("gather_clip", state, table.device)


_LIB = None


def _lib():
    """The K1 library with its C signatures declared, built on first use."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("gather")
        lib.sheep_gather_clip.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.sheep_gather_clip.restype = ctypes.c_int
        lib.sheep_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sheep_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def gather_clip(table: torch.Tensor, idx: torch.Tensor,
                state: torch.Tensor = None) -> torch.Tensor:
    """``table[clip(idx)]`` for int32 1-D contiguous tensors of any length.
    With an execution ``state``: a 2-D ``idx`` is read at the execution's
    row, and once the execution has stopped nothing is gathered (the
    output then holds no values)."""
    _check(table, idx, state)
    m = idx.shape[-1]
    if table.device.type == "cpu":
        if state is not None:
            if fixpoint.stopped(state):
                return torch.empty(m, dtype=torch.int32)
            if idx.dim() == 2:
                idx = idx[fixpoint.row(state)]
        return gather_clip_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_clip: unsupported device {table.device}")
    out = torch.empty(m, dtype=torch.int32, device=table.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.sheep_gather_clip(
            table.data_ptr(), len(table), idx.data_ptr(), out.data_ptr(), m,
            None if state is None else state.data_ptr(),
            m if idx.dim() == 2 else 0, stream)
    if rc != 0:
        raise RuntimeError("gather_clip launch failed: "
                           + lib.sheep_cuda_error_string(rc).decode())
    LAUNCHES["gather_clip"] += 1
    return out


def vmem_gather(table: torch.Tensor, idx: torch.Tensor,
                block: int = 8192) -> torch.Tensor:
    """The reference's contract: ``len(idx)`` must be a multiple of
    ``block`` (``ValueError`` otherwise); the gather itself is
    :func:`gather_clip`."""
    if len(idx) % block:
        raise ValueError(f"len(idx)={len(idx)} not a multiple of "
                         f"block={block}")
    return gather_clip(table, idx)
