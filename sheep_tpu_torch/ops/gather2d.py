"""2-D int32 gathers (counterparts of the Mosaic probes' Pallas kernels in
``tools/pallas_smoke.py``: ``try_form`` forms A, B, C and E, ``_perf2`` and
``_probe_width``).

``take_rows(t, idx)`` is ``t[clip(idx, 0, R-1), :]`` for an (R, W) table
and a 1-D ``idx``: kernel K2 (``csrc/gather2d.cu``).

``take_along(x, idx, axis, shift=0)`` is
``x[clip(idx >> shift, 0, R-1), c]`` on axis 0 (``idx`` has ``x``'s
columns) and ``x[r, clip(idx >> shift, 0, W-1)]`` on axis 1 (``idx`` has
``x``'s rows): kernel K3. ``shift`` is 7 for the probes' form E, whose
indices address the flattened (R, 128) table, and 0 otherwise.

Out-of-range indices are clipped to the gathered axis after the shift, as
``jnp.take(mode="clip")`` does; the probes' own indices are all in range.
On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain PyTorch versions :func:`take_rows_plain` and
:func:`take_along_plain`. Anything else raises. ``LAUNCHES`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"take_rows": 0, "take_along": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def take_rows_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2."""
    return t[idx.clamp(0, t.shape[0] - 1).long()]


def take_along_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                     shift: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K3."""
    j = (idx >> shift).clamp(0, x.shape[axis] - 1).long()
    return torch.gather(x, axis, j)


def _check(fn: str, tensors, dims) -> None:
    for (name, t), dim in zip(tensors, dims):
        if t.dtype != torch.int32:
            raise TypeError(f"{fn}: {name} must be int32, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{fn}: {name} must be {dim}-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    devices = {t.device for _, t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{fn}: tensors on several devices {devices}")
    dev = tensors[0][1].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")


_LIB = None


def _lib():
    """The K2/K3 library with its C signatures declared, built on first
    use."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("gather2d")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.sheep_take_rows.argtypes = [vp, ll, ll, vp, vp, ll, vp]
        lib.sheep_take_rows.restype = ctypes.c_int
        lib.sheep_take_along.argtypes = [
            vp, ll, ll, vp, vp, ll, ll, ctypes.c_int, ctypes.c_int, vp]
        lib.sheep_take_along.restype = ctypes.c_int
        lib.sheep_gather2d_error_string.argtypes = [ctypes.c_int]
        lib.sheep_gather2d_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.sheep_gather2d_error_string(rc).decode())


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[clip(idx), :]`` for an int32 (R, W) table and int32 1-D idx,
    both contiguous on one device; returns (len(idx), W)."""
    _check("take_rows", (("t", t), ("idx", idx)), (2, 1))
    rows, w = t.shape
    if rows == 0 and len(idx):
        raise ValueError("take_rows: empty table")
    if rows >= 2**31:
        raise ValueError("take_rows: table must hold < 2^31 rows")
    if t.device.type == "cpu":
        return take_rows_plain(t, idx)
    out = torch.empty((len(idx), w), dtype=torch.int32, device=t.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.sheep_take_rows(t.data_ptr(), rows, w, idx.data_ptr(),
                                 out.data_ptr(), len(idx), stream)
    _raise_on(lib, rc, "take_rows")
    LAUNCHES["take_rows"] += 1
    return out


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int,
               shift: int = 0) -> torch.Tensor:
    """``take_along_axis(x, clip(idx >> shift), axis)`` for int32 2-D
    contiguous ``x`` and ``idx`` on one device, ``axis`` 0 or 1 and
    ``0 <= shift < 32``; the other axis of ``idx`` must equal ``x``'s.
    Returns a tensor of ``idx``'s shape."""
    _check("take_along", (("x", x), ("idx", idx)), (2, 2))
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis must be 0 or 1, got {axis}")
    if not 0 <= shift < 32:
        raise ValueError(f"take_along: shift must be in [0, 32), "
                         f"got {shift}")
    other = 1 - axis
    if idx.shape[other] != x.shape[other]:
        raise ValueError(f"take_along: idx shape {tuple(idx.shape)} does "
                         f"not match x shape {tuple(x.shape)} off axis "
                         f"{axis}")
    if x.shape[axis] == 0 and idx.numel():
        raise ValueError("take_along: empty gathered axis")
    if x.shape[axis] >= 2**31:
        raise ValueError("take_along: gathered axis must be < 2^31")
    if x.device.type == "cpu":
        return take_along_plain(x, idx, axis, shift)
    out = torch.empty_like(idx)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sheep_take_along(x.data_ptr(), x.shape[0], x.shape[1],
                                  idx.data_ptr(), out.data_ptr(),
                                  idx.shape[0], idx.shape[1], axis, shift,
                                  stream)
    _raise_on(lib, rc, "take_along")
    LAUNCHES["take_along"] += 1
    return out

