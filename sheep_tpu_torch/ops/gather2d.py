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
Any contiguous int32 view is taken, one that starts off a 16-byte boundary
too; ``out=`` gives the result's tensor (contiguous, of the result's
shape, overlapping no input). On CUDA tensors the wrappers launch the
kernels; on CPU tensors they run the plain PyTorch versions
:func:`take_rows_plain` and :func:`take_along_plain`. Anything else
raises. ``LAUNCHES`` counts the kernel launches.

The launch plan of each kernel is a pure function of the shapes, the
pointers' alignment and the card's SMs (:func:`plan_take_rows`,
:func:`plan_take_along`); the tests replay a plan's mapping of threads to
elements on the host.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

LAUNCHES = {"take_rows": 0, "take_along": 0}

# the launch plans' constants, as csrc/gather2d.cu has them
THREADS = 256          # kThreads: the most threads a block
UNITS = 4              # kUnits: K3's elements a thread
BATCH = 8              # kBatch: K2's units a lane loads before it stores
LANE_UNITS = 16        # K2: units a lane, two batches
H100_SMS = 132         # an H100 SXM's streaming multiprocessors
WARPS_PER_SM = 8       # K2: the fewest warps a plan leaves an SM
GRID_Y = 65535         # the largest gridDim.y


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


# -- launch plans ------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class RowsPlan:
    """K2's launch: ``vec`` 16-byte units (else 4-byte); ``log_rows``:
    log2 of the rows a warp; ``threads`` a block, ``blocks`` the grid."""
    vec: bool
    log_rows: int
    threads: int
    blocks: int

    @classmethod
    def covering(cls, vec: bool, log_rows: int, b: int) -> "RowsPlan":
        """The grid of ``THREADS``-thread blocks whose warps, 2^log_rows
        rows each, cover ``b`` rows."""
        warps = _cdiv(b, 1 << log_rows)
        return cls(vec, log_rows, THREADS, _cdiv(warps, THREADS // 32))


def plan_take_rows(w: int, b: int, t_addr: int, out_addr: int,
                   sms: int = H100_SMS) -> RowsPlan:
    """K2's plan for ``b`` rows of width ``w`` from a table at ``t_addr``
    into ``out_addr``. 16-byte units need W % 4 == 0 and both addresses
    16-byte aligned, else 4-byte units. A warp takes the most rows (at
    most 32) that give a lane at most ``LANE_UNITS`` units and leave every
    SM ``WARPS_PER_SM`` warps."""
    vec = w % 4 == 0 and t_addr % 16 == 0 and out_addr % 16 == 0
    nq = w // 4 if vec else w
    log_rows = 0
    while (log_rows < 5 and (nq << (log_rows + 1)) <= 32 * LANE_UNITS
           and _cdiv(b, 1 << (log_rows + 1)) >= sms * WARPS_PER_SM):
        log_rows += 1
    return RowsPlan.covering(vec, log_rows, b)


@dataclass(frozen=True)
class AlongPlan:
    """K3's launch: ``log_tpr``: log2 of the threads a row tile;
    ``threads`` a block; ``grid``: (column tiles of a row, tiles of
    rows)."""
    log_tpr: int
    threads: int
    grid: tuple

    @classmethod
    def covering(cls, ir: int, ic: int, threads: int) -> "AlongPlan":
        """The grid of ``threads``-thread blocks that covers an (ir, ic)
        idx, ``UNITS`` elements a thread: a row tile is the power of two of
        threads (at most a block) that holds the row; past ``GRID_Y`` tiles
        of rows the grid strides in y."""
        log_tpr = min(max(_cdiv(ic, UNITS) - 1, 0).bit_length(),
                      threads.bit_length() - 1)
        tiles = _cdiv(ir, threads >> log_tpr)
        return cls(log_tpr, threads,
                   (_cdiv(ic, UNITS << log_tpr), min(tiles, GRID_Y)))

    def tiles(self, ir: int) -> int:
        """The blocks of the grid before its y stride, for ``ir`` rows."""
        return self.grid[0] * _cdiv(ir, self.threads >> self.log_tpr)


def plan_take_along(ir: int, ic: int, sms: int = H100_SMS) -> AlongPlan:
    """K3's plan for an (ir, ic) idx: the largest block (at most 256
    threads) that gives at least a quarter of the SMs a block. The same
    for any alignment of idx and out."""
    threads = THREADS
    while (threads > 32 and AlongPlan.covering(ir, ic, threads).tiles(ir)
           < _cdiv(sms, 4)):
        threads //= 2
    return AlongPlan.covering(ir, ic, threads)


# -- the wrappers ------------------------------------------------------------

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


def _out(fn: str, out, shape, like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=like.device)
    _check(fn, (("out", out), ("input", like)), (len(shape), like.dim()))
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{fn}: out must have shape {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    return out


_LIB = None
_SMS: dict = {}


def _lib():
    """The K2/K3 library with its C signatures declared, built on first
    use."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        _LIB = declare(_build.load("gather2d"))
    return _LIB


def declare(lib):
    """``lib`` (a build of ``csrc/gather2d.cu``) with its C signatures
    declared."""
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sheep_take_rows.argtypes = [vp, ll, ll, vp, vp, ll, i, i, i, ll, vp]
    lib.sheep_take_rows.restype = i
    lib.sheep_take_along.argtypes = [vp, ll, ll, vp, vp, ll, ll, i, i, i, i,
                                     ll, ll, vp]
    lib.sheep_take_along.restype = i
    lib.sheep_gather2d_empty.argtypes = [ll, ll, i, vp]
    lib.sheep_gather2d_empty.restype = i
    lib.sheep_gather2d_error_string.argtypes = [i]
    lib.sheep_gather2d_error_string.restype = ctypes.c_char_p
    return lib


def sms(device) -> int:
    """The card's streaming multiprocessors (queried once a device)."""
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _SMS[key]


def _raise_on(lib, rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.sheep_gather2d_error_string(rc).decode())


def launch_take_rows(t, idx, out, plan: RowsPlan, lib=None) -> None:
    """Launch K2 on CUDA tensors with ``plan`` (checked by the kernel's
    launcher against the inputs); ``lib``: another build declared by
    :func:`declare` (a comparison's), else the package's, whose launches
    are counted."""
    own = lib is None
    lib = _lib() if own else lib
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.sheep_take_rows(t.data_ptr(), t.shape[0], t.shape[1],
                                 idx.data_ptr(), out.data_ptr(), len(idx),
                                 int(plan.vec), plan.log_rows, plan.threads,
                                 plan.blocks, stream)
    _raise_on(lib, rc, "take_rows")
    if own:
        LAUNCHES["take_rows"] += 1


def launch_take_along(x, idx, out, axis: int, shift: int,
                      plan: AlongPlan, lib=None) -> None:
    """Launch K3 on CUDA tensors with ``plan``; ``lib`` as for
    :func:`launch_take_rows`."""
    own = lib is None
    lib = _lib() if own else lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sheep_take_along(
            x.data_ptr(), x.shape[0], x.shape[1], idx.data_ptr(),
            out.data_ptr(), idx.shape[0], idx.shape[1], axis, shift,
            plan.log_tpr, plan.threads, plan.grid[0], plan.grid[1], stream)
    _raise_on(lib, rc, "take_along")
    if own:
        LAUNCHES["take_along"] += 1


def launch_empty(device, grid: tuple, threads: int) -> None:
    """An empty kernel launched as K2 and K3 are (a programmatic dependent
    launch) on ``grid`` of ``threads``-thread blocks: the launch floor of
    their chain bound (a yardstick; no path launches it, and no launch is
    counted)."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sheep_gather2d_empty(grid[0], grid[1] if len(grid) > 1
                                      else 1, threads, stream)
    _raise_on(lib, rc, "empty")


def take_rows(t: torch.Tensor, idx: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """``t[clip(idx), :]`` for an int32 (R, W) table and int32 1-D idx,
    both contiguous on one device; returns (len(idx), W) (``out`` if
    given)."""
    _check("take_rows", (("t", t), ("idx", idx)), (2, 1))
    rows, w = t.shape
    if rows == 0 and len(idx):
        raise ValueError("take_rows: empty table")
    if rows >= 2**31 or w >= 2**31:
        raise ValueError("take_rows: table must hold < 2^31 rows and "
                         "columns")
    out = _out("take_rows", out, (len(idx), w), t)
    if t.device.type == "cpu":
        return out.copy_(take_rows_plain(t, idx))
    if out.numel() == 0:
        return out
    plan = plan_take_rows(w, len(idx), t.data_ptr(), out.data_ptr(),
                          sms(t.device))
    launch_take_rows(t, idx, out, plan)
    return out


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int,
               shift: int = 0,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``take_along_axis(x, clip(idx >> shift), axis)`` for int32 2-D
    contiguous ``x`` and ``idx`` on one device, ``axis`` 0 or 1 and
    ``0 <= shift < 32``; the other axis of ``idx`` must equal ``x``'s.
    Returns a tensor of ``idx``'s shape (``out`` if given)."""
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
    if x.shape[axis] >= 2**31 or idx.shape[1] >= 2**31:
        raise ValueError("take_along: gathered axis and idx rows must be "
                         "< 2^31")
    out = _out("take_along", out, tuple(idx.shape), x)
    if x.device.type == "cpu":
        return out.copy_(take_along_plain(x, idx, axis, shift))
    if out.numel() == 0:
        return out
    plan = plan_take_along(idx.shape[0], idx.shape[1], sms(x.device))
    launch_take_along(x, idx, out, axis, shift, plan)
    return out
