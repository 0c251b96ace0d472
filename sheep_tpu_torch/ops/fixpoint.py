"""The batched fixpoint execution's own kernels and its device-side state
(counterparts of the scatter-min of ``_pos_round_body`` and of the loop
of ``batch_segment_fixpoint``, ``sheep_tpu/ops/elim.py:149`` and
``:425-495``).

The JAX package runs an execution, the rounds over the rows of an [N, C]
block, as one ``lax.while_loop`` whose stop condition lives on the device.
The port enqueues the execution's whole budget of rounds and reads
nothing back. Its state is a small int64 tensor (:func:`new_state`):

    [ROW]        the row being folded      [ROUNDS]     rounds counted
    [RETIRED]    slots retired             [DEPTH_SUM], [DEPTH_MAX],
    [LIVE_SUM], [LIVE_MAX]  the rounds' depth and live slots
    [STOP]       set once ROW reaches N or ROUNDS the budget
    [LOG + 2r], [LOG + 2r + 1]   depth and live slots of round r

int64, because a sum of live slots over a budget of rounds of C slots can
pass 2^31. Every kernel of a round is given the state and returns at once
when STOP is set, so the rounds enqueued after the last row converged
change nothing and are not counted; a kernel that reads the round's slots
reads row ROW of the blocks. The round's end (count the round from the
control word ``ctl`` of ``ops/lift.py``, move to the next row when the
round changed nothing, set STOP; :func:`round_end_plain` on the CPU) is
the state's only writer; on CUDA it runs in the last block of the
round's last kernel, ``climb_tail`` (``lift.climb_rows``), and has no
launch of its own.

Kernels (``csrc/fixpoint.cu``), each with its plain PyTorch version:

  scatter_min   P[lo] <- min(P[lo], hi) at the live slots (lo != n)
  exec_finish   store the rows that converged all-sentinel and pack
                sv = int32[4] (segments_done, rounds, live, retired)

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain versions, reading the state on the host, so the CPU runs the
same enqueued rounds, no-op rounds included. Anything else raises.
``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"scatter_min": 0, "exec_finish": 0}

(ROW, ROUNDS, RETIRED, DEPTH_SUM, DEPTH_MAX, LIVE_SUM, LIVE_MAX,
 STOP) = range(8)
LOG = 8


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def new_state(batch_rounds: int, device) -> torch.Tensor:
    """A fresh execution state with room to log ``batch_rounds`` rounds."""
    return torch.zeros(LOG + 2 * max(int(batch_rounds), 1),
                       dtype=torch.int64, device=device)


def check_state(fn: str, state: torch.Tensor, device) -> None:
    if state.dtype != torch.int64 or state.dim() != 1 or \
            not state.is_contiguous() or len(state) < LOG + 2:
        raise ValueError(f"{fn}: state must be a contiguous int64 vector of "
                         f">= {LOG + 2} entries (fixpoint.new_state)")
    if state.device != device:
        raise ValueError(f"{fn}: state on {state.device}, data on {device}")


def stopped(state: torch.Tensor) -> bool:
    """Whether the execution has stopped; a host read, so CPU only."""
    return bool(state[STOP])


def row(state: torch.Tensor) -> int:
    return int(state[ROW])


def round_log(state, rounds: int):
    """(depth, live) of the execution's first ``rounds`` rounds, from a
    host copy of its state."""
    log = state[LOG:LOG + 2 * rounds]
    return [(int(log[2 * r]), int(log[2 * r + 1])) for r in range(rounds)]


def _check_vec(fn: str, name: str, t: torch.Tensor, dims=(1,)) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} must be int32, got {t.dtype}")
    if t.dim() not in dims:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_device(fn: str, ref: torch.Tensor, *ts) -> None:
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"{fn}: tensors on {ref.device} and {t.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {ref.device}")


def _slots(fn: str, lo, hi, state):
    """Check a round's slot arguments: 1-D of one length, or [N, C]
    blocks of one shape, whose row the execution ``state`` picks."""
    dims = (1, 2) if state is not None else (1,)
    _check_vec(fn, "lo", lo, dims)
    _check_vec(fn, "hi", hi, dims)
    if lo.shape != hi.shape:
        raise ValueError(f"{fn}: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.dim() == 2 and lo.numel() >= 2**31:
        raise ValueError(f"{fn}: blocks must hold < 2^31 slots")


def pick_row(state, *blocks):
    """CPU: the execution's row of each [N, C] block (1-D passes)."""
    i = row(state)
    return [b[i] if b.dim() == 2 else b for b in blocks]


def _stride(t: torch.Tensor) -> int:
    return t.shape[1] if t.dim() == 2 else 0


def _ptr(t):
    return None if t is None else t.data_ptr()


# -- plain versions --------------------------------------------------------

def scatter_min_plain(P: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> None:
    """The plain version of :func:`scatter_min` on 1-D slots:
    ``scatter_reduce_(..., "amin")`` over the live slots (lo in [0, n))."""
    n = len(P) - 1
    live = (lo >= 0) & (lo < n)
    P.scatter_reduce_(0, lo[live].long(), hi[live], reduce="amin",
                      include_self=True)


def exec_finish_plain(loB: torch.Tensor, hiB: torch.Tensor,
                      state: torch.Tensor, n: int) -> torch.Tensor:
    """The plain version of :func:`exec_finish`, on a CPU state."""
    done = row(state)
    loB[:done] = n
    hiB[:done] = n
    live = int((loB != n).sum())
    return torch.tensor([done, int(state[ROUNDS]), live,
                         int(state[RETIRED])], dtype=torch.int32)


# -- kernels ---------------------------------------------------------------

_LIB = None


def _lib():
    """The fixpoint library with its C signatures declared, built on first
    use."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("fixpoint")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, args in (
                ("sheep_scatter_min", [p, ll, p, p, ll, p, ll, p]),
                ("sheep_exec_finish", [p, p, ll, ll, i, p, p, p])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.sheep_fixpoint_error_string.argtypes = [ctypes.c_int]
        lib.sheep_fixpoint_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, dev, *args) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"sheep_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.sheep_fixpoint_error_string(rc).decode())
    LAUNCHES[name] += 1


def scatter_min(P: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                state: torch.Tensor = None) -> None:
    """``P[lo] <- min(P[lo], hi)`` in place at the live slots (lo in
    [0, n), n = len(P) - 1; a dead slot (n, n) changes nothing). With an
    execution ``state``: nothing once it has stopped, and [N, C] blocks
    ``lo``/``hi`` are read at the execution's row."""
    _check_vec("scatter_min", "P", P)
    _slots("scatter_min", lo, hi, state)
    _check_device("scatter_min", P, lo, hi)
    if not 0 < len(P) < 2**31:
        raise ValueError("scatter_min: P must hold 1 .. 2^31-1 entries")
    if state is not None:
        check_state("scatter_min", state, P.device)
    if P.device.type == "cpu":
        if state is not None:
            if stopped(state):
                return
            lo, hi = pick_row(state, lo, hi)
        scatter_min_plain(P, lo, hi)
        return
    _launch("scatter_min", P.device, P.data_ptr(), len(P), lo.data_ptr(),
            hi.data_ptr(), lo.shape[-1], _ptr(state), _stride(lo))


def check_round_end(fn: str, state: torch.Tensor, N: int,
                    batch_rounds: int) -> None:
    """Check the arguments of a round's end: ``N`` rows, a budget of
    ``batch_rounds`` rounds, and a ``state`` that can log that many."""
    if N < 1 or batch_rounds < 1:
        raise ValueError(f"{fn}: N and batch_rounds must be >= 1")
    if len(state) < LOG + 2 * batch_rounds:
        raise ValueError(f"{fn}: state logs {(len(state) - LOG) // 2} "
                         f"rounds, budget {batch_rounds}")


def round_end_plain(ctl: torch.Tensor, state: torch.Tensor, N: int,
                    batch_rounds: int) -> None:
    """Count one round of an execution over ``N`` rows with a budget of
    ``batch_rounds`` rounds, from the round's control word ``ctl``
    ([rows, changed, retired, live, tickets], ``ops/lift.py``): log
    (depth, live), add the retired count, move to the next row when
    nothing changed, set STOP as the reference's loop condition would.
    Nothing once stopped. The plain version, which reads the state on the
    host: on CUDA the round ends in the last block of ``climb_tail``
    (``lift.climb_rows``), which has no launch of its own."""
    fn = "round_end_plain"
    _check_vec(fn, "ctl", ctl)
    if len(ctl) < 4:
        raise ValueError(f"{fn}: ctl must hold >= 4 entries")
    check_state(fn, state, ctl.device)
    check_round_end(fn, state, N, batch_rounds)
    _check_device(fn, ctl, state)
    if stopped(state):
        return
    rows, changed, retired, live = (int(x) for x in ctl.tolist()[:4])
    depth = rows + 1
    r = int(state[ROUNDS])
    state[LOG + 2 * r] = depth
    state[LOG + 2 * r + 1] = live
    state[ROUNDS] = r + 1
    state[RETIRED] += retired
    state[DEPTH_SUM] += depth
    state[DEPTH_MAX] = max(int(state[DEPTH_MAX]), depth)
    state[LIVE_SUM] += live
    state[LIVE_MAX] = max(int(state[LIVE_MAX]), live)
    i = row(state) + (0 if changed else 1)
    state[ROW] = i
    state[STOP] = int(i >= N or r + 1 >= batch_rounds)


def exec_finish(loB: torch.Tensor, hiB: torch.Tensor, state: torch.Tensor,
                n: int) -> torch.Tensor:
    """End an execution: the rows below the state's row converged and are
    stored all-sentinel (n), in place; returns ``sv`` int32[4] =
    (segments_done, rounds, live slots of the blocks, retired), on the
    blocks' device."""
    fn = "exec_finish"
    _check_vec(fn, "loB", loB, (2,))
    _check_vec(fn, "hiB", hiB, (2,))
    if loB.shape != hiB.shape or loB.numel() == 0 or loB.numel() >= 2**31:
        raise ValueError(f"{fn}: blocks {tuple(loB.shape)} and "
                         f"{tuple(hiB.shape)}: one non-empty shape of "
                         f"< 2^31 slots")
    check_state(fn, state, loB.device)
    _check_device(fn, loB, hiB)
    if loB.device.type == "cpu":
        return exec_finish_plain(loB, hiB, state, n)
    sv = torch.empty(4, dtype=torch.int32, device=loB.device)
    N, C = loB.shape
    _launch(fn, loB.device, loB.data_ptr(), hiB.data_ptr(), N, C, n,
            state.data_ptr(), sv.data_ptr())
    return sv

