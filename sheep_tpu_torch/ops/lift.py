"""The round's lifting work: the lifting stack and the fused climb
(counterparts of ``build_lift_tables`` and of ``_pos_round_body`` after
its scatter-min, ``sheep_tpu/ops/elim.py:295`` and ``:158-192``), the
stream descent (that round's stream branch, ``:166-171``), and the
jump-mode climb of the adaptive driver's small buffers (of
``_pos_small_round_body`` after its scatter-min, ``:359``).

``lift_stack(P, stack, ctl)`` fills the stack with the levels
t_1 .. t_{d-1} of the table P (t_0 = P, t_{j+1} = t_j[t_j]), zeroes the
control word and writes d - 1, the stack rows in use, to ``ctl[ROWS]``:
on CUDA in one persistent launch a ladder, its levels apart by grid-wide
barriers (``csrc/lift.cu``).
``climb_tail(lo, hi, old_at_lo, P, stack, ctl)`` runs the rest of the
round over the slots in one pass: retire, displace, the binary-lifting
climb over levels d-1 .. 0, and the pass's ``changed`` flag, retired
count and live count added to ``ctl``. Given ``jumps`` > 0, ``climb_tail`` launches
its jump-mode kernel, ``climb_jumps``, instead: the climb is up to
``jumps`` single steps over P and the stack is not read.
``stream_descent(P, lo, hi, levels, scratch, ctl)`` is the
stream descent's climb, which keeps no stack: levels 0 .. L-1 in
ascending order over t_0 = P, t_1, ... (``cur <- t_j[cur]`` where below
hi, from lo), each squared from the one before into the other of two
rows, up to the first all-n level or the first after which no slot
moves, the climbed positions into ``scratch.pre`` at the live slots,
which it returns, and ``ctl`` set to [L - 1, 0, 0, 0, 0]; ``climb_tail``
then takes ``pre`` in place of a stack. On CUDA tensors they launch the
kernels of ``csrc/lift.cu``; on CPU tensors they run the plain PyTorch
versions :func:`lift_stack_plain`, :func:`stream_descent_plain` and
:func:`climb_tail_plain`. Anything else raises.

**The depth cut is exact.** d counts the distinct levels: the first
level j with t_{j+1} == t_j is idempotent (t_j[t_j] = t_j), every higher
level equals it, and d = j + 1. The squaring stops as soon as that is
known: at the first level whose entries are all n, which in position
space (P[p] in (p, n], P[n] = n) is exactly the first idempotent one
(``csrc/lift.cu`` has the proof), so its copy t_{j+1} is never computed;
or, outside position space, at the first level that changed nothing. The
climb applies levels d-1 .. 0 instead of L-1 .. 0. The levels it skips all
equal t_{d-1}, and applying an idempotent table again moves no slot: if
the first application moved ``cur`` to ``cand = t[cur]``, the next reads
``t[cand] = t[t[cur]] = t[cur] = cand``; if it did not (``cand >= hi``),
the next reads the same ``cand``. So the climb over d levels is, bit for
bit, the climb over L.

Inputs are the round's state: P int32[T], T = n + 1, with entries in
[0, n] and P[n] = n; lo, hi, old_at_lo int32[C] with entries in [0, n],
lo < hi on a live slot and lo == n only on a dead slot (n, n). The
kernels clip every table index to [0, n], as K1 does. On such inputs the
kernel and the plain version agree bit for bit. A dead slot's hi is not
read: it is n by this contract. The stream descent also needs P in
position space, P[p] in (p, n], as every round's table is: there a
slot's step that does not move is its last (``csrc/lift.cu``), and the
kernel stops climbing it.

The stack is allocated once per fixpoint call (:func:`new_stack`): level
k >= 1 is row k - 1 of an int32 [L-1, stride] tensor, stride the table
length rounded up to a multiple of 32 (16-byte aligned rows). Rows at
or above d - 1 are not read. The control word ``ctl`` is int32
[ROWS, CHANGED, RETIRED, LIVE, TICKETS] (:func:`new_ctl`), ROWS = d - 1
so that zeroing the word starts a round; TICKETS counts the blocks of
the CUDA ``climb_tail`` that have finished the round.

In a batched fixpoint execution (``ops/fixpoint.py``) each is given the
execution's state and does nothing once it has stopped (``lift_stack``
still zeroes ``ctl``); ``stream_descent`` reads the execution's row of
the [N, C] blocks, and :func:`climb_rows` is ``climb_tail`` on that row,
written back in place, taking the stream descent's ``pre`` instead of
the stack.
``climb_rows`` is the round's last step, so it also ends the round: on
CUDA in the last block of its kernel, on the CPU by
``fixpoint.round_end_plain`` after the plain climb.

``LAUNCHES`` counts the wrapper calls that launched their kernels: one
``lift_stack`` call is one cooperative launch of the whole ladder, which
also zeroes ``ctl``, and one ``stream_descent`` call one of the whole
descent. Their grid barrier uses a small scratch buffer that the wrapper
allocates once for each device and stream (:func:`_bar`), so two
launches on one stream never share it at once.

The adaptive driver's stale round (``ops/elim.py``, the counterpart of
``_pos_round_body_stale``, ``:222``) calls ``lift_stack`` once a segment
and ``climb_tail`` every round on that stack: ``climb_tail`` applies
level 0 from the current P, so a stack built from an older table gives
the stale round, and no kernel of its own is needed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sheep_tpu_torch.ops import fixpoint
from sheep_tpu_torch.ops.gather import gather_clip_plain

LAUNCHES = {"lift_stack": 0, "stream_descent": 0, "climb_tail": 0,
            "climb_jumps": 0}

ROWS, CHANGED, RETIRED, LIVE, TICKETS = range(5)
CTL_WORDS = 5
ROW_ALIGN = 32  # int32: rows start on 128-byte boundaries


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def row_stride(T: int) -> int:
    return -(-T // ROW_ALIGN) * ROW_ALIGN


def new_stack(T: int, levels: int, device) -> torch.Tensor:
    """The stack for a table of T entries and ``levels`` lifting levels."""
    return torch.empty((max(levels - 1, 0), row_stride(T)), dtype=torch.int32,
                       device=device)


def new_ctl(device) -> torch.Tensor:
    return torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)


class Descent(NamedTuple):
    """The stream descent's buffers (:func:`new_descent`): ``pre``, the
    climbed positions int32[C]; ``rows``, the two squaring rows int32[2,
    stride] (none for one level: nothing is squared); ``mask``, the slots
    still moving, one bit a slot, int32[ceil(C / 32)]."""
    pre: torch.Tensor
    rows: torch.Tensor
    mask: torch.Tensor


def new_descent(T: int, C: int, levels: int, device) -> Descent:
    """The stream descent's buffers for a table of T entries, rows of C
    slots and ``levels`` levels. The rows are P's size twice, as the
    per-level tables they replace were (t_j and t_{j+1} live at a level's
    turn)."""
    return Descent(torch.empty(C, dtype=torch.int32, device=device),
                   torch.empty((2 if levels > 1 else 0, row_stride(T)),
                               dtype=torch.int32, device=device),
                   torch.empty(-(-C // 32), dtype=torch.int32,
                               device=device))


def lift_stack_plain(P: torch.Tensor, levels: int):
    """The plain version of :func:`lift_stack`: ``(stack, d)`` with stack
    int32 [levels-1, T], rows 0 .. d-2 holding t_1 .. t_{d-1} and the rest
    zero, and d the number of distinct levels. It stops at the first level
    with every entry n (the last distinct one) or that changed nothing,
    as the kernel does."""
    stack = torch.zeros((max(levels - 1, 0), len(P)), dtype=torch.int32,
                        device=P.device)
    n = len(P) - 1
    t = P
    for j in range(levels - 1):
        t2 = gather_clip_plain(t, t)
        if torch.equal(t2, t):
            return stack, j + 1
        stack[j] = t2
        if not bool((t2 != n).any()):
            return stack, j + 2
        t = t2
    return stack, levels


def stream_descent_plain(P: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, levels: int) -> torch.Tensor:
    """The plain version of :func:`stream_descent` on 1-D slots: the
    reference's stream loop (``sheep_tpu/ops/elim.py:166-171``), every
    level, no stop. Returns the climbed positions at every slot (a dead
    slot (n, n) keeps n)."""
    t, cur = P, lo
    for j in range(levels):
        cand = gather_clip_plain(t, cur)
        cur = torch.where(cand < hi, cand, cur)
        if j < levels - 1:
            t = gather_clip_plain(t, t)
    return cur


def climb_tail_plain(lo, hi, old_at_lo, P, stack, d: int, pre=None,
                     jumps: int = 0):
    """The plain version of :func:`climb_tail`: the round after its
    scatter-min, as the port ran it before this kernel, with the level loop
    bounded by d. ``stack`` rows 0 .. d-2 hold t_1 .. t_{d-1} (a row may be
    padded past len(P)); ``pre``, when given, is the climb's result
    instead (the stream descent's); ``jumps`` > 0: the climb is that many
    single steps over P (the jump mode; ``stack`` and d are not read).
    Returns ``(out_lo, out_hi, changed, retired, live)``, the last three
    0-d tensors."""
    T = len(P)
    cur = lo
    if pre is not None:
        cur = pre
    elif jumps > 0:
        for _ in range(jumps):
            cand = gather_clip_plain(P, cur)
            cur = torch.where(cand < hi, cand, cur)
    else:
        for k in range(d - 1, -1, -1):
            t = P if k == 0 else stack[k - 1, :T]
            cand = gather_clip_plain(t, cur)
            cur = torch.where(cand < hi, cand, cur)
    return finish_round(lo, hi, cur, gather_clip_plain(P, lo), old_at_lo,
                        T - 1)


def finish_round(lo, hi, cur, now, old_at_lo, n: int):
    """The round's end after the climb reached ``cur``, given ``now`` = P[lo]
    after the scatter: a slot whose ``hi`` is ``now`` retires (reused for
    the displaced constraint (now, old) if it improved an older parent),
    a climbed slot that reached ``hi`` dies, any other moves to (cur, hi).
    Returns ``(out_lo, out_hi, changed, retired, live)``, the last three
    0-d tensors."""
    became_loop = cur == hi
    climb_lo = cur.masked_fill(became_loop, n)
    climb_hi = hi.masked_fill(became_loop, n)

    retire = hi == now
    displaced = retire & (now < old_at_lo) & (old_at_lo < n)
    out_lo = torch.where(retire, now.masked_fill(~displaced, n), climb_lo)
    out_hi = torch.where(retire, old_at_lo.masked_fill(~displaced, n),
                         climb_hi)
    changed = ((out_lo != lo) | (out_hi != hi)).any()
    live = lo != n
    retired = (live & (out_lo == n)).sum(dtype=torch.int32)
    return out_lo, out_hi, changed, retired, live.sum(dtype=torch.int32)


def _check_vec(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(fn: str, P, stack, ctl, *slots, state=None) -> None:
    """Check a lifting call's arguments; ``stack`` None: a jump-mode climb
    that reads none."""
    _check_vec(f"{fn}: P", P)
    _check_vec(f"{fn}: ctl", ctl)
    for i, t in enumerate(slots):
        name = ("lo", "hi", "old_at_lo", "pre")[i]
        if state is not None and i < 2:  # [N, C] blocks
            if t.dim() != 2 or t.dtype != torch.int32 or \
                    not t.is_contiguous() or t.shape != slots[0].shape:
                raise ValueError(f"{fn}: {name} must be a contiguous int32 "
                                 f"[N, C] block, the shape of lo")
            continue
        _check_vec(f"{fn}: {name}", t)
        if len(t) != slots[0].shape[-1]:
            raise ValueError(f"{fn}: lo, hi, old_at_lo and pre differ in "
                             f"row length")
    if state is not None:
        fixpoint.check_state(fn, state, P.device)
    T = len(P)
    if not 0 < T < 2**31:
        raise ValueError(f"{fn}: P must hold 1 .. 2^31-1 entries")
    if len(ctl) != CTL_WORDS:
        raise ValueError(f"{fn}: ctl must hold {CTL_WORDS} entries")
    if stack is None:
        stack = P  # nothing more to check of it
    elif stack.dtype != torch.int32:
        raise TypeError(f"{fn}: stack must be int32, got {stack.dtype}")
    elif stack.dim() != 2 or not stack.is_contiguous():
        raise ValueError(f"{fn}: stack must be a contiguous 2-D tensor")
    elif stack.shape[1] != row_stride(T) or stack.shape[0] + 1 > 32:
        raise ValueError(f"{fn}: stack shape {tuple(stack.shape)} does not "
                         f"fit a table of {T} entries")
    for t in (stack, ctl, *slots):
        if t.device != P.device:
            raise ValueError(f"{fn}: tensors on {P.device} and {t.device}")
    if P.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {P.device}")
    if P.device.type == "cuda" and (P.data_ptr() % 16 or
                                    stack.data_ptr() % 16):
        raise ValueError(f"{fn}: P and stack must be 16-byte aligned")


_LIB = None


def _lib():
    """The lift library with its C signatures declared, built on first
    use."""
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("lift")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sheep_lift_stack.argtypes = [p, ll, p, ll, i, p, p, p, p]
        lib.sheep_lift_stack.restype = ctypes.c_int
        lib.sheep_lift_copy_row.argtypes = [p, p, ll, p]
        lib.sheep_lift_copy_row.restype = ctypes.c_int
        lib.sheep_lift_grid.argtypes = [ll, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
        lib.sheep_lift_grid.restype = ctypes.c_int
        lib.sheep_climb_tail.argtypes = [p, p, p, ll, p, ll, p, ll, p, p, p,
                                         p, ll, p, ll, ll, p]
        lib.sheep_climb_tail.restype = ctypes.c_int
        lib.sheep_climb_jumps.argtypes = [p, p, p, ll, p, ll, i, p, p, p, p,
                                          ll, ll, ll, p]
        lib.sheep_climb_jumps.restype = ctypes.c_int
        lib.sheep_stream_descent.argtypes = [p, ll, p, ll, p, p, ll, ll, p,
                                             p, i, p, p, p, p]
        lib.sheep_stream_descent.restype = ctypes.c_int
        lib.sheep_lift_chase.argtypes = [p, ll, i, i, p, i, p]
        lib.sheep_lift_chase.restype = ctypes.c_int
        lib.sheep_lift_error_string.argtypes = [ctypes.c_int]
        lib.sheep_lift_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_if(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + _lib().sheep_lift_error_string(rc).decode())


_BARS: dict = {}


def _bar(device, stream: int) -> torch.Tensor:
    """The grid barrier's scratch for ladders on ``stream`` of ``device``:
    int32 zeros, allocated once, which every ladder leaves at zero."""
    key = (device.index, stream)
    bar = _BARS.get(key)
    if bar is None:
        bar = torch.zeros(_lib().sheep_lift_bar_words(), dtype=torch.int32,
                          device=device)
        _BARS[key] = bar
    return bar


def ladder_grid(T: int):
    """(blocks, threads a block) of the ladder's grid for T entries."""
    b, t = ctypes.c_int(), ctypes.c_int()
    _raise_if(_lib().sheep_lift_grid(T, ctypes.byref(b), ctypes.byref(t)),
              "lift_stack")
    return b.value, t.value


def copy_row(src: torch.Tensor, dst: torch.Tensor) -> None:
    """``dst[:T] = src`` on the ladder's grid, T = len(src): the stream
    floor of one level (a yardstick; no kernel of the path)."""
    _check_vec("copy_row: src", src)
    _check_vec("copy_row: dst", dst)
    if len(dst) < len(src) or dst.device != src.device:
        raise ValueError("copy_row: dst must hold len(src) entries on "
                         "src's device")
    if src.device.type == "cpu":
        dst[:len(src)].copy_(src)
        return
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _lib().sheep_lift_copy_row(src.data_ptr(), dst.data_ptr(),
                                        len(src), stream)
    _raise_if(rc, "copy_row")


def chase(t: torch.Tensor, start: int, steps: int, out: torch.Tensor,
          blocks: int = 1) -> None:
    """``steps`` dependent loads cur <- t[clip(cur)] from ``start`` on one
    thread, the end into ``out[0]``; with 0 steps an empty kernel of
    ``blocks`` blocks of 256 threads. The yardsticks of ``climb_jumps``'
    chain, the launch floor and the latency of a dependent load (a
    yardstick; no kernel of the path)."""
    _check_vec("chase: t", t)
    _check_vec("chase: out", out)
    if not 0 < len(t) < 2**31 or len(out) < 1 or steps < 0 or blocks < 1 \
            or out.device != t.device:
        raise ValueError("chase: a table of 1 .. 2^31-1 entries, steps >= "
                         "0, blocks >= 1 and out on t's device")
    if t.device.type == "cpu":
        cur = int(start)
        for _ in range(steps):
            cur = int(t[min(max(cur, 0), len(t) - 1)])
        if steps:
            out[0] = cur
        return
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _lib().sheep_lift_chase(t.data_ptr(), len(t), int(start), steps,
                                     out.data_ptr(), blocks, stream)
    _raise_if(rc, "chase")


def lift_stack(P: torch.Tensor, stack: torch.Tensor,
               ctl: torch.Tensor, state: torch.Tensor = None) -> None:
    """Fill ``stack`` with t_1 .. t_{d-1} of P and set ``ctl`` to
    [d - 1, 0, 0, 0, 0], for ``stack.shape[0] + 1`` levels. With an
    execution ``state`` that has stopped: only ``ctl`` is zeroed."""
    _check("lift_stack", P, stack, ctl, state=state)
    L = stack.shape[0] + 1
    if P.device.type == "cpu":
        if state is not None and fixpoint.stopped(state):
            ctl.zero_()
            return
        st, d = lift_stack_plain(P, L)
        stack[:d - 1, :len(P)] = st[:d - 1]
        ctl.zero_()
        ctl[ROWS] = d - 1
        return
    lib = _lib()
    ex = None if state is None else state.data_ptr()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = lib.sheep_lift_stack(
            P.data_ptr(), len(P), stack.data_ptr(), stack.shape[1], L,
            ctl.data_ptr(), ex, _bar(P.device, stream).data_ptr(), stream)
    _raise_if(rc, "lift_stack")
    LAUNCHES["lift_stack"] += 1


def stream_descent(P: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   levels: int, scratch: Descent, ctl: torch.Tensor,
                   state: torch.Tensor = None) -> torch.Tensor:
    """The stream descent of one round over ``levels`` levels of P:
    returns ``scratch.pre``, which holds, at each live slot (lo != n), lo
    climbed level by level (:func:`stream_descent_plain`; a dead slot's
    ``pre`` is not written on CUDA), and sets ``ctl`` to [levels - 1, 0,
    0, 0, 0]. ``scratch`` is the kernel's (:func:`new_descent`). With an
    execution ``state``: [N, C] blocks ``lo``/``hi`` read at its row, and
    nothing at all once it has stopped."""
    fn = "stream_descent"
    _check(fn, P, None, ctl, lo, hi, state=state)
    C = lo.shape[-1]
    pre, rows, mask = scratch
    if not 1 <= levels <= 32:
        raise ValueError(f"{fn}: levels must be in 1 .. 32, got {levels}")
    for name, t, size in (("pre", pre, C), ("mask", mask, -(-C // 32))):
        _check_vec(f"{fn}: {name}", t)
        if len(t) != size:
            raise ValueError(f"{fn}: {name} must hold {size} entries")
    want = (2 if levels > 1 else 0, row_stride(len(P)))
    if rows.dtype != torch.int32 or tuple(rows.shape) != want or \
            not rows.is_contiguous():
        raise ValueError(f"{fn}: rows must be a contiguous int32 {want} "
                         f"tensor (new_descent)")
    for t in (pre, rows, mask):
        if t.device != P.device:
            raise ValueError(f"{fn}: tensors on {P.device} and {t.device}")
    if P.device.type == "cpu":
        if state is not None:
            if fixpoint.stopped(state):
                return pre
            lo, hi = fixpoint.pick_row(state, lo, hi)
        ctl.zero_()
        ctl[ROWS] = levels - 1
        pre.copy_(stream_descent_plain(P, lo, hi, levels))
        return pre
    ex = None if state is None else state.data_ptr()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = _lib().sheep_stream_descent(
            P.data_ptr(), len(P), rows.data_ptr() if levels > 1 else None,
            rows.shape[1], lo.data_ptr(), hi.data_ptr(), C,
            C if lo.dim() == 2 else 0, pre.data_ptr(), mask.data_ptr(),
            levels, ctl.data_ptr(), ex, _bar(P.device, stream).data_ptr(),
            stream)
    _raise_if(rc, fn)
    LAUNCHES[fn] += 1
    return pre


def climb_tail(lo: torch.Tensor, hi: torch.Tensor, old_at_lo: torch.Tensor,
               P: torch.Tensor, stack, ctl: torch.Tensor, jumps: int = 0):
    """The round after its scatter-min, in one pass: returns ``(out_lo,
    out_hi)``, ORs this pass's changed flag into ``ctl[CHANGED]`` and adds
    its retired and live counts to ``ctl[RETIRED]`` and ``ctl[LIVE]``;
    climbs ``ctl[ROWS] + 1`` levels, or with ``jumps`` > 0 takes that many
    single steps over P (``climb_jumps``; ``stack`` may be None)."""
    _check("climb_tail", P, None if jumps > 0 else stack, ctl, lo, hi,
           old_at_lo)
    if P.device.type == "cpu":
        out_lo, out_hi, changed, retired, live = climb_tail_plain(
            lo, hi, old_at_lo, P, stack, int(ctl[ROWS]) + 1, jumps=jumps)
        ctl[CHANGED] |= changed
        ctl[RETIRED] += retired
        ctl[LIVE] += live
        return out_lo, out_hi
    out_lo = torch.empty_like(lo)
    out_hi = torch.empty_like(hi)
    _launch_climb(lo, hi, old_at_lo, P, stack, ctl, out_lo, out_hi,
                  jumps=jumps)
    return out_lo, out_hi


def climb_rows(loB: torch.Tensor, hiB: torch.Tensor, old_at_lo: torch.Tensor,
               P: torch.Tensor, stack, ctl: torch.Tensor,
               state: torch.Tensor, batch_rounds: int,
               pre: torch.Tensor = None, jumps: int = 0) -> None:
    """:func:`climb_tail` on the row of the [N, C] blocks that the
    execution ``state`` picks, written back into that row, then the end of
    the round (``fixpoint.round_end_plain``, for an execution over the
    blocks' N rows with a budget of ``batch_rounds`` rounds); nothing once
    the execution has stopped. ``pre``: the stream descent's climbed
    positions, used instead of climbing the stack; ``jumps`` > 0: the
    jump-mode climb (``climb_jumps``); with either, ``stack`` may be
    None."""
    slots = (loB, hiB, old_at_lo) + (() if pre is None else (pre,))
    if pre is not None or jumps > 0:
        stack = None
    _check("climb_tail", P, stack, ctl, *slots, state=state)
    N = loB.shape[0]
    fixpoint.check_round_end("climb_tail", state, N, batch_rounds)
    if P.device.type == "cpu":
        if fixpoint.stopped(state):
            return
        lo, hi = fixpoint.pick_row(state, loB, hiB)
        out_lo, out_hi, changed, retired, live = climb_tail_plain(
            lo, hi, old_at_lo, P, stack, int(ctl[ROWS]) + 1, pre, jumps)
        lo.copy_(out_lo)
        hi.copy_(out_hi)
        ctl[CHANGED] |= changed
        ctl[RETIRED] += retired
        ctl[LIVE] += live
        fixpoint.round_end_plain(ctl, state, N, batch_rounds)
        return
    _launch_climb(loB, hiB, old_at_lo, P, stack, ctl, loB, hiB, state, pre,
                  N, batch_rounds, jumps)


def _launch_climb(lo, hi, old_at_lo, P, stack, ctl, out_lo, out_hi,
                  state=None, pre=None, N=0, batch_rounds=0,
                  jumps=0) -> None:
    lib = _lib()
    row_stride = lo.shape[1] if lo.dim() == 2 else 0
    ex = None if state is None else state.data_ptr()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        if jumps > 0:
            rc = lib.sheep_climb_jumps(
                lo.data_ptr(), hi.data_ptr(), old_at_lo.data_ptr(),
                lo.shape[-1], P.data_ptr(), len(P), jumps, ctl.data_ptr(),
                out_lo.data_ptr(), out_hi.data_ptr(), ex, row_stride, N,
                batch_rounds, stream)
            _raise_if(rc, "climb_jumps")
            LAUNCHES["climb_jumps"] += 1
            return
        rc = lib.sheep_climb_tail(
            lo.data_ptr(), hi.data_ptr(), old_at_lo.data_ptr(),
            lo.shape[-1], P.data_ptr(), len(P),
            None if stack is None else stack.data_ptr(),
            0 if stack is None else stack.shape[1], ctl.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), ex, row_stride,
            None if pre is None else pre.data_ptr(), N, batch_rounds,
            stream)
    _raise_if(rc, "climb_tail")
    LAUNCHES["climb_tail"] += 1
