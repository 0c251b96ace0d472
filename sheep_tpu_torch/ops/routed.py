"""The routed round of the vertex-sharded build (the owner and requester
sides of ``_lookup`` and ``_scatter_min`` and the round's local rewrite,
``sheep_tpu/parallel/bigv.py:150-182`` and ``:263-285``; XLA programs
under ``shard_map`` in the JAX package).

A table of n + 1 rows is block-sharded over the D shards of a mesh: shard
s owns rows [s B, (s + 1) B), B = ceil((n + 1) / D), the rows past n hold
the sentinel n. A card holds the blocks of its S shards first .. first +
S - 1 as one (S, B) buffer. A routed lookup is the all-gather of every
shard's requests (a (D, W) block), each owner's answers ((S, D, W) a card:
its entry where it owns the row, n elsewhere), the all-to-all that hands
requester j row j of every owner's answers, and the requester's fold with
a min; the routed scatter-min folds (lo -> val) requests into the owned
rows and answers before and after.

Kernels (``csrc/routed.cu``), each with its plain PyTorch version:

  owned_gather       the owner side of a lookup, one launch a card
  owned_scatter_min  the owner side of the scatter-min: the answers before
                     the round, the min-fold, the answers after (three
                     launches in stream order)
  routed_step        the requester's fold, then the climb's rewrite
                     ``cur <- cand < hi ? cand : cur``, or the plain min
  routed_round_end   the round's end (retire, displace, became-loop, the
                     new slots in place, the live slots counted into the
                     segment state), the count of a segment's first live
                     slots, and the segment's accounting (psum and pmax of
                     the shards' live words, the round counted, STOP)

The segment state (:func:`new_state`, int64, one a card) is [STOP,
ROUNDS, LIVE, MAX_LIVE] and one live word a shard of the mesh; every
kernel given it does nothing once STOP is set. On CUDA tensors the
wrappers launch the kernels; on CPU tensors they run the plain versions,
reading the state on the host. Anything else raises. ``LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"owned_gather": 0, "owned_scatter_min": 0, "routed_step": 0,
            "routed_round_end": 0}

STOP, ROUNDS, LIVE, MAX_LIVE = range(4)
WORDS = 4
FOLD, COUNT, ACCOUNT = range(3)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def new_state(d: int, device) -> torch.Tensor:
    """A fresh segment state for a mesh of ``d`` shards."""
    return torch.zeros(WORDS + d, dtype=torch.int64, device=device)


def _halted(state) -> bool:
    return state is not None and bool(state[STOP])


def _check(fn: str, name: str, t: torch.Tensor, dims: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} must be int32, got {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}")


def _contig(fn: str, name: str, t: torch.Tensor, dims: int) -> None:
    _check(fn, name, t, dims)
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _same_device(fn: str, ref: torch.Tensor, *ts) -> None:
    for t in ts:
        if t is not None and t.device != ref.device:
            raise ValueError(f"{fn}: tensors on {ref.device} and {t.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {ref.device}")


def _check_state(fn: str, state, d: int, device) -> None:
    if state is None:
        return
    if state.dtype != torch.int64 or state.dim() != 1 or \
            len(state) != WORDS + d or not state.is_contiguous():
        raise ValueError(f"{fn}: state must be routed.new_state({d})")
    if state.device != device:
        raise ValueError(f"{fn}: state on {state.device}, data on {device}")


def _replies(fn: str, rep: torch.Tensor):
    """(D, R, W) answers with unit stride along W: their strides."""
    _check(fn, "rep", rep, 3)
    if rep.stride(2) != 1 or rep.shape[2] > 1 and rep.stride(1) < \
            rep.shape[2]:
        raise ValueError(f"{fn}: rep must have unit stride along its last "
                         f"dimension and rows that do not overlap")
    return rep.stride(0), rep.stride(1)


# -- plain versions ---------------------------------------------------------

def owned_answers_plain(table: torch.Tensor, first: int, req: torch.Tensor,
                        n: int) -> torch.Tensor:
    """The plain owner side: (S, D, W) answers of shards first .. first + S
    - 1 (blocks ``table`` (S, B)) to the requests ``req`` (D, W)."""
    S, B = table.shape
    base = (first + torch.arange(S, device=req.device,
                                 dtype=torch.int64)) * B
    local = req.long().unsqueeze(0) - base.view(S, 1, 1)
    ok = (local >= 0) & (local < B)
    idx = local.clamp(0, B - 1).reshape(S, -1)
    val = table.gather(1, idx).view(local.shape)
    return torch.where(ok, val, n).to(torch.int32)


def owned_scatter_min_plain(table: torch.Tensor, first: int,
                            lo: torch.Tensor, val: torch.Tensor, n: int):
    """The plain version of :func:`owned_scatter_min`: (old, new), the
    table min-folded in place."""
    S, B = table.shape
    old = owned_answers_plain(table, first, lo, n)
    local = lo.long().reshape(-1) - first * B
    ok = (local >= 0) & (local < S * B)
    flat = table.view(-1)
    flat.scatter_reduce_(0, local[ok], val.reshape(-1)[ok], reduce="amin",
                         include_self=True)
    return old, owned_answers_plain(table, first, lo, n)


def routed_fold_plain(rep: torch.Tensor) -> torch.Tensor:
    """The requester's fold of (D, R, W) answers: the min over the owners."""
    return rep.amin(0)


def routed_step_plain(rep, hi=None, cur=None):
    """(out, cand): cand the folded answers, out ``cand < hi ? cand : cur``
    (cand itself without ``hi``)."""
    cand = routed_fold_plain(rep)
    if hi is None:
        return cand, cand
    return torch.where(cand < hi, cand, cur), cand


def round_end_plain(old, new, cur, lo, hi, n: int):
    """The round's end (``bigv.py:265-283``): (out_lo, out_hi)."""
    retire = hi == new
    displaced = retire & (new < old) & (old < n)
    loop = cur == hi
    climb_lo = torch.where(loop, n, cur)
    climb_hi = torch.where(loop, n, hi)
    out_lo = torch.where(retire, torch.where(displaced, new, n), climb_lo)
    out_hi = torch.where(retire, torch.where(displaced, old, n), climb_hi)
    return out_lo.to(torch.int32), out_hi.to(torch.int32)


def account_plain(state: torch.Tensor, first: int, S: int,
                  budget: int, start: bool) -> None:
    """The segment's accounting on a CPU state (``ACCOUNT``)."""
    if bool(state[STOP]):
        return
    words = state[WORDS:]
    rounds = int(state[ROUNDS]) + (0 if start else 1)
    live = int(words.sum())
    state[ROUNDS] = rounds
    state[LIVE] = live
    state[MAX_LIVE] = int(words.max()) if len(words) else 0
    state[STOP] = int(live == 0 or rounds >= budget)
    state[WORDS + first:WORDS + first + S] = 0


# -- kernels ----------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("routed")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, args in (
                ("sheep_owned_gather", [p, ll, ll, i, p, ll, ll, p, i, p,
                                        p]),
                ("sheep_owned_scatter_min", [p, ll, ll, i, p, p, ll, ll, p,
                                             p, i, p, p]),
                ("sheep_routed_step", [p, ll, ll, ll, ll, ll, p, p, p, p, p,
                                       p]),
                ("sheep_routed_round_end", [p, ll, ll, ll, ll, p, p, p, p, i,
                                            ll, i, p, i, ll, p]),
                ("sheep_routed_round", [p, ll, ll, i, p, p, p, p, ll, p, p,
                                        p, p, p, i, p, p, p, ll, p])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
        lib.sheep_routed_error_string.argtypes = [i]
        lib.sheep_routed_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, dev, launches: int, *args) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"sheep_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.sheep_routed_error_string(rc).decode())
    LAUNCHES[name] += launches


def _ptr(t):
    return None if t is None else t.data_ptr()


def _owner_args(fn, table, first, req, n, state):
    _contig(fn, "table", table, 2)
    _contig(fn, "requests", req, 2)
    _same_device(fn, table, req, state)
    _check_state(fn, state, req.shape[0], table.device)
    S, B = table.shape
    if not 0 <= first or S < 1 or B < 1 or not 0 <= n < 2**31:
        raise ValueError(f"{fn}: bad first {first}, blocks {S} x {B} or n")
    return S, B


def owned_gather(table: torch.Tensor, first: int, req: torch.Tensor,
                 n: int, state: torch.Tensor = None) -> torch.Tensor:
    """(S, D, W) int32 answers of the card's shards first .. first + S - 1
    (blocks ``table`` (S, B), contiguous) to the all-gathered requests
    ``req`` (D, W): ``table[s][q - (first + s) B]`` where shard first + s
    owns row q, n elsewhere. With a segment ``state``: nothing once it has
    stopped (the output is then left unwritten)."""
    fn = "owned_gather"
    S, B = _owner_args(fn, table, first, req, n, state)
    D, W = req.shape
    if table.device.type == "cpu":
        if _halted(state):
            return torch.full((S, D, W), n, dtype=torch.int32)
        return owned_answers_plain(table, first, req, n)
    out = torch.empty((S, D, W), dtype=torch.int32, device=table.device)
    _launch(fn, table.device, 1, table.data_ptr(), B, first, S,
            req.data_ptr(), D, W, out.data_ptr(), n, _ptr(state))
    return out


def owned_scatter_min(table: torch.Tensor, first: int, lo: torch.Tensor,
                      val: torch.Tensor, n: int,
                      state: torch.Tensor = None):
    """The owner side of a routed scatter-min over the all-gathered
    requests ``lo``, ``val`` (D, W): returns (old, new), the (S, D, W)
    answers before and after ``table[lo - first B] <- min(..., val)`` over
    every request the card's shards own, duplicates included, in place.
    Entries of ``table`` lie in [0, n]. With a segment ``state``: nothing
    once it has stopped."""
    fn = "owned_scatter_min"
    S, B = _owner_args(fn, table, first, lo, n, state)
    _contig(fn, "val", val, 2)
    if val.shape != lo.shape:
        raise ValueError(f"{fn}: lo {tuple(lo.shape)} and val "
                         f"{tuple(val.shape)} differ")
    _same_device(fn, table, val)
    D, W = lo.shape
    if table.device.type == "cpu":
        if _halted(state):
            full = torch.full((S, D, W), n, dtype=torch.int32)
            return full, full.clone()
        return owned_scatter_min_plain(table, first, lo, val, n)
    old = torch.empty((S, D, W), dtype=torch.int32, device=table.device)
    new = torch.empty_like(old)
    _launch(fn, table.device, 3, table.data_ptr(), B, first, S,
            lo.data_ptr(), val.data_ptr(), D, W, old.data_ptr(),
            new.data_ptr(), n, _ptr(state))
    return old, new


def routed_step(rep: torch.Tensor, out: torch.Tensor, hi=None, cur=None,
                store=None, state: torch.Tensor = None) -> None:
    """The requester's fold of the (D, R, W) answers ``rep`` (a view with
    unit stride along W, as :func:`~sheep_tpu_torch.parallel.mesh.
    all_to_all` leaves them) with a min, into ``out`` (R, W): with ``hi``,
    ``out = cand < hi ? cand : cur`` (``cur`` may be ``out``), else the
    folded answers; ``store`` (R, W), when given, also gets them. With a
    segment ``state``: nothing once it has stopped."""
    fn = "routed_step"
    so, sr = _replies(fn, rep)
    D, R, W = rep.shape
    for name, t in (("out", out), ("hi", hi), ("cur", cur),
                    ("store", store)):
        if t is not None:
            _contig(fn, name, t, 2)
            if t.shape != (R, W):
                raise ValueError(f"{fn}: {name} {tuple(t.shape)}, answers "
                                 f"for {(R, W)}")
    if (hi is None) != (cur is None):
        raise ValueError(f"{fn}: hi and cur go together")
    _same_device(fn, rep, out, hi, cur, store, state)
    _check_state(fn, state, len(state) - WORDS if state is not None else 0,
                 rep.device)
    if rep.device.type == "cpu":
        if _halted(state):
            return
        res, cand = routed_step_plain(rep, hi, cur)
        if store is not None:
            store.copy_(cand)
        out.copy_(res)
        return
    _launch(fn, rep.device, 1, rep.data_ptr(), D, so, sr, R, W, _ptr(hi),
            _ptr(cur), out.data_ptr(), _ptr(store), _ptr(state))


def routed_round_end(rep_old: torch.Tensor, new: torch.Tensor,
                     cur: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     n: int, first: int, state: torch.Tensor) -> None:
    """The round's end on the card's shards first .. first + S - 1: the
    (D, S, Q) pre-round answers ``rep_old`` folded, then retire, displace
    and became-loop as the reference's round, the new slots written into
    ``lo``/``hi`` (S, Q) in place, and each shard's live slots added into
    its word of ``state``. Nothing once the state has stopped."""
    fn = "routed_round_end"
    so, sr = _replies(fn, rep_old)
    D, S, W = rep_old.shape
    for name, t in (("new", new), ("cur", cur), ("lo", lo), ("hi", hi)):
        _contig(fn, name, t, 2)
        if t.shape != (S, W):
            raise ValueError(f"{fn}: {name} {tuple(t.shape)}, answers for "
                             f"{(S, W)}")
    _same_device(fn, rep_old, new, cur, lo, hi, state)
    _check_state(fn, state, len(state) - WORDS, rep_old.device)
    if rep_old.device.type == "cpu":
        if _halted(state):
            return
        out_lo, out_hi = round_end_plain(routed_fold_plain(rep_old), new,
                                         cur, lo, hi, n)
        lo.copy_(out_lo)
        hi.copy_(out_hi)
        state[WORDS + first:WORDS + first + S] += \
            (out_lo != n).sum(1, dtype=torch.int64)
        return
    _launch(fn, rep_old.device, 1, rep_old.data_ptr(), D, so, sr, W,
            new.data_ptr(), cur.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
            first, S, state.data_ptr(), FOLD, 0)


def count_live(lo: torch.Tensor, n: int, first: int,
               state: torch.Tensor) -> None:
    """Add each shard's live slots (``lo`` (S, Q) != n) into its word of
    ``state`` (``routed_round_end``'s COUNT mode). Nothing once stopped."""
    fn = "routed_round_end"
    _contig(fn, "lo", lo, 2)
    _same_device(fn, lo, state)
    _check_state(fn, state, len(state) - WORDS, lo.device)
    S, W = lo.shape
    if lo.device.type == "cpu":
        if _halted(state):
            return
        state[WORDS + first:WORDS + first + S] += \
            (lo != n).sum(1, dtype=torch.int64)
        return
    _launch(fn, lo.device, 1, None, 1, 0, 0, W, None, None, lo.data_ptr(),
            None, n, first, S, state.data_ptr(), COUNT, 0)


def account(state: torch.Tensor, first: int, S: int, budget: int,
            start: bool = False) -> None:
    """The segment's accounting once every shard's live word has reached
    ``state`` (``routed_round_end``'s ACCOUNT mode): LIVE the sum of the
    words, MAX_LIVE their max, ROUNDS counted (not at the ``start``), STOP
    set when nothing is live or ``budget`` rounds are done; the card's own
    words (shards first .. first + S - 1) zeroed for the next count.
    Nothing once stopped."""
    fn = "routed_round_end"
    if state.dtype != torch.int64 or state.dim() != 1 or \
            len(state) <= WORDS:
        raise ValueError(f"{fn}: state must be routed.new_state(d)")
    if budget < 1:
        raise ValueError(f"{fn}: a segment needs a budget >= 1")
    if state.device.type == "cpu":
        account_plain(state, first, S, budget, start)
        return
    if state.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {state.device}")
    d = len(state) - WORDS
    _launch(fn, state.device, 1, None, d, 0, 0, 0, None, None, None, None,
            0, first, S, state.data_ptr(), ACCOUNT,
            -budget - 1 if start else budget)


CLIMB, SQUARE = 0, 1


class CardRound:
    """One fixpoint round of a segment on a card that holds every shard of
    the mesh (first 0, S = D): the all-gather of the shards' (D, W) rows
    is that buffer itself and the all-to-all the answers' transpose, so
    nothing moves between the kernels. A round is the scatter-min, the
    climb's first step from its post-round answers, the climb
    ``program`` (a list of (CLIMB, table): a lookup at the slots' cur and
    the rewrite below hi; or (SQUARE, table): the table's entries looked
    up in it, folded into ``t_buf``), the round's end and the segment's
    accounting over ``budget`` rounds. One host call enqueues the round's
    launches (``sheep_routed_round``); it has no CPU path of its own: on
    the CPU the same steps run through the wrappers one by one, as on a
    mesh of several cards. P (D, B), lo/hi (D, Q) and ``t_buf`` are
    updated in place; the buffers are the segment's."""

    def __init__(self, P, lo, hi, n: int, program, state, budget: int,
                 t_buf=None):
        fn = "CardRound"
        _contig(fn, "P", P, 2)
        for name, t in (("lo", lo), ("hi", hi)):
            _contig(fn, name, t, 2)
        D, Q = lo.shape
        B = P.shape[1]
        if P.shape[0] != D or hi.shape != lo.shape or Q < 1:
            raise ValueError(f"{fn}: P {tuple(P.shape)}, slots "
                             f"{tuple(lo.shape)}")
        _same_device(fn, P, lo, hi, state, t_buf)
        if P.device.type != "cuda":
            raise ValueError(f"{fn}: a CUDA kernel sequence; on {P.device} "
                             f"a round goes through the wrappers one by "
                             f"one (BigVPipeline._round)")
        _check_state(fn, state, D, P.device)
        for kind, t in program:
            _contig(fn, "table", t, 2)
            if t.shape != P.shape or t.device != P.device:
                raise ValueError(f"{fn}: a climb table is not (D, B) on "
                                 f"{P.device}")
        if budget < 1:
            raise ValueError(f"{fn}: a segment needs a budget >= 1")
        squares = sum(kind == SQUARE for kind, _ in program)
        if squares and (t_buf is None or t_buf.shape != P.shape):
            raise ValueError(f"{fn}: squarings need a (D, B) t_buf")
        self.P, self.lo, self.hi, self.n = P, lo, hi, n
        self.program, self.state, self.budget = program, state, budget
        self.t_buf = t_buf
        self.cur = torch.empty_like(lo)
        self.new = torch.empty_like(lo)
        self.launches = {"owned_scatter_min": 3,
                         "owned_gather": len(program),
                         "routed_step": 1 + len(program),
                         "routed_round_end": 2}
        dev = P.device
        self.ans = torch.empty((3, D, D, Q), dtype=torch.int32, device=dev)
        ans_b = torch.empty((D, D, B), dtype=torch.int32, device=dev) \
            if squares else None
        k = max(len(program), 1)
        self._kinds = (ctypes.c_int * k)(*[kind for kind, _ in program])
        self._tables = (ctypes.c_void_p * k)(*[t.data_ptr()
                                               for _, t in program])
        self._keep = (ans_b, self._kinds, self._tables)
        self.args = (P.data_ptr(), B, D, n, lo.data_ptr(), hi.data_ptr(),
                     self.cur.data_ptr(), self.new.data_ptr(), Q,
                     self.ans[0].data_ptr(), self.ans[1].data_ptr(),
                     self.ans[2].data_ptr(), _ptr(ans_b), _ptr(t_buf),
                     len(program), ctypes.addressof(self._kinds),
                     ctypes.addressof(self._tables), state.data_ptr(),
                     budget)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self) -> None:
        lib = _lib()
        rc = lib.sheep_routed_round(*self.args, self.stream)
        if rc != 0:
            raise RuntimeError("routed round launch failed: "
                               + lib.sheep_routed_error_string(rc).decode())
        for key, count in self.launches.items():
            LAUNCHES[key] += count
