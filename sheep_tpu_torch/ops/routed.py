"""The routed round of the vertex-sharded build (the owner and requester
sides of ``_lookup`` and ``_scatter_min``, the jump climb and squaring of
the fold programs, and the round's local rewrite,
``sheep_tpu/parallel/bigv.py:150-182``, ``:263-285`` and ``:310-399``; XLA
programs under ``shard_map`` in the JAX package).

A table of n + 1 rows is block-sharded over the D shards of a mesh: shard
s owns rows [s B, (s + 1) B), B = ceil((n + 1) / D), the rows past n hold
the sentinel n. A card holds the blocks of its S shards first .. first +
S - 1 as one (S, B) buffer. A routed lookup is the all-gather of every
shard's requests (a (D, W) block), each owner's answers ((S, D, W) a card:
its entry where it owns the row, n elsewhere), the all-to-all that hands
requester j row j of every owner's answers, and the requester's fold with
a min; the routed scatter-min folds (lo -> val) requests into the owned
rows and answers before and after. On a card that holds every shard
(first 0, S = D) the min over the answers to a request q is the (D, B)
buffer's own entry at q (n past it), so the card forms read the table
there and move no answers.

Kernels (``csrc/routed.cu``), each with its plain PyTorch version:

  owned_gather       the owner side of a lookup, one launch a card
  owned_scatter_min  the scatter-min, equal rows pre-combined a warp:
                     the answers before the round, the min-fold, the
                     answers after (three launches in stream order); or,
                     with ``fold`` on a card that holds every shard, the
                     folded parents before it, one cooperative launch
  routed_step        the requester's fold, then the climb's rewrite
                     ``cur <- cand < hi ? cand : cur``, or the plain min
  routed_climb       routed_step's card form for a climb: runs of steps
                     over the card's own tables in one launch, a run
                     ending at its first step that does not move a slot
  routed_square      routed_step's card form for a squaring, t[t]
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
            "routed_climb": 0, "routed_square": 0, "routed_round_end": 0}

STOP, ROUNDS, LIVE, MAX_LIVE = range(4)
WORDS = 4
FOLD, COUNT, ACCOUNT = range(3)
# the runs of one routed_climb launch (csrc/routed.cu kMaxRuns)
MAX_RUNS = 32


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


def _slots(fn: str, shape, **ts) -> None:
    """Contiguous int32 slot tensors of one shape (None skipped)."""
    for name, t in ts.items():
        if t is None:
            continue
        _contig(fn, name, t, len(shape))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} {tuple(t.shape)}, slots "
                             f"{tuple(shape)}")


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


def take_plain(table: torch.Tensor, q: torch.Tensor, n: int) -> torch.Tensor:
    """The whole table's entries at ``q`` (``table`` read flat; n where q
    lies outside it): on a card that holds every shard, the min over the
    owners' answers to q."""
    flat = table.reshape(-1)
    ok = (q >= 0) & (q < flat.numel())
    got = flat[q.long().clamp(0, flat.numel() - 1)]
    return torch.where(ok, got, n).to(torch.int32)


def owned_scatter_min_plain(table: torch.Tensor, first: int,
                            lo: torch.Tensor, val: torch.Tensor, n: int,
                            fold: bool = False):
    """The plain version of :func:`owned_scatter_min`: (old, new), the
    table min-folded in place; with ``fold`` (first 0, the table every
    shard's block) the folded (D, W) parents before and after."""
    S, B = table.shape
    if fold:
        old = take_plain(table, lo, n)
    else:
        old = owned_answers_plain(table, first, lo, n)
    local = lo.long().reshape(-1) - first * B
    ok = (local >= 0) & (local < S * B)
    flat = table.view(-1)
    flat.scatter_reduce_(0, local[ok], val.reshape(-1)[ok], reduce="amin",
                         include_self=True)
    if fold:
        return old, take_plain(table, lo, n)
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


def climb_runs_plain(start: torch.Tensor, hi: torch.Tensor, runs, n: int):
    """The plain version of :func:`routed_climb`, every step taken (no
    early stop): from ``start``, for each (table, steps) of ``runs`` that
    many steps ``cand = table[cur]`` (n past the table), ``cur = cand <
    hi ? cand : cur``. Returns (cur, the first step's candidate)."""
    cur, first = start, None
    for table, steps in runs:
        for _ in range(steps):
            cand = take_plain(table, cur, n)
            if first is None:
                first = cand
            cur = torch.where(cand < hi, cand, cur)
    return cur.to(torch.int32), first


def routed_climb_plain(table: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, steps: int, n: int):
    """A round's jump climb as the reference writes it (``bigv.py:310-324``
    on one card): the first step from ``lo``, then ``steps - 1`` lookups
    of ``table``, no early stop. Returns (cur, new): new the first step's
    candidate, the post-round parent at lo."""
    return climb_runs_plain(lo, hi, [(table, steps)], n)


def routed_square_plain(t: torch.Tensor, n: int) -> torch.Tensor:
    """A routed squaring on a card that holds every shard: ``t[t]`` (n past
    the table), the reference's ``_lookup(t, t)``."""
    return take_plain(t, t, n)


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
                ("sheep_scatter_card", [p, ll, p, p, ll, p, i, p, p]),
                ("sheep_routed_step", [p, ll, ll, ll, ll, ll, p, p, p, p, p,
                                       p]),
                ("sheep_routed_climb", [i, p, p, ll, p, p, p, p, ll, i, p,
                                        p]),
                ("sheep_routed_square", [p, ll, p, i, p, p]),
                ("sheep_routed_round_end", [p, ll, ll, ll, ll, p, p, p, p, i,
                                            ll, i, p, i, ll, p]),
                ("sheep_routed_round", [p, ll, ll, i, p, p, p, p, p, ll, i,
                                        p, p, p, p, p, p, ll, p])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
        lib.sheep_routed_error_string.argtypes = [i]
        lib.sheep_routed_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, dev, launches: int, *args, entry: str = None) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"sheep_{entry or name}")(*args, stream)
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
                      state: torch.Tensor = None, fold: bool = False):
    """The owner side of a routed scatter-min over the all-gathered
    requests ``lo``, ``val`` (D, W): returns (old, new), the (S, D, W)
    answers before and after ``table[lo - first B] <- min(..., val)`` over
    every request the card's shards own, duplicates included, in place.
    Entries of ``table`` lie in [0, n]. With ``fold`` the card holds every
    shard (first 0, S = D) and the call returns old alone: the folded (D,
    W) pre-round parents, the table's entries at lo (n past it), in one
    cooperative launch (a round reads its post-round parents from the
    table). With a segment ``state``: nothing once it has stopped."""
    fn = "owned_scatter_min"
    S, B = _owner_args(fn, table, first, lo, n, state)
    _contig(fn, "val", val, 2)
    if val.shape != lo.shape:
        raise ValueError(f"{fn}: lo {tuple(lo.shape)} and val "
                         f"{tuple(val.shape)} differ")
    _same_device(fn, table, val)
    D, W = lo.shape
    if fold and (first != 0 or S != D):
        raise ValueError(f"{fn}: the folded form needs every shard on the "
                         f"card (first 0, {S} blocks for {D} shards)")
    shape = (D, W) if fold else (S, D, W)
    if table.device.type == "cpu":
        if _halted(state):
            full = torch.full(shape, n, dtype=torch.int32)
            return full if fold else (full, full.clone())
        old, nw = owned_scatter_min_plain(table, first, lo, val, n, fold)
        return old if fold else (old, nw)
    old = torch.empty(shape, dtype=torch.int32, device=table.device)
    if fold:
        _launch(fn, table.device, 1, table.data_ptr(), S * B,
                lo.data_ptr(), val.data_ptr(), D * W, old.data_ptr(), n,
                _ptr(state), entry="scatter_card")
        return old
    nw = torch.empty_like(old)
    _launch(fn, table.device, 3, table.data_ptr(), B, first, S,
            lo.data_ptr(), val.data_ptr(), D, W, old.data_ptr(),
            nw.data_ptr(), n, _ptr(state))
    return old, nw


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
    _slots(fn, (R, W), out=out, hi=hi, cur=cur, store=store)
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


def _tables(fn: str, tables, ref: torch.Tensor) -> int:
    """The entries of a card's tables (contiguous int32, one shape, on
    ``ref``'s device)."""
    rows = None
    for t in tables:
        _contig(fn, "table", t, t.dim())
        _same_device(fn, ref, t)
        if rows is None:
            rows = t.shape
        elif t.shape != rows:
            raise ValueError(f"{fn}: tables of shapes {tuple(rows)} and "
                             f"{tuple(t.shape)}")
    numel = int(torch.Size(rows).numel()) if rows is not None else 0
    if not 0 < numel < 2**31:
        raise ValueError(f"{fn}: a table of {numel} entries")
    return numel


def routed_climb(start: torch.Tensor, hi: torch.Tensor, runs, n: int,
                 out: torch.Tensor, new=None,
                 state: torch.Tensor = None) -> None:
    """The card form of a routed climb (first 0, every shard on the card):
    from the slots' ``start`` (R, W), each (table, steps) of ``runs`` in
    turn, a step ``cand = table[cur]`` (the table read flat, n past it)
    and ``cur = cand < hi ? cand : cur``, into ``out`` (which may be
    ``start``). A run stops at its first step that does not move the slot
    (every later step of the run would load the same entry). ``new``, when
    given, gets the first step's candidate. One launch for at most
    MAX_RUNS runs. With a segment ``state``: nothing once it has
    stopped."""
    fn = "routed_climb"
    shape = tuple(start.shape)
    _slots(fn, shape, start=start, hi=hi, out=out, new=new)
    runs = [(t, int(s)) for t, s in runs]
    if not 0 < len(runs) <= MAX_RUNS or any(s < 1 for _, s in runs):
        raise ValueError(f"{fn}: 1 to {MAX_RUNS} runs of at least one "
                         f"step, got {[s for _, s in runs]}")
    rows = _tables(fn, [t for t, _ in runs], start)
    _same_device(fn, start, hi, out, new, state)
    _check_state(fn, state, len(state) - WORDS if state is not None else 0,
                 start.device)
    if start.device.type == "cpu":
        if _halted(state):
            return
        cur, first = climb_runs_plain(start, hi, runs, n)
        if new is not None:
            new.copy_(first)
        out.copy_(cur)
        return
    k = len(runs)
    tables = (ctypes.c_void_p * k)(*[t.data_ptr() for t, _ in runs])
    steps = (ctypes.c_int * k)(*[s for _, s in runs])
    _launch(fn, start.device, 1, k, tables, steps, rows, start.data_ptr(),
            hi.data_ptr(), out.data_ptr(), _ptr(new), start.numel(), n,
            _ptr(state))


def routed_square(t: torch.Tensor, n: int, out: torch.Tensor = None,
                  state: torch.Tensor = None) -> torch.Tensor:
    """The card form of a routed squaring (first 0, every shard on the
    card): ``out = t[t]`` (the table read flat, n past it) into another
    buffer of t's shape (allocated when not given). With a segment
    ``state``: nothing once it has stopped."""
    fn = "routed_square"
    rows = _tables(fn, [t], t)
    if out is None:
        out = torch.empty_like(t)
    _slots(fn, tuple(t.shape), out=out)
    if out.data_ptr() == t.data_ptr():
        raise ValueError(f"{fn}: out must be another buffer than t")
    _same_device(fn, t, out, state)
    _check_state(fn, state, len(state) - WORDS if state is not None else 0,
                 t.device)
    if t.device.type == "cpu":
        if not _halted(state):
            out.copy_(routed_square_plain(t, n))
        return out
    _launch(fn, t.device, 1, t.data_ptr(), rows, out.data_ptr(), n,
            _ptr(state))
    return out


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
    _slots(fn, (S, W), new=new, cur=cur, lo=lo, hi=hi)
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


# -- one round on a card that holds every shard ------------------------------

CLIMB, SQUARE = 0, 1
# the steps of a round's plan (csrc/routed.cu kPlanFirst, kPlanClimb,
# kPlanSquare)
PLAN_FIRST, PLAN_CLIMB, PLAN_SQUARE = 0, 1, 2


def round_plan(P: torch.Tensor, program) -> list:
    """The launches of a card round between its scatter and its end, from
    the climb ``program`` ((CLIMB, table): a step of the climb; (SQUARE,
    src, dst): dst = src[src]): the round's first step on ``P`` and the
    steps after it, consecutive steps on one table merged into one run and
    consecutive runs into one ``routed_climb`` launch of at most MAX_RUNS
    runs, each squaring a ``routed_square`` launch. Returns
    [(PLAN_FIRST or PLAN_CLIMB, [(table, steps), ...]) or (PLAN_SQUARE,
    src, dst)]."""
    plan, runs = [], [[P, 1]]

    def flush():
        for i in range(0, len(runs), MAX_RUNS):
            kind = PLAN_FIRST if not plan and i == 0 else PLAN_CLIMB
            plan.append((kind, [tuple(r) for r in runs[i:i + MAX_RUNS]]))
        runs.clear()

    for step in program:
        if step[0] == CLIMB:
            t = step[1]
            if runs and runs[-1][0].data_ptr() == t.data_ptr():
                runs[-1][1] += 1
            else:
                runs.append([t, 1])
        else:
            flush()
            plan.append((PLAN_SQUARE, step[1], step[2]))
    flush()
    return plan


def round_launches(plan) -> dict:
    """The kernel launches of one card round of ``plan`` by kernel: the
    scatter's one cooperative launch, the plan's climbs and squarings, the
    round's end and the accounting."""
    climbs = sum(step[0] != PLAN_SQUARE for step in plan)
    return {"owned_scatter_min": 1, "routed_climb": climbs,
            "routed_square": len(plan) - climbs, "routed_round_end": 2}


def card_round_plain(P, lo, hi, cur, new, old, n: int, plan, state,
                     budget: int) -> None:
    """The plain version of :class:`CardRound`'s round, its steps in its
    order on plain versions (every climb step taken): the folded
    scatter-min, the plan's climbs and squarings, the round's end with the
    pre-round parents as the one owner's answers, the accounting. P, lo,
    hi, the plan's squared tables and cur, new, old updated in place."""
    if _halted(state):
        return
    D = lo.shape[0]
    o, _ = owned_scatter_min_plain(P, 0, lo, hi, n, fold=True)
    old.copy_(o)
    for step in plan:
        if step[0] == PLAN_SQUARE:
            step[2].copy_(routed_square_plain(step[1], n))
            continue
        got, first = climb_runs_plain(lo if step[0] == PLAN_FIRST else cur,
                                      hi, step[1], n)
        if step[0] == PLAN_FIRST:
            new.copy_(first)
        cur.copy_(got)
    out_lo, out_hi = round_end_plain(old, new, cur, lo, hi, n)
    lo.copy_(out_lo)
    hi.copy_(out_hi)
    state[WORDS:WORDS + D] += (out_lo != n).sum(1, dtype=torch.int64)
    account_plain(state, 0, D, budget, False)


class CardRound:
    """One fixpoint round of a segment on a card that holds every shard of
    the mesh (first 0, S = D), where P (D, B) is the whole table and the
    min over the owners' answers to a request is P's own entry, so no
    answers are made: the scatter-min in card mode (the folded pre-round
    parents; one cooperative launch), the climb ``program`` as
    :func:`round_plan`'s launches (the round's first step and every climb
    step on one table in one ``routed_climb`` launch: a tail round's whole
    jump climb; each squaring a ``routed_square`` into its (D, B)
    ``dst``), the round's end with the pre-round parents as one owner's
    answers, and the segment's accounting over ``budget`` rounds. On CUDA
    one host call enqueues the round's launches (``sheep_routed_round``);
    on the CPU the same steps run as :func:`card_round_plain`. P, lo/hi
    (D, Q) and the squared tables are updated in place."""

    def __init__(self, P, lo, hi, n: int, program, state, budget: int):
        fn = "CardRound"
        _contig(fn, "P", P, 2)
        _slots(fn, tuple(lo.shape), lo=lo, hi=hi)
        D, Q = lo.shape
        B = P.shape[1]
        if P.shape[0] != D or Q < 1:
            raise ValueError(f"{fn}: P {tuple(P.shape)}, slots "
                             f"{tuple(lo.shape)}")
        _same_device(fn, P, lo, hi, state)
        _check_state(fn, state, D, P.device)
        tables = [t for step in program for t in step[1:]]
        if _tables(fn, [P] + tables, P) != D * B:
            raise ValueError(f"{fn}: a climb table is not (D, B)")
        if budget < 1:
            raise ValueError(f"{fn}: a segment needs a budget >= 1")
        self.P, self.lo, self.hi, self.n = P, lo, hi, n
        self.state, self.budget = state, budget
        self.plan = round_plan(P, program)
        self.launches = round_launches(self.plan)
        self.cur = torch.empty_like(lo)
        self.new = torch.empty_like(lo)
        self.old = torch.empty_like(lo)
        if P.device.type == "cpu":
            return
        kinds, args, nargs, ptrs, counts = [], [], [], [], []
        for step in self.plan:
            kinds.append(step[0])
            args.append(len(ptrs))
            if step[0] == PLAN_SQUARE:
                nargs.append(2)
                ptrs += [step[1].data_ptr(), step[2].data_ptr()]
                counts += [0, 0]
            else:
                nargs.append(len(step[1]))
                ptrs += [t.data_ptr() for t, _ in step[1]]
                counts += [s for _, s in step[1]]
        k, m = max(len(kinds), 1), max(len(ptrs), 1)
        self._arrays = ((ctypes.c_int * k)(*kinds),
                        (ctypes.c_int * k)(*args),
                        (ctypes.c_int * k)(*nargs),
                        (ctypes.c_void_p * m)(*ptrs),
                        (ctypes.c_int * m)(*counts))
        self.args = (P.data_ptr(), B, D, n, lo.data_ptr(), hi.data_ptr(),
                     self.cur.data_ptr(), self.new.data_ptr(),
                     self.old.data_ptr(), Q, len(kinds),
                     *[ctypes.addressof(a) for a in self._arrays],
                     state.data_ptr(), budget)
        self.stream = torch.cuda.current_stream(P.device).cuda_stream

    def __call__(self) -> None:
        if self.P.device.type == "cpu":
            card_round_plain(self.P, self.lo, self.hi, self.cur, self.new,
                             self.old, self.n, self.plan, self.state,
                             self.budget)
            return
        lib = _lib()
        with torch.cuda.device(self.P.device):
            rc = lib.sheep_routed_round(*self.args, self.stream)
        if rc != 0:
            raise RuntimeError("routed round launch failed: "
                               + lib.sheep_routed_error_string(rc).decode())
        for key, count in self.launches.items():
            LAUNCHES[key] += count
