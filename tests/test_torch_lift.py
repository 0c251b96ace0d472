"""The lifting stack and the fused climb of the port's exact-descent round
(sheep_tpu_torch/ops/lift.py) against the JAX package's round
(``_pos_round_body``) and lifting tables (``build_lift_tables``), on the
same numpy inputs made from fixed seeds, at n = 2^10..2^13. Everything is
integer, so every comparison is exact. The depth cut climbs fewer levels
than the reference and must give its outputs bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import elim as jelim
from sheep_tpu_torch.ops import elim, fixpoint, lift
from sheep_tpu_torch.ops.gather import gather_clip_plain

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _forest(n, rng, span=50, roots=0.1):
    """A position-space forest: P[p] in (p, n], P[n] = n."""
    p = np.arange(n, dtype=np.int64)
    P = np.minimum(p + 1 + rng.geometric(1 / span, n) - 1, n)
    P[rng.random(n) < roots] = n
    return np.append(P, n).astype(np.int32)


def _path(n, length):
    """A chain through the first ``length`` positions, the rest roots."""
    P = np.full(n + 1, n, np.int32)
    P[:length - 1] = np.arange(1, length, dtype=np.int32)
    return P


def _slots(n, C, rng, dead=0.1, top=None):
    """C slots (lo, hi), lo < hi < top (default n), a share of them dead
    (n, n)."""
    top = n if top is None else top
    lo = rng.integers(0, top - 1, C)
    hi = lo + 1 + (rng.random(C) * (top - 1 - lo)).astype(np.int64)
    off = rng.random(C) < dead
    lo[off] = hi[off] = n
    return lo.astype(np.int32), hi.astype(np.int32)


def _state(kind, n, seed):
    rng = np.random.default_rng(seed)
    C = 2 * n
    if kind == "random":
        return (_forest(n, rng),) + _slots(n, C, rng)
    if kind == "deep-chain":  # a path: d = L, no level is cut
        return (_path(n, n),) + _slots(n, C, rng)
    if kind == "half-chain":  # a path over half the positions: d = L - 1
        # slots inside the chain: the scatter leaves it as it is
        return (_path(n, n // 2),) + _slots(n, C, rng, top=n // 2)
    if kind == "all-dead":
        full = np.full(C, n, np.int32)
        return _forest(n, rng), full, full.copy()
    if kind == "duplicates-retire":  # one constraint C times at a root
        P = _forest(n, rng)
        P[7] = n
        return P, np.full(C, 7, np.int32), np.full(C, 300, np.int32)
    if kind == "displace":  # (a, b) under an older parent c > b: (b, c)
        P = _forest(n, rng)
        lo, hi = _slots(n, C, rng)
        lo[lo == 5] = hi[lo == 5] = n  # no other constraint at 5
        P[5], lo[:3], hi[:3] = 900, 5, 40
        return P, lo, hi
    raise ValueError(kind)


def _scatter(P, lo, hi, n):
    """The round up to the climb: (old_at_lo, P after the scatter-min)."""
    old = gather_clip_plain(P, lo)
    P = P.clone()
    P.scatter_reduce_(0, lo.long(), hi, reduce="amin", include_self=True)
    return old, P


def _depth_ok(tables, P, d, L):
    """Every JAX level at or above d equals level d - 1."""
    levels = [np.asarray(P)] + [np.asarray(t) for t in tables]
    assert len(levels) == L
    for k in range(d, L):
        assert np.array_equal(levels[k], levels[d - 1])
    if d >= 2:  # and d counts distinct levels
        assert not np.array_equal(levels[d - 1], levels[d - 2])


KINDS = ["random", "deep-chain", "half-chain", "all-dead",
         "duplicates-retire", "displace"]


@pytest.mark.parametrize("n", [1 << 10, 1 << 13])
@pytest.mark.parametrize("kind", KINDS)
def test_rounds_match_jax(kind, n):
    """Three consecutive rounds: lift_stack_plain against
    build_lift_tables, climb_tail_plain with the cut against the JAX round
    (lo, hi, P, changed) and its retired count, and the wrappers' CPU
    path against the plain versions."""
    P, lo, hi = _state(kind, n, seed=n + len(kind))
    L, descent = jelim._resolve(n, 0, "exact")
    assert descent == "exact"
    body = jelim._pos_round_body(n, L, "exact")
    stack = lift.new_stack(n + 1, L, CPU)
    ctl = lift.new_ctl(CPU)
    depths = []
    for _ in range(3):
        lo_j, hi_j, P_j, ch_j, _ = body((jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(P), jnp.asarray(True),
                                         jnp.asarray(0, jnp.int32)))
        old, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
        assert np.array_equal(P2.numpy(), np.asarray(P_j))

        st, d = lift.lift_stack_plain(P2, L)
        tables = jelim.build_lift_tables(jnp.asarray(P2.numpy()), n, L)
        for k in range(1, d):
            assert np.array_equal(st[k - 1].numpy(), np.asarray(tables[k - 1]))
        _depth_ok(tables, P2.numpy(), d, L)
        depths.append(d)

        out_lo, out_hi, ch, ret, live = lift.climb_tail_plain(
            _t(lo), _t(hi), old, P2, st, d)
        assert np.array_equal(out_lo.numpy(), np.asarray(lo_j))
        assert np.array_equal(out_hi.numpy(), np.asarray(hi_j))
        assert bool(ch) == bool(ch_j)
        lo_np = np.asarray(lo)
        assert int(ret) == int(np.sum((np.asarray(lo_j) == n) & (lo_np != n)))
        assert int(live) == int(np.sum(lo_np != n))

        lift.lift_stack(P2, stack, ctl)  # the wrappers on the CPU
        assert int(ctl[lift.ROWS]) == d - 1
        assert torch.equal(stack[:d - 1, :n + 1], st[:d - 1])
        w_lo, w_hi = lift.climb_tail(_t(lo), _t(hi), old, P2, stack, ctl)
        assert torch.equal(w_lo, out_lo) and torch.equal(w_hi, out_hi)
        assert ctl[lift.CHANGED:].tolist() == [int(ch), int(ret), int(live),
                                               0]

        P, lo, hi = P2.numpy(), out_lo.numpy(), out_hi.numpy()
    if kind == "deep-chain":
        assert depths[0] == L
    if kind == "half-chain":
        assert depths[0] == L - 1
    if kind == "all-dead":
        assert not bool(ch)


def test_special_states_do_what_they_say():
    n = 1 << 10
    P, lo, hi = _state("duplicates-retire", n, 1)
    old, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
    st, d = lift.lift_stack_plain(P2, 11)
    out_lo, out_hi, ch, ret, live = lift.climb_tail_plain(
        _t(lo), _t(hi), old, P2, st, d)
    assert bool(ch) and int(ret) == int(live) == len(lo)
    assert (out_lo == n).all() and (out_hi == n).all()

    P, lo, hi = _state("displace", n, 2)
    old, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
    assert int(P2[5]) == 40 and int(old[0]) == 900
    st, d = lift.lift_stack_plain(P2, 11)
    out_lo, out_hi, _, _, _ = lift.climb_tail_plain(_t(lo), _t(hi), old, P2,
                                                    st, d)
    assert out_lo[:3].tolist() == [40] * 3 and out_hi[:3].tolist() == [900] * 3


def test_single_level_and_roots_only():
    """A forest of roots is idempotent: d = 1 and the stack is not read."""
    n = 1 << 10
    P = torch.full((n + 1,), n, dtype=torch.int32)
    st, d = lift.lift_stack_plain(P, 11)
    assert d == 1
    stack, ctl = lift.new_stack(n + 1, 11, CPU), lift.new_ctl(CPU)
    lift.lift_stack(P, stack, ctl)
    assert int(ctl[lift.ROWS]) == 0
    one = lift.new_stack(n + 1, 1, CPU)
    assert one.shape[0] == 0
    lift.lift_stack(P, one, ctl)
    assert int(ctl[lift.ROWS]) == 0


def _args():
    n = 64
    P = torch.full((n + 1,), n, dtype=torch.int32)
    v = torch.full((16,), n, dtype=torch.int32)
    return P, lift.new_stack(n + 1, 7, CPU), lift.new_ctl(CPU), v


def test_wrappers_reject_bad_inputs():
    P, stack, ctl, v = _args()
    with pytest.raises(TypeError, match="int32"):
        lift.lift_stack(P.long(), stack, ctl)
    with pytest.raises(TypeError, match="int32"):
        lift.climb_tail(v.long(), v, v, P, stack, ctl)
    with pytest.raises(TypeError, match="int32"):
        lift.lift_stack(P, stack.long(), ctl)
    with pytest.raises(ValueError, match="1-D"):
        lift.climb_tail(v, v.reshape(4, 4), v, P, stack, ctl)
    with pytest.raises(ValueError, match="1-D"):
        lift.lift_stack(P.reshape(5, 13), stack, ctl)
    with pytest.raises(ValueError, match="2-D"):
        lift.lift_stack(P, stack[0], ctl)
    with pytest.raises(ValueError, match="contiguous"):
        lift.climb_tail(v, v, torch.zeros(32, dtype=torch.int32)[::2], P,
                        stack, ctl)
    with pytest.raises(ValueError, match="length"):
        lift.climb_tail(v, v[:8], v, P, stack, ctl)
    with pytest.raises(ValueError, match="fit"):
        lift.lift_stack(P, lift.new_stack(200, 7, CPU), ctl)
    with pytest.raises(ValueError, match=f"{lift.CTL_WORDS} entries"):
        lift.lift_stack(P, stack, ctl[:3])


def test_wrappers_reject_other_devices():
    """A tensor off the CPU and CUDA, or on another device than P, never
    reaches the plain version or a kernel."""
    P, stack, ctl, v = _args()
    meta = [t.to("meta") for t in (P, stack, ctl, v)]
    n0 = dict(lift.LAUNCHES)
    with pytest.raises(ValueError, match="device"):
        lift.lift_stack(*meta[:3])
    with pytest.raises(ValueError, match="device"):
        lift.climb_tail(meta[3], meta[3], meta[3], *meta[:3])
    with pytest.raises(ValueError, match="tensors on"):
        lift.climb_tail(v, v, v, P, stack, meta[2])
    assert lift.LAUNCHES == n0


def test_cpu_path_counts_no_launch():
    P, stack, ctl, v = _args()
    n0 = dict(lift.LAUNCHES)
    lift.lift_stack(P, stack, ctl)
    lift.climb_tail(v, v, v, P, stack, ctl)
    assert lift.LAUNCHES == n0


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the lift kernels have "
                    "no CPU mode")
    n = (1 << 16) + 3
    rng = np.random.default_rng(5)
    P, lo, hi = _forest(n, rng), *_slots(n, 3 * n + 1, rng)
    old, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
    L = n.bit_length()
    dev = torch.device("cuda")
    Pc, loc, hic, oldc = (t.to(dev) for t in (P2, _t(lo), _t(hi), old))
    stack = lift.new_stack(n + 1, L, dev)
    ctl = lift.new_ctl(dev)
    lift.lift_stack(Pc, stack, ctl)  # builds the library, allocates
    torch.cuda.synchronize()
    n0 = dict(lift.LAUNCHES)
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        lift.lift_stack(Pc, stack, ctl)
        torch.cuda.synchronize()
    # one kernel a ladder, no memset
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1 and "lift_ladder" in device[0], device
    out_lo, out_hi = lift.climb_tail(loc, hic, oldc, Pc, stack, ctl)
    torch.cuda.synchronize()
    assert lift.LAUNCHES["lift_stack"] == n0["lift_stack"] + 1
    assert lift.LAUNCHES["climb_tail"] == n0["climb_tail"] + 1
    st, d = lift.lift_stack_plain(Pc, L)
    assert int(ctl[lift.ROWS]) == d - 1
    assert torch.equal(stack[:d - 1, :n + 1], st[:d - 1])
    p_lo, p_hi, ch, ret, live = lift.climb_tail_plain(loc, hic, oldc, Pc, st,
                                                      d)
    assert torch.equal(out_lo, p_lo) and torch.equal(out_hi, p_hi)
    assert ctl[lift.CHANGED:].tolist() == [int(ch), int(ret), int(live),
                                               0]


def test_ctl_adds_until_lift_stack_zeroes_it():
    """climb_tail adds each pass's counts to the control word, as the
    kernel's atomics do; lift_stack starts the next round from zero."""
    n = 1 << 10
    P, lo, hi = _state("random", n, seed=3)
    old, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
    stack, ctl = lift.new_stack(n + 1, 11, CPU), lift.new_ctl(CPU)
    lift.lift_stack(P2, stack, ctl)
    rows = int(ctl[lift.ROWS])
    lift.climb_tail(_t(lo), _t(hi), old, P2, stack, ctl)
    once = ctl.tolist()
    assert once[lift.CHANGED] == 1 and once[lift.LIVE] > 0
    lift.climb_tail(_t(lo), _t(hi), old, P2, stack, ctl)
    assert ctl.tolist() == [rows, 1, 2 * once[lift.RETIRED],
                            2 * once[lift.LIVE], 0]
    lift.lift_stack(P2, stack, ctl)
    assert ctl.tolist() == [rows, 0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [4, 60])
def test_fused_round_end_matches_plain_on_card(budget):
    """climb_rows on the card ends the round in climb_tail's last block.
    Rounds of an execution over three rows of slots, whose budget runs out
    mid-execution (4) or leaves no-op rounds (60): after every round the
    table, the blocks, every word of the state and the control word equal
    the CPU's (the plain climb, then ``round_end_plain``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the lift kernels have "
                    "no CPU mode")
    n, C = (1 << 12) + 3, 3000
    rng = np.random.default_rng(budget)
    rows = [_slots(n, C, rng, dead) for dead in (0.5, 0.9, 1.0)]
    L = n.bit_length()
    runs = []
    for dev in (CPU, torch.device("cuda")):
        runs.append((elim._pos_round_body(n, L, "exact"),
                     torch.full((n + 1,), n, dtype=torch.int32, device=dev),
                     _t(np.stack([lo for lo, _ in rows])).to(dev),
                     _t(np.stack([hi for _, hi in rows])).to(dev),
                     fixpoint.new_state(budget, dev)))
    for _ in range(budget):
        for body, P, loB, hiB, state in runs:
            body(loB, hiB, P, state, budget)
        torch.cuda.synchronize()
        (cb, *cpu), (gb, *gpu) = runs
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(gb.ctl.cpu(), cb.ctl)
    state = runs[0][4]
    rows_done, rounds = int(state[fixpoint.ROW]), int(state[fixpoint.ROUNDS])
    if budget == 4:
        assert rows_done < 3 and rounds == 4  # the budget ran out
    else:
        assert rows_done == 3 and rounds < 60  # no-op rounds after the last
