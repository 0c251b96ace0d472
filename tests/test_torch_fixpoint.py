"""The batched fixpoint execution's kernels (sheep_tpu_torch/ops/fixpoint.py)
and the guarded round against the JAX package: the scatter-min against
``P.at[lo].min(hi, mode="drop")``, the stream descent's climb level (a
descent of one level, ``lift.stream_descent``; tests/test_torch_descent.py
holds its deeper ones) against its ``t[cur]``/``where`` step, and whole
executions (``round_end_plain`` and
``exec_finish`` with the round's kernels) against the reference's
``fold_segments_batch_pos``, on the same numpy inputs made from fixed
seeds. Everything is integer, so every comparison is exact. The CPU runs
the plain versions with the state on the host, so these tests reach the
stop logic too: the no-op rounds, the row switch and the store-back."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.backends.tpu_backend import pad_chunk
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import elim as jelim
from sheep_tpu.ops import order as jorder
from sheep_tpu_torch.ops import elim, fixpoint, gather, lift

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These CPU runs issue many small ops, round after round; beside the
    other workers of a parallel test run, torch's intra-op threads cost
    far more than they save (a test of ~1.5 s alone took 150 s beside
    five other workers on eight cores), so the module runs on one thread
    and restores the count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _forest(n, rng):
    """A position-space forest: P[p] in (p, n], P[n] = n."""
    p = np.arange(n, dtype=np.int64)
    P = np.minimum(p + rng.geometric(1 / 50, n), n)
    P[rng.random(n) < 0.1] = n
    return np.append(P, n).astype(np.int32)


def _slots(n, C, rng, dead):
    lo = rng.integers(0, n - 1, C)
    hi = lo + 1 + (rng.random(C) * (n - 1 - lo)).astype(np.int64)
    off = rng.random(C) < dead
    lo[off] = hi[off] = n
    return lo.astype(np.int32), hi.astype(np.int32)


def _blocks(scale, seed, N, C):
    """[N, C] oriented position blocks of an R-MAT graph's first N chunks
    (sentinel rows past its end), numpy."""
    n = 1 << scale
    e = jgen.rmat(scale, 8, seed=seed)
    deg = jdeg.degree_chunk(jdeg.init_degrees(n), pad_chunk(e, len(e), n), n)
    pos, _ = jorder.elimination_order(deg, n)
    chunks = [pad_chunk(e[off:off + C], C, n) for off in range(0, len(e), C)]
    chunks = (chunks + [np.full((C, 2), n, np.int32)] * N)[:N]
    loB, hiB = jelim.orient_chunks_batch_pos(jnp.asarray(np.stack(chunks)),
                                             pos, n)
    return n, np.asarray(loB), np.asarray(hiB)


@pytest.mark.parametrize("dead", [0.0, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("n", [1 << 10, (1 << 12) + 5])
def test_scatter_min_matches_jax(n, dead):
    rng = np.random.default_rng(n + int(100 * dead))
    P = _forest(n, rng)
    lo, hi = _slots(n, 3 * n, rng, dead)
    lo[:50] = 7  # many slots on one entry
    ref = np.asarray(jnp.asarray(P).at[jnp.asarray(lo)].min(
        jnp.asarray(hi), mode="drop"))
    got = _t(P)
    fixpoint.scatter_min(got, _t(lo), _t(hi))
    assert np.array_equal(got.numpy(), ref)
    plain = _t(P)
    fixpoint.scatter_min_plain(plain, _t(lo), _t(hi))
    assert np.array_equal(plain.numpy(), ref)


def test_climb_level_matches_jax():
    """One level of the stream descent's climb: the descent at L = 1 is
    exactly the reference's ``t[cur]``/``where`` step, at every slot in
    the plain version and at the live ones in the wrapper's ``pre``."""
    n = 1 << 11
    rng = np.random.default_rng(3)
    t = _forest(n, rng)
    cur, hi = _slots(n, 3 * n, rng, 0.2)
    cand = jnp.asarray(t)[jnp.asarray(cur)]
    ref = np.asarray(jnp.where(cand < jnp.asarray(hi), cand,
                               jnp.asarray(cur)))
    got = lift.stream_descent_plain(_t(t), _t(cur), _t(hi), 1)
    assert np.array_equal(got.numpy(), ref)
    scratch = lift.new_descent(n + 1, len(cur), 1, CPU)
    ctl = lift.new_ctl(CPU)
    pre = lift.stream_descent(_t(t), _t(cur), _t(hi), 1, scratch, ctl)
    assert pre is scratch.pre
    live = cur != n
    assert np.array_equal(pre.numpy()[live], ref[live])
    assert ctl.tolist() == [0, 0, 0, 0, 0]


@pytest.mark.parametrize("descent", ["exact", "stream"])
@pytest.mark.parametrize("batch_rounds", [1, 4, 7, 0, 500])
def test_execution_matches_jax(descent, batch_rounds):
    """A whole execution: table, blocks and sv equal the reference's,
    whether the budget runs out mid-row (store-back), on a row boundary,
    or long after every row converged (no-op rounds)."""
    n, loB, hiB = _blocks(11, 4, 3, 1 << 11)
    P0 = np.full(n + 1, n, np.int32)
    loB_j, hiB_j, P_j, sv_j = jelim.fold_segments_batch_pos(
        jnp.asarray(P0), jnp.asarray(loB), jnp.asarray(hiB), n,
        descent=descent, batch_rounds=batch_rounds)
    state = fixpoint.new_state(batch_rounds or 96, CPU)
    loB2, hiB2, P2, sv = elim.batch_segment_fixpoint(
        _t(P0), _t(loB), _t(hiB), n, descent=descent,
        batch_rounds=batch_rounds, state=state)
    assert np.array_equal(sv.numpy(), np.asarray(sv_j))
    assert np.array_equal(P2.numpy(), np.asarray(P_j))
    assert np.array_equal(loB2.numpy(), np.asarray(loB_j))
    assert np.array_equal(hiB2.numpy(), np.asarray(hiB_j))
    done, rounds, _, retired = sv.tolist()
    assert state[fixpoint.ROW] == done and state[fixpoint.STOP] == 1
    assert state[fixpoint.ROUNDS] == rounds
    assert state[fixpoint.RETIRED] == retired
    log = fixpoint.round_log(state, rounds)
    assert len(log) == rounds
    assert state[fixpoint.DEPTH_SUM] == sum(d for d, _ in log)
    assert state[fixpoint.LIVE_MAX] == max(v for _, v in log)
    if batch_rounds == 500:  # every row converged well before the budget
        assert done == 3 and rounds < 500
        assert not state[fixpoint.LOG + 2 * rounds:].any()


def test_round_end_counts_switches_rows_and_stops():
    state = fixpoint.new_state(4, CPU)
    ctl = torch.tensor([5, 1, 2, 9], dtype=torch.int32)  # changed
    fixpoint.round_end_plain(ctl, state, 2, 4)
    assert state[:fixpoint.LOG].tolist() == [0, 1, 2, 6, 6, 9, 9, 0]
    ctl[:] = torch.tensor([2, 0, 1, 3], dtype=torch.int32)  # converged
    fixpoint.round_end_plain(ctl, state, 2, 4)
    assert state[:fixpoint.LOG].tolist() == [1, 2, 3, 9, 6, 12, 9, 0]
    fixpoint.round_end_plain(ctl, state, 2, 4)  # row 1 converges: i == N
    assert state[fixpoint.ROW] == 2 and state[fixpoint.STOP] == 1
    before = state.clone()
    fixpoint.round_end_plain(ctl, state, 2, 4)  # stopped: a no-op round
    assert torch.equal(state, before)
    assert fixpoint.round_log(state, 3) == [(6, 9), (3, 3), (3, 3)]
    budget = fixpoint.new_state(2, CPU)
    ctl[lift.CHANGED] = 1
    for _ in range(2):
        fixpoint.round_end_plain(ctl, budget, 5, 2)
    assert budget[fixpoint.ROW] == 0 and budget[fixpoint.STOP] == 1


def test_stopped_execution_changes_nothing():
    """Every guarded step of a round leaves the table, the blocks and the
    control word's counts as they were once the execution has stopped."""
    n, loB, hiB = _blocks(10, 2, 2, 1 << 10)
    P = _t(np.full(n + 1, n, np.int32))
    loB, hiB = _t(loB), _t(hiB)
    state = fixpoint.new_state(3, CPU)
    state[fixpoint.STOP] = 1
    before = [t.clone() for t in (P, loB, hiB, state)]
    L = n.bit_length()
    stack, ctl = lift.new_stack(n + 1, L, CPU), lift.new_ctl(CPU)
    ctl[:] = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    old = gather.gather_clip(P, loB, state)
    assert old.shape == (loB.shape[1],)
    fixpoint.scatter_min(P, loB, hiB, state)
    lift.lift_stack(P, stack, ctl, state)
    assert not ctl.any()  # the ladder's memset still runs
    ctl[:] = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    lift.climb_rows(loB, hiB, old, P, stack, ctl, state, 3)
    scratch = lift.new_descent(n + 1, loB.shape[1], 1, CPU)
    scratch.pre.fill_(7)
    lift.stream_descent(P, loB, hiB, 1, scratch, ctl, state)
    assert (scratch.pre == 7).all()
    for a, b in zip((P, loB, hiB, state), before):
        assert torch.equal(a, b)
    assert ctl.tolist() == [3, 1, 4, 1, 5]


def test_exec_finish_stores_converged_rows():
    n = 100
    rng = np.random.default_rng(8)
    loB = _t(rng.integers(0, n + 1, (4, 16)))
    hiB = _t(rng.integers(0, n + 1, (4, 16)))
    loB[3, :5] = n
    state = fixpoint.new_state(9, CPU)
    state[fixpoint.ROW], state[fixpoint.ROUNDS] = 2, 9
    state[fixpoint.RETIRED] = 11
    want_live = int((loB[2:] != n).sum())
    sv = fixpoint.exec_finish(loB, hiB, state, n)
    assert sv.dtype == torch.int32
    assert sv.tolist() == [2, 9, want_live, 11]
    assert (loB[:2] == n).all() and (hiB[:2] == n).all()


def _round_args():
    P = torch.full((9,), 8, dtype=torch.int32)
    lo = torch.full((4,), 8, dtype=torch.int32)
    return P, lo, lo.clone()


def test_wrappers_reject_bad_inputs():
    P, lo, hi = _round_args()
    state = fixpoint.new_state(2, CPU)
    with pytest.raises(TypeError, match="int32"):
        fixpoint.scatter_min(P, lo.long(), hi)
    with pytest.raises(ValueError, match="shape"):
        fixpoint.scatter_min(P, lo[None], hi[None])  # blocks need a state
    with pytest.raises(ValueError, match="differ"):
        fixpoint.scatter_min(P, lo, hi[:3])
    with pytest.raises(ValueError, match="int64"):
        fixpoint.scatter_min(P, lo[None], hi[None], state.int())
    with pytest.raises(ValueError, match="budget"):
        fixpoint.round_end_plain(lift.new_ctl(CPU), state, 1, 5)
    with pytest.raises(ValueError, match=">= 1"):
        fixpoint.round_end_plain(lift.new_ctl(CPU), state, 0, 1)
    with pytest.raises(ValueError, match="budget"):
        elim._pos_round_body(8, 4, "exact")(lo[None], hi[None], P, state)
    with pytest.raises(ValueError, match="blocks"):
        fixpoint.exec_finish(lo[None], hi[None, :3], state, 8)
    with pytest.raises(ValueError, match="pre must hold 4"):
        lift.stream_descent(P, lo, hi, 1, lift.new_descent(9, 4, 1, CPU)
                            ._replace(pre=torch.empty(3, dtype=torch.int32)),
                            lift.new_ctl(CPU))
    with pytest.raises(ValueError, match="1-D"):
        gather.gather_clip(P, lo[None])  # a block needs a state
    with pytest.raises(ValueError, match="block"):
        lift.climb_rows(lo, hi, lo, P, lift.new_stack(9, 4, CPU),
                        lift.new_ctl(CPU), state, 2)


def test_wrappers_reject_other_devices():
    P, lo, hi = _round_args()
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="tensors on"):
        fixpoint.scatter_min(P, lo.to(meta), hi)
    with pytest.raises(ValueError, match="state on"):
        fixpoint.scatter_min(P, lo[None], hi[None],
                             fixpoint.new_state(2, meta))
    with pytest.raises(ValueError, match="unsupported device"):
        lift.stream_descent(P.to(meta), lo.to(meta), hi.to(meta), 1,
                            lift.new_descent(9, 4, 1, meta),
                            lift.new_ctl(meta))


def test_cpu_path_counts_no_launch():
    fixpoint.reset_launches()
    n, loB, hiB = _blocks(9, 1, 2, 512)
    elim.batch_segment_fixpoint(_t(np.full(n + 1, n, np.int32)), _t(loB),
                                _t(hiB), n, batch_rounds=8)
    assert set(fixpoint.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the fixpoint kernels "
                    "have no CPU mode")
    dev = torch.device("cuda")
    n, loB, hiB = _blocks(12, 6, 3, 1 << 12)
    P0 = np.full(n + 1, n, np.int32)
    for batch_rounds in (5, 300):
        want = elim.batch_segment_fixpoint(_t(P0), _t(loB), _t(hiB), n,
                                           batch_rounds=batch_rounds)
        n0 = dict(fixpoint.LAUNCHES)
        climbs0 = lift.LAUNCHES["climb_tail"]
        got = elim.batch_segment_fixpoint(
            _t(P0).to(dev), _t(loB).to(dev), _t(hiB).to(dev), n,
            batch_rounds=batch_rounds)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        # the round ends in climb_tail's last block, one launch a round
        assert "round_end" not in fixpoint.LAUNCHES
        assert lift.LAUNCHES["climb_tail"] == climbs0 + batch_rounds
        assert fixpoint.LAUNCHES["exec_finish"] == n0["exec_finish"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4099, 4101, 4096])
def test_scatter_min_rows_match_plain_on_card(C):
    """scatter_min on each row of [3, C] blocks: with C not a multiple of
    4 the rows start off a 16-byte boundary (the kernel's scalar head and
    tail), against the plain version on that row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the fixpoint kernels "
                    "have no CPU mode")
    dev = torch.device("cuda")
    n = (1 << 12) + 5
    rng = np.random.default_rng(C)
    P = _forest(n, rng)
    rows = [_slots(n, C, rng, dead) for dead in (0.0, 0.5, 0.99)]
    loB = _t(np.stack([lo for lo, _ in rows])).to(dev)
    hiB = _t(np.stack([hi for _, hi in rows])).to(dev)
    loB[0, :40] = 7  # many slots on one entry, in the head and the body
    for r in range(3):
        state = fixpoint.new_state(1, dev)
        state[fixpoint.ROW] = r
        got, want = _t(P).to(dev), _t(P)
        fixpoint.scatter_min(got, loB, hiB, state)
        fixpoint.scatter_min_plain(want, loB[r].cpu(), hiB[r].cpu())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
