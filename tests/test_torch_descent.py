"""The stream descent (``lift.stream_descent`` and its plain version,
``sheep_tpu_torch/ops/lift.py``) against the JAX package's stream round
(``sheep_tpu/ops/elim.py`` ``_pos_round_body(..., "stream")``), on the
same numpy inputs made from fixed seeds: the climbed positions against
the reference's level loop, and the whole round (K1, ``scatter_min``,
the descent, ``climb_tail``) against the reference's round body, at every
depth of levels, share of live slots and shape of forest. Everything is
integer, so every comparison is exact. The CPU runs the plain version;
the kernel is held to it on the card (``chip_smoke.py`` phase 3d, and
tests/test_torch_descent_card.py, which makes these inputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import elim as jelim
from sheep_tpu_torch.ops import elim, fixpoint, lift

from test_torch_descent_card import (FORESTS, SHARES, SIZES, _case, _forest,
                                     _slots, _t)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops a case: one torch thread beside the other workers
    of a parallel run (see tests/test_torch_fixpoint.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_loop(P, lo, hi, L):
    """The reference's stream loop (sheep_tpu/ops/elim.py:166-171) on
    cpu-jax: the climbed positions of every slot."""
    t, cur, h = jnp.asarray(P), jnp.asarray(lo), jnp.asarray(hi)
    for j in range(L):
        cand = t[cur]
        cur = jnp.where(cand < h, cand, cur)
        if j < L - 1:
            t = t[t]
    return np.asarray(cur)


@pytest.mark.parametrize("kind", FORESTS)
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("L", [1, 2, 8, "bits"])
@pytest.mark.parametrize("n", SIZES)
def test_descent_matches_reference_loop(n, L, share, kind):
    """The plain version and the wrapper on the CPU against the
    reference's loop: every slot (the wrapper's ``pre`` at the live ones),
    and ``ctl`` = [L - 1, 0, 0, 0, 0] after the call."""
    P, lo, hi, L = _case(n, L, share, kind, 1)
    want = _reference_loop(P, lo, hi, L)
    got = lift.stream_descent_plain(_t(P), _t(lo), _t(hi), L)
    assert np.array_equal(got.numpy(), want)
    ctl = _t([9, 9, 9, 9, 9])
    pre = lift.stream_descent(_t(P), _t(lo), _t(hi), L,
                              lift.new_descent(n + 1, len(lo), L, CPU), ctl)
    live = lo != n
    assert np.array_equal(pre.numpy()[live], want[live])
    assert ctl.tolist() == [L - 1, 0, 0, 0, 0]


def _jax_round(P, lo, hi, n, L):
    body = jelim._pos_round_body(n, L, "stream")
    out = body((jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(P),
                jnp.asarray(True), jnp.asarray(0, dtype=jnp.int32)))
    return [np.asarray(x) for x in out[:4]]


@pytest.mark.parametrize("kind", FORESTS)
@pytest.mark.parametrize("share", [1.0, 0.2])
@pytest.mark.parametrize("L", [1, 2, 8, "bits"])
@pytest.mark.parametrize("n", SIZES)
def test_stream_round_matches_jax(n, L, share, kind):
    """One free-standing stream round (K1, ``scatter_min``, the descent,
    ``climb_tail``) against the reference's round body: slots, table and
    ``changed``."""
    P, lo, hi, L = _case(n, L, share, kind, 2)
    want = _jax_round(P, lo, hi, n, L)
    body = elim._pos_round_body(n, L, "stream")
    out_lo, out_hi, P2, changed = body(_t(lo), _t(hi), _t(P))
    for a, b in zip((out_lo, out_hi, P2), want):
        assert np.array_equal(a.numpy(), b)
    assert bool(changed) == bool(want[3])
    assert body.ctl[lift.ROWS] == L - 1


@pytest.mark.parametrize("row", [0, 1, 2])
def test_descent_reads_the_execution_row(row):
    """With an execution state, [N, C] blocks are read at its row; the
    round on that row equals the reference's round on it, and the other
    rows are not touched."""
    n, L = 1 << 10, 11
    rng = np.random.default_rng(40 + row)
    P = _forest("random", n, rng)
    rows_ = [_slots(n, 2048, rng, share) for share in (1.0, 0.2, "one")]
    loB = _t(np.stack([lo for lo, _ in rows_]))
    hiB = _t(np.stack([hi for _, hi in rows_]))
    state = fixpoint.new_state(4, CPU)
    state[fixpoint.ROW] = row
    ctl = _t([3, 1, 4, 1, 5])
    pre = lift.stream_descent(_t(P), loB, hiB, L,
                              lift.new_descent(n + 1, 2048, L, CPU), ctl,
                              state)
    lo, hi = rows_[row]
    want = _reference_loop(P, lo, hi, L)
    live = lo != n
    assert np.array_equal(pre.numpy()[live], want[live])
    assert ctl.tolist() == [L - 1, 0, 0, 0, 0]

    before = (loB.clone(), hiB.clone())
    body = elim._pos_round_body(n, L, "stream")
    Pt = _t(P)
    body(loB, hiB, Pt, state, 4)
    w_lo, w_hi, w_P, _ = _jax_round(P, lo, hi, n, L)
    assert np.array_equal(loB[row].numpy(), w_lo)
    assert np.array_equal(hiB[row].numpy(), w_hi)
    assert np.array_equal(Pt.numpy(), w_P)
    for r in range(3):
        if r != row:
            assert torch.equal(loB[r], before[0][r])
            assert torch.equal(hiB[r], before[1][r])


def test_stopped_descent_touches_nothing():
    """Once the execution has stopped the descent writes nothing: not
    ``pre``, not its scratch, not ``ctl``."""
    n, L = 1 << 8, 9
    rng = np.random.default_rng(5)
    P = _forest("chain", n, rng)
    lo, hi = _slots(n, 512, rng, 1.0)
    state = fixpoint.new_state(2, CPU)
    state[fixpoint.STOP] = 1
    scratch = lift.new_descent(n + 1, 512, L, CPU)
    for t in scratch:
        t.fill_(7)
    ctl = _t([3, 1, 4, 1, 5])
    lift.stream_descent(_t(P), _t(lo)[None], _t(hi)[None], L, scratch, ctl,
                        state)
    for t in scratch:
        assert (t == 7).all()
    assert ctl.tolist() == [3, 1, 4, 1, 5]


@pytest.mark.parametrize("L", [1, 2, 23])
def test_descent_buffers(L):
    """``new_descent``: pre of C slots, two squaring rows of the stack's
    stride (none at one level), one mask word for 32 slots."""
    pre, rows, mask = lift.new_descent(1001, 100, L, CPU)
    assert pre.shape == (100,) and mask.shape == (4,)
    assert rows.shape == ((2 if L > 1 else 0), lift.row_stride(1001))
    assert {t.dtype for t in (pre, rows, mask)} == {torch.int32}


def test_descent_rejects_bad_inputs():
    n = 8
    P = torch.full((n + 1,), n, dtype=torch.int32)
    lo = torch.full((40,), n, dtype=torch.int32)
    ctl = lift.new_ctl(CPU)
    s = lift.new_descent(n + 1, 40, 3, CPU)
    with pytest.raises(ValueError, match="levels"):
        lift.stream_descent(P, lo, lo, 0, s, ctl)
    with pytest.raises(ValueError, match="levels"):
        lift.stream_descent(P, lo, lo, 33, s, ctl)
    with pytest.raises(ValueError, match="pre must hold 40"):
        lift.stream_descent(P, lo, lo, 3, s._replace(pre=s.pre[:39]), ctl)
    with pytest.raises(ValueError, match="mask must hold 2"):
        lift.stream_descent(P, lo, lo, 3, s._replace(mask=s.mask[:1]), ctl)
    with pytest.raises(ValueError, match="rows"):
        lift.stream_descent(P, lo, lo, 3, s._replace(rows=s.rows[:1]), ctl)
    with pytest.raises(ValueError, match="rows"):
        lift.stream_descent(P, lo, lo, 1, s, ctl)
    with pytest.raises(TypeError, match="int32"):
        lift.stream_descent(P, lo.long(), lo, 3, s, ctl)
    with pytest.raises(ValueError, match="block"):
        lift.stream_descent(P, lo, lo, 3, s, ctl, fixpoint.new_state(1, CPU))


def test_chase_on_the_cpu():
    """The chain yardstick's CPU path: ``steps`` dependent loads, and
    nothing written with none."""
    t = _t([1, 2, 3, 0])
    out = _t([-1])
    lift.chase(t, 0, 0, out)
    assert out.tolist() == [-1]
    lift.chase(t, 0, 6, out)
    assert out.tolist() == [2]
