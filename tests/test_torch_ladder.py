"""Where the port's lifting ladder stops (``sheep_tpu_torch/ops/lift.py``
``lift_stack_plain``, the plain version of the one-launch ladder of
``csrc/lift.cu``) against the JAX package's ``build_lift_tables``, on the
same numpy inputs at n = 2^10 and 2^13: in position space the first
idempotent level of the reference's tables is its first all-n level, and
the ladder, which stops there, gives the reference's tables in rows
0 .. rows-1 and its number of distinct levels, computing no level past
the first all-n one. Everything is integer, so every comparison is
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import elim as jelim
from sheep_tpu_torch.ops import lift
from sheep_tpu_torch.ops.gather import gather_clip_plain

from test_torch_lift import KINDS, _scatter, _state, _t

CPU = torch.device("cpu")


def _levels(P, n, L):
    """The reference's levels t_0 = P .. t_{L-1} as numpy arrays."""
    tables = jelim.build_lift_tables(jnp.asarray(P), n, L)
    return [np.asarray(P)] + [np.asarray(t) for t in tables]


def _idempotent(j, t):
    return np.array_equal(t[np.clip(t, 0, len(t) - 1)], t)


def _first(pred, levels):
    return next((j for j, t in enumerate(levels) if pred(j, t)), None)


def _counted_ladder(monkeypatch, P, L):
    """lift_stack_plain with its gathers counted: (stack, d, levels
    computed)."""
    calls = []

    def counted(t, idx):
        calls.append(1)
        return gather_clip_plain(t, idx)

    monkeypatch.setattr(lift, "gather_clip_plain", counted)
    stack, d = lift.lift_stack_plain(P, L)
    return stack, d, len(calls)


@pytest.mark.parametrize("n", [1 << 10, 1 << 13])
@pytest.mark.parametrize("kind", KINDS)
def test_ladder_stops_at_first_all_n(monkeypatch, kind, n):
    P, lo, hi = _state(kind, n, seed=n + 7 * len(kind))
    _, P2 = _scatter(_t(P), _t(lo), _t(hi), n)
    L, _ = jelim._resolve(n, 0, "exact")
    levels = _levels(P2.numpy(), n, L)
    all_n = _first(lambda j, t: bool((t == n).all()), levels)
    assert _first(_idempotent, levels) == all_n  # both None, or equal
    stack, d, computed = _counted_ladder(monkeypatch, P2, L)
    rows = d - 1
    assert rows == (L - 1 if all_n is None else all_n)
    for k in range(1, d):
        assert np.array_equal(stack[k - 1].numpy(), levels[k])
    # no level past the first all-n one (P all-n: one level, which finds
    # nothing changed)
    assert computed == (L - 1 if all_n is None else max(all_n, 1))
    # the wrapper's CPU path writes the same rows and ctl
    st, ctl = lift.new_stack(n + 1, L, CPU), lift.new_ctl(CPU)
    lift.lift_stack(P2, st, ctl)
    assert ctl.tolist() == [rows, 0, 0, 0, 0]
    assert torch.equal(st[:rows, :n + 1], stack[:rows])
    if kind == "deep-chain":
        assert rows == L - 1
    if kind == "half-chain":
        assert rows == L - 2 and computed == L - 2


@pytest.mark.parametrize("table", ["identity", "cycle", "roots", "to-zero"])
def test_ladder_outside_position_space(monkeypatch, table):
    """A table outside position space stops at its first level that
    changed nothing or is all n: the rows and the depth of the
    reference's tables (to-zero: P[p] = 0, P[0] = n, whose t_1 is
    all-n)."""
    n, L = 1 << 10, 11
    p = np.arange(n + 1, dtype=np.int32)
    P = {"identity": p,
         "cycle": np.append((p[:n] + 1) % n, n).astype(np.int32),
         "roots": np.full(n + 1, n, np.int32),
         "to-zero": np.where((p == 0) | (p == n), n, 0).astype(np.int32),
         }[table]
    levels = _levels(P, n, L)
    idem = _first(_idempotent, levels)
    stack, d, computed = _counted_ladder(monkeypatch, _t(P), L)
    assert d - 1 == (L - 1 if idem is None else idem)
    for k in range(1, d):
        assert np.array_equal(stack[k - 1].numpy(), levels[k])
    want = {"identity": 1, "cycle": L - 1, "roots": 1, "to-zero": 1}
    assert computed == want[table]


def test_one_level_ladder_computes_nothing(monkeypatch):
    n = 64
    P = torch.full((n + 1,), n, dtype=torch.int32)
    stack, d, computed = _counted_ladder(monkeypatch, P, 1)
    assert stack.shape[0] == 0 and d == 1 and computed == 0


def test_copy_row_copies_a_row():
    src = torch.arange(37, dtype=torch.int32)
    dst = torch.full((64,), -1, dtype=torch.int32)
    lift.copy_row(src, dst)
    assert torch.equal(dst[:37], src) and bool((dst[37:] == -1).all())


@pytest.mark.parametrize("dst", ["short", "int64", "2-D"])
def test_copy_row_refuses_a_bad_dst(dst):
    src = torch.arange(37, dtype=torch.int32)
    bad = {"short": torch.zeros(36, dtype=torch.int32),
           "int64": torch.zeros(64, dtype=torch.int64),
           "2-D": torch.zeros((2, 64), dtype=torch.int32)}[dst]
    with pytest.raises((TypeError, ValueError)):
        lift.copy_row(src, bad)
    assert not bad.any()
