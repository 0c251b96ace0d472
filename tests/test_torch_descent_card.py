"""The stream descent's kernel (``lift.stream_descent``,
``sheep_tpu_torch/csrc/lift.cu``) against its plain version on the card,
at every depth of levels, share of live slots and shape of forest that
tests/test_torch_descent.py holds the plain version to against the JAX
package; and the inputs both files make. This file imports no JAX, so
that it runs on a machine with the card: ``python -m pytest
tests/test_torch_descent_card.py -m cuda``. Here it skips."""

import numpy as np
import pytest
import torch

from sheep_tpu_torch.ops import lift

SIZES = [1 << 6, 1 << 9, 1 << 12]
SHARES = [1.0, 0.2, "one"]
FORESTS = ["random", "chain", "shallow"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _levels(L, n):
    return n.bit_length() if L == "bits" else L


def _forest(kind, n, rng):
    """A position-space table P[p] in (p, n], P[n] = n: ``random``
    (parents a geometric step ahead, 10% roots), ``chain`` (P[p] = p + 1:
    no level below 2^j >= n is all n), ``shallow`` (paths of three edges,
    so that t_2, the fourth ancestors, is all n)."""
    p = np.arange(n, dtype=np.int64)
    if kind == "random":
        P = np.minimum(p + rng.geometric(1 / 8, n), n)
        P[rng.random(n) < 0.1] = n
    elif kind == "chain":
        P = p + 1
    else:
        P = np.where(p % 4 == 3, n, np.minimum(p + 1, n))
    return np.append(P, n).astype(np.int32)


def _slots(n, C, rng, share):
    """C slots (lo, hi), lo < hi <= n at the live ones, the others (n, n);
    ``share`` the live fraction, or "one" for a single live slot."""
    lo = rng.integers(0, n - 1, C)
    hi = lo + 1 + (rng.random(C) * (n - 1 - lo)).astype(np.int64)
    if share == "one":
        dead = np.arange(C) != C // 3
    else:
        dead = rng.random(C) >= share
    lo[dead] = hi[dead] = n
    return lo.astype(np.int32), hi.astype(np.int32)


def _case(n, L, share, kind, salt):
    rng = np.random.default_rng([n, salt, len(str(L)), SHARES.index(share),
                                 FORESTS.index(kind)])
    P = _forest(kind, n, rng)
    lo, hi = _slots(n, 3 * n, rng, share)
    return P, lo, hi, _levels(L, n)


@pytest.mark.cuda
def test_descent_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the stream descent has "
                    "no CPU mode")
    dev = torch.device("cuda")
    for kind in FORESTS:
        for share in SHARES:
            for L in (1, 2, 8, "bits"):
                n = 1 << 12
                P, lo, hi, L = _case(n, L, share, kind, 1)
                want = lift.stream_descent_plain(_t(P), _t(lo), _t(hi), L)
                scratch = lift.new_descent(n + 1, len(lo), L, dev)
                ctl = _t([9, 9, 9, 9, 9]).to(dev)
                launches = lift.LAUNCHES["stream_descent"]
                pre = lift.stream_descent(_t(P).to(dev), _t(lo).to(dev),
                                          _t(hi).to(dev), L, scratch, ctl)
                torch.cuda.synchronize()
                live = torch.from_numpy(lo != n)
                assert torch.equal(pre.cpu()[live], want[live])
                assert ctl.tolist() == [L - 1, 0, 0, 0, 0]
                assert lift.LAUNCHES["stream_descent"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch_rounds", [5, 300])
def test_stream_execution_matches_cpu_on_card(batch_rounds):
    """A whole execution on the stream descent over [3, 2^12] blocks of an
    R-MAT graph (the port's generator, order and orientation): table,
    blocks, sv and every word of the state on the card equal the CPU's,
    one ``stream_descent`` launch a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the stream descent has "
                    "no CPU mode")
    from sheep_tpu_torch.io import generators
    from sheep_tpu_torch.ops import degrees, elim, fixpoint, order

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    scale, N, C = 12, 3, 1 << 12
    n = 1 << scale
    e = torch.from_numpy(generators.rmat_hash_range(scale, 0, N * C,
                                                    seed=6)).int()
    deg = degrees.init_degrees(n, cpu)
    degrees.degree_chunk(deg, e, n)
    pos, _ = order.elimination_order(deg, n)
    loB, hiB = elim.orient_chunks_batch_pos(e.reshape(N, C, 2), pos, n)
    runs = []
    for d in (cpu, dev):
        state = fixpoint.new_state(batch_rounds, d)
        launches = lift.LAUNCHES["stream_descent"]
        out = elim.batch_segment_fixpoint(
            torch.full((n + 1,), n, dtype=torch.int32, device=d),
            loB.clone().to(d), hiB.clone().to(d), n, descent="stream",
            batch_rounds=batch_rounds, state=state)
        runs.append([t.cpu() for t in (*out, state)])
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert lift.LAUNCHES["stream_descent"] == launches + batch_rounds
    for a, b in zip(*runs):
        assert torch.equal(a, b)
