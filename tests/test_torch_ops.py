"""Each op of the port's build path against its JAX counterpart, on the
same numpy inputs made from fixed seeds, at n = 2^10..2^12. Every
comparison is exact: the ops move and compare integers only, and the
fixpoint round is the same integer program in both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.backends.tpu_backend import pad_chunk
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import elim as jelim
from sheep_tpu.ops import order as jorder
from sheep_tpu.ops import score as jscore
from sheep_tpu_torch.ops import degrees, elim, order, score

CPU = torch.device("cpu")


def _edges(n, m, seed, loops=True):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    if loops:
        e[:7, 1] = e[:7, 0]  # a few self-loops
    return e


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_order(e, n):
    deg = jdeg.degree_chunk(jdeg.init_degrees(n),
                            pad_chunk(e, len(e) + 100, n), n)
    return jorder.elimination_order(deg, n)


@pytest.mark.parametrize("n,seed", [(1 << 10, 0), (1 << 12, 1)])
def test_degree_chunk(n, seed):
    e = _edges(n, 6 * n, seed)
    padded = pad_chunk(e, len(e) + 333, n)
    ref = np.asarray(jdeg.degree_chunk(jdeg.init_degrees(n), padded, n))
    got = degrees.degree_chunk(degrees.init_degrees(n, CPU), _t(padded), n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_elimination_order_ties():
    n = 1 << 11
    deg = np.random.default_rng(2).integers(0, 9, size=n + 1)
    pos_j, order_j = jorder.elimination_order(jnp.asarray(deg, jnp.int32), n)
    pos, ordr = order.elimination_order(_t(deg.astype(np.int64)), n)
    assert np.array_equal(pos.numpy(), np.asarray(pos_j))
    assert np.array_equal(ordr.numpy(), np.asarray(order_j))


def test_elimination_order_past_int32():
    """Totals past int32: the reference sorts their stable ranks
    (rank_clip_i32); the port sorts the int64 totals. Same order."""
    n = 1 << 10
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 5, size=n).astype(np.int64)
    deg[rng.choice(n, 40, replace=False)] = (1 << 33) + rng.integers(0, 3, 40)
    ranks = jdeg.rank_clip_i32(deg)
    pos_j, order_j = jorder.elimination_order(jnp.asarray(ranks, jnp.int32),
                                              n)
    pos, ordr = order.elimination_order(_t(deg), n)
    assert np.array_equal(pos.numpy(), np.asarray(pos_j))
    assert np.array_equal(ordr.numpy(), np.asarray(order_j))


def test_pow2_at_least():
    for x in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1):
        for floor in (1, 1 << 10):
            assert elim.pow2_at_least(x, floor) == \
                jelim.pow2_at_least(x, floor)


def test_orient_edges_pos():
    n = 1 << 10
    e = _edges(n, 4000, 4)
    pos_j, _ = _jax_order(e, n)
    padded = pad_chunk(e, 4096, n)
    lo_j, hi_j = jelim.orient_edges_pos(jnp.asarray(padded), pos_j, n)
    lo, hi = elim.orient_edges_pos(_t(padded), _t(pos_j), n)
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(hi.numpy(), np.asarray(hi_j))
    blocks = np.stack([padded, np.full_like(padded, n), padded[::-1]])
    loB_j, hiB_j = jelim.orient_chunks_batch_pos(jnp.asarray(blocks), pos_j, n)
    loB, hiB = elim.orient_chunks_batch_pos(_t(blocks), _t(pos_j), n)
    assert np.array_equal(loB.numpy(), np.asarray(loB_j))
    assert np.array_equal(hiB.numpy(), np.asarray(hiB_j))


def _round_state(n, seed):
    """A mid-build state: P after folding part of the edges, plus the
    oriented actives of fresh edges."""
    e = _edges(n, 6 * n, seed)
    pos_j, _ = _jax_order(e, n)
    first = pad_chunk(e[: 3 * n], 3 * n, n)
    lo, hi = jelim.orient_edges_pos(jnp.asarray(first), pos_j, n)
    P, _ = jelim.fold_segments_batch(jnp.full(n + 1, n, jnp.int32),
                                     lo[None], hi[None], n)
    rest = pad_chunk(e[3 * n:], 3 * n + 64, n)
    lo, hi = jelim.orient_edges_pos(jnp.asarray(rest), pos_j, n)
    return np.asarray(P), np.asarray(lo), np.asarray(hi)


@pytest.mark.parametrize("budget", [None, 1 << 10])
def test_round_body_exact_and_stream(monkeypatch, budget):
    n = 1 << 11
    if budget is not None:
        # forces the stream descent in both packages
        monkeypatch.setattr(jelim, "EXACT_TABLE_BYTES", budget)
        monkeypatch.setattr(elim, "EXACT_TABLE_BYTES", budget)
    L_j, descent_j = jelim._resolve(n, 0, "auto")
    L, descent = elim._resolve(n, 0, "auto")
    assert (L, descent) == (L_j, descent_j)
    assert descent == ("exact" if budget is None else "stream")
    P, lo, hi = _round_state(n, 5)
    for _ in range(3):  # three consecutive rounds
        jb = jelim._pos_round_body(n, L, descent)
        lo_j, hi_j, P_j, ch_j, _ = jb((jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(P), jnp.asarray(True),
                                       jnp.asarray(0, jnp.int32)))
        lo2, hi2, P2, ch = elim._pos_round_body(n, L, descent)(
            _t(lo), _t(hi), _t(P).clone())
        assert np.array_equal(lo2.numpy(), np.asarray(lo_j))
        assert np.array_equal(hi2.numpy(), np.asarray(hi_j))
        assert np.array_equal(P2.numpy(), np.asarray(P_j))
        assert bool(ch) == bool(ch_j)
        P, lo, hi = P2.numpy(), lo2.numpy(), hi2.numpy()


def _blocks(n, seed, N, C):
    e = jgen.rmat(int(np.log2(n)), 6, seed=seed)
    pos_j, order_j = _jax_order(e, n)
    chunks = [pad_chunk(e[off:off + C], C, n) for off in range(0, len(e), C)]
    chunks = chunks[:N] + [np.full((C, 2), n, np.int32)] * max(0, N - len(chunks))
    loB, hiB = jelim.orient_chunks_batch_pos(jnp.asarray(np.stack(chunks)),
                                             pos_j, n)
    return np.asarray(loB), np.asarray(hiB), pos_j, e


@pytest.mark.parametrize("batch_rounds", [0, 5])
def test_batch_segment_fixpoint(batch_rounds):
    n, N, C = 1 << 12, 3, 1 << 13
    loB, hiB, _, _ = _blocks(n, 6, N, C)
    P0 = np.full(n + 1, n, np.int32)
    loB_j, hiB_j, P_j, sv_j = jelim.fold_segments_batch_pos(
        jnp.asarray(P0), jnp.asarray(loB), jnp.asarray(hiB), n,
        batch_rounds=batch_rounds)
    loB2, hiB2, P2, sv = elim.batch_segment_fixpoint(
        _t(P0), _t(loB), _t(hiB), n, batch_rounds=batch_rounds)
    assert np.array_equal(sv.numpy(), np.asarray(sv_j))
    assert np.array_equal(P2.numpy(), np.asarray(P_j))
    assert np.array_equal(loB2.numpy(), np.asarray(loB_j))
    assert np.array_equal(hiB2.numpy(), np.asarray(hiB_j))
    # the execution reads nothing back (sv stays where P is); the pipeline
    # reads one stats word per confirmed execution, as the reference
    assert sv.device == P2.device
    stats = {}
    elim.fold_segments_pipelined(
        _t(P0), iter([(_t(loB), _t(hiB))]), n, batch_rounds=batch_rounds,
        stats=stats)
    assert stats["host_syncs"] == stats["batch_execs"]


def test_fold_segments_pipelined_depth1():
    """Groups whose round budget runs out are re-queued until they drain:
    same table and round count as the reference at inflight=1."""
    n, C = 1 << 11, 1 << 11
    e = jgen.rmat(11, 8, seed=9)
    pos_j, _ = _jax_order(e, n)
    chunks = [pad_chunk(e[off:off + C], C, n) for off in range(0, len(e), C)]
    groups = [np.stack(chunks[i:i + 2]) for i in range(0, len(chunks), 2)]
    staged_j = [jelim.orient_chunks_batch_pos(jnp.asarray(g), pos_j, n)
                for g in groups]
    P_j, r_j = jelim.fold_segments_pipelined(
        jnp.full(n + 1, n, jnp.int32), iter(staged_j), n, inflight=1,
        donate=False, segment_rounds=1)
    staged = [(_t(lo), _t(hi)) for lo, hi in staged_j]
    stats = {}
    P, r = elim.fold_segments_pipelined(
        torch.full((n + 1,), n, dtype=torch.int32), iter(staged), n,
        segment_rounds=1, stats=stats)
    assert r == int(r_j) and stats["device_rounds"] == r
    assert stats["batch_execs"] > len(groups)  # leftovers were re-queued
    assert np.array_equal(P.numpy(), np.asarray(P_j))


def test_minp_to_parent():
    n = 1 << 10
    loB, hiB, pos_j, e = _blocks(n, 7, 1, 6 * n)
    _, order_j = _jax_order(e, n)
    P, _ = jelim.fold_segments_batch(jnp.full(n + 1, n, jnp.int32),
                                     jnp.asarray(loB), jnp.asarray(hiB), n)
    minp = P[pos_j]
    ref = jelim.minp_to_parent(minp, order_j, n)
    got = elim.minp_to_parent(_t(np.asarray(minp)), _t(np.asarray(order_j)),
                              n)
    assert np.array_equal(got, ref)
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("k", [2, 64])
def test_score_chunk_and_cv_keys(monkeypatch, k):
    n = 1 << 11
    e = _edges(n, 5000, 8)
    padded = pad_chunk(e, 5120, n)
    assign = np.random.default_rng(k).integers(0, k, size=n + 1,
                                               dtype=np.int32)
    assign[n] = 0
    cut_j, tot_j = jscore.score_chunk(jnp.asarray(padded),
                                      jnp.asarray(assign), n)
    cut, tot = score.score_chunk(_t(padded), _t(assign), n)
    assert (int(cut), int(tot)) == (int(cut_j), int(tot_j))
    keys_j = jscore.cut_pair_keys_host(jnp.asarray(padded),
                                       jnp.asarray(assign), n, k)
    keys = score.cut_pair_keys(_t(padded), _t(assign), n, k)
    assert np.array_equal(keys.numpy(), np.unique(keys_j))
    acc = []
    score.accumulate_cv_keys(acc, keys)
    score.accumulate_cv_keys(acc, keys[::2])
    assert len(acc) == 2
    monkeypatch.setattr(score, "CV_COMPACT_ENTRIES", 1)
    score.accumulate_cv_keys(acc, keys[1::3])
    assert len(acc) == 1  # compacted
    assert score.comm_volume(acc) == len(np.unique(keys_j))
