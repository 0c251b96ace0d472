"""The port's refinement (``sheep_tpu_torch/ops/refine.py``) against the JAX
package's, exactly, on the CPU: the histogram, its row statistics and the
move planners on the same arrays (ties across 32-wide strides at k = 1, 3,
7, 64 and 257, where the kernels' lanes a row and tiles branch; a block
of one row), ``refine_assignment`` in its full, blocked, host-planned and
weighted modes with the spool and its cleanup, ``partition(refine=...)``
and ``refine_result``, and the streams' ``num_edges_cheap``.

The histogram's plain version, like its kernel, drops invalid edges where
the reference adds them to the sentinel row (the row of vertex n), which
nothing reads; so histograms are compared on the rows of vertices [0, n).
The kernels themselves run on the card only (``cuda``-marked test)."""

import glob
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sheep_tpu
import sheep_tpu_torch
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import refine as jref
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import refine
from sheep_tpu_torch.tools import kernel_cases


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk(rng, n, C):
    """A (C, 2) int32 chunk with self-loops, ends out of range and
    sentinel padding at the end."""
    e = rng.integers(0, n, (C, 2)).astype(np.int32)
    loops = rng.random(C) < 0.05
    e[loops, 1] = e[loops, 0]
    e[rng.random(C) < 0.02, 0] = n + 3
    e[rng.random(C) < 0.02, 1] = -1
    e[-C // 8:] = n
    return e


@pytest.mark.parametrize("k", [1, 3, 7, 64, 257])
def test_neighbor_hist_chunk_matches_jax(k):
    rng = np.random.default_rng(k)
    n, C = 1500, 4096
    assign = rng.integers(0, k, n + 1).astype(np.int32)
    hist_j = jnp.zeros((n + 1, k), jnp.int32)
    hist = torch.zeros((n + 1, k), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int64)
    cut_j = total_j = 0
    for _ in range(3):
        chunk = _chunk(rng, n, C)
        hist_j, c, t = jref.neighbor_hist_chunk(
            hist_j, jnp.asarray(chunk), jnp.asarray(assign), n, k)
        cut_j += int(c)
        total_j += int(t)
        refine.neighbor_hist_chunk(hist, _t(chunk), _t(assign), n, k,
                                   counts)
    assert np.array_equal(hist.numpy()[:n], np.asarray(hist_j)[:n])
    assert counts.tolist() == [cut_j, total_j]
    # the dropped edges: the reference's sentinel row holds them, the
    # port's stays empty
    assert int(np.asarray(hist_j)[n].sum()) > 0
    assert int(hist[n].sum()) == 0


@pytest.mark.parametrize("base,vb", [(0, 512), (512, 512), (1024, 700),
                                     (777, 1)])
def test_neighbor_hist_block_matches_jax(base, vb):
    rng = np.random.default_rng(base + vb)
    n, k, C = 1500, 64, 4096
    assign = rng.integers(0, k, n + 1).astype(np.int32)
    hist_j = jnp.zeros((vb + 1, k), jnp.int32)
    hist = torch.zeros((vb, k), dtype=torch.int32)
    for _ in range(2):
        chunk = _chunk(rng, n, C)
        hist_j = jref.neighbor_hist_block(
            hist_j, jnp.asarray(chunk), jnp.asarray(assign),
            jnp.int32(base), n, k, vb)
        refine.neighbor_hist_block(hist, _t(chunk), _t(assign), base, n, k,
                                   vb)
    rows = min(vb, n - base)  # the rows of vertices below n
    assert np.array_equal(hist.numpy()[:rows], np.asarray(hist_j)[:rows])


@pytest.mark.parametrize("k", [1, 3, 7, 64, 257])
def test_hist_stats_matches_jax_with_ties(k):
    rng = np.random.default_rng(100 + k)
    rows = 3000
    hist = rng.integers(0, 3, (rows, k)).astype(np.int32)
    hist[::5] = 0  # all-zero rows: best 0, gain 0
    # ties across lanes and across 32-wide strides: the first column wins
    hist[1::7, k - 1] = 9
    hist[1::7, (k - 1) // 2] = 9
    hist[2::9, min(31, k - 1)] = 8
    hist[2::9, k - 1] = 8
    hist[3::11, 0] = 7
    hist[3::11, k - 1] = 7
    cur = rng.integers(0, k, rows).astype(np.int32)
    want = [np.asarray(x) for x in jref.hist_stats(jnp.asarray(hist),
                                                   jnp.asarray(cur))]
    best, bestv, cur_got, gain = refine.hist_stats(_t(hist), _t(cur))
    assert np.array_equal(best.numpy(), want[0])
    assert np.array_equal(bestv.numpy(), want[1])
    assert np.array_equal(cur_got.numpy(), want[2])
    assert np.array_equal(gain.numpy(), want[1] - want[2])


_plan_inputs = kernel_cases.plan_inputs
PLAN_EDGES = dict(kernel_cases.plan_edge_cases())


@pytest.mark.parametrize("k", [7, 64, 257])
@pytest.mark.parametrize("parity", [0, 1])
def test_plan_moves_matches_jax(k, parity):
    n, assign, best, gain, cap = _plan_inputs(k, k + parity)
    want = np.asarray(jref.plan_moves(
        jnp.asarray(best), jnp.asarray(gain), jnp.asarray(assign),
        jnp.int32(cap), parity, n, k))
    got = refine.plan_moves(_t(best), _t(gain), _t(assign), cap, parity, n,
                            k).numpy()
    assert np.array_equal(got, want)
    assert (got != assign).any()
    host = refine.plan_moves_host(best, gain, assign, cap, parity, n, k)
    assert np.array_equal(host, want)
    assert np.array_equal(
        host, jref.plan_moves_host(best, gain, assign, cap, parity, n, k))


@pytest.mark.parametrize("name", sorted(PLAN_EDGES))
def test_plan_moves_cases_match_jax(name):
    """The planner's edge cases (``kernel_cases.plan_edge_cases``):
    thresholds at gains of 300 and 70,000 (past the count's bins, every
    gain digit), k = 1000 (16 bins a part) and k = 4000 (the bins in
    global memory), a part whose movers equal its head, a part with no
    room, one gain tied across many blocks of rows, k = 1, odd and even n
    at parity 1."""
    c = PLAN_EDGES[name]
    want = np.asarray(jref.plan_moves(
        jnp.asarray(c["best"]), jnp.asarray(c["gain"]),
        jnp.asarray(c["assign"]), jnp.int32(c["cap"]), c["parity"], c["n"],
        c["k"]))
    got = refine.plan_moves(_t(c["best"]), _t(c["gain"]), _t(c["assign"]),
                            c["cap"], c["parity"], c["n"], c["k"]).numpy()
    assert np.array_equal(got, want)
    assert (got != c["assign"]).any()


@pytest.mark.parametrize("k", [7, 64])
@pytest.mark.parametrize("parity", [0, 1])
def test_plan_moves_weighted_matches_jax(k, parity):
    """Integer weights whose total is below 2^24, where float32 prefix sums
    are exact in any order."""
    n, assign, best, gain, _ = _plan_inputs(k, 50 + k + parity)
    rng = np.random.default_rng(k)
    w = np.concatenate([rng.integers(1, 8, n), [0]]).astype(np.float32)
    cap = np.float32(1.10 * float(w.sum()) / k)
    want = np.asarray(jref.plan_moves_weighted(
        jnp.asarray(best), jnp.asarray(gain), jnp.asarray(assign),
        jnp.asarray(w), jnp.float32(cap), parity, n, k))
    got = refine.plan_moves_weighted(_t(best), _t(gain), _t(assign), _t(w),
                                     cap, parity, n, k).numpy()
    assert np.array_equal(got, want)
    assert (got != assign).any()
    host = refine.plan_moves_host(best, gain, assign, float(cap), parity, n,
                                  k, w=w)
    assert np.array_equal(host, jref.plan_moves_host(
        best, gain, assign, float(cap), parity, n, k, w=w))


def _both(spec_or_edges, k, tmp_path=None, **kw):
    """refine_assignment of the same unrefined partition on both
    packages: (port, reference), each (assignment, stats)."""
    if isinstance(spec_or_edges, str):
        def open_j():
            return jes.open_input(spec_or_edges)

        def open_t():
            return edgestream.open_input(spec_or_edges)
    else:
        path = str(tmp_path / "g.bin32")
        jformats.write_edges(path, spec_or_edges)

        def open_j():
            return jes.EdgeStream.open(path)

        def open_t():
            return edgestream.EdgeStream.open(path)
    with open_j() as js:
        n = js.num_vertices
        base = sheep_tpu.get_backend("cpu").partition(js, k).assignment
        w = None
        if kw.pop("degree", False):
            w = np.zeros(n, np.int64)
            for c in js.chunks(1 << 22):
                w += np.bincount(np.asarray(c).ravel(), minlength=n)[:n]
        ref = jref.refine_assignment(base, js, n, k, weights=w, **kw)
    with open_t() as ts:
        got = refine.refine_assignment(base, ts, n, k, weights=w,
                                       device="cpu", **kw)
    return got, ref


MODES = {"full": {}, "blocked": dict(budget_bytes=1 << 14, min_block=256),
         "host_plan": dict(plan_budget_bytes=1 << 12),
         "weighted": dict(degree=True),
         "weighted_host": dict(degree=True, plan_budget_bytes=1 << 12)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("spec,k", [("rmat-hash:11:8:3", 8),
                                    ("sbm-hash:11:16:0.05:16:1", 16)])
def test_refine_assignment_modes_match_jax(spec, k, mode):
    (got, gs), (ref, rs) = _both(spec, k, rounds=3, chunk_edges=1 << 13,
                                 **MODES[mode])
    assert np.array_equal(got, ref)
    assert gs == rs
    if mode == "blocked":
        assert gs["refine_hist_blocks"] > 1
    if mode.endswith("host") or mode == "host_plan":
        assert gs["refine_host_plan"] == 1
    assert gs["refine_spooled"] == 1  # a generator stream


@pytest.mark.parametrize("scale", [10, 12])
def test_refine_assignment_rmat_matches_jax(scale):
    (got, gs), (ref, rs) = _both(f"rmat-hash:{scale}:8:5", 16, rounds=4)
    assert np.array_equal(got, ref) and gs == rs


def test_refine_assignment_karate_file_matches_jax(tmp_path):
    (got, gs), (ref, rs) = _both(jgen.karate_club(), 2, tmp_path, rounds=5)
    assert np.array_equal(got, ref) and gs == rs
    assert gs["refine_spooled"] == 0  # a file is not spooled


def test_spool_is_removed_and_optional(tmp_path, monkeypatch):
    spec, k = "sbm-hash:10:8:0.05:8:2", 8
    with edgestream.open_input(spec) as ts:
        n = ts.num_vertices
        base = np.arange(n, dtype=np.int32) % k
        spooled = refine.refine_assignment(base, ts, n, k, rounds=2,
                                           device="cpu",
                                           spool_dir=str(tmp_path))
        assert os.listdir(tmp_path) == []
        direct = refine.refine_assignment(base, ts, n, k, rounds=2,
                                          device="cpu", spool=False)
        # too little free space: the stream is read direct
        monkeypatch.setattr(refine.shutil, "disk_usage",
                            lambda path: types.SimpleNamespace(free=100))
        short = refine.refine_assignment(base, ts, n, k, rounds=2,
                                         device="cpu")
    assert spooled[1]["refine_spooled"] == 1
    assert direct[1]["refine_spooled"] == short[1]["refine_spooled"] == 0
    for out in (direct, short):
        assert np.array_equal(out[0], spooled[0])
        assert {**out[1], "refine_spooled": 1} == spooled[1]


def test_spool_is_removed_when_refinement_fails(tmp_path, monkeypatch):
    def fail(assign, stream, *args):
        assert stream.fmt == "bin32" and len(os.listdir(tmp_path)) == 1
        raise RuntimeError("pass failed")

    monkeypatch.setattr(refine, "_refine_impl", fail)
    with edgestream.open_input("sbm-hash:10:8:0.05:8:2") as ts:
        with pytest.raises(RuntimeError, match="pass failed"):
            refine.refine_assignment(np.zeros(1 << 10, np.int32), ts,
                                     1 << 10, 8, device="cpu",
                                     spool_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_spool_failure_leaves_no_file(tmp_path):
    """A source stream that fails mid-spool raises its own error, and the
    partial spool file is removed."""
    class Broken:
        fmt = "generator"
        num_edges_upper_bound = 1 << 12

        def chunks(self, cs):
            yield np.zeros((8, 2), np.int64)
            raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        refine.spool_stream(Broken(), 16, spool_dir=str(tmp_path))
    assert glob.glob(str(tmp_path / "*")) == []


def test_partition_refine_matches_jax():
    spec = "sbm-hash:11:16:0.05:16:1"
    ref = sheep_tpu.partition(spec, 16, backend="cpu", refine=4)
    got = sheep_tpu_torch.partition(spec, 16, device="cpu", refine=4)
    assert np.array_equal(got.assignment, ref.assignment)
    for key in ("edge_cut", "total_edges", "comm_volume", "balance",
                "cut_ratio"):
        assert getattr(got, key) == getattr(ref, key), key
    stats = {key: v for key, v in got.diagnostics.items()
             if key.startswith("refine_")}
    assert stats == {key: v for key, v in ref.diagnostics.items()
                     if key.startswith("refine_")}
    assert stats["refine_cut_before"] == 30064
    assert stats["refine_cut_after"] == got.edge_cut == 16021
    assert (stats["refine_moves_wanted"], stats["refine_moves_applied"],
            stats["refine_spooled"]) == (5071, 1432, 1)


@pytest.mark.parametrize("comm_volume", [True, False])
def test_refine_result_degree_weights_matches_jax(comm_volume):
    spec = "rmat-hash:11:8:9"
    with jes.open_input(spec) as js:
        res_j = sheep_tpu.get_backend("cpu").partition(
            js, 8, weights="degree", comm_volume=comm_volume)
        ref = sheep_tpu.refine_result(res_j, js, rounds=3, alpha=1.2,
                                      weights="degree")
    with edgestream.open_input(spec) as ts:
        got = sheep_tpu_torch.refine_result(res_j, ts, rounds=3, alpha=1.2,
                                            weights="degree", device="cpu")
    assert np.array_equal(got.assignment, ref.assignment)
    for key in ("edge_cut", "comm_volume", "balance", "cut_ratio"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.diagnostics == ref.diagnostics


def test_refine_result_keeps_the_partition_on_value_error(monkeypatch):
    spec = "rmat-hash:10:8:1"
    res = sheep_tpu_torch.partition(spec, 4, device="cpu")

    def refuse(*args, **kw):
        raise ValueError("over budget")

    monkeypatch.setattr(refine, "refine_assignment", refuse)
    with edgestream.open_input(spec) as ts:
        out = sheep_tpu_torch.refine_result(res, ts, device="cpu")
    assert np.array_equal(out.assignment, res.assignment)
    assert out.edge_cut == res.edge_cut
    assert out.diagnostics["refine_skipped"] == "over budget"


@pytest.mark.parametrize("spec", [
    "rmat-hash:10:8:1", "sbm-hash:10:8:0.05:8:2", "rmat:10:8:3",
    "plsbm-hash:10:8:0.05:8:2", "bipartite-hash:10:4:0.02:8:2",
    "nearclique-hash:10:4:0.02:8:2"])
def test_num_edges_cheap_of_synthetic_inputs(spec):
    with jes.open_input(spec) as js, edgestream.open_input(spec) as ts:
        assert ts.num_edges_cheap == js.num_edges_cheap is not None


@pytest.mark.parametrize("fmt", ["bin32", "bin64", "edges", "edges.gz",
                                 "csr", "memory"])
def test_num_edges_cheap_of_files(tmp_path, fmt):
    from sheep_tpu.io import csr as jcsr

    edges = jgen.rmat(9, 4, seed=2)
    if fmt == "memory":
        js = jes.EdgeStream.from_array(edges)
        ts = edgestream.EdgeStream.from_array(edges)
    else:
        path = str(tmp_path / f"g.{fmt}")
        if fmt == "csr":
            jcsr.write_csr(path, jes.EdgeStream.from_array(edges), 1 << 9)
        else:
            jformats.write_edges(path, edges)
        js, ts = jes.EdgeStream.open(path), edgestream.EdgeStream.open(path)
    assert ts.num_edges_cheap == js.num_edges_cheap
    assert (ts.num_edges_cheap is None) == (fmt in ("edges", "edges.gz"))


def test_overflow_cap_splits_parts_in_the_overflow_bin():
    """Phase 3g's R-MAT planner case picks its cap with
    ``chip_smoke.overflow_cap``: at that cap, the parts it counts are
    split with their head-th mover's gain at 255 or more, and the JAX
    package's planner accepts exactly their heads."""
    import chip_smoke

    rng = np.random.default_rng(11)
    n, k, parity = 4001, 5, 0
    assign = rng.integers(0, k, n + 1).astype(np.int32)
    # no row's best is its own part, so a mover to p ends in p if accepted
    best = ((assign + rng.integers(1, k, n + 1)) % k).astype(np.int32)
    gain = rng.choice([-1, 1, 2, 300, 400, 70000], n + 1).astype(np.int32)
    cap, parts = chip_smoke.overflow_cap(_t(best), _t(gain), _t(assign),
                                         parity, n, k)
    assert parts > 0
    want = np.asarray(jref.plan_moves(
        jnp.asarray(best), jnp.asarray(gain), jnp.asarray(assign),
        jnp.int32(cap), parity, n, k))
    vid = np.arange(n + 1)
    mover = (gain > 0) & (vid < n) & (vid % 2 == parity)
    found = 0
    for p in range(k):
        head = cap - int((assign[:n] == p).sum())
        mine = np.sort(gain[mover & (best == p)])[::-1]
        if 0 < head < len(mine) and mine[head - 1] >= 255:
            found += 1
            assert int((want[mover & (best == p)] == p).sum()) == head
    assert found == parts


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the refine kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_refine_kernels_match_plain_on_card():
    """The kernels against their plain versions where their designs
    branch, the case table that phase 3g of ``chip_smoke.py`` also runs
    (``refine_edge_cases``): k = 1, 3, 7, 64, 257 (lanes a row); k =
    40,000, a row past the apply's shared-memory tile and the stats' ring;
    blocked mode at a base that does not start a bucket; row counts that
    are not a multiple of the stats' tile rows (a ragged last tile); a
    chunk of invalid edges only; a hub vertex that takes most updates; a
    histogram that starts off a 16-byte boundary. Then the planner on its
    case table (``kernel_cases.plan_cases``), each case twice with one
    scratch."""
    dev = _card()
    import chip_smoke

    assert chip_smoke.refine_edge_cases(dev) > len(kernel_cases.plan_cases())
