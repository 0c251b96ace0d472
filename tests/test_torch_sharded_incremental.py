"""Incremental epochs on the port's sharded backend (``torch-sharded``:
``_fold_delta`` through the per-shard machinery, ``_move_rescore`` over
the shards) at ``device="cpu"`` on 8 virtual shards, against the JAX
package's ``tpu-sharded`` at the cases of
``tests/test_incremental_multidevice.py``, with zero tolerance:

- two add epochs equal the one-shot ``delta:`` build and the reference's
  resident state, table, scores and fold counters;
- deletes with a full compaction equal a clean rebuild of the survivors;
- a scored epoch rescores over the shards (``score_distributed``) under
  ``SHEEP_SCORE_AUDIT=1``, as the reference's, equal to the host scorer;
- a small epoch's counters sit ten times below the base build's;
- a ``delta:`` log over a device-synthesized base stages no host bytes;
- ``move_rescore_sharded`` against the reference's on random moves.
"""

import numpy as np
import pytest
import torch

import jax

from sheep_tpu import incremental as jinc
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.ops import score as jscore
from sheep_tpu.parallel import mesh as jmesh

from sheep_tpu_torch import incremental as inc
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.backends.torch_sharded_backend import \
    TorchShardedBackend
from sheep_tpu_torch.io import deltalog as dl
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.io.devicestream import is_device_stream
from sheep_tpu_torch.ops import score
from sheep_tpu_torch.parallel import mesh

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

N = 512
FOLD_KEYS = ("update_folds", "device_rounds", "host_syncs", "folded_bytes",
             "merge_payload_bytes", "merge_mode", "score_full",
             "score_incremental", "score_distributed")


@pytest.fixture(autouse=True, scope="module")
def _eight_shards():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh.force_cpu_devices(8)
    yield
    mesh.force_cpu_devices(1)
    torch.set_num_threads(threads)


def _graph(m=4000, n=N, seed=5):
    return np.random.default_rng(seed).integers(0, n, (m, 2)).astype(
        np.int64)


def _base_file(tmp_path, edges, name="base.bin64"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(np.asarray(edges, np.int64).astype("<u8").tobytes())
    return p


def _port(cs):
    return TorchShardedBackend(chunk_edges=cs, device="cpu")


def _jax(cs):
    return get_backend("tpu-sharded", chunk_edges=cs)


def _same_stats(got: dict, want: dict):
    for key in FOLD_KEYS:
        assert got.get(key) == want.get(key), key


def test_two_epochs_equal_one_shot_and_reference(tmp_path):
    e = _graph()
    half = len(e) // 2
    base = _base_file(tmp_path, e[:half])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[half: half + 1000])
        w.append(e[half + 1000:])
    be = _port(4096)
    one = be.partition(edgestream.open_input(f"delta:{log}", n_vertices=N),
                       8, comm_volume=False)
    state, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=N), 8, backend=be)
    assert be.partition_update(state, adds=e[half: half + 1000],
                               score=False) is None
    r2 = be.partition_update(state, adds=e[half + 1000:], score=True)
    assert state.epoch == 2 and state.stats["update_folds"] == 2
    assert np.array_equal(r2.assignment, one.assignment)
    assert (r2.edge_cut, r2.total_edges) == (one.edge_cut, one.total_edges)
    jbe = _jax(4096)
    jstate, _ = jinc.begin_incremental(
        jes.open_input(base, n_vertices=N), 8, backend=jbe)
    jbe.partition_update(jstate, adds=e[half: half + 1000], score=False)
    j2 = jbe.partition_update(jstate, adds=e[half + 1000:], score=True)
    assert np.array_equal(state.minp, jstate.minp)
    assert np.array_equal(r2.assignment, j2.assignment)
    assert (r2.edge_cut, r2.total_edges, r2.balance) == \
        (j2.edge_cut, j2.total_edges, j2.balance)
    _same_stats(state.stats, jstate.stats)
    # the single-device port's fold lands on the same table
    sbe = TorchBackend(chunk_edges=4096, device="cpu")
    sstate, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=N), 8, backend=sbe)
    sbe.partition_update(sstate, adds=e[half:], score=False)
    assert np.array_equal(state.minp, sstate.minp)


def test_delete_full_compact_matches_clean_rebuild(tmp_path):
    e = _graph()
    base = _base_file(tmp_path, e[:2000])
    be = _port(4096)
    state, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=N), 8, backend=be)
    be.partition_update(state, adds=e[2000:], score=False)
    dels = e[np.random.default_rng(9).permutation(len(e))[:600]]
    r_stale = be.partition_update(state, deletes=dels, score=True,
                                  compact="never")
    assert state.stale_deletes == 600
    assert inc.compact_state(be, state, mode="full") == "full"
    assert state.stale_deletes == 0
    r = inc.refresh(be, state)
    surv = np.concatenate(list(dl.filter_tombstones([e], dels)))
    clean = TorchBackend(chunk_edges=777, device="cpu").partition(
        edgestream.EdgeStream.from_array(surv, n_vertices=N), 8,
        comm_volume=False)
    assert np.array_equal(r.assignment, clean.assignment)
    assert (r.edge_cut, r.total_edges) == (clean.edge_cut,
                                           clean.total_edges)
    assert r_stale.total_edges == clean.total_edges


def test_distributed_rescore_fires_and_survives_audit(tmp_path,
                                                      monkeypatch):
    """A sparse graph whose epochs move labels: the scored refresh takes
    the sharded rescore under the full-pass audit, as the reference's, and
    lands the host scorer's cut."""
    monkeypatch.setenv("SHEEP_SCORE_AUDIT", "1")
    n = 2048
    e = np.random.default_rng(15).integers(0, n, (13000, 2)).astype(
        np.int64)
    base = _base_file(tmp_path, e[:6000])
    be = _port(8192)
    state, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=n), 4, backend=be)
    r1 = be.partition_update(state, adds=e[6000:10000], score=True)
    r2 = be.partition_update(state, adds=e[10000:], score=True)
    assert state.stats["score_full"] >= 1
    assert state.stats["score_distributed"] >= 1
    jbe = _jax(8192)
    js, _ = jinc.begin_incremental(jes.open_input(base, n_vertices=n), 4,
                                   backend=jbe)
    j1 = jbe.partition_update(js, adds=e[6000:10000], score=True)
    j2 = jbe.partition_update(js, adds=e[10000:], score=True)
    assert (r1.edge_cut, r2.edge_cut) == (j1.edge_cut, j2.edge_cut)
    assert np.array_equal(r2.assignment, j2.assignment)
    _same_stats(state.stats, js.stats)
    host = TorchBackend(chunk_edges=2048, device="cpu")
    hs, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=n), 4, backend=host)
    host.partition_update(hs, adds=e[6000:10000], score=True)
    h2 = host.partition_update(hs, adds=e[10000:], score=True)
    assert hs.stats.get("score_distributed", 0) == 0
    assert r2.edge_cut == h2.edge_cut


def test_small_delta_epoch_is_ten_x_below_full_rebuild(tmp_path):
    """The counters of folding and scoring a small epoch on a resident
    sharded partition (``device_rounds``, ``host_syncs``,
    ``folded_bytes``) sit ten times below the base build's, and the epoch
    lands the single-device one-shot build of the ``delta:`` log."""
    n, m, dm = 1024, 200_000, 128
    rng = np.random.default_rng(11)
    e = rng.integers(0, n, (m + dm, 2)).astype(np.int64)
    base = _base_file(tmp_path, e[:m])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[m:])
    be = _port(1024)
    state, built = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=n), 8, backend=be)
    keys = ("device_rounds", "host_syncs", "folded_bytes")
    before = {k: state.stats.get(k, 0) for k in keys}
    r = be.partition_update(state, adds=e[m:], score=True)
    cost = {k: state.stats.get(k, 0) - before[k] for k in keys}
    for k in keys:
        assert cost[k] > 0, k
        assert 10 * cost[k] <= built.diagnostics[k], k
    one = TorchBackend(chunk_edges=1 << 16, device="cpu").partition(
        edgestream.open_input(f"delta:{log}", n_vertices=n), 8,
        comm_volume=False)
    assert np.array_equal(r.assignment, one.assignment)
    assert r.edge_cut == one.edge_cut


def test_delta_anchor_over_device_stream_base(tmp_path):
    """A ``delta:`` log over an ``rmat-hash`` base keeps synthesizing the
    anchor pass's chunks on the shards, and builds the reference's
    partition."""
    spec = "rmat-hash:9:4:1"
    with edgestream.open_input(spec) as s:
        n = s.num_vertices
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=spec) as w:
        w.append(_graph(300, n=n, seed=3))
    st = edgestream.open_input(f"delta:{log}")
    assert is_device_stream(st.anchor_stream())
    got = _port(1024).partition(st, 8, comm_volume=False)
    assert got.diagnostics["device_stream_chunks"] > 0
    assert got.diagnostics["h2d_staged_bytes"] == 0
    want = _jax(1024).partition(jes.open_input(f"delta:{log}"), 8,
                                comm_volume=False)
    assert np.array_equal(got.assignment, want.assignment)
    assert got.edge_cut == want.edge_cut
    for key in ("device_stream_chunks", "device_rounds", "host_syncs"):
        assert got.diagnostics[key] == want.diagnostics[key], key


@pytest.mark.parametrize("d", [3, 8])
def test_move_rescore_sharded_matches_reference(d):
    """Random moves on several ks: the per-k cut deltas of the shards'
    partial sums, reduced once, equal the reference's."""
    rng = np.random.default_rng(d)
    n, arcs = 700, 5000
    src = rng.integers(0, n, arcs)
    dst = rng.integers(0, n, arcs)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    prevs, news, masks = {}, {}, {}
    for k in (2, 8, 64):
        prev = rng.integers(0, k, n).astype(np.int32)
        new = prev.copy()
        moved = rng.random(n) < 0.1
        new[moved] = rng.integers(0, k, int(moved.sum()))
        prevs[k], news[k], masks[k] = prev, new, prev != new
    want = jscore.move_rescore_sharded(src, dst, prevs, news, masks,
                                       jmesh.shards_mesh(d))
    got = score.move_rescore_sharded(src, dst, prevs, news, masks,
                                     mesh.shards_mesh(d, device="cpu"))
    assert got == want
