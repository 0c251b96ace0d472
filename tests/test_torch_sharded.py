"""The port's sharded build (``sheep_tpu_torch/parallel/``, backend
``torch-sharded``) at ``device="cpu"`` on 8 virtual shards, against the JAX
package's ``tpu-sharded`` on the 8-device virtual CPU mesh of
``tests/conftest.py``, with zero tolerance: the forest, assignment, edge
cut, total, comm volume and balance, and every diagnostic that is not a
time (``device_rounds``, ``host_syncs``, ``batch_execs``,
``inflight_discards``, ``merge_payload_bytes``, ``merge_mode``, ...).

- the cases of ``tests/test_parallel.py``: the tree and the scores against
  the oracle and the reference, shard counts 1, 2, 3, 5 and 8, the compact
  merge at 3, 5 and 8 shards, the dense merge, ``chunk_batches``;
- the batched dispatch at N in {1, 4} and depths 1 and 2;
- a device-synthesized ``rmat-hash`` input;
- a build killed and resumed (and a JAX build resumed by the port), an
  injected out-of-memory fault recovered in process, a stall caught by
  the watchdog, a budget that spills the residency tier;
- ``partition_multi`` at ks [2, 8, 64] against independent runs;
- the collectives against ``lax.ppermute``/``psum``/``pmax``/``pmin``
  under ``shard_map``, and the compaction's kept duplicates against
  ``compact_actives(dedup=False)``;
- the entry points and the CLI, equal to the single-device port.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sheep_tpu.backends.base import get_backend
from sheep_tpu.core import pure as jpure
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import elim as jelim
from sheep_tpu.parallel import mesh as jmesh
from sheep_tpu.parallel.pipeline import ShardedPipeline as JPipeline
from sheep_tpu.utils import fault as jfault
from sheep_tpu.utils.checkpoint import Checkpointer as JCheckpointer

import sheep_tpu_torch
from sheep_tpu_torch import cli
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.backends.torch_sharded_backend import \
    TorchShardedBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import compact
from sheep_tpu_torch.parallel import mesh
from sheep_tpu_torch.parallel.pipeline import ShardedPipeline, chunk_batches
from sheep_tpu_torch.utils import fault
from sheep_tpu_torch.utils.checkpoint import Checkpointer
from sheep_tpu_torch.utils.fault import InjectedFault

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

SCORES = ("edge_cut", "total_edges", "comm_volume", "balance")


@pytest.fixture(autouse=True, scope="module")
def _eight_shards():
    """Eight virtual CPU shards, one torch thread (small CPU builds beside
    other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh.force_cpu_devices(8)
    yield
    mesh.force_cpu_devices(1)
    torch.set_num_threads(threads)


def _cases():
    return {
        "karate": (jgen.karate_club(), 34),
        "rmat": (jgen.rmat(9, 8, seed=31), 512),
        "grid": (jgen.grid_graph(16, 16), 256),
        "path": (jgen.path_graph(200), 200),
    }


# the graphs more than one test builds, by name
_GRAPHS = {
    **{name: (lambda name=name: _cases()[name]) for name in _cases()},
    "rmat10": lambda: (jgen.rmat(10, 8, seed=3), 1 << 10),
    "random200": lambda: (jgen.random_graph(200, 2000, seed=2), 200),
}


def _deterministic(diag: dict) -> dict:
    return {k: v for k, v in diag.items()
            if not (k.startswith("t_") or k.endswith("_ms"))}


def _assert_same(res, ref):
    """Every result field and every diagnostic of the reference that is
    not a time, exactly."""
    for key in ("parent", "pos", "deg"):
        assert np.array_equal(res.tree[key], ref.tree[key]), key
    assert np.array_equal(res.assignment, ref.assignment)
    for key in SCORES:
        assert getattr(res, key) == getattr(ref, key), key
    for key, want in _deterministic(ref.diagnostics).items():
        assert res.diagnostics.get(key) == want, key


def _jax_run(e, n, k=8, cs=256, **kw):
    be = get_backend("tpu-sharded", chunk_edges=cs, **kw)
    return be.partition(jes.EdgeStream.from_array(e, n_vertices=n), k,
                        keep_tree=True)


def _port_run(e, n, k=8, cs=256, **kw):
    be = TorchShardedBackend(chunk_edges=cs, device="cpu", **kw)
    return be.partition(edgestream.EdgeStream.from_array(e, n_vertices=n),
                        k, keep_tree=True)


def _single_run(e, n, k=8, cs=256):
    return TorchBackend(chunk_edges=cs, device="cpu").partition(
        edgestream.EdgeStream.from_array(e, n_vertices=n), k,
        keep_tree=True)


_RUNS = {"jax": _jax_run, "port": _port_run, "single": _single_run}


@pytest.fixture(scope="module")
def built():
    """``built(side, graph, **options)``: the build of a named graph by
    the reference (``"jax"``), the sharded port (``"port"``) or the
    single-device port (``"single"``), made once for the module and
    shared by the tests that compare the same build."""
    memo = {}

    def get(side, graph, **kw):
        key = (side, graph, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = _RUNS[side](*_GRAPHS[graph](), **kw)
        return memo[key]

    return get


def _pair(e, n, **kw):
    ref = _jax_run(e, n, **kw)
    res = _port_run(e, n, **kw)
    _assert_same(res, ref)
    return res, ref


def _built_pair(built, graph, **kw):
    ref = built("jax", graph, **kw)
    res = built("port", graph, **kw)
    _assert_same(res, ref)
    return res, ref


def _oracle_parent(e, n):
    return jpure.build_elim_tree(
        e, jpure.elimination_order(jpure.degrees(e, n))).parent


@pytest.mark.parametrize("name", list(_cases()))
def test_tree_and_scores_match_oracle_and_reference(name, built):
    e, n = _cases()[name]
    res, _ = _built_pair(built, name, n_devices=8)
    assert np.array_equal(res.tree["parent"], _oracle_parent(e, n))
    ref = jpure.partition_arrays(e, 8, n=n)
    assert (res.edge_cut, res.total_edges) == (ref.edge_cut,
                                               ref.total_edges)
    assert np.array_equal(res.assignment, ref.assignment)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_shard_count_invariance(d, built):
    """The same forest on any mesh, powers of two or not, and the
    reference's counters at each; equal to the single-device port."""
    e, n = _cases()["rmat"]
    res, _ = _built_pair(built, "rmat", n_devices=d)
    assert np.array_equal(res.tree["parent"], _oracle_parent(e, n))
    single = built("single", "rmat")
    assert np.array_equal(res.tree["parent"], single.tree["parent"])
    assert np.array_equal(res.assignment, single.assignment)


@pytest.mark.parametrize("d", [3, 5, 8])
def test_compact_merge_sparse_shards(d):
    """Sparse forests ship boundary pairs; out-of-range partners of 3 and
    5 shards stay inert; the payload is far below the dense table's."""
    n = 1 << 14
    e = jgen.random_graph(n, 1500, seed=41)
    res, _ = _pair(e, n, n_devices=d)
    assert np.array_equal(res.tree["parent"], _oracle_parent(e, n))
    assert res.diagnostics["merge_mode"] == "compact"
    rounds = max(1, int(np.ceil(np.log2(d))))
    assert res.diagnostics["merge_payload_bytes"] < \
        rounds * d * 4 * (n + 1) / 3


def test_dense_merge_when_occupancy_high(built):
    n = _cases()["rmat"][1]
    res = built("port", "rmat", n_devices=8)
    assert res.diagnostics["merge_mode"] == "dense"
    assert res.diagnostics["merge_payload_bytes"] == 3 * 8 * 4 * (n + 1)


def test_chunk_batches_cover_stream():
    e = jgen.rmat(8, 8, seed=34)
    n = 256
    es = edgestream.EdgeStream.from_array(e, n_vertices=n)
    seen = 0
    for batch, filled in chunk_batches(es, 100, 8, n):
        assert batch.shape == (8, 100, 2)
        seen += int(((batch[:, :, 0] != n) | (batch[:, :, 1] != n)).sum())
    assert seen == len(e)
    # a worker's share (shard 1 of 2) is the reference's, batch for batch
    from sheep_tpu.parallel.pipeline import chunk_batches as jchunk_batches

    jes_ = jes.EdgeStream.from_array(e, n_vertices=n)
    got = list(chunk_batches(es, 100, 8, n, shard=1, num_shards=2))
    ref = list(jchunk_batches(jes_, 100, 8, n, shard=1, num_shards=2))
    assert len(got) == len(ref) > 0
    for (b, f), (rb, rf) in zip(got, ref):
        assert f == rf and np.array_equal(b, rb)


@pytest.mark.parametrize("nb,depth", [(1, 2), (4, 1), (4, 2)])
def test_batched_dispatch_matches(nb, depth):
    """The batched fold (pmin'd done, pmax'd rounds and live, psum'd
    retires; speculation and discards at depth 2): every counter as the
    reference's, the forest as the per-segment run's."""
    e = jgen.rmat(11, 8, seed=9)
    n = 1 << 11
    res, ref = _pair(e, n, cs=256, dispatch_batch=nb, inflight=depth)
    assert res.diagnostics["dispatch_batch"] == nb
    assert res.diagnostics["inflight_depth"] == depth
    assert res.diagnostics["batch_execs"] == res.diagnostics["host_syncs"]
    assert np.array_equal(res.tree["parent"], _oracle_parent(e, n))


def test_device_synthesized_input_matches():
    """An ``rmat-hash`` input synthesizes its chunks on each shard
    (``device_stream_chunks``, no staged bytes), as the reference's."""
    spec = "rmat-hash:12:8:5"
    with jes.open_input(spec) as s:
        ref = get_backend("tpu-sharded", chunk_edges=2048).partition(
            s, 8, keep_tree=True)
    with edgestream.open_input(spec) as s:
        res = TorchShardedBackend(chunk_edges=2048, device="cpu").partition(
            s, 8, keep_tree=True)
    _assert_same(res, ref)
    assert res.diagnostics["device_stream_chunks"] > 0
    assert res.diagnostics["h2d_staged_bytes"] == 0


@pytest.mark.parametrize("phase,nb", [("build", 1), ("build", 2),
                                      ("score", 1)])
def test_kill_and_resume_matches_uninterrupted(tmp_path, monkeypatch, phase,
                                               nb, built):
    e, n = _GRAPHS["rmat10"]()
    expect = built("port", "rmat10", k=4, dispatch_batch=nb)
    ck = Checkpointer(str(tmp_path), every=8)
    monkeypatch.setenv(fault.ENV_VAR, f"{phase}:2")
    fault.reset()
    with pytest.raises(InjectedFault):
        TorchShardedBackend(chunk_edges=256, device="cpu",
                            dispatch_batch=nb).partition(
            edgestream.EdgeStream.from_array(e, n_vertices=n), 4,
            checkpointer=ck)
    monkeypatch.delenv(fault.ENV_VAR)
    assert ck.load() is not None
    res = TorchShardedBackend(chunk_edges=256, device="cpu",
                              dispatch_batch=nb).partition(
        edgestream.EdgeStream.from_array(e, n_vertices=n), 4,
        checkpointer=ck, resume=True)
    assert np.array_equal(res.assignment, expect.assignment)
    for key in SCORES:
        assert getattr(res, key) == getattr(expect, key), key
    assert ck.load() is None


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, built):
    """The checkpoint's format and fingerprint are the reference's: a
    ``tpu-sharded`` build killed mid-stream finishes in the port."""
    e, n = _GRAPHS["rmat10"]()
    expect = built("port", "rmat10", k=4, dispatch_batch=1)
    ck = JCheckpointer(str(tmp_path), every=8)
    monkeypatch.setenv(jfault.ENV_VAR, "build:2")
    jfault.reset()
    with pytest.raises(jfault.InjectedFault):
        get_backend("tpu-sharded", chunk_edges=256).partition(
            jes.EdgeStream.from_array(e, n_vertices=n), 4, checkpointer=ck)
    monkeypatch.delenv(jfault.ENV_VAR)
    assert ck.load().phase == "build"
    res = TorchShardedBackend(chunk_edges=256, device="cpu").partition(
        edgestream.EdgeStream.from_array(e, n_vertices=n), 4,
        checkpointer=Checkpointer(str(tmp_path), every=8), resume=True)
    assert np.array_equal(res.assignment, expect.assignment)
    assert (res.edge_cut, res.comm_volume) == (expect.edge_cut,
                                               expect.comm_volume)


def test_oom_retry_degrades_as_the_reference(monkeypatch, built):
    """An injected out-of-memory fault at the second dispatch: the build
    degrades and folds again from its snapshot, bit-identical, with the
    reference's retry and degrade counters."""
    e, n = _GRAPHS["random200"]()
    clean = built("port", "random200", k=4)
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.0")
    out = {}
    for name, run in (("jax", _jax_run), ("port", _port_run)):
        monkeypatch.setenv(fault.ENV_VAR, "oom@dispatch:2")
        jfault.reset()
        fault.reset()
        out[name] = run(e, 200, k=4, dispatch_batch=2, inflight=2)
        monkeypatch.delenv(fault.ENV_VAR)
    _assert_same(out["port"], out["jax"])
    assert out["port"].diagnostics["dispatch_retries"] >= 1
    assert np.array_equal(out["port"].assignment, clean.assignment)


def test_entry_points_refuse_what_the_sharded_build_lacks():
    """``round_log``, a staging ring and ``cache_chunks=False`` raise with
    ``backend="torch-sharded"``, as the CLI refuses their flags."""
    spec = "rmat-hash:8:4:1"
    kw = dict(device="cpu", backend="torch-sharded")
    with pytest.raises(ValueError, match="round_log"):
        sheep_tpu_torch.partition(spec, 4, round_log=[], **kw)
    with pytest.raises(ValueError, match="h2d_ring"):
        sheep_tpu_torch.partition(spec, 4, h2d_ring=2, **kw)
    with pytest.raises(ValueError, match="h2d_ring"):
        sheep_tpu_torch.partition_multi(spec, [2, 4], h2d_ring=2, **kw)
    with pytest.raises(ValueError, match="cache_chunks"):
        sheep_tpu_torch.partition(spec, 4, cache_chunks=False, **kw)
    assert sheep_tpu_torch.partition(spec, 4, cache_chunks=True,
                                     **kw).k == 4


def test_device_loss_probes_every_device_of_the_mesh(monkeypatch, built):
    """An injected device loss at the second dispatch: the build saves its
    snapshot, probes every distinct device of the mesh once and folds
    again, bit-identical to a clean build; the probe fails when any one
    device does not answer."""
    from sheep_tpu_torch.utils import retry

    probed = []
    probe = retry.reinit_devices

    def record(device=None):
        probed.append(list(device))
        return probe(device)

    monkeypatch.setattr(retry, "reinit_devices", record)
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.0")
    monkeypatch.setenv(fault.ENV_VAR, "device@dispatch:2")
    fault.reset()
    res = _port_run(*_GRAPHS["random200"](), k=4, dispatch_batch=2,
                    inflight=2)
    monkeypatch.delenv(fault.ENV_VAR)
    assert res.diagnostics["device_loss_recoveries"] == 1
    assert probed == [mesh.shards_mesh(device="cpu").distinct()]
    clean = built("port", "random200", k=4)
    assert np.array_equal(res.assignment, clean.assignment)
    for key in SCORES:
        assert getattr(res, key) == getattr(clean, key), key
    assert probe([torch.device("cpu"), torch.device("cpu")])
    assert not probe([torch.device("cpu"), torch.device("meta")])


def test_watchdog_interrupts_a_stalled_build(monkeypatch):
    """``SHEEP_PEER_TIMEOUT_S``: a stalled batch is interrupted (the
    monitor thread stops with the loop)."""
    from sheep_tpu_torch.utils import watchdog

    e, n = _cases()["rmat"]
    monkeypatch.setenv(watchdog.ENV_TIMEOUT, "0.2")
    monkeypatch.setattr(fault, "STALL_S", 1.0)
    monkeypatch.setenv(fault.ENV_VAR, "stall@build:1")
    fault.reset()
    with pytest.raises(KeyboardInterrupt):
        _port_run(e, n)
    monkeypatch.delenv(fault.ENV_VAR)
    monkeypatch.setenv(watchdog.ENV_TIMEOUT, "600")
    with watchdog.watched(1, "on") as wd:
        assert isinstance(wd, watchdog.StallWatchdog)
    assert wd._thread is None
    monkeypatch.delenv(watchdog.ENV_TIMEOUT)
    with watchdog.watched(1, "off") as wd:
        assert wd is watchdog.NULL_WATCHDOG


def test_residency_budget_spills_as_the_reference(monkeypatch, built):
    """``SHEEP_CACHE_BYTES`` keeps the build's batches on the shards for
    the score pass (``residency.manager_from_env``); a tiny budget spills,
    with the reference's counters, and the same result."""
    e, n = _GRAPHS["rmat10"]()
    clean = built("port", "rmat10", k=4, dispatch_batch=1)
    monkeypatch.setenv("SHEEP_CACHE_BYTES", "40000")
    res, _ = _pair(e, n, k=4)
    assert res.diagnostics["spill_evictions"] > 0
    assert 0 < res.diagnostics["spill_resident_bytes"] <= 40000
    assert np.array_equal(res.assignment, clean.assignment)


def test_partition_multi_matches_independent_runs():
    e = jgen.rmat(10, 8, seed=6)
    n = 1 << 10
    ks = [2, 8, 64]
    be = TorchShardedBackend(chunk_edges=1024, device="cpu")
    multi = be.partition_multi(
        edgestream.EdgeStream.from_array(e, n_vertices=n), ks)
    jmulti = get_backend("tpu-sharded", chunk_edges=1024).partition_multi(
        jes.EdgeStream.from_array(e, n_vertices=n), ks)
    assert [r.k for r in multi] == ks
    for r, j in zip(multi, jmulti):
        single = TorchShardedBackend(chunk_edges=1024,
                                     device="cpu").partition(
            edgestream.EdgeStream.from_array(e, n_vertices=n), r.k)
        assert np.array_equal(r.assignment, single.assignment)
        assert np.array_equal(r.assignment, j.assignment)
        for key in SCORES:
            assert getattr(r, key) == getattr(single, key), key
            assert getattr(r, key) == getattr(j, key), key


@pytest.mark.parametrize("d", [3, 8])
def test_collectives_match_lax(d):
    """``ppermute`` (a shard without partner gets zeros), ``psum``,
    ``pmax`` and ``pmin`` of per-shard vectors, against the lax
    collectives under ``shard_map`` on the same data."""
    from jax import lax

    rng = np.random.default_rng(d)
    x = rng.integers(-50, 50, (d, 3)).astype(np.int32)
    m = jmesh.shards_mesh(d)
    P = jax.sharding.PartitionSpec
    spec = dict(mesh=m, in_specs=(P(jmesh.SHARD_AXIS),),
                out_specs=P(jmesh.SHARD_AXIS))
    xs = [torch.from_numpy(row.copy()) for row in x]
    for r in range(max(1, int(np.ceil(np.log2(d))))):
        perm = [(i, i ^ (1 << r)) for i in range(d) if (i ^ (1 << r)) < d]
        want = np.asarray(jax.jit(jmesh.shard_map(
            lambda v, perm=perm: lax.ppermute(v, jmesh.SHARD_AXIS, perm),
            **spec))(jnp.asarray(x)))
        got = np.stack([t.numpy() for t in mesh.ppermute(xs, perm)])
        assert np.array_equal(got, want), r
    for op, lop in ((mesh.psum, lax.psum), (mesh.pmax, lax.pmax),
                    (mesh.pmin, lax.pmin)):
        want = np.asarray(jax.jit(jmesh.shard_map(
            lambda v, lop=lop: lop(v, jmesh.SHARD_AXIS), **spec))(
                jnp.asarray(x)))
        got = np.stack([t.numpy() for t in op(xs)])
        assert np.array_equal(got, want), op.__name__


def test_compaction_keeps_duplicates_as_the_reference():
    """The sharded fold's compaction (``compact_live(dedup=False)``) keeps
    the multiset of live pairs that ``compact_actives(dedup=False)``
    keeps, so the live counts that steer the driver agree."""
    rng = np.random.default_rng(7)
    n, c = 1000, 1 << 12
    lo = rng.integers(0, 40, c).astype(np.int32)
    hi = (lo + rng.integers(1, 4, c)).astype(np.int32)
    dead = rng.random(c) < 0.5
    lo[dead] = n
    hi[dead] = n
    jlo, jhi = jelim.compact_actives(jnp.asarray(lo), jnp.asarray(hi), n,
                                     c)
    plo, phi = compact.compact_live(torch.from_numpy(lo),
                                    torch.from_numpy(hi), n, c, dedup=False)
    want = sorted(zip(np.asarray(jlo).tolist(), np.asarray(jhi).tolist()))
    got = sorted(zip(plo.tolist(), phi.tolist()))
    assert got == want
    assert int((plo != n).sum()) == int((~dead).sum())
    dlo, _ = compact.compact_live(torch.from_numpy(lo), torch.from_numpy(hi),
                                  n, c)
    assert int((dlo != n).sum()) < int((~dead).sum())


def test_pipeline_steps_match_the_reference():
    """The per-segment fold, the merge and the occupancy read of the
    pipeline on a hand-made state, step by step, against the reference's
    pipeline on the same state."""
    n, d = 300, 5
    rng = np.random.default_rng(11)
    e = rng.integers(0, n, (d, 256, 2)).astype(np.int32)
    pos = np.concatenate([rng.permutation(n), [n]]).astype(np.int32)
    jp = JPipeline(n, 256, jmesh.shards_mesh(d))
    pp = ShardedPipeline(n, 256, mesh.shards_mesh(d, device="cpu"))
    jstats, pstats = {}, {}
    jP = jp.build_step(jp.init_forest(), jp.put_batch(e),
                       jp.put_replicated(pos), stats=jstats)
    pP = pp.build_step(pp.init_forest(), pp.put_batch(e),
                       pp.put_replicated(pos), stats=pstats)
    assert np.array_equal(np.asarray(jP), np.stack([p.numpy() for p in pP]))
    assert pstats == jstats
    assert int(pp.max_occupancy(pP)) == int(jp.max_occupancy(jP))
    jm, pm = {}, {}
    want = np.asarray(jp.merge(jP, stats=jm))
    got = pp.merge(pP, stats=pm).numpy()
    assert np.array_equal(got, want) and pm == jm
    # the merge left the shards' tables as they were (consume=False)
    assert np.array_equal(np.asarray(jP), np.stack([p.numpy() for p in pP]))


def test_entry_points_and_cli_match_single_device(tmp_path, capsys):
    """``partition(..., backend="torch-sharded")`` at D = 1 and 8 equals
    the single-device port (the cross-backend invariant);
    ``partition_multi`` and the CLI's ``--backend torch-sharded`` too."""
    spec = "rmat-hash:11:8:2"
    single = sheep_tpu_torch.partition(spec, 8, device="cpu",
                                       keep_tree=True)
    for d in (1, 8):
        res = sheep_tpu_torch.partition(spec, 8, device="cpu",
                                        backend="torch-sharded",
                                        n_devices=d, keep_tree=True)
        assert np.array_equal(res.tree["parent"], single.tree["parent"])
        assert np.array_equal(res.assignment, single.assignment)
        for key in SCORES:
            assert getattr(res, key) == getattr(single, key), key
        assert res.backend == "torch-sharded:cpu"
    multi = sheep_tpu_torch.partition_multi(spec, [8, 4], device="cpu",
                                            backend="torch-sharded")
    assert np.array_equal(multi[0].assignment, single.assignment)
    with pytest.raises(ValueError, match="unknown backend"):
        sheep_tpu_torch.partition(spec, 8, device="cpu", backend="tpu")
    with pytest.raises(ValueError, match="n_devices"):
        sheep_tpu_torch.partition(spec, 8, device="cpu", n_devices=2)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        mesh.shards_mesh(9, device="cpu")
    out = str(tmp_path / "g.parts")
    assert cli.main(["--input", spec, "--k", "8", "--device", "cpu",
                     "--backend", "torch-sharded", "--n-devices", "8",
                     "--output", out, "--json"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["edge_cut"], line["total_edges"]) == (single.edge_cut,
                                                       single.total_edges)
    assert line["backend"] == "torch-sharded:cpu"
    assert np.array_equal(np.loadtxt(out, dtype=np.int64),
                          single.assignment)
    with pytest.raises(SystemExit):
        cli.main(["--input", spec, "--k", "8", "--device", "cpu",
                  "--backend", "torch-sharded", "--carry-tail"])
