"""The port's vertex-sharded build (``torch-bigv``) through its device
ingest, checkpoints, faults, residency, multi-k and incremental paths, at
``device="cpu"`` on 8 virtual shards, against the JAX package's
``tpu-bigv`` on the 8-device virtual CPU mesh of ``tests/conftest.py``
(and its ``tpu`` backend where the cross-backend invariant makes them
equal), with zero tolerance:

- a device-synthesized ``rmat-hash`` input (``device_stream_chunks``, no
  staged bytes);
- builds killed at a degrees, build and score checkpoint and resumed, and
  a ``tpu-bigv`` checkpoint (state format ``bigv-pos``) resumed by the
  port;
- an injected out-of-memory fault retried in process
  (``dispatch_retries``), a stall caught by the watchdog, a residency
  budget that spills;
- ``partition_multi`` at ks [2, 8, 64];
- two delta epochs folded into the one distributed forest (the table and
  the fold counters against ``tpu-bigv``'s) and a scored refresh (against
  the ``tpu`` backend's).
"""

import numpy as np
import pytest
import torch

import jax

from sheep_tpu import incremental as jinc
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import generators as jgen
from sheep_tpu.utils import fault as jfault
from sheep_tpu.utils.checkpoint import Checkpointer as JCheckpointer

from sheep_tpu_torch import incremental as inc
from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
from sheep_tpu_torch.io import deltalog as dl
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.parallel import mesh
from sheep_tpu_torch.utils import fault
from sheep_tpu_torch.utils.checkpoint import Checkpointer
from sheep_tpu_torch.utils.fault import InjectedFault

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

SCORES = ("edge_cut", "total_edges", "comm_volume", "balance")
N10 = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def _eight_shards():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh.force_cpu_devices(8)
    yield
    mesh.force_cpu_devices(1)
    torch.set_num_threads(threads)


def _rmat10():
    return jgen.rmat(10, 8, seed=3)


def _deterministic(diag: dict) -> dict:
    return {k: v for k, v in diag.items()
            if not (k.startswith("t_") or k.endswith("_ms"))}


def _assert_same(res, ref, tree=True, stats=True):
    """The result, and with ``tree`` the forest, with ``stats`` every
    diagnostic of ``ref`` that is not a time (a resumed run counts only
    what it ran)."""
    if tree:
        for key in ("parent", "pos", "deg"):
            assert np.array_equal(res.tree[key], ref.tree[key]), key
    assert np.array_equal(res.assignment, ref.assignment)
    for key in SCORES:
        assert getattr(res, key) == getattr(ref, key), key
    for key, want in _deterministic(ref.diagnostics).items() if stats \
            else ():
        assert res.diagnostics.get(key) == want, key


def _port(cs=256, **kw):
    return TorchBigVBackend(chunk_edges=cs, device="cpu", jumps=16, **kw)


def _jax(cs=256, **kw):
    return get_backend("tpu-bigv", chunk_edges=cs, jumps=16, **kw)


def _run(be, e, n=N10, k=4, es=edgestream, **kw):
    return be.partition(es.EdgeStream.from_array(e, n_vertices=n), k, **kw)


@pytest.fixture(scope="module")
def clean():
    """The uninterrupted port build of rmat10 at k = 4, and the
    reference's."""
    return (_run(_port(), _rmat10(), keep_tree=True),
            _run(_jax(), _rmat10(), es=jes, keep_tree=True))


def test_clean_build_matches_reference(clean):
    res, ref = clean
    _assert_same(res, ref)


def test_device_synthesized_input_matches():
    """An ``rmat-hash`` input is synthesized on each shard's device
    (``device_lockstep_batches``): no staged host bytes, the reference's
    ``device_stream_chunks``."""
    spec = "rmat-hash:12:8:5"
    with jes.open_input(spec) as s:
        ref = get_backend("tpu-bigv", chunk_edges=2048).partition(
            s, 8, keep_tree=True)
    with edgestream.open_input(spec) as s:
        res = TorchBigVBackend(chunk_edges=2048, device="cpu").partition(
            s, 8, keep_tree=True)
    _assert_same(res, ref)
    assert res.diagnostics["device_stream_chunks"] > 0
    assert res.diagnostics.get("h2d_staged_bytes", 0) == 0


@pytest.mark.parametrize("phase", ["degrees", "build", "score"])
def test_kill_and_resume_matches_uninterrupted(tmp_path, monkeypatch, phase,
                                               clean):
    """Killed after a phase's second batch, with a checkpoint every batch
    (8 chunks): the saved local blocks (``deg_local``, ``ptable_local``)
    resume to the uninterrupted result, and the checkpoint is cleared."""
    expect, _ = clean
    ck = Checkpointer(str(tmp_path), every=8)
    monkeypatch.setenv(fault.ENV_VAR, f"{phase}:2")
    fault.reset()
    with pytest.raises(InjectedFault):
        _run(_port(), _rmat10(), checkpointer=ck)
    monkeypatch.delenv(fault.ENV_VAR)
    saved = ck.load()
    assert saved.phase == phase
    assert saved.arrays["deg_local"].dtype == np.int32
    if phase != "degrees":
        assert saved.arrays["ptable_local"].shape == (8 * (-(-1025 // 8)),)
    res = _run(_port(), _rmat10(), checkpointer=ck, resume=True)
    _assert_same(res, expect, tree=False, stats=False)
    assert ck.load() is None


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, clean):
    """The checkpoint's format (``bigv-pos``) and fingerprint are the
    reference's: a ``tpu-bigv`` build killed mid-build finishes in the
    port."""
    expect, _ = clean
    ck = JCheckpointer(str(tmp_path), every=8)
    monkeypatch.setenv(jfault.ENV_VAR, "build:2")
    jfault.reset()
    with pytest.raises(jfault.InjectedFault):
        _run(_jax(), _rmat10(), es=jes, checkpointer=ck)
    monkeypatch.delenv(jfault.ENV_VAR)
    assert ck.load().phase == "build"
    res = _run(_port(), _rmat10(),
               checkpointer=Checkpointer(str(tmp_path), every=8),
               resume=True)
    _assert_same(res, expect, tree=False, stats=False)


def test_oom_is_retried_in_process(monkeypatch, clean):
    """``oom@dispatch:2``: the second build step's injected out-of-memory
    fault is retried from the untouched forest, with the reference's
    ``dispatch_retries`` and result."""
    expect, _ = clean
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.0")
    out = {}
    for name, be, es in (("jax", _jax(), jes), ("port", _port(),
                                                edgestream)):
        monkeypatch.setenv(fault.ENV_VAR, "oom@dispatch:2")
        jfault.reset()
        fault.reset()
        out[name] = _run(be, _rmat10(), es=es, keep_tree=True)
        monkeypatch.delenv(fault.ENV_VAR)
    _assert_same(out["port"], out["jax"])
    assert out["port"].diagnostics["dispatch_retries"] == 1
    assert np.array_equal(out["port"].assignment, expect.assignment)


def test_oom_after_the_forest_changed_is_retried_from_the_batch(
        monkeypatch, clean):
    """An out-of-memory error raised inside the second build step, after
    its first segment has folded rounds into the forest, is retried from
    the tables before the batch: the forest, the result and every counter
    equal the reference's run with its fault at that step's dispatch."""
    from sheep_tpu_torch.parallel.bigv import BigVPipeline

    expect, _ = clean
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.0")
    monkeypatch.setenv(jfault.ENV_VAR, "oom@dispatch:2")
    jfault.reset()
    ref = _run(_jax(), _rmat10(), es=jes, keep_tree=True)
    monkeypatch.delenv(jfault.ENV_VAR)
    steps, fired = [], []
    step, fold = BigVPipeline.build_step, BigVPipeline.fold_segment

    def counted_step(self, *a, **kw):
        steps.append(1)
        return step(self, *a, **kw)

    def failing_fold(self, P, *a, **kw):
        before = [p.clone() for p in P]
        got = fold(self, P, *a, **kw)
        if len(steps) == 2 and not fired:
            fired.append(1)
            assert any(not torch.equal(p, b) for p, b in zip(P, before))
            raise RuntimeError("CUDA out of memory. Tried to allocate "
                               "200.00 MiB")
        return got

    monkeypatch.setattr(BigVPipeline, "build_step", counted_step)
    monkeypatch.setattr(BigVPipeline, "fold_segment", failing_fold)
    res = _run(_port(), _rmat10(), keep_tree=True)
    assert fired and res.diagnostics["dispatch_retries"] == 1
    _assert_same(res, ref)
    assert np.array_equal(res.assignment, expect.assignment)


def test_watchdog_interrupts_a_stalled_build(monkeypatch):
    from sheep_tpu_torch.utils import watchdog

    monkeypatch.setenv(watchdog.ENV_TIMEOUT, "0.2")
    monkeypatch.setattr(fault, "STALL_S", 1.0)
    monkeypatch.setenv(fault.ENV_VAR, "stall@build:1")
    fault.reset()
    with pytest.raises(KeyboardInterrupt):
        _run(_port(), _rmat10())
    monkeypatch.delenv(fault.ENV_VAR)


def test_residency_budget_spills_as_the_reference(monkeypatch, clean):
    """``SHEEP_CACHE_BYTES`` keeps the build's batches on the shards for
    the score pass; a tiny budget spills, with the reference's counters
    and the same result."""
    expect, _ = clean
    monkeypatch.setenv("SHEEP_CACHE_BYTES", "40000")
    res = _run(_port(), _rmat10(), keep_tree=True)
    ref = _run(_jax(), _rmat10(), es=jes, keep_tree=True)
    _assert_same(res, ref)
    assert res.diagnostics["spill_evictions"] > 0
    assert 0 < res.diagnostics["spill_resident_bytes"] <= 40000
    assert np.array_equal(res.assignment, expect.assignment)


def test_partition_multi_matches_reference_and_single_runs():
    e = jgen.rmat(10, 8, seed=6)
    ks = [2, 8, 64]
    multi = _port(cs=1024).partition_multi(
        edgestream.EdgeStream.from_array(e, n_vertices=N10), ks)
    jmulti = _jax(cs=1024).partition_multi(
        jes.EdgeStream.from_array(e, n_vertices=N10), ks)
    assert [r.k for r in multi] == ks
    for r, j in zip(multi, jmulti):
        single = _run(_port(cs=1024), e, k=r.k)
        assert np.array_equal(r.assignment, j.assignment)
        assert np.array_equal(r.assignment, single.assignment)
        for key in SCORES:
            assert getattr(r, key) == getattr(j, key), key
            assert getattr(r, key) == getattr(single, key), key


def test_two_delta_epochs_and_a_scored_refresh(tmp_path):
    """Two add epochs fold into the one distributed forest: the table and
    the fold counters (``update_folds``, ``update_rounds``, the routed
    collectives' counts) are ``tpu-bigv``'s; the scored second epoch and
    the one-shot ``delta:`` build equal the reference's ``tpu`` backend
    (the cross-backend invariant)."""
    n = 512
    e = np.random.default_rng(5).integers(0, n, (4000, 2)).astype(np.int64)
    half = len(e) // 2
    base = str(tmp_path / "base.bin64")
    with open(base, "wb") as f:
        f.write(e[:half].astype("<u8").tobytes())
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[half: half + 1000])
        w.append(e[half + 1000:])
    be = _port(cs=4096)
    state, _ = inc.begin_incremental(
        edgestream.open_input(base, n_vertices=n), 8, backend="torch-bigv",
        chunk_edges=4096, jumps=16, device="cpu")
    assert state.backend_name == "torch-bigv"
    jbe = _jax(cs=4096)
    jstate, _ = jinc.begin_incremental(
        jes.open_input(base, n_vertices=n), 8, backend=jbe)
    be.partition_update(state, adds=e[half: half + 1000], score=False)
    jbe.partition_update(jstate, adds=e[half: half + 1000], score=False)
    be.partition_update(state, adds=e[half + 1000:], score=False)
    jbe.partition_update(jstate, adds=e[half + 1000:], score=False)
    assert np.array_equal(state.minp, jstate.minp)
    for key in ("update_folds", "update_rounds", "device_rounds",
                "host_syncs", "folded_bytes", "collective_ops",
                "collective_bytes", "q_rounds", "compactions"):
        assert state.stats.get(key) == jstate.stats.get(key), key
    tpu = get_backend("tpu", chunk_edges=4096)
    tstate, _ = jinc.begin_incremental(
        jes.open_input(base, n_vertices=n), 8, backend=tpu)
    tpu.partition_update(tstate, adds=e[half:], score=False)
    got = inc.refresh(be, state, comm_volume=True)
    want = jinc.refresh(tpu, tstate, comm_volume=True)
    assert np.array_equal(state.minp, tstate.minp)
    assert np.array_equal(got.assignment, want.assignment)
    for key in SCORES:
        assert getattr(got, key) == getattr(want, key), key
    one = be.partition(edgestream.open_input(f"delta:{log}", n_vertices=n),
                       8, comm_volume=False)
    assert np.array_equal(one.assignment, got.assignment)
    assert (one.edge_cut, one.total_edges) == (got.edge_cut,
                                               got.total_edges)
