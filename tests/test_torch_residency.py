"""The port's device-resident chunk cache and its residency tier
(``sheep_tpu_torch/utils/residency.py``, ``_device_chunks`` and
``_chunk_cache_budget`` of the backend) against the JAX package's, on the
CPU: the manager's bookkeeping under the same operations, a tiny
``SHEEP_CACHE_BYTES`` budget on both build drivers (the reference's spill,
reload and hit counters, the unconstrained partition), the spill rung of
the degrade ladder, and the budget rule."""

import numpy as np
import pytest
import torch

from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.utils import fault as jfault
from sheep_tpu.utils import membudget as jmem
from sheep_tpu.utils import residency as jres

from sheep_tpu_torch.backends import torch_backend
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.utils import fault, residency

K = 8
CS = 2048
CHUNK_BYTES = CS * 2 * 4
RESIDENCY_KEYS = ("spill_evictions", "spill_reloads", "spill_reload_bytes",
                  "spill_resident_bytes", "residency_hits",
                  "residency_boundary_evictions", "spill_degrades",
                  "dispatch_retries", "degraded_dispatch_batch",
                  "degraded_inflight", "device_rounds")


def _ops(seed: int):
    rng = np.random.default_rng(seed)
    names = ["admit", "admit", "admit", "get", "lease", "release",
             "boundary", "spill", "pressure_spill", "end"]
    for _ in range(200):
        yield names[rng.integers(len(names))], int(rng.integers(12)), \
            int(rng.integers(1, 4)) * 100


def _apply(mgr, op, idx, nbytes):
    try:
        if op == "admit":
            return mgr.admit(idx, f"ref{idx}", nbytes)
        if op == "get":
            return mgr.get(idx)
        if op == "lease":
            return mgr.lease(idx)
        if op == "release":
            return mgr.release(idx)
        if op == "boundary":
            return mgr.boundary(idx)
        if op == "spill":
            return mgr.spill(nbytes if idx % 2 else None)
        if op == "pressure_spill":
            return mgr.pressure_spill()
        return mgr.note_stream_end(idx)
    except RuntimeError as exc:
        return type(exc).__name__


@pytest.mark.parametrize("seed", range(4))
def test_manager_matches_jax(seed):
    """The same random operations give the same answers, counters, resident
    sets and spillable bytes on both managers; evicting a leased entry
    raises ``LeasedChunkError``."""
    a = jres.ResidencyManager(700, stats={}, window_fraction=0.25)
    b = residency.ResidencyManager(700, stats={}, window_fraction=0.25)
    for op, idx, nbytes in _ops(seed):
        assert _apply(a, op, idx, nbytes) == _apply(b, op, idx, nbytes)
        assert a.stats == b.stats
        assert sorted(a.entries) == sorted(b.entries)
        assert (a.used, a.budget, a.complete, a.spillable_bytes()) == \
            (b.used, b.budget, b.complete, b.spillable_bytes())
    c = residency.ResidencyManager(700)
    assert c.admit(50, "x", 100)
    c.lease(50)
    with pytest.raises(residency.LeasedChunkError):
        c.evict(50)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("residency") / "g.bin32")
    jformats.write_edges(path, jgen.rmat_hash_range(11, 0, 8 << 11, seed=3))
    return path


def _run(pkg, path, monkeypatch, env, **opts):
    jfault.reset()
    fault.reset()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    try:
        if pkg == "jax":
            with jes.open_input(path) as s:
                return get_backend("tpu", chunk_edges=CS, **opts).partition(
                    s, K)
        with edgestream.open_input(path) as s:
            return TorchBackend(device="cpu", chunk_edges=CS,
                                **opts).partition(s, K)
    finally:
        for key in env:
            monkeypatch.delenv(key)


@pytest.mark.parametrize("budget,opts,inject", [
    (4 * CHUNK_BYTES, {}, None),
    (4 * CHUNK_BYTES, {"dispatch_batch": 2, "inflight": 2}, None),
    (64 * CHUNK_BYTES, {}, None),
    (4 * CHUNK_BYTES, {"dispatch_batch": 2, "inflight": 2},
     "oom@dispatch:3:2"),
    (4 * CHUNK_BYTES, {}, "oom@build:3:2"),
    (4 * CHUNK_BYTES, {"carry_tail": True}, "device@build:4"),
], ids=["per-segment", "batched", "fits", "batched-oom-spills",
        "per-segment-oom-spills", "carry-device"])
def test_budget_matches_jax(monkeypatch, graph_file, budget, opts, inject):
    """A budget of a quarter (or all) of the stream's 8 chunks: the
    reference's residency counters, the spill rung before any halving,
    and the unconstrained partition."""
    base = _run("port", graph_file, monkeypatch, {}, **opts)
    env = {"SHEEP_CACHE_BYTES": str(budget), "SHEEP_RETRY_BASE_S": "0"}
    if inject:
        env["SHEEP_FAULT_INJECT"] = inject
    ref = _run("jax", graph_file, monkeypatch, env, **opts)
    got = _run("port", graph_file, monkeypatch, env, **opts)
    for res in (ref, got):
        assert np.array_equal(res.assignment, base.assignment)
        assert (res.edge_cut, res.total_edges, res.comm_volume) == \
            (base.edge_cut, base.total_edges, base.comm_volume)
    d = got.diagnostics
    for key in RESIDENCY_KEYS:
        assert d.get(key) == ref.diagnostics.get(key), key
    assert 0 < d["spill_resident_bytes"] <= budget
    if budget < 8 * CHUNK_BYTES:
        assert d["spill_evictions"] > 0 and d["spill_reload_bytes"] > 0
    else:
        assert "spill_evictions" not in d and d["residency_hits"] == 16
    if inject and inject.startswith("oom"):
        assert d["spill_degrades"] >= 1 and \
            "degraded_dispatch_batch" not in d
    assert "residency_hits" not in base.diagnostics


def test_cache_off(monkeypatch, graph_file):
    """``cache_chunks=False`` keeps nothing on the device, whatever the
    budget."""
    got = _run("port", graph_file, monkeypatch,
               {"SHEEP_CACHE_BYTES": str(1 << 20)}, cache_chunks=False)
    assert not any(k.startswith(("spill_", "residency_"))
                   for k in got.diagnostics)


@pytest.mark.parametrize("fit", [2, 4, 8])
def test_residency_chunks_serve_the_stream(fit):
    """``_device_chunks`` through a :class:`ResidencyManager` of ``fit``
    chunks: every pass and a pass from a later chunk give the stream's
    chunks; a stream that fits is served from the device on the next pass,
    one that does not spills and reloads."""
    s = edgestream.open_input("rmat-hash:10:4:1")
    cs, n = 1024, s.num_vertices
    plain = [c.clone() for c in torch_backend.device_chunks(s, cs, n, "cpu")]
    stats: dict = {}
    rm = residency.ResidencyManager(fit * cs * 2 * 4, stats=stats)
    for _ in range(2):
        got = [c.clone() for c in torch_backend._device_chunks(
            s, cs, n, "cpu", rm, 0)]
        assert len(got) == len(plain) == 4
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    tail = [c.clone() for c in torch_backend._device_chunks(
        s, cs, n, "cpu", rm, 3)]
    assert len(tail) == 1 and torch.equal(tail[0], plain[3])
    assert rm.complete == (fit >= 4)
    assert stats["spill_resident_bytes"] <= rm.budget
    assert stats.get("residency_hits", 0) >= (5 if fit >= 4 else 1)
    assert (stats.get("spill_evictions", 0) > 0) == (fit < 4)


@pytest.mark.parametrize("hbm", [8 << 30, 80 << 30])
def test_cache_budget_matches_jax_rule(monkeypatch, hbm):
    """0.9 of the card's memory less the build's model and 1 GiB on CUDA
    (the reference's rule on an accelerator), 0 on the CPU, and
    ``SHEEP_CACHE_BYTES`` on any device."""
    monkeypatch.delenv("SHEEP_CACHE_BYTES", raising=False)
    monkeypatch.setattr(torch_backend, "device_memory_bytes",
                        lambda dev: hbm)
    n, cs = (1 << 22) + 1, 1 << 22
    want = max(0, int(0.9 * hbm) - jmem.build_phase_bytes(
        n, cs, dispatch_batch=8, inflight=2, donate=True)["total_bytes"]
        - (1 << 30))
    assert torch_backend._chunk_cache_budget(
        n, cs, torch.device("cuda"), dispatch_batch=8, inflight=2,
        donate=True) == want
    assert torch_backend._chunk_cache_budget(n, cs, "cpu") == 0
    monkeypatch.setenv("SHEEP_CACHE_BYTES", "123")
    assert torch_backend._chunk_cache_budget(n, cs, "cpu") == 123
