"""The port's fault layer against the JAX package's, on the CPU: the
``SHEEP_FAULT_INJECT`` grammars (``utils/fault.py``), ``classify`` and the
retry policy (``utils/retry.py``), the memory model's degrade ladder
(``utils/membudget.py``), in-process recovery from injected out-of-memory
and device-loss faults at ``dispatch`` (the ``tpu`` backend's counters),
and the streams' IO policy and read retry (``io/edgestream.py``)."""

import numpy as np
import pytest
import torch

import sheep_tpu
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.utils import fault as jfault
from sheep_tpu.utils import membudget as jmem
from sheep_tpu.utils import retry as jretry

import sheep_tpu_torch
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.utils import fault, membudget, retry

K = 8
CS = 2048
RECOVERY_KEYS = ("dispatch_retries", "spill_degrades",
                 "degraded_dispatch_batch", "degraded_inflight",
                 "degraded_h2d_ring", "device_loss_recoveries",
                 "device_rounds")


def _reset():
    jfault.reset()
    fault.reset()


def _outcome(mod, phase, count, kinds):
    """What one injection point does under the armed spec."""
    try:
        mod.maybe_fail(phase, count, kinds=kinds)
        return None
    except Exception as exc:  # noqa: BLE001, the outcome is compared
        return type(exc).__name__, getattr(exc, "fault_class", None)


SPECS = ["build:3", "level0:2", "oom@dispatch:2", "device@dispatch:1:2",
         "read@read:3", "kill@score:1", "stall@build:1", "chaos:7:3:0.5",
         "chaos:11", "oom@dispatch:2:0"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_jax(monkeypatch, spec):
    """The same call sequence under each spec fires the same faults, with
    the same classes, on both packages (scopes included)."""
    monkeypatch.setattr(jfault, "STALL_S", 0.0)
    monkeypatch.setattr(fault, "STALL_S", 0.0)
    calls = [(p, c, kinds) for c in range(5)
             for p, kinds in (("build", ("kill", "oom", "device")),
                              ("dispatch", ("oom", "device")),
                              ("read", ("read",)), ("score", ("kill",)))]
    out = []
    for mod in (jfault, fault):
        _reset()
        monkeypatch.setenv(mod.ENV_VAR, spec)
        with mod.scope("level0"):
            out.append([_outcome(mod, *c) for c in calls])
    monkeypatch.delenv(fault.ENV_VAR)
    assert out[0] == out[1]
    assert any(out[1]) or spec.endswith(":0") or spec.startswith("stall")


@pytest.mark.parametrize("spec", ["bad@build:1", "build:x", "chaos:x"])
def test_bad_specs_raise_as_jax(monkeypatch, spec):
    for mod in (jfault, fault):
        _reset()
        monkeypatch.setenv(mod.ENV_VAR, spec)
        with pytest.raises(ValueError):
            mod.maybe_fail("build", 1)
    monkeypatch.delenv(fault.ENV_VAR)


def _errors():
    return [
        fault.InjectedResourceExhausted("x"), fault.InjectedDeviceLoss("x"),
        fault.InjectedReadError("x"), fault.InjectedFault("x"),
        jfault.InjectedResourceExhausted("x"),
        MemoryError(), OSError("disk"), TimeoutError(),
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                               "2.00 GiB"),
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        RuntimeError("CUDA error: device-side assert triggered"),
        RuntimeError("RESOURCE_EXHAUSTED: while connection was open"),
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("device lost"), ValueError("bad input"),
        ConnectionResetError("connection reset by peer")]


def test_classify_matches_jax():
    got = [retry.classify(e) for e in _errors()]
    assert got == [jretry.classify(e) for e in _errors()]
    # a real out-of-memory error of the card is a resource fault; a sticky
    # CUDA error is fatal, as the reference's patterns say
    assert got[8] == retry.RESOURCE
    assert got[9] == got[10] == retry.FATAL


def test_retry_policy_matches_jax(monkeypatch):
    monkeypatch.setenv("SHEEP_RETRY_MAX", "2")
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.01")
    a, b = jretry.RetryPolicy(seed=3), retry.RetryPolicy(seed=3)
    assert (a.max_retries, a.base_delay_s) == (b.max_retries, b.base_delay_s)
    assert [a.delay_s(i) for i in range(6)] == [b.delay_s(i)
                                                 for i in range(6)]
    for cls in (retry.TRANSIENT, retry.RESOURCE, retry.DEVICE_LOSS,
                retry.FATAL):
        assert a.admit(cls) == b.admit(cls)
    b.jitter = 0.0
    assert b.record(retry.TRANSIENT, OSError("blip")) == 0.01
    assert b.attempts[retry.TRANSIENT] == 1
    with pytest.raises(ValueError):
        retry.RetryPolicy(max_retries=-1)
    assert retry.reinit_devices("cpu")


GRID = [(n, cs, batch, depth, ring, spill)
        for n in (1 << 10, (1 << 22) + 5)
        for cs in (1 << 12, 1 << 22)
        for batch in (1, 2, 16)
        for depth in (1, 2, 3)
        for ring in (None, 1, 2)
        for spill in (0, 1 << 20)]


def test_degrade_ladder_matches_jax():
    """``degraded_dispatch`` and ``build_phase_bytes`` with resident bytes
    give the reference's numbers over a grid."""
    for n, cs, batch, depth, ring, spill in GRID:
        for donate in (False, True):
            assert membudget.degraded_dispatch(
                n, cs, batch, depth, donate, h2d_ring=ring,
                spillable_bytes=spill) == jmem.degraded_dispatch(
                n, cs, batch, depth, donate, h2d_ring=ring,
                spillable_bytes=spill)
        assert membudget.build_phase_bytes(
            n, cs, dispatch_batch=batch, inflight=depth, donate=True,
            h2d_ring=ring or 0, resident_bytes=spill) == \
            jmem.build_phase_bytes(n, cs, dispatch_batch=batch,
                                   inflight=depth, donate=True,
                                   h2d_ring=ring or 0, resident_bytes=spill)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("faults") / "g.bin32")
    jformats.write_edges(path, jgen.rmat_hash_range(11, 0, 8 << 11, seed=3))
    return path


def _run(pkg, path, monkeypatch, env, **opts):
    _reset()
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


@pytest.mark.parametrize("env,opts", [
    ({"SHEEP_FAULT_INJECT": "oom@dispatch:2"}, {}),
    ({"SHEEP_FAULT_INJECT": "device@dispatch:2"}, {}),
    ({"SHEEP_FAULT_INJECT": "oom@dispatch:2:2"}, {}),
    ({"SHEEP_FAULT_INJECT": "oom@build:3:2"},
     {"dispatch_batch": 1, "inflight": 1}),
    ({"SHEEP_FAULT_INJECT": "device@build:5"}, {"carry_tail": True}),
], ids=["oom", "device", "oom-twice", "oom-per-segment", "device-carry"])
def test_recovery_matches_jax(monkeypatch, graph_file, env, opts):
    """An injected fault recovered in process: the uninterrupted partition,
    and the reference's retry, degrade and recovery counters."""
    opts = {"dispatch_batch": 2, "inflight": 2, **opts}
    if opts.get("carry_tail"):
        opts = {"carry_tail": True}
    env = {"SHEEP_RETRY_BASE_S": "0", **env}
    base = _run("port", graph_file, monkeypatch, {}, **opts)
    ref = _run("jax", graph_file, monkeypatch, env, **opts)
    got = _run("port", graph_file, monkeypatch, env, **opts)
    for res in (ref, got):
        assert np.array_equal(res.assignment, base.assignment)
        assert (res.edge_cut, res.total_edges, res.comm_volume) == \
            (base.edge_cut, base.total_edges, base.comm_volume)
    assert got.diagnostics["dispatch_retries"] >= 1
    for key in RECOVERY_KEYS:
        assert got.diagnostics.get(key) == ref.diagnostics.get(key), key


def test_retry_off_propagates(monkeypatch, graph_file):
    """``SHEEP_RETRY_MAX=0``: the injected fault reaches the caller."""
    with pytest.raises(fault.InjectedResourceExhausted):
        _run("port", graph_file, monkeypatch,
             {"SHEEP_RETRY_MAX": "0", "SHEEP_FAULT_INJECT": "oom@dispatch:1"},
             dispatch_batch=2, inflight=2)


def _torn(tmp_path, extra: bytes):
    path = str(tmp_path / "torn.bin32")
    rng = np.random.default_rng(0)
    jformats.write_edges(path, rng.integers(0, 500, size=(3000, 2)))
    with open(path, "ab") as f:
        f.write(extra)
    return path


def test_torn_input_io_policy_matches_jax(tmp_path, monkeypatch, capsys):
    """A .bin32 with 3 torn trailing bytes: ``strict`` raises
    ``CorruptStreamError`` (a ``ValueError``) with the byte count and the
    policy hint on both packages; ``quarantine`` warns and partitions the
    intact prefix exactly as the reference does."""
    path = _torn(tmp_path, b"\x01\x02\x03")
    kw = dict(chunk_edges=1024)
    msgs = []
    for err, run in (
            (jes.CorruptStreamError,
             lambda: sheep_tpu.partition(path, 4, backend="tpu", **kw)),
            (edgestream.CorruptStreamError,
             lambda: sheep_tpu_torch.partition(path, 4, device="cpu", **kw))):
        with pytest.raises(err) as info:
            run()
        assert isinstance(info.value, ValueError)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert "(3 torn trailing bytes)" in msgs[1] and \
        "SHEEP_IO_POLICY=quarantine" in msgs[1]
    monkeypatch.setenv("SHEEP_IO_POLICY", "quarantine")
    ref = sheep_tpu.partition(path, 4, backend="tpu", **kw)
    capsys.readouterr()
    got = sheep_tpu_torch.partition(path, 4, device="cpu", **kw)
    assert "edgestream quarantine" in capsys.readouterr().err
    assert np.array_equal(got.assignment, ref.assignment)
    assert (got.edge_cut, got.total_edges, got.comm_volume) == \
        (ref.edge_cut, ref.total_edges, ref.comm_volume)
    monkeypatch.setenv("SHEEP_IO_POLICY", "lenient")
    with pytest.raises(ValueError, match="SHEEP_IO_POLICY"):
        list(edgestream.EdgeStream.open(path).chunks(1024))


def test_short_read_io_policy(tmp_path, monkeypatch):
    """The file shrinks under a pass: strict raises, quarantine yields the
    intact pairs before the tear and stops, as the reference's reader."""
    path = _torn(tmp_path, b"")
    out = []
    for mod in (jes, edgestream):
        for policy in ("strict", "quarantine"):
            monkeypatch.setenv("SHEEP_IO_POLICY", policy)
            it = mod.EdgeStream.open(path).chunks(1024)
            first = next(it)
            with open(path, "r+b") as f:
                f.truncate(1024 * 8 + 300 * 8 + 4)
            try:
                rest = [c.tolist() for c in it]
            except mod.CorruptStreamError as exc:
                rest = type(exc).__bases__[0].__name__
            out.append((first.tolist(), rest))
            path = _torn(tmp_path, b"")
    assert out[:2] == out[2:]
    assert out[2][1] == "ValueError" and len(out[3][1]) == 1 and \
        len(out[3][1][0]) == 300


@pytest.mark.parametrize("name", ["g.bin32", "g.edges", "g.edges.gz"])
def test_read_retry_matches_jax(tmp_path, monkeypatch, name):
    """Two injected read errors are retried in place: every chunk from
    ``start_chunk`` on equals the reference's."""
    path = str(tmp_path / name)
    jformats.write_edges(path, jgen.rmat_hash_range(10, 0, 3000, seed=1))
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0")
    out = []
    for mod, fmod in ((jes, jfault), (edgestream, fault)):
        _reset()
        monkeypatch.setenv(fault.ENV_VAR, "read@read:1:2")
        s = mod.EdgeStream.open(path)
        out.append([c.tolist() for c in s.chunks(700, start_chunk=2)])
    monkeypatch.delenv(fault.ENV_VAR)
    assert out[0] == out[1] and len(out[1]) == 3


def test_start_chunk_matches_jax(tmp_path):
    """``chunks(cs, start_chunk=i)`` on every stream kind: the reference's
    chunks from i on."""
    e = jgen.rmat_hash_range(10, 0, 5000, seed=2)
    specs = ["rmat-hash:10:4:1", "sbm-hash:10:8:0.05:4:1", "rmat:9:4:2"]
    for name in ("g.bin32", "g.bin64", "g.edges", "g.edges.gz"):
        specs.append(str(tmp_path / name))
        jformats.write_edges(specs[-1], e)
    for spec in specs:
        for start in (0, 3, 99):
            with jes.open_input(spec) as a, edgestream.open_input(spec) as b:
                want = [c.tolist() for c in a.chunks(1000, start_chunk=start)]
                got = [c.tolist() for c in b.chunks(1000, start_chunk=start)]
            assert got == want, (spec, start)
    arr = np.asarray(e, np.int64)
    assert [c.tolist() for c in edgestream.EdgeStream.from_array(arr).chunks(
        1000, start_chunk=2)] == [c.tolist() for c in jes.EdgeStream
                                  .from_array(arr).chunks(1000,
                                                          start_chunk=2)]
