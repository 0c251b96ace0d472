"""The port's device-stream counters and the records it prints
(``sheep_tpu_torch/io/devicestream.py``, the backend's diagnostics, the
flat CLI's wall line) against the JAX package's ``tpu`` backend and CLI on
the CPU: ``device_stream_chunks`` and ``h2d_staged_bytes`` with the chunk
cache on and off and on a resume from a later chunk, every ``_ms``
counter rounded to 3 places, and the wall line's edges/s."""

import re

import numpy as np
import pytest

from sheep_tpu import cli as jcli
from sheep_tpu.backends import tpu_backend as jtpu
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.utils import checkpoint as jck
from sheep_tpu.utils import fault as jfault

from sheep_tpu_torch import cli
from sheep_tpu_torch.backends import torch_backend
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import devicestream, edgestream, generators
from sheep_tpu_torch.utils import checkpoint, fault

K = 8
CS = 2048
SPECS = ["rmat-hash:11:8:5", "sbm-hash:11:4:0.1:8:2"]
KEYS = ("device_stream_chunks", "h2d_staged_bytes", "residency_hits")


def _env(monkeypatch, cache):
    jfault.reset()
    fault.reset()
    if cache is None:
        monkeypatch.delenv("SHEEP_CACHE_BYTES", raising=False)
    else:
        monkeypatch.setenv("SHEEP_CACHE_BYTES", str(cache))


def _jax_run(spec, ck=None, resume=False):
    with jes.open_input(spec) as s:
        return get_backend("tpu", chunk_edges=CS).partition(
            s, K, checkpointer=ck, resume=resume)


def _port_run(spec, ck=None, resume=False):
    with edgestream.open_input(spec) as s:
        return TorchBackend(device="cpu", chunk_edges=CS).partition(
            s, K, checkpointer=ck, resume=resume)


def _same_counters(ref, got):
    assert np.array_equal(got.assignment, ref.assignment)
    for key in KEYS:
        assert got.diagnostics.get(key) == ref.diagnostics.get(key), key


@pytest.mark.parametrize("cache", [None, 1 << 22], ids=["no-cache", "cache"])
@pytest.mark.parametrize("spec", SPECS)
def test_device_stream_counters_match_jax(monkeypatch, spec, cache):
    """Each synthesized chunk counted once, no staged bytes: three passes
    of 8 chunks uncached, one cached (the build and the score read the
    cache)."""
    _env(monkeypatch, cache)
    ref, got = _jax_run(spec), _port_run(spec)
    _same_counters(ref, got)
    d = got.diagnostics
    assert d["h2d_staged_bytes"] == 0
    assert d["device_stream_chunks"] == (8 if cache else 24)


@pytest.mark.parametrize("spec", SPECS)
def test_resumed_counters_match_jax(tmp_path, monkeypatch, spec):
    """Killed at build:5 with a checkpoint every 2 chunks, then resumed
    from the build's chunk 4: the resumed run's counters equal the
    reference's."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for run, ck in ((_jax_run, jck.Checkpointer(jdir, every=2)),
                    (_port_run, checkpoint.Checkpointer(tdir, every=2))):
        _env(monkeypatch, None)
        monkeypatch.setenv(fault.ENV_VAR, "build:5")
        with pytest.raises(RuntimeError, match="injected fault"):
            run(spec, ck)
    monkeypatch.delenv(fault.ENV_VAR)
    _env(monkeypatch, None)
    ref = _jax_run(spec, jck.Checkpointer(jdir, every=2), resume=True)
    got = _port_run(spec, checkpoint.Checkpointer(tdir, every=2),
                    resume=True)
    _same_counters(ref, got)
    # the build from chunk 4 and the score: 4 + 8 chunks
    assert got.diagnostics["device_stream_chunks"] == 12


@pytest.mark.parametrize("start", [0, 3, 8])
def test_supplier_counts_from_a_later_chunk(start):
    """The chunk supplier from ``start_chunk`` counts the chunks it
    synthesizes as the reference's ``_upload_chunks`` does."""
    n = 1 << 11
    ref_stats, stats = {}, {}
    ref = [np.asarray(c) for c in jtpu._upload_chunks(
        jgen.RmatHashStream(11, 8, seed=5), CS, n, start, stats=ref_stats)]
    got = [c.numpy() for c in torch_backend.device_chunks(
        generators.RmatHashStream(11, 8, seed=5), CS, n, "cpu",
        stats=stats, start_chunk=start)]
    assert len(got) == len(ref) == 8 - start
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert stats == ref_stats


def test_device_stream_protocol():
    assert devicestream.is_device_stream(generators.RmatHashStream(10))
    assert isinstance(generators.NearCliqueStream(10, 4, 0.1),
                      devicestream.DeviceStream)
    assert not devicestream.is_device_stream(
        edgestream.open_input("plsbm-hash:10:4:0.1"))
    stats = {"h2d_staged_bytes": 64}
    devicestream.note_device_chunks(stats, 3)
    devicestream.note_device_chunks(None)
    assert stats == {"h2d_staged_bytes": 64, "device_stream_chunks": 3}


@pytest.fixture(scope="module")
def bin32(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ds") / "g.bin32")
    jformats.write_edges(path, jgen.rmat_hash_range(11, 0, 8 << 11, seed=7))
    return path


def test_ms_counters_rounded(bin32):
    """A .bin32 through the H2D ring: every ``_ms`` diagnostic has at most
    3 decimals, on both packages."""
    opts = dict(chunk_edges=CS, dispatch_batch=2, inflight=2, h2d_ring=2)
    with jes.open_input(bin32) as s:
        ref = get_backend("tpu", **opts).partition(s, K)
    with edgestream.open_input(bin32) as s:
        got = TorchBackend(device="cpu", **opts).partition(s, K)
    for res in (ref, got):
        ms = {k: v for k, v in res.diagnostics.items() if k.endswith("_ms")}
        assert {"h2d_staged_ms", "h2d_blocked_ms", "host_blocked_ms",
                "device_gap_ms"} <= set(ms)
        for key, v in ms.items():
            assert round(v, 3) == v, (key, v)
    assert got.diagnostics["h2d_staged_bytes"] == \
        ref.diagnostics["h2d_staged_bytes"]


WALL = re.compile(r"^wall: \d+\.\d\ds  \([\d,]+ edges/s\)$", re.M)


def test_cli_wall_line_matches_jax(capsys, bin32):
    argv = ["--input", bin32, "--k", "4", "--chunk-edges", str(CS)]
    assert jcli.main(argv + ["--backend", "tpu"]) == 0
    ref = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert WALL.search(ref) and WALL.search(got), (ref, got)
