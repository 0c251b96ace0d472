"""The port's pipelined dispatch (``fold_segments_pipelined`` at depth D)
and staged ingest against the JAX package's, on the CPU.

For D in {1, 2, 3} the port's pipelined fold is held exactly against the
reference's at the same D on the same staged blocks: the table, the total
rounds and the dispatch counters (``batch_execs``, ``host_syncs``,
``inflight_discards``, ``batch_retired``, ``device_rounds``), in the
cases of tests/test_inflight.py (oracle equality, discard on early
convergence, resume after the budget runs out, the ``max_rounds``
backstop) and through a flush barrier. ``TorchBackend(inflight=D)`` is
held against ``TpuBackend(inflight=D)``, a ``.bin32`` file through the
H2D ring at every depth, and the CLI's ``--inflight``/``--h2d-ring``.
Everything compared is integer (balance is one shared float formula), so
every comparison is exact."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.backends.tpu_backend import TpuBackend, pad_chunk
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import elim as jelim
from sheep_tpu.ops import order as jorder
from sheep_tpu_torch import cli
from sheep_tpu_torch.backends import torch_backend
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io.edgestream import EdgeStream
from sheep_tpu_torch.ops import elim
from sheep_tpu_torch.utils.prefetch import H2DRing, prefetch

COUNTERS = ("batch_execs", "host_syncs", "inflight_discards",
            "batch_retired", "device_rounds")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These CPU runs issue many small ops, round after round; beside the
    other workers of a parallel test run, torch's intra-op threads cost
    far more than they save (a test of ~1.5 s alone took 150 s beside
    five other workers on eight cores), so the module runs on one thread
    and restores the count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _groups(scale, ef, seed, cs, batch):
    """The numpy [batch, cs] oriented position blocks of an R-MAT graph,
    the last group filled with sentinel chunks, and n."""
    n = 1 << scale
    e = jgen.rmat(scale, ef, seed=seed)
    deg = jdeg.degree_chunk(jdeg.init_degrees(n), pad_chunk(e, len(e), n), n)
    pos, _ = jorder.elimination_order(deg, n)
    chunks = [pad_chunk(e[off:off + cs], cs, n)
              for off in range(0, len(e), cs)]
    while len(chunks) % batch:
        chunks.append(np.full((cs, 2), n, np.int32))
    out = []
    for i in range(0, len(chunks), batch):
        loB, hiB = jelim.orient_chunks_batch_pos(
            jnp.asarray(np.stack(chunks[i:i + batch])), pos, n)
        out.append((np.asarray(loB), np.asarray(hiB)))
    return out, n


def _both(groups, n, inflight, **kw):
    """The same staged blocks through the reference's fold and the
    port's at depth ``inflight``: (P, rounds, stats) of each; tags are
    the group indices."""
    sj, sp = {}, {}
    jax_kw, port_kw = kw.pop("jax", {}), kw.pop("port", {})
    P_j, r_j = jelim.fold_segments_pipelined(
        jnp.full(n + 1, n, jnp.int32),
        ((jnp.asarray(lo), jnp.asarray(hi), i)
         for i, (lo, hi) in enumerate(groups)), n,
        inflight=inflight, donate=False, stats=sj, **jax_kw, **kw)
    P, r = elim.fold_segments_pipelined(
        torch.full((n + 1,), n, dtype=torch.int32),
        ((torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy()), i)
         for i, (lo, hi) in enumerate(groups)), n,
        inflight=inflight, stats=sp, **port_kw, **kw)
    return (np.asarray(P_j), int(r_j), sj), (P.numpy(), r, sp)


def _assert_same(ref, got):
    (P_j, r_j, sj), (P, r, sp) = ref, got
    assert np.array_equal(P, P_j)
    assert r == r_j
    for key in COUNTERS:
        assert sp[key] == sj[key], key
    assert ("batch_incomplete_segments" in sp) == \
        ("batch_incomplete_segments" in sj)
    assert sp.get("batch_incomplete_segments") == \
        sj.get("batch_incomplete_segments")


@pytest.fixture(scope="module")
def rmat12():
    return _groups(12, 8, 5, 1 << 10, 2)


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_pipelined_matches_jax(rmat12, inflight):
    groups, n = rmat12
    ref, got = _both(groups, n, inflight, segment_rounds=2)
    _assert_same(ref, got)
    sp = got[2]
    assert sp["host_syncs"] == sp["batch_execs"]  # one read an execution
    assert sp["host_blocked_ms"] >= 0.0 and sp["device_gap_ms"] >= 0.0
    assert sp["rounds_enqueued"] >= sp["device_rounds"]


@pytest.mark.parametrize("inflight", [2, 3])
def test_early_convergence_discards_speculation(inflight):
    """One group, one execution that drains it: the stream-end
    speculations are discarded unread, and the table is the confirmed
    one."""
    groups, n = _groups(11, 8, 3, 1 << 14, 1)
    ref, got = _both(groups, n, inflight, batch_rounds=256)
    _assert_same(ref, got)
    assert got[2]["inflight_discards"] == inflight - 1
    assert got[2]["host_syncs"] == 1


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_budget_exhaustion_resumes(rmat12, inflight):
    """A budget of 3 rounds an execution: leftovers are re-queued on the
    current table, in the reference's order."""
    groups, n = rmat12
    ref, got = _both(groups, n, inflight, batch_rounds=3)
    _assert_same(ref, got)
    assert got[2]["batch_execs"] > len(groups)


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_max_rounds_backstop_flags_incomplete(inflight):
    groups, n = _groups(11, 8, 2, 256, 2)
    ref, got = _both(groups, n, inflight, max_rounds=4)
    _assert_same(ref, got)
    assert got[1] >= 4 and got[2]["batch_incomplete_segments"] > 0


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_flush_barrier(rmat12, inflight):
    """``on_confirm`` asks for a barrier after every second group; the
    tables ``on_flush`` receives, and the confirms' (tag, rounds), equal
    the reference's."""
    groups, n = rmat12
    seen = {"jax": [], "port": []}

    def hooks(key, as_numpy):
        def on_confirm(tag, rounds, P):
            seen[key].append(("confirm", tag, int(rounds)))
            return tag is not None and tag % 2 == 1

        def on_flush(P):
            seen[key].append(("flush", as_numpy(P).tolist()))
        return {"on_confirm": on_confirm, "on_flush": on_flush}

    ref, got = _both(groups, n, inflight, batch_rounds=3,
                     jax=hooks("jax", np.asarray),
                     port=hooks("port", lambda P: P.numpy().copy()))
    _assert_same(ref, got)
    assert seen["port"] == seen["jax"]
    assert sum(1 for s in seen["port"] if s[0] == "flush") >= 2


def test_round_log_holds_every_counted_round(rmat12):
    groups, n = rmat12
    log, stats = [], {}
    elim.fold_segments_pipelined(
        torch.full((n + 1,), n, dtype=torch.int32),
        ((torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy()))
         for lo, hi in groups), n, inflight=2, batch_rounds=3,
        stats=stats, round_log=log)
    assert len(log) == stats["device_rounds"]
    assert sum(d for d, _ in log) == stats["depth_sum"]
    assert max(v for _, v in log) == stats["live_max"]


def test_pipelined_rejects_bad_depth():
    with pytest.raises(ValueError, match="inflight"):
        elim.fold_segments_pipelined(torch.full((8,), 7, dtype=torch.int32),
                                     iter(()), 7, inflight=0)


def _edges():
    return jgen.rmat(11, 8, seed=9), 1 << 11


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_backend_matches_tpu_backend(inflight):
    e, n = _edges()
    ref = TpuBackend(chunk_edges=512, dispatch_batch=2,
                     inflight=inflight).partition(
        jes.EdgeStream.from_array(e, n_vertices=n), 8, keep_tree=True)
    got = TorchBackend(chunk_edges=512, dispatch_batch=2, device="cpu",
                       inflight=inflight).partition(
        EdgeStream.from_array(e, n_vertices=n), 8, keep_tree=True)
    assert np.array_equal(got.tree["parent"], ref.tree["parent"])
    assert np.array_equal(got.assignment, ref.assignment)
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        assert getattr(got, key) == getattr(ref, key), key
    for key in ("device_rounds", "inflight_depth", "inflight_discards",
                "batch_execs", "host_syncs"):
        assert got.diagnostics[key] == ref.diagnostics[key], key
    for key in ("host_blocked_ms", "device_gap_ms"):
        assert got.diagnostics[key] >= 0.0


@pytest.fixture(scope="module")
def bin32(tmp_path_factory):
    e, n = _edges()
    path = str(tmp_path_factory.mktemp("g") / "g.bin32")
    jformats.write_edges(path, e)
    return path


@pytest.mark.parametrize("ring", [1, 2, 3])
def test_bin32_through_the_ring(bin32, ring):
    with jes.open_input(bin32) as s:
        ref = TpuBackend(chunk_edges=1024, dispatch_batch=2, inflight=2,
                         h2d_ring=ring).partition(s, 4, keep_tree=True)
    res = TorchBackend(chunk_edges=1024, dispatch_batch=2, device="cpu",
                       inflight=2, h2d_ring=ring).partition(
        EdgeStream.open(bin32), 4, keep_tree=True)
    assert np.array_equal(res.tree["parent"], ref.tree["parent"])
    assert np.array_equal(res.assignment, ref.assignment)
    assert (res.edge_cut, res.comm_volume) == (ref.edge_cut, ref.comm_volume)
    d = res.diagnostics
    assert d["device_rounds"] == ref.diagnostics["device_rounds"]
    assert d["h2d_ring_depth"] == ring
    # three passes (degrees, build, score) of 16 chunks of 1024 x 2 int32
    assert d["h2d_staged_bytes"] == 3 * 16 * 1024 * 8


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_h2d_ring_keeps_order_and_closes(depth):
    blocks = [np.full((4, 2), i, np.int32) for i in range(7)]
    stats = {}
    with prefetch(iter(blocks)) as pf, \
            H2DRing(pf, "cpu", depth=depth, stats=stats) as ring:
        got = [int(b[0, 0]) for b in ring]
    assert got == list(range(7))
    assert stats["h2d_staged_bytes"] == 7 * 32
    ring = H2DRing(iter(blocks), "cpu", depth=depth)
    next(ring)
    ring.close()
    assert list(ring) == []
    with pytest.raises(ValueError, match="depth"):
        H2DRing(iter(blocks), "cpu", depth=0)


def test_prefetch_delivers_worker_errors():
    def bad():
        yield 1
        raise OSError("read failed")

    with prefetch(bad()) as pf:
        assert next(pf) == 1
        with pytest.raises(OSError, match="read failed"):
            next(pf)


def test_auto_depths_and_validation():
    for resolve in (torch_backend.resolve_inflight,
                    torch_backend.resolve_h2d_ring):
        assert resolve(0, "cpu") == 1
        assert resolve(0, torch.device("cuda")) == 2
        assert resolve(3, "cpu") == 3
    with pytest.raises(ValueError, match="inflight"):
        TorchBackend(device="cpu", inflight=-1)
    with pytest.raises(ValueError, match="h2d_ring"):
        TorchBackend(device="cpu", h2d_ring=-1)


@pytest.mark.parametrize("flags", [["--inflight", "2", "--h2d-ring", "3"],
                                   ["--inflight", "3"], []])
def test_cli_depth_flags(capsys, bin32, flags):
    assert cli.main(["--input", bin32, "--k", "4", "--device", "cpu",
                     "--chunk-edges", "1024", "--dispatch-batch", "2",
                     "--json", *flags]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jes.open_input(bin32) as s:
        ref = TpuBackend(chunk_edges=1024, dispatch_batch=2,
                         inflight=1).partition(s, 4)
    assert (line["edge_cut"], line["comm_volume"]) == \
        (ref.edge_cut, ref.comm_volume)
    want = int(flags[1]) if flags else 1  # auto is 1 on the CPU
    assert line["diagnostics"]["inflight_depth"] == want


@pytest.mark.parametrize("flag", ["--inflight", "--h2d-ring"])
def test_cli_rejects_negative_depths(capsys, flag):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--input", "rmat-hash:8", "--k", "2", "--device", "cpu",
                  flag, "-1"])
    assert exc.value.code == 2
    assert ">= 0" in capsys.readouterr().err
