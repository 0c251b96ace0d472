"""The port's delta log (``sheep_tpu_torch/io/deltalog.py``), its
``delta:`` input and ``io/csr.py``'s writer, against the JAX package on the
CPU, exactly.

Both packages write the same log bytes and read each other's logs; the
multiset algebra (``net_effect``, ``cancel_adds``, ``filter_tombstones``)
gives the reference's arrays on logs with cancellations, duplicates,
self-loops and unmatched deletes; ``rewrite_base`` and the v2 floor behave
as the reference's; a damaged log raises or keeps its intact prefix under
``SHEEP_IO_POLICY`` as ``tests/test_edgestream.py::TestDeltaLogDamage``
holds the reference; a ``delta:`` build equals the JAX package's; and
``write_csr`` writes the reference's bytes."""

import os

import numpy as np
import pytest
import torch

from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import csr as jcsr
from sheep_tpu.io import deltalog as jdl
from sheep_tpu.io import edgestream as jes

from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import csr, deltalog as dl, edgestream

N = 512
PKGS = {"port": (dl, edgestream), "jax": (jdl, jes)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU builds beside other test workers: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(m, n=N, seed=5):
    return np.random.default_rng(seed).integers(0, n, (m, 2)).astype(
        np.int64)


def _base_file(tmp_path, edges, name="base.bin64"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(np.asarray(edges, np.int64).astype("<u8").tobytes())
    return p


def _write_log(mod, path, base, e):
    """Three epochs: adds, adds with deletes (some of an earlier add, some
    of the base, one absent), then adds again; returns the log's bytes."""
    with mod.DeltaLogWriter(path, base_spec=base) as w:
        w.append(e[:50])
        w.append_epoch(adds=e[50:80], dels=np.concatenate(
            [e[10:20], e[200:205], [[N - 1, N - 2]]]))
        w.append(e[80:120], epoch=5)
    with open(path, "rb") as f:
        return f.read()


def _rows(recs):
    return np.stack([recs["u"].astype(np.int64),
                     recs["v"].astype(np.int64)], axis=1)


# -- the format, written and read across the packages ----------------------

@pytest.mark.parametrize("floor", [0, 3])
def test_header_bytes_and_round_trip(tmp_path, floor):
    a, b = str(tmp_path / "a.dlog"), str(tmp_path / "b.dlog")
    dl.write_header(a, "base.bin64", epoch_floor=floor)
    jdl.write_header(b, "base.bin64", epoch_floor=floor)
    assert open(a, "rb").read() == open(b, "rb").read()
    for read in (dl.read_header, jdl.read_header):
        hdr = read(a)
        assert hdr == dl.read_header(b)
        assert hdr["version"] == (2 if floor else 1)
        assert hdr["epoch_floor"] == floor


def test_not_a_delta_log(tmp_path):
    p = str(tmp_path / "junk")
    with open(p, "wb") as f:
        f.write(b"not a log at all")
    with pytest.raises(ValueError, match="bad magic"):
        dl.read_header(p)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_logs_read_across_packages(tmp_path, writer, reader):
    e = _graph(300)
    base = _base_file(tmp_path, e[200:])
    log = str(tmp_path / "g.dlog")
    raw = _write_log(PKGS[writer][0], log, base, e)
    other = str(tmp_path / "other.dlog")
    assert _write_log(PKGS["jax" if writer == "port" else "port"][0],
                      other, base, e) == raw
    rmod = PKGS[reader][0]
    got = list(rmod.DeltaLogReader(log).epochs())
    want = list(jdl.DeltaLogReader(log).epochs())
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 2, 5]
    for g, w in zip(got, want):
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
    assert rmod.DeltaLogReader(log).max_epoch == 5
    assert [ep for ep, _, _ in rmod.DeltaLogReader(log).epochs(
        start_epoch=1, up_to=2)] == [2]
    # a reopened appender resumes at the last epoch
    with rmod.DeltaLogWriter(log) as w2:
        assert w2.last_epoch == 5
        assert w2.append_epoch(adds=e[120:130]) == 6


def test_writer_validation(tmp_path):
    log = str(tmp_path / "g.dlog")
    with pytest.raises(ValueError, match="base_spec"):
        dl.DeltaLogWriter(log)
    with dl.DeltaLogWriter(log, base_spec="b") as w:
        with pytest.raises(ValueError, match="bad delta op"):
            w.append(_graph(4), op=9)
        with pytest.raises(ValueError, match="non-negative"):
            w.append(np.array([[-1, 2]]))
        w.append(_graph(4), epoch=5)
        with pytest.raises(ValueError, match="never rewind"):
            w.append(_graph(4), epoch=4)
        with pytest.raises(ValueError, match="logs deltas over"):
            dl.DeltaLogWriter(log, base_spec="other")


# -- the multiset algebra ------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_multiset_algebra_matches_reference(seed):
    """Dense small id ranges, so that deletes cancel adds of both
    orientations, repeat, miss, and name self-loops."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        ids = int(rng.integers(2, 12))
        m = int(rng.integers(1, 300))
        rec = np.zeros(m, dtype=dl.RECORD_DTYPE)
        rec["u"] = rng.integers(0, ids, m)
        rec["v"] = rng.integers(0, ids, m)
        rec["op"] = rng.integers(0, 2, m)
        rec["epoch"] = np.sort(rng.integers(1, 5, m))
        got, want = dl.net_effect(rec), jdl.net_effect(rec)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        adds = [rng.integers(0, ids, (int(rng.integers(0, 50)), 2))
                for _ in range(int(rng.integers(0, 4)))]
        dels = rng.integers(0, ids, (int(rng.integers(0, 60)), 2))
        got_adds, got_t = dl.cancel_adds(adds, dels)
        want_adds, want_t = jdl.cancel_adds(adds, dels)
        assert len(got_adds) == len(want_adds)
        assert all(np.array_equal(g, w) for g, w in zip(got_adds, want_adds))
        assert np.array_equal(got_t, want_t)
        chunks = [rng.integers(0, ids, (int(rng.integers(0, 40)), 2))
                  for _ in range(5)]
        tombs = rng.integers(0, ids, (int(rng.integers(0, 40)), 2))
        got_c = list(dl.filter_tombstones(chunks, tombs))
        want_c = list(jdl.filter_tombstones(chunks, tombs))
        assert len(got_c) == len(want_c)
        assert all(np.array_equal(g, w) for g, w in zip(got_c, want_c))


def test_filter_tombstones_past_32_bit_ids():
    chunks = [np.array([[5, 1 << 33], [2, 1], [1, 2]], np.int64)]
    tombs = np.array([[1 << 33, 5], [1, 2]], np.int64)
    got = list(dl.filter_tombstones(chunks, tombs))
    want = list(jdl.filter_tombstones(chunks, tombs))
    assert [g.tolist() for g in got] == [w.tolist() for w in want] \
        == [[[1, 2]]]


# -- the delta: input ------------------------------------------------------------

def test_delta_spec_matches_reference(tmp_path):
    e = _graph(4000)
    base = _base_file(tmp_path, e[:2000])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[2000:3000])
        w.append_epoch(adds=e[3000:], dels=np.concatenate([e[:30],
                                                            e[2000:2010]]))
    for spec in (f"delta:{log}", f"delta:{log}@1"):
        got = edgestream.open_input(spec)
        want = jes.open_input(spec)
        assert got.order_anchor and got.anchor_stream() is got.base
        assert (got.epoch, got.num_vertices, got.num_edges_cheap,
                got.num_edges_upper_bound) == (
            want.epoch, want.num_vertices, want.num_edges_cheap,
            want.num_edges_upper_bound)
        assert np.array_equal(got.adds, want.adds)
        assert np.array_equal(got.tombs, want.tombs)
        for g, w in zip(got.chunks(777), want.chunks(777)):
            assert np.array_equal(g, w)
        assert np.array_equal(got.read_all(), want.read_all())
        assert got.content_fingerprint() == want.content_fingerprint()
        assert list(got.chunks(777, start_chunk=3))[0].tolist() == \
            list(want.chunks(777, start_chunk=3))[0].tolist()
        assert got.clamp_chunk_edges(1 << 22) == min(
            1 << 22, max(1024, want.num_edges_upper_bound))
    with pytest.raises(ValueError, match="does not exist"):
        edgestream.open_input(f"delta:{tmp_path}/nope.dlog")
    with pytest.raises(ValueError, match="below the"):
        edgestream.open_input(f"delta:{log}", n_vertices=4)
    with pytest.raises(NotImplementedError):
        list(edgestream.open_input(f"delta:{log}").chunks(
            64, shard=0, num_shards=2))
    inner = str(tmp_path / "outer.dlog")
    dl.write_header(inner, f"delta:{log}")
    with pytest.raises(ValueError, match="do not nest"):
        edgestream.open_input(f"delta:{inner}")


@pytest.mark.parametrize("opts", [{}, {"dispatch_batch": 2, "inflight": 2}],
                         ids=["per-segment", "batched"])
def test_delta_build_matches_reference(tmp_path, opts):
    """A one-shot delta: build: the anchored order (the base's degrees),
    the partition and the scores equal the JAX package's."""
    e = _graph(4000)
    base = _base_file(tmp_path, e[:2000])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[2000:3000])
        w.append_epoch(adds=e[3000:], dels=e[:40])
    spec = f"delta:{log}"
    got = TorchBackend(device="cpu", chunk_edges=777, **opts).partition(
        edgestream.open_input(spec, n_vertices=N), 8, keep_tree=True)
    want = get_backend("tpu", chunk_edges=777, **opts).partition(
        jes.open_input(spec, n_vertices=N), 8, keep_tree=True)
    assert np.array_equal(got.tree["pos"], want.tree["pos"])
    assert np.array_equal(got.tree["deg"], want.tree["deg"])
    assert np.array_equal(got.tree["parent"], want.tree["parent"])
    assert np.array_equal(got.assignment, want.assignment)
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.diagnostics["device_rounds"] == \
        want.diagnostics["device_rounds"]
    # the anchor is the base's degrees, not the union's
    deg = np.bincount(e[:2000].ravel(), minlength=N)
    assert np.array_equal(got.tree["deg"], deg)


# -- rewrite_base and the v2 floor ---------------------------------------------

def _sorted_rows(e):
    return np.sort(np.ascontiguousarray(e).view("i8,i8"), axis=0)


def test_rewrite_base_floor_and_continuation(tmp_path):
    e = _graph(1200)
    base = _base_file(tmp_path, e[:600])
    logs = {}
    for name, mod in PKGS.items():
        log = str(tmp_path / f"{name}.dlog")
        with mod[0].DeltaLogWriter(log, base_spec=base) as w:
            w.append(e[600:900])
            w.append_epoch(dels=e[:100])
        with edgestream.open_input(f"delta:{log}", n_vertices=N) as es:
            before = _sorted_rows(es.read_all())
        nb = str(tmp_path / f"{name}.csr")
        with mod[0].DeltaLogWriter(log) as w:
            assert w.rewrite_base(nb, n_vertices=N) == nb
            assert (w.base_spec, w.epoch_floor, w.last_epoch) == (nb, 2, 2)
            w.append(e[900:1000])
            assert w.last_epoch == 3
        logs[name] = (log, nb, before)
    (log, nb, before), (jlog, jnb, _) = logs["port"], logs["jax"]
    # the rewritten base is the reference's, byte for byte
    assert open(nb, "rb").read() == open(jnb, "rb").read()
    hdr = dl.read_header(log)
    assert (hdr["version"], hdr["epoch_floor"], hdr["base_spec"]) == \
        (2, 2, nb)
    with edgestream.open_input(f"delta:{log}", n_vertices=N) as es:
        after = _sorted_rows(es.read_all())
    want = _sorted_rows(np.concatenate(
        [before.view(np.int64).reshape(-1, 2), e[900:1000]]))
    assert np.array_equal(after, want)
    r = dl.DeltaLogReader(log)
    assert r.max_epoch == 3
    assert [ep for ep, _, _ in r.epochs(start_epoch=2)] == [3]
    with pytest.raises(ValueError, match="compaction floor"):
        dl.DeltaLogStream(log, up_to=1)
    with dl.DeltaLogWriter(log) as w2:
        assert (w2.last_epoch, w2.epoch_floor) == (3, 2)
    # each package reads the other's rewritten log to the same edges
    with jes.open_input(f"delta:{log}", n_vertices=N) as es:
        assert np.array_equal(_sorted_rows(es.read_all()), after)


def test_rewrite_equals_filtered_multiset(tmp_path):
    e = _graph(800)
    dup = np.concatenate([e, e[:50]])
    base = _base_file(tmp_path, dup)
    log = str(tmp_path / "g.dlog")
    dels = np.concatenate([e[:60], e[:10], np.array([[N - 1, N - 1]])])
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append_epoch(dels=dels)
    nb = str(tmp_path / "rb.csr")
    with dl.DeltaLogWriter(log) as w:
        w.rewrite_base(nb, n_vertices=N)
    with edgestream.open_input(f"delta:{log}", n_vertices=N) as es:
        got = _sorted_rows(es.read_all())
    surv = np.concatenate(list(jdl.filter_tombstones([dup], dels)))
    assert np.array_equal(got, _sorted_rows(surv))
    # a leftover header of a crashed rewrite is ignored
    with open(log + ".rewrite.tmp", "wb") as f:
        f.write(b"torn header bytes")
    assert dl.DeltaLogReader(log).header["epoch_floor"] == 1
    with dl.DeltaLogWriter(log) as w:
        assert w.append(e[:5]) == 2


# -- damage under SHEEP_IO_POLICY ------------------------------------------------

def _damage_log(tmp_path, n_epochs=2, per=40):
    from sheep_tpu.io import formats, generators

    e = generators.random_graph(64, n_epochs * per, seed=15)
    p = str(tmp_path / "g.dlog")
    base = str(tmp_path / "base.bin64")
    formats.write_edges(base, generators.random_graph(64, 50, seed=16))
    with dl.DeltaLogWriter(p, base_spec=base) as w:
        for i in range(n_epochs):
            w.append(e[i * per: (i + 1) * per])
    return p, e


def _shrunk(monkeypatch, mod, p):
    """The log's size as a reader saw it before it shrank by a record."""
    real = os.path.getsize(p)
    monkeypatch.setattr(mod.os.path, "getsize",
                        lambda q, real=real: real + 24 if q == p
                        else os.stat(q).st_size)


@pytest.mark.parametrize("damage", ["torn1", "torn7", "torn23", "short",
                                    "rewind"])
@pytest.mark.parametrize("policy", ["strict", "quarantine"])
def test_damage_contract(tmp_path, monkeypatch, damage, policy):
    """Each package's reader on the same damaged log: strict raises its
    package's CorruptStreamError; quarantine keeps the same intact
    prefix."""
    p, e = _damage_log(tmp_path)
    if damage.startswith("torn"):
        with open(p, "ab") as f:
            f.write(b"\xff" * int(damage[4:]))
        want = e
    elif damage == "short":
        _shrunk(monkeypatch, dl, p)
        _shrunk(monkeypatch, jdl, p)
        want = e
    else:
        hdr = dl.read_header(p)
        recs = np.fromfile(p, dtype=dl.RECORD_DTYPE,
                           offset=hdr["header_len"])
        recs["epoch"][40:] = 0
        with open(p, "r+b") as f:
            f.seek(hdr["header_len"])
            f.write(recs.tobytes())
        want = e[:40]
    monkeypatch.setenv("SHEEP_IO_POLICY", policy)
    if policy == "strict":
        with pytest.raises(edgestream.CorruptStreamError):
            dl.DeltaLogReader(p).records()
        with pytest.raises(jes.CorruptStreamError):
            jdl.DeltaLogReader(p).records()
        return
    got = _rows(dl.DeltaLogReader(p).records())
    assert np.array_equal(got, _rows(jdl.DeltaLogReader(p).records()))
    assert np.array_equal(got, want)


def test_quarantined_delta_build_equals_intact_prefix(tmp_path, monkeypatch):
    p, _ = _damage_log(tmp_path)

    def build():
        return TorchBackend(device="cpu", chunk_edges=64).partition(
            edgestream.open_input(f"delta:{p}"), 4, comm_volume=False)

    intact = build()
    with open(p, "ab") as f:
        f.write(b"\xee" * 9)
    monkeypatch.setenv("SHEEP_IO_POLICY", "quarantine")
    torn = build()
    ref = get_backend("tpu", chunk_edges=64).partition(
        jes.open_input(f"delta:{p}"), 4, comm_volume=False)
    assert np.array_equal(torn.assignment, intact.assignment)
    assert np.array_equal(torn.assignment, ref.assignment)


# -- io/csr.py: write_csr, the adjacency and the tool --------------------------

@pytest.mark.parametrize("case", ["plain", "dups-loops", "chunked", "empty"])
def test_write_csr_bytes_match_reference(tmp_path, case):
    e = _graph(3000)
    if case == "dups-loops":
        e = np.concatenate([e, e[:200], np.array([[7, 7], [7, 7]])])
    if case == "empty":
        e = np.zeros((0, 2), np.int64)
    kw = {"chunk_edges": 500} if case == "chunked" else {}
    a, b = str(tmp_path / "a.csr"), str(tmp_path / "b.csr")
    h = csr.write_csr(a, edgestream.EdgeStream.from_array(e, n_vertices=N),
                      **kw)
    jcsr.write_csr(b, jes.EdgeStream.from_array(e, n_vertices=N), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert (h.n_vertices, h.n_edges) == (N, len(e))
    g, jg = csr.CsrGraph(a), jcsr.CsrGraph(b)
    for u in (0, 7, N - 1):
        assert np.array_equal(g.neighbors(u), jg.neighbors(u))
    vs = np.array([3, 7, 7, 100, N - 1])
    for x, y in zip(g.arcs_from(vs), jg.arcs_from(vs)):
        assert np.array_equal(x, y)
    assert all(len(x) == 0 for x in g.arcs_from(np.zeros(0, np.int64)))
    with pytest.raises(ValueError, match="out of range"):
        csr.write_csr(a, edgestream.EdgeStream.from_array(
            np.array([[0, N]]), n_vertices=N))


def test_csr_tool_matches_reference(tmp_path, capsys):
    src = _base_file(tmp_path, _graph(2000))
    a, b = str(tmp_path / "a.csr"), str(tmp_path / "b.csr")
    assert csr.main([src, a, str(N)]) == 0
    assert jcsr.main([src, b, str(N)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(a, "X") == out[1].replace(b, "X")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert csr.main([src]) == 2
