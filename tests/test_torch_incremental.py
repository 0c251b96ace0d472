"""The port's incremental repartitioning (``sheep_tpu_torch/incremental.py``,
the backend's ``_fold_delta`` and ``partition_update``, ``--deltas``)
against the JAX package's ``tpu`` backend on the CPU, with zero tolerance,
at the sizes of ``tests/test_incremental.py`` (N = 512, m = 4000, chunks of
777 edges).

- The two-halves replay: the port's resident table, assignment, scores and
  epoch equal the JAX package's, each equals its one-shot build of the
  ``delta:`` log, and the folds count the same rounds.
- Snapshots: each package loads the other's and folds on to the same
  result.
- Idempotent epochs, the vertex-space guard, deletes with full compaction
  against a clean rebuild, subtree compaction equal to the JAX package's
  and inside its bound, the staleness counter, the no-op compaction.
- Incremental rescoring equal to the full pass under
  ``SHEEP_SCORE_AUDIT=1``, which catches a poisoned cache; a comm-volume
  refresh takes the full pass.
- ``--deltas`` through both CLIs: the same JSON numbers and partition map,
  and the same refusals."""

import json

import numpy as np
import pytest
import torch

from sheep_tpu import cli as jcli
from sheep_tpu import incremental as jinc
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import deltalog as jdl
from sheep_tpu.io import edgestream as jes

import sheep_tpu_torch
from sheep_tpu_torch import cli, incremental as inc
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import deltalog as dl, edgestream

N = 512
CS = 777
SCORES = ("edge_cut", "total_edges", "cut_ratio", "balance", "comm_volume")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU builds beside other test workers: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(m=4000, n=N, seed=5):
    return np.random.default_rng(seed).integers(0, n, (m, 2)).astype(
        np.int64)


def _base_file(tmp_path, edges, name="base.bin64"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(np.asarray(edges, np.int64).astype("<u8").tobytes())
    return p


def _pair(opts=None, cs=CS):
    """(port backend on the CPU, JAX tpu backend) with the same knobs."""
    opts = opts or {}
    return (TorchBackend(device="cpu", chunk_edges=cs, **opts),
            get_backend("tpu", chunk_edges=cs, **opts))


def _begin(be, jbe, base, ks):
    st, _ = inc.begin_incremental(edgestream.open_input(base, n_vertices=N),
                                  ks, backend=be)
    jst, _ = jinc.begin_incremental(jes.open_input(base, n_vertices=N), ks,
                                    backend=jbe)
    return st, jst


def _same_state(st, jst):
    assert np.array_equal(st.minp, jst.minp)
    assert np.array_equal(st.pos, jst.pos)
    assert np.array_equal(st.deg_anchor, jst.deg_anchor)
    for key in ("epoch", "total_edges", "stale_deletes", "compactions",
                "anchored_at_epoch"):
        assert getattr(st, key) == getattr(jst, key), key
    assert np.array_equal(st.adds_array(), jst.adds_array())
    assert np.array_equal(st.tomb_array(), jst.tomb_array())


def _same(r, jr):
    rs = r if isinstance(r, list) else [r]
    jrs = jr if isinstance(jr, list) else [jr]
    assert len(rs) == len(jrs)
    for a, b in zip(rs, jrs):
        assert a.k == b.k
        assert np.array_equal(a.assignment, b.assignment)
        for key in SCORES:
            assert getattr(a, key) == getattr(b, key), key
        assert a.diagnostics["epoch"] == b.diagnostics["epoch"]


def _minp_of(res, n=N):
    return inc._minp_from_parent(res.tree["parent"],
                                 np.asarray(res.tree["pos"], np.int64), n)


# -- the exactness of adds -------------------------------------------------------

@pytest.mark.parametrize("opts", [{}, {"dispatch_batch": 2, "inflight": 2}],
                         ids=["auto", "batched"])
def test_two_halves_replay_bit_identical(tmp_path, opts):
    e = _graph()
    half = len(e) // 2
    base = _base_file(tmp_path, e[:half])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[half: half + 1000])
        w.append(e[half + 1000:])
    be, jbe = _pair(opts)
    spec = f"delta:{log}"
    one = be.partition(edgestream.open_input(spec, n_vertices=N), 8,
                       comm_volume=False, keep_tree=True)
    jone = jbe.partition(jes.open_input(spec, n_vertices=N), 8,
                         comm_volume=False, keep_tree=True)
    st, jst = _begin(be, jbe, base, 8)
    assert be.partition_update(st, adds=e[half: half + 1000],
                               score=False) is None
    jbe.partition_update(jst, adds=e[half: half + 1000], score=False)
    r = be.partition_update(st, adds=e[half + 1000:], score=True)
    jr = jbe.partition_update(jst, adds=e[half + 1000:], score=True)
    assert st.epoch == 2
    _same_state(st, jst)
    _same(r, jr)
    assert st.stats["update_rounds"] == jst.stats["update_rounds"] > 0
    assert st.stats["host_syncs"] == jst.stats["host_syncs"]
    # each against its one-shot build of the log at epoch 2
    for state, res, oneshot in ((st, r, one), (jst, jr, jone)):
        assert np.array_equal(state.minp, _minp_of(oneshot))
        assert np.array_equal(res.assignment, oneshot.assignment)
        assert (res.edge_cut, res.total_edges, res.balance) == \
            (oneshot.edge_cut, oneshot.total_edges, oneshot.balance)
    # a state begun from the log itself resumes at its epoch
    st2, _ = inc.begin_incremental(
        edgestream.open_input(spec, n_vertices=N), 8, backend=be)
    jst2, _ = jinc.begin_incremental(
        jes.open_input(spec, n_vertices=N), 8, backend=jbe)
    assert st2.epoch == jst2.epoch == 2
    assert st2.base_spec == jst2.base_spec == base
    _same_state(st2, jst2)


def test_delete_never_cancels_a_later_add(tmp_path):
    e = _graph(600)
    base = _base_file(tmp_path, e[:300])
    absent = np.array([[N - 1, N - 2]], np.int64)
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append_epoch(dels=absent)
        w.append(absent)
        w.append(e[300:])
    be, jbe = _pair()
    one = be.partition(edgestream.open_input(f"delta:{log}", n_vertices=N),
                       4, comm_volume=False)
    st, jst = _begin(be, jbe, base, 4)
    out = []
    for b, s in ((be, st), (jbe, jst)):
        b.partition_update(s, deletes=absent, epoch=1, score=False,
                           compact="never")
        b.partition_update(s, adds=absent, epoch=2, score=False)
        out.append(b.partition_update(s, adds=e[300:], epoch=3))
    _same_state(st, jst)
    _same(*out)
    assert np.array_equal(out[0].assignment, one.assignment)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_load_across_packages(tmp_path, writer):
    e = _graph()
    half = len(e) // 2
    base = _base_file(tmp_path, e[:half])
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 8)
    for b, s in ((be, st), (jbe, jst)):
        b.partition_update(s, adds=e[half:-500], score=False)
        b.partition_update(s, deletes=e[:100], score=False, compact="never")
    _same_state(st, jst)
    a, b_ = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    inc.save_state(st, a)
    jinc.save_state(jst, b_)
    with np.load(a) as za, np.load(b_) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            if key != "meta":
                assert za[key].dtype == zb[key].dtype, key
                assert np.array_equal(za[key], zb[key]), key
    # the other package's snapshot, folded on by this one's backend
    if writer == "port":
        loaded, jloaded = inc.load_state(b_), jinc.load_state(a)
    else:
        loaded, jloaded = inc.load_state(a), jinc.load_state(b_)
    assert loaded.epoch == jloaded.epoch == st.epoch
    _same_state(loaded, st)
    _same_state(jloaded, jst)
    r = be.partition_update(loaded, adds=e[-500:], compact="never")
    jr = jbe.partition_update(jloaded, adds=e[-500:], compact="never")
    r0 = be.partition_update(st, adds=e[-500:], compact="never")
    _same(r, jr)
    _same(r, r0)
    _same_state(loaded, jloaded)


def test_epoch_idempotency_and_vertex_space_guard(tmp_path):
    e = _graph()
    base = _base_file(tmp_path, e[:2000])
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 4)
    r = be.partition_update(st, adds=e[2000:2100], epoch=1)
    jr = jbe.partition_update(jst, adds=e[2000:2100], epoch=1)
    _same(r, jr)
    # a replayed epoch is a no-op
    assert be.partition_update(st, adds=e[2000:2100], epoch=1) is None
    assert st.epoch == 1 and st.stats["updates"] == 1
    with pytest.raises(ValueError, match="outside the resident"):
        be.partition_update(st, adds=np.array([[0, N + 7]]))
    with pytest.raises(ValueError, match="bad compact mode"):
        be.partition_update(st, adds=e[:4], compact="later")
    with pytest.raises(ValueError, match="bad compact mode"):
        inc.compact_state(be, st, mode="later")
    _same_state(st, jst)


# -- deletes and compaction ------------------------------------------------------

def test_delete_full_compact_matches_clean_rebuild(tmp_path):
    e = _graph()
    base = _base_file(tmp_path, e[:2000])
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 8)
    dels = e[np.random.default_rng(9).permutation(len(e))[:600]]
    stale = []
    for b, s in ((be, st), (jbe, jst)):
        b.partition_update(s, adds=e[2000:], score=False)
        stale.append(b.partition_update(s, deletes=dels, compact="never"))
    _same(*stale)
    assert st.stale_deletes == 600
    assert inc.compact_state(be, st, mode="full") == "full"
    assert jinc.compact_state(jbe, jst, mode="full") == "full"
    _same_state(st, jst)
    assert st.stale_deletes == 0 and st.anchored_at_epoch == st.epoch
    r, jr = inc.refresh(be, st), jinc.refresh(jbe, jst)
    _same(r, jr)
    surv = np.concatenate(list(jdl.filter_tombstones([e], dels)))
    clean = be.partition(edgestream.EdgeStream.from_array(surv, n_vertices=N),
                         8, comm_volume=False, keep_tree=True)
    assert np.array_equal(st.minp, _minp_of(clean))
    assert np.array_equal(r.assignment, clean.assignment)
    assert (r.edge_cut, r.total_edges) == (clean.edge_cut, clean.total_edges)
    assert stale[0].total_edges == clean.total_edges


def test_subtree_compact_matches_reference_and_bound(tmp_path):
    e = _graph(6000)
    base = _base_file(tmp_path, e[:3000])
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 8)
    for b, s in ((be, st), (jbe, jst)):
        b.partition_update(s, adds=e[3000:], score=False)
        b.partition_update(s, deletes=e[:30], score=False, compact="never")
    assert inc.compact_state(be, st, mode="subtree") == "subtree"
    assert jinc.compact_state(jbe, jst, mode="subtree") == "subtree"
    _same_state(st, jst)
    assert st.stats["compact_refolded_edges"] == \
        jst.stats["compact_refolded_edges"]
    assert 0 < st.stats["compact_refolded_edges"] < len(e)
    assert st.stats["update_rounds"] == jst.stats["update_rounds"]
    r, jr = inc.refresh(be, st), jinc.refresh(jbe, jst)
    _same(r, jr)
    surv = np.concatenate(list(jdl.filter_tombstones([e], e[:30])))
    clean = be.partition(edgestream.EdgeStream.from_array(surv, n_vertices=N),
                         8, comm_volume=False)
    assert r.total_edges == clean.total_edges
    assert r.cut_ratio <= clean.cut_ratio + 0.05


@pytest.mark.parametrize("case", ["staleness", "noop", "auto"])
def test_compaction_triggers(tmp_path, case):
    e = _graph(4000 if case != "noop" else 1000)
    base = _base_file(tmp_path, e)
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 8)
    if case == "noop":
        assert inc.compact_state(be, st) == "noop"
        assert jinc.compact_state(jbe, jst) == "noop"
        assert st.compactions == 0
        return
    if case == "staleness":
        st.compact_threshold = jst.compact_threshold = 50
        for b, s in ((be, st), (jbe, jst)):
            b.partition_update(s, deletes=e[:40], score=False)
        assert st.compactions == 0
        for b, s in ((be, st), (jbe, jst)):
            b.partition_update(s, deletes=e[40:100], score=False)
        assert st.compactions == 1 and st.stale_deletes == 0
    else:
        # force compaction in auto mode: subtree while few parts are dirty
        modes = [inc.compact_state, jinc.compact_state]
        for b, s in ((be, st), (jbe, jst)):
            b.partition_update(s, deletes=e[:3], score=False,
                               compact="never")
        assert modes[0](be, st) == modes[1](jbe, jst)
    _same_state(st, jst)
    _same(inc.refresh(be, st), jinc.refresh(jbe, jst))


# -- incremental scoring ---------------------------------------------------------

def test_incremental_rescore_bit_equals_full(tmp_path, monkeypatch):
    """Add, delete and compaction churn under SHEEP_SCORE_AUDIT, each
    rescore checked against the full pass; then the cache dropped: the
    full pass's results equal the incremental ones, and the JAX package's
    at every epoch."""
    monkeypatch.setenv("SHEEP_SCORE_AUDIT", "1")
    e = _graph(4000)
    base = _base_file(tmp_path, e[:2000])
    be, jbe = _pair(cs=512)
    st, jst = _begin(be, jbe, base, [4, 8])
    _same(inc.refresh(be, st), jinc.refresh(jbe, jst))
    rng = np.random.default_rng(11)
    adds1 = rng.integers(0, N, (700, 2)).astype(np.int64)
    adds1[:6] = adds1[6:12]        # duplicate adds
    adds1[20, 1] = adds1[20, 0]    # a self-loop
    dels = np.concatenate([
        e[100:160], e[100:110],    # base hits, and repeated deletes
        adds1[:30],                # cancelling pending adds
        np.array([[0, 0]], np.int64),
        rng.integers(0, N, (20, 2)),
    ]).astype(np.int64)
    steps = [dict(adds=adds1), dict(deletes=dels, compact="never"),
             dict(adds=rng.integers(0, N, (400, 2)), compact="force"),
             dict(adds=rng.integers(0, N, (200, 2)))]
    for kw in steps:
        r = be.partition_update(st, **kw)
        _same(r, jbe.partition_update(jst, **kw))
    _same_state(st, jst)
    assert st.stats["score_incremental"] == \
        jst.stats["score_incremental"] >= 3
    st._score = None
    full = inc.refresh(be, st)
    for a, b in zip(r, full):
        assert (a.k, a.edge_cut, a.total_edges, a.balance, a.cut_ratio) == \
            (b.k, b.edge_cut, b.total_edges, b.balance, b.cut_ratio)
        assert np.array_equal(a.assignment, b.assignment)


@pytest.mark.parametrize("gather_arcs", [1 << 24, 7])
def test_tombstone_firing_matches_reference(tmp_path, monkeypatch,
                                            gather_arcs):
    """The survivor index's multiplicities and the tombstones that fire,
    batch after batch, against the reference's one-at-a-time walk; a
    small gather budget splits the lookups into many batches."""
    monkeypatch.setattr(inc, "_GATHER_ARCS", gather_arcs)
    rng = np.random.default_rng(3)
    e = rng.integers(0, 40, (600, 2)).astype(np.int64)
    e = np.concatenate([e, e[:80], [[5, 5], [5, 5], [7, 7]]])
    base = _base_file(tmp_path, e)
    be, jbe = _pair(cs=128)
    st, jst = _begin(be, jbe, base, 4)
    index, jindex = inc._SurvivorIndex(st), jinc._SurvivorIndex(jst)
    keys = rng.integers(0, 45, (300, 2))
    got = index.multiplicities(keys[:, 0], keys[:, 1])
    assert got.tolist() == [jindex.multiplicity(int(a), int(b))
                            for a, b in keys.tolist()]
    fired, jfired = {}, {}
    for _ in range(3):
        tombs = np.concatenate([e[rng.integers(0, len(e), 200)],
                                rng.integers(0, 45, (50, 2)),
                                [[5, 5]]])
        hit = inc._fire(fired, index, tombs)
        want = []
        for a, b in tombs.tolist():  # the reference's walk
            key = (min(a, b), max(a, b))
            f = jfired.get(key, 0)
            ok = a != b and f < jindex.multiplicity(a, b)
            if ok:
                jfired[key] = f + 1
            want.append(ok)
        assert hit.tolist() == want
        assert fired == jfired
    index.drop()
    jindex.drop()


def test_audit_catches_a_poisoned_cache(tmp_path, monkeypatch):
    e = _graph(2000)
    base = _base_file(tmp_path, e)
    be = TorchBackend(device="cpu", chunk_edges=512)
    st, _ = inc.begin_incremental(edgestream.open_input(base, n_vertices=N),
                                  4, backend=be)
    inc.refresh(be, st)
    assert st._score is not None and "prev" in st._score
    st._score["cut"][4] += 1
    monkeypatch.setenv("SHEEP_SCORE_AUDIT", "1")
    with pytest.raises(RuntimeError, match="SHEEP_SCORE_AUDIT"):
        inc.refresh(be, st)


def test_comm_volume_requests_run_the_full_pass(tmp_path):
    e = _graph(1500)
    base = _base_file(tmp_path, e)
    be, jbe = _pair(cs=512)
    st, jst = _begin(be, jbe, base, 4)
    inc.refresh(be, st)
    f0 = st.stats["score_full"]
    r = inc.refresh(be, st, comm_volume=True)
    jr = jinc.refresh(jbe, jst, comm_volume=True)
    assert st.stats["score_full"] == f0 + 1
    assert r.comm_volume is not None
    _same(r, jr)
    i0 = st.stats.get("score_incremental", 0)
    inc.refresh(be, st)
    assert st.stats["score_incremental"] == i0 + 1


def test_rebase_and_exports(tmp_path):
    e = _graph()
    base = _base_file(tmp_path, e[:2000])
    be, jbe = _pair()
    st, jst = _begin(be, jbe, base, 4)
    for b, s in ((be, st), (jbe, jst)):
        b.partition_update(s, adds=e[2000:3000], score=False)
        b.partition_update(s, deletes=e[:50], score=True)
    out = str(tmp_path / "port.csr")
    jout = str(tmp_path / "jax.csr")
    assert inc.rebase_state(be, st, out) == out
    jinc.rebase_state(jbe, jst, jout)
    assert open(out, "rb").read() == open(jout, "rb").read()
    assert st._score is None and not st.adds and not st.tombs
    for b, s in ((be, st), (jbe, jst)):
        assert b.partition_update(s, adds=e[3000:]) is not None
    _same_state(st, jst)
    _same(inc.refresh(be, st), jinc.refresh(jbe, jst))
    for name in ("begin_incremental", "apply_update", "refresh",
                 "compact_state", "save_state", "load_state"):
        assert getattr(sheep_tpu_torch, name) is getattr(inc, name)
    with pytest.raises(AttributeError):
        sheep_tpu_torch.no_such_entry


def _spans_and_events(path):
    """(span name, attributes) in start order, and (event, fields) of the
    incremental path's events, from a trace; timing keys and the backend's
    name dropped."""
    spans, events = [], []
    for line in open(path):
        r = json.loads(line)
        if r["event"] == "span_start":
            spans.append((r["span"], {k: v for k, v in r.items() if k not in (
                "event", "ts", "span", "id", "parent", "backend")}))
        elif r["event"] in ("delta_epoch_applied", "compacted"):
            events.append({k: v for k, v in r.items() if k != "ts"})
    return spans, events


def test_spans_and_events_match_jax(tmp_path):
    """The incremental path traced on both packages: the same
    ``partition_update`` and ``compact`` spans with their fields, nested
    builds and folds, and the same ``delta_epoch_applied`` and
    ``compacted`` events."""
    from sheep_tpu import obs as jobs

    from sheep_tpu_torch import obs

    e = _graph()
    base = _base_file(tmp_path, e[:2000])
    be, jbe = _pair()
    traces = []
    for b, mod, ob in ((be, inc, obs), (jbe, jinc, jobs)):
        path = str(tmp_path / f"{b.name}.jsonl")
        with ob.tracing(path):
            st, _ = mod.begin_incremental(
                (edgestream if mod is inc else jes).open_input(
                    base, n_vertices=N), 8, backend=b)
            b.partition_update(st, adds=e[2000:3000], score=False)
            b.partition_update(st, deletes=e[:20], compact="force")
            b.partition_update(st, deletes=e[20:25], score=False,
                               compact="never")
            mod.compact_state(b, st, mode="subtree")
        traces.append(_spans_and_events(path))
    assert traces[0] == traces[1]
    names = [name for name, _ in traces[0][0]]
    assert names.count("partition_update") == 3
    assert names.count("compact") == 2
    assert [ev["event"] for ev in traces[0][1]] == [
        "delta_epoch_applied", "compacted", "delta_epoch_applied",
        "delta_epoch_applied", "compacted"]


# -- the CLI -------------------------------------------------------------------------

def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("extra", [[], ["--no-comm-volume"],
                                   ["--weights", "degree"]],
                         ids=["cv", "no-cv", "degree"])
def test_cli_deltas_matches_jax(tmp_path, capsys, extra):
    e = _graph()
    half = len(e) // 2
    base = _base_file(tmp_path, e[:half])
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[half:-700])
        w.append_epoch(adds=e[-700:], dels=e[:20])
    out = str(tmp_path / "p.parts")
    argv = ["--input", base, "--k", "4", "--num-vertices", str(N),
            "--chunk-edges", str(CS), "--deltas", log, "--output", out,
            *extra]
    assert jcli.main([*argv, "--backend", "tpu"]) == 0
    ref = capsys.readouterr()
    want_map = open(out, "rb").read()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert open(out, "rb").read() == want_map
    g, w = _json_lines(got.out)[-1], _json_lines(ref.out)[-1]
    for key in ("k", "edge_cut", "total_edges", "cut_ratio", "balance",
                "comm_volume", "n_vertices"):
        assert g[key] == w[key], key
    for key in ("epoch", "stale_deletes", "compactions", "updates",
                "delta_adds", "delta_deletes", "update_rounds"):
        assert g["diagnostics"][key] == w["diagnostics"][key], key
    note = [line for line in got.out.splitlines()
            if line.startswith("deltas:")]
    assert note == [line for line in ref.out.splitlines()
                    if line.startswith("deltas:")]
    assert note[0].endswith("-> epoch 2 (stale deletes 20, compactions 0)")
    # the one-shot delta: build through the CLI gives the same numbers
    assert cli.main(["--input", f"delta:{log}", "--k", "4",
                     "--num-vertices", str(N), "--chunk-edges", str(CS),
                     "--device", "cpu", "--json", *extra]) == 0
    one = _json_lines(capsys.readouterr().out)[-1]
    # the deletes are tombstones until a compaction, so the replay's tree
    # is not the one-shot's; the surviving multiset is the same
    assert one["total_edges"] == g["total_edges"]


@pytest.mark.parametrize("extra", [["--refine", "2"], ["--k", "4,8"],
                                   ["--checkpoint-dir", "CK"],
                                   ["--auto-recipe"], ["--resume"],
                                   ["--k-levels", "2,2"],
                                   ["--score-only", "P"], ["missing"]])
def test_cli_deltas_validation_matches_jax(tmp_path, capsys, extra):
    e = _graph(100)
    base = _base_file(tmp_path, e)
    log = str(tmp_path / "g.dlog")
    with dl.DeltaLogWriter(log, base_spec=base) as w:
        w.append(e[:10])
    argv = ["--input", base, "--k", "4", "--deltas", log]
    if extra == ["missing"]:
        argv[-1] = str(tmp_path / "missing.dlog")
    elif extra[0] in ("--k", "--k-levels"):
        argv = ["--input", base, "--deltas", log, *extra]
    else:
        argv += [x.replace("CK", str(tmp_path / "ck")) for x in extra]
    if extra[0] == "--resume":
        argv += ["--checkpoint-dir", str(tmp_path / "ck")]
    errors = []
    for main, more in ((jcli.main, ["--backend", "tpu"]),
                       (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main([*argv, *more])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ", 1)[1] == errors[1].split("error: ", 1)[1]
