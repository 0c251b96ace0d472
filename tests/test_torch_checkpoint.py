"""The port's checkpoint and resume (``sheep_tpu_torch/utils/checkpoint.py``,
the backend's save points, the hierarchy's level checkpoints and the CLI's
flags) against the JAX package's ``tpu`` backend on the CPU.

A run killed by ``SHEEP_FAULT_INJECT`` in each phase and resumed gives the
uninterrupted partition on both build drivers (per segment, per segment
with ``carry_tail`` or ``tail_overlap``, batched at N = D = 2); the port's
checkpoint at the kill point equals the reference's (phase, chunk,
fingerprint, every array and dtype), and a checkpoint of either package
resumes in the other to the same result. Corrupt, torn and missing checkpoints degrade as the
reference's do. Both packages read the same environment variable, so each
run arms it around one call and resets both packages' fault state."""

import json
import os

import numpy as np
import pytest

from sheep_tpu import cli as jcli
from sheep_tpu.backends.base import get_backend
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.utils import checkpoint as jck
from sheep_tpu.utils import fault as jfault

import sheep_tpu
import sheep_tpu_torch
from sheep_tpu_torch import cli, hierarchy
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.utils import checkpoint
from sheep_tpu_torch.utils import fault

SPEC = "rmat-hash:11:8:3"
K = 8
CS = 2048  # 8 chunks
DRIVERS = {"per-segment": {}, "carry-tail": {"carry_tail": True},
           "tail-overlap": {"tail_overlap": True},
           "batched": {"dispatch_batch": 2, "inflight": 2}}
SCORES = ("edge_cut", "total_edges", "comm_volume", "balance")


def _arm(monkeypatch, spec):
    jfault.reset()
    fault.reset()
    if spec is None:
        monkeypatch.delenv(fault.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(fault.ENV_VAR, spec)


def _jax_run(opts, ck=None, resume=False, spec=SPEC):
    with jes.open_input(spec) as s:
        return get_backend("tpu", chunk_edges=CS, **opts).partition(
            s, K, checkpointer=ck, resume=resume)


def _port_run(opts, ck=None, resume=False, spec=SPEC):
    with edgestream.open_input(spec) as s:
        return TorchBackend(device="cpu", chunk_edges=CS, **opts).partition(
            s, K, checkpointer=ck, resume=resume)


def _same(got, want):
    assert np.array_equal(got.assignment, want.assignment)
    for key in SCORES:
        assert getattr(got, key) == getattr(want, key), key


@pytest.fixture(scope="module")
def uninterrupted():
    """The uninterrupted run of each driver, on both packages."""
    out = {}
    for name, opts in DRIVERS.items():
        ref = _jax_run(opts)
        got = _port_run(opts)
        _same(got, ref)
        out[name] = got
    return out


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("point,phase,chunk", [
    ("degrees:3", "degrees", 2), ("build:5", "build", 4),
    ("score:3", "score", 2)], ids=["degrees", "build", "score"])
def test_kill_resume_matches_jax(tmp_path, monkeypatch, uninterrupted,
                                 driver, point, phase, chunk):
    """Killed in ``phase`` with a checkpoint every 2 chunks: the same step
    on both packages, equal arrays and fingerprints; each package resumes
    its own and the other's checkpoint to the uninterrupted partition."""
    opts = DRIVERS[driver]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for run, ck in ((_jax_run, jck.Checkpointer(jdir, every=2)),
                    (_port_run, checkpoint.Checkpointer(tdir, every=2))):
        _arm(monkeypatch, point)
        with pytest.raises(RuntimeError, match="injected fault"):
            run(opts, ck)
    _arm(monkeypatch, None)
    want = jck.Checkpointer(jdir, every=2).load()
    got = checkpoint.Checkpointer(tdir, every=2).load()
    assert (got.phase, got.chunk_idx) == (want.phase, want.chunk_idx) \
        == (phase, chunk)
    assert got.meta == want.meta
    assert sorted(got.arrays) == sorted(want.arrays)
    for key, arr in want.arrays.items():
        assert got.arrays[key].dtype == arr.dtype, key
        assert np.array_equal(got.arrays[key], arr), key
    if driver == "carry-tail" and phase == "build":
        assert "carry_lo" in got.arrays and "carry_hi" in got.arrays
    # each package resumes the other's checkpoint
    _same(_port_run(opts, checkpoint.Checkpointer(jdir, every=2), True),
          uninterrupted[driver])
    _same(_jax_run(opts, jck.Checkpointer(tdir, every=2), True),
          uninterrupted[driver])
    # a run that succeeds clears its checkpoint
    assert checkpoint.Checkpointer(jdir).load() is None
    assert jck.Checkpointer(tdir).load() is None


def test_kill_inside_a_group_saves_at_the_flush(tmp_path, monkeypatch):
    """The batched build at N = D = 2 killed at a chunk inside a group
    saves only at the pipeline's flush barrier: the port's steps equal the
    reference's at every save before the kill, and the resume equals the
    uninterrupted run."""
    opts = DRIVERS["batched"]
    seen = {}
    for name, mod, run in (("jax", jck, _jax_run),
                           ("port", checkpoint, _port_run)):
        steps = []

        class Spy(mod.Checkpointer):
            def save(self, phase, idx, arrays, meta=None):
                if phase == "build":
                    steps.append((idx, arrays["minp"].copy()))
                super().save(phase, idx, arrays, meta)

        _arm(monkeypatch, "build:7")
        with pytest.raises(RuntimeError, match="injected fault"):
            run(opts, Spy(str(tmp_path / name), every=2))
        seen[name] = steps
    _arm(monkeypatch, None)
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["jax"]]
    assert seen["port"]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert np.array_equal(a, b)
    _same(_port_run(opts, checkpoint.Checkpointer(str(tmp_path / "port"),
                                                  every=2), True),
          _jax_run(opts))


def test_stream_meta_matches_jax(tmp_path):
    """The fingerprint, key for key, of every kind of stream."""
    e = jgen.rmat_hash_range(9, 0, 4 << 9, seed=2)
    paths = []
    for name in ("g.bin32", "g.edges"):
        paths.append(str(tmp_path / name))
        jformats.write_edges(paths[-1], e)
    specs = paths + ["rmat-hash:10:8:3", "sbm-hash:10:8:0.05:8:3",
                     "plsbm-hash:10:8:0.05:8:3",
                     "bipartite-hash:10:8:0.05:8:3",
                     "nearclique-hash:10:3:0.02:8:3", "rmat:9:4:2"]
    kw = dict(k=4, chunk_edges=1024, weights="degree", alpha=0.5,
              comm_volume=False, state_format="minp")
    for spec in specs:
        with jes.open_input(spec) as a, edgestream.open_input(spec) as b:
            assert checkpoint.stream_meta(b, **kw) == \
                jck.stream_meta(a, **kw), spec
    arr = np.asarray(e, np.int64)
    assert checkpoint.stream_meta(
        edgestream.EdgeStream.from_array(arr, n_vertices=1 << 9), **kw) == \
        jck.stream_meta(jes.EdgeStream.from_array(arr, n_vertices=1 << 9),
                        **kw)


def test_checkpointer_files_match_jax(tmp_path):
    """The same saves leave the same files, manifests and cadence."""
    out = []
    for mod in (jck, checkpoint):
        d = str(tmp_path / mod.__name__.split(".")[0])
        ck = mod.Checkpointer(d, every=3)
        for i in (3, 6, 9):
            ck.save("build", i, {"minp": np.arange(5, dtype=np.int32) + i},
                    {"k": 4})
        with open(ck._manifest_path) as f:
            manifest = json.load(f)
        out.append((sorted(os.listdir(d)), manifest,
                    [ck.due(i) for i in range(8)],
                    [ck.due_span(a, b) for a in range(5) for b in range(a, 8)],
                    ck.load().chunk_idx))
        child = ck.child("level0")
        assert child.dir == os.path.join(d, "level0") and \
            not child.auto_clear
        ck.clear()
        assert ck.load() is None and not [f for f in os.listdir(d)
                                          if f.endswith(".npz")]
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        checkpoint.Checkpointer(str(tmp_path / "x"), every=0)


@pytest.mark.parametrize("chunks", [[], [[5, 1, 5]], [[1, 2, 2]], [[1, 4, 9]],
                                    [[9, 1], [1, 4]]])
def test_compact_cv_keys_matches_jax(chunks):
    """The comm-volume key compaction (one strictly increasing array, the
    device's ``torch.unique``, is taken as it is) equals the reference's."""
    arrays = [np.asarray(c, np.int64) for c in chunks]
    got = checkpoint.compact_cv_keys(arrays)
    want = jck.compact_cv_keys(arrays)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _truncate_half(path):
    with open(path, "r+b") as f:
        f.truncate(max(1, os.path.getsize(path) // 2))


@pytest.mark.parametrize("damage", ["latest", "missing", "all", "manifest",
                                    "version"])
def test_damaged_checkpoints_degrade_as_jax(tmp_path, capsys, damage):
    """A truncated or missing latest step falls back to the previous one;
    every step truncated, a torn manifest or another format version start
    clean; each is warned and counted, never raised."""
    out = []
    for mod in (jck, checkpoint):
        d = str(tmp_path / mod.__name__.split(".")[0])
        ck = mod.Checkpointer(d, every=1)
        ck.save("build", 1, {"deg": np.arange(4, dtype=np.int64)}, {"k": 4})
        ck.save("build", 2, {"deg": np.arange(4, dtype=np.int64) * 2},
                {"k": 4})
        with open(ck._manifest_path) as f:
            manifest = json.load(f)
        if damage == "latest":
            _truncate_half(os.path.join(d, manifest["data"]))
        elif damage == "missing":
            os.remove(os.path.join(d, manifest["data"]))
        elif damage == "all":
            for name in os.listdir(d):
                if name.endswith(".npz"):
                    _truncate_half(os.path.join(d, name))
        elif damage == "manifest":
            _truncate_half(ck._manifest_path)
        else:
            manifest["version"] = 2
            with open(ck._manifest_path, "w") as f:
                json.dump(manifest, f)
        before = mod.degraded_events()
        state = ck.load()
        out.append((None if state is None else
                    (state.chunk_idx, state.arrays["deg"].tolist()),
                    mod.degraded_events() - before,
                    capsys.readouterr().err.replace("sheep_tpu_torch",
                                                    "sheep_tpu")
                    .replace(os.path.join(str(tmp_path), "sheep_tpu_torch"),
                             os.path.join(str(tmp_path), "sheep_tpu"))))
    assert out[0] == out[1]
    assert out[1][1] >= 1 and "checkpoint warning" in out[1][2]


def test_resume_from_corrupt_checkpoint_completes(tmp_path, monkeypatch,
                                                  uninterrupted):
    """Every data file truncated after a kill: the resume starts clean,
    reports ``checkpoint_degraded`` and gives the uninterrupted result."""
    ck = checkpoint.Checkpointer(str(tmp_path), every=1)
    _arm(monkeypatch, "build:4")
    with pytest.raises(fault.InjectedFault):
        _port_run({}, ck)
    _arm(monkeypatch, None)
    for name in os.listdir(tmp_path):
        if name.endswith(".npz"):
            _truncate_half(str(tmp_path / name))
    res = _port_run({}, ck, True)
    _same(res, uninterrupted["per-segment"])
    assert res.diagnostics["checkpoint_degraded"] >= 1


def test_resume_refuses_another_run(tmp_path, monkeypatch):
    """A checkpoint resumes only its own run: another k or another chunk
    size is refused; nothing saved is a fresh run."""
    ck = checkpoint.Checkpointer(str(tmp_path), every=2)
    fresh = _port_run({}, ck, True)
    assert ck.load() is None
    _arm(monkeypatch, "build:3")
    with pytest.raises(fault.InjectedFault):
        _port_run({}, ck)
    _arm(monkeypatch, None)
    with edgestream.open_input(SPEC) as s:
        with pytest.raises(ValueError, match="does not match"):
            TorchBackend(device="cpu", chunk_edges=CS).partition(
                s, K + 1, checkpointer=ck, resume=True)
    with pytest.raises(ValueError, match="does not match"):
        _port_run({"carry_tail": True}, ck, True)
    _same(_port_run({}, ck, True), fresh)


def test_partition_entry_point_checkpoint_and_refine(tmp_path, monkeypatch):
    """``sheep_tpu_torch.partition(checkpointer=, resume=)`` as the
    reference's ``partition``, with ``refine`` after the resumed build."""
    kw = dict(chunk_edges=CS, refine=2)
    want = sheep_tpu.partition(SPEC, K, backend="tpu", **kw)
    ck = checkpoint.Checkpointer(str(tmp_path), every=2)
    _arm(monkeypatch, "score:2")
    with pytest.raises(fault.InjectedFault):
        sheep_tpu_torch.partition(SPEC, K, device="cpu", checkpointer=ck,
                                  **kw)
    _arm(monkeypatch, None)
    got = sheep_tpu_torch.partition(SPEC, K, device="cpu", checkpointer=ck,
                                    resume=True, **kw)
    _same(got, want)
    assert got.diagnostics["refine_cut_after"] == \
        want.diagnostics["refine_cut_after"]


HIER = "sbm-hash:11:16:0.05:8:1"
HIER_KW = dict(refine=1, chunk_edges=CS)


@pytest.fixture(scope="module")
def hier_uninterrupted():
    ref = sheep_tpu.partition_hierarchical(HIER, [4, 4], backend="tpu",
                                           **HIER_KW)
    got = sheep_tpu_torch.partition_hierarchical(HIER, [4, 4], device="cpu",
                                                 **HIER_KW)
    _same(got, ref)
    return got


@pytest.mark.parametrize("point", ["level0:3", "level:1"])
def test_hierarchy_kill_resume(tmp_path, monkeypatch, hier_uninterrupted,
                               point):
    """Killed inside level 0 (chunk checkpoints in ``level0/``) or after a
    top-level part (a ``hier`` step with the spill manifest): the resume
    is bit-identical, a boundary resume reuses the spill shards instead
    of spilling again, and success clears the whole directory."""
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), every=1)
    _arm(monkeypatch, point)
    with pytest.raises(fault.InjectedFault):
        sheep_tpu_torch.partition_hierarchical(
            HIER, [4, 4], device="cpu", checkpointer=ck, **HIER_KW)
    _arm(monkeypatch, None)
    if point.startswith("level0"):
        assert checkpoint.Checkpointer(
            str(tmp_path / "ck" / "level0")).load().phase == "degrees"
    else:
        st = ck.load()
        assert (st.phase, st.chunk_idx) == ("hier", 1)
        assert {"assign", "final", "level", "spill_names",
                "spill_sizes"} <= set(st.arrays)
        assert int(st.arrays["spill_sizes"][0]) == -1
        assert int(st.arrays["spill_sizes"][1]) >= 0
    spills = []
    spill = hierarchy._spill_intra
    monkeypatch.setattr(hierarchy, "_spill_intra",
                        lambda *a, **k: spills.append(1) or spill(*a, **k))
    res = sheep_tpu_torch.partition_hierarchical(
        HIER, [4, 4], device="cpu", checkpointer=ck, resume=True, **HIER_KW)
    _same(res, hier_uninterrupted)
    assert np.array_equal(res.assignment, hier_uninterrupted.assignment)
    assert len(spills) == (1 if point.startswith("level0") else 0)
    assert os.listdir(tmp_path / "ck") == []


def test_hierarchy_torn_shard_rebuilds_the_level(tmp_path, monkeypatch,
                                                 capsys, hier_uninterrupted):
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), every=1)
    _arm(monkeypatch, "level:1")
    with pytest.raises(fault.InjectedFault):
        sheep_tpu_torch.partition_hierarchical(
            HIER, [4, 4], device="cpu", checkpointer=ck, **HIER_KW)
    _arm(monkeypatch, None)
    shard = tmp_path / "ck" / "hier_spill_p0" / "level0_shards" / "p2.bin32"
    _truncate_half(str(shard))
    res = sheep_tpu_torch.partition_hierarchical(
        HIER, [4, 4], device="cpu", checkpointer=ck, resume=True, **HIER_KW)
    _same(res, hier_uninterrupted)
    assert "rebuilding the level from scratch" in capsys.readouterr().err


def test_cli_kill_and_resume(tmp_path, monkeypatch):
    """``--checkpoint-dir``/``--checkpoint-every``/``--resume`` as the
    reference's CLI: killed at build:3, resumed to the uninterrupted map,
    for the flat run and for ``--k-levels``."""
    g = str(tmp_path / "g.bin32")
    jformats.write_edges(g, jgen.rmat_hash_range(10, 0, 8 << 10, seed=4))
    ck = str(tmp_path / "ck")
    for extra in (["--k", "4"], ["--k-levels", "2,2", "--refine", "1"]):
        base = ["--input", g, "--chunk-edges", "1024", "--device", "cpu",
                "--json"] + extra
        full = str(tmp_path / "full.parts")
        assert cli.main(base + ["--output", full]) == 0
        _arm(monkeypatch, "build:3")
        with pytest.raises(fault.InjectedFault):
            cli.main(base + ["--checkpoint-dir", ck, "--checkpoint-every",
                             "1"])
        _arm(monkeypatch, None)
        resumed = str(tmp_path / "resumed.parts")
        assert cli.main(base + ["--checkpoint-dir", ck, "--resume",
                                "--output", resumed]) == 0
        assert np.array_equal(jformats.read_partition(full),
                              jformats.read_partition(resumed))


@pytest.mark.parametrize("argv,msg", [
    (["--k", "4", "--resume"], "--resume requires --checkpoint-dir"),
    (["--k", "4,8", "--checkpoint-dir", "CK"],
     "--k lists do not combine with --checkpoint-dir"),
    (["--k-levels", "2,2", "--no-cache-chunks"],
     "--no-cache-chunks not supported with --k-levels"),
    (["--k-levels", "2,2", "--resume"], "--resume requires --checkpoint-dir"),
], ids=["resume-without-dir", "k-list", "k-levels-no-cache", "k-levels"])
def test_cli_checkpoint_errors_match_jax(tmp_path, capsys, argv, msg):
    argv = [a.replace("CK", str(tmp_path)) for a in argv]
    base = ["--input", "rmat-hash:8", "--json"]
    with pytest.raises(SystemExit) as got:
        cli.main(base + ["--device", "cpu"] + argv)
    assert got.value.code == 2 and msg in capsys.readouterr().err
    with pytest.raises(SystemExit) as want:
        jcli.main(base + ["--backend", "tpu"] + argv)
    assert want.value.code == 2 and msg in capsys.readouterr().err


def test_cli_no_cache_chunks(capsys, monkeypatch):
    """``--no-cache-chunks`` turns the cache off: under a budget the
    residency counters stay away, and the result is the same."""
    monkeypatch.setenv("SHEEP_CACHE_BYTES", str(1 << 20))
    lines = []
    for extra in ([], ["--no-cache-chunks"]):
        assert cli.main(["--input", "rmat-hash:10:8:3", "--k", "4",
                         "--chunk-edges", "1024", "--device", "cpu",
                         "--json"] + extra) == 0
        lines.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert lines[0]["edge_cut"] == lines[1]["edge_cut"]
    assert lines[0]["diagnostics"]["residency_hits"] == 16  # build, score
    assert "residency_hits" not in lines[1]["diagnostics"]
