"""The port's multi-process runs (``torch.distributed``, gloo on the CPU)
against the JAX package, modelled on ``tests/test_multihost.py``.

In process, exactly as the reference: ``iter_batches_lockstep``'s
round-robin batches at 2 and 3 processes, ``EdgeStream.chunks(shard=,
num_shards=, byte_range=)`` and ``count_edges_in_span`` over memory,
``.bin32``, ``.csr``, text and gzip inputs, the hash streams' sharded
chunks, ``Checkpointer.load_at``.

Spawned gloo ranks (2 virtual CPU shards a rank, ``rmat(9, 8, seed=21)``,
n = 512, chunks of 128, k = 8, comm volume on), against the JAX package's
``core.pure`` oracle: every rank's forest, assignment, cut, total, comm
volume and balance equal the oracle's, and every rank's non-time
diagnostics equal every other rank's. ``torch-sharded`` (both dispatch
paths) and ``torch-bigv`` at 2 and 3 ranks, over the edges and over a
hash stream synthesized by each rank on its shards, text by byte spans, a
fault then a resume of both builds, a one-step skew of the saves, a
fingerprint mismatch on one rank (exit 43 on every rank), the CLI's
``--k-levels 2,2 --refine 1`` over the three flags against the JAX
package's hierarchy, and a ``delta:`` input refused. Six spawned groups: each rank one torch
thread, logs in files, a free port, a timeout that kills every rank."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.parallel.pipeline import iter_batches_lockstep as jlockstep
from sheep_tpu.utils.checkpoint import Checkpointer as JCheckpointer

from sheep_tpu_torch.io import csr, edgestream, generators
from sheep_tpu_torch.parallel.pipeline import iter_batches_lockstep
from sheep_tpu_torch.utils.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 9
SPAWN_TIMEOUT_S = 180
# a device stream of n vertices: each process synthesizes its own chunks
HASH_SPEC = "rmat-hash:9:8:21"


# -- in process -------------------------------------------------------------

def _edges():
    return jgen.rmat(9, 8, seed=21)


@pytest.mark.parametrize("procs,start", [(2, 0), (2, 5), (3, 0), (3, 5)])
def test_lockstep_round_robin_matches_jax(procs, start):
    """Every process's padded batches, stragglers' all-sentinel ones
    included, are the reference's."""
    e = _edges()
    for proc in range(procs):
        got = list(iter_batches_lockstep(
            edgestream.EdgeStream.from_array(e, n_vertices=N), 128, 2, N,
            proc, procs, start_chunk=start))
        ref = list(jlockstep(jes.EdgeStream.from_array(e, n_vertices=N),
                             128, 2, N, proc, procs, start_chunk=start))
        assert len(got) == len(ref) > 0
        for b, rb in zip(got, ref):
            assert np.array_equal(b, rb)


@pytest.mark.parametrize("procs,start", [(1, 0), (2, 0), (2, 6), (3, 0),
                                         (3, 6)])
def test_device_lockstep_matches_jax_host_batches(procs, start):
    """A hash stream's batches synthesized on each process's shards are
    the reference's padded host batches of that process, and every
    process counts the run's real chunks."""
    from sheep_tpu_torch.parallel.pipeline import device_lockstep_batches

    spec, cs, rows = "rmat-hash:10:8:3", 700, 2
    ts, js = edgestream.open_input(spec), jes.open_input(spec)
    n = ts.num_vertices
    for proc in range(procs):
        stats = {}
        got = list(device_lockstep_batches(
            ts, cs, rows, n, ["cpu"] * rows, start_chunk=start,
            stats=stats, proc=proc, procs=procs))
        ref = list(jlockstep(js, cs, rows, n, proc, procs,
                             start_chunk=start))
        assert len(got) == len(ref) > 0
        for b, rb in zip(got, ref):
            assert np.array_equal(np.stack([x.numpy() for x in b]), rb)
        assert stats == {"h2d_staged_bytes": 0,
                         "device_stream_chunks": ts.num_chunks(cs) - start}


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp_inputs")
    e = _edges()
    paths = {}
    for ext in (".bin32", ".edges", ".edges.gz"):
        paths[ext] = str(d / f"g{ext}")
        jformats.write_edges(paths[ext], e)
    paths[".csr"] = str(d / "g.csr")
    csr.write_csr(paths[".csr"], edgestream.EdgeStream.from_array(e),
                  n_vertices=N)
    return paths


@pytest.mark.parametrize("fmt", ["memory", ".bin32", ".csr", ".edges",
                                 ".edges.gz"])
@pytest.mark.parametrize("byte_range", [False, True])
def test_sharded_chunks_match_jax(graph_files, fmt, byte_range):
    """Every worker's chunks (round robin, or byte spans for plain text)
    and its span count are the reference's."""
    def open_both():
        if fmt == "memory":
            e = _edges()
            return (edgestream.EdgeStream.from_array(e, n_vertices=N),
                    jes.EdgeStream.from_array(e, n_vertices=N))
        return (edgestream.EdgeStream.open(graph_files[fmt], n_vertices=N),
                jes.EdgeStream.open(graph_files[fmt], n_vertices=N))

    for shards in (2, 3):
        for shard in range(shards):
            ts, js = open_both()
            for cs, start in ((100, 0), (300, 4)):
                got = list(ts.chunks(cs, shard=shard, num_shards=shards,
                                     start_chunk=start,
                                     byte_range=byte_range))
                ref = list(js.chunks(cs, shard=shard, num_shards=shards,
                                     start_chunk=start,
                                     byte_range=byte_range))
                assert len(got) == len(ref) > 0
                for c, rc in zip(got, ref):
                    assert np.array_equal(c, rc)
            assert ts.count_edges_in_span(shard, shards) == \
                js.count_edges_in_span(shard, shards)


@pytest.mark.parametrize("spec", ["rmat-hash:10:8:3",
                                  "sbm-hash:10:8:0.05:8:3"])
def test_hash_stream_shards_match_jax(spec):
    """The counter-hash streams skip straight to a worker's own chunks."""
    ts, js = edgestream.open_input(spec), jes.open_input(spec)
    assert isinstance(ts, generators._CounterHashStream)
    for shards in (2, 3):
        for shard in range(shards):
            for start in (0, 5):
                got = list(ts.chunks(700, shard=shard, num_shards=shards,
                                     start_chunk=start))
                ref = list(js.chunks(700, shard=shard, num_shards=shards,
                                     start_chunk=start))
                assert len(got) == len(ref) > 0
                assert all(np.array_equal(c, rc)
                           for c, rc in zip(got, ref))
            assert ts.count_edges_in_span(shard, shards) == \
                js.count_edges_in_span(shard, shards)
    with pytest.raises(ValueError):
        next(ts.chunks(700, shard=2, num_shards=2))


def test_load_at_matches_jax(tmp_path):
    """The latest and the kept previous step load; an older one is
    gone; the reference's ``load_at`` reads the same steps."""
    ck = Checkpointer(str(tmp_path), every=1, process=1)
    meta = {"k": 8}
    for idx in (4, 8, 12):
        ck.save("build", idx, {"deg": np.arange(idx, dtype=np.int64)}, meta)
    jck = JCheckpointer(str(tmp_path), every=1, process=1)
    for phase, idx in (("build", 12), ("build", 8), ("build", 4),
                       ("score", 12)):
        got, ref = ck.load_at(phase, idx), jck.load_at(phase, idx)
        assert (got is None) == (ref is None)
        if got is not None:
            assert got.chunk_idx == ref.chunk_idx == idx
            assert np.array_equal(got.arrays["deg"], ref.arrays["deg"])
            assert got.meta == meta
    assert ck.load_at("build", 4) is None


def test_resume_state_mismatch_sentinel_matches_jax(tmp_path):
    """``raise_on_mismatch=False`` hands back the sentinel where the
    reference does, and raises where it raises; in one process the
    collective resume returns the local state, or raises for the
    sentinel."""
    from sheep_tpu.utils import checkpoint as jckpt

    from sheep_tpu_torch.utils import checkpoint as ckpt

    ck = Checkpointer(str(tmp_path), every=1)
    ck.save("build", 4, {"deg": np.zeros(3, np.int64)}, {"k": 8})
    jck = JCheckpointer(str(tmp_path), every=1)
    for meta in ({"k": 8}, {"k": 9}):
        got = ckpt.resume_state(ck, meta, True, raise_on_mismatch=False)
        ref = jckpt.resume_state(jck, meta, True, raise_on_mismatch=False)
        assert (got is ckpt.MISMATCHED) == (ref is jckpt.MISMATCHED) == \
            (meta["k"] == 9)
    with pytest.raises(ValueError):
        ckpt.resume_state(ck, {"k": 9}, True)
    state = ckpt.resume_state(ck, {"k": 8}, True)
    assert ckpt.reconcile_multihost_resume(ck, state, {"k": 8}) is state
    assert ckpt.reconcile_multihost_resume(ck, None, {"k": 8}) is None
    with pytest.raises(ValueError, match="cannot resume"):
        ckpt.reconcile_multihost_resume(ck, ckpt.MISMATCHED, {"k": 8})


def test_bring_up_refuses_what_it_cannot_run():
    """No process group forms from a bad request, and none is left
    behind: nccl needs CUDA shards, a coordinator needs the ids, a mesh
    of several processes needs its group."""
    from sheep_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="nccl"):
        mesh.init_distributed("127.0.0.1:1", 2, 0, backend="nccl",
                              device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        mesh.init_distributed("127.0.0.1:1", 2, 0, backend="mpi",
                              device="cpu")
    with pytest.raises(ValueError, match="--num-processes"):
        mesh.init_distributed("127.0.0.1:1", device="cpu")
    assert mesh.host_shard_info() == (0, 1) and mesh.transport() is None
    with pytest.raises(ValueError, match="init_distributed"):
        mesh.Mesh(["cpu"] * 2, procs=2, proc=1)
    with pytest.raises(ValueError):
        mesh.Mesh(["cpu"], procs=1, proc=1)
    m = mesh.Mesh(["cpu"] * 3)
    assert (m.procs, m.proc, m.size, m.base) == (1, 0, 3, 0)
    assert mesh.Mesh(m) == m and mesh.Mesh(m).size == 3


def test_init_distributed_needs_a_gpu_unless_asked_for_the_cpu():
    import torch

    from sheep_tpu_torch.parallel import mesh

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed("127.0.0.1:1", 2, 0, backend="gloo")


def test_one_process_collectives_copy_nothing_new():
    """With one process every collective is what it was: an all-gather of
    the rows of one buffer is that buffer, an all-to-all views it, the
    reductions and the host allgather need no group."""
    import torch

    from sheep_tpu_torch.parallel import mesh
    from sheep_tpu_torch.parallel.pipeline import union_key_count

    m = mesh.Mesh(["cpu"] * 3)
    buf = torch.arange(3 * 3 * 4, dtype=torch.int32).view(3, 3, 4)
    rows = list(buf)
    for where in (None, m):
        got = mesh.all_gather(rows, where)
        assert all(g.data_ptr() == buf.data_ptr() for g in got)
        a2a = mesh.all_to_all(rows, where)
        for s in range(3):
            assert torch.equal(a2a[s], buf[:, s])
            assert a2a[s].data_ptr() == buf[0, s].data_ptr()
        assert torch.equal(mesh.psum(rows, where)[0], buf.sum(0))
        assert torch.equal(mesh.pmin(rows, where)[0], buf[0])
        assert mesh.shard0(rows, where) is rows[0]
        perm = [(0, 1), (1, 0)]
        got = mesh.ppermute(rows, perm, where)
        assert torch.equal(got[1], rows[0]) and not got[2].any()
    assert np.array_equal(mesh.process_allgather(np.arange(4)),
                          np.arange(4)[None])
    assert union_key_count(np.array([5, 1, 5, 9])) == 3


@pytest.mark.parametrize("argv", [
    ["--dist-backend", "gloo"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "0", "--deltas", "g.dlog"]])
def test_cli_refuses_multi_process_misuse(argv, capsys):
    from sheep_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--input", "rmat-hash:8", "--k", "2", "--device", "cpu",
                  *argv])
    assert e.value.code == 2
    assert "--coordinator" in capsys.readouterr().err


# -- spawned ranks ----------------------------------------------------------

WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
addr, pid, nprocs, out_path, runs = sys.argv[1:6]
pid, nprocs = int(pid), int(nprocs)
from sheep_tpu_torch.parallel import mesh
mesh.init_distributed(addr, nprocs, pid, device="cpu")
mesh.force_cpu_devices(2)
from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
from sheep_tpu_torch.backends.torch_sharded_backend import \
    TorchShardedBackend
from sheep_tpu_torch.io.edgestream import EdgeStream, open_input
from sheep_tpu_torch.parallel.bigv import BigVPipeline
from sheep_tpu_torch.parallel.pipeline import ShardedPipeline
from sheep_tpu_torch.types import UnsupportedGraphError
from sheep_tpu_torch.utils import fault
from sheep_tpu_torch.utils.checkpoint import Checkpointer

n = 1 << 9
m = mesh.shards_mesh(device="cpu")
assert (m.procs, m.proc, len(m), m.size) == (nprocs, pid, 2, 2 * nprocs)
results = {}


def dump():
    with open(out_path, "w") as f:
        json.dump(results, f)


def keep(v):
    return isinstance(v, (int, str)) and not isinstance(v, bool)


t0 = time.perf_counter()
for run in json.loads(runs):
    tag = run["tag"]
    print(f"{tag} at {time.perf_counter() - t0:.2f} s", flush=True)
    if run.get("delta"):
        for name, be in (("sharded", TorchShardedBackend(device="cpu")),
                         ("bigv", TorchBigVBackend(device="cpu"))):
            try:
                be.partition(open_input("delta:" + run["delta"]), 4)
                results[tag + name] = "built"
            except UnsupportedGraphError:
                results[tag + name] = "refused"
        dump()
        continue
    if run.get("spec"):
        stream = open_input(run["spec"])
    elif run.get("graph"):
        stream = EdgeStream.open(run["graph"], n_vertices=n)
    else:
        stream = EdgeStream.from_array(np.load(run["edges"]), n_vertices=n)
    kw = {}
    if run.get("ckdir"):
        kw = {"checkpointer": Checkpointer(run["ckdir"], every=1,
                                           process=pid),
              "resume": bool(run.get("resume"))}
    if run["kind"] == "bigv":
        pipe = BigVPipeline(n, 128, m)
    else:
        pipe = ShardedPipeline(n, 128, m, dispatch_batch=run.get("nb", 1),
                               inflight=run.get("depth", 1))
    if run.get("fault"):
        os.environ[fault.ENV_VAR] = run["fault"]
    fault.reset()
    try:
        out = pipe.run(stream, k=8, comm_volume=True, **kw)
    except fault.InjectedFault:
        results[tag] = "fault"
        dump()
        continue
    except ValueError as exc:
        print("ValueError:", exc, flush=True)
        results[tag] = "ValueError"
        dump()
        sys.exit(43)
    finally:
        os.environ.pop(fault.ENV_VAR, None)
        fault.reset()
    stats = {**out["build_stats"], **out.get("merge_stats", {})}
    results[tag] = {
        "edge_cut": int(out["edge_cut"]),
        "total_edges": int(out["total_edges"]),
        "comm_volume": int(out["comm_volume"]),
        "balance": float(out["balance"]),
        "assignment": np.asarray(out["assignment"]).tolist(),
        "parent": np.asarray(out["parent"]).tolist(),
        "diagnostics": {k: v for k, v in sorted(stats.items())
                        if keep(v) and not k.endswith("_ms")},
    }
    dump()
print(f"done at {time.perf_counter() - t0:.2f} s", flush=True)
mesh.shutdown_distributed()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("SHEEP_FAULT_INJECT", None)
    return env


def _start(nprocs, tmp, tag, runs=None, argv=None):
    """``nprocs`` gloo ranks, each of WORKER over ``runs`` or of ``python
    -m sheep_tpu_torch argv`` (with its rank's flags), started; the
    handle :func:`_finish` waits for."""
    addr = f"127.0.0.1:{_free_port()}"
    procs, outs, logs = [], [], []
    for pid in range(nprocs):
        outs.append(str(tmp / f"out_{tag}_{pid}.json"))
        logs.append(str(tmp / f"log_{tag}_{pid}.txt"))
        if argv is None:
            cmd = ["-c", WORKER, addr, str(pid), str(nprocs), outs[-1],
                   json.dumps(runs)]
        else:
            cmd = ["-m", "sheep_tpu_torch", *argv, "--coordinator", addr,
                   "--num-processes", str(nprocs), "--process-id", str(pid)]
        # logs to files: a full pipe would stall a rank's collectives
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *cmd], cwd=REPO, env=_env(), stdout=log,
                stderr=subprocess.STDOUT))
    return tag, procs, outs, logs


def _finish(handle):
    """(exit codes, each rank's results, each rank's log tail); a rank
    past the timeout kills every rank of the group."""
    tag, procs, outs, logs = handle
    rcs = []
    for p in procs:
        try:
            p.wait(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail(f"spawn {tag} timed out: "
                        + " | ".join(open(lg).read()[-1500:]
                                     for lg in logs))
        rcs.append(p.returncode)
    res = [json.load(open(o)) if os.path.exists(o) else {} for o in outs]
    return rcs, res, [open(lg).read()[-2000:] for lg in logs]


def _oracle(e):
    from sheep_tpu.core import pure

    ref = pure.partition_arrays(e, 8, n=N)
    parent = pure.build_elim_tree(
        e, pure.elimination_order(pure.degrees(e, N))).parent
    return ref, np.asarray(parent)


@pytest.fixture(scope="module")
def oracle():
    return _oracle(_edges())


@pytest.fixture(scope="module")
def hash_oracle():
    return _oracle(jes.open_input(HASH_SPEC).read_all())


@pytest.fixture(scope="module")
def mp_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    np.save(str(d / "e.npy"), _edges())
    jformats.write_edges(str(d / "g.edges"), _edges())
    return d


def _check(results, tag, oracle):
    """Every rank's result of ``tag`` is the oracle's, and the ranks'
    non-time diagnostics agree."""
    ref, parent = oracle
    got = [r[tag] for r in results]
    for r in got:
        assert r["total_edges"] == ref.total_edges
        assert r["edge_cut"] == ref.edge_cut
        assert r["comm_volume"] == ref.comm_volume
        assert r["balance"] == ref.balance
        assert np.array_equal(np.asarray(r["parent"]), parent), \
            "multi-process forest != the sequential oracle"
        assert np.array_equal(np.asarray(r["assignment"]), ref.assignment)
        assert r["diagnostics"] == got[0]["diagnostics"]
    return got[0]["diagnostics"]


@pytest.fixture(scope="module")
def group(mp_dir):
    """The spawned groups, run once and read by the tests: the five that
    depend on nothing at once (their ranks mostly wait on each other),
    then the resumes of the fault group's checkpoints."""
    from sheep_tpu_torch.io.deltalog import DeltaLogWriter

    edges = str(mp_dir / "e.npy")
    graph = str(mp_dir / "g.edges")
    log = str(mp_dir / "g.dlog")
    with DeltaLogWriter(log, base_spec=graph) as w:
        w.append(_edges()[:64])
    both = [{"tag": "seg", "kind": "sharded", "edges": edges},
            {"tag": "batched", "kind": "sharded", "edges": edges,
             "nb": 2, "depth": 2},
            {"tag": "bigv", "kind": "bigv", "edges": edges},
            {"tag": "hash-sharded", "kind": "sharded", "spec": HASH_SPEC}]
    started = [
        _start(3, mp_dir, "three", both),
        _start(2, mp_dir, "two", both + [{"tag": "delta-", "delta": log}]),
        _start(2, mp_dir, "text", [
            {"tag": "sharded", "kind": "sharded", "graph": graph},
            {"tag": "bigv", "kind": "bigv", "graph": graph},
            {"tag": "hash-bigv", "kind": "bigv", "spec": HASH_SPEC}]),
        _start(2, mp_dir, "hier", argv=[
            "--input", graph, "--k-levels", "2,2", "--refine", "1",
            "--chunk-edges", "128", "--num-vertices", str(N),
            "--no-comm-volume", "--json", "--output",
            str(mp_dir / "hier.parts"), "--device", "cpu", "--n-devices",
            "4"]),
        _start(2, mp_dir, "fault", [
            {"tag": t, "kind": kind, "edges": edges,
             "ckdir": str(mp_dir / f"ck_{t}"), "fault": f}
            for t, kind, f in (("sharded", "sharded", "build:2"),
                               ("bigv", "bigv", "build:2"),
                               ("skew", "sharded", "build:3"),
                               ("mismatch", "sharded", "build:2"))])]
    # the resumes start as soon as the (short) fault group is done
    out = {"fault": _finish(started.pop())}
    if out["fault"][0] == [0, 0]:
        ck1 = Checkpointer(str(mp_dir / "ck_skew"), every=1, process=1)
        st = ck1.load()
        assert st is not None
        # process 1 saved one more step before the crash
        ck1.save(st.phase, st.chunk_idx + 4, st.arrays, st.meta)
        mpath = Checkpointer(str(mp_dir / "ck_mismatch"), every=1,
                             process=1)._manifest_path
        manifest = json.load(open(mpath))
        manifest["meta"]["k"] = 99
        json.dump(manifest, open(mpath, "w"))
        # the mismatch last: it ends both ranks with 43
        started.append(_start(2, mp_dir, "resume", [
            {"tag": t, "kind": kind, "edges": edges, "resume": True,
             "ckdir": str(mp_dir / f"ck_{t}")}
            for t, kind in (("sharded", "sharded"), ("bigv", "bigv"),
                            ("skew", "sharded"), ("mismatch", "sharded"))]))
    out.update((h[0], _finish(h)) for h in started)
    return out.__getitem__


@pytest.mark.parametrize("name,nprocs", [("two", 2), ("three", 3)])
def test_sharded_both_paths_match_oracle(group, oracle, name, nprocs):
    rcs, res, logs = group(name)
    assert rcs == [0] * nprocs, logs
    seg = _check(res, "seg", oracle)
    batched = _check(res, "batched", oracle)
    assert seg["merge_mode"] == batched["merge_mode"]
    assert batched["dispatch_batch"] == 2 and batched["inflight_depth"] == 2


@pytest.mark.parametrize("name,nprocs", [("two", 2), ("three", 3)])
def test_bigv_matches_oracle(group, oracle, name, nprocs):
    rcs, res, logs = group(name)
    assert rcs == [0] * nprocs, logs
    diag = _check(res, "bigv", oracle)
    assert diag["device_rounds"] > 0


@pytest.mark.parametrize("kind,name,nprocs", [
    ("sharded", "two", 2), ("sharded", "three", 3), ("bigv", "text", 2)])
def test_device_stream_matches_oracle(group, hash_oracle, kind, name,
                                      nprocs):
    """A hash stream's chunks synthesized by every process on its own
    shards (no host batches): the oracle's result, every chunk counted
    once on every rank. (The batches at 3 processes, stragglers' padding
    included, are held against the reference's in process.)"""
    rcs, res, logs = group(name)
    assert rcs == [0] * nprocs, logs
    diag = _check(res, "hash-" + kind, hash_oracle)
    assert diag["h2d_staged_bytes"] == 0
    chunks = edgestream.open_input(HASH_SPEC).num_chunks(128)
    assert diag["device_stream_chunks"] % chunks == 0


@pytest.mark.parametrize("kind", ["sharded", "bigv"])
def test_text_byte_spans_match_oracle(group, oracle, kind):
    """Plain text splits by byte span over the processes: other chunks
    than the round robin's, the same forest."""
    rcs, res, logs = group("text")
    assert rcs == [0, 0], logs
    _check(res, kind, oracle)


@pytest.mark.parametrize("kind", ["sharded", "bigv"])
def test_delta_input_refused_at_two_processes(group, kind):
    rcs, res, logs = group("two")
    assert rcs == [0, 0], logs
    assert [r["delta-" + kind] for r in res] == ["refused", "refused"]


@pytest.mark.parametrize("kind", ["sharded", "bigv"])
def test_fault_then_resume_matches_oracle(group, oracle, kind):
    """Both ranks killed at build batch 2, then resumed from their
    checkpoints: the uninterrupted result."""
    rcs, res, logs = group("fault")
    assert rcs == [0, 0], logs
    assert [r[kind] for r in res] == ["fault", "fault"]
    rcs, res, logs = group("resume")
    _check(res, kind, oracle)


def test_resume_reconciles_one_step_skew(group, oracle):
    """One process's manifest a step ahead: the resume falls back to the
    step both hold."""
    rcs, res, logs = group("resume")
    _check(res, "skew", oracle)


def test_resume_mismatch_fails_collectively(group):
    """A fingerprint mismatch on one process raises on every process
    (exit 43), none left waiting in a collective."""
    rcs, res, logs = group("resume")
    assert rcs == [43, 43], logs
    assert [r["mismatch"] for r in res] == ["ValueError", "ValueError"]


def test_cli_hierarchy_level0_matches_jax(group, mp_dir):
    """``python -m sheep_tpu_torch --k-levels 2,2 --refine 1`` over the
    three flags: every level through ``torch-sharded`` across the
    processes; process 0's map is the JAX package's single-process
    hierarchy."""
    import sheep_tpu

    rcs, _, logs = group("hier")
    assert rcs == [0, 0], logs
    line = json.loads(logs[0].strip().splitlines()[-1])
    assert line["backend"] == "torch-sharded:cpu+hier[2, 2]"
    # process 0 alone reports
    assert not [ln for ln in logs[1].splitlines() if ln.startswith("{")]
    expect = sheep_tpu.partition_hierarchical(
        str(mp_dir / "g.edges"), [2, 2], backend="cpu", refine=1,
        chunk_edges=128, n_vertices=N, comm_volume=False)
    got = jformats.read_partition(str(mp_dir / "hier.parts"))
    assert np.array_equal(got, np.asarray(expect.assignment)), logs
    assert line["edge_cut"] == expect.edge_cut
