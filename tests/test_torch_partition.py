"""The whole slice: ``sheep_tpu_torch.partition(..., device="cpu")`` against
the JAX ``tpu`` backend (batched dispatch, inflight=1) under
JAX_PLATFORMS=cpu. The forest, assignment, scores and the fixpoint's round
count are integers (balance is the same numpy formula), so every
comparison is exact."""

import ast
import inspect
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sheep_tpu_torch
from sheep_tpu.backends.tpu_backend import TpuBackend, pad_chunk
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import elim as jelim
from sheep_tpu.ops import order as jorder
from sheep_tpu_torch import cli, state
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import elim

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These CPU runs issue many small ops; beside the other workers of a
    parallel test run, torch's intra-op threads cost more than they save
    (a case of ~7 s alone took ~110 s beside five other workers on eight
    cores), so the module runs on one thread and restores the count
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(spec, k, cs, batch):
    be = TpuBackend(chunk_edges=cs, dispatch_batch=batch, inflight=1)
    with jes.open_input(spec) as s:
        return be.partition(s, k, keep_tree=True)


def _assert_equal(res, ref):
    assert np.array_equal(res.tree["parent"], ref.tree["parent"])
    assert np.array_equal(res.tree["pos"], ref.tree["pos"])
    assert np.array_equal(res.tree["deg"], ref.tree["deg"])
    assert np.array_equal(res.assignment, ref.assignment)
    for key in ("edge_cut", "total_edges", "balance", "comm_volume"):
        assert getattr(res, key) == getattr(ref, key), key
    assert res.diagnostics["device_rounds"] == \
        ref.diagnostics["device_rounds"]
    assert res.diagnostics["fixpoint_rounds"] == \
        ref.diagnostics["fixpoint_rounds"]


@pytest.fixture(scope="module")
def karate_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("g") / "karate.edges")
    jformats.write_edges(path, jgen.karate_club())
    return path


@pytest.mark.parametrize("batch", [2, 3])
def test_karate_k2(karate_path, batch):
    ref = _jax(karate_path, 2, 1 << 13, batch)
    res = sheep_tpu_torch.partition(karate_path, 2, device="cpu",
                                    chunk_edges=1 << 13,
                                    dispatch_batch=batch, keep_tree=True)
    _assert_equal(res, ref)


@pytest.mark.parametrize("spec", ["rmat-hash:12:8:1", "rmat-hash:14:8:3"])
@pytest.mark.parametrize("k", [2, 64])
@pytest.mark.parametrize("batch", [2, 3])
def test_rmat_matches_tpu_backend(spec, k, batch):
    cs = 1 << 13
    ref = _jax(spec, k, cs, batch)
    res = sheep_tpu_torch.partition(spec, k, device="cpu", chunk_edges=cs,
                                    dispatch_batch=batch, keep_tree=True)
    _assert_equal(res, ref)
    assert res.diagnostics["gather_launches"] == 0  # CPU: the plain gather


def test_degree_weights_match(karate_path):
    be = TpuBackend(chunk_edges=1 << 13, dispatch_batch=2, inflight=1)
    with jes.open_input(karate_path) as s:
        ref = be.partition(s, 3, weights="degree")
    res = sheep_tpu_torch.partition(karate_path, 3, device="cpu",
                                    chunk_edges=1 << 13, dispatch_batch=2,
                                    weights="degree")
    assert np.array_equal(res.assignment, ref.assignment)
    assert (res.edge_cut, res.balance) == (ref.edge_cut, ref.balance)


def test_state_carry_from_jax():
    """JAX folds the first half of the chunks; state_from_jax hands the
    state over; the port folds the rest. The forest equals a one-shot
    build, and state_to_numpy gives the JAX payload back."""
    n, cs = 1 << 12, 1 << 11
    e = jgen.rmat_hash_range(12, 0, 8 << 12, seed=11)
    deg = jdeg.degree_chunk(jdeg.init_degrees(n), pad_chunk(e, len(e), n), n)
    pos_j, order_j = jorder.elimination_order(deg, n)
    chunks = [pad_chunk(e[off:off + cs], cs, n)
              for off in range(0, len(e), cs)]
    half = len(chunks) // 2

    def staged_jax(cs_list):
        return iter([jelim.orient_chunks_batch_pos(
            jnp.asarray(np.stack(cs_list[i:i + 2])), pos_j, n)
            for i in range(0, len(cs_list), 2)])

    P_all, _ = jelim.fold_segments_pipelined(
        jnp.full(n + 1, n, jnp.int32), staged_jax(chunks), n, inflight=1,
        donate=False)
    P_half, _ = jelim.fold_segments_pipelined(
        jnp.full(n + 1, n, jnp.int32), staged_jax(chunks[:half]), n,
        inflight=1, donate=False)
    payload = {"deg": np.asarray(deg[:n], np.int64),
               "minp": np.asarray(P_half[pos_j])}

    cpu = torch.device("cpu")
    pos = torch.from_numpy(np.array(pos_j))
    P = state.state_from_jax(payload, pos, np.asarray(order_j)[:n], cpu)
    staged = (elim.orient_chunks_batch_pos(
        torch.from_numpy(np.stack(chunks[i:i + 2])), pos, n)
        for i in range(half, len(chunks), 2))
    P, _ = elim.fold_segments_pipelined(P, staged, n)
    back = state.state_to_numpy(P, pos, payload["deg"])
    assert np.array_equal(back["minp"], np.asarray(P_all[pos_j]))
    assert np.array_equal(back["deg"], payload["deg"])
    assert np.array_equal(
        elim.minp_to_parent(back["minp"], np.asarray(order_j), n),
        jelim.minp_to_parent(P_all[pos_j], order_j, n))


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sheep_tpu_torch.partition("rmat-hash:8", 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sheep_tpu_torch.partition("rmat-hash:8", 2, device="cuda")


def test_cli_json_line(capsys, tmp_path):
    out = str(tmp_path / "p.parts")
    assert cli.main(["--input", "rmat-hash:10:4:2", "--k", "4",
                     "--device", "cpu", "--chunk-edges", "2048",
                     "--dispatch-batch", "2", "--output", out,
                     "--json"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = _jax("rmat-hash:10:4:2", 4, 2048, 2)
    assert line["edge_cut"] == ref.edge_cut
    assert line["total_edges"] == ref.total_edges
    assert line["n_vertices"] == 1 << 10
    parts = np.loadtxt(out, dtype=np.int32)
    assert np.array_equal(parts, ref.assignment)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    # _build/ holds generated kernel libraries, not package sources
    files = sorted(p for p in (REPO / "sheep_tpu_torch").rglob("*.py")
                   if "_build" not in p.relative_to(REPO).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    # the sharded build: the mesh, the pipeline, its backend, the watchdog
    # and the vertex-sharded build: its pipeline, kernels and backend
    for part in ("parallel/__init__.py", "parallel/mesh.py",
                 "parallel/pipeline.py",
                 "backends/torch_sharded_backend.py", "utils/watchdog.py",
                 "parallel/bigv.py", "ops/routed.py",
                 "backends/torch_bigv_backend.py"):
        assert REPO / "sheep_tpu_torch" / part in files, part
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sheep_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU")
def test_sharded_entry_points_need_a_gpu():
    """Without a GPU the sharded build raises unless the caller asks for
    the CPU: no mesh of CPU shards stands in for the cards."""
    from sheep_tpu_torch.backends.torch_sharded_backend import \
        TorchShardedBackend
    from sheep_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.shards_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.shards_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchShardedBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sheep_tpu_torch.partition("rmat-hash:8", 2,
                                  backend="torch-sharded")
    assert mesh.shards_mesh(device="cpu") == (torch.device("cpu"),) * \
        mesh.device_count("cpu")


def test_text_grammar_partition_matches(tmp_path):
    """Signed and decimal fields read as the reference's native parser
    reads them, so the degrees, forest, assignment and cut agree."""
    path = str(tmp_path / "signs.edges")
    with open(path, "wb") as f:
        f.write(b"1 2\n2 3\n-1 3\n+4 5\n6 7.0\n3 4\n4 5\n5 6\n6 7\n0 7\n")
    ref = _jax(path, 2, 1 << 13, 2)
    res = sheep_tpu_torch.partition(path, 2, device="cpu",
                                    chunk_edges=1 << 13, dispatch_batch=2,
                                    keep_tree=True)
    _assert_equal(res, ref)
    assert res.tree["deg"].tolist() == [1, 1, 2, 2, 2, 2, 3, 3]


ADAPTIVE_COUNTERS = ("warm_segments", "full_segments", "small_segments",
                     "stack_rebuilds", "compactions", "host_tails",
                     "host_tail_live", "host_syncs", "device_rounds")


@pytest.mark.parametrize("inflight", [0, 1])
def test_single_chunk_batch_at_depth_one_matches(inflight):
    """At dispatch_batch=1 and depth 1 (on the CPU the auto depth is 1)
    both run the adaptive per-segment driver: the same forest, partition,
    scores, device rounds and driver counters."""
    spec, k, cs = "rmat-hash:14:8:1", 8, 1 << 15
    be = TpuBackend(chunk_edges=cs, dispatch_batch=1, inflight=inflight)
    with jes.open_input(spec) as s:
        ref = be.partition(s, k, keep_tree=True)
    res = sheep_tpu_torch.partition(spec, k, device="cpu", chunk_edges=cs,
                                    dispatch_batch=1, inflight=inflight,
                                    keep_tree=True)
    _assert_equal(res, ref)
    for key in ADAPTIVE_COUNTERS:
        assert res.diagnostics.get(key) == ref.diagnostics.get(key), key
    assert res.diagnostics["host_syncs"] == sum(
        res.diagnostics.get(key, 0) for key in
        ("warm_segments", "full_segments", "small_segments"))


def test_defaults_match_the_reference():
    """``TorchBackend(device="cpu")`` and ``TpuBackend()`` with their
    defaults (auto dispatch batch and depth: 1 and 1 on the CPU) run the
    same driver to the same result."""
    spec, k = "rmat-hash:15:8:2", 16
    with jes.open_input(spec) as s:
        ref = TpuBackend().partition(s, k, keep_tree=True)
    res = TorchBackend(device="cpu").partition(
        edgestream.open_input(spec), k, keep_tree=True)
    _assert_equal(res, ref)
    for key in ADAPTIVE_COUNTERS:
        assert res.diagnostics.get(key) == ref.diagnostics.get(key), key
    assert res.diagnostics["dispatch_batch"] == 1
    assert res.diagnostics["inflight_depth"] == 1


def test_single_chunk_batch_at_depth_two_matches():
    spec, k, cs = "rmat-hash:12:8:1", 8, 1 << 13
    be = TpuBackend(chunk_edges=cs, dispatch_batch=1, inflight=2)
    with jes.open_input(spec) as s:
        ref = be.partition(s, k, keep_tree=True)
    res = sheep_tpu_torch.partition(spec, k, device="cpu", chunk_edges=cs,
                                    dispatch_batch=1, inflight=2,
                                    keep_tree=True)
    _assert_equal(res, ref)
    assert res.diagnostics["inflight_depth"] == 2


def test_default_chunk_edges_is_the_reference(monkeypatch):
    ref = inspect.signature(TpuBackend.__init__).parameters[
        "chunk_edges"].default
    assert inspect.signature(TorchBackend.__init__).parameters[
        "chunk_edges"].default == ref
    # partition's default (None) is each backend's own, the reference's
    default = inspect.signature(sheep_tpu_torch.partition).parameters[
        "chunk_edges"].default
    assert sheep_tpu_torch._backend("cpu", default, 0, 1.0, 0, 0, {}) \
        .chunk_edges == ref
    assert TorchBackend(device="cpu").chunk_edges == ref
    seen = {}

    def fake_partition(path, k, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(sheep_tpu_torch, "partition", fake_partition)
    with pytest.raises(SystemExit):
        cli.main(["--input", "rmat-hash:8", "--k", "2", "--device", "cpu"])
    assert seen["chunk_edges"] == ref
