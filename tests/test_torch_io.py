"""The port's host pieces against the JAX package's: the counter-hash R-MAT
(host and device-synthesized chunks, bit-equal), karate, the edge streams,
and the tree split on random forests. All comparisons are exact."""

import numpy as np
import pytest
import torch

from sheep_tpu.core import pure as jpure
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.types import ElimTree as JElimTree
from sheep_tpu_torch.core import pure
from sheep_tpu_torch.io import edgestream, formats, generators
from sheep_tpu_torch.types import ElimTree


@pytest.mark.parametrize("scale,start,count,seed", [
    (10, 0, 5000, 0),
    (16, 123, 777, 42),
    (22, 1 << 20, 4096, 7),
    (31, (1 << 32) - 1000, 3000, 3),  # crosses the 32-bit counter carry
])
def test_rmat_hash_range_bit_equal(scale, start, count, seed):
    ref = jgen.rmat_hash_range(scale, start, count, seed=seed)
    got = generators.rmat_hash_range(scale, start, count, seed=seed)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("scale,start,count,pad_to,seed", [
    (12, 0, 4096, 4096, 1),
    (14, 8192, 1000, 2048, 3),
    (20, (1 << 32) - 512, 1024, 1024, 5),
])
def test_device_chunk_bit_equal(scale, start, count, pad_to, seed):
    n = 1 << scale
    ref = np.full((pad_to, 2), n, np.int32)
    ref[:count] = jgen.rmat_hash_range(scale, start, count, seed=seed)
    got = generators.rmat_hash_chunk_device(scale, start, count, pad_to, n,
                                            torch.device("cpu"), seed=seed)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    dev_ref = np.asarray(jgen.rmat_hash_chunk_device(scale, start, count,
                                                     pad_to, n, seed=seed))
    assert np.array_equal(got.numpy(), dev_ref)


def test_rmat_stream_chunks():
    js = jgen.RmatHashStream(12, 8, seed=9)
    ts = generators.RmatHashStream(12, 8, seed=9)
    assert ts.num_vertices == js.num_vertices
    assert ts.clamp_chunk_edges(1 << 20) == js.clamp_chunk_edges(1 << 20)
    cs = 5000
    for a, b in zip(ts.chunks(cs), js.chunks(cs), strict=True):
        assert np.array_equal(a, b)
    n = ts.num_vertices
    for i in range(js.num_device_chunks(cs)):
        assert np.array_equal(
            ts.device_chunk(i, cs, n, torch.device("cpu")).numpy(),
            np.asarray(js.device_chunk(i, cs, n)))


def test_karate_equal():
    assert np.array_equal(generators.karate_club(), jgen.karate_club())


@pytest.mark.parametrize("ext", [".edges", ".bin32", ".bin64"])
def test_edge_streams_match(tmp_path, ext):
    e = jgen.random_graph(3000, 20000, seed=4)
    path = str(tmp_path / f"g{ext}")
    jformats.write_edges(path, e)
    if ext == ".edges":  # comments, blanks and malformed lines are skipped
        with open(path, "a") as f:
            f.write("# comment\n\n% other\n7\nx y\n1 2 3\n")
    js = jes.open_input(path)
    ts = edgestream.open_input(path)
    assert ts.num_vertices == js.num_vertices
    assert ts.clamp_chunk_edges(1 << 22) == js.clamp_chunk_edges(1 << 22)
    for a, b in zip(ts.chunks(4096), js.chunks(4096), strict=True):
        assert np.array_equal(a, b)
    mem = edgestream.EdgeStream.from_array(e)
    jmem = jes.EdgeStream.from_array(e)
    assert mem.clamp_chunk_edges(1 << 22) == jmem.clamp_chunk_edges(1 << 22)
    for a, b in zip(mem.chunks(777), jmem.chunks(777), strict=True):
        assert np.array_equal(a, b)


def test_write_edges_round_trip(tmp_path):
    e = generators.karate_club()
    for ext in (".edges", ".bin32", ".bin64"):
        path = str(tmp_path / f"k{ext}")
        formats.write_edges(path, e)
        assert np.array_equal(jformats.read_edges(path), e)


def test_open_input_rejects_other_specs():
    for spec in ("sbm-hash:10:4:0.1", "rmat:10", "rmat-hash:x",
                 "rmat-hash:10:1:2:3", "delta:/nonexistent"):
        with pytest.raises(ValueError):
            edgestream.open_input(spec)
    with pytest.raises(ValueError):
        edgestream.open_input("graph.unknown")


def _random_forest(n, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    parent = np.full(n, -1, np.int64)
    for r in range(n - 1):
        if rng.random() < 0.93:
            parent[order[r]] = order[rng.integers(r + 1, n)]
    return parent, pos


@pytest.mark.parametrize("n,k,seed", [(500, 2, 0), (3000, 64, 1),
                                      (2048, 7, 2)])
@pytest.mark.parametrize("weighted", [False, True])
def test_tree_split_equal(n, k, seed, weighted):
    parent, pos = _random_forest(n, seed)
    w = None
    if weighted:
        w = np.random.default_rng(seed + 10).integers(
            1, 50, size=n).astype(np.float64)
    ref = jpure.tree_split(JElimTree(parent=parent, pos=pos, n=n), k,
                           weights=w, alpha=1.0)
    got = pure.tree_split(ElimTree(parent=parent, pos=pos, n=n), k,
                          weights=w, alpha=1.0)
    assert np.array_equal(got, ref)
    assert pure.part_balance(got, k, w) == jpure.part_balance(ref, k, w)
