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
    # sbm-hash and rmat specs are read since the planted family and the
    # replay stream were ported; a delta: spec needs an existing log
    for spec in ("sbm-hash:10:4", "rmat:10:1:2:3", "rmat-hash:x",
                 "rmat-hash:10:1:2:3", "delta:/nonexistent"):
        with pytest.raises(ValueError):
            edgestream.open_input(spec)
    with pytest.raises(ValueError):
        edgestream.open_input("graph.unknown")


def test_rmat_hash_scale_32_is_read_and_its_build_refused():
    """The reference reads rmat-hash at scale 32 (its host ranges work)
    and refuses the build with UnsupportedGraphError; the port did not
    read the spec at all."""
    import sheep_tpu_torch
    from sheep_tpu_torch.types import UnsupportedGraphError

    ts = edgestream.open_input("rmat-hash:32:1")
    js = jes.open_input("rmat-hash:32:1")
    assert ts.num_vertices == js.num_vertices == 1 << 32
    for start, count in (((1 << 32) - 3, 6), ((1 << 32) - 5000, 9000)):
        got = ts._range(start, count)
        assert np.array_equal(got, js._range(start, count))
    assert ts._range((1 << 32) - 3, 6)[:2].tolist() == [
        [412485932, 24171806], [404833024, 268698312]]
    with pytest.raises(UnsupportedGraphError) as exc:
        sheep_tpu_torch.partition("rmat-hash:32:1", 4, device="cpu")
    assert isinstance(exc.value, ValueError)


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


# The reference's default text grammar is its native parser's: digits
# only (a signed field makes the line malformed), a field ends at the
# first other byte ("6 7.0" reads (6, 7), "1 2x" reads (1, 2)), spaces and
# tabs between fields, extra columns ignored. The second file is the one
# that first showed the port's reader taking another grammar.
TEXT_FILES = {
    "mixed-no-final-newline": b"1 2\n2 3\n-1 3\n+4 5\n6 7.0\n3 4\n4 5\n"
                              b"5 6\n6 7\n0 7\n1 2x\n  8\t9 10\n7 8",
    "signs-and-decimals": b"1 2\n2 3\n-1 3\n+4 5\n6 7.0\n3 4\n4 5\n5 6\n"
                          b"6 7\n0 7\n",
}


@pytest.fixture
def reference_native_text(monkeypatch):
    """The reference's text reader, held to its native parser: its Python
    fallback raises if it is reached."""
    from sheep_tpu.core import native as jnative

    assert jnative.available(), "the reference's native parser is not built"

    def no_fallback(*args, **kwargs):
        raise AssertionError("the reference read text without its native "
                             "parser")

    monkeypatch.setattr(jes.EdgeStream, "_chunks_text_python", no_fallback)


@pytest.mark.parametrize("name", sorted(TEXT_FILES))
@pytest.mark.parametrize("cs", [3, 1 << 22])
def test_text_grammar_matches_native_reference(tmp_path, name, cs,
                                               reference_native_text):
    path = str(tmp_path / f"{name}.edges")
    with open(path, "wb") as f:
        f.write(TEXT_FILES[name])
    ref = list(jes.open_input(path).chunks(cs))
    got = list(edgestream.open_input(path).chunks(cs))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == np.int64
        assert np.array_equal(a, b)
    if name == "mixed-no-final-newline":
        assert np.concatenate(got).tolist() == [
            [1, 2], [2, 3], [6, 7], [3, 4], [4, 5], [5, 6], [6, 7], [0, 7],
            [1, 2], [8, 9], [7, 8]]


@pytest.mark.parametrize("block", [5, 64, 4093])
@pytest.mark.parametrize("final_newline", [True, False])
def test_text_split_across_parse_blocks(tmp_path, monkeypatch, block,
                                        final_newline,
                                        reference_native_text):
    """Lines cut by the parser's block boundary are carried whole into the
    next block, at any block size, with or without a final newline."""
    e = jgen.random_graph(500, 3000, seed=block)
    path = str(tmp_path / "g.edges")
    jformats.write_edges(path, e)
    with open(path, "ab") as f:
        f.write(b"# tail comment\n\r 12\t13 99\n-5 6\n14 15")
        if final_newline:
            f.write(b"\n")
    monkeypatch.setattr(edgestream, "TEXT_BLOCK_BYTES", block)
    ref = list(jes.open_input(path).chunks(1000))
    got = list(edgestream.open_input(path).chunks(1000))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert got[-1][-2:].tolist() == [[12, 13], [14, 15]]
