"""The port's synthetic inputs against the JAX package's, exactly: every
family's host chunks (numpy and native ranges, across the 2^32 counter
carry), the device chunks' plain versions against the JAX device
functions on cpu-jax, ground truth and planted ratios, the reference's
argument checks, and ``hash_chunk``'s kernel against its plain version on
the card."""

import numpy as np
import pytest
import torch

from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import generators as jgen
from sheep_tpu_torch.io import edgestream, generators
from sheep_tpu_torch.ops import synth

CPU = torch.device("cpu")
CARRY = (1 << 32) - (1 << 20)

# (class name, constructor arguments): each family at a small scale
FAMILIES = [
    ("RmatHashStream", dict(scale=11, edge_factor=4, seed=3)),
    ("SbmHashStream", dict(scale=11, n_blocks=16, p_out=0.05, edge_factor=4,
                           seed=7)),
    ("SbmHashStream", dict(scale=9, n_blocks=2, p_out=1.0, edge_factor=8,
                           seed=1)),
    ("NearCliqueStream", dict(scale=11, clique_bits=5, p_out=0.02,
                              edge_factor=4, seed=7)),
    ("PowerlawSbmHashStream", dict(scale=11, n_blocks=16, p_out=0.05,
                                   edge_factor=4, seed=7)),
    ("BipartiteHashStream", dict(scale=11, n_blocks=8, p_out=0.02,
                                 edge_factor=4, seed=7)),
]
FAMILY_IDS = [f"{name}-{i}" for i, (name, _) in enumerate(FAMILIES)]


def _pair(name, kw):
    return getattr(generators, name)(**kw), getattr(jgen, name)(**kw)


@pytest.mark.parametrize("name,kw", FAMILIES, ids=FAMILY_IDS)
@pytest.mark.parametrize("cs", [1000, 4096, 5000, 1 << 22])
def test_host_chunks_equal(name, kw, cs):
    ts, js = _pair(name, kw)
    assert ts.num_vertices == js.num_vertices
    assert ts.num_edges == js.num_edges
    assert ts.num_edges_upper_bound == js.num_edges_upper_bound
    assert ts.clamp_chunk_edges(cs) == js.clamp_chunk_edges(cs)
    got = list(ts.chunks(cs))
    ref = list(js.chunks(cs))
    assert len(got) == len(ref) == ts.num_chunks(cs)
    for a, b in zip(got, ref):
        assert a.dtype == np.int64
        assert np.array_equal(a, b)
    assert np.array_equal(ts.read_all(), js.read_all())


@pytest.mark.parametrize("count", [3000, 9000])  # numpy path, native path
@pytest.mark.parametrize("scale,seed", [(12, 0), (22, 5), (31, 9), (32, 1)])
def test_rmat_hash_range_across_the_carry(scale, seed, count):
    start = (1 << 32) - count // 2
    assert np.array_equal(
        generators.rmat_hash_range(scale, start, count, seed=seed),
        jgen.rmat_hash_range(scale, start, count, seed=seed))


@pytest.mark.parametrize("count", [3000, 9000])
@pytest.mark.parametrize("scale,n_blocks,p_out", [
    (12, 2, 1.0), (16, 64, 0.05), (20, 1 << 20, 0.3), (31, 4, 0.0)])
def test_sbm_hash_range_across_the_carry(scale, n_blocks, p_out, count):
    start = (1 << 32) - count // 2
    assert np.array_equal(
        generators.sbm_hash_range(scale, start, count, n_blocks, p_out,
                                  seed=4),
        jgen.sbm_hash_range(scale, start, count, n_blocks, p_out, seed=4))


def _ref_chunk(js, i, cs, n):
    return np.asarray(js.device_chunk(i, cs, n))


@pytest.mark.parametrize("name,kw", [f for f in FAMILIES
                                     if f[0] in ("RmatHashStream",
                                                 "SbmHashStream",
                                                 "NearCliqueStream")])
@pytest.mark.parametrize("cs", [1000, 3072])
def test_device_chunks_equal_jax_device(name, kw, cs):
    """Every padded chunk, the ragged last one and a chunk past the end
    (all sentinel) included."""
    ts, js = _pair(name, kw)
    n = ts.num_vertices
    chunks = ts.num_chunks(cs)
    assert chunks == js.num_device_chunks(cs)
    for i in range(chunks + 1):
        got = ts.device_chunk(i, cs, n, CPU)
        assert got.dtype == torch.int32 and got.shape == (cs, 2)
        assert np.array_equal(got.numpy(), _ref_chunk(js, i, cs, n))


@pytest.mark.parametrize("mode,scale,keys_seed,params", [
    (synth.RMAT, 22, 42, (0.57, 0.19, 0.19)),
    (synth.RMAT, 31, 3, (0.45, 0.15, 0.15)),
    (synth.SBM, 22, 42, (0.05, 64)),
    (synth.SBM, 12, 1, (1.0, 2)),
    (synth.SBM, 22, 42, (0.02, 1 << 14)),  # near-clique, clique bits 8
])
@pytest.mark.parametrize("start,count", [(0, 2048), (CARRY - 1000, 1500),
                                         (7 * 2048, 2048 - 345)])
def test_hash_chunk_plain_equals_jax(mode, scale, keys_seed, params, start,
                                     count):
    """``hash_chunk`` on the CPU (its plain version) against the JAX
    package's device functions: the carry, a ragged count and both
    modes."""
    # ids reach 2^31 - 1 at scale 31, where the sentinel must stay int32
    pad, n = 2048, min(1 << scale, 2**31 - 1)
    if mode == synth.RMAT:
        keys = generators._rmat_hash_keys(scale, keys_seed)
        th = generators._rmat_hash_thresholds(*params)
        got = synth.hash_chunk(mode, start, count, pad, n, keys, th, CPU)
        ref = jgen.rmat_hash_chunk_device(scale, start, count, pad, n,
                                          *params, seed=keys_seed)
    else:
        p_out, nb = params
        bits = scale - (nb.bit_length() - 1)
        t_out = generators._sbm_t_out(p_out)
        got = synth.hash_chunk(mode, start, count, pad, n,
                               generators._sbm_hash_keys(keys_seed),
                               (t_out, nb, bits), CPU)
        ref = jgen._sbm_device_chunk_fn()(
            (np.uint32(start & 0xFFFFFFFF), np.uint32(start >> 32)), count,
            pad, tuple(jgen._sbm_hash_keys(keys_seed)), t_out, nb, bits, n)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert (got[count:] == n).all()


@pytest.mark.parametrize("name,kw", FAMILIES[1:], ids=FAMILY_IDS[1:])
@pytest.mark.parametrize("k", [None, 1, 2, 8])
def test_ground_truth_and_planted_ratio(name, kw, k):
    ts, js = _pair(name, kw)
    if k is not None and js.n_blocks % k:
        for fn in ("ground_truth", "planted_cut_ratio"):
            with pytest.raises(ValueError) as ref:
                getattr(js, fn)(k)
            with pytest.raises(ValueError) as got:
                getattr(ts, fn)(k)
            assert str(got.value) == str(ref.value)
        return
    assert np.array_equal(ts.ground_truth(k), js.ground_truth(k))
    assert ts.planted_cut_ratio(k) == js.planted_cut_ratio(k)


@pytest.mark.parametrize("spec", [
    "sbm-hash:10:1:0.1", "sbm-hash:10:3:0.1", "sbm-hash:4:32:0.1",
    "sbm-hash:10:4:1.5", "sbm-hash:10:4:-0.1", "sbm-hash:32:4:0.1",
    "plsbm-hash:4:16:0.1", "plsbm-hash:10:6:0.1", "plsbm-hash:10:4:2",
    "bipartite-hash:1:2:0.1", "bipartite-hash:4:16:0.1",
    "bipartite-hash:10:4:1.01", "nearclique-hash:10:0:0.1",
    "nearclique-hash:10:10:0.1", "nearclique-hash:10:4:-1",
    "nearclique-hash:32:4:0.1", "rmat-hash:33", "rmat-hash:0",
    "rmat-hash:10:0", "rmat:41", "rmat:10:1:2:3", "rmat-hash:x",
    "sbm-hash:10:4", "sbm-hash:10:4:0.1:1:2:3", "sbm-hash:10:4:x",
    "sbm-hash:10:4:0.1:0"])
def test_invalid_specs_raise_where_the_reference_raises(spec):
    with pytest.raises(ValueError) as ref:
        jes.open_input(spec)
    with pytest.raises(ValueError) as got:
        edgestream.open_input(spec)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("fn,args", [
    ("sbm_hash_range", (10, 0, 10, 1, 0.1)),
    ("sbm_hash_range", (10, 0, 10, 3, 0.1)),
    ("sbm_hash_range", (4, 0, 10, 32, 0.1)),
])
def test_range_checks_raise_where_the_reference_raises(fn, args):
    with pytest.raises(ValueError) as ref:
        getattr(jgen, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(generators, fn)(*args)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("spec,n_vertices", [
    ("sbm-hash:10:4:0.1", 1000), ("rmat-hash:10", 1023),
    ("rmat:10:2:1", 2048)])
def test_contradicting_num_vertices_raises(spec, n_vertices):
    with pytest.raises(ValueError) as ref:
        jes.open_input(spec, n_vertices=n_vertices)
    with pytest.raises(ValueError) as got:
        edgestream.open_input(spec, n_vertices=n_vertices)
    assert str(got.value) == str(ref.value)
    assert edgestream.open_input(spec, n_vertices=1 << int(
        spec.split(":")[1])).num_vertices == 1 << int(spec.split(":")[1])


@pytest.mark.parametrize("cs", [1000, 1 << 14, 1 << 22])
def test_rmat_replay_stream_equal(cs):
    ts = edgestream.open_input("rmat:11:4:5")
    js = jes.open_input("rmat:11:4:5")
    assert ts.num_vertices == js.num_vertices
    assert ts.clamp_chunk_edges(cs) == js.clamp_chunk_edges(cs)
    got, ref = list(ts.chunks(cs)), list(js.chunks(cs))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert np.array_equal(generators.rmat(9, 4, seed=2), jgen.rmat(9, 4,
                                                                   seed=2))


def test_delta_inputs_are_refused_with_the_queue_item():
    # delta: inputs are read since the incremental slice; a missing log is
    # refused with the reference's message
    with pytest.raises(ValueError, match="does not exist") as got:
        edgestream.open_input("delta:/nonexistent.log")
    with pytest.raises(ValueError) as want:
        jes.open_input("delta:/nonexistent.log")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["sbm-hash:12:16:0.05:4:7",
                                  "nearclique-hash:12:6:0.02:4:7"])
def test_device_streams_synthesize_and_host_ones_stage(spec):
    """Streams with a device body go through ``hash_chunk``; the others
    have no ``device_chunk`` and take the staged ring."""
    assert hasattr(edgestream.open_input(spec), "device_chunk")
    for other in ("plsbm-hash:12:16:0.05", "bipartite-hash:12:8:0.02",
                  "rmat:10"):
        assert not hasattr(edgestream.open_input(other), "device_chunk")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hash_chunk_matches_plain_on_card():
    dev = _card()
    n = 1 << 22
    rk = generators._rmat_hash_keys(22, 42)
    th = generators._rmat_hash_thresholds(0.57, 0.19, 0.19)
    sk = generators._sbm_hash_keys(42)
    cases = [(synth.RMAT, 0, 1 << 20, 1 << 20, rk, th),
             (synth.RMAT, CARRY, 1 << 20, 1 << 20, rk, th),
             (synth.RMAT, 0, 1000, 4096, generators._rmat_hash_keys(31, 3),
              th),
             (synth.SBM, 0, 77_777, 1 << 17,
              sk, (generators._sbm_t_out(0.05), 64, 16)),
             (synth.SBM, CARRY, 1 << 17, 1 << 17,
              sk, (generators._sbm_t_out(1.0), 2, 21))]
    for mode, start, count, pad, keys, params in cases:
        want = synth.hash_chunk_plain(mode, start, count, pad, n, keys,
                                      params, CPU)
        got = synth.hash_chunk(mode, start, count, pad, n, keys, params,
                               dev)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
