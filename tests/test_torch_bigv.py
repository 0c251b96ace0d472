"""The port's vertex-sharded build (``sheep_tpu_torch/parallel/bigv.py``,
``ops/routed.py``, backend ``torch-bigv``) at ``device="cpu"`` on virtual
shards, against the JAX package's ``tpu-bigv`` on the 8-device virtual CPU
mesh of ``tests/conftest.py``, with zero tolerance: the forest, pos, the
degrees, the assignment, the edge cut, total, comm volume and balance,
``fixpoint_rounds`` and every counter of ``build_stats``
(``collective_ops``, ``collective_bytes``, ``compactions``, ``q_rounds``,
``host_syncs``, ``device_rounds``, ``folded_bytes``, ...).

- the cases of ``tests/test_bigv.py``: karate, rmat9, grid, path, a star's
  hub (every request to one owner), two components; shard counts 1, 2,
  3, 5 and 8 (3 and 5: B does not divide n + 1); jumps 1, 2 and 8; the
  worst-case displacement order; duplicates and self-loops; the lifting
  and compaction path (RMAT-13 at Q = 16,384 > TAIL_Q); the hoisted stack
  against per-round squaring; the balance budget;
- the cross-backend invariant: equal to the single-device port;
- the routed kernels' plain versions against their JAX expressions under
  ``shard_map``, ``all_gather``/``all_to_all`` against ``lax``'s, the
  segment state's stop, the wrappers' device checks;
- the entry points, the CLI (``--backend torch-bigv``, ``--jumps``,
  ``--hoist-bytes``, ``--list-backends``, ``--version``, the backend
  chosen by the card's memory when ``--backend`` is left out).
"""

import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from sheep_tpu.backends.base import get_backend
from sheep_tpu.core import pure as jpure
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import generators as jgen
from sheep_tpu.parallel import mesh as jmesh
from sheep_tpu.parallel.bigv import BigVPipeline as JBigV
from sheep_tpu.parallel.bigv import cached_pipeline

import sheep_tpu_torch
from sheep_tpu_torch import cli
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import routed
from sheep_tpu_torch.parallel import mesh
from sheep_tpu_torch.parallel.bigv import BigVPipeline

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

SCORES = ("edge_cut", "total_edges", "comm_volume", "balance")


@pytest.fixture(autouse=True, scope="module")
def _eight_shards():
    """Eight virtual CPU shards, one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh.force_cpu_devices(8)
    yield
    mesh.force_cpu_devices(1)
    torch.set_num_threads(threads)


CASES = {
    "karate": lambda: (jgen.karate_club(), 34),
    "rmat9": lambda: (jgen.rmat(9, 8, seed=21), 512),
    "grid": lambda: (jgen.grid_graph(16, 16), 256),
    "path": lambda: (jgen.path_graph(200), 200),
    "star_hub": lambda: (jgen.star_graph(300), 300),
    "two_components": lambda: (
        np.concatenate([jgen.path_graph(40),
                        40 + jgen.star_graph(50)]), 90),
}


def _jax_run(e, n, d=8, cs=128, jumps=4, k=8, **kw):
    pipe = cached_pipeline(n, cs, jmesh.shards_mesh(d), jumps=jumps, **kw)
    return pipe.run(jes.EdgeStream.from_array(e, n_vertices=n), k=k,
                    comm_volume=True)


def _port_run(e, n, d=8, cs=128, jumps=4, k=8, **kw):
    pipe = BigVPipeline(n, cs, mesh.shards_mesh(d, device="cpu"),
                        jumps=jumps, **kw)
    return pipe.run(edgestream.EdgeStream.from_array(e, n_vertices=n), k=k,
                    comm_volume=True)


def _assert_same(out, ref):
    """Every output and every counter of the reference, exactly."""
    for key in ("parent", "pos", "degrees", "assignment"):
        assert np.array_equal(out[key], ref[key]), key
    for key in SCORES + ("fixpoint_rounds", "k"):
        assert out[key] == ref[key], key
    for key, want in ref["build_stats"].items():
        assert out["build_stats"].get(key) == want, key


def _oracle_parent(e, n):
    return jpure.build_elim_tree(
        e, jpure.elimination_order(jpure.degrees(e, n))).parent


def _pair(e, n, **kw):
    ref = _jax_run(e, n, **kw)
    out = _port_run(e, n, **kw)
    _assert_same(out, ref)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_and_oracle(name):
    e, n = CASES[name]()
    out = _pair(e, n)
    assert np.array_equal(out["parent"], _oracle_parent(e, n))
    ref = jpure.partition_arrays(e, 8, n=n)
    assert (out["edge_cut"], out["total_edges"], out["comm_volume"]) == \
        (ref.edge_cut, ref.total_edges, ref.comm_volume)
    assert np.array_equal(out["assignment"], ref.assignment)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_shard_count_invariance(d):
    """The same forest on any mesh, B dividing n + 1 or not, the
    reference's counters at each, and the single-device port's result
    (the cross-backend invariant)."""
    e, n = jgen.rmat(8, 8, seed=33), 256
    out = _pair(e, n, d=d)
    assert np.array_equal(out["parent"], _oracle_parent(e, n))
    single = TorchBackend(chunk_edges=128, device="cpu").partition(
        edgestream.EdgeStream.from_array(e, n_vertices=n), 8,
        keep_tree=True)
    assert np.array_equal(out["parent"], single.tree["parent"])
    assert np.array_equal(out["assignment"], single.assignment)
    assert (out["edge_cut"], out["comm_volume"]) == (single.edge_cut,
                                                     single.comm_volume)


@pytest.mark.parametrize("lift", [False, True])
def test_rounds_through_the_collectives(lift):
    """The round driven through ``all_gather``/``all_to_all`` and the
    wrappers one card after another (the path of the CPU and of a mesh of
    several cards; ``CardRound``, one CUDA card's one-call round, is not
    taken) gives the reference's forest and counters: the jump tail at
    D = 3, and the lifting, compaction and hoisted stack at D = 5."""
    pipe = BigVPipeline(256, 128, mesh.shards_mesh(3, device="cpu"))
    assert not pipe.card_rounds
    if lift:
        e, n = jgen.rmat(12, 16, seed=41), 1 << 12
        _pair(e, n, d=5, cs=len(e) // 2, hoist_bytes=4 * 820 * 4)
    else:
        _pair(jgen.rmat(8, 8, seed=33), 256, d=3)


@pytest.mark.parametrize("jumps", [1, 2, 8])
def test_jumps_invariance(jumps):
    e, n = jgen.rmat(8, 8, seed=34), 256
    out = _pair(e, n, jumps=jumps)
    assert np.array_equal(out["parent"], _oracle_parent(e, n))


def test_worst_case_displacement_order():
    """Descending pos[hi] maximizes the displacement chains through the
    scatter's answers."""
    e, n = jgen.rmat(9, 4, seed=7), 512
    pos = jpure.elimination_order(jpure.degrees(e, n))
    key = np.maximum(pos[e[:, 0]], pos[e[:, 1]])
    out = _pair(e[np.argsort(-key, kind="stable")], n, cs=64)
    assert np.array_equal(out["parent"], _oracle_parent(e, n))


def test_duplicates_and_self_loops():
    base = jgen.random_graph(60, 150, seed=17)
    loops = np.stack([np.arange(10), np.arange(10)], axis=1)
    e = np.concatenate([base, base, loops, base])
    e = e[np.random.default_rng(5).permutation(len(e))]
    out = _pair(e, 60)
    assert np.array_equal(out["parent"], _oracle_parent(e, 60))


def test_lift_and_compaction_path():
    """RMAT-13 in one chunk a shard: Q = 16,384 > TAIL_Q, so the first
    segments lift (routed squarings at width B), then the live set
    collapses, compacts with in-shard dedup and runs the jump tail; every
    counter is the reference's."""
    n = 1 << 13
    e = jgen.rmat(13, 16, seed=41)
    out = _pair(e, n, cs=len(e) // 8)
    assert np.array_equal(out["parent"], _oracle_parent(e, n))
    st = out["build_stats"]
    assert st["compactions"] >= 1 and st["collective_bytes"] > 0
    assert st["owned_scatter_min_launches"] == 0  # the plain versions ran


def test_hoisted_lifting_matches_per_round_squaring():
    """The stack built once a segment (``hoist_bytes=1 << 30``: L - 1
    levels) gives the forest of per-round squaring (``hoist_bytes=0``),
    with the reference's counters at both; the byte cap's arithmetic and
    the variable as the default's fallback only."""
    n = 1 << 13
    e = jgen.rmat(13, 16, seed=5)
    outs = {}
    for hb in (0, 1 << 30):
        pipe = BigVPipeline(n, len(e), mesh.shards_mesh(8, device="cpu"),
                            hoist_bytes=hb)
        assert pipe.hoist_levels == (0 if hb == 0 else pipe.lift_levels - 1)
        assert pipe.hoist_levels * 4 * pipe.B <= hb
        outs[hb] = _pair(e, n, cs=len(e) // 8, hoist_bytes=hb)
    for key in ("parent", "assignment"):
        assert np.array_equal(outs[0][key], outs[1 << 30][key])
    assert outs[0]["build_stats"]["collective_bytes"] != \
        outs[1 << 30]["build_stats"]["collective_bytes"]
    tiny = BigVPipeline(n, len(e), mesh.shards_mesh(8, device="cpu"),
                        hoist_bytes=4 * 100)
    assert 4 * 100 < 4 * tiny.B and tiny.hoist_levels == 0


def test_hoist_bytes_variable_is_the_default_only(monkeypatch):
    monkeypatch.setenv("SHEEP_BIGV_HOIST_BYTES", str(1 << 30))
    m = mesh.shards_mesh(2, device="cpu")
    assert BigVPipeline(1000, 128, m).hoist_levels == 9
    assert BigVPipeline(1000, 128, m, hoist_bytes=0).hoist_levels == 0
    j = JBigV(1000, 128, jmesh.shards_mesh(2))
    assert j.hoist_levels == 9


def test_balance_budget_respected():
    """``alpha`` reaches the host split as in the reference: the tight
    budget's balance obeys the bound the default exceeds, on both."""
    e, n, k, beta = jgen.rmat(10, 8, seed=7), 1 << 10, 64, 1.1

    def run(alpha):
        got = TorchBigVBackend(chunk_edges=512, alpha=alpha, n_devices=8,
                               device="cpu").partition(
            edgestream.EdgeStream.from_array(e, n_vertices=n), k,
            comm_volume=False)
        ref = get_backend("tpu-bigv", chunk_edges=512, alpha=alpha,
                          n_devices=8).partition(
            jes.EdgeStream.from_array(e, n_vertices=n), k,
            comm_volume=False)
        assert np.array_equal(got.assignment, ref.assignment)
        assert got.balance == ref.balance
        return got

    default, tight = run(1.0), run(beta - 1.0)
    bound = beta + k * 1.0 / n
    assert tight.balance <= bound + 1e-9
    assert default.balance > bound


def test_tables_are_block_sharded():
    """No shard holds a whole table: a card's blocks are (S, B) with B the
    reference's, and shards of one device share one buffer."""
    n = 1 << 12
    pipe = BigVPipeline(n, 128, mesh.Mesh(["cpu"] * 8))
    ref = JBigV(n, 128, jmesh.shards_mesh(8))
    assert (pipe.B, pipe.rows) == (ref.B, ref.rows)
    blocks = pipe._shard_table(np.full(n + 1, n, np.int32))
    assert [tuple(b.shape) for b in blocks] == [(8, pipe.B)]
    assert pipe.B < (n + 1) / 4
    with pytest.raises(ValueError, match="consecutive"):
        BigVPipeline(n, 128, mesh.Mesh(["cpu", "meta", "cpu"]))


# -- the routed round's pieces against the JAX expressions -----------------

def _shard_map(fn, d, in_specs, out_specs):
    return jax.jit(jmesh.shard_map(fn, mesh=jmesh.shards_mesh(d),
                                   in_specs=in_specs, out_specs=out_specs))


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("d", [1, 3, 5, 8])
def test_routed_lookup_and_scatter_match_jax(d):
    """``owned_gather``'s and ``owned_scatter_min``'s plain versions and
    the requester's fold against ``_lookup`` and ``_scatter_min`` under
    ``shard_map``: the owners' answers, the folded answers and the
    min-folded table, with requests at the sentinel row n, past the table
    and below 0, and duplicate rows; then the pipeline's own routed
    lookup over the mesh's shards."""
    P = jax.sharding.PartitionSpec
    S = jmesh.SHARD_AXIS
    rng = np.random.default_rng(d)
    n, W = 97, 64
    B = -(-(n + 1) // d)
    table = np.full(d * B, n, np.int32)
    table[:n] = rng.integers(0, n + 1, n)
    q = rng.integers(-3, d * B + 5, (d, W)).astype(np.int32)
    q[:, :5] = n
    val = rng.integers(0, n + 1, (d, W)).astype(np.int32)

    def jax_side(t_local, q_l, v_l):
        gq = lax.all_gather(q_l[0], S)
        gv = lax.all_gather(v_l[0], S)
        local = gq - lax.axis_index(S) * B
        ok = (local >= 0) & (local < B)
        part = jnp.where(ok, t_local[jnp.clip(local, 0, B - 1)], n)
        looked = jnp.min(lax.all_to_all(part, S, 0, 0), axis=0)
        idx = jnp.where(ok, local, B)
        new_t = t_local.at[idx.ravel()].min(gv.ravel(), mode="drop")
        lidx = jnp.clip(local, 0, B - 1)
        old_p = jnp.where(ok, t_local[lidx], n)
        new_p = jnp.where(ok, new_t[lidx], n)
        old = jnp.min(lax.all_to_all(old_p, S, 0, 0), axis=0)
        new = jnp.min(lax.all_to_all(new_p, S, 0, 0), axis=0)
        return part[None], looked[None], new_t, old[None], new[None]

    spec = P(S, None)
    outs = [_np(x) for x in _shard_map(
        jax_side, d, (P(S), spec, spec),
        (P(S, None, None), spec, P(S), spec, spec))(
            jnp.asarray(table), jnp.asarray(q), jnp.asarray(val))]
    part, looked, new_t, old, new = outs
    tt = torch.from_numpy(table.reshape(d, B).copy())
    qt, vt = torch.from_numpy(q), torch.from_numpy(val)
    answers = routed.owned_answers_plain(tt, 0, qt, n)
    assert np.array_equal(answers.numpy(), part)
    assert np.array_equal(routed.routed_fold_plain(answers).numpy(), looked)
    o, nw = routed.owned_scatter_min_plain(tt, 0, qt, vt, n)
    assert np.array_equal(tt.numpy().ravel(), new_t)
    assert np.array_equal(routed.routed_fold_plain(o).numpy(), old)
    assert np.array_equal(routed.routed_fold_plain(nw).numpy(), new)
    # the same through the wrappers, the collectives and the card split
    pipe = BigVPipeline(n, W, mesh.Mesh(["cpu"] * d))
    got = pipe._resolve(pipe._place(table), [qt])
    assert np.array_equal(got[0].numpy(), looked)


def test_round_end_and_climb_step_match_jax():
    """``round_end_plain`` and ``routed_step_plain`` against the
    reference's rewrite (``bigv.py:265-283``, ``:319-322``) on random
    slots with retired, displaced, looped and climbing cases."""
    rng = np.random.default_rng(3)
    n, C = 50, 4096
    lo = rng.integers(0, n + 1, C).astype(np.int32)
    hi = rng.integers(0, n + 1, C).astype(np.int32)
    new = np.where(rng.random(C) < 0.3, hi,
                   rng.integers(0, n + 1, C)).astype(np.int32)
    old = rng.integers(0, n + 1, C).astype(np.int32)
    cur = np.where(rng.random(C) < 0.2, hi,
                   rng.integers(0, n + 1, C)).astype(np.int32)

    def ref(lo_, hi_, new, old, cur):
        retire = hi_ == new
        displaced = retire & (new < old) & (old < n)
        loop = cur == hi_
        out_lo = jnp.where(retire, jnp.where(displaced, new, n),
                           jnp.where(loop, n, cur))
        out_hi = jnp.where(retire, jnp.where(displaced, old, n),
                           jnp.where(loop, n, hi_))
        return out_lo, out_hi

    want = [_np(x) for x in jax.jit(ref)(lo, hi, new, old, cur)]
    t = {k: torch.from_numpy(v) for k, v in
         dict(lo=lo, hi=hi, new=new, old=old, cur=cur).items()}
    got = routed.round_end_plain(t["old"], t["new"], t["cur"], t["lo"],
                                 t["hi"], n)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    rep = torch.from_numpy(rng.integers(0, n + 1, (3, 1, C))
                           .astype(np.int32))
    step, cand = routed.routed_step_plain(rep, t["hi"][None],
                                          t["cur"][None])
    c = np.asarray(rep.numpy().min(0))
    assert np.array_equal(cand.numpy(), c)
    assert np.array_equal(step.numpy(), np.where(c < hi, c, cur))


def test_segment_state_stops_every_kernel():
    """A segment's accounting counts rounds and live words as the
    reference's loop condition; once STOP is set no wrapper changes
    anything (the rounds the host enqueued after the stop)."""
    d, n = 3, 20
    st = routed.new_state(d, "cpu")
    lo = torch.tensor([[1, n, 2], [n, n, n]], dtype=torch.int32)
    routed.count_live(lo, n, 1, st)
    routed.account(st, 1, 2, budget=2, start=True)
    assert st.tolist()[:4] == [0, 0, 2, 2] and st[routed.WORDS + 1] == 0
    for rounds in (1, 2):
        routed.count_live(lo, n, 1, st)
        routed.account(st, 1, 2, budget=2)
        assert st.tolist()[:4] == [int(rounds == 2), rounds, 2, 2]
    before = st.clone()
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    keep = table.clone()
    req = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0]], dtype=torch.int32)
    routed.owned_scatter_min(table, 0, req, torch.zeros_like(req), n, st)
    assert torch.equal(table, keep)
    out = torch.full((1, 3), 7, dtype=torch.int32)
    routed.routed_step(torch.zeros((3, 1, 3), dtype=torch.int32), out,
                       state=st)
    routed.routed_round_end(torch.zeros((3, 2, 3), dtype=torch.int32),
                            lo.clone(), lo.clone(), lo, lo.clone(), n, 1,
                            st)
    assert torch.equal(out, torch.full((1, 3), 7, dtype=torch.int32))
    assert torch.equal(st, before)


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version for CPU tensors only; any other
    device raises (no fallback)."""
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    req = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        routed.owned_gather(meta, 0, req, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        routed.routed_step(torch.empty((2, 1, 3), dtype=torch.int32,
                                       device="meta"),
                           torch.empty((1, 3), dtype=torch.int32,
                                       device="meta"))
    with pytest.raises(TypeError):
        routed.owned_gather(meta.long(), 0, req, 5)
    with pytest.raises(ValueError, match="state"):
        routed.owned_gather(torch.zeros((2, 4), dtype=torch.int32), 0,
                            torch.zeros((2, 3), dtype=torch.int32), 5,
                            routed.new_state(3, "cpu"))
    # the one-call round runs its plain version on the CPU only
    P = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    slots = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        routed.CardRound(P, slots, slots.clone(), 5, [], routed.new_state(
            2, "meta"), 4)


@pytest.mark.parametrize("d", [3, 8])
def test_all_gather_all_to_all_match_lax(d):
    """``all_gather`` and ``all_to_all`` of per-shard tensors against the
    lax collectives under ``shard_map``: from the rows of one buffer
    (views, nothing copied) and from separate tensors."""
    P = jax.sharding.PartitionSpec
    S = jmesh.SHARD_AXIS
    rng = np.random.default_rng(d)
    x = rng.integers(-50, 50, (d, 5)).astype(np.int32)
    blocks = rng.integers(-50, 50, (d, d, 5)).astype(np.int32)
    g = _np(_shard_map(lambda v: lax.all_gather(v[0], S)[None], d,
                       (P(S, None),), P(S, None, None))(jnp.asarray(x)))
    a = _np(_shard_map(lambda v: lax.all_to_all(v[0], S, 0, 0)[None], d,
                       (P(S, None, None),), P(S, None, None))(
        jnp.asarray(blocks)))
    buf = torch.from_numpy(x)
    views = mesh.all_gather([buf[i] for i in range(d)])
    assert views[0].data_ptr() == buf.data_ptr()
    copies = mesh.all_gather([buf[i].clone() for i in range(d)])
    for got in (views, copies):
        assert np.array_equal(np.stack([t.numpy() for t in got]), g)
    bb = torch.from_numpy(blocks)
    views = mesh.all_to_all([bb[j] for j in range(d)])
    assert views[0].data_ptr() == bb.data_ptr()
    copies = mesh.all_to_all([bb[j].clone() for j in range(d)])
    for got in (views, copies):
        assert np.array_equal(np.stack([t.numpy() for t in got]), a)


# -- entry points and the CLI ------------------------------------------------

def test_entry_points_and_cli_match_single_device(tmp_path, capsys):
    """``partition``/``partition_multi``/the CLI with ``torch-bigv`` equal
    the single-device port (D = 1 and 8); the knobs it does not take
    raise; its flags pass through."""
    spec = "rmat-hash:10:8:2"
    single = sheep_tpu_torch.partition(spec, 8, device="cpu",
                                       keep_tree=True)
    for d in (1, 8):
        res = sheep_tpu_torch.partition(spec, 8, device="cpu",
                                        backend="torch-bigv", n_devices=d,
                                        keep_tree=True, jumps=16)
        assert np.array_equal(res.tree["parent"], single.tree["parent"])
        assert np.array_equal(res.assignment, single.assignment)
        for key in SCORES:
            assert getattr(res, key) == getattr(single, key), key
        assert res.backend == "torch-bigv:cpu"
        # the reference's clamp of the 2^20 default: max(1024, ceil(m/D))
        assert res.diagnostics["chunk_edges_effective"] == \
            max(1024, -(-8 * (1 << 10) // d))
    # left out, the chunk is the backend's own 2^20, as the reference's
    # partition(..., backend="tpu-bigv") takes it
    from sheep_tpu.backends.tpu_bigv_backend import TpuBigVBackend

    want = inspect.signature(TpuBigVBackend.__init__).parameters[
        "chunk_edges"].default
    for entry in (sheep_tpu_torch.partition, sheep_tpu_torch.partition_multi):
        default = inspect.signature(entry).parameters["chunk_edges"].default
        assert sheep_tpu_torch._backend(
            "cpu", default, 0, 1.0, 0, 0, {}, "torch-bigv").chunk_edges == \
            want
    multi = sheep_tpu_torch.partition_multi(spec, [8, 4], device="cpu",
                                            backend="torch-bigv")
    assert np.array_equal(multi[0].assignment, single.assignment)
    for bad, kw in (("dispatch_batch", dict(dispatch_batch=2)),
                    ("h2d_ring", dict(h2d_ring=2)),
                    ("warm_schedule", dict(warm_schedule=())),
                    ("round_log", dict(round_log=[]))):
        with pytest.raises(ValueError, match=bad):
            sheep_tpu_torch.partition(spec, 8, device="cpu",
                                      backend="torch-bigv", **kw)
    out = str(tmp_path / "g.parts")
    assert cli.main(["--input", spec, "--k", "8", "--device", "cpu",
                     "--backend", "torch-bigv", "--n-devices", "8",
                     "--jumps", "16", "--hoist-bytes", str(1 << 20),
                     "--segment-rounds", "4", "--output", out,
                     "--json"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["edge_cut"], line["total_edges"]) == (single.edge_cut,
                                                       single.total_edges)
    assert line["backend"] == "torch-bigv:cpu"
    assert np.array_equal(np.loadtxt(out, dtype=np.int64),
                          single.assignment)
    for argv in (["--backend", "torch-bigv", "--dispatch-batch", "2"],
                 ["--backend", "torch-sharded", "--jumps", "4"],
                 ["--jumps", "4"], ["--backend", "torch", "--n-devices", "2"],
                 ["--backend", "torch-bigv", "--jumps", "0"]):
        with pytest.raises(SystemExit):
            cli.main(["--input", spec, "--k", "8", "--device", "cpu",
                      *argv])


def test_list_backends(capsys):
    assert cli.main(["--list-backends"]) == 0
    assert capsys.readouterr().out.strip() == "torch torch-sharded torch-bigv"


def test_version(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--version"])
    assert exc.value.code == 0
    assert capsys.readouterr().out.strip() == "sheep_tpu_torch 0.1.0"


class _Counted:
    """A stream stand-in whose only property is its vertex count."""

    def __init__(self, n):
        self.num_vertices = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("n,want", [((1 << 29) + 1, "torch-bigv"),
                                    (1 << 29, "torch")])
def test_auto_backend_by_card_memory(monkeypatch, capsys, n, want):
    """``--backend`` left out on CUDA: ``torch-bigv`` once V passes the
    replicated tables' ceiling at 0.9 of the card's memory (a 16 GiB card
    faked: 2^29 vertices, as the reference's model says), with the note
    on stderr; ``torch`` up to it, and always on the CPU."""
    import argparse

    from sheep_tpu_torch.backends import torch_backend
    from sheep_tpu_torch.io import edgestream as port_es

    monkeypatch.setattr(torch_backend, "device_memory_bytes",
                        lambda device: 16 << 30)
    monkeypatch.setattr(port_es, "open_input",
                        lambda spec, n_vertices=None: _Counted(n))
    args = argparse.Namespace(input="g.bin32", num_vertices=None,
                              chunk_edges=None)
    assert cli._auto_backend(args, torch.device("cuda")) == want
    assert args.num_vertices == n
    err = capsys.readouterr().err
    assert ("auto-selected the vertex-sharded torch-bigv" in err) == \
        (want == "torch-bigv")
    assert cli._auto_backend(args, torch.device("cpu")) == "torch"


def test_bigv_entry_points_need_a_gpu():
    """Without a GPU the vertex-sharded build raises unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBigVBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sheep_tpu_torch.partition("rmat-hash:8", 2, backend="torch-bigv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sheep_tpu_torch.partition_multi("rmat-hash:8", [2, 4],
                                        backend="torch-bigv")
