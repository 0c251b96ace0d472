"""The one-card round of the vertex-sharded build (``ops/routed.py``'s
card forms: ``owned_scatter_min(fold=True)``, ``routed_climb``,
``routed_square``, ``CardRound`` and their plain versions) on the CPU,
against the JAX package's ``tpu-bigv`` on the 8-device virtual CPU mesh of
``tests/conftest.py``, with zero tolerance:

- the folded scatter-min, the jump climb and the squaring against
  ``_scatter_min`` / ``_lookup`` and the climb of ``_make_fold_seg``
  (``sheep_tpu/parallel/bigv.py:150-182``, ``:310-324``) under
  ``shard_map`` at D in 1, 2, 3, 5, 8: duplicate requests, the sentinel
  row, values of n and more, requests below 0 and past the table, chains
  longer than the jump count and hi barriers mid-chain;
- one segment of ``fold_segment`` through ``CardRound``'s plain version
  (``card_round_plain``) against the JAX package's own segment programs
  (``_make_fold_seg``, ``_make_fold_lift``, ``_make_fold_lift_hoisted``):
  the forest, the slots, the rounds, live and max-live;
- whole builds with every round a ``CardRound`` against ``tpu-bigv``: the
  forest, the scores and every ``build_stats`` counter, tail and lifting,
  with and without the hoisted stack;
- the launches a tail and a lifting round, by kernel, from the function
  ``CardRound`` counts with, and the stop state and device checks of the
  new wrappers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import generators as jgen
from sheep_tpu.parallel import mesh as jmesh
from sheep_tpu.parallel.bigv import BigVPipeline as JBigV
from sheep_tpu.parallel.bigv import cached_pipeline

from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import routed
from sheep_tpu_torch.parallel import mesh
from sheep_tpu_torch.parallel.bigv import BigVPipeline

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _forest(n: int, rows: int, rng, reach: int = 3) -> np.ndarray:
    """A (rows,) position-space forest: each position's parent 1 to
    ``reach`` positions later, 5% roots, the rows from n on the
    sentinel."""
    t = np.full(rows, n, np.int32)
    p = np.arange(n) + rng.integers(1, reach + 1, n)
    p[rng.random(n) < 0.05] = n
    t[:n] = np.minimum(p, n)
    return t


def _slots(n: int, d: int, q: int, rng, dead: float = 0.2):
    """(d, q) constraint slots lo < hi <= n - 1, ``dead`` of them (n, n),
    a few duplicates."""
    lo = rng.integers(0, n - 1, (d, q))
    hi = np.minimum(lo + rng.integers(1, 30, (d, q)), n - 1)
    off = rng.random((d, q)) < dead
    lo[off] = n
    hi[off] = n
    lo[:, 1::7] = lo[:, 0:1]
    hi[:, 1::7] = hi[:, 0:1]
    return lo.astype(np.int32), hi.astype(np.int32)


def _shard_map(fn, d, in_specs, out_specs):
    return jax.jit(jmesh.shard_map(fn, mesh=jmesh.shards_mesh(d),
                                   in_specs=in_specs, out_specs=out_specs))


# -- the card forms against the JAX expressions ------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_card_forms_match_jax(d):
    """The folded scatter-min, the round's jump climb (its first step
    from the post-round parent, then ``jumps - 1`` lookups of the scatter's
    table) and the squaring against the reference's routed expressions,
    through the plain versions and through the wrappers (which run them
    on the CPU)."""
    P = jax.sharding.PartitionSpec
    S = jmesh.SHARD_AXIS
    rng = np.random.default_rng(100 + d)
    n, W, J = 97, 64, 6
    B = -(-(n + 1) // d)
    table = _forest(n, d * B, rng)
    lo = rng.integers(-3, d * B + 5, (d, W)).astype(np.int32)
    lo[:, :5] = n                              # the sentinel row
    lo[:, 5:9] = lo[:, 9:10]                   # duplicate requests
    hi = np.minimum(lo + rng.integers(1, 40, (d, W)), n).astype(np.int32)
    hi[:, 20:24] = n                           # chains past the jump count
    val = rng.integers(0, n + 6, (d, W)).astype(np.int32)  # some >= n

    def jax_side(t_local, lo_l, hi_l, v_l):
        me = lax.axis_index(S)

        def lookup(tab, q):
            gq = lax.all_gather(q, S)
            local = gq - me * B
            ok = (local >= 0) & (local < B)
            part = jnp.where(ok, tab[jnp.clip(local, 0, B - 1)], n)
            return jnp.min(lax.all_to_all(part, S, 0, 0), axis=0)

        lo0, hi0 = lo_l[0], hi_l[0]
        glo = lax.all_gather(lo0, S)
        gval = lax.all_gather(v_l[0], S)
        local = glo - me * B
        ok = (local >= 0) & (local < B)
        idx = jnp.where(ok, local, B)
        new_t = t_local.at[idx.ravel()].min(gval.ravel(), mode="drop")
        lidx = jnp.clip(local, 0, B - 1)
        old = jnp.min(lax.all_to_all(jnp.where(ok, t_local[lidx], n), S,
                                     0, 0), axis=0)
        new = jnp.min(lax.all_to_all(jnp.where(ok, new_t[lidx], n), S, 0,
                                     0), axis=0)
        cur = jnp.where(new < hi0, new, lo0)
        for _ in range(J - 1):
            p = lookup(new_t, cur)
            cur = jnp.where(p < hi0, p, cur)
        return (new_t, old[None], new[None], cur[None],
                lookup(t_local, t_local))

    spec = P(S, None)
    new_t, old, new, cur, sq = [np.asarray(x) for x in _shard_map(
        jax_side, d, (P(S), spec, spec, spec),
        (P(S), spec, spec, spec, P(S)))(
            jnp.asarray(table), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(val))]
    tt = torch.from_numpy(table.reshape(d, B).copy())
    lt, ht, vt = (torch.from_numpy(a) for a in (lo, hi, val))
    # the squaring of the table before the scatter
    assert np.array_equal(routed.routed_square_plain(tt, n).numpy().ravel(),
                          sq)
    assert np.array_equal(routed.routed_square(tt, n).numpy().ravel(), sq)
    # the folded scatter-min: plain (the parents before and after), and
    # through the wrapper (the parents before)
    t = tt.clone()
    o, nw = routed.owned_scatter_min_plain(t, 0, lt, vt, n, fold=True)
    assert np.array_equal(t.numpy().ravel(), new_t)
    assert np.array_equal(o.numpy(), old)
    assert np.array_equal(nw.numpy(), new)
    t = tt.clone()
    o = routed.owned_scatter_min(t, 0, lt, vt, n, fold=True)
    assert np.array_equal(t.numpy().ravel(), new_t)
    assert np.array_equal(o.numpy(), old)
    after = torch.from_numpy(new_t.reshape(d, B).copy())
    # the jump climb: plain, and the wrapper with its first candidate
    # (the post-round parent) stored
    got, first = routed.routed_climb_plain(after, lt, ht, J, n)
    assert np.array_equal(got.numpy(), cur)
    assert np.array_equal(first.numpy(), new)
    out, nw = torch.empty_like(lt), torch.empty_like(lt)
    routed.routed_climb(lt, ht, [(after, J)], n, out, new=nw)
    assert np.array_equal(out.numpy(), cur)
    assert np.array_equal(nw.numpy(), new)
    # the cap binds on some chain and a barrier stops another mid-chain
    longer, _ = routed.routed_climb_plain(after, lt, ht, J + 8, n)
    assert (longer != got).any()
    assert ((got.numpy() < hi - 1) & (got.numpy() == longer.numpy()) &
            (got.numpy() != lo)).any()


def test_climb_runs_split_at_tables():
    """Runs over several tables climb each in turn; a run of k steps
    equals k runs of one step on the same table."""
    rng = np.random.default_rng(7)
    n, d = 200, 4
    B = -(-(n + 1) // d)
    tabs = [torch.from_numpy(_forest(n, d * B, rng, reach=r).reshape(d, B))
            for r in (2, 5, 9)]
    lo, hi = (torch.from_numpy(a) for a in _slots(n, d, 50, rng))
    runs = [(tabs[0], 3), (tabs[1], 2), (tabs[2], 4)]
    a, _ = routed.climb_runs_plain(lo, hi, runs, n)
    b, _ = routed.climb_runs_plain(
        lo, hi, [(t, 1) for t, s in runs for _ in range(s)], n)
    assert torch.equal(a, b)
    out = lo.clone()
    routed.routed_climb(out, hi, runs, n, out)
    assert torch.equal(out, a)


# -- one segment through CardRound's plain version against the JAX fold ------

MODES = {
    # name: (lift, BigVPipeline options)
    "tail": (False, dict(jumps=5)),
    "lift": (True, dict(lift_levels=4, hoist_bytes=0)),
    "hoisted-all": (True, dict(lift_levels=4, hoist_bytes=1 << 30)),
    "hoisted-capped": (True, dict(lift_levels=5)),
}


@pytest.mark.parametrize("d,mode", [(d, "tail") for d in (1, 2, 3, 5, 8)]
                         + [(d, m) for d in (3, 8)
                            for m in ("lift", "hoisted-all",
                                      "hoisted-capped")])
def test_segment_through_card_round_matches_jax(d, mode):
    """``fold_segment`` with every round a ``CardRound`` (on the CPU its
    plain version) against the JAX package's segment program on the
    same forest and slots: P, lo, hi, rounds, live and max-live."""
    rng = np.random.default_rng(d * 10 + len(mode))
    n, Q, R = 300, 40, 4
    lift, kw = MODES[mode]
    kw = dict(kw, segment_rounds=R)
    B = -(-(n + 1) // d)
    if mode == "hoisted-capped":
        kw["hoist_bytes"] = 2 * 4 * B    # two of the four levels hoisted
    table = _forest(n, n + 1, rng, reach=2)
    lo, hi = _slots(n, d, Q, rng)
    jb = JBigV(n, Q, jmesh.shards_mesh(d), **kw)
    pipe = BigVPipeline(n, Q, mesh.Mesh(["cpu"] * d), card_rounds=True,
                        **kw)
    assert (pipe.B, pipe.hoist_levels) == (jb.B, jb.hoist_levels)
    if mode == "hoisted-capped":
        assert 0 < pipe.hoist_levels < pipe.lift_levels - 1
    if not lift:
        fold = jb._make_fold_seg(jb.jumps)
    elif jb.hoist_levels:
        fold = jb._make_fold_lift_hoisted(jb.lift_levels, jb.hoist_levels)
    else:
        fold = jb._make_fold_lift(jb.lift_levels)
    act = jax.sharding.NamedSharding(
        jb.mesh, jax.sharding.PartitionSpec(jmesh.SHARD_AXIS, None))
    P_f, lo_f, hi_f, live, rounds, ml = fold(
        jb._shard_table(table), jax.device_put(jnp.asarray(lo), act),
        jax.device_put(jnp.asarray(hi), act))
    P = pipe._shard_table(table)
    lo_t, hi_t = [torch.from_numpy(lo.copy())], [torch.from_numpy(hi.copy())]
    got = pipe.fold_segment(P, lo_t, hi_t, lift)
    assert got == (int(rounds), int(live), int(ml))
    assert np.array_equal(P[0].numpy().ravel(), np.asarray(P_f))
    assert np.array_equal(lo_t[0].numpy(), np.asarray(lo_f))
    assert np.array_equal(hi_t[0].numpy(), np.asarray(hi_f))
    assert int(rounds) >= 1


# -- whole builds, every round a CardRound, against tpu-bigv -----------------

BUILDS = {
    # name: (graph, n, D, chunk edges (a share of the graph's where
    # negative: lifting needs a shard's chunk above TAIL_Q), options)
    "tail-d1": (lambda: jgen.rmat(8, 8, seed=33), 256, 1, 128, {}),
    "tail-d3": (lambda: jgen.rmat(8, 8, seed=33), 256, 3, 128, {}),
    "star-d5": (lambda: jgen.star_graph(300), 300, 5, 128, {}),
    "lift-d8": (lambda: jgen.rmat(13, 16, seed=41), 1 << 13, 8, -8, {}),
    "hoisted-d5": (lambda: jgen.rmat(12, 16, seed=41), 1 << 12, 5, -2,
                   dict(hoist_bytes=4 * 820 * 4)),
    "hoisted-all-d2": (lambda: jgen.rmat(12, 16, seed=5), 1 << 12, 2, -2,
                       dict(hoist_bytes=1 << 30)),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_through_card_rounds_matches_tpu_bigv(name):
    graph, n, d, cs, kw = BUILDS[name]
    e = graph()
    cs = cs if cs > 0 else len(e) // -cs
    ref = cached_pipeline(n, cs, jmesh.shards_mesh(d), jumps=4, **kw).run(
        jes.EdgeStream.from_array(e, n_vertices=n), k=8, comm_volume=True)
    pipe = BigVPipeline(n, cs, mesh.Mesh(["cpu"] * d), jumps=4,
                        card_rounds=True, **kw)
    out = pipe.run(edgestream.EdgeStream.from_array(e, n_vertices=n), k=8,
                   comm_volume=True)
    for key in ("parent", "pos", "degrees", "assignment"):
        assert np.array_equal(out[key], ref[key]), key
    for key in ("edge_cut", "total_edges", "comm_volume", "balance",
                "fixpoint_rounds"):
        assert out[key] == ref[key], key
    for key, want in ref["build_stats"].items():
        assert out["build_stats"].get(key) == want, key
    # a lifting case's first segments lift: a shard's chunk is wider than
    # the tail's
    assert (cs > BigVPipeline.TAIL_Q) == name.startswith(("lift", "hoist"))


# -- launches, the stop state, the device checks ------------------------------

def _program(n: int, d: int, **kw):
    """A one-card pipeline's table (D, B) and its round's climb program on
    it, as ``fold_segment`` hands them to ``CardRound``."""
    pipe = BigVPipeline(n, 64, mesh.Mesh(["cpu"] * d), card_rounds=True,
                        **kw)
    P = pipe._shard_table(np.full(n + 1, n, np.int32))
    lift = "lift_levels" in kw
    bufs = [[torch.empty_like(P[0])] for _ in range(2)] if lift else None
    stack = pipe._hoist(P) if lift and pipe.hoist_levels else None
    prog = pipe._program(P, bufs, stack)
    return P[0], [(step[0], *[t[0] for t in step[1:]]) for step in prog]


@pytest.mark.parametrize("kw,want", [
    (dict(jumps=128), {"owned_scatter_min": 1, "routed_climb": 1,
                       "routed_square": 0, "routed_round_end": 2}),
    (dict(jumps=1), {"owned_scatter_min": 1, "routed_climb": 1,
                     "routed_square": 0, "routed_round_end": 2}),
    (dict(lift_levels=23, hoist_bytes=0),
     {"owned_scatter_min": 1, "routed_climb": 23, "routed_square": 22,
      "routed_round_end": 2}),
    (dict(lift_levels=23, hoist_bytes=1 << 40),
     {"owned_scatter_min": 1, "routed_climb": 1, "routed_square": 0,
      "routed_round_end": 2}),
    (dict(lift_levels=23, hoist_bytes=10 * 4 * 1025),
     {"owned_scatter_min": 1, "routed_climb": 13, "routed_square": 12,
      "routed_round_end": 2}),
])
def test_round_launches(kw, want):
    """A tail round is 4 launches (from 260), a lifting round of L = 23
    levels 2L + 2 = 48 (from 96); ``CardRound.launches`` is the same
    function of the same plan."""
    n, d = 4096, 4
    P, prog = _program(n, d, **kw)
    plan = routed.round_plan(P, prog)
    got = routed.round_launches(plan)
    assert got == want
    total = sum(got.values())
    if "lift_levels" in kw:
        assert total <= 3 + 2 * kw["lift_levels"]
    else:
        # the round's first step and its jumps - 1 lookups: one run on P
        assert total <= 5
        assert [(k, [(t.data_ptr(), s) for t, s in r]) for k, r in plan] \
            == [(routed.PLAN_FIRST, [(P.data_ptr(), kw["jumps"])])]
    lo = torch.full((d, 8), n, dtype=torch.int32)
    rnd = routed.CardRound(P, lo, lo.clone(), n, prog,
                           routed.new_state(d, "cpu"), 4)
    assert rnd.launches == got


def test_round_plan_splits_long_runs():
    """More than MAX_RUNS tables in a row of climbs take more than one
    launch, the first from lo, the rest from cur."""
    t = [torch.zeros((2, 51), dtype=torch.int32) for _ in range(40)]
    plan = routed.round_plan(t[0], [(routed.CLIMB, x) for x in t[1:]])
    assert [k for k, _ in plan] == [routed.PLAN_FIRST, routed.PLAN_CLIMB]
    assert [len(r) for _, r in plan] == [routed.MAX_RUNS,
                                         40 - routed.MAX_RUNS]


def test_card_forms_stop_with_the_segment():
    """Once STOP is set no card form and no CardRound changes anything."""
    d, n = 3, 20
    st = routed.new_state(d, "cpu")
    st[routed.STOP] = 1
    before = st.clone()
    rng = np.random.default_rng(1)
    B = -(-(n + 1) // d)
    P = torch.from_numpy(_forest(n, d * B, rng).reshape(d, B))
    keep = P.clone()
    lo, hi = (torch.from_numpy(a) for a in _slots(n, d, 6, rng, dead=0.0))
    lo0, hi0 = lo.clone(), hi.clone()
    routed.owned_scatter_min(P, 0, lo, hi, n, st, fold=True)
    out = torch.full_like(lo, 7)
    routed.routed_climb(lo, hi, [(P, 3)], n, out, state=st)
    sq = torch.full_like(P, 7)
    routed.routed_square(P, n, sq, state=st)
    routed.CardRound(P, lo, hi, n, [(routed.CLIMB, P)], st, 4)()
    assert torch.equal(P, keep) and torch.equal(st, before)
    assert torch.equal(lo, lo0) and torch.equal(hi, hi0)
    assert (out == 7).all() and (sq == 7).all()


def test_card_forms_raise_off_cpu_and_cuda():
    """The card forms run their plain versions for CPU tensors only; any
    other device raises, and so do shapes they do not take."""
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    slots = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        routed.routed_climb(slots, slots, [(meta, 2)], 5, slots)
    with pytest.raises(ValueError, match="unsupported device"):
        routed.routed_square(meta, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        routed.CardRound(meta, slots, slots, 5, [], routed.new_state(
            2, "meta"), 4)
    cpu = torch.zeros((2, 4), dtype=torch.int32)
    s = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="runs"):
        routed.routed_climb(s, s, [(cpu, 1)] * (routed.MAX_RUNS + 1), 5, s)
    with pytest.raises(ValueError, match="another buffer"):
        routed.routed_square(cpu, 5, cpu)
    with pytest.raises(ValueError, match="every shard"):
        routed.owned_scatter_min(cpu, 0, torch.zeros((3, 3),
                                                     dtype=torch.int32),
                                 torch.zeros((3, 3), dtype=torch.int32), 5,
                                 fold=True)
    with pytest.raises(ValueError, match="new"):
        routed.routed_climb(s, s, [(cpu, 1)], 5, s,
                            new=torch.zeros((2, 4), dtype=torch.int32))
