"""The port's adaptive per-segment driver against the JAX package's, on the
CPU (``JAX_PLATFORMS=cpu``).

Each piece takes the same inputs, made with numpy from a seed, through the
JAX function and the port's: the compaction (``compact_actives`` with
dedup, ``count_live_distinct``), one stale and one jump-mode segment, the
adaptive fold over its option matrix with every driver counter, the carry
variant, the host tail as deltas and through the worker thread, the
native Liu pass, the memory model and the auto dispatch batch, and the
CLI's flags. Everything compared is integer, so every comparison is
exact. The CUDA kernels (``climb_jumps``, ``compact_live``) are held
against their plain versions on the card by the ``cuda`` tests at the
end, which skip here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu import cli as jcli
from sheep_tpu.backends import base as jbase
from sheep_tpu.backends import tpu_backend
from sheep_tpu.backends.tpu_backend import TpuBackend, pad_chunk
from sheep_tpu.core import native as jnative
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import elim as jelim
from sheep_tpu.ops import order as jorder
from sheep_tpu.utils import membudget as jmem
import sheep_tpu_torch
from sheep_tpu_torch import cli
from sheep_tpu_torch.backends import torch_backend
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.core import native
from sheep_tpu_torch.ops import compact, elim, lift
from sheep_tpu_torch.tools import kernel_cases
from sheep_tpu_torch.utils import membudget

COUNTERS = ("warm_segments", "full_segments", "small_segments",
            "stack_rebuilds", "compactions", "host_tails", "host_tail_live",
            "host_syncs", "device_rounds", "carried_tails", "carried_live")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops, round after round: one intra-op thread beside the
    other workers of a parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _graph(scale, ef, seed):
    """(loP, hiP) numpy position pairs of one R-MAT chunk, n, pos_host."""
    n = 1 << scale
    e = jgen.rmat(scale, ef, seed=seed)
    deg = jdeg.degree_chunk(jdeg.init_degrees(n), pad_chunk(e, len(e), n), n)
    pos, _ = jorder.elimination_order(deg, n)
    lo, hi = jelim.orient_edges_pos(jnp.asarray(pad_chunk(e, len(e), n)),
                                    pos, n)
    return np.asarray(lo), np.asarray(hi), n, np.asarray(pos[:n])


@pytest.fixture(scope="module")
def rmat13():
    return _graph(13, 8, 4)


_pairs = kernel_cases.compact_pairs
COMPACT_CASES = dict(kernel_cases.compact_cases())


@pytest.mark.parametrize("share", [1.0, 0.5, 0.1, 0.01, 0.0])
@pytest.mark.parametrize("size", [1, 64, 1000, 4096])
def test_compact_matches_jax(share, size):
    rng = np.random.default_rng(int(share * 100) + size)
    n, C = 5000, 4096
    lo, hi = _pairs(rng, C, n, share, 0.3)
    want = jelim.compact_actives(jnp.asarray(lo), jnp.asarray(hi), n, size,
                                 dedup=True)
    for fn in (compact.compact_live, compact.compact_live_plain):
        got = fn(_t(lo), _t(hi), n, size)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    live, distinct = jelim.count_live_distinct(jnp.asarray(lo),
                                               jnp.asarray(hi), n)
    assert compact.count_live_distinct(_t(lo), _t(hi), n) == \
        (int(live), int(distinct))


# the reference's compact_actives takes no empty round, so the case of no
# slot is held against the plain version only (on the card)
@pytest.mark.parametrize("name", sorted(k for k, c in COMPACT_CASES.items()
                                        if len(c["lo"])))
def test_compact_cases_match_jax(name):
    """The compaction's case table (``kernel_cases.compact_cases``): sort
    keys of 2 x 19, 2 x 3 and 2 x 10 bits, every slot one live pair, n =
    1, and slots not a multiple of the sort's tile with more distinct
    pairs than ``size``."""
    c = COMPACT_CASES[name]
    want = jelim.compact_actives(jnp.asarray(c["lo"]), jnp.asarray(c["hi"]),
                                 c["n"], c["size"], dedup=True)
    got = compact.compact_live(_t(c["lo"]), _t(c["hi"]), c["n"], c["size"])
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def _sv(sv):
    return [int(x) for x in np.asarray(sv)]


def _same_segment(want, got):
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert _sv(want[3]) == got[3].tolist()


def test_stale_and_jump_segments_match_jax(rmat13):
    """A stale segment on a stack built from the entry table, one on a
    stack built a segment earlier (reused, as ``stale_reuse`` > 1 does),
    and a jump-mode segment on a compacted buffer: (loP, hiP, P, sv)."""
    lo, hi, n, _ = rmat13
    P0 = np.full(n + 1, n, np.int32)
    want = jelim.fold_segment_pos_hoisted(
        jnp.asarray(P0), jnp.asarray(lo), jnp.asarray(hi), n,
        segment_rounds=2)
    got = elim.fold_segment_pos_hoisted(_t(P0), _t(lo), _t(hi), n,
                                        segment_rounds=2)
    _same_segment(want, got)
    assert got[3].tolist()[1] == 2  # the budget ran out
    # a stack from this table, used after one more segment moved it
    jt = jelim.build_lift_tables(want[2], n)
    pt = elim.build_lift_tables(got[2], n)
    want = jelim.fold_segment_pos_hoisted(want[2], want[0], want[1], n,
                                          segment_rounds=2)
    got = elim.fold_segment_pos_hoisted(got[2], got[0], got[1], n,
                                        segment_rounds=2)
    _same_segment(want, got)
    want = jelim.fold_segment_pos_stale(want[2], want[0], want[1], jt, n,
                                        segment_rounds=3)
    got = elim.fold_segment_pos_stale(got[2], got[0], got[1], pt, n,
                                      segment_rounds=3)
    _same_segment(want, got)
    size = elim.pow2_at_least(2 * got[3].tolist()[2], 1 << 10)
    jlo, jhi = jelim.compact_actives(want[0], want[1], n, size, dedup=True)
    plo, phi = compact.compact_live(got[0], got[1], n, size)
    want = jelim.fold_segment_small_pos(want[2], jlo, jhi, n, jumps=16,
                                        segment_rounds=64)
    got = elim.fold_segment_small_pos(got[2], plo, phi, n, jumps=16,
                                      segment_rounds=64)
    _same_segment(want, got)


def _fold_both(lo, hi, n, pos_host, carry=False, **kw):
    """The same buffer through the reference's adaptive fold and the
    port's: (P, rounds, stats[, carry]) of each."""
    sj, sp = {}, {}
    P0 = np.full(n + 1, n, np.int32)
    fj = jelim.fold_edges_adaptive_pos_carry if carry \
        else jelim.fold_edges_adaptive_pos
    fp = elim.fold_edges_adaptive_pos_carry if carry \
        else elim.fold_edges_adaptive_pos
    ref = fj(jnp.asarray(P0), jnp.asarray(lo), jnp.asarray(hi), n,
             pos_host=pos_host, stats=sj, **kw)
    kw_port = dict(kw)
    # without pos_host the reference falls back to jump mode silently; the
    # port refuses a host tail it cannot run and is asked for jump mode
    if pos_host is None:
        kw_port["host_tail"] = False
    got = fp(_t(P0), _t(lo), _t(hi), n, pos_host=pos_host, stats=sp,
             **kw_port)
    return (*ref, sj), (*got, sp)


def _assert_fold(ref, got):
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert got[1] == int(ref[1])
    sj, sp = ref[-1], got[-1]
    for key in COUNTERS:
        assert sp.get(key) == sj.get(key), key
    for key in ("t_warm_s", "t_full_s", "t_small_s", "t_host_tail_s"):
        assert (key in sp) == (key in sj), key
    for key in ("host_blocked_ms", "device_gap_ms"):
        assert sp[key] >= 0.0


@pytest.mark.parametrize("warm", [((1, 8),), ()], ids=["warm", "cold"])
@pytest.mark.parametrize("stale_reuse", [1, 2])
@pytest.mark.parametrize("host_tail", [True, False])
@pytest.mark.parametrize("threshold", [0, 300], ids=["auto", "300"])
def test_adaptive_fold_matches_jax(rmat13, warm, stale_reuse, host_tail,
                                   threshold):
    lo, hi, n, pos_host = rmat13
    ref, got = _fold_both(lo, hi, n, pos_host if host_tail else None,
                          warm_schedule=warm, stale_reuse=stale_reuse,
                          host_tail_threshold=threshold)
    _assert_fold(ref, got)
    sp = got[-1]
    assert sp["host_syncs"] == sum(sp.get(key, 0) for key in (
        "warm_segments", "full_segments", "small_segments"))


@pytest.mark.parametrize("threshold, kinds", [
    (64, ("warm_segments", "full_segments", "stack_rebuilds", "compactions",
          "small_segments")),
    (0, ("warm_segments", "host_tails"))], ids=["64", "auto"])
def test_adaptive_fold_visits_every_segment_kind(rmat13, threshold, kinds):
    """Between them the two runs take every branch of the driver."""
    lo, hi, n, pos_host = rmat13
    ref, got = _fold_both(lo, hi, n, pos_host, warm_schedule=((1, 8),),
                          stale_reuse=2, host_tail_threshold=threshold)
    _assert_fold(ref, got)
    for key in kinds:
        assert got[-1].get(key, 0) >= 1, key


@pytest.mark.parametrize("threshold", [0, 300], ids=["auto", "300"])
def test_carry_variant_matches_jax(rmat13, threshold):
    lo, hi, n, pos_host = rmat13
    ref, got = _fold_both(lo, hi, n, pos_host, carry=True,
                          warm_schedule=((1, 8),),
                          host_tail_threshold=threshold)
    _assert_fold(ref, got)
    (jlo, jhi), (plo, phi) = ref[2], got[2]
    assert np.array_equal(plo.numpy(), np.asarray(jlo))
    assert np.array_equal(phi.numpy(), np.asarray(jhi))
    if threshold == 0:  # auto: the tail is handed on after the warm round
        assert got[-1]["carried_tails"] == 1 and len(plo) > 0


def test_host_tail_and_overlap_match_jax(rmat13):
    """Two segments, then the live tail: finished on the host, as delta
    pairs, and through the worker thread (two tails in flight)."""
    lo, hi, n, pos_host = rmat13
    P0 = np.full(n + 1, n, np.int32)
    jlo, jhi, jP, _ = jelim.fold_segment_pos(
        jnp.asarray(P0), jnp.asarray(lo), jnp.asarray(hi), n,
        segment_rounds=2)
    plo, phi, pP, _ = elim.fold_segment_pos(_t(P0), _t(lo), _t(hi), n,
                                            segment_rounds=2)
    assert int((plo != n).sum()) > 0
    want = jelim._host_tail_finish_pos(jP, jlo, jhi, n, len(lo), pos_host)
    got = elim._host_tail_finish_pos(pP, plo, phi, n, len(lo), pos_host)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dj = jelim.host_tail_delta(jP, jlo, jhi, n, pos_host)
    dp = elim.host_tail_delta(pP, plo, phi, n, pos_host)
    assert len(dp[0]) > 0
    for a, b in zip(dj, dp):
        assert np.array_equal(np.asarray(a), b)
    with jelim.TailOverlap(n, pos_host) as oj, \
            elim.TailOverlap(n, pos_host, torch.device("cpu")) as op:
        for ov, args in ((oj, (jP, jlo, jhi)), (op, (pP, plo, phi))):
            ov.submit(*args)
            ov.submit(*args)
        # the port's worker reads copies: a later in-place fold of the
        # table does not reach it
        pP.fill_(0)
        oj.drain(True)
        op.drain(True)
        want, got = oj.take_inject(), op.take_inject()
    for a, b in zip(want, got):
        assert np.array_equal(b.numpy(), np.asarray(a))
    assert op.take_inject() is None


@pytest.mark.parametrize("seed", range(6))
def test_native_elim_tree_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    pos = rng.permutation(n)
    edges = rng.integers(-1, n + 1, (int(rng.integers(0, 3 * n)), 2))
    want = jnative.build_elim_tree(edges, pos)
    got = native.build_elim_tree(edges, pos)
    assert np.array_equal(got, want)
    more = rng.integers(0, n, (n, 2))
    assert np.array_equal(native.build_elim_tree(more, pos, got.copy()),
                          jnative.build_elim_tree(more, pos, want.copy()))
    with pytest.raises(ValueError, match="permutation"):
        native.build_elim_tree(edges, np.zeros(n, np.int64) if n > 1
                               else np.array([3]))


GRID = [(n, cs, inflight, donate, ring)
        for n in (1 << 10, (1 << 22) + 5, 1 << 28)
        for cs in (1 << 12, 1 << 22)
        for inflight in (1, 2, 3)
        for donate in (False, True)
        for ring in (0, 2)]


def test_memory_model_matches_jax():
    for n, cs, inflight, donate, ring in GRID:
        for batch in (1, 2, 16):
            want = jmem.build_phase_bytes(n, cs, dispatch_batch=batch,
                                          inflight=inflight, donate=donate,
                                          h2d_ring=ring)
            got = membudget.build_phase_bytes(
                n, cs, dispatch_batch=batch, inflight=inflight,
                donate=donate, h2d_ring=ring)
            assert got == want
        for hbm in (1 << 24, 1 << 30, 3 << 30, 72 << 30):
            assert membudget.dispatch_batch_for(
                hbm, n, cs, inflight=inflight, donate=donate,
                h2d_ring=ring) == jmem.dispatch_batch_for(
                hbm, n, cs, inflight=inflight, donate=donate, h2d_ring=ring)


@pytest.mark.parametrize("hbm", [1 << 28, 16 << 30, 80 << 30])
def test_resolve_dispatch_batch_matches_jax(monkeypatch, hbm):
    monkeypatch.setattr(torch_backend, "device_memory_bytes",
                        lambda dev: hbm)
    for n, cs, inflight, donate, ring in GRID:
        for batch in (0, 1, 3):
            assert torch_backend.resolve_dispatch_batch(
                batch, n, cs, "cpu", inflight, donate, ring) == \
                tpu_backend.resolve_dispatch_batch(batch, n, cs, inflight,
                                                   donate, ring)
    # on an accelerator, 0 sizes N from the device's memory
    monkeypatch.setattr(tpu_backend.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(tpu_backend, "_device_hbm_bytes",
                        lambda purpose="": hbm)
    for n, cs, inflight, donate, ring in GRID:
        assert torch_backend.resolve_dispatch_batch(
            0, n, cs, torch.device("cuda"), inflight, donate, ring) == \
            tpu_backend.resolve_dispatch_batch(0, n, cs, inflight, donate,
                                               ring)


def test_backend_tail_strategies_match_jax():
    """carry_tail and tail_overlap (auto N and D defer to them) and an
    explicit threshold, with several chunks: the same partition, rounds
    and counters."""
    e, n = jgen.rmat(13, 8, seed=6), 1 << 13
    for kw in (dict(carry_tail=True, host_tail_threshold=300),
               dict(tail_overlap=True, host_tail_threshold=300),
               dict(dispatch_batch=1, inflight=1, stale_reuse=2,
                    warm_schedule=(), host_tail_threshold=64)):
        ref = TpuBackend(chunk_edges=1 << 15, **kw).partition(
            jbase_stream(e, n), 8, keep_tree=True)
        got = TorchBackend(chunk_edges=1 << 15, device="cpu",
                           **kw).partition(port_stream(e, n), 8,
                                           keep_tree=True)
        assert np.array_equal(got.tree["parent"], ref.tree["parent"])
        assert np.array_equal(got.assignment, ref.assignment)
        assert (got.edge_cut, got.comm_volume) == \
            (ref.edge_cut, ref.comm_volume)
        for key in COUNTERS + ("fixpoint_rounds", "overlap_tails"):
            assert got.diagnostics.get(key) == ref.diagnostics.get(key), \
                (kw, key)


def jbase_stream(e, n):
    from sheep_tpu.io.edgestream import EdgeStream

    return EdgeStream.from_array(e, n_vertices=n)


def port_stream(e, n):
    from sheep_tpu_torch.io.edgestream import EdgeStream

    return EdgeStream.from_array(e, n_vertices=n)


def test_backend_rejects_mixed_strategies():
    for kw in (dict(dispatch_batch=2, carry_tail=True),
               dict(inflight=2, tail_overlap=True),
               dict(carry_tail=True, tail_overlap=True),
               dict(dispatch_batch=-1), dict(stale_reuse=0)):
        with pytest.raises(ValueError):
            TorchBackend(device="cpu", **kw)


BUILD_KEYS = ("segment_rounds", "warm_schedule", "host_tail_threshold",
              "carry_tail", "tail_overlap", "stale_reuse", "lift_levels",
              "dispatch_batch", "inflight")


class _Built(Exception):
    """Raised by the stand-ins below with the keywords they were given."""


def _capture(*args, **kw):
    raise _Built(kw)


def _build_keys(built):
    return {k: v for k, v in built.value.args[0].items() if k in BUILD_KEYS}


def _jax_ctor(monkeypatch, flags):
    """The build settings the JAX CLI gives its backend."""
    monkeypatch.setattr(jbase, "get_backend", _capture)
    with pytest.raises(_Built) as built:
        jcli.main(["--input", "rmat-hash:8", "--k", "2", "--backend", "tpu",
                   *flags])
    return _build_keys(built)


def _port_opts(monkeypatch, flags):
    """The build settings the port's CLI gives ``partition``."""
    monkeypatch.setattr(sheep_tpu_torch, "partition", _capture)
    with pytest.raises(_Built) as built:
        cli.main(["--input", "rmat-hash:8", "--k", "2", "--device", "cpu",
                  *flags])
    return _build_keys(built)


@pytest.mark.parametrize("flags", [
    [], ["--segment-rounds", "3"], ["--warm-schedule", "1:8,2:4"],
    ["--warm-schedule", ""], ["--host-tail-threshold", "100"],
    ["--carry-tail"], ["--no-carry-tail"], ["--tail-overlap"],
    ["--no-tail-overlap"], ["--stale-reuse", "2"], ["--lift-levels", "5"],
    ["--dispatch-batch", "0"], ["--dispatch-batch", "1", "--inflight", "1"],
    ["--dispatch-batch", "4"]])
def test_cli_flags_match_jax(monkeypatch, flags):
    assert _port_opts(monkeypatch, flags) == _jax_ctor(monkeypatch, flags)


@pytest.mark.parametrize("flags", [
    ["--warm-schedule", "0:8"], ["--warm-schedule", "1:0"],
    ["--warm-schedule", "1-8"], ["--carry-tail", "--tail-overlap"],
    ["--dispatch-batch", "2", "--carry-tail"],
    ["--inflight", "2", "--tail-overlap"], ["--stale-reuse", "0"],
    ["--dispatch-batch", "-1"]])
def test_cli_rejects_what_jax_rejects(monkeypatch, capsys, flags):
    for run in (_port_opts, _jax_ctor):
        with pytest.raises(SystemExit) as exc:
            run(monkeypatch, flags)
        assert exc.value.code == 2
    capsys.readouterr()


def test_defaults_are_the_reference():
    import inspect

    ref = inspect.signature(TpuBackend.__init__).parameters
    got = inspect.signature(TorchBackend.__init__).parameters
    for key in BUILD_KEYS:
        assert got[key].default == ref[key].default, key
    assert TorchBackend(device="cpu").warm_schedule == \
        TpuBackend().warm_schedule
    assert inspect.signature(sheep_tpu_torch.partition).parameters[
        "dispatch_batch"].default == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_compact_live_matches_plain_on_card():
    dev = _card()
    for name, c in COMPACT_CASES.items():
        lo, hi, n, size = _t(c["lo"]), _t(c["hi"]), c["n"], c["size"]
        want = compact.compact_live_plain(lo, hi, n, size)
        got = compact.compact_live(lo.to(dev), hi.to(dev), n, size)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(b.cpu(), a), name


@pytest.mark.cuda
def test_climb_jumps_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(10)
    n = 1 << 16
    P = np.minimum(np.arange(n) + rng.integers(1, 40, n), n)
    P = np.concatenate([P, [n]]).astype(np.int32)
    lo, hi = _pairs(rng, 1 << 14, n, 0.7, 0.1)
    old = P[lo]
    for jumps in (1, 16):
        want = lift.climb_tail_plain(_t(lo), _t(hi), _t(old), _t(P), None, 1,
                                     jumps=jumps)
        ctl = lift.new_ctl(dev)
        got = lift.climb_tail(_t(lo).to(dev), _t(hi).to(dev),
                              _t(old).to(dev), _t(P).to(dev), None, ctl,
                              jumps=jumps)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert ctl.tolist()[1:4] == [int(want[2]), int(want[3]),
                                     int(want[4])]
