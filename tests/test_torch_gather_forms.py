"""The gather forms of the Mosaic probes (tools/pallas_smoke.py) against the
port's kernels K2/K3 (sheep_tpu_torch/ops/gather2d.py) and K1 on the CPU.

Each form's Pallas kernel runs in interpret mode through the probe's own
``try_form``, on inputs made with numpy from a seed, and its output must
equal the port's. Exact comparisons: the functions move int32 values and
compute nothing."""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.lax as lax
import jax.numpy as jnp

from sheep_tpu_torch.ops import gather, gather2d
from sheep_tpu_torch.tools import gather_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
R, B, S, SB = 4096, 1024, 64, 64


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_smoke_for_port_tests", REPO / "tools" / "pallas_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _ints(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape, dtype=np.int32)


def _kernel_D(t, i, o):
    def one(s, _):
        g = i[s, :]
        row = (g >> 7).reshape(8, 1)
        col = (g & 127).reshape(8, 1)
        rows8 = jnp.take_along_axis(
            t[...], jnp.broadcast_to(row, (8, 128)), axis=0)
        z = jnp.take_along_axis(
            rows8, jnp.broadcast_to(col, (8, 128)), axis=1)
        o[s, :] = z[:, 0]
        return _

    lax.fori_loop(0, S, one, 0)


# form -> (Pallas kernel body, input maker, port, numpy reference)
FORMS = {
    "A_row_take": (
        lambda t, i, o: o.__setitem__(
            ..., jnp.take(t[...], i[...], axis=0, mode="clip")),
        lambda rng: [_ints(rng, 0, 1 << 30, (R, 128)),
                     _ints(rng, 0, R, (B,))],
        gather2d.take_rows,
        lambda t, i: t[i]),
    "B_sublane_gather": (
        lambda t, i, o: o.__setitem__(
            ..., jnp.take_along_axis(t[...], i[...], axis=0)),
        lambda rng: [_ints(rng, 0, 1 << 30, (R, 128)),
                     _ints(rng, 0, R, (8, 128))],
        lambda t, i: gather2d.take_along(t, i, 0),
        lambda t, i: np.take_along_axis(t, i, axis=0)),
    "C_lane_gather": (
        lambda x, i, o: o.__setitem__(
            ..., jnp.take_along_axis(x[...], i[...], axis=1)),
        lambda rng: [_ints(rng, 0, 1 << 30, (8, 128)),
                     _ints(rng, 0, 128, (8, 128))],
        lambda x, i: gather2d.take_along(x, i, 1),
        lambda x, i: np.take_along_axis(x, i, axis=1)),
    "D_composite_scalar": (
        _kernel_D,
        lambda rng: [_ints(rng, 0, 1 << 30, (R, 128)),
                     _ints(rng, 0, R * 128, (S, 8))],
        lambda t, i: gather.gather_clip(
            t.reshape(-1), i.reshape(-1)).reshape(S, 8),
        lambda t, i: t.reshape(-1)[i]),
    "E_lane_routed_bulk": (
        lambda t, i, o: o.__setitem__(
            ..., jnp.take_along_axis(t[...], i[...] >> 7, axis=0)),
        lambda rng: [_ints(rng, 0, 1 << 30, (R, 128)),
                     _ints(rng, 0, R, (SB, 128)) * 128
                     + np.arange(128, dtype=np.int32)[None, :]],
        lambda t, i: gather2d.take_along(t, i, 0, shift=7),
        lambda t, i: t.reshape(-1)[i]),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_matches_pallas_interpret(probe, form):
    kernel, make, port, numpy_ref = FORMS[form]
    arrays = make(np.random.default_rng(sorted(FORMS).index(form)))
    port_out = port(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert np.array_equal(port_out, numpy_ref(*arrays))
    rec = probe.try_form(
        form, kernel, [jnp.asarray(a) for a in arrays],
        jax.ShapeDtypeStruct(port_out.shape, jnp.int32),
        check=lambda out: np.array_equal(out, port_out))
    assert rec.get("lowered") and rec.get("ok"), rec


@pytest.mark.parametrize("width", [128, 256, 512])
def test_lane_width_matches_pallas_interpret(probe, width):
    """P3: the probe's Pallas lane gather equals numpy on its own inputs
    (default_rng(0)), and the port equals numpy on the same inputs."""
    rec = probe._probe_width(width)
    assert rec.get("lowered") and rec.get("ok"), rec
    rng = np.random.default_rng(0)
    x = _ints(rng, 0, 1 << 30, (8, width))
    idx = _ints(rng, 0, width, (8, width))
    want = np.take_along_axis(x, idx, axis=1)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    assert np.array_equal(gather2d.take_along_plain(xt, it, 1).numpy(), want)
    assert np.array_equal(gather2d.take_along(xt, it, 1).numpy(), want)


def test_router_and_unroute():
    """P2's router: balanced residues, routed through K3's axis-0 form."""
    rows, ni = 64, 1 << 13
    rng = np.random.default_rng(7)
    table = _ints(rng, 0, 1 << 30, (rows, 128))
    res = np.repeat(np.arange(128, dtype=np.int32), ni // 128)
    rng.shuffle(res)
    idx = _ints(rng, 0, rows, (ni,)) * 128 + res
    want = table.reshape(-1)[idx]
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    z, order = gather_smoke.route(t, i)
    assert np.array_equal(order.numpy(), np.argsort(idx & 127, kind="stable"))
    assert np.array_equal(z.numpy(), want[order.numpy()])
    assert np.array_equal(gather_smoke.unroute(z, order).numpy(), want)
    with pytest.raises(ValueError, match="multiple of 128"):
        gather_smoke.route(t, i[:100])


@pytest.mark.parametrize("shape,lo,hi", [
    ((1001, 37), -500, 1500),
    ((5, 8), -(1 << 31), (1 << 31) - 1),
    ((64, 128), 0, 64),
])
def test_take_rows_clips(shape, lo, hi):
    rng = np.random.default_rng(shape[0])
    t = _ints(rng, 0, 1 << 30, shape)
    idx = rng.integers(lo, hi, 3001, dtype=np.int64).astype(np.int32)
    want = t[np.clip(idx, 0, shape[0] - 1)]
    tt, it = torch.from_numpy(t), torch.from_numpy(idx)
    assert np.array_equal(gather2d.take_rows_plain(tt, it).numpy(), want)
    assert np.array_equal(gather2d.take_rows(tt, it).numpy(), want)


@pytest.mark.parametrize("axis,shift,xshape,ishape,lo,hi", [
    (0, 0, (1001, 37), (513, 37), -500, 1500),
    (0, 3, (1001, 37), (513, 37), -8000, 16000),
    (0, 7, (64, 128), (32, 128), -(1 << 20), 1 << 20),
    (1, 0, (7, 999), (7, 1001), -300, 1300),
    (1, 2, (5, 60001), (5, 1003), -3000, 300000),
])
def test_take_along_clips(axis, shift, xshape, ishape, lo, hi):
    rng = np.random.default_rng(xshape[1])
    x = _ints(rng, 0, 1 << 30, xshape)
    idx = _ints(rng, lo, hi, ishape)
    j = np.clip(idx >> shift, 0, xshape[axis] - 1)
    want = np.take_along_axis(x, j, axis=axis)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    assert np.array_equal(
        gather2d.take_along_plain(xt, it, axis, shift).numpy(), want)
    assert np.array_equal(gather2d.take_along(xt, it, axis, shift).numpy(),
                          want)


def test_empty_inputs():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    out = gather2d.take_rows(t, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 4) and out.dtype == torch.int32
    out = gather2d.take_along(t, torch.zeros((0, 4), dtype=torch.int32), 0)
    assert out.shape == (0, 4)
    with pytest.raises(ValueError, match="empty"):
        gather2d.take_rows(torch.zeros((0, 4), dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32))


def test_wrappers_reject_bad_inputs():
    t = torch.arange(64 * 8, dtype=torch.int32).reshape(64, 8)
    i1 = torch.arange(16, dtype=torch.int32)
    i2 = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gather2d.take_rows(t.long(), i1)
    with pytest.raises(TypeError, match="int32"):
        gather2d.take_along(t, i2.long(), 0)
    with pytest.raises(ValueError, match="2-D"):
        gather2d.take_rows(t.reshape(-1), i1)
    with pytest.raises(ValueError, match="1-D"):
        gather2d.take_rows(t, i2)
    with pytest.raises(ValueError, match="2-D"):
        gather2d.take_along(t, i1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        gather2d.take_rows(t.T, i1)
    with pytest.raises(ValueError, match="contiguous"):
        gather2d.take_along(t, torch.zeros((8, 4), dtype=torch.int32).T, 0)
    with pytest.raises(ValueError, match="axis"):
        gather2d.take_along(t, i2, 2)
    with pytest.raises(ValueError, match="shift"):
        gather2d.take_along(t, i2, 0, shift=32)
    with pytest.raises(ValueError, match="does not match"):
        gather2d.take_along(t, torch.zeros((4, 7), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="does not match"):
        gather2d.take_along(t, i2, 1)
    meta1 = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        gather2d.take_rows(t, meta1)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on CUDA never reaches the plain
    version, and no launch is counted."""
    t = torch.empty((64, 8), dtype=torch.int32, device="meta")
    i1 = torch.empty(16, dtype=torch.int32, device="meta")
    i2 = torch.empty((4, 8), dtype=torch.int32, device="meta")
    n0 = dict(gather2d.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        gather2d.take_rows(t, i1)
    with pytest.raises(ValueError, match="unsupported device"):
        gather2d.take_along(t, i2, 0)
    assert gather2d.LAUNCHES == n0


def test_cpu_path_counts_no_launch():
    n0 = dict(gather2d.LAUNCHES)
    t = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    gather2d.take_rows(t, torch.arange(4, dtype=torch.int32))
    gather2d.take_along(t, torch.zeros((4, 8), dtype=torch.int32), 1)
    assert gather2d.LAUNCHES == n0


@pytest.mark.parametrize("args", [["--variant", "1"], ["--variant", "2"],
                                  ["--variant", "2", "--perf"],
                                  ["--variant", "3"]],
                         ids=["v1", "v2", "v2-perf", "v3"])
def test_gather_smoke_cli_on_cpu(args):
    p = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.tools.gather_smoke", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr + p.stdout
    lines = p.stdout.strip().splitlines()
    assert len(lines) >= 2 and '"ok": true' in lines[-1]


def test_gather_smoke_records():
    recs = gather_smoke.run(3, device="cpu")
    assert [r["lane_extent"] for r in recs] == list(gather_smoke.P3_WIDTHS)
    for r in recs:
        assert r["ok"] and r["built"] is False and r["ms"] is None
        assert r["axis"] == 1 and r["max_abs_err"] == 0
        assert r["plain_ms"] is None
    # the bytes bound at R = 32768: idx in, out back, and each element of
    # the table that the lookups reach once (the tool's own inputs)
    rng = np.random.default_rng(0)
    _ints(rng, 0, 1 << 30, (8, 32768))
    idx = _ints(rng, 0, 32768, (8, 32768))
    reached = sum(len(np.unique(row)) for row in idx)
    assert reached < idx.size
    assert recs[-1]["bound_ms"] == pytest.approx(
        (8 * idx.size + 4 * reached) / 3.35e12 * 1e3)


def test_bytes_bounds_count_reached_elements():
    """A few lookups into a large table need only the elements they reach,
    after the shift and the clip."""
    t = torch.zeros((4096, 128), dtype=torch.int32)
    i = torch.tensor([5, 5, -3, 9000, 0], dtype=torch.int32)
    # reached: 5, 0 (clip of -3 and of 0), 4095 (clip of 9000)
    assert gather_smoke.take_bytes(t.numel(), i) == 8 * 5 + 4 * 3
    assert gather_smoke.take_bytes(4096, i) == 8 * 5 + 4 * 3
    # K2: idx in, out rows back, each distinct row once
    assert gather_smoke.rows_bytes(t, i) == 4 * 5 + 4 * 5 * 128 + 4 * 3 * 128
    # K3 axis 0: (row, column) pairs; rows 5 >> 1 = 2 twice in column 0
    i2 = torch.tensor([[4, 1], [5, 1]], dtype=torch.int32)
    assert gather_smoke.along_bytes(t[:, :2].contiguous(), i2, 0, 1) == \
        8 * 4 + 4 * 2
    # K3 axis 1: per row; row 0 reaches 1 and 127 (clip), row 1 reaches 1
    i3 = torch.tensor([[1, 500], [1, 1]], dtype=torch.int32)
    assert gather_smoke.along_bytes(t[:2], i3, 1) == 8 * 4 + 4 * 3
    # never more of the table than it holds
    full = torch.arange(4096, dtype=torch.int32).repeat(3)
    assert gather_smoke.take_bytes(4096, full) == 8 * full.numel() + 4 * 4096



def test_gather_smoke_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gather_smoke.main(["--variant", "1"])


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: K2/K3 have no CPU mode")
    rng = np.random.default_rng(3)
    t = torch.from_numpy(_ints(rng, 0, 1 << 30, (1001, 37))).cuda()
    i1 = torch.from_numpy(_ints(rng, -500, 1500, (3001,))).cuda()
    i2 = torch.from_numpy(_ints(rng, -500, 1500, (7, 37))).cuda()
    x1 = torch.from_numpy(_ints(rng, 0, 1 << 30, (7, 999))).cuda()
    n0 = dict(gather2d.LAUNCHES)
    assert torch.equal(gather2d.take_rows(t, i1),
                       gather2d.take_rows_plain(t, i1))
    assert torch.equal(gather2d.take_along(t, i2, 0),
                       gather2d.take_along_plain(t, i2, 0))
    assert torch.equal(gather2d.take_along(x1, i2[:, :37], 1),
                       gather2d.take_along_plain(x1, i2[:, :37], 1))
    torch.cuda.synchronize()
    assert gather2d.LAUNCHES["take_rows"] == n0["take_rows"] + 1
    assert gather2d.LAUNCHES["take_along"] == n0["take_along"] + 2


# -- the redesign's shapes and launch plans -----------------------------------

def rows_cover(plan, b: int, w: int):
    """Replay K2's mapping (``take_rows_kernel``) on the host: (writes,
    source) of shape (b, w), the times each output element is written and
    the output row whose index its value was read by (-1: never)."""
    writes = np.zeros((b, w), np.int64)
    source = np.full((b, w), -1, np.int64)
    flat_w, flat_s = writes.reshape(-1), source.reshape(-1)
    unit, rpw = 4 if plan.vec else 1, 1 << plan.log_rows
    nq = w // unit
    batch = 32 * gather2d.BATCH
    lanes, offs = np.arange(32), np.arange(unit)
    for warp in range(plan.blocks * (plan.threads // 32)):
        r0 = warp * rpw
        if r0 >= b:
            break
        total = min(rpw, b - r0) * nq
        # the kernel's incremental (row, q), the 32 lanes at once: lane / nq
        # once, then 32 units a step, a batch's steps whether in range or not
        row, q = lanes // nq, lanes % nq
        r_step, q_step = 32 // nq, 32 % nq
        for k0 in range(0, -(-total // batch) * batch, 32):
            k = k0 + lanes
            live = k < total
            assert (q[live] == k[live] % nq).all()
            e = (r0 * w + k[live] * unit)[:, None] + offs
            flat_w[e] += 1
            flat_s[e] = (r0 + row[live])[:, None]
            q = q + q_step
            row = row + r_step
            wrap = q >= nq
            q[wrap] -= nq
            row[wrap] += 1
    return writes, source


def along_cover(plan, ir: int, ic: int):
    """Replay K3's mapping (``take_along_kernel``) on the host: the times
    each (ir, ic) element is written."""
    writes = np.zeros((ir, ic), np.int64)
    tpr = 1 << plan.log_tpr
    rpb = plan.threads // tpr
    gx, gy = plan.grid
    for by in range(gy):
        for lr in range(rpb):
            for r in range(by * rpb + lr, ir, gy * rpb):
                for bx in range(gx):
                    for t in range(tpr):
                        c0 = bx * tpr * gather2d.UNITS + t
                        for g in range(gather2d.UNITS):
                            if c0 + g * tpr < ic:
                                writes[r, c0 + g * tpr] += 1
    return writes


def _at(a: torch.Tensor, at: int) -> torch.Tensor:
    """``a``'s values in a contiguous view ``at`` elements into a larger
    buffer (off a 16-byte boundary for at % 4 != 0)."""
    buf = torch.empty(a.numel() + at, dtype=a.dtype)
    v = buf[at:].view(a.shape)
    v.copy_(a)
    return v


def _routed(rng, rows, sb):
    return (_ints(rng, 0, rows, (sb, 128)) * 128
            + np.arange(128, dtype=np.int32)[None, :])


# chip_smoke.py phase 3b's cases at small stand-in sizes: (Pallas form, its
# inputs, the port's call on them with (first input, index, out) views
# starting at the given elements)
REDESIGN = {
    "A-odd-w37-out-at-1": (
        "A_row_take", lambda rng: [_ints(rng, 0, 1 << 30, (101, 37)),
                                   _ints(rng, -50, 150, (301,))],
        (0, 0, 1)),
    "A-t-at-1": (
        "A_row_take", lambda rng: [_ints(rng, 0, 1 << 30, (64, 128)),
                                   _ints(rng, 0, 64, (512,))],
        (1, 0, 0)),
    "A-idx-at-1": (
        "A_row_take", lambda rng: [_ints(rng, 0, 1 << 30, (64, 128)),
                                   _ints(rng, 0, 64, (512,))],
        (0, 1, 0)),
    "B-odd-w37-idx-at-1": (
        "B_sublane_gather", lambda rng: [_ints(rng, 0, 1 << 30, (101, 37)),
                                         _ints(rng, 0, 101, (9, 37))],
        (0, 1, 1)),
    "C-wide-4096-x-at-1": (
        "C_lane_gather", lambda rng: [_ints(rng, 0, 1 << 30, (8, 4096)),
                                      _ints(rng, 0, 4096, (8, 4096))],
        (1, 0, 0)),
    "C-odd-w999-out-at-1": (
        "C_lane_gather", lambda rng: [_ints(rng, 0, 1 << 30, (7, 999)),
                                      _ints(rng, 0, 999, (7, 1001))],
        (0, 0, 1)),
    "E-idx-at-1": (
        "E_lane_routed_bulk", lambda rng: [_ints(rng, 0, 1 << 30, (64, 128)),
                                           _routed(rng, 64, 33)],
        (0, 1, 0)),
}


@pytest.mark.parametrize("case", sorted(REDESIGN))
def test_redesign_shapes_match_pallas_interpret(probe, case):
    """The plain versions at phase 3b's new shapes (odd widths, views from
    element 1, a wide row) equal the probe's Pallas form in interpret mode
    and numpy, through the wrappers and their ``out=``."""
    form, make, (t_at, i_at, o_at) = REDESIGN[case]
    kernel, _, port, numpy_ref = FORMS[form]
    arrays = make(np.random.default_rng(sorted(REDESIGN).index(case)))
    want = numpy_ref(*[np.clip(a, 0, arrays[0].shape[0] - 1)
                       if k and form == "A_row_take" else a
                       for k, a in enumerate(arrays)])
    t = _at(torch.from_numpy(arrays[0]), t_at)
    i = _at(torch.from_numpy(arrays[1]), i_at)
    out = _at(torch.full(want.shape, -1, dtype=torch.int32), o_at)
    if form == "A_row_take":
        got = gather2d.take_rows(t, i, out=out)
    else:
        axis = 1 if form == "C_lane_gather" else 0
        got = gather2d.take_along(t, i, axis, 7 if form[0] == "E" else 0,
                                  out=out)
    assert got is out and np.array_equal(out.numpy(), want)
    assert np.array_equal(port(t, i).numpy(), want)
    rec = probe.try_form(
        form, kernel, [jnp.asarray(a) for a in arrays],
        jax.ShapeDtypeStruct(want.shape, jnp.int32),
        check=lambda o: np.array_equal(o, want))
    assert rec.get("lowered") and rec.get("ok"), rec


def _along_plan(ir, ic, threads):
    """The default K3 plan (``threads`` None), else the grid of blocks of
    ``threads`` that covers the idx."""
    if threads is None:
        return gather2d.plan_take_along(ir, ic, 132)
    return gather2d.AlongPlan.covering(ir, ic, threads)


@pytest.mark.parametrize("ir,ic", [(1, 1), (3, 2), (7, 37), (8, 128),
                                   (4, 1001), (3, 4099), (70, 4), (513, 37)])
@pytest.mark.parametrize("threads", [None, 32, 64, 256])
def test_take_along_plan_covers_every_element_once(ir, ic, threads):
    plan = _along_plan(ir, ic, threads)
    assert (along_cover(plan, ir, ic) == 1).all()
    tpr = 1 << plan.log_tpr
    assert tpr <= plan.threads <= gather2d.THREADS
    assert plan.grid[1] <= gather2d.GRID_Y


@pytest.mark.parametrize("w,b", [(1, 1), (37, 301), (4, 100), (128, 1024),
                                 (8, 777), (2048, 70), (4100, 5)])
@pytest.mark.parametrize("t_off,out_off", [(0, 0), (4, 0), (0, 4)])
@pytest.mark.parametrize("log_rows", [None, 0, 3, 5])
def test_take_rows_plan_covers_every_element_once(w, b, t_off, out_off,
                                                  log_rows):
    """Every output element written once, from its own row's index: the
    kernel's incremental (row, column) walk replayed."""
    plan = gather2d.plan_take_rows(w, b, 4096 + t_off, 8192 + out_off, 132)
    if log_rows is not None:
        plan = gather2d.RowsPlan.covering(plan.vec, log_rows, b)
    writes, source = rows_cover(plan, b, w)
    assert (writes == 1).all()
    assert (source == np.arange(b)[:, None]).all()


def test_misaligned_views_take_the_scalar_path():
    """K2 moves 16-byte units only for W % 4 == 0 with t and out 16-byte
    aligned; a view from element 1 of either, or an odd width, takes the
    4-byte units. K3 has one element-wise path: its plan reads no
    address, so a misaligned view gets the aligned plan."""
    t = torch.zeros((64, 128), dtype=torch.int32)
    assert gather2d.plan_take_rows(128, 64, t.data_ptr(), 0).vec
    for t_addr, out_addr, w in ((4, 0, 128), (0, 4, 128), (0, 0, 37),
                                (8, 8, 128), (0, 12, 4)):
        assert not gather2d.plan_take_rows(w, 64, 4096 + t_addr,
                                           4096 + out_addr).vec
    assert gather2d.plan_take_rows(128, 64, 4096 + 16, 4096 + 32).vec
    import inspect
    assert not any("addr" in p for p in
                   inspect.signature(gather2d.plan_take_along).parameters)


def test_plans_at_the_probe_shapes():
    """The plan's choices at the shapes PERF.md times: small shapes spread
    over 32-thread blocks, P2 and the wide P3 rows in 256-thread blocks;
    K2 in bulk takes 16 rows a warp (16 units a lane), P1-A one, and the
    4-byte units of a misaligned bulk case 4."""
    P = gather2d.plan_take_along
    assert P(8, 128) == gather2d.AlongPlan(5, 32, (1, 8))
    assert P(64, 128) == gather2d.AlongPlan(5, 32, (1, 64))
    assert P(8192, 128) == gather2d.AlongPlan(5, 256, (1, 1024))
    assert P(8, 32768) == gather2d.AlongPlan(8, 256, (32, 8))
    for ir, ic in ((8, 4096), (8, 16384), (8, 65536), (513, 37)):
        plan = P(ir, ic)
        blocks = plan.grid[0] * plan.grid[1]
        assert blocks >= 33 or plan.threads == 32
    assert gather2d.plan_take_rows(128, 1024, 0, 0) == \
        gather2d.RowsPlan(True, 0, 256, 128)
    assert gather2d.plan_take_rows(128, 1 << 16, 0, 0) == \
        gather2d.RowsPlan(True, 4, 256, 512)
    assert gather2d.plan_take_rows(128, 1 << 16, 4, 0) == \
        gather2d.RowsPlan(False, 2, 256, 2048)
    assert gather2d.plan_take_rows(37, 3001, 0, 0).log_rows == 1
    # past 65,535 tiles of rows the grid strides in y
    assert P(1 << 25, 4).grid[1] == gather2d.GRID_Y


@pytest.mark.parametrize("ir,ic,threads", [(70, 4, 32), (513, 37, 64),
                                           (9, 300, None)])
def test_take_along_plan_strides_rows_past_the_grid(monkeypatch, ir, ic,
                                                    threads):
    """With fewer y blocks than tiles of rows (the kernel's stride past
    65,535), every element is still written once."""
    monkeypatch.setattr(gather2d, "GRID_Y", 3)
    plan = _along_plan(ir, ic, threads)
    assert plan.grid[1] == 3
    assert (along_cover(plan, ir, ic) == 1).all()


def test_out_argument_checked():
    t = torch.arange(64 * 8, dtype=torch.int32).reshape(64, 8)
    i1 = torch.arange(16, dtype=torch.int32)
    i2 = torch.zeros((4, 8), dtype=torch.int32)
    out = torch.empty((16, 8), dtype=torch.int32)
    assert gather2d.take_rows(t, i1, out=out) is out
    assert torch.equal(out, t[:16])
    with pytest.raises(ValueError, match="shape"):
        gather2d.take_rows(t, i1, out=torch.empty((16, 7), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        gather2d.take_along(t, i2, 0, out=torch.empty((4, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        gather2d.take_along(t, i2, 0,
                            out=torch.empty((8, 4), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="several devices"):
        gather2d.take_along(t, i2, 0, out=torch.empty(
            (4, 8), dtype=torch.int32, device="meta"))


PLANLESS_DECLARATIONS = """
extern "C" int sheep_take_rows(const void* t, long long rows, long long w,
                               const void* idx, void* out, long long b,
                               void* stream) {
extern "C" int sheep_take_along(const void* x, long long xr, long long xc,
                                const void* idx, void* out, long long ir,
                                long long ic, int axis, int shift,
                                void* stream) {
"""


@pytest.mark.parametrize("case", ["this tree", "planless", "one more",
                                  "one fewer", "missing"])
def test_gather_turns_calls_only_an_interface_it_knows(case):
    """The turns tool calls another gather2d.cu through the interface that
    source declares: this tree's, or the one before the launch plans moved
    to Python; any other declaration is refused before anything is
    compiled or called."""
    from sheep_tpu_torch.tools import gather_turns

    this = (pathlib.Path(gather2d.__file__).parent.parent / "csrc"
            / "gather2d.cu").read_text()
    sources = {
        "this tree": this,
        "planless": PLANLESS_DECLARATIONS,
        "one more": this.replace("long long blocks, void* stream",
                                 "long long blocks, int pdl, void* stream"),
        "one fewer": PLANLESS_DECLARATIONS.replace("int shift,\n", ""),
        "missing": this.replace("sheep_take_along(", "sheep_take_cols("),
    }
    src = sources[case]
    assert src != this or case == "this tree"
    if case in ("this tree", "planless"):
        assert gather_turns.interface_of(src) == (
            "plans" if case == "this tree" else "planless")
    else:
        with pytest.raises(ValueError):
            gather_turns.interface_of(src)


def test_sector_bytes_count_each_warp_run():
    """The L2's sector traffic: a run of 32 consecutive lookups reaches each
    of its distinct 32-byte sectors once."""
    x = torch.zeros((4, 64), dtype=torch.int32)
    assert gather_smoke.sector_bytes(
        x, torch.zeros((4, 64), dtype=torch.int32), 1) == 8 * 32
    spread = torch.arange(64, dtype=torch.int32).repeat(4, 1)
    assert gather_smoke.sector_bytes(x, spread, 1) == 8 * 4 * 32
    # axis 0, form E: the column is the lane, the row the index >> 7
    t = torch.zeros((16, 128), dtype=torch.int32)
    e = torch.arange(128, dtype=torch.int32)[None, :].repeat(2, 1)
    assert gather_smoke.sector_bytes(t, e, 0, 7) == 8 * 4 * 32
