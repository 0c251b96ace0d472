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
