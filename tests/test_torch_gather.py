"""The port's clip-mode gather (sheep_tpu_torch/ops/gather.py) against the
JAX package's Pallas gather in interpreter mode. Exact comparisons: the
function moves int32 values and computes nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import pallas_gather
from sheep_tpu_torch.ops import gather


def _inputs(seed, T, M, lo, hi):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 20, size=T, dtype=np.int32)
    idx = rng.integers(lo, hi, size=M, dtype=np.int32)
    return table, idx


@pytest.mark.parametrize("case", [
    ("in-range", 1 << 12, 0, 1 << 12),
    ("out-of-range", 1 << 12, -(1 << 12), 1 << 13),
    ("ragged-table", 1000, -5, 1100),
])
def test_gather_matches_pallas_interpret(case):
    _, T, lo, hi = case
    table, idx = _inputs(T, T, 1 << 14, lo, hi)
    ref = np.asarray(pallas_gather.vmem_gather(
        jnp.asarray(table), jnp.asarray(idx), block=4096, interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert np.array_equal(gather.gather_clip_plain(t, i).numpy(), ref)
    assert np.array_equal(gather.vmem_gather(t, i, block=4096).numpy(), ref)
    assert np.array_equal(gather.gather_clip(t, i).numpy(), ref)


def test_gather_clip_any_length():
    table, idx = _inputs(3, 77, 12345, -10, 90)
    out = gather.gather_clip(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(out.numpy(), table[np.clip(idx, 0, 76)])
    empty = gather.gather_clip(torch.from_numpy(table),
                               torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0,) and empty.dtype == torch.int32


def test_block_validation():
    t = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        gather.vmem_gather(t, torch.zeros(100, dtype=torch.int32), block=64)
    # the reference raises the same error for the same arguments
    with pytest.raises(ValueError, match="multiple"):
        pallas_gather.vmem_gather(jnp.zeros(16, jnp.int32),
                                  jnp.zeros(100, jnp.int32), block=64)


def test_wrapper_rejects_bad_inputs():
    t = torch.arange(64, dtype=torch.int32)
    i = torch.arange(32, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_clip(t.long(), i)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_clip(t, i.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_clip(t, torch.arange(64, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_clip(t[::2], i)
    with pytest.raises(ValueError, match="1-D"):
        gather.gather_clip(t, i.reshape(4, 8))
    with pytest.raises(ValueError, match="empty"):
        gather.gather_clip(torch.zeros(0, dtype=torch.int32), i)


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on CUDA never reaches the
    plain version."""
    t = torch.empty(64, dtype=torch.int32, device="meta")
    i = torch.empty(32, dtype=torch.int32, device="meta")
    n0 = gather.LAUNCHES["gather_clip"]
    with pytest.raises(ValueError, match="device"):
        gather.gather_clip(t, i)
    assert gather.LAUNCHES["gather_clip"] == n0


def test_cpu_path_counts_no_launch():
    n0 = gather.LAUNCHES["gather_clip"]
    gather.gather_clip(torch.arange(8, dtype=torch.int32),
                       torch.arange(8, dtype=torch.int32))
    assert gather.LAUNCHES["gather_clip"] == n0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: K1 has no CPU mode")
    table, idx = _inputs(5, (1 << 16) + 1, (1 << 17) + 3, -100, 1 << 17)
    t = torch.from_numpy(table).cuda()
    i = torch.from_numpy(idx).cuda()
    n0 = gather.LAUNCHES["gather_clip"]
    out = gather.gather_clip(t, i)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_clip"] == n0 + 1
    assert torch.equal(out, gather.gather_clip_plain(t, i))
