"""Counter-hash chunk synthesis on the card (counterpart of the JAX
package's device-chunk programs, ``_device_chunk_fn._chunk`` and
``_sbm_device_chunk_fn._chunk``, ``sheep_tpu/io/generators.py:252`` and
``:551``).

``hash_chunk(mode, start, count, pad_to, n, keys, params, device)`` gives
the (pad_to, 2) int32 chunk of edge counters [start, start+pad_to): rows
past ``count`` hold the sentinel ``n``. Mode :data:`RMAT` hashes one field
a bit level (``keys`` one a level, ``params`` the thresholds (t_u, t_v0,
t_v1)); mode :data:`SBM` five fields (``keys`` the five field keys,
``params`` (t_out, n_blocks, block_bits)). On a CUDA device it launches
the kernel ``hash_chunk`` (``csrc/synth.cu``); on the CPU it runs
:func:`hash_chunk_plain`, the masked-int64 PyTorch bodies of
``io/generators.py``. Anything else raises. ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sheep_tpu_torch.io import generators

RMAT, SBM = 0, 1
LAUNCHES = {"hash_chunk": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def hash_chunk_plain(mode: int, start: int, count: int, pad_to: int, n: int,
                     keys, params, device) -> torch.Tensor:
    """The plain version of :func:`hash_chunk`, on any device."""
    idx = start + torch.arange(pad_to, dtype=torch.int64, device=device)
    elo, ehi = idx & generators._M32, idx >> 32
    if mode == RMAT:
        u, v = generators._rmat_hash_uv_torch(elo, ehi, keys, params)
    else:
        u, v = generators._sbm_hash_uv_torch(elo, ehi, keys, *params)
    e = torch.stack([u, v], dim=1).to(torch.int32)
    e.narrow(0, count, pad_to - count).fill_(n)
    return e


def _check(mode: int, start: int, count: int, pad_to: int, n: int, keys,
           params) -> None:
    if mode not in (RMAT, SBM):
        raise ValueError(f"hash_chunk: unknown mode {mode}")
    if not (0 <= count <= pad_to < 2**31):
        raise ValueError(f"hash_chunk: need 0 <= count <= pad_to < 2^31, "
                         f"got count {count}, pad_to {pad_to}")
    if not (0 <= start and start + pad_to <= 2**63):
        raise ValueError(f"hash_chunk: counters [{start}, {start + pad_to})"
                         f" outside [0, 2^63)")
    if not (0 <= n < 2**31):
        raise ValueError(f"hash_chunk: sentinel {n} outside int32")
    if mode == RMAT and not 0 <= len(keys) <= 32:
        raise ValueError(f"hash_chunk: {len(keys)} levels, at most 32")
    if mode == SBM:
        n_blocks, block_bits = params[1], params[2]
        if len(keys) != 5 or n_blocks < 2 or not 0 <= block_bits <= 30:
            raise ValueError("hash_chunk: SBM mode takes five keys, "
                             "n_blocks >= 2 and block_bits in [0, 30]")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from sheep_tpu_torch.ops import _build

        lib = _build.load("synth")
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        i, u, ll = ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.sheep_hash_chunk.argtypes = [
            i, u32p, u32p, i, ctypes.c_ulonglong, ll, ll, i, u, u, u,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.sheep_hash_chunk.restype = i
        lib.sheep_cuda_error_string.argtypes = [i]
        lib.sheep_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def hash_chunk(mode: int, start: int, count: int, pad_to: int, n: int,
               keys, params, device) -> torch.Tensor:
    """The padded int32 chunk of counters [start, start+pad_to) on
    ``device`` (see the module docstring)."""
    _check(mode, start, count, pad_to, n, keys, params)
    device = torch.device(device)
    if device.type == "cpu":
        return hash_chunk_plain(mode, start, count, pad_to, n, keys, params,
                                device)
    if device.type != "cuda":
        raise ValueError(f"hash_chunk: unsupported device {device}")
    out = torch.empty((pad_to, 2), dtype=torch.int32, device=device)
    if pad_to == 0:
        return out
    p = list(params)
    if mode == SBM:  # the kernel takes the mask n_blocks - 1
        p[1] -= 1
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sheep_hash_chunk(
            mode, np.asarray(keys, dtype=np.uint32),
            np.asarray(generators._rmat_hash_keys2(keys), dtype=np.uint32),
            len(keys), start, count, pad_to, n, *p, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("hash_chunk launch failed: "
                           + lib.sheep_cuda_error_string(rc).decode())
    LAUNCHES["hash_chunk"] += 1
    return out
