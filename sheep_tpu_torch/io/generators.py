"""Graph generators of the port (counterpart of ``sheep_tpu/io/generators.py``).

``karate_club`` and the counter-hash R-MAT stream. The R-MAT is a stateless
hash per (edge index, level), so any edge range is computable on its own:
on the host in numpy uint32, or on a device in torch int64 masked to 32
bits. Both are bit-equal to the JAX package's ``rmat_hash_range``.
"""

from __future__ import annotations

import numpy as np
import torch

# Zachary karate club, 34 vertices / 78 undirected edges (0-indexed),
# the standard public edge list (W. W. Zachary, 1977).
_KARATE = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]


def karate_club() -> np.ndarray:
    """34 v / 78 e."""
    return np.asarray(_KARATE, dtype=np.int64)


# ---------------------------------------------------------------------------
# counter-hash R-MAT. Per bit level, u's bit is 1 with probability c+d, then
# v's bit is 1 with probability b/(a+b) (u bit 0) or d/(c+d) (u bit 1); the
# two uniforms are the 16-bit halves of one 32-bit hash and the thresholds
# are integers, so every implementation agrees bit for bit.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32_int(x: int) -> int:
    """murmur3 fmix32 on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def _rmat_hash_keys(scale: int, seed: int):
    """Per-level uint32 keys derived from the seed."""
    s = _mix32_int((seed & _M32) ^ 0x9E3779B9)
    return [_mix32_int(s + 0x9E3779B9 * (lvl + 1)) for lvl in range(scale)]


def _rmat_hash_keys2(keys):
    """Second per-level constant, folded with the high counter word."""
    return [_mix32_int(k ^ 0x7FEB352D) for k in keys]


def _rmat_hash_thresholds(a: float, b: float, c: float):
    """16-bit integer thresholds for the quadrant choice."""
    d = 1.0 - a - b - c
    t_u = min(65535, max(0, round((c + d) * 65536)))
    t_v0 = min(65535, max(0, round(b / (a + b) * 65536)))
    t_v1 = min(65535, max(0, round(d / (c + d) * 65536)))
    return t_u, t_v0, t_v1


def _rmat_hash_uv(elo: np.ndarray, ehi: np.ndarray, keys, thresholds):
    """Host body: uint32 counter words (elo, ehi) -> int64 (u, v)."""
    t_u, t_v0, t_v1 = (np.uint32(t) for t in thresholds)
    u = np.zeros(elo.shape, dtype=np.uint32)
    v = np.zeros(elo.shape, dtype=np.uint32)
    for bit, (key, key2) in enumerate(zip(keys, _rmat_hash_keys2(keys))):
        h = elo ^ np.uint32(key)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (ehi ^ np.uint32(key2))
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
        ubit = ((h >> np.uint32(16)) < t_u).astype(np.uint32)
        t_v = np.where(ubit == 1, t_v1, t_v0)
        vbit = ((h & np.uint32(0xFFFF)) < t_v).astype(np.uint32)
        u = u | (ubit << np.uint32(bit))
        v = v | (vbit << np.uint32(bit))
    return u.astype(np.int64), v.astype(np.int64)


def _rmat_hash_uv_torch(elo: torch.Tensor, ehi: torch.Tensor, keys,
                        thresholds):
    """Device body in int64 masked to 32 bits. torch's uint32 arithmetic
    is partial; an int64 product that wraps still has the right low 32
    bits, and every shift is taken on a masked (non-negative) value."""
    t_u, t_v0, t_v1 = thresholds
    u = torch.zeros_like(elo)
    v = torch.zeros_like(elo)
    for bit, (key, key2) in enumerate(zip(keys, _rmat_hash_keys2(keys))):
        h = elo ^ key
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & _M32
        h = h ^ (ehi ^ key2)
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & _M32
        h = h ^ (h >> 16)
        ubit = (h >> 16) < t_u
        t_v = torch.where(ubit, t_v1, t_v0)
        vbit = (h & 0xFFFF) < t_v
        u = u | (ubit.to(torch.int64) << bit)
        v = v | (vbit.to(torch.int64) << bit)
    return u, v


def rmat_hash_range(scale: int, start: int, count: int, a: float = 0.57,
                    b: float = 0.19, c: float = 0.19,
                    seed: int = 0) -> np.ndarray:
    """Edges [start, start+count) of the counter-hash R-MAT stream as a
    (count, 2) int64 host array."""
    keys = _rmat_hash_keys(scale, seed)
    th = _rmat_hash_thresholds(a, b, c)
    idx = start + np.arange(count, dtype=np.int64)
    elo = (idx & _M32).astype(np.uint32)
    ehi = (idx >> 32).astype(np.uint32)
    u, v = _rmat_hash_uv(elo, ehi, keys, th)
    return np.stack([u, v], axis=1)


def rmat_hash_chunk_device(scale: int, start: int, count: int, pad_to: int,
                           n: int, device, a: float = 0.57, b: float = 0.19,
                           c: float = 0.19, seed: int = 0) -> torch.Tensor:
    """A (pad_to, 2) int32 chunk synthesized on ``device``: rows past
    ``count`` hold the sentinel vertex ``n``. Bit-equal to
    :func:`rmat_hash_range` over the same range."""
    keys = _rmat_hash_keys(scale, seed)
    th = _rmat_hash_thresholds(a, b, c)
    idx = start + torch.arange(pad_to, dtype=torch.int64, device=device)
    u, v = _rmat_hash_uv_torch(idx & _M32, idx >> 32, keys, th)
    e = torch.stack([u, v], dim=1).to(torch.int32)
    if count < pad_to:
        e[count:] = n
    return e


class RmatHashStream:
    """Counter-hash R-MAT stream: 2**scale vertices, edge_factor * 2**scale
    edges. ``chunks`` hashes host ranges; ``device_chunk`` synthesizes the
    padded chunk straight into device memory."""

    def __init__(self, scale: int, edge_factor: int = 16, a: float = 0.57,
                 b: float = 0.19, c: float = 0.19, seed: int = 0):
        if not (1 <= scale <= 31):
            raise ValueError(f"rmat-hash scale must be 1..31, got {scale}")
        self.scale = int(scale)
        self.edge_factor = int(edge_factor)
        self.abc = (float(a), float(b), float(c))
        self.seed = int(seed)
        self._m = self.edge_factor << self.scale
        self._n = 1 << self.scale

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def num_vertices(self) -> int:
        return self._n

    def clamp_chunk_edges(self, chunk_edges: int, floor: int = 1024) -> int:
        return min(chunk_edges, max(floor, self._m))

    def num_chunks(self, chunk_edges: int) -> int:
        return -(-self._m // int(chunk_edges))

    def chunks(self, chunk_edges: int):
        cs = int(chunk_edges)
        for i in range(self.num_chunks(cs)):
            yield rmat_hash_range(self.scale, i * cs,
                                  min(cs, self._m - i * cs), *self.abc,
                                  seed=self.seed)

    def device_chunk(self, idx: int, chunk_edges: int, n: int, device):
        cs = int(chunk_edges)
        start = idx * cs
        count = max(0, min(cs, self._m - start))
        return rmat_hash_chunk_device(self.scale, start, count, cs, n,
                                      device, *self.abc, seed=self.seed)
