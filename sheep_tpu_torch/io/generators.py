"""Graph generators of the port (counterpart of ``sheep_tpu/io/generators.py``).

``karate_club``, the PCG replay R-MAT (``rmat``, ``rmat_stream``) and the
counter-hash streams: R-MAT, the planted partition (SBM) and its three
quality-scenario variants (near-clique, power-law SBM, bipartite). A
counter-hash stream is a stateless hash per (edge index, field), so any
edge range is computable on its own: on the host in numpy uint32 (or the
native loop of ``csrc/sheep_core.cpp`` for large ranges), or on the card
by the ``hash_chunk`` kernel (``ops/synth.py``), whose plain version is
the masked-int64 PyTorch bodies here. All of them are bit-equal to the
JAX package's host and device chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from sheep_tpu_torch.io.devicestream import DeviceStream

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
# PCG replay R-MAT (Chakrabarti et al. 2004, Graph500 parameters): numpy's
# default generator, seeded per chunk, so a stream replays exactly.
# ---------------------------------------------------------------------------

def _rmat_batch(scale: int, cnt: int, rng, a: float, b: float,
                c: float) -> np.ndarray:
    d = 1.0 - a - b - c
    u = np.zeros(cnt, dtype=np.int64)
    v = np.zeros(cnt, dtype=np.int64)
    for bit in range(scale):
        r1 = rng.random(cnt)
        r2 = rng.random(cnt)
        # the u bit, then the v bit conditioned on it
        ubit = (r1 > (a + b)).astype(np.int64)
        pv = np.where(ubit == 0, b / (a + b), d / (c + d))
        vbit = (r2 < pv).astype(np.int64)
        u |= ubit << bit
        v |= vbit << bit
    return np.stack([u, v], axis=1)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, batch: int = 1 << 20) -> np.ndarray:
    """2**scale vertices, edge_factor * 2**scale edges, as one (m, 2) int64
    array (use :func:`rmat_stream` for graphs that do not fit)."""
    m = edge_factor << scale
    rng = np.random.default_rng(seed)
    out = np.empty((m, 2), dtype=np.int64)
    for off in range(0, m, batch):
        cnt = min(batch, m - off)
        out[off:off + cnt] = _rmat_batch(scale, cnt, rng, a, b, c)
    return out


def rmat_stream(scale: int, edge_factor: int = 16, a: float = 0.57,
                b: float = 0.19, c: float = 0.19, seed: int = 0,
                chunk: int = 1 << 22):
    """R-MAT edges chunk by chunk, chunk i from the seed sequence
    (seed, i)."""
    m = edge_factor << scale
    for i, off in enumerate(range(0, m, chunk)):
        cnt = min(chunk, m - off)
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        yield _rmat_batch(scale, cnt, rng, a, b, c)


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
    """Second per-level (or per-field) constant, folded with the high
    counter word."""
    return [_mix32_int(k ^ 0x7FEB352D) for k in keys]


def _rmat_hash_thresholds(a: float, b: float, c: float):
    """16-bit integer thresholds for the quadrant choice."""
    d = 1.0 - a - b - c
    t_u = min(65535, max(0, round((c + d) * 65536)))
    t_v0 = min(65535, max(0, round(b / (a + b) * 65536)))
    t_v1 = min(65535, max(0, round(d / (c + d) * 65536)))
    return t_u, t_v0, t_v1


def _counter_words(start: int, count: int):
    """uint32 (low, high) words of the edge counters [start, start+count)."""
    idx = start + np.arange(count, dtype=np.int64)
    return (idx & _M32).astype(np.uint32), (idx >> 32).astype(np.uint32)


def _hash_fields(elo: np.ndarray, ehi: np.ndarray, keys):
    """One independent 32-bit uniform per key for each counter (fmix32
    over elo ^ key, folded with ehi mid-mix), in uint32 arithmetic; yielded
    one field at a time."""
    for key, key2 in zip(keys, _rmat_hash_keys2(keys)):
        h = elo ^ np.uint32(key)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (ehi ^ np.uint32(key2))
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
        yield h


def _rmat_hash_uv(elo: np.ndarray, ehi: np.ndarray, keys, thresholds,
                  dtype=np.int64):
    """Host body: uint32 counter words (elo, ehi) -> (u, v) of ``dtype``."""
    t_u, t_v0, t_v1 = (np.uint32(t) for t in thresholds)
    u = np.zeros(elo.shape, dtype=np.uint32)
    v = np.zeros(elo.shape, dtype=np.uint32)
    for bit, h in enumerate(_hash_fields(elo, ehi, keys)):
        ubit = ((h >> np.uint32(16)) < t_u).astype(np.uint32)
        t_v = np.where(ubit == 1, t_v1, t_v0)
        vbit = ((h & np.uint32(0xFFFF)) < t_v).astype(np.uint32)
        u = u | (ubit << np.uint32(bit))
        v = v | (vbit << np.uint32(bit))
    return u.astype(dtype), v.astype(dtype)


def _hash_fields_torch(elo: torch.Tensor, ehi: torch.Tensor, keys):
    """:func:`_hash_fields` in int64 masked to 32 bits. torch's uint32
    arithmetic is partial; an int64 product that wraps still has the right
    low 32 bits, and every shift is taken on a masked (non-negative)
    value."""
    for key, key2 in zip(keys, _rmat_hash_keys2(keys)):
        h = elo ^ key
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & _M32
        h = h ^ (ehi ^ key2)
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & _M32
        h = h ^ (h >> 16)
        yield h


def _rmat_hash_uv_torch(elo: torch.Tensor, ehi: torch.Tensor, keys,
                        thresholds):
    """Device body in int64 masked to 32 bits: the plain version of
    ``hash_chunk``'s R-MAT mode."""
    t_u, t_v0, t_v1 = thresholds
    u = torch.zeros_like(elo)
    v = torch.zeros_like(elo)
    for bit, h in enumerate(_hash_fields_torch(elo, ehi, keys)):
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
    (count, 2) int64 host array; ranges of 4096 edges or more take the
    native loop."""
    keys = _rmat_hash_keys(scale, seed)
    th = _rmat_hash_thresholds(a, b, c)
    if count >= 4096:
        from sheep_tpu_torch.core import native

        return native.rmat_hash_range(scale, start, count, keys,
                                      _rmat_hash_keys2(keys), th)
    u, v = _rmat_hash_uv(*_counter_words(start, count), keys, th)
    return np.stack([u, v], axis=1)


def rmat_hash_chunk_device(scale: int, start: int, count: int, pad_to: int,
                           n: int, device, a: float = 0.57, b: float = 0.19,
                           c: float = 0.19, seed: int = 0) -> torch.Tensor:
    """A (pad_to, 2) int32 chunk synthesized on ``device`` by
    ``hash_chunk``: rows past ``count`` hold the sentinel vertex ``n``.
    Bit-equal to :func:`rmat_hash_range` over the same range."""
    from sheep_tpu_torch.ops import synth

    return synth.hash_chunk(synth.RMAT, start, count, pad_to, n,
                            _rmat_hash_keys(scale, seed),
                            _rmat_hash_thresholds(a, b, c), device)


class _CounterHashStream:
    """The stream surface shared by the counter-hash streams. Subclasses
    set ``_n`` / ``_m`` and implement ``_range(start, count)`` (a host
    chunk as an int64 (count, 2) array); those with a device body also
    provide ``device_chunk``. Chunk i is ``_range(i*cs, cs)``, so any
    chunk is computed on its own."""

    path = None
    fmt = "generator"

    def _range(self, start: int, count: int) -> np.ndarray:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def num_edges(self) -> int:
        return self._m

    @property
    def num_edges_cheap(self) -> int:
        return self._m

    @property
    def num_edges_upper_bound(self) -> int:
        return self._m

    @property
    def num_vertices(self) -> int:
        return self._n

    def clamp_chunk_edges(self, chunk_edges: int, parts: int = 1,
                          floor: int = 1024) -> int:
        return min(chunk_edges, max(floor, -(-self._m // parts)))

    def num_chunks(self, chunk_edges: int) -> int:
        return -(-self._m // int(chunk_edges))

    def chunks(self, chunk_edges: int = 1 << 22, start_chunk: int = 0,
               shard: int = 0, num_shards: int = 1,
               byte_range: bool = False):
        """Chunk i by direct range hashing, so a worker skips straight to
        its own: chunks i >= ``start_chunk`` with ``i % num_shards ==
        shard`` (``byte_range`` means nothing here)."""
        if not 0 <= shard < num_shards:
            raise ValueError(f"bad shard {shard}/{num_shards}")
        cs = int(chunk_edges)
        first = int(start_chunk)
        first += (shard - first) % num_shards
        for i in range(first, self.num_chunks(cs), num_shards):
            yield self._range(i * cs, min(cs, self._m - i * cs))

    def count_edges_in_span(self, shard: int, num_shards: int) -> int:
        """The edges of worker ``shard``'s round-robin chunks at the
        default width, by arithmetic (the reference's count)."""
        cs = 1 << 22
        n_chunks = -(-self._m // cs)
        total = len(range(shard, n_chunks, num_shards)) * cs
        if n_chunks and (n_chunks - 1) % num_shards == shard:
            total -= n_chunks * cs - self._m  # the short last chunk
        return total

    def read_all(self) -> np.ndarray:
        return self._range(0, self._m)

    def _fingerprint(self, tag: str) -> str:
        """A cheap stable identity for the checkpoint fingerprint: the
        parameters (``tag``) and a hash of the first 4096 edges, as the
        reference's ``_CounterHashStream._fingerprint``."""
        import hashlib

        sample = self._range(0, min(4096, self._m))
        return tag + hashlib.sha1(
            np.ascontiguousarray(sample).tobytes()).hexdigest()


class RmatHashStream(DeviceStream, _CounterHashStream):
    """Counter-hash R-MAT stream: 2**scale vertices, edge_factor * 2**scale
    edges. ``device_chunk`` synthesizes the padded chunk straight into
    device memory."""

    def __init__(self, scale: int, edge_factor: int = 16, a: float = 0.57,
                 b: float = 0.19, c: float = 0.19, seed: int = 0):
        if not (1 <= scale <= 32):
            # vertex bits accumulate in uint32; the build refuses ids of
            # 2^31 and more (types.check_vertex_range)
            raise ValueError(f"rmat-hash scale must be 1..32, got {scale}")
        self.scale = int(scale)
        self.edge_factor = int(edge_factor)
        self.abc = (float(a), float(b), float(c))
        self.seed = int(seed)
        self._m = self.edge_factor << self.scale
        self._n = 1 << self.scale

    def _range(self, start: int, count: int) -> np.ndarray:
        return rmat_hash_range(self.scale, start, count, *self.abc,
                               seed=self.seed)

    def content_fingerprint(self) -> str:
        return self._fingerprint(f"rmat_hash/s{self.scale}/"
                                 f"ef{self.edge_factor}/{self.abc}/"
                                 f"{self.seed}/")

    def device_chunk(self, idx: int, chunk_edges: int, n: int, device):
        cs = int(chunk_edges)
        start = idx * cs
        count = max(0, min(cs, self._m - start))
        return rmat_hash_chunk_device(self.scale, start, count, cs, n,
                                      device, *self.abc, seed=self.seed)


# ---------------------------------------------------------------------------
# Counter-hash planted partition (SBM). Per edge counter, five uniforms:
#   cross = h0 < round(p_out * 2^32)
#   bu    = h1 & (n_blocks - 1)               (blocks are a power of two)
#   bv    = a block other than bu, from h2    (used when cross)
#   u     = bu * block_size + (h3 & (block_size - 1))
#   v     = (cross ? bv : bu) * block_size + (h4 & (block_size - 1))
# so a cross edge never lands inside a block, and the ground truth of
# vertex v is v >> block_bits.
# ---------------------------------------------------------------------------

def _sbm_hash_keys(seed: int):
    """Five per-field uint32 keys (decide, bu, bv, uoff, voff)."""
    s = _mix32_int((seed & _M32) ^ 0x2545F491)
    return [_mix32_int(s + 0x9E3779B9 * (f + 1)) for f in range(5)]


def _sbm_blocks(h_cross, h_bu, h_bv, t_out: int, n_blocks: int, where):
    """(bu, block of v) from the first three fields; ``where`` is the
    namespace's select (numpy uint32 or torch int64)."""
    cross = h_cross < t_out
    bu = h_bu & (n_blocks - 1)
    # a block other than bu: draw from [0, n_blocks-1) and skip past bu
    bvr = h_bv % (n_blocks - 1)
    bv = bvr + (bvr >= bu)
    return bu, where(cross, bv, bu)


def _sbm_hash_uv(elo: np.ndarray, ehi: np.ndarray, keys, t_out: int,
                 n_blocks: int, block_bits: int):
    """Host body: counter words -> int64 (u, v), in uint32 arithmetic."""
    h_cross, h_bu, h_bv, h_uo, h_vo = _hash_fields(elo, ehi, keys)
    bu, b2 = _sbm_blocks(h_cross, h_bu, h_bv, np.uint32(t_out),
                         np.uint32(n_blocks), np.where)
    off_mask = np.uint32((1 << block_bits) - 1)
    u = (bu << np.uint32(block_bits)) | (h_uo & off_mask)
    v = (b2 << np.uint32(block_bits)) | (h_vo & off_mask)
    return u.astype(np.int64), v.astype(np.int64)


def _sbm_hash_uv_torch(elo: torch.Tensor, ehi: torch.Tensor, keys,
                       t_out: int, n_blocks: int, block_bits: int):
    """Device body in int64 masked to 32 bits: the plain version of
    ``hash_chunk``'s SBM mode."""
    h_cross, h_bu, h_bv, h_uo, h_vo = _hash_fields_torch(elo, ehi, keys)
    bu, b2 = _sbm_blocks(h_cross, h_bu, h_bv, t_out, n_blocks, torch.where)
    off_mask = (1 << block_bits) - 1
    return ((bu << block_bits) | (h_uo & off_mask),
            (b2 << block_bits) | (h_vo & off_mask))


def _sbm_t_out(p_out: float) -> int:
    """p_out as a uint32 threshold (clamped; p_out = 1.0 maps to 2^32-1)."""
    return min(_M32, max(0, round(float(p_out) * 4294967296.0)))


def _check_blocks(n_blocks: int, most: int, most_text: str) -> int:
    nb = int(n_blocks)
    if nb < 2 or nb & (nb - 1) or nb > most:
        raise ValueError(f"n_blocks must be a power of two in "
                         f"[2, {most_text}], got {n_blocks}")
    return nb


def _check_p_out(p_out: float) -> None:
    if not (0.0 <= p_out <= 1.0):
        raise ValueError(f"p_out must be in [0, 1], got {p_out}")


def sbm_hash_range(scale: int, start: int, count: int, n_blocks: int,
                   p_out: float, seed: int = 0) -> np.ndarray:
    """Edges [start, start+count) of the counter-hash planted partition as
    a (count, 2) int64 host array; ranges of 4096 edges or more take the
    native loop."""
    nb = _check_blocks(n_blocks, 1 << scale, "2**scale")
    keys = _sbm_hash_keys(seed)
    block_bits = scale - (nb.bit_length() - 1)
    if count >= 4096:
        from sheep_tpu_torch.core import native

        return native.sbm_hash_range(start, count, keys,
                                     _rmat_hash_keys2(keys),
                                     _sbm_t_out(p_out), nb, block_bits)
    u, v = _sbm_hash_uv(*_counter_words(start, count), keys,
                        _sbm_t_out(p_out), nb, block_bits)
    return np.stack([u, v], axis=1)


class SbmHashStream(DeviceStream, _CounterHashStream):
    """Planted-partition (stochastic block model) counter-hash stream:
    2**scale vertices in ``n_blocks`` equal contiguous blocks, each edge
    inter-block with probability ``p_out``. ``device_chunk`` synthesizes
    the padded chunk on the card."""

    def __init__(self, scale: int, n_blocks: int = 64, p_out: float = 0.05,
                 edge_factor: int = 16, seed: int = 0):
        if not (1 <= scale <= 31):
            raise ValueError(f"sbm-hash scale must be 1..31, got {scale}")
        nb = _check_blocks(n_blocks, 1 << scale, "2**scale")
        _check_p_out(p_out)
        self.scale = int(scale)
        self.n_blocks = nb
        self.block_bits = self.scale - (nb.bit_length() - 1)
        self.p_out = float(p_out)
        self.edge_factor = int(edge_factor)
        self.seed = int(seed)
        self._m = self.edge_factor << self.scale
        self._n = 1 << self.scale

    def _range(self, start: int, count: int) -> np.ndarray:
        return sbm_hash_range(self.scale, start, count, self.n_blocks,
                              self.p_out, seed=self.seed)

    def content_fingerprint(self) -> str:
        return self._fingerprint(
            f"sbm_hash/s{self.scale}/b{self.n_blocks}/p{self.p_out}/"
            f"ef{self.edge_factor}/{self.seed}/")

    def ground_truth(self, k: int | None = None) -> np.ndarray:
        """The planted assignment at ``k`` parts (default: one part per
        block); consecutive blocks group into a part."""
        k = self.n_blocks if k is None else int(k)
        if k < 1 or self.n_blocks % k:
            raise ValueError(f"k must divide n_blocks={self.n_blocks}, "
                             f"got {k}")
        per = self.n_blocks // k
        blocks = np.arange(self._n, dtype=np.int64) >> self.block_bits
        return (blocks // per).astype(np.int32)

    def planted_cut_ratio(self, k: int | None = None) -> float:
        """The expected cut ratio of the planted partition at ``k`` parts:
        the cross rate at one part per block; at grouped parts a cross
        edge stays inside its part with probability
        (per - 1)/(n_blocks - 1)."""
        p = _sbm_t_out(self.p_out) / 4294967296.0
        if k is None or k == self.n_blocks:
            return p
        if k < 1 or self.n_blocks % k:
            raise ValueError(f"k must divide n_blocks={self.n_blocks}, "
                             f"got {k}")
        per = self.n_blocks // k
        return p * (self.n_blocks - per) / max(self.n_blocks - 1, 1)

    def device_chunk(self, idx: int, chunk_edges: int, n: int, device):
        from sheep_tpu_torch.ops import synth

        cs = int(chunk_edges)
        start = idx * cs
        count = max(0, min(cs, self._m - start))
        return synth.hash_chunk(
            synth.SBM, start, count, cs, n, _sbm_hash_keys(self.seed),
            (_sbm_t_out(self.p_out), self.n_blocks, self.block_bits),
            device)


class NearCliqueStream(SbmHashStream):
    """Planted near-clique communities: blocks of ``2**clique_bits``
    vertices, each edge intra-block with probability ``1 - p_out``. The
    planted partition with n_blocks = 2**(scale - clique_bits), so its
    host, device and ground-truth paths are the SBM's."""

    def __init__(self, scale: int, clique_bits: int, p_out: float = 0.01,
                 edge_factor: int = 8, seed: int = 0):
        cb = int(clique_bits)
        if not (1 <= cb < int(scale)):
            raise ValueError(f"clique_bits must be in [1, scale), got "
                             f"{clique_bits}")
        super().__init__(scale, 1 << (int(scale) - cb), p_out, edge_factor,
                         seed=seed)
        self.clique_bits = cb

    def content_fingerprint(self) -> str:
        return self._fingerprint(
            f"nearclique_hash/s{self.scale}/c{self.clique_bits}/"
            f"p{self.p_out}/ef{self.edge_factor}/{self.seed}/")


class PowerlawSbmHashStream(_CounterHashStream):
    """The planted partition with power-law within-block degrees: the
    SBM's block choice, and the within-block offsets from the R-MAT bit
    walk over ``block_bits`` levels. Host chunks only: the build stages
    them through the H2D ring."""

    def __init__(self, scale: int, n_blocks: int = 16, p_out: float = 0.05,
                 edge_factor: int = 16, seed: int = 0, a: float = 0.57,
                 b: float = 0.19, c: float = 0.19):
        if not (1 <= scale <= 31):
            raise ValueError(f"plsbm-hash scale must be 1..31, got {scale}")
        # at least 2 vertices a block, so the offset walk has a level
        nb = _check_blocks(n_blocks, 1 << (scale - 1), "2**(scale-1)")
        _check_p_out(p_out)
        self.scale = int(scale)
        self.n_blocks = nb
        self.block_bits = self.scale - (nb.bit_length() - 1)
        self.p_out = float(p_out)
        self.edge_factor = int(edge_factor)
        self.seed = int(seed)
        self.abc = (float(a), float(b), float(c))
        self._m = self.edge_factor << self.scale
        self._n = 1 << self.scale

    def _range(self, start: int, count: int) -> np.ndarray:
        elo, ehi = _counter_words(start, count)
        h_cross, h_bu, h_bv = _hash_fields(elo, ehi,
                                           _sbm_hash_keys(self.seed)[:3])
        bu, b2 = _sbm_blocks(h_cross, h_bu, h_bv,
                             np.uint32(_sbm_t_out(self.p_out)),
                             np.uint32(self.n_blocks), np.where)
        # offsets: the R-MAT walk on a key schedule of their own
        okeys = _rmat_hash_keys(self.block_bits,
                                _mix32_int(self.seed ^ 0x6A09E667))
        uo, vo = _rmat_hash_uv(elo, ehi, okeys,
                               _rmat_hash_thresholds(*self.abc), np.uint32)
        u = (bu << np.uint32(self.block_bits)) | uo
        v = (b2 << np.uint32(self.block_bits)) | vo
        return np.stack([u.astype(np.int64), v.astype(np.int64)], axis=1)

    def content_fingerprint(self) -> str:
        return self._fingerprint(
            f"plsbm_hash/s{self.scale}/b{self.n_blocks}/p{self.p_out}/"
            f"ef{self.edge_factor}/{self.abc}/{self.seed}/")

    ground_truth = SbmHashStream.ground_truth
    planted_cut_ratio = SbmHashStream.planted_cut_ratio


class BipartiteHashStream(_CounterHashStream):
    """Planted bipartite communities: a left half [0, n/2) and a right
    half [n/2, n), every edge across them; ``n_blocks`` bi-communities
    each own a left and the matching right segment, and an edge joins its
    block's two sides with probability ``1 - p_out``. Host chunks only:
    the build stages them through the H2D ring."""

    def __init__(self, scale: int, n_blocks: int = 8, p_out: float = 0.02,
                 edge_factor: int = 16, seed: int = 0):
        if not (2 <= scale <= 31):
            raise ValueError(f"bipartite-hash scale must be 2..31, "
                             f"got {scale}")
        nb = _check_blocks(n_blocks, 1 << (int(scale) - 1), "2**(scale-1)")
        _check_p_out(p_out)
        self.scale = int(scale)
        self.n_blocks = nb
        # a side's block span: half / n_blocks vertices
        self.block_bits = (self.scale - 1) - (nb.bit_length() - 1)
        self.p_out = float(p_out)
        self.edge_factor = int(edge_factor)
        self.seed = int(seed)
        self._m = self.edge_factor << self.scale
        self._n = 1 << self.scale

    def _range(self, start: int, count: int) -> np.ndarray:
        keys = _sbm_hash_keys(_mix32_int(self.seed ^ 0x3C6EF372))
        h_cross, h_bu, h_bv, h_uo, h_vo = _hash_fields(
            *_counter_words(start, count), keys)
        bu, b2 = _sbm_blocks(h_cross, h_bu, h_bv,
                             np.uint32(_sbm_t_out(self.p_out)),
                             np.uint32(self.n_blocks), np.where)
        off_mask = np.uint32((1 << self.block_bits) - 1)
        half = np.int64(self._n >> 1)
        u = (bu.astype(np.int64) << self.block_bits) \
            | (h_uo & off_mask).astype(np.int64)
        v = half + ((b2.astype(np.int64) << self.block_bits)
                    | (h_vo & off_mask).astype(np.int64))
        return np.stack([u, v], axis=1)

    def content_fingerprint(self) -> str:
        return self._fingerprint(
            f"bipartite_hash/s{self.scale}/b{self.n_blocks}/"
            f"p{self.p_out}/ef{self.edge_factor}/{self.seed}/")

    def ground_truth(self, k: int | None = None) -> np.ndarray:
        """Planted assignment at ``k`` parts (default: one per
        bi-community); a part takes a block's left and right segments."""
        k = self.n_blocks if k is None else int(k)
        if k < 1 or self.n_blocks % k:
            raise ValueError(f"k must divide n_blocks={self.n_blocks}, "
                             f"got {k}")
        per = self.n_blocks // k
        side_off = np.arange(self._n, dtype=np.int64) % (self._n >> 1)
        return ((side_off >> self.block_bits) // per).astype(np.int32)

    planted_cut_ratio = SbmHashStream.planted_cut_ratio
