// hash_chunk: counter-hash edge synthesis of one padded chunk, B12.
//
// Replaces the JAX package's device-chunk programs (XLA, not Pallas):
// sheep_tpu/io/generators.py _device_chunk_fn._chunk (:252, R-MAT) and
// _sbm_device_chunk_fn._chunk (:551, the planted partition, which the
// near-clique stream shares). Row i of the (pad_to, 2) int32 output is the
// edge of counter start + i for i < count and (n, n) after it. The counter
// is split into uint32 words as the reference splits it: elo = lo0 + i
// with wraparound, ehi = hi0 + (elo < lo0), the 64-bit carry. Each field
// is murmur3's fmix32 over elo ^ key, folded with ehi ^ key2 mid-mix
// (_hash_fields, :463).
//
//   R-MAT mode (_rmat_hash_uv, :178): `levels` fields, one a bit level;
//     u's bit is (h >> 16) < t_u, v's bit (h & 0xFFFF) < (u bit ? t_v1 :
//     t_v0).
//   SBM mode (_sbm_hash_uv, :481): five fields; cross = h0 < t_out, bu =
//     h1 & (nb - 1), bvr = h2 % (nb - 1), bv = bvr + (bvr >= bu), and the
//     block offsets masked to block_bits.
//
// All arithmetic is unsigned 32-bit, so every row is bit-equal to the
// host twins and to the plain version (io/generators.py, int64 masked to
// 32 bits).
//
// Bound: the kernel reads nothing but its arguments and writes 8 bytes a
// row (0.020 ms for 2^23 rows at 3.35 TB/s); its level loop is 26 SASS
// instructions, so at scale 22 R-MAT mode executes some 600 a row (SBM
// mode 116) and is bound by the card's instruction rate, not by bytes.
// Its design: one thread a row, the per-level keys in a __grid_constant__
// argument (read through the constant cache, the same word for every
// thread of a warp), the level loop kept rolled so that its body is one
// level, and one 8-byte store a row, coalesced across the warp.
//
// Bound to PyTorch through a plain C function (loaded with ctypes): the
// caller passes the keys, the output's device pointer and its CUDA
// stream, and gets back cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
enum : int { kRmat = 0, kSbm = 1 };

struct Keys {
  uint32_t key[kMaxLevels];
  uint32_t key2[kMaxLevels];
};

__device__ __forceinline__ uint32_t field(uint32_t elo, uint32_t ehi,
                                          uint32_t key, uint32_t key2) {
  uint32_t h = elo ^ key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= ehi ^ key2;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// p0, p1, p2: t_u, t_v0, t_v1 (R-MAT); t_out, n_blocks - 1, block_bits
// (SBM)
template <int kMode>
__global__ void hash_chunk_kernel(const __grid_constant__ Keys keys,
                                  int levels, uint32_t lo0, uint32_t hi0,
                                  int64_t count, int64_t pad_to, int32_t n,
                                  uint32_t p0, uint32_t p1, uint32_t p2,
                                  int2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pad_to) return;
  if (i >= count) {
    out[i] = make_int2(n, n);
    return;
  }
  const uint32_t elo = lo0 + (uint32_t)i;
  const uint32_t ehi = hi0 + (elo < lo0 ? 1u : 0u);
  uint32_t u = 0, v = 0;
  if (kMode == kRmat) {
#pragma unroll 1
    for (int b = 0; b < levels; ++b) {
      const uint32_t h = field(elo, ehi, keys.key[b], keys.key2[b]);
      const uint32_t ubit = (h >> 16) < p0 ? 1u : 0u;
      const uint32_t vbit = (h & 0xFFFFu) < (ubit ? p2 : p1) ? 1u : 0u;
      u |= ubit << b;
      v |= vbit << b;
    }
  } else {
    const uint32_t cross = field(elo, ehi, keys.key[0], keys.key2[0]);
    const uint32_t bu = field(elo, ehi, keys.key[1], keys.key2[1]) & p1;
    const uint32_t bvr = field(elo, ehi, keys.key[2], keys.key2[2]) % p1;
    const uint32_t bv = bvr + (bvr >= bu ? 1u : 0u);
    const uint32_t b2 = cross < p0 ? bv : bu;
    const uint32_t mask = (1u << p2) - 1u;
    u = (bu << p2) | (field(elo, ehi, keys.key[3], keys.key2[3]) & mask);
    v = (b2 << p2) | (field(elo, ehi, keys.key[4], keys.key2[4]) & mask);
  }
  out[i] = make_int2((int32_t)u, (int32_t)v);
}

}  // namespace

// mode 0 R-MAT (levels = scale, 1..32), 1 SBM (levels = 5); keys and keys2
// are host arrays of `levels` words; out is the (pad_to, 2) int32 device
// output. Returns a cudaError_t.
extern "C" int sheep_hash_chunk(int mode, const uint32_t* keys,
                                const uint32_t* keys2, int levels,
                                unsigned long long start, long long count,
                                long long pad_to, int n, unsigned p0,
                                unsigned p1, unsigned p2, void* out,
                                void* stream) {
  if (pad_to <= 0) return 0;
  if (levels < 0 || levels > kMaxLevels || pad_to > 0x7FFFFFFFLL ||
      (mode == kSbm && (levels != 5 || p1 == 0 || p2 > 31)) ||
      (mode != kRmat && mode != kSbm))
    return (int)cudaErrorInvalidValue;
  Keys k = {};
  for (int j = 0; j < levels; ++j) {
    k.key[j] = keys[j];
    k.key2[j] = keys2[j];
  }
  const unsigned blocks =
      (unsigned)((pad_to + sheep::kThreads - 1) / sheep::kThreads);
  const uint32_t lo0 = (uint32_t)start, hi0 = (uint32_t)(start >> 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kRmat)
    hash_chunk_kernel<kRmat><<<blocks, sheep::kThreads, 0, s>>>(
        k, levels, lo0, hi0, (int64_t)count, (int64_t)pad_to, (int32_t)n,
        p0, p1, p2, (int2*)out);
  else
    hash_chunk_kernel<kSbm><<<blocks, sheep::kThreads, 0, s>>>(
        k, levels, lo0, hi0, (int64_t)count, (int64_t)pad_to, (int32_t)n,
        p0, p1, p2, (int2*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
