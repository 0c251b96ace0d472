// compact_live: the live-pair compaction of the adaptive fixpoint driver,
// the counterpart of compact_actives(..., dedup=True)
// (sheep_tpu/ops/elim.py:1055), its two-key sort included.
//
// Input: the round's (lo, hi) pairs, int32, both in [0, n]. Output:
// out_lo, out_hi [size]: the pairs that are live (lo != n) and the first
// of their run of equal pairs, in ascending (lo, hi) order, then (n, n) up
// to size. A pair past size is dropped, as jnp.nonzero(..., size=size)
// drops it; the driver sizes size above the live count.
//
// The sort: each pair packed into one key lo << b | hi, b the bits of n,
// and the keys sorted alone (no permutation) by cub's radix sort over
// their 2b bits, where the JAX package's lax.sort orders (lo, hi) as two
// keys. The compaction after it: a two-pass stream compaction in three
// launches: count the kept keys of each tile of kTile keys (a block a
// tile), an exclusive scan of the tiles' counts in one block (the total
// after the last), then each block scatters its tile's kept pairs to
// their offsets (a warp ballot and __popc for the rank in the warp, the
// warps' counts in shared memory) and the blocks together fill
// [total, size) with n.
//
// Bound by bytes: the pairs read (8 B a pair) and the outputs written (8 B
// a slot of size). The sort's passes (8 bits a pass, each reading and
// writing the keys) and the counting pass's second read of the keys come
// on top; on the driver's shapes (C <= 2^22, 32 MB of keys) L2 holds much
// of them.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers, the scratch it allocated and its CUDA
// stream, and gets back the first CUDA error of the launches (0 if none).

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace sheep;

constexpr int kItems = 8;                     // keys a thread
constexpr int64_t kTile = kThreads * kItems;  // keys a block

__global__ void __launch_bounds__(kThreads)
compact_pack(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
             int64_t m, int b, uint64_t* __restrict__ key) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step)
    key[i] = ((uint64_t)(uint32_t)lo[i] << b) | (uint32_t)hi[i];
}

__device__ __forceinline__ bool kept(const uint64_t* __restrict__ key,
                                     int64_t i, int64_t m, int32_t n,
                                     int b) {
  if (i >= m) return false;
  const uint64_t k = key[i];
  if ((int32_t)(k >> b) == n) return false;  // dead (n, n)
  return i == 0 || key[i - 1] != k;
}

__global__ void __launch_bounds__(kThreads)
compact_count(const uint64_t* __restrict__ key, int64_t m, int32_t n,
              int b, int32_t* __restrict__ counts) {
  __shared__ int smem[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    c += kept(key, base + it * kThreads + threadIdx.x, m, n, b);
  c = block_sum(c, smem);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// exclusive scan of counts[0 .. tiles) in place, the total to
// counts[tiles]; one block
__global__ void __launch_bounds__(kThreads)
compact_scan(int32_t* counts, int64_t tiles) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < tiles; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const int x = i < tiles ? counts[i] : 0;
    int incl = x;  // inclusive scan in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      if (w < warp) before += s;
      chunk += s;
    }
    if (i < tiles) counts[i] = before + incl - x;
    __syncthreads();  // every thread has read carry and warp_sum
    if (threadIdx.x == 0) carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[tiles] = carry;
}

__global__ void __launch_bounds__(kThreads)
compact_scatter(const uint64_t* __restrict__ key, int64_t m, int32_t n,
                int b, const int32_t* __restrict__ offsets, int64_t tiles,
                int32_t* __restrict__ out_lo, int32_t* __restrict__ out_hi,
                int64_t size) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x < tiles) {
    const int64_t base = (int64_t)blockIdx.x * kTile;
    int64_t run = offsets[blockIdx.x];
    for (int it = 0; it < kItems; ++it) {
      const int64_t i = base + it * kThreads + threadIdx.x;
      const bool k = kept(key, i, m, n, b);
      const unsigned votes = __ballot_sync(0xffffffffu, k);
      if (lane == 0) warp_count[warp] = __popc(votes);
      __syncthreads();
      int before = 0, all = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_count[w];
        if (w < warp) before += c;
        all += c;
      }
      const int64_t at = run + before + __popc(votes & ((1u << lane) - 1u));
      if (k && at < size) {
        const uint64_t v = key[i];
        out_lo[at] = (int32_t)(v >> b);
        out_hi[at] = (int32_t)(v & ((1ull << b) - 1ull));
      }
      run += all;
      __syncthreads();  // every warp has read warp_count
    }
  }
  const int64_t total = offsets[tiles];
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = total + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < size; j += step) {
    out_lo[j] = n;
    out_hi[j] = n;
  }
}

}  // namespace

// The keys of tile t are key[t * kTile .. (t + 1) * kTile); scratch holds
// tiles + 1 int32 (the wrapper allocates it: tiles = ceil(m / kTile)).
extern "C" long long sheep_compact_tile() { return kTile; }

// The bytes of cub's temporary storage for sorting m keys of `bits` bits
// into *bytes.
extern "C" int sheep_compact_sort_bytes(long long m, int bits,
                                        unsigned long long* bytes) {
  if (m < 0 || m > 0x7FFFFFFFLL || bits < 1 || bits > 64)
    return (int)cudaErrorInvalidValue;
  size_t t = 0;
  cudaError_t err = cub::DeviceRadixSort::SortKeys(
      nullptr, t, (const uint64_t*)nullptr, (uint64_t*)nullptr, (int)m, 0,
      bits);
  *bytes = t;
  return (int)err;
}

// key [m] <- the pairs (lo, hi) packed as lo << b | hi, ascending; tmp
// [m] uint64 holds the packed keys before the sort, temp the sort's
// storage (temp_bytes from sheep_compact_sort_bytes(m, 2 b)).
extern "C" int sheep_compact_sort(const void* lo, const void* hi,
                                  long long m, int b, void* tmp, void* key,
                                  void* temp, unsigned long long temp_bytes,
                                  void* stream) {
  if (m < 0 || m > 0x7FFFFFFFLL || b < 1 || b > 31)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  compact_pack<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)lo, (const int32_t*)hi, m, b, (uint64_t*)tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t t = temp_bytes;
  err = cub::DeviceRadixSort::SortKeys(temp, t, (const uint64_t*)tmp,
                                       (uint64_t*)key, (int)m, 0, 2 * b, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out_lo/out_hi [size] <- the live first-of-run pairs of the m ascending
// keys lo << b | hi, then (n, n); scratch int32[ceil(m / kTile) + 1].
extern "C" int sheep_compact_live(const void* key, long long m, int n, int b,
                                  void* scratch, void* out_lo, void* out_hi,
                                  long long size, void* stream) {
  if (m < 0 || size < 0 || m > 0x7FFFFFFFLL || n < 0 || b < 1 || b > 31)
    return (int)cudaErrorInvalidValue;
  if (size == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (m + kTile - 1) / kTile;
  int32_t* counts = (int32_t*)scratch;
  const uint64_t* k = (const uint64_t*)key;
  if (tiles > 0) {
    compact_count<<<(unsigned)tiles, kThreads, 0, s>>>(k, m, n, b, counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  compact_scan<<<1, kThreads, 0, s>>>(counts, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a block a tile, and enough blocks to fill size at one slot a thread
  // when the tiles are fewer
  long long blocks = (size + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < tiles) blocks = tiles;
  compact_scatter<<<(unsigned)blocks, kThreads, 0, s>>>(
      k, m, n, b, counts, tiles, (int32_t*)out_lo, (int32_t*)out_hi, size);
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
