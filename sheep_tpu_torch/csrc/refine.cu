// The refinement's device programs (B11), the counterparts of the XLA
// programs of sheep_tpu/ops/refine.py:
//
//   neighbor_hist   neighbor_hist_chunk (:42) and neighbor_hist_block (:63)
//   hist_stats      hist_stats (:83)
//   plan_moves      plan_moves (:100)
//
// neighbor_hist: for each valid edge (u, v) of a (C, 2) int32 chunk (both
// ends in [0, n), u != v), hist[u, assign[v]] += 1 and hist[v, assign[u]]
// += 1 by int32 atomics, and the chunk's (cut, total) under the same mask,
// summed in the block and added once a block to two 64-bit counters.
// Blocked mode (a template argument) keeps only the rows [base, base + vb)
// of a (vb, k) buffer. The reference sends every invalid edge (padding,
// self-loops) to the sentinel row n (vb in blocked mode, or the row of
// vertex n when it lies in the block); on the card that many atomics on one
// address serialize, and the row is never read (the planner and the move
// accounting skip vid == n, the cut comes from the counters). So the kernel
// drops invalid edges and leaves that row as it found it. Bound by bytes:
// 8 B an edge read, the 32 B sector of each histogram cell an edge touches
// read and written back, and the assignment table (16 MiB at s22, in L2).
// Integer atomics in any order give the same counts.
//
// hist_stats: one warp a row, the row's k columns read in 32-wide strides
// (any k >= 1): best = the FIRST argmax (a lane keeps its first maximum,
// the warp's shuffle reduction prefers the smaller column on a tie, as
// jnp.argmax), bestv its value, cur = hist[r, cur_part[r]], and gain =
// bestv - cur, which the caller computes next anyway. Bound by bytes: the
// histogram read once.
//
// plan_moves: one parity half-round of capacity-capped moves. Loads: a
// bincount of assign[:n] over k in shared memory (global atomics when k
// does not fit). Keys: the i-th row of the parity is vid = 2 i + parity;
// a mover (gain > 0, vid < n) gets the 64-bit key best << 32 |
// (INT32_MAX - gain), every other row the key k << 32 | 0xFFFFFFFF, which
// sorts last. cub's stable radix SortPairs orders the keys with the vids
// as values: part ascending, gain descending, vid ascending, the order of
// the reference's stable lexsort((-gain, part_key)) restricted to the
// parity's rows, and only movers have ranks, so the accepted set is the
// same. Starts: the first sorted index of each part. Accept: rank = index
// - start, accepted while rank < max(cap - load, 0), written over a copy
// of the assignment. Bound by bytes: 16 B a row (best, gain and the
// assignment read, the new assignment written); the sort comes on top.
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

constexpr unsigned kFull = 0xffffffffu;
// loads in shared memory up to this many parts (48 KB of int32)
constexpr int kSharedParts = 12288;

template <bool kBlocked>
__global__ void __launch_bounds__(kThreads)
neighbor_hist_kernel(const int2* __restrict__ edges, int64_t m,
                     const int32_t* __restrict__ assign, int32_t n,
                     int32_t k, int64_t base, int64_t vb,
                     int32_t* __restrict__ hist,
                     unsigned long long* __restrict__ counts) {
  __shared__ int smem[kWarps];
  int cut = 0, total = 0;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const int2 e = edges[i];
    const int32_t u = e.x, v = e.y;
    if (u < 0 || u >= n || v < 0 || v >= n || u == v) continue;
    const int32_t pu = __ldg(assign + u), pv = __ldg(assign + v);
    cut += pu != pv;
    total += 1;
    if (kBlocked) {
      const int64_t lu = (int64_t)u - base, lv = (int64_t)v - base;
      if (lu >= 0 && lu < vb) atomicAdd(hist + lu * k + pv, 1);
      if (lv >= 0 && lv < vb) atomicAdd(hist + lv * k + pu, 1);
    } else {
      atomicAdd(hist + (int64_t)u * k + pv, 1);
      atomicAdd(hist + (int64_t)v * k + pu, 1);
    }
  }
  if (counts != nullptr) {
    const int c = block_sum(cut, smem);
    __syncthreads();  // thread 0 has read smem before it is reused
    const int t = block_sum(total, smem);
    if (threadIdx.x == 0) {
      atomicAdd(counts, (unsigned long long)c);
      atomicAdd(counts + 1, (unsigned long long)t);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hist_stats_kernel(const int32_t* __restrict__ hist, int64_t rows, int32_t k,
                  const int32_t* __restrict__ cur_part,
                  int32_t* __restrict__ best, int32_t* __restrict__ bestv,
                  int32_t* __restrict__ cur, int32_t* __restrict__ gain) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < rows; r += warps) {
    const int32_t* row = hist + r * k;
    // a lane without a column holds the index k, which loses every tie
    int32_t bv = INT32_MIN, bi = k;
    if (lane < k) {
      bv = row[lane];
      bi = lane;
    }
    for (int32_t j = lane + 32; j < k; j += 32) {
      const int32_t x = row[j];
      if (x > bv) {
        bv = x;
        bi = j;
      }
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int32_t ov = __shfl_xor_sync(kFull, bv, d);
      const int32_t oi = __shfl_xor_sync(kFull, bi, d);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      const int32_t c = row[clip(cur_part[r], k - 1)];
      best[r] = bi;
      bestv[r] = bv;
      cur[r] = c;
      gain[r] = bv - c;
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
plan_loads(const int32_t* __restrict__ assign, int64_t n, int32_t k,
           int32_t* __restrict__ loads) {
  extern __shared__ int32_t part_count[];
  if (kShared) {
    for (int32_t j = threadIdx.x; j < k; j += blockDim.x) part_count[j] = 0;
    __syncthreads();
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int32_t p = assign[i];
    if (p < 0 || p >= k) continue;  // the reference's mode="drop"
    atomicAdd(kShared ? part_count + p : loads + p, 1);
  }
  if (kShared) {
    __syncthreads();
    for (int32_t j = threadIdx.x; j < k; j += blockDim.x)
      if (part_count[j]) atomicAdd(loads + j, part_count[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
plan_keys(const int32_t* __restrict__ best, const int32_t* __restrict__ gain,
          int64_t n, int32_t k, int parity, int64_t half,
          uint64_t* __restrict__ keys, int32_t* __restrict__ vids) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < half;
       i += step) {
    const int64_t vid = 2 * i + parity;
    uint64_t key = ((uint64_t)(uint32_t)k << 32) | 0xffffffffull;
    if (vid < n) {
      const int32_t g = gain[vid];
      if (g > 0)
        key = ((uint64_t)(uint32_t)best[vid] << 32) |
              (uint32_t)(INT32_MAX - g);
    }
    keys[i] = key;
    vids[i] = (int32_t)vid;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_starts(const uint64_t* __restrict__ keys, int64_t m, int32_t k,
            int32_t* __restrict__ starts) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const uint32_t p = (uint32_t)(keys[i] >> 32);
    if (p >= (uint32_t)k) continue;
    if (i == 0 || (uint32_t)(keys[i - 1] >> 32) != p)
      starts[p] = (int32_t)i;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_accept(const uint64_t* __restrict__ keys,
            const int32_t* __restrict__ vids, int64_t m, int32_t k,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ loads, int32_t cap,
            int32_t* __restrict__ out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const uint32_t p = (uint32_t)(keys[i] >> 32);
    if (p >= (uint32_t)k) continue;
    const int32_t room = cap - loads[p];
    const int64_t head = room > 0 ? room : 0;
    if (i - starts[p] < head) out[vids[i]] = (int32_t)p;
  }
}

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

Wave hist_full_wave, hist_block_wave, stats_wave, loads_shared_wave,
    loads_global_wave, keys_wave, starts_wave, accept_wave;

}  // namespace

// hist [rows, k] += the chunk's edges [m, 2] (rows = n + 1, or vb in
// blocked mode with rows [base, base + vb) kept); counts [2] (uint64, may
// be null) += (cut, total) of the chunk.
extern "C" int sheep_refine_hist(const void* edges, long long m,
                                 const void* assign, int n, int k,
                                 int blocked, long long base, long long vb,
                                 void* hist, void* counts, void* stream) {
  if (m < 0 || n < 0 || k < 1 || (blocked && vb < 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = 0;
  cudaError_t err;
  if (blocked) {
    err = wave_blocks(hist_block_wave, neighbor_hist_kernel<true>, m,
                      &blocks);
    if (err != cudaSuccess) return (int)err;
    neighbor_hist_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const int2*)edges, m, (const int32_t*)assign, n, k, base, vb,
        (int32_t*)hist, (unsigned long long*)counts);
  } else {
    err = wave_blocks(hist_full_wave, neighbor_hist_kernel<false>, m,
                      &blocks);
    if (err != cudaSuccess) return (int)err;
    neighbor_hist_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int2*)edges, m, (const int32_t*)assign, n, k, 0, 0,
        (int32_t*)hist, (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

// best, bestv, cur, gain [rows] <- the stats of hist [rows, k] at the
// current parts cur_part [rows].
extern "C" int sheep_refine_stats(const void* hist, long long rows, int k,
                                  const void* cur_part, void* best,
                                  void* bestv, void* cur, void* gain,
                                  void* stream) {
  if (rows < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  unsigned blocks = 0;
  cudaError_t err = wave_blocks(stats_wave, hist_stats_kernel, rows * 32,
                                &blocks);
  if (err != cudaSuccess) return (int)err;
  hist_stats_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hist, rows, k, (const int32_t*)cur_part,
      (int32_t*)best, (int32_t*)bestv, (int32_t*)cur, (int32_t*)gain);
  return (int)cudaGetLastError();
}

// The rows of a parity half-round, ceil(n / 2) rounded for either parity.
extern "C" long long sheep_refine_plan_rows(long long n) {
  return (n + 1) / 2;
}

// The bytes of cub's temporary storage for plan_moves at n rows, k parts.
extern "C" int sheep_refine_plan_bytes(long long n, int k,
                                       unsigned long long* bytes) {
  if (n < 0 || n > 0x7FFFFFFFLL || k < 1) return (int)cudaErrorInvalidValue;
  size_t t = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, t, (const uint64_t*)nullptr, (uint64_t*)nullptr,
      (const int32_t*)nullptr, (int32_t*)nullptr,
      (int)sheep_refine_plan_rows(n), 0, 32 + bit_length(k));
  *bytes = t;
  return (int)err;
}

// out [n + 1] <- assign [n + 1] with the accepted movers of the parity
// moved to their best part. Scratch: loads int32 [k], starts int32 [k],
// keys_in/keys_out uint64 [rows], vids_in/vids_out int32 [rows] (rows =
// sheep_refine_plan_rows(n)), temp of sheep_refine_plan_bytes bytes.
extern "C" int sheep_refine_plan(const void* best, const void* gain,
                                 const void* assign, int n, int k, int cap,
                                 int parity, void* loads, void* starts,
                                 void* keys_in, void* keys_out,
                                 void* vids_in, void* vids_out, void* temp,
                                 unsigned long long temp_bytes, void* out,
                                 void* stream) {
  if (n < 0 || k < 1 || (parity != 0 && parity != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = sheep_refine_plan_rows(n);
  cudaError_t err = cudaMemcpyAsync(out, assign, (size_t)(n + 1) * 4,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  err = cudaMemsetAsync(loads, 0, (size_t)k * 4, s);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = 0;
  if (n > 0) {
    if (k <= kSharedParts) {
      err = wave_blocks(loads_shared_wave, plan_loads<true>, n, &blocks);
      if (err != cudaSuccess) return (int)err;
      plan_loads<true><<<blocks, kThreads, (size_t)k * 4, s>>>(
          (const int32_t*)assign, n, k, (int32_t*)loads);
    } else {
      err = wave_blocks(loads_global_wave, plan_loads<false>, n, &blocks);
      if (err != cudaSuccess) return (int)err;
      plan_loads<false><<<blocks, kThreads, 0, s>>>(
          (const int32_t*)assign, n, k, (int32_t*)loads);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = wave_blocks(keys_wave, plan_keys, rows, &blocks);
  if (err != cudaSuccess) return (int)err;
  plan_keys<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)best, (const int32_t*)gain, n, k, parity, rows,
      (uint64_t*)keys_in, (int32_t*)vids_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t t = temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(
      temp, t, (const uint64_t*)keys_in, (uint64_t*)keys_out,
      (const int32_t*)vids_in, (int32_t*)vids_out, (int)rows, 0,
      32 + bit_length(k), s);
  if (err != cudaSuccess) return (int)err;
  err = wave_blocks(starts_wave, plan_starts, rows, &blocks);
  if (err != cudaSuccess) return (int)err;
  plan_starts<<<blocks, kThreads, 0, s>>>((const uint64_t*)keys_out, rows, k,
                                          (int32_t*)starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = wave_blocks(accept_wave, plan_accept, rows, &blocks);
  if (err != cudaSuccess) return (int)err;
  plan_accept<<<blocks, kThreads, 0, s>>>(
      (const uint64_t*)keys_out, (const int32_t*)vids_out, rows, k,
      (const int32_t*)starts, (const int32_t*)loads, cap, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The sort alone, as sheep_refine_plan runs it, for timing it apart: the
// keys and vids in keys_in/vids_in sorted into keys_out/vids_out.
extern "C" int sheep_refine_plan_sort(long long n, int k, void* keys_in,
                                      void* keys_out, void* vids_in,
                                      void* vids_out, void* temp,
                                      unsigned long long temp_bytes,
                                      void* stream) {
  if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
  const long long rows = sheep_refine_plan_rows(n);
  if (rows == 0) return 0;
  size_t t = temp_bytes;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, t, (const uint64_t*)keys_in, (uint64_t*)keys_out,
      (const int32_t*)vids_in, (int32_t*)vids_out, (int)rows, 0,
      32 + bit_length(k), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_refine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
