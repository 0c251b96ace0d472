// What the port's CUDA sources share: the block size, small device
// helpers, the one-wave grid size, and the layout of a batched fixpoint
// execution's state and of a round's control word (ops/fixpoint.py and
// ops/lift.py hold the same layouts on the Python side).
//
// Execution state ex (int64): [kRow] the row of the [N, C] blocks being
// folded; [kRounds] rounds counted; [kRetired] slots retired; depth and
// live-slot sums and maxima; [kStop] set once the row passes N - 1 or the
// round budget is spent; from [kLog] on, (depth, live) of each counted
// round. round_end (csrc/fixpoint.cu) is its only writer. A kernel of a
// round given ex returns at once when kStop is set, and a kernel that
// reads a row of the blocks offsets its pointers by ex[kRow] rows. Stream
// order makes round_end's writes visible to the next round's kernels.
//
// Control word ctl (int32[4]) of one round: [kCtlRows] the stack rows in
// use (depth d less one), [kCtlChanged], [kCtlRetired], [kCtlLive]
// (csrc/lift.cu writes it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sheep {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum : int {
  kRow = 0,
  kRounds = 1,
  kRetired = 2,
  kDepthSum = 3,
  kDepthMax = 4,
  kLiveSum = 5,
  kLiveMax = 6,
  kStop = 7,
  kLog = 8,
};

enum : int { kCtlRows = 0, kCtlChanged = 1, kCtlRetired = 2, kCtlLive = 3 };

__device__ __forceinline__ bool stopped(const int64_t* ex) {
  return ex != nullptr && ex[kStop] != 0;
}

// elements to skip to reach the execution's row of a block whose rows
// are `stride` elements apart (0 without an execution or for a 1-D input)
__device__ __forceinline__ int64_t row_offset(const int64_t* ex,
                                              int64_t stride) {
  return ex != nullptr ? ex[kRow] * stride : 0;
}

__device__ __forceinline__ int32_t clip(int32_t x, int32_t last) {
  return x < 0 ? 0 : (x > last ? last : x);
}

// sum over a block of kThreads into thread 0's return value
__device__ __forceinline__ int block_sum(int x, int* smem) {
  x = __reduce_add_sync(0xffffffffu, x);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) smem[warp] = x;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += smem[w];
  return s;
}

// blocks of kThreads for `work` items, capped at one wave: the blocks the
// card holds resident for `kernel`, queried once per device
struct Wave {
  int dev = -1;
  long long cap = 0;
};

template <typename Kernel>
cudaError_t wave_blocks(Wave& w, Kernel kernel, long long work,
                        unsigned* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != w.dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    w.cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    w.dev = dev;
  }
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  *blocks = (unsigned)(b < w.cap ? b : w.cap);
  return cudaSuccess;
}

}  // namespace sheep
