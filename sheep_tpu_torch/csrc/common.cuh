// What the port's CUDA sources share: the block size, small device
// helpers, the one-wave grid size, and the layout of a batched fixpoint
// execution's state and of a round's control word (ops/fixpoint.py and
// ops/lift.py hold the same layouts on the Python side).
//
// Execution state ex (int64): [kRow] the row of the [N, C] blocks being
// folded; [kRounds] rounds counted; [kRetired] slots retired; depth and
// live-slot sums and maxima; [kStop] set once the row passes N - 1 or the
// round budget is spent; from [kLog] on, (depth, live) of each counted
// round. end_round, run by the last block of the round's last kernel
// (climb_tail, csrc/lift.cu), is its only writer. A kernel of a round
// given ex returns at once when kStop is set, and a kernel that reads a
// row of the blocks offsets its pointers by ex[kRow] rows. Stream order
// makes end_round's writes visible to the next round's kernels.
//
// Control word ctl (int32[5]) of one round: [kCtlRows] the stack rows in
// use (depth d less one), [kCtlChanged], [kCtlRetired], [kCtlLive], and
// [kCtlTickets], the blocks of climb_tail that have finished (csrc/lift.cu
// writes it; zeroed with the rest at the start of each round).

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

enum : int {
  kCtlRows = 0,
  kCtlChanged = 1,
  kCtlRetired = 2,
  kCtlLive = 3,
  kCtlTickets = 4,
  kCtlWords = 5,
};

__device__ __forceinline__ bool stopped(const int64_t* ex) {
  return ex != nullptr && ex[kStop] != 0;
}

// elements to skip to reach the execution's row of a block whose rows
// are `stride` elements apart (0 without an execution or for a 1-D input)
__device__ __forceinline__ int64_t row_offset(const int64_t* ex,
                                              int64_t stride) {
  return ex != nullptr ? ex[kRow] * stride : 0;
}

__device__ __forceinline__ int32_t volatile_load(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

// The end of a round of an execution over N rows with a budget of
// `budget` rounds (the loop body of batch_segment_fixpoint and its cond,
// sheep_tpu/ops/elim.py:463-484): log (depth, live), add the retired
// count, move to the next row when the round changed nothing, stop once
// the row passes N - 1 or the budget is spent. One thread, after every
// write of the round to ctl is visible to it; nothing once stopped. Every
// word is loaded before the first store, so the loads go out together.
__device__ __forceinline__ void end_round(const int32_t* ctl, int64_t* ex,
                                          int64_t N, int64_t budget) {
  const int64_t stop = ex[kStop], r = ex[kRounds], row = ex[kRow];
  const int64_t retired = ex[kRetired], depth_sum = ex[kDepthSum],
                depth_max = ex[kDepthMax], live_sum = ex[kLiveSum],
                live_max = ex[kLiveMax];
  const int64_t depth = (int64_t)volatile_load(ctl + kCtlRows) + 1;
  const int32_t changed = volatile_load(ctl + kCtlChanged);
  const int64_t ret = volatile_load(ctl + kCtlRetired);
  const int64_t live = volatile_load(ctl + kCtlLive);
  if (stop) return;
  const int64_t next = row + (changed ? 0 : 1);
  ex[kLog + 2 * r] = depth;
  ex[kLog + 2 * r + 1] = live;
  ex[kRounds] = r + 1;
  ex[kRetired] = retired + ret;
  ex[kDepthSum] = depth_sum + depth;
  ex[kDepthMax] = depth > depth_max ? depth : depth_max;
  ex[kLiveSum] = live_sum + live;
  ex[kLiveMax] = live > live_max ? live : live_max;
  ex[kRow] = next;
  ex[kStop] = next >= N || r + 1 >= budget;
}

// atomicAdd(p, 1) with acquire-release order at device scope: the
// caller's earlier writes are visible to whoever later reads the count
// it leaves, and the writes of whoever left the count it reads are
// visible to the caller
__device__ __forceinline__ unsigned ticket(int32_t* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
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

// blocks of `threads` (kThreads unless given) for `work` items, capped at
// one wave: the blocks the card holds resident for `kernel`, queried once
// per device
struct Wave {
  int dev = -1;
  long long cap = 0;
};

template <typename Kernel>
cudaError_t wave_blocks(Wave& w, Kernel kernel, long long work,
                        unsigned* blocks, int threads = kThreads) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != w.dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    w.cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    w.dev = dev;
  }
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  *blocks = (unsigned)(b < w.cap ? b : w.cap);
  return cudaSuccess;
}

}  // namespace sheep
