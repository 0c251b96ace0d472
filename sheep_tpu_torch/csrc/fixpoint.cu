// The batched fixpoint execution's own kernels (ops/fixpoint.py):
//
//   scatter_min   P[lo] <- min(P[lo], hi) over the round's slots, the
//                 counterpart of `P_.at[lo_].min(hi_, mode="drop")` in
//                 _pos_round_body (sheep_tpu/ops/elim.py:149);
//   exec_finish   the end of batch_segment_fixpoint (:486-488): the rows
//                 that converged stored all-sentinel, the live slots
//                 counted, and sv = (segments_done, rounds, live, retired)
//                 packed.
//
// The rest of the loop body of batch_segment_fixpoint (:467-484) and its
// cond (:463), which count the round, move to the next row and stop the
// execution, run in the last block of climb_tail, the round's last kernel
// (csrc/lift.cu, end_round in csrc/common.cuh).
//
// The JAX package runs an execution as one lax.while_loop whose stop
// condition lives on the device. Here the host enqueues the execution's
// whole budget of rounds and reads nothing back: the state lives in a
// small int64 tensor (csrc/common.cuh), every kernel of a round reads
// it first and returns at once once the execution has stopped, and the
// host reads the packed sv once per execution.
//
// scatter_min: a live slot (lo in [0, n)) does one int32 atomicMin whose
// value is not used, so it compiles to a fire-and-forget reduction (RED)
// and no load waits on it. A dead slot (n, n) reads lo and nothing else:
// min(P[n], n) = P[n], so skipping it is exact, and no atomics pile up on
// P[n]. A minimum does not depend on order, so the result is bit-exact.
// Bound by bytes: lo in (4 B a slot), hi at the live slots and one 32-byte
// sector of P for each distinct sector that the live slots write. On the
// main path nearly every slot is dead (a median of 7-8 live of 2^23 at
// s22), so the kernel is a stream of lo: each thread keeps kScatterUnroll
// 16-byte loads of lo in flight before it looks at any (a scalar head up
// to the row's first 16-byte boundary and a scalar tail take what the
// vectors do not), a warp with no live lane among its slots moves on at
// once, and a live lane loads all its hi values before its first atomic.
// The grid is one wave of the blocks the card holds resident. Of 1, 2, 4
// and 8 loads a thread on one wave, two waves or a thread for each group
// of quads, this one was the fastest at a median round's share and at 1%
// live, and within 1.5% of the fastest at 100% (PERF.md, section 6). The
// filter of the kernel this one replaced (the atomic only where a read of
// P[lo] is above hi) measured slower at 100% and 1% live and no faster at
// a median round's share, so it went.
//
// exec_finish streams the blocks once (each row below the final one
// written back as sentinel, the others read), bound by bytes.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers and its CUDA stream and gets back the
// first CUDA error of its launches (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace sheep;

constexpr int kScatterUnroll = 2;  // 16-byte loads of lo in flight a thread

__device__ __forceinline__ bool live_slot(int32_t l, int32_t n) {
  return (uint32_t)l < (uint32_t)n;  // dead (n, n) or out of range
}

__global__ void __launch_bounds__(kThreads)
scatter_min_kernel(int32_t* __restrict__ P, const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ hi, int64_t m, int32_t n,
                   const int64_t* ex, int64_t row_stride) {
  if (stopped(ex)) return;
  const int64_t off = row_offset(ex, row_stride);
  lo += off;
  hi += off;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  // slots before lo's first 16-byte boundary, and after its last whole
  // quad: fewer than 4 each, one slot a thread
  int64_t head = (int64_t)((0 - (uintptr_t)lo) & 15) >> 2;
  if (head > m) head = m;
  const int64_t quads = (m - head) >> 2;
  const int64_t body_end = head + 4 * quads;
  if (tid < head) {
    const int32_t l = lo[tid];
    if (live_slot(l, n)) atomicMin(P + l, hi[tid]);
  }
  if (tid < m - body_end) {
    const int32_t l = lo[body_end + tid];
    if (live_slot(l, n)) atomicMin(P + l, hi[body_end + tid]);
  }
  const int4* lo4 = reinterpret_cast<const int4*>(lo + head);
  const int32_t* hi_b = hi + head;
  // the loop bound is the warp's, so every lane takes every turn and the
  // vote below sees the whole warp
  const int64_t lane = threadIdx.x & 31;
  for (int64_t base = tid - lane; base < quads;
       base += kScatterUnroll * threads) {
    int4 v[kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int64_t q = base + u * threads + lane;
      v[u] = q < quads ? __ldg(lo4 + q) : make_int4(n, n, n, n);
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u)
      any |= live_slot(v[u].x, n) | live_slot(v[u].y, n) |
             live_slot(v[u].z, n) | live_slot(v[u].w, n);
    if (!__any_sync(0xffffffffu, any)) continue;
    if (!any) continue;
    // every hi of the lane's live slots loaded before the first atomic
    int32_t h[4 * kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int32_t* hq = hi_b + 4 * (base + u * threads + lane);
      const int32_t l[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        h[4 * u + c] = live_slot(l[c], n) ? __ldg(hq + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int32_t l[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (live_slot(l[c], n)) atomicMin(P + l[c], h[4 * u + c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
exec_finish_kernel(int32_t* loB, int32_t* hiB, int64_t total, int64_t C,
                   int32_t n, const int64_t* __restrict__ ex,
                   int32_t* sv) {
  __shared__ int smem[kWarps];
  const int64_t done = ex[kRow];
  const int64_t cleared = done * C;  // the rows that converged
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  int live = 0;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    if (e < cleared) {
      loB[e] = n;
      hiB[e] = n;
    } else {
      live += loB[e] != n;
    }
  }
  live = block_sum(live, smem);
  if (threadIdx.x == 0) {
    if (live) atomicAdd(sv + 2, live);
    if (blockIdx.x == 0) {
      sv[0] = (int32_t)done;
      sv[1] = (int32_t)ex[kRounds];
      sv[3] = (int32_t)ex[kRetired];
    }
  }
}

Wave wave_scatter, wave_finish;

}  // namespace

// P[lo[i]] <- min(P[lo[i]], hi[i]) over m slots with lo in [0, n), n =
// T - 1. ex: the execution's state or null; row_stride: the blocks' row
// length when lo and hi are [N, C] blocks, else 0.
extern "C" int sheep_scatter_min(void* P, long long T, const void* lo,
                                 const void* hi, long long m, const void* ex,
                                 long long row_stride, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  if ((uintptr_t)lo & 3) return (int)cudaErrorMisalignedAddress;
  // one thread for kScatterUnroll quads, at least one block for the head
  // and the tail, at most one wave
  const long long work = (m + 4 * kScatterUnroll - 1) / (4 * kScatterUnroll);
  unsigned blocks = 0;
  cudaError_t err =
      wave_blocks(wave_scatter, scatter_min_kernel, work, &blocks);
  if (err != cudaSuccess) return (int)err;
  scatter_min_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)P, (const int32_t*)lo, (const int32_t*)hi, m,
      (int32_t)(T - 1), (const int64_t*)ex, (int64_t)row_stride);
  return (int)cudaGetLastError();
}

// The rows below ex[kRow] of the [N, C] blocks stored all-sentinel, and
// sv (int32[4]) = (segments_done, rounds, live, retired).
extern "C" int sheep_exec_finish(void* loB, void* hiB, long long N,
                                 long long C, int n, const void* ex, void* sv,
                                 void* stream) {
  if (N <= 0 || C <= 0 || N * C > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sv, 0, 4 * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = 0;
  err = wave_blocks(wave_finish, exec_finish_kernel, N * C, &blocks);
  if (err != cudaSuccess) return (int)err;
  exec_finish_kernel<<<blocks, kThreads, 0, s>>>(
      (int32_t*)loB, (int32_t*)hiB, N * C, C, (int32_t)n,
      (const int64_t*)ex, (int32_t*)sv);
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_fixpoint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
