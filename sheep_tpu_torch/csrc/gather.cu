// K1: clip-mode int32 gather, out[i] = table[min(max(idx[i], 0), T - 1)].
//
// Replaces the Pallas kernel sheep_tpu/ops/pallas_gather.py vmem_gather
// (pl.pallas_call at :70). That kernel stages the whole table in TPU VMEM
// as one block and blocks idx over a sequential grid. On Hopper the
// counterpart of VMEM residency is the 50 MB L2: a table of 4*(n+1) bytes
// (16.8 MB at RMAT-22) fits it, so one launch's random table reads hit
// L2 once the table is in, and they go through the read-only path
// (__ldg). Only the table of the current launch can be resident: a round
// of the exact descent keeps 23 such tables (386 MB at RMAT-22). Staging
// the table in shared memory would fit only tables of <= ~56K entries
// (227 KB), so it is not done here.
//
// Bound: the kernel streams idx in and out back, each once, plus the
// table once: 8*M + 4*T bytes of device memory. At M = 2^23 and
// T = 2^22 + 1 that is 84 MB, 25 us at 3.35 TB/s. It does no arithmetic
// worth counting, so it is bound by bytes. Its design: a grid-stride loop
// over M, neighbouring threads on neighbouring idx/out elements
// (coalesced), the ragged tail masked by the loop bound.
//
// In a batched fixpoint execution (csrc/common.cuh) the kernel is
// given the execution's state: it returns at once when the execution has
// stopped, and with a row stride it reads idx from the execution's row of
// an [N, C] block (the read of P before the round's scatter).
//
// Bound to PyTorch through a plain C function (loaded with ctypes): the
// caller passes device pointers and its CUDA stream, and gets back
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void gather_clip_kernel(const int32_t* __restrict__ table,
                                   int32_t last,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out,
                                   int64_t m, const int64_t* ex,
                                   int64_t row_stride) {
  if (sheep::stopped(ex)) return;
  idx += sheep::row_offset(ex, row_stride);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    int32_t j = idx[i];
    j = j < 0 ? 0 : (j > last ? last : j);
    out[i] = __ldg(table + j);
  }
}

}  // namespace

// ex: the execution's state or null; row_stride: the block's row length
// when idx is an [N, C] block, else 0.
extern "C" int sheep_gather_clip(const void* table, long long table_len,
                                 const void* idx, void* out, long long m,
                                 const void* ex, long long row_stride,
                                 void* stream) {
  if (m <= 0) return 0;
  if (table_len <= 0 || table_len > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // one wave: the grid is capped at the blocks the card holds resident
  // (8 per SM on an H100 at 256 threads)
  static sheep::Wave wave;
  unsigned blocks = 0;
  cudaError_t err = sheep::wave_blocks(wave, gather_clip_kernel, m, &blocks);
  if (err != cudaSuccess) return (int)err;
  gather_clip_kernel<<<blocks, sheep::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (int32_t)(table_len - 1), (const int32_t*)idx,
      (int32_t*)out, (int64_t)m, (const int64_t*)ex, (int64_t)row_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
