// K2 and K3: the 2-D int32 gathers of the Mosaic lowering probes.
//
// K2 take_rows: out[b, :] = t[clip(idx[b], 0, R - 1), :] on a row-major
// int32 (R, W) table. Replaces form A of try_form (the pl.pallas_call at
// tools/pallas_smoke.py:166; the form at :206-214, jnp.take(axis=0,
// mode="clip") on a VMEM-staged (4096, 128) table).
//
// K3 take_along: out[r, c] = x[clip(idx[r, c] >> shift), c] (axis 0) or
// x[r, clip(idx[r, c] >> shift)] (axis 1), the clip to the gathered axis.
// Replaces forms B, C and E of try_form (:216-238, :269-287), the form-E
// kernel of _perf2 (pl.pallas_call at :336, shift = 7) and the lane gather
// of _probe_width (pl.pallas_call at :420).
//
// Bound: both move int32 values and compute nothing, so they are bound by
// bytes. K2 reads idx once, each distinct selected row once, and writes
// each output row once: 4*B + 4*B*W + 4*D*W bytes for D distinct rows.
// K3 reads idx once, writes out once and reads each table element the
// lookups reach once: 8*N + 4*D bytes for D distinct elements (at most
// min(N, |x|)).
//
// Design. The TPU kernels stage the whole table in VMEM (megabytes) and
// gather from there with the vector unit's sublane/lane shuffles. Hopper
// has a 50 MB L2 in front of its memory, so the kernels read the table
// through the read-only path (__ldg) and let L2 hold what is reused:
//  - K2 gives one warp to each 128-element segment of an output row: the
//    row index is read once for the warp, and the segment moves as one
//    16-byte load and store a lane (W % 4 == 0 and 16-byte aligned
//    pointers) or as four coalesced 4-byte ones otherwise.
//  - K3 on axis 0 puts neighbouring threads on neighbouring columns, so
//    each warp's reads of one table row fall into the same 128-byte lines.
//  - K3 on axis 1 (the TPU's VMEM lane gather) puts neighbouring threads
//    on neighbouring outputs of one row: idx and out move coalesced, and
//    the random reads stay within the row, which L2 holds. Staging the row
//    in shared memory, the literal counterpart of VMEM, was slower at every
//    width from 128 to 57,344 int32 on an H100 (each block of a wide row
//    stages all of it), so there is no staged path.
//
// Bound to PyTorch through plain C functions loaded with ctypes: the
// caller passes device pointers and its CUDA stream, and gets back
// cudaGetLastError() of the launch, so a refused launch is an error and
// never a silent no-op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 128;  // K2: elements of a row segment a warp moves

__device__ __forceinline__ int32_t clip(int32_t j, int32_t last) {
  return j < 0 ? 0 : (j > last ? last : j);
}

template <bool kVec>
__global__ void take_rows_kernel(const int32_t* __restrict__ t, int32_t last,
                                 int64_t w, const int32_t* __restrict__ idx,
                                 int32_t* __restrict__ out, int64_t b,
                                 int64_t nseg) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t units = b * nseg;
  for (int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       u < units; u += warps) {
    const int64_t row = u / nseg;
    const int64_t c0 = (u - row * nseg) * kSeg;
    const int32_t* src = t + (int64_t)clip(idx[row], last) * w;
    int32_t* dst = out + row * w;
    if (kVec) {
      const int64_t c = c0 + 4 * lane;
      if (c < w) {
        *reinterpret_cast<int4*>(dst + c) =
            __ldg(reinterpret_cast<const int4*>(src + c));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSeg / 32; ++k) {
        const int64_t c = c0 + lane + 32 * k;
        if (c < w) dst[c] = __ldg(src + c);
      }
    }
  }
}

__global__ void take_along0_kernel(const int32_t* __restrict__ x,
                                   int32_t last, int64_t cols,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int64_t n,
                                   int shift) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t c = e % cols;
    out[e] = __ldg(x + (int64_t)clip(idx[e] >> shift, last) * cols + c);
  }
}

__global__ void take_along1_kernel(const int32_t* __restrict__ x, int64_t wx,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int64_t wi,
                                   int64_t n, int shift) {
  const int32_t last = (int32_t)(wx - 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t r = e / wi;
    out[e] = __ldg(x + r * wx + clip(idx[e] >> shift, last));
  }
}

// The blocks the current device holds resident at once (one wave), by
// kernel; queried once per device.
struct DeviceCaps {
  int dev = -1;
  long long wave_rows = 0;
  long long wave_along0 = 0;
  long long wave_along1 = 0;
};

cudaError_t caps(DeviceCaps** out) {
  static DeviceCaps c;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != c.dev) {
    int sms = 0, a = 0, b = 0, d = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &a, take_rows_kernel<true>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, take_along0_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d, take_along1_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    c.wave_rows = (long long)sms * (a > 0 ? a : 1);
    c.wave_along0 = (long long)sms * (b > 0 ? b : 1);
    c.wave_along1 = (long long)sms * (d > 0 ? d : 1);
    c.dev = dev;
  }
  *out = &c;
  return cudaSuccess;
}

long long grid_for(long long threads_needed, long long wave) {
  long long blocks = (threads_needed + kThreads - 1) / kThreads;
  return blocks > wave ? wave : blocks;
}

}  // namespace

// K2. t is (rows, w), idx (b,), out (b, w); all int32, contiguous.
extern "C" int sheep_take_rows(const void* t, long long rows, long long w,
                               const void* idx, void* out, long long b,
                               void* stream) {
  if (b <= 0 || w <= 0) return 0;
  if (rows <= 0 || rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  DeviceCaps* c = nullptr;
  cudaError_t err = caps(&c);
  if (err != cudaSuccess) return (int)err;
  const long long nseg = (w + kSeg - 1) / kSeg;
  const long long blocks = grid_for(b * nseg * 32, c->wave_rows);
  const bool vec = (w % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(t) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    take_rows_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)t, (int32_t)(rows - 1), w, (const int32_t*)idx,
        (int32_t*)out, b, nseg);
  } else {
    take_rows_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)t, (int32_t)(rows - 1), w, (const int32_t*)idx,
        (int32_t*)out, b, nseg);
  }
  return (int)cudaGetLastError();
}

// K3. x is (xr, xc), idx and out are (ir, ic); on axis 0 ic == xc, on
// axis 1 ir == xr.
extern "C" int sheep_take_along(const void* x, long long xr, long long xc,
                                const void* idx, void* out, long long ir,
                                long long ic, int axis, int shift,
                                void* stream) {
  const long long n = ir * ic;
  if (n <= 0) return 0;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  const long long extent = axis == 0 ? xr : xc;
  if (extent <= 0 || extent > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  DeviceCaps* c = nullptr;
  cudaError_t err = caps(&c);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* xp = (const int32_t*)x;
  const int32_t* ip = (const int32_t*)idx;
  int32_t* op = (int32_t*)out;
  if (axis == 0) {
    take_along0_kernel<<<(unsigned)grid_for(n, c->wave_along0), kThreads, 0,
                         s>>>(xp, (int32_t)(xr - 1), xc, ip, op, n, shift);
  } else {
    take_along1_kernel<<<(unsigned)grid_for(n, c->wave_along1), kThreads, 0,
                         s>>>(xp, xc, ip, op, ic, n, shift);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_gather2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
