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
// bytes, or at small shapes by a chain: a launch, then the index load and
// the table load that depends on it. K2 reads idx once, each distinct
// selected row once, and writes each output row once: 4*B + 4*B*W +
// 4*D*W bytes for D distinct rows. K3 reads idx once, writes out once and
// reads each table element the lookups reach once: 8*N + 4*D bytes; where
// the lookups are random, each one moves a whole 32-byte L2 sector to its
// SM, and that rate, not the bytes, sets K3's time at P2's shapes.
//
// The launch plan (rows a warp, threads a block, the grid) is chosen in
// Python, as a pure function of the shapes, the pointers' alignment and
// the card's SMs (ops/gather2d.py plan_take_rows, plan_take_along); these
// functions check it against the inputs and launch it.
//
// K3. A 2-D grid: blockIdx.y (strided past 65,535) picks a tile of rows
// of idx, blockIdx.x a tile of columns within each row, in 32-bit column
// arithmetic (no division). A thread owns kUnits elements of its row,
// tpr apart, so that neighbouring threads hold neighbouring columns and
// every warp-wide load or store of idx and out is coalesced whatever the
// pointers' alignment; it loads its indices, then issues all its table
// loads, then stores. The grid covers the whole output (no grid-stride cap
// at one wave); the plan takes the largest block (at most 256 threads)
// that still gives a quarter of the SMs a block, since at small shapes the
// time is the SM's rate of scattered loads.
//
// K2. A row take is a copy of whole rows: a warp owns 2^k consecutive
// output rows (a contiguous span of out); lane j loads idx[r0 + j] and
// the warp walks the span in 16-byte units (4-byte where W % 4 != 0 or t
// or out is not 16-byte aligned), lane after lane, each unit's source row
// taken from its owner lane by a shuffle: all of a batch's loads (kBatch
// units a lane) are issued before its first store. The plan gives a lane
// at most two batches while every SM keeps 8 warps (16 rows a warp at the
// bulk case, one at P1-A). Stores stream (evict-first): out is written
// once, and the table stays in L2.
//
// Every kernel starts at griddepcontrol.wait and is launched as a
// programmatic dependent launch: its launch overlaps the tail of the
// kernel before it on the stream, and it reads nothing until that kernel
// has finished and its writes are visible. Timed in turns, 50 calls back
// to back, this overlap is most of the gain at the small shapes: launched
// without it, the kernels were 6-13% slower than the earlier grid-stride
// kernels at P1 (K2 at P1-A 0.002893 against 0.002560-0.002573 ms) and 2%
// faster at P2 (0.010826-0.010861 against 0.011029-0.011036).
//
// What lost, timed in turns on an NVIDIA H100 80GB HBM3 at 700 W
// (python -m sheep_tpu_torch.tools.gather_turns; PERF.md section 6):
//  - K3 in 16-byte units (a thread's 4 consecutive elements, one int4
//    load of idx and one int4 store, a scalar head and tail a row): slower
//    at every shape from P1 to P3 (P2 0.01092 against 0.00968 ms; P3 R =
//    32768 0.00343 against 0.00327; P1-B 0.00141 against 0.00132);
//  - K3 on axis 1 with the row staged across a thread block cluster (8
//    blocks, each bringing in its slice by a TMA bulk copy, lookups read
//    from the slice's owner through distributed shared memory): 1.9x-2.2x
//    slower than reading the row through L2 at R = 16384, 32768 and 65536
//    (0.01039 against 0.00475 ms at 32768). Staging the whole row in each
//    block's shared memory had lost before at every width;
//  - K2 through a ring of 4 shared-memory stages filled by TMA bulk copies
//    (one a row, completed on an mbarrier) and emptied by one bulk store a
//    tile: 0.0180 against 0.0154 ms at the bulk case (2^16 rows of 512 B),
//    slower at P1-A too;
//  - K3's table read at L2 only (ld.global.cg) or without allocating in
//    L1, and letting the next grid launch early (griddepcontrol.
//    launch_dependents): no gain at any shape.
//
// Bound to PyTorch through plain C functions loaded with ctypes: the
// caller passes device pointers, the plan and its CUDA stream, and gets
// back the launch's error (or cudaErrorInvalidValue for a plan that does
// not fit the inputs), so a refused launch is an error and never a silent
// no-op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the most threads a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnits = 4;  // K3: elements a thread
constexpr int kBatch = 8;  // K2: units a lane loads before it stores

__device__ __forceinline__ int32_t clip(int32_t j, int32_t last) {
  return j < 0 ? 0 : (j > last ? last : j);
}

// programmatic dependent launch: wait for the grid before this one (a
// no-op unless launched with the attribute) before the first read
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// K3. log_tpr: log2 of the threads a row tile (at most the block's)
template <int kAxis>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const int32_t* __restrict__ x, int64_t xc, int32_t last,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int64_t ir, uint32_t ic, int shift, int log_tpr) {
  wait_prior_grid();
  const uint32_t tpr = 1u << log_tpr;
  const uint32_t c0 = blockIdx.x * tpr * kUnits + (threadIdx.x & (tpr - 1));
  const int rpb = blockDim.x >> log_tpr;
  for (int64_t r = (int64_t)blockIdx.y * rpb + (threadIdx.x >> log_tpr);
       r < ir; r += (int64_t)gridDim.y * rpb) {
    const int32_t* ir_ = idx + r * (int64_t)ic;
    int32_t* or_ = out + r * (int64_t)ic;
    const int32_t* xrow = kAxis == 1 ? x + r * xc : x;
    int32_t v[kUnits];
#pragma unroll
    for (int g = 0; g < kUnits; ++g) {
      const uint32_t c = c0 + g * tpr;
      v[g] = c < ic ? __ldg(ir_ + c) : 0;
    }
#pragma unroll
    for (int g = 0; g < kUnits; ++g) {
      const uint32_t c = c0 + g * tpr;
      const int32_t j = clip(v[g] >> shift, last);
      if (c < ic)
        v[g] = __ldg(kAxis == 0 ? x + (int64_t)j * xc + c : xrow + j);
    }
#pragma unroll
    for (int g = 0; g < kUnits; ++g) {
      const uint32_t c = c0 + g * tpr;
      if (c < ic) or_[c] = v[g];
    }
  }
}

template <int kUnit>
struct VecOf;
template <>
struct VecOf<4> {
  using T = int4;
};
template <>
struct VecOf<1> {
  using T = int32_t;
};

// K2. log_rpw: log2 of the rows a warp; nq: units of kUnit elements a row
template <int kUnit>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const int32_t* __restrict__ t, int32_t last, int64_t w,
                 const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                 int64_t b, int log_rpw, uint32_t nq) {
  using V = typename VecOf<kUnit>::T;
  wait_prior_grid();
  const int lane = threadIdx.x & 31;
  const int64_t r0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                     << log_rpw;
  if (r0 >= b) return;  // the whole warp
  const int64_t left = b - r0;
  const uint32_t nr =
      left < (1 << log_rpw) ? (uint32_t)left : (1u << log_rpw);
  const int32_t mine =
      (uint32_t)lane < nr ? clip(__ldg(idx + r0 + lane), last) : 0;
  // the warp's span of out: nr rows of nq units, unit k at k * kUnit;
  // lane's unit k0 + lane is (row, q), advanced 32 units a step
  const uint32_t total = nr * nq;
  uint32_t row = (uint32_t)lane / nq, q = (uint32_t)lane % nq;
  const uint32_t r_step = 32u / nq, q_step = 32u % nq;
  int32_t* dst = out + r0 * w;
  for (uint32_t k0 = 0; k0 < total; k0 += 32u * kBatch) {
    V v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int32_t src = __shfl_sync(kFull, mine, (int)(row & 31u));
      if (k0 + 32u * i + lane < total)
        v[i] = __ldg(reinterpret_cast<const V*>(t + (int64_t)src * w +
                                                (int64_t)q * kUnit));
      q += q_step;
      row += r_step;
      if (q >= nq) {
        q -= nq;
        ++row;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const uint32_t k = k0 + 32u * i + lane;
      if (k < total)
        __stcs(reinterpret_cast<V*>(dst + (int64_t)k * kUnit), v[i]);
    }
  }
}

__global__ void empty_kernel() { wait_prior_grid(); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one launch on the caller's stream, as a programmatic dependent launch
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), dim3 grid, unsigned threads,
                   cudaStream_t s, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K2. t is (rows, w), idx (b,), out (b, w); all int32, contiguous. vec 1:
// 16-byte units (w % 4 == 0, t and out 16-byte aligned); log_rows: log2 of
// the rows a warp; threads: a block's (a multiple of 32); blocks: the grid.
extern "C" int sheep_take_rows(const void* t, long long rows, long long w,
                               const void* idx, void* out, long long b,
                               int vec, int log_rows, int threads,
                               long long blocks, void* stream) {
  if (b <= 0 || w <= 0) return 0;
  if (rows <= 0 || rows > 0x7FFFFFFFLL || w > 0x7FFFFFFFLL || blocks <= 0 ||
      blocks > 0x7FFFFFFFLL || log_rows < 0 || log_rows > 5 ||
      threads < 32 || threads > kThreads || threads % 32 ||
      (vec && (w % 4 || !aligned16(t) || !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const long long nq = vec ? w / 4 : w;
  if ((nq << log_rows) >= 0x7FFFFFFFLL ||
      ((blocks * (threads / 32)) << log_rows) < b)
    return (int)cudaErrorInvalidValue;
  return (int)launch(vec ? take_rows_kernel<4> : take_rows_kernel<1>,
                     dim3((unsigned)blocks), (unsigned)threads,
                     (cudaStream_t)stream, (const int32_t*)t,
                     (int32_t)(rows - 1), (int64_t)w, (const int32_t*)idx,
                     (int32_t*)out, (int64_t)b, log_rows, (uint32_t)nq);
}

// K3. x is (xr, xc), idx and out are (ir, ic); on axis 0 ic == xc, on
// axis 1 ir == xr. log_tpr: log2 of the threads a row tile; threads: a
// block's (a power of two, at least the tile's); (gx, gy): the grid.
extern "C" int sheep_take_along(const void* x, long long xr, long long xc,
                                const void* idx, void* out, long long ir,
                                long long ic, int axis, int shift,
                                int log_tpr, int threads, long long gx,
                                long long gy, void* stream) {
  if (ir <= 0 || ic <= 0) return 0;
  if ((axis != 0 && axis != 1) || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  const long long extent = axis == 0 ? xr : xc;
  if (extent <= 0 || extent > 0x7FFFFFFFLL || ic > 0x7FFFFFFFLL ||
      log_tpr < 0 || threads < 1 || threads > kThreads ||
      (threads & (threads - 1)) || (1 << log_tpr) > threads || gx <= 0 ||
      gx > 0x7FFFFFFFLL || gy <= 0 || gy > 65535 ||
      // the column tiles must reach the row's end
      (gx << log_tpr) * kUnits < ic)
    return (int)cudaErrorInvalidValue;
  return (int)launch(axis == 0 ? take_along_kernel<0> : take_along_kernel<1>,
                     dim3((unsigned)gx, (unsigned)gy), (unsigned)threads,
                     (cudaStream_t)stream, (const int32_t*)x,
                     (int64_t)xc, (int32_t)(extent - 1), (const int32_t*)idx,
                     (int32_t*)out, (int64_t)ir, (uint32_t)ic, shift,
                     log_tpr);
}

// A yardstick on no path: an empty kernel launched as K2 and K3 are, on
// their grid, for the launch floor of their chain bound.
extern "C" int sheep_gather2d_empty(long long gx, long long gy, int threads,
                                    void* stream) {
  if (gx <= 0 || gx > 0x7FFFFFFFLL || gy <= 0 || gy > 65535 || threads < 1 ||
      threads > kThreads)
    return (int)cudaErrorInvalidValue;
  return (int)launch(empty_kernel, dim3((unsigned)gx, (unsigned)gy),
                     (unsigned)threads, (cudaStream_t)stream);
}

extern "C" const char* sheep_gather2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
