// The exact-descent fixpoint round's lifting work as two kernels:
//
//   lift_stack   the lifting stack t_{j+1} = t_j[t_j] (t_0 = P), one
//                launch per level, issued as one ladder by one host call,
//                with an on-device depth cut;
//   climb_tail   one fused pass per round over the slots: the binary-
//                lifting climb, retire, displace, the round's `changed`
//                flag and its retired and live counts;
//   climb_jumps  the same pass with the jump-mode climb: `jumps` single
//                parent steps over the current table in place of the
//                stack.
//
// They are the counterparts of _pos_round_body after its scatter-min
// (sheep_tpu/ops/elim.py:158-192), of build_lift_tables (:295), of the
// stale round _pos_round_body_stale after its scatter (:222; climb_tail
// over a stack built once a segment, its level 0 the current table), and
// of the jump-mode round _pos_small_round_body after its scatter (:359).
//
// Control word ctl (int32[5]): [0] rows, the number of stack rows that
// hold distinct levels (the depth d less one); [1] changed; [2] retired;
// [3] live; [4] the blocks of climb_tail that have finished. lift_stack
// zeroes all five and writes [0]; climb_tail reads [0] and adds to
// [1..4].
//
// Depth cut. Level launch j computes t_{j+1} from t_j and raises rows to
// j + 1 if any entry differs (a block vote, one atomicMax per block). If
// none differs, t_j is idempotent, every higher level equals it, and the
// later launches of the ladder read rows and return at once. The climb
// applies levels d-1 .. 0: applying an idempotent table twice moves no
// slot (cand = t[t[x]] = t[x] = cur), so this is bit for bit the climb
// over L-1 .. 0.
//
// The stack is level-major: one row of `stride` (a multiple of 32) int32
// per level, so the squaring streams a row with 16-byte loads and stores.
// An entry-major stack ([T, 32], one 128-byte line per entry, so that a
// climbing slot that does not jump rereads one line) made the climb
// 1.4-2.2x faster but the squaring ladder 15-26x slower, and the s22
// build 7x slower, on an H100 (PERF.md).
//
// Bounds on an H100 (3.35 TB/s), both by bytes (no arithmetic worth
// counting). The ladder reads P once and writes each level it computes
// once, 4*T bytes for P and 4*T a level (T = n + 1; 0.0050 ms a level at
// T = 2^22 + 1): a level's source row is the previous launch's output,
// 16.8 MB, which L2 holds, so its reads need not reach memory. A climb
// pass reads lo and writes two outputs, 12 bytes a slot; hi only at live
// slots and old_at_lo only at retiring ones; and each table at the
// sectors its live slots read (P at lo and at the end of the climb,
// levels d-1 .. 1 on the way), 32 bytes a distinct sector.
//
// In a batched fixpoint execution (csrc/common.cuh) both kernels are
// given the execution's state and return at once when it has stopped;
// climb_tail then reads the execution's row of the [N, C] blocks and
// writes its outputs back into that row in place (each slot reads and
// writes only its own entries). For the stream descent climb_tail takes
// the climbed positions `pre` instead of climbing the stack itself.
//
// climb_tail is the round's last kernel on both descents, so it also ends
// the round (end_round, csrc/common.cuh): a round's end is a few words,
// and as a launch of its own it cost a launch and a gap a round. Each
// block, once its counts are in ctl, draws a ticket; the block that
// draws the last one has seen every block's counts, ends the round
// on one thread and puts the ticket counter back to 0 (one atomic with
// acquire-release order a block, in place of a fence and an atomic).
// Without an execution (a free-standing round) nothing is counted.
//
// climb_jumps runs on the adaptive driver's small buffers (at most 2^14
// slots after compaction): `jumps` dependent loads a climbing slot, each
// a random 4-byte read of P, so it is bound by their latency, not by
// bytes; one thread a slot keeps every slot's chain in flight at once.
// Its bytes bound: lo in and two outputs back (12 B a slot), hi at the
// live slots, old_at_lo at the retiring ones, and a sector of P for each
// step a climbing slot takes.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers and its CUDA stream and gets back the
// first CUDA error of its launches (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using sheep::block_sum;
using sheep::clip;
using sheep::kThreads;
using sheep::kWarps;
using sheep::volatile_load;
using sheep::Wave;
using sheep::wave_blocks;
constexpr int kRows = sheep::kCtlRows;
constexpr int kChanged = sheep::kCtlChanged;
constexpr int kRetired = sheep::kCtlRetired;
constexpr int kLive = sheep::kCtlLive;

// one atomicMax per block whose entries changed
__device__ __forceinline__ void vote_rows(bool diff, int j, int32_t* ctl) {
  if (__syncthreads_or(diff) && threadIdx.x == 0 &&
      volatile_load(ctl + kRows) < j + 1)
    atomicMax(ctl + kRows, j + 1);
}

// dst = src[src] over T entries, 4 entries a thread through 16-byte
// loads and stores, a scalar tail for the last T % 4
__global__ void __launch_bounds__(kThreads)
lift_level(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
           int64_t T, int j, int32_t* ctl, const int64_t* ex) {
  if (sheep::stopped(ex)) return;
  if (volatile_load(ctl + kRows) < j) return;  // t_j == t_{j-1}
  const int32_t last = (int32_t)(T - 1);
  const int64_t quads = T >> 2;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  bool diff = false;
  for (int64_t q = tid; q < quads; q += step) {
    const int4 v = __ldg(s4 + q);
    int4 w;
    w.x = __ldg(src + clip(v.x, last));
    w.y = __ldg(src + clip(v.y, last));
    w.z = __ldg(src + clip(v.z, last));
    w.w = __ldg(src + clip(v.w, last));
    d4[q] = w;
    diff |= (w.x != v.x) | (w.y != v.y) | (w.z != v.z) | (w.w != v.w);
  }
  const int64_t p = (quads << 2) + tid;
  if (p < T) {
    const int32_t v = src[p];
    const int32_t w = __ldg(src + clip(v, last));
    dst[p] = w;
    diff |= w != v;
  }
  vote_rows(diff, j, ctl);
}

// lo, hi and out_lo, out_hi may be the same slots (in place): no
// __restrict__ on them. kJumps: the climb is `jumps` steps over P (the
// stack and pre are not read).
template <bool kJumps>
__global__ void __launch_bounds__(kThreads)
climb_tail_kernel(const int32_t* lo, const int32_t* hi,
                  const int32_t* __restrict__ old,
                  const int32_t* __restrict__ P,
                  const int32_t* __restrict__ stack, int64_t stride,
                  int32_t* ctl, int32_t* out_lo, int32_t* out_hi, int64_t m,
                  int32_t n, int64_t* ex, int64_t row_stride,
                  const int32_t* __restrict__ pre, int64_t N,
                  int64_t budget, int jumps) {
  __shared__ int smem[2][kWarps];
  if (sheep::stopped(ex)) return;
  const int64_t off = sheep::row_offset(ex, row_stride);
  lo += off;
  hi += off;
  out_lo += off;
  out_hi += off;
  const int32_t rows = volatile_load(ctl + kRows);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  bool changed = false;
  int retired = 0, live = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const int32_t l = lo[i];
    int32_t ol = n, oh = n;  // a dead slot (n, n) reads nothing else
    if (l != n) {
      ++live;
      const int32_t h = hi[i];
      const int32_t now = __ldg(P + clip(l, n));
      if (h == now) {  // retire; displace an older parent
        const int32_t o = old[i];
        if (now < o && o < n) {
          ol = now;
          oh = o;
        }
      } else {  // climb levels d-1 .. 1 of the stack, then P
        int32_t cur = clip(l, n);
        if (kJumps) {
          for (int j = 0; j < jumps; ++j) {
            const int32_t cand = __ldg(P + cur);
            if (cand < h) cur = cand;
          }
        } else if (pre != nullptr) {
          cur = pre[i];  // the stream descent climbed already
        } else {
          for (int k = rows; k >= 1; --k) {
            const int32_t cand =
                __ldg(stack + (int64_t)(k - 1) * stride + cur);
            if (cand < h) cur = cand;
          }
          const int32_t cand = __ldg(P + cur);
          if (cand < h) cur = cand;
        }
        if (cur != h) {  // else the constraint is implied: the slot dies
          ol = cur;
          oh = h;
        }
      }
      retired += ol == n;
      changed |= (ol != l) | (oh != h);
    }
    out_lo[i] = ol;
    out_hi[i] = oh;
  }
  const bool any = __syncthreads_or(changed);
  retired = block_sum(retired, smem[0]);
  live = block_sum(live, smem[1]);
  if (threadIdx.x == 0) {
    if (any && volatile_load(ctl + kChanged) == 0) atomicOr(ctl + kChanged, 1);
    if (retired) atomicAdd(ctl + kRetired, retired);
    if (live) atomicAdd(ctl + kLive, live);
    // the ticket releases this block's counts; the last one acquires
    // every block's
    if (ex != nullptr &&
        sheep::ticket(ctl + sheep::kCtlTickets) == gridDim.x - 1) {
      sheep::end_round(ctl, ex, N, budget);
      ctl[sheep::kCtlTickets] = 0;
    }
  }
}

Wave wave_lift, wave_climb, wave_jumps;

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The ladder of one round: ctl zeroed, then levels t_1 .. t_{levels-1}
// into the stack, row k-1 (at stack + (k-1)*stride) holding t_k. ex: the
// execution's state or null.
extern "C" int sheep_lift_stack(const void* P, long long T, void* stack,
                                long long stride, int levels, void* ctl,
                                const void* ex, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL || levels < 1 || levels > 32)
    return (int)cudaErrorInvalidValue;
  if (stride < T || stride % 4 || !aligned16(P) || !aligned16(stack))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* c = (int32_t*)ctl;
  cudaError_t err =
      cudaMemsetAsync(c, 0, sheep::kCtlWords * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = 0;
  err = wave_blocks(wave_lift, lift_level, (T + 3) / 4, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int32_t* p = (const int32_t*)P;
  int32_t* st = (int32_t*)stack;
  for (int j = 0; j + 1 < levels; ++j) {
    const int32_t* src = j == 0 ? p : st + (long long)(j - 1) * stride;
    lift_level<<<blocks, kThreads, 0, s>>>(
        src, st + (long long)j * stride, T, j, c, (const int64_t*)ex);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One pass over m slots: out_lo/out_hi, and this pass's changed flag,
// retired and live counts added to ctl[1..3]; reads rows at ctl[0]. ex:
// the execution's state or null; with it, the round of an execution over
// N rows with a budget of `budget` rounds is ended in the last block;
// row_stride: the blocks' row length when lo, hi, out_lo and out_hi are
// [N, C] blocks, else 0; pre: the climbed positions (stream descent) or
// null.
extern "C" int sheep_climb_tail(const void* lo, const void* hi,
                                const void* old, long long m, const void* P,
                                long long T, const void* stack,
                                long long stride, void* ctl, void* out_lo,
                                void* out_hi, void* ex, long long row_stride,
                                const void* pre, long long N,
                                long long budget, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (ex != nullptr && (m <= 0 || N <= 0 || budget <= 0))
    return (int)cudaErrorInvalidValue;  // the round must end
  if (m <= 0) return 0;
  unsigned blocks = 0;
  cudaError_t err =
      wave_blocks(wave_climb, climb_tail_kernel<false>, m, &blocks);
  if (err != cudaSuccess) return (int)err;
  climb_tail_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)old,
      (const int32_t*)P, (const int32_t*)stack, stride, (int32_t*)ctl,
      (int32_t*)out_lo, (int32_t*)out_hi, m, (int32_t)(T - 1),
      (int64_t*)ex, (int64_t)row_stride, (const int32_t*)pre, (int64_t)N,
      (int64_t)budget, 0);
  return (int)cudaGetLastError();
}

// climb_tail's pass with the jump-mode climb: `jumps` steps cur <- P[cur]
// where that lands below hi, for the non-retiring live slots; the other
// arguments as sheep_climb_tail's.
extern "C" int sheep_climb_jumps(const void* lo, const void* hi,
                                 const void* old, long long m, const void* P,
                                 long long T, int jumps, void* ctl,
                                 void* out_lo, void* out_hi, void* ex,
                                 long long row_stride, long long N,
                                 long long budget, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL || jumps < 0)
    return (int)cudaErrorInvalidValue;
  if (ex != nullptr && (m <= 0 || N <= 0 || budget <= 0))
    return (int)cudaErrorInvalidValue;  // the round must end
  if (m <= 0) return 0;
  unsigned blocks = 0;
  cudaError_t err =
      wave_blocks(wave_jumps, climb_tail_kernel<true>, m, &blocks);
  if (err != cudaSuccess) return (int)err;
  climb_tail_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)old,
      (const int32_t*)P, nullptr, 0, (int32_t*)ctl, (int32_t*)out_lo,
      (int32_t*)out_hi, m, (int32_t)(T - 1), (int64_t*)ex,
      (int64_t)row_stride, nullptr, (int64_t)N, (int64_t)budget, jumps);
  return (int)cudaGetLastError();
}

extern "C" const char* sheep_lift_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
