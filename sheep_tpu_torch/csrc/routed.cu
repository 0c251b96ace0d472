// The routed round of the vertex-sharded build (ops/routed.py,
// parallel/bigv.py): the owner side and the requester side of the JAX
// package's routed lookup and routed scatter-min
// (sheep_tpu/parallel/bigv.py:150-182), and the local rewrite that ends a
// fixpoint round (:263-285). There they are XLA programs under shard_map;
// no Pallas kernel computes them.
//
// A table of V + 1 rows is block-sharded over D shards: shard s owns the
// B rows [s B, (s + 1) B), and a card holds the blocks of its S shards
// first .. first + S - 1 as one (S, B) buffer, which is the contiguous
// global slice [first B, (first + S) B). Requests come as the all-gather
// of every shard's (W,) requests, a (D, W) block; an owner answers every
// request with its table entry where it owns the row and n elsewhere, a
// (S, D, W) block of answers; the all-to-all hands requester j row j of
// every owner's block, and the requester folds its D answers with a min.
//
//   owned_gather       the owner side of the lookup: out[s][j][i] =
//                      table[s][q - (first + s) B] where that row is
//                      shard first + s's, else n. One launch serves every
//                      shard of the card: a thread loads a request once
//                      and writes its S answers.
//   owned_scatter_min  the owner side of the scatter-min, three launches
//                      of one kernel in stream order: the answers before
//                      the round (mode READ), table[q - first B] <-
//                      min(table[...], val) over every owned request,
//                      duplicates included (mode MIN), the answers after
//                      it (mode READ). Stream order puts every read of the
//                      first launch before any write and every write
//                      before the last launch's reads. A request whose
//                      value is n or more cannot lower an entry (entries
//                      lie in [0, n]), so it takes no atomic: the round's
//                      dead slots (n, n) would all land on the sentinel
//                      row.
//   routed_step        the requester's fold of the D answers with a min,
//                      then the climb's rewrite cur <- cand < hi ? cand :
//                      cur (the first step of a round also keeps the
//                      folded answer, the scatter's post-round parent);
//                      without hi the plain min (a squaring t <- t[t], the
//                      pos and part lookups).
//   routed_round_end   the round's end on every shard of the card (mode
//                      FOLD): the pre-round answers folded, retire,
//                      displace, became-loop and the new (lo, hi) slots
//                      written in place, the shard's live slots counted
//                      into its word of the segment state; mode COUNT
//                      counts a segment's first live slots; mode ACCOUNT
//                      sums and maxes the D shards' words once they all
//                      reached the card (the psum and pmax), counts the
//                      round and sets STOP when nothing is live or the
//                      segment's rounds are spent.
//
// The segment state st (int64, ops/routed.py: STOP, ROUNDS, LIVE,
// MAX_LIVE, then one live word a shard of the mesh) lives on each card;
// every kernel given it returns at once once STOP is set, so the host
// enqueues a segment's whole budget of rounds and reads the state once.
//
// Bound by bytes: every kernel streams its requests or answers once and
// reads the table at the requested rows; the answers are the D Q words a
// collective ships, the trade of the reference's static-shape routing.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers and its CUDA stream and gets back the
// first CUDA error of its launches (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace sheep;

enum : int { kStStop = 0, kStRounds = 1, kStLive = 2, kStMaxLive = 3,
             kStWords = 4 };
enum : int { kRead = 0, kMin = 1 };
enum : int { kFold = 0, kCount = 1, kAccount = 2 };

__device__ __forceinline__ bool halted(const int64_t* st) {
  return st != nullptr && st[kStStop] != 0;
}

// answers of the card's S shards to the requests of row j: a thread loads
// a request once and writes one answer a shard
__device__ __forceinline__ void answer(const int32_t* __restrict__ table,
                                       int64_t B, int64_t first, int S,
                                       int32_t q, int32_t n,
                                       int32_t* __restrict__ out,
                                       int64_t shard_stride) {
  const int64_t lo = (int64_t)q - first * B;
  for (int s = 0; s < S; ++s) {
    const int64_t local = lo - (int64_t)s * B;
    out[s * shard_stride] =
        (local >= 0 && local < B) ? table[s * B + local] : n;
  }
}

__global__ void __launch_bounds__(kThreads)
owned_gather_kernel(const int32_t* __restrict__ table, int64_t B,
                    int64_t first, int S, const int32_t* __restrict__ req,
                    int64_t D, int64_t W, int32_t* __restrict__ out,
                    int32_t n, const int64_t* st) {
  if (halted(st)) return;
  const int64_t j = blockIdx.y;
  const int32_t* q = req + j * W;
  int32_t* o = out + j * W;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < W;
       i += step)
    answer(table, B, first, S, q[i], n, o + i, D * W);
}

__global__ void __launch_bounds__(kThreads)
owned_scatter_min_kernel(int32_t* table, int64_t B, int64_t first, int S,
                         const int32_t* __restrict__ lo,
                         const int32_t* __restrict__ val, int64_t D,
                         int64_t W, int32_t* __restrict__ out, int32_t n,
                         const int64_t* st, int mode) {
  if (halted(st)) return;
  const int64_t j = blockIdx.y;
  const int32_t* q = lo + j * W;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t rows = (int64_t)S * B;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < W;
       i += step) {
    if (mode == kRead) {
      answer(table, B, first, S, q[i], n, out + j * W + i, D * W);
    } else {
      const int64_t local = (int64_t)q[i] - first * B;
      if (local >= 0 && local < rows) {
        const int32_t v = val[j * W + i];
        if (v < n) atomicMin(table + local, v);
      }
    }
  }
}

// min over the D owners' answers to requester l's slot i
__device__ __forceinline__ int32_t fold(const int32_t* __restrict__ rep,
                                        int64_t D, int64_t owner_stride,
                                        int64_t i) {
  int32_t m = rep[i];
  for (int64_t s = 1; s < D; ++s) {
    const int32_t a = rep[s * owner_stride + i];
    m = a < m ? a : m;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
routed_step_kernel(const int32_t* __restrict__ rep, int64_t D,
                   int64_t owner_stride, int64_t req_stride, int64_t W,
                   const int32_t* __restrict__ hi, const int32_t* cur_in,
                   int32_t* out, int32_t* __restrict__ store,
                   const int64_t* st) {
  if (halted(st)) return;
  const int64_t l = blockIdx.y;
  const int32_t* r = rep + l * req_stride;
  const int64_t off = l * W;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < W;
       i += step) {
    const int32_t cand = fold(r, D, owner_stride, i);
    if (store != nullptr) store[off + i] = cand;
    if (hi == nullptr) {
      out[off + i] = cand;
    } else {
      const int32_t h = hi[off + i];
      out[off + i] = cand < h ? cand : cur_in[off + i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
routed_round_end_kernel(const int32_t* __restrict__ rep_old, int64_t D,
                        int64_t owner_stride, int64_t req_stride, int64_t W,
                        const int32_t* __restrict__ newp,
                        const int32_t* __restrict__ cur, int32_t* lo,
                        int32_t* hi, int32_t n, int64_t first, int S,
                        int64_t* st, int mode, int64_t budget) {
  __shared__ int smem[kWarps];
  if (mode == kAccount) {
    // one thread: the psum and pmax of the D shards' live words, then
    // the round counted (or, first, the segment's start) and STOP set
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    if (st[kStStop]) return;
    int64_t live = 0, mx = 0;
    for (int64_t s = 0; s < D; ++s) {
      const int64_t w = st[kStWords + s];
      live += w;
      mx = w > mx ? w : mx;
    }
    const int64_t rounds = st[kStRounds] + (budget >= 0 ? 1 : 0);
    const int64_t cap = budget >= 0 ? budget : -budget - 1;
    st[kStRounds] = rounds;
    st[kStLive] = live;
    st[kStMaxLive] = mx;
    st[kStStop] = live == 0 || rounds >= cap;
    // the card's own words start the next count at zero
    for (int s = 0; s < S; ++s) st[kStWords + first + s] = 0;
    return;
  }
  if (st[kStStop]) return;
  const int64_t l = blockIdx.y;
  const int64_t off = l * W;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  int live = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < W;
       i += step) {
    if (mode == kCount) {
      live += lo[off + i] != n;
      continue;
    }
    const int32_t old = fold(rep_old + l * req_stride, D, owner_stride, i);
    const int32_t nw = newp[off + i], h = hi[off + i], c = cur[off + i];
    const bool retire = h == nw;
    const bool displaced = retire && nw < old && old < n;
    const bool loop = c == h;
    const int32_t out_lo = retire ? (displaced ? nw : n) : (loop ? n : c);
    const int32_t out_hi = retire ? (displaced ? old : n) : (loop ? n : h);
    lo[off + i] = out_lo;
    hi[off + i] = out_hi;
    live += out_lo != n;
  }
  live = block_sum(live, smem);
  if (threadIdx.x == 0 && live)
    atomicAdd(reinterpret_cast<unsigned long long*>(st + kStWords + first +
                                                    l),
              (unsigned long long)live);
}

Wave wave_gather, wave_scatter, wave_step, wave_end;

// a (blocks, rows) grid: at most one wave of blocks over all rows
template <typename Kernel>
cudaError_t grid2d(Wave& w, Kernel kernel, long long W, long long rows,
                   dim3* grid) {
  unsigned cap = 0;
  cudaError_t err = wave_blocks(w, kernel, 1LL << 40, &cap);
  if (err != cudaSuccess) return err;
  long long per_row = (W + kThreads - 1) / kThreads;
  long long room = (long long)cap / (rows > 0 ? rows : 1);
  if (room < 1) room = 1;
  if (per_row > room) per_row = room;
  if (per_row < 1) per_row = 1;
  *grid = dim3((unsigned)per_row, (unsigned)rows, 1);
  return cudaSuccess;
}

bool bad_shape(long long B, long long D, long long W, int S) {
  return B <= 0 || D <= 0 || D > 65535 || W < 0 || S <= 0 ||
         W > 0x7FFFFFFFLL || D * W > 0x7FFFFFFFLL * 4;
}

}  // namespace

// out (S, D, W) = the answers of shards first .. first + S - 1 (table (S,
// B)) to the requests req (D, W). st: the segment state or null.
extern "C" int sheep_owned_gather(const void* table, long long B,
                                  long long first, int S, const void* req,
                                  long long D, long long W, void* out, int n,
                                  const void* st, void* stream) {
  if (bad_shape(B, D, W, S)) return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  dim3 grid;
  cudaError_t err = grid2d(wave_gather, owned_gather_kernel, W, D, &grid);
  if (err != cudaSuccess) return (int)err;
  owned_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, B, first, S, (const int32_t*)req, D, W,
      (int32_t*)out, (int32_t)n, (const int64_t*)st);
  return (int)cudaGetLastError();
}

// old (S, D, W) = the answers before, table[lo - first B] <- min(..., val)
// over the owned requests, new (S, D, W) = the answers after: three
// launches in stream order.
extern "C" int sheep_owned_scatter_min(void* table, long long B,
                                       long long first, int S, const void* lo,
                                       const void* val, long long D,
                                       long long W, void* old, void* nw,
                                       int n, const void* st, void* stream) {
  if (bad_shape(B, D, W, S)) return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  dim3 grid;
  cudaError_t err =
      grid2d(wave_scatter, owned_scatter_min_kernel, W, D, &grid);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* const outs[3] = {(int32_t*)old, nullptr, (int32_t*)nw};
  const int modes[3] = {kRead, kMin, kRead};
  for (int k = 0; k < 3; ++k) {
    owned_scatter_min_kernel<<<grid, kThreads, 0, s>>>(
        (int32_t*)table, B, first, S, (const int32_t*)lo,
        (const int32_t*)val, D, W, outs[k], (int32_t)n, (const int64_t*)st,
        modes[k]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out[l][i] = min over the D answers rep[s * owner_stride + l * req_stride
// + i]; with hi, out = cand < hi ? cand : cur_in; with store, store = cand.
// out, hi, cur_in and store are (R, W) contiguous; out may be cur_in.
extern "C" int sheep_routed_step(const void* rep, long long D,
                                 long long owner_stride,
                                 long long req_stride, long long R,
                                 long long W, const void* hi,
                                 const void* cur_in, void* out, void* store,
                                 const void* st, void* stream) {
  if (D <= 0 || R <= 0 || R > 65535 || W < 0) return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  dim3 grid;
  cudaError_t err = grid2d(wave_step, routed_step_kernel, W, R, &grid);
  if (err != cudaSuccess) return (int)err;
  routed_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rep, D, owner_stride, req_stride, W,
      (const int32_t*)hi, (const int32_t*)cur_in, (int32_t*)out,
      (int32_t*)store, (const int64_t*)st);
  return (int)cudaGetLastError();
}

// mode 0 (FOLD): the round's end on the card's S shards (slots (S, W));
// mode 1 (COUNT): their live slots counted; both add into st's words of
// shards first .. first + S - 1. mode 2 (ACCOUNT): the D words summed and
// maxed, the round counted (budget >= 0: a round of a segment of `budget`
// rounds; budget < 0: the segment's start, of -budget - 1 rounds).
extern "C" int sheep_routed_round_end(const void* rep_old, long long D,
                                      long long owner_stride,
                                      long long req_stride, long long W,
                                      const void* nw, const void* cur,
                                      void* lo, void* hi, int n,
                                      long long first, int S, void* st,
                                      int mode, long long budget,
                                      void* stream) {
  if (D <= 0 || S <= 0 || S > 65535 || W < 0 || st == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kAccount) {
    routed_round_end_kernel<<<1, 32, 0, s>>>(
        nullptr, D, 0, 0, 0, nullptr, nullptr, nullptr, nullptr, n, first,
        S, (int64_t*)st, mode, budget);
    return (int)cudaGetLastError();
  }
  if (W == 0) return 0;
  dim3 grid;
  cudaError_t err = grid2d(wave_end, routed_round_end_kernel, W, S, &grid);
  if (err != cudaSuccess) return (int)err;
  routed_round_end_kernel<<<grid, kThreads, 0, s>>>(
      (const int32_t*)rep_old, D, owner_stride, req_stride, W,
      (const int32_t*)nw, (const int32_t*)cur, (int32_t*)lo, (int32_t*)hi,
      (int32_t)n, first, S, (int64_t*)st, mode, budget);
  return (int)cudaGetLastError();
}

// One fixpoint round on a card that holds every shard of the mesh (first
// 0, S = D), where the all-gather of the shards' (D, W) rows is that
// buffer itself and the all-to-all hands requester j the answers' column
// j, so no copy moves between the kernels: the scatter-min (three
// launches), the climb's first step from its post-round answers, the
// climb (`ops` steps, each a lookup and a fold: kind 0 looks up
// `tables[i]` at the slots' cur and rewrites cur below hi; kind 1 squares
// `tables[i]` into t_buf, the requests its own entries at width B), the
// round's end and the segment's accounting. One host call enqueues the
// round's 3 + 1 + 2 ops + 2 launches, each a launch of the kernels above.
// Slots lo, hi, cur, nw are (D, Q); answers ans_old, ans_new, ans_q (D, D,
// Q), ans_b (D, D, B); the table P and t_buf (D, B).
extern "C" int sheep_routed_round(void* P, long long B, long long D, int n,
                                  void* lo, void* hi, void* cur, void* nw,
                                  long long Q, void* ans_old, void* ans_new,
                                  void* ans_q, void* ans_b, void* t_buf,
                                  int ops, const int* kinds,
                                  void* const* tables, void* st,
                                  long long budget, void* stream) {
  if (bad_shape(B, D, Q, (int)D) || Q == 0 || st == nullptr)
    return (int)cudaErrorInvalidValue;
  const int S = (int)D;
  int rc = sheep_owned_scatter_min(P, B, 0, S, lo, hi, D, Q, ans_old,
                                   ans_new, n, st, stream);
  if (rc) return rc;
  rc = sheep_routed_step(ans_new, D, D * Q, Q, D, Q, hi, lo, cur, nw, st,
                         stream);
  if (rc) return rc;
  for (int i = 0; i < ops; ++i) {
    if (kinds[i] == 0) {
      rc = sheep_owned_gather(tables[i], B, 0, S, cur, D, Q, ans_q, n, st,
                              stream);
      if (!rc)
        rc = sheep_routed_step(ans_q, D, D * Q, Q, D, Q, hi, cur, cur,
                               nullptr, st, stream);
    } else {
      rc = sheep_owned_gather(tables[i], B, 0, S, tables[i], D, B, ans_b, n,
                              st, stream);
      if (!rc)
        rc = sheep_routed_step(ans_b, D, D * B, B, D, B, nullptr, nullptr,
                               t_buf, nullptr, st, stream);
    }
    if (rc) return rc;
  }
  rc = sheep_routed_round_end(ans_old, D, D * Q, Q, Q, nw, cur, lo, hi, n, 0,
                              S, st, kFold, 0, stream);
  if (rc) return rc;
  return sheep_routed_round_end(nullptr, D, 0, 0, 0, nullptr, nullptr,
                                nullptr, nullptr, n, 0, S, st, kAccount,
                                budget, stream);
}

extern "C" const char* sheep_routed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
