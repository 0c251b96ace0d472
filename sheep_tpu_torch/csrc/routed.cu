// The routed round of the vertex-sharded build (ops/routed.py,
// parallel/bigv.py): the owner side and the requester side of the JAX
// package's routed lookup and routed scatter-min
// (sheep_tpu/parallel/bigv.py:150-182), its jump climb and squaring
// (:310-399), and the local rewrite that ends a fixpoint round
// (:263-285). There they are XLA programs under shard_map; no Pallas
// kernel computes them.
//
// A table of V + 1 rows is block-sharded over D shards: shard s owns the
// B rows [s B, (s + 1) B), and a card holds the blocks of its S shards
// first .. first + S - 1 as one (S, B) buffer, which is the contiguous
// global slice [first B, (first + S) B). Requests come as the all-gather
// of every shard's (W,) requests, a (D, W) block; an owner answers every
// request with its table entry where it owns the row and n elsewhere, a
// (S, D, W) block of answers; the all-to-all hands requester j row j of
// every owner's block, and the requester folds its D answers with a min.
// On a card that holds every shard (first 0, S = D) the (D, B) buffer is
// the whole table, so the min over the D answers to a request q is the
// table's own entry at q (n past the table): the card forms below read
// it there and move no answers.
//
//   owned_gather       the owner side of the lookup: out[s][j][i] =
//                      table[s][q - (first + s) B] where that row is
//                      shard first + s's, else n. One launch serves every
//                      shard of the card: a thread loads a request once
//                      and writes its S answers.
//   owned_scatter_min  the scatter-min. Answers mode (several cards):
//                      three launches of one kernel in stream order, the
//                      answers before the round (READ), table[q - first
//                      B] <- min(table[...], val) over every owned
//                      request, duplicates included (MIN), the answers
//                      after it (READ). Card mode (one card holds every
//                      shard): one cooperative launch, the folded
//                      pre-round parents old[i] = table[lo[i]], a grid
//                      barrier, then the min (the round's climb reads the
//                      post-round parents from the table). In both
//                      modes the min pre-combines equal rows within a
//                      warp (__match_any_sync, a min over the group, one
//                      atomicMin by the group's first lane), among the
//                      lanes whose value can still lower their row (below
//                      its entry before the round, or as read now): a
//                      star's hub, every request on one row, takes at most
//                      one atomic a warp in place of 32. A request whose
//                      value is n or more cannot lower an entry (entries
//                      lie in [0, n]), so it takes no atomic: the round's
//                      dead slots (n, n) would all land on the sentinel
//                      row.
//   routed_step        the requester's fold of the D answers with a min
//                      (16-byte loads of four answers over each row's
//                      aligned body, a scalar head and tail), then the
//                      climb's rewrite
//                      cur <- cand < hi ? cand : cur (the first step of a
//                      round also keeps the folded answer, the scatter's
//                      post-round parent); without hi the plain min (a
//                      squaring t <- t[t], the pos and part lookups).
//   routed_climb       routed_step's card form for a climb: runs of steps
//                      over the card's own tables, one thread a slot, in
//                      one launch: each step cand = table[cur] (n past
//                      the table), cur <- cand < hi ? cand : cur. A run
//                      over one table ends at its first step that does
//                      not move the slot: the table does not change
//                      within the launch, so every later step of the run
//                      would load the same entry. The round's first step
//                      (cur = lo, its candidate the scatter's post-round
//                      parent) is the first step of the first run; its
//                      candidate is stored into nw. A tail round's whole
//                      jump climb (jumps steps over P) is one launch; a
//                      lifting round's climb on a level is a run of one
//                      step.
//   routed_square      routed_step's card form for a squaring: out[i] =
//                      t[t[i]] (n past the table) over the whole table,
//                      into another buffer.
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
// Bound by bytes, or for the climb by its longest chain of dependent
// loads: every kernel streams its requests or answers once and reads the
// table at the requested rows; the answers are the D Q words a
// collective ships, the trade of the reference's static-shape routing,
// which the card forms do without.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers and its CUDA stream and gets back the
// first CUDA error of its launches (0 if none).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sheep;

enum : int { kStStop = 0, kStRounds = 1, kStLive = 2, kStMaxLive = 3,
             kStWords = 4 };
enum : int { kRead = 0, kMin = 1 };
enum : int { kFold = 0, kCount = 1, kAccount = 2 };
// a card round's plan steps (ops/routed.py round_plan)
enum : int { kPlanFirst = 0, kPlanClimb = 1, kPlanSquare = 2 };

constexpr int kMaxRuns = 32;  // ops/routed.py MAX_RUNS
constexpr unsigned kFull = 0xffffffffu;

struct Runs {
  const int32_t* table[kMaxRuns];
  int32_t steps[kMaxRuns];
  int32_t count;
};

__device__ __forceinline__ bool halted(const int64_t* st) {
  return st != nullptr && st[kStStop] != 0;
}

// the table's entry at q, n past the table; through L2, where the
// atomics of other blocks land
__device__ __forceinline__ int32_t entry(const int32_t* table, int64_t rows,
                                         int32_t q, int32_t n) {
  return (q >= 0 && q < rows) ? __ldcg(table + q) : n;
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

// table[lo[i] - offset] <- min(..., val[i]) for i in [0, W) where the row
// lies in [0, rows) and val < n, a warp's equal rows pre-combined: the
// lanes of one row take the min of their values and the group's first
// lane lowers the row with one atomic. A lane whose value cannot lower
// its row takes no part: one whose value is no less than the row's entry
// before the round (`before[i]`, where the caller has it, else the
// entry as read now through L2); entries only fall, so a stale entry can
// only keep a needless atomic. A warp with no lane left skips the match,
// and the group's first lane reads the row again before its atomic (a
// star's hub, once at its min, takes no more). The loop runs warp by
// warp, so every lane of a warp meets the warp-wide intrinsics on each
// pass; `at` is the warp's first element and `step` a multiple of 32.
__device__ __forceinline__ void min_rows(int32_t* table, int64_t offset,
                                         int64_t rows,
                                         const int32_t* __restrict__ lo,
                                         const int32_t* __restrict__ val,
                                         const int32_t* before, int64_t W,
                                         int64_t at, int64_t step,
                                         int32_t n) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = at; base < W; base += step) {
    const int64_t i = base + lane;
    int32_t key = -1, v = n;
    if (i < W) {
      const int64_t local = (int64_t)lo[i] - offset;
      v = val[i];
      if (local >= 0 && local < rows && v < n &&
          v < (before != nullptr ? before[i] : __ldcg(table + local)))
        key = (int32_t)local;
    }
    if (!__any_sync(kFull, key >= 0)) continue;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0) {
      const int32_t m = __reduce_min_sync(peers, v);
      if (lane == __ffs(peers) - 1 && m < __ldcg(table + key))
        atomicMin(table + key, m);
    }
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
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == kMin) {
    min_rows(table, first * B, (int64_t)S * B, q, val + j * W, nullptr, W,
             t - (threadIdx.x & 31), step, n);
    return;
  }
  for (int64_t i = t; i < W; i += step)
    answer(table, B, first, S, q[i], n, out + j * W + i, D * W);
}

// The card mode of the scatter-min over m requests into the whole table
// (rows entries), one cooperative launch: old = the entries at lo, then
// the warp-combined min. Every block passes the barrier or none (STOP is
// read once, before it).
__global__ void __launch_bounds__(kThreads)
scatter_card_kernel(int32_t* table, int64_t rows,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ val, int64_t m,
                    int32_t* old, int32_t n, const int64_t* st) {
  if (halted(st)) return;
  cg::grid_group grid = cg::this_grid();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = t; i < m; i += step) old[i] = entry(table, rows, lo[i], n);
  grid.sync();
  min_rows(table, 0, rows, lo, val, old, m, t - (threadIdx.x & 31), step, n);
}

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void store4(int32_t* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

__device__ __forceinline__ int4 min4(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                   min(a.w, b.w));
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
  const int32_t* h = hi != nullptr ? hi + off : nullptr;
  const int32_t* c = cur_in != nullptr ? cur_in + off : nullptr;
  int32_t* o = out + off;
  int32_t* s = store != nullptr ? store + off : nullptr;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // four slots a thread over the row's 16-byte-aligned body, where every
  // pointer of the row shares out's offset within 16 bytes (one answer a
  // thread over the head before it and the tail after it); one slot a
  // thread over the whole row otherwise
  const uintptr_t a = (uintptr_t)o & 15;
  const bool vec = owner_stride % 4 == 0 && ((uintptr_t)r & 15) == a &&
                   (h == nullptr ||
                    (((uintptr_t)h & 15) == a && ((uintptr_t)c & 15) == a)) &&
                   (s == nullptr || ((uintptr_t)s & 15) == a);
  int64_t head = vec ? (int64_t)((16 - a) & 15) / 4 : W;
  if (head > W) head = W;
  const int64_t W4 = vec ? (W - head) / 4 : 0;
  for (int64_t k = t; k < W4; k += step) {
    const int64_t i = head + 4 * k;
    int4 m = load4(r + i);
#pragma unroll 4
    for (int64_t d = 1; d < D; ++d)
      m = min4(m, load4(r + d * owner_stride + i));
    if (s != nullptr) store4(s + i, m);
    if (h == nullptr) {
      store4(o + i, m);
    } else {
      const int4 hv = load4(h + i), cv = load4(c + i);
      store4(o + i, make_int4(m.x < hv.x ? m.x : cv.x, m.y < hv.y ? m.y : cv.y,
                              m.z < hv.z ? m.z : cv.z,
                              m.w < hv.w ? m.w : cv.w));
    }
  }
  const int64_t tail = head + 4 * W4;
  for (int64_t j = t; j < head + (W - tail); j += step) {
    const int64_t i = j < head ? j : tail + (j - head);
    const int32_t cand = fold(r, D, owner_stride, i);
    if (s != nullptr) s[i] = cand;
    o[i] = h == nullptr ? cand : (cand < h[i] ? cand : c[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
routed_climb_kernel(const Runs runs, int64_t rows,
                    const int32_t* start, const int32_t* __restrict__ hi,
                    int32_t* out, int32_t* __restrict__ nw, int64_t m,
                    int32_t n, const int64_t* st) {
  if (halted(st)) return;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const int32_t h = hi[i];
    int32_t cur = start[i];
    bool first = nw != nullptr;
    for (int r = 0; r < runs.count; ++r) {
      const int32_t* t = runs.table[r];
      for (int k = 0; k < runs.steps[r]; ++k) {
        const int32_t cand = (cur >= 0 && cur < rows) ? __ldg(t + cur) : n;
        if (first) nw[i] = cand;
        first = false;
        if (cand < h && cand != cur)
          cur = cand;
        else
          break;  // the rest of the run loads this same entry
      }
    }
    out[i] = cur;
  }
}

__global__ void __launch_bounds__(kThreads)
routed_square_kernel(const int32_t* __restrict__ t, int64_t rows,
                     int32_t* __restrict__ out, int32_t n,
                     const int64_t* st) {
  if (halted(st)) return;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += step) {
    const int32_t q = t[i];
    out[i] = (q >= 0 && q < rows) ? __ldg(t + q) : n;
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

Wave wave_gather, wave_scatter, wave_step, wave_end, wave_climb,
    wave_square, wave_card;

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
         W > 0x7FFFFFFFLL || D * W > 0x7FFFFFFFLL * 4 ||
         (long long)S * B > 0x7FFFFFFFLL;
}

cudaError_t launch_scatter_card(int32_t* table, long long rows,
                                const int32_t* lo, const int32_t* val,
                                long long m, int32_t* old, int n,
                                const int64_t* st, cudaStream_t s) {
  unsigned blocks = 0;
  cudaError_t err = wave_blocks(wave_card, scatter_card_kernel, m, &blocks);
  if (err != cudaSuccess) return err;
  int64_t rows64 = rows, m64 = m;
  int32_t n32 = n;
  void* args[] = {&table, &rows64, (void*)&lo, (void*)&val, &m64, &old,
                  &n32, (void*)&st};
  return cudaLaunchCooperativeKernel((const void*)scatter_card_kernel,
                                     dim3(blocks), dim3(kThreads), args, 0,
                                     s);
}

cudaError_t launch_climb(const Runs& runs, long long rows,
                         const int32_t* start, const int32_t* hi,
                         int32_t* out, int32_t* nw, long long m, int n,
                         const int64_t* st, cudaStream_t s) {
  unsigned blocks = 0;
  cudaError_t err = wave_blocks(wave_climb, routed_climb_kernel, m, &blocks);
  if (err != cudaSuccess) return err;
  routed_climb_kernel<<<blocks, kThreads, 0, s>>>(
      runs, rows, start, hi, out, nw, m, (int32_t)n, st);
  return cudaGetLastError();
}

cudaError_t launch_square(const int32_t* t, long long rows, int32_t* out,
                          int n, const int64_t* st, cudaStream_t s) {
  unsigned blocks = 0;
  cudaError_t err =
      wave_blocks(wave_square, routed_square_kernel, rows, &blocks);
  if (err != cudaSuccess) return err;
  routed_square_kernel<<<blocks, kThreads, 0, s>>>(t, rows, out, (int32_t)n,
                                                   st);
  return cudaGetLastError();
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

// Answers mode: old (S, D, W) = the answers before, table[lo - first B]
// <- min(..., val) over the owned requests, new (S, D, W) = the answers
// after: three launches in stream order.
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

// Card mode: the table (rows entries) is every shard's block, old (m) =
// table[lo] before, then table[lo] <- min(..., val): one cooperative
// launch.
extern "C" int sheep_scatter_card(void* table, long long rows, const void* lo,
                                  const void* val, long long m, void* old,
                                  int n, const void* st, void* stream) {
  if (rows <= 0 || rows > 0x7FFFFFFFLL || m < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  return (int)launch_scatter_card((int32_t*)table, rows, (const int32_t*)lo,
                                  (const int32_t*)val, m, (int32_t*)old, n,
                                  (const int64_t*)st, (cudaStream_t)stream);
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
  cudaError_t err =
      grid2d(wave_step, routed_step_kernel, (W + 3) / 4, R, &grid);
  if (err != cudaSuccess) return (int)err;
  routed_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rep, D, owner_stride, req_stride, W,
      (const int32_t*)hi, (const int32_t*)cur_in, (int32_t*)out,
      (int32_t*)store, (const int64_t*)st);
  return (int)cudaGetLastError();
}

// out (m) = the climb of the m slots from start over `count` runs (tables
// of rows entries each, steps[r] steps of tables[r]) below hi; out may be
// start. nw (m, or null) = the first step's candidate.
extern "C" int sheep_routed_climb(int count, void* const* tables,
                                  const int* steps, long long rows,
                                  const void* start, const void* hi,
                                  void* out, void* nw, long long m, int n,
                                  const void* st, void* stream) {
  if (count < 1 || count > kMaxRuns || rows <= 0 || rows > 0x7FFFFFFFLL ||
      m < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Runs runs{};
  runs.count = count;
  for (int r = 0; r < count; ++r) {
    runs.table[r] = (const int32_t*)tables[r];
    runs.steps[r] = steps[r];
  }
  return (int)launch_climb(runs, rows, (const int32_t*)start,
                           (const int32_t*)hi, (int32_t*)out, (int32_t*)nw, m,
                           n, (const int64_t*)st, (cudaStream_t)stream);
}

// out (rows) = t[t] (n past the table); out is another buffer.
extern "C" int sheep_routed_square(const void* t, long long rows, void* out,
                                   int n, const void* st, void* stream) {
  if (rows <= 0 || rows > 0x7FFFFFFFLL || t == out)
    return (int)cudaErrorInvalidValue;
  return (int)launch_square((const int32_t*)t, rows, (int32_t*)out, n,
                            (const int64_t*)st, (cudaStream_t)stream);
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
// 0, S = D), where the table P (D, B) is the whole table and the min over
// the owners' answers to a request is P's own entry: the scatter-min in
// card mode (the folded pre-round parents into old), then the `steps`
// launches of the round's plan (ops/routed.py round_plan): kind 0 the
// climb from lo, whose first step's candidate (the post-round parent)
// goes to nw, over the runs tables[arg[e] .. arg[e] + narg[e]) of
// counts[...] steps each; kind 1 the same from cur; kind 2 the squaring
// tables[arg[e]] -> tables[arg[e] + 1]; then the round's end with old as
// the one owner's answers and the segment's accounting. One host call
// enqueues the round's 1 + steps + 2 launches. Slots lo, hi, cur, nw, old
// are (D, Q); the tables (D, B).
extern "C" int sheep_routed_round(void* P, long long B, long long D, int n,
                                  void* lo, void* hi, void* cur, void* nw,
                                  void* old, long long Q, int steps,
                                  const int* kind, const int* arg,
                                  const int* narg, void* const* tables,
                                  const int* counts, void* st,
                                  long long budget, void* stream) {
  if (bad_shape(B, D, Q, (int)D) || Q == 0 || st == nullptr ||
      B * D > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = B * D, m = D * Q;
  const int64_t* state = (const int64_t*)st;
  cudaError_t err = launch_scatter_card(
      (int32_t*)P, rows, (const int32_t*)lo, (const int32_t*)hi, m,
      (int32_t*)old, n, state, s);
  if (err != cudaSuccess) return (int)err;
  for (int e = 0; e < steps; ++e) {
    if (kind[e] == kPlanSquare) {
      err = launch_square((const int32_t*)tables[arg[e]], rows,
                          (int32_t*)tables[arg[e] + 1], n, state, s);
    } else {
      if (narg[e] < 1 || narg[e] > kMaxRuns)
        return (int)cudaErrorInvalidValue;
      Runs runs{};
      runs.count = narg[e];
      for (int r = 0; r < narg[e]; ++r) {
        runs.table[r] = (const int32_t*)tables[arg[e] + r];
        runs.steps[r] = counts[arg[e] + r];
      }
      const bool from_lo = kind[e] == kPlanFirst;
      err = launch_climb(runs, rows, (const int32_t*)(from_lo ? lo : cur),
                         (const int32_t*)hi, (int32_t*)cur,
                         from_lo ? (int32_t*)nw : nullptr, m, n, state, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  int rc = sheep_routed_round_end(old, 1, 0, Q, Q, nw, cur, lo, hi, n, 0,
                                  (int)D, st, kFold, 0, stream);
  if (rc) return rc;
  return sheep_routed_round_end(nullptr, D, 0, 0, 0, nullptr, nullptr,
                                nullptr, nullptr, n, 0, (int)D, st, kAccount,
                                budget, stream);
}

extern "C" const char* sheep_routed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
