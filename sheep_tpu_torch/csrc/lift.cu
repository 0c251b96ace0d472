// The fixpoint round's lifting work:
//
//   lift_stack      the lifting stack t_{j+1} = t_j[t_j] (t_0 = P): the
//                   whole ladder in one persistent launch, its levels
//                   apart by grid-wide barriers, stopping at the first
//                   all-n level;
//   stream_descent  the stream descent's climb and squaring, level by
//                   level in the same kind of launch, on two rows in
//                   place of the stack;
//   climb_tail      one fused pass per round over the slots: the binary-
//                   lifting climb, retire, displace, the round's `changed`
//                   flag and its retired and live counts;
//   climb_jumps     the same pass with the jump-mode climb: up to `jumps`
//                   single parent steps over the current table in place
//                   of the stack.
//
// They are the counterparts of _pos_round_body after its scatter-min
// (sheep_tpu/ops/elim.py:158-192; its stream branch, :166-171, is
// stream_descent), of build_lift_tables (:295), of the stale round
// _pos_round_body_stale after its scatter (:222; climb_tail over a stack
// built once a segment, its level 0 the current table), and of the
// jump-mode round _pos_small_round_body after its scatter (:359).
//
// Control word ctl (int32[5]): [0] rows, the number of stack rows that
// hold distinct levels (the depth d less one); [1] changed; [2] retired;
// [3] live; [4] the blocks of climb_tail that have finished. lift_stack
// zeroes all five and writes [0]; stream_descent writes L - 1 to [0] and
// zeroes the rest; climb_tail reads [0] and adds to [1..4].
//
// Depth cut. Level j computes t_{j+1} from t_j; rows is raised to j + 1
// when some entry differs from t_j, so rows = d - 1 counts the distinct
// levels. The climb applies levels d-1 .. 0: applying an idempotent table
// twice moves no slot (cand = t[t[x]] = t[x] = cur), so this is bit for
// bit the climb over L-1 .. 0.
//
// Where the ladder stops. In position space P[p] lies in (p, n] and P[n]
// = n, and squaring keeps that (t[t[p]] > t[p] > p, or n). So n is the
// only fixed point, and a table is idempotent exactly when every entry is
// n: an entry t[p] = q < n has t[q] > q = t[p], so t[t[p]] != t[p]; and an
// all-n table maps every entry to t[n] = n. The first all-n level t_a is
// therefore the last distinct one (rows = a), and every level above it
// equals it. So each block also votes on whether any entry it wrote is
// other than n, and a level that wrote none ends the ladder: t_{a+1},
// which equals t_a, is never computed, and rows keeps its value. A level
// with no entry changed ends it as well (the only stop on a table outside
// position space, where it is the one the per-level ladder made). Edge
// cases: P all-n computes one level (rows 0); no all-n level among
// t_1 .. t_{L-1} computes all L-1 (rows L-1); L = 1 computes none.
//
// One launch a ladder. The kernel is launched cooperatively over one wave
// of co-resident blocks (the launch fails, and the wrapper raises, if the
// card will not hold them together) and loops over the levels. Between
// levels a grid-wide barrier on a small scratch buffer of the wrapper's:
// each block's thread 0 adds one 64-bit word that carries its arrival and
// its two votes (acquire-release); the block that arrives last sees every
// vote, writes rows to ctl, zeroes the count and releases the next
// generation with the stop bit, which the others wait for (acquire). The
// count is zero again when the kernel ends; ctl is zeroed by block 0
// before its first arrival, so no separate memset. A wait that outlasts
// kBarrierTimeoutNs traps instead of hanging the card.
//
// The level. On the table of the R-MAT s22 build's own forest a level's
// 2-2.4 M entries below n reach about 2 M distinct 32-byte sectors (a
// warp's 128 entries reach some 110 sectors): the gathers are random
// reads of L2, 64 MB of sectors a level beside the 33.6 MB stream of
// the row read and written, and they bound it (an H100 at 700 W: 0.0198
// ms a level against a row copy's 0.0077 on the same grid). An entry n
// needs no gather (its result is t[n], read once a level), which
// measured 2-4% faster there. Of 1, 2 or 4 quads in flight a thread,
// blocks of 256 or 1024 threads and L2 eviction hints (evict_last on the
// row written, evict_first on the row read), two quads and blocks of 1024
// with no hints were the fastest on that table, within 1-5% of the rest
// (PERF.md, section 6).
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
// The stream descent (the round when the stack would pass the table
// budget, ops/elim.py): levels j = 0 .. L-1 in ascending order, each the
// climb over t_j (cur <- t_j[cur] where that is below hi, cur starting at
// lo) and, below L-1, the squaring t_{j+1} = t_j[t_j] into the other of
// two rows (never in place: a slot would read entries already advanced).
// Both read t_j alone, so one grid barrier a level suffices. The climb
// writes the climbed positions `pre` at the live slots, which climb_tail
// reads in place of climbing a stack. In position space a slot's step
// that does not move is its last (its ancestors at the levels above are
// higher still), so the descent keeps a mask of the slots still moving,
// one bit a slot: level 0 streams lo a warp at a time (32 slots a group,
// kDescentGroups groups in flight) and writes it, the levels above read
// 4 B of it for 32 slots, climb only the groups with a bit set
// (kDescentGroups in flight a warp) and clear the bits of the slots that
// stopped. The levels stop at the first barrier after which no slot is
// moving, or where the ladder stops: a level t_{j+1} all n (every later
// one is, and cand = n < hi never holds) or equal to t_j (idempotent:
// applying it again moves no slot, as in the depth cut above). ctl's rows
// stay L - 1 however early it stops, so the round log's depth is the
// reference's L. On a median round (8 live of 2^23 slots) the climb is
// the 1 MB of mask a level and the squarings stop once those few slots
// do; at 100% live a level moves hi and pre (12 B a slot with pre's
// store) of the slots still moving, as climb_level, the kernel this
// replaced, moved at every slot and every level.
//
// climb_jumps runs on the adaptive driver's small buffers (at most 2^14
// slots after compaction): up to `jumps` dependent loads a climbing slot,
// each a random 4-byte read of P, so it is bound by their latency, not by
// bytes; one thread a slot keeps every slot's chain in flight at once. A
// step that does not move (cand >= hi) leaves cur as it was, so every
// later step would read the same cand: the chain ends there, exactly.
// Its bound is the larger of its bytes (lo in and two outputs back, 12 B
// a slot, hi at the live slots, old_at_lo at the retiring ones, and a
// sector of P for each step a climbing slot takes) and its chain: the
// launch floor and the longest chain's dependent loads at the card's
// latency (chip_smoke.py measures both with `chase`).
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers and its CUDA stream and gets back the
// first CUDA error of its launches (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// The grid barrier's scratch (int32[kBarWords], zero when first
// allocated): the arrival count and the votes in one 64-bit word at
// kBarCount, the generation on a line of its own at kBarGen.
constexpr int kBarCount = 0;
constexpr int kBarGen = 32;
constexpr int kBarWords = 64;
constexpr int kVoteBits = 16;  // a field of the word: up to 2^16 - 1 blocks
constexpr unsigned long long kField = (1ull << kVoteBits) - 1;
constexpr unsigned long long kBarrierTimeoutNs = 10000000000ull;
// the level's shape (PERF.md, section 6): blocks of 1024 threads, two
// 16-byte loads a thread in flight
constexpr int kLadderBlock = 1024;
constexpr int kLadderQuads = 2;
// the stream descent's climb: groups of 32 slots a warp has in flight
constexpr int kDescentGroups = 4;

__device__ __forceinline__ unsigned long long arrive(unsigned long long* p,
                                                     unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier after level j, on thread 0 of every block, with the block's
// votes: some entry changed (diff), some entry written is not n (live),
// and (the stream descent's) some slot may climb on (more). Returns 1
// when the levels stop after this one: no entry changed, none written
// other than n, or no slot left to climb. The last block to arrive writes
// rows = j + 1 to ctl (when not null) if any entry changed.
__device__ unsigned level_barrier(int32_t* bar, bool diff, bool live,
                                  bool more, int j, int32_t* ctl) {
  auto* count = reinterpret_cast<unsigned long long*>(bar + kBarCount);
  auto* gen = reinterpret_cast<unsigned*>(bar + kBarGen);
  // the generation cannot move before this block arrives
  const unsigned g = *reinterpret_cast<volatile unsigned*>(gen);
  const unsigned long long add = 1ull |
                                 (unsigned long long)diff << kVoteBits |
                                 (unsigned long long)live << 2 * kVoteBits |
                                 (unsigned long long)more << 3 * kVoteBits;
  __threadfence();  // the block's level, written before bar.sync
  const unsigned long long tot = arrive(count, add) + add;
  if ((tot & kField) == gridDim.x) {
    const bool any_diff = (tot >> kVoteBits) & kField;
    const bool any_live = (tot >> 2 * kVoteBits) & kField;
    const bool any_more = (tot >> 3 * kVoteBits) & kField;
    if (any_diff && ctl != nullptr) ctl[kRows] = j + 1;
    *reinterpret_cast<volatile unsigned long long*>(count) = 0;
    const unsigned stop = any_diff && any_live && any_more ? 0u : 1u;
    store_release(gen, ((g & ~1u) + 2u) | stop);
    return stop;
  }
  const unsigned long long t0 = global_ns();
  unsigned now;
  while (((now = load_acquire(gen)) >> 1) == (g >> 1)) {
    __nanosleep(64);
    if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
  }
  __threadfence();
  return now & 1u;
}

// t[clip(v)], but an entry n (v == last) takes top = t[n] with no gather
__device__ __forceinline__ int32_t lift_one(const int32_t* t, int32_t v,
                                            int32_t last, int32_t top) {
  return v == last ? top : t[clip(v, last)];
}

// One squaring level dst = src[src] over T entries, this thread's share
// of the grid (thread tid of step): kLadderQuads 16-byte loads of the
// source row in flight an iteration before their gathers, a scalar tail
// for the last T % 4 entries. Adds the thread's votes to diff (some entry
// changed) and live (some entry written is not n). The source row may
// have been written in this launch, so it is read with plain (coherent)
// loads, never through the read-only path.
__device__ __forceinline__ void square_level(const int32_t* src,
                                             int32_t* dst, int64_t T,
                                             int64_t tid, int64_t step,
                                             bool& diff, bool& live) {
  const int32_t last = (int32_t)(T - 1);
  const int64_t quads = T >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  const int32_t top = src[last];
  for (int64_t q0 = tid; q0 < quads; q0 += step * kLadderQuads) {
    int4 v[kLadderQuads], w[kLadderQuads];
#pragma unroll
    for (int i = 0; i < kLadderQuads; ++i)
      if (q0 + i * step < quads) v[i] = s4[q0 + i * step];
#pragma unroll
    for (int i = 0; i < kLadderQuads; ++i) {
      if (q0 + i * step >= quads) continue;
      w[i].x = lift_one(src, v[i].x, last, top);
      w[i].y = lift_one(src, v[i].y, last, top);
      w[i].z = lift_one(src, v[i].z, last, top);
      w[i].w = lift_one(src, v[i].w, last, top);
    }
#pragma unroll
    for (int i = 0; i < kLadderQuads; ++i) {
      if (q0 + i * step >= quads) continue;
      d4[q0 + i * step] = w[i];
      diff |= (w[i].x != v[i].x) | (w[i].y != v[i].y) |
              (w[i].z != v[i].z) | (w[i].w != v[i].w);
      live |= (w[i].x != last) | (w[i].y != last) | (w[i].z != last) |
              (w[i].w != last);
    }
  }
  const int64_t p = (quads << 2) + tid;
  if (p < T) {
    const int32_t v = src[p];
    const int32_t w = lift_one(src, v, last, top);
    dst[p] = w;
    diff |= w != v;
    live |= w != last;
  }
}

// The grid barrier after level j for the whole block: the block's votes
// gathered, thread 0 at the barrier. Returns whether the levels stop.
__device__ __forceinline__ bool block_barrier(int32_t* bar, bool diff,
                                              bool live, bool more, int j,
                                              int32_t* ctl, unsigned* stop) {
  diff = __syncthreads_or(diff);
  live = __syncthreads_or(live);
  more = __syncthreads_or(more);
  if (threadIdx.x == 0) *stop = level_barrier(bar, diff, live, more, j, ctl);
  __syncthreads();
  return *stop != 0;
}

// The ladder: levels t_1 .. t_{levels-1} of P into the stack (row k-1
// holds t_k); a grid barrier after every level.
__global__ void __launch_bounds__(kLadderBlock)
lift_ladder(const int32_t* P, int32_t* stack, int64_t stride, int64_t T,
            int levels, int32_t* ctl, const int64_t* ex, int32_t* bar) {
  __shared__ unsigned stop;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int w = 0; w < sheep::kCtlWords; ++w) ctl[w] = 0;
  if (sheep::stopped(ex)) return;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int j = 0; j + 1 < levels; ++j) {
    const int32_t* src = j == 0 ? P : stack + (int64_t)(j - 1) * stride;
    bool diff = false, live = false;
    square_level(src, stack + (int64_t)j * stride, T, tid, step, diff, live);
    if (block_barrier(bar, diff, live, true, j, ctl, &stop)) break;
  }
}

// The stream descent's level-0 climb over P: each warp takes
// kDescentGroups groups of 32 slots at once (lo loaded for all of them,
// then hi and P[lo] for the live ones, before any is looked at), climbs
// the live lanes one level, pre = P[lo] where that is below hi, else lo,
// and stores each group's vote of the lanes that moved in mask: a slot
// that did not move never will (see stream_descent). The loop bound is
// the warp's, so the votes see the whole warp. Returns whether a slot of
// this thread moved.
__device__ __forceinline__ bool descent_first(
    const int32_t* __restrict__ P, int32_t last, const int32_t* lo,
    const int32_t* hi, int64_t m, int32_t* pre, unsigned* mask,
    int64_t warp, int64_t warps, int lane) {
  const int64_t groups = (m + 31) >> 5;
  bool more = false;
  for (int64_t g0 = warp * kDescentGroups; g0 < groups;
       g0 += warps * kDescentGroups) {
    int32_t l[kDescentGroups];
#pragma unroll
    for (int u = 0; u < kDescentGroups; ++u) {
      const int64_t s = ((g0 + u) << 5) + lane;
      l[u] = s < m ? __ldg(lo + s) : last;
    }
    int32_t h[kDescentGroups], c[kDescentGroups];
#pragma unroll
    for (int u = 0; u < kDescentGroups; ++u) {
      const int64_t s = ((g0 + u) << 5) + lane;
      h[u] = l[u] != last ? __ldg(hi + s) : 0;
      c[u] = l[u] != last ? __ldg(P + clip(l[u], last)) : 0;
    }
#pragma unroll
    for (int u = 0; u < kDescentGroups; ++u) {
      const bool up = l[u] != last && c[u] < h[u];
      const unsigned vote = __ballot_sync(0xffffffffu, up);
      if (lane == u && g0 + u < groups) mask[g0 + u] = vote;
      if (l[u] != last) pre[((g0 + u) << 5) + lane] = up ? c[u] : l[u];
      more |= up;
    }
  }
  return more;
}

// The climb of a level above 0 over t (written in this launch: plain
// loads): each warp reads 32 words of mask at once (1024 slots) and
// climbs the groups with a slot still moving, kDescentGroups at a time;
// a group whose slots stopped moving gets its word back with their bits
// cleared. Returns whether a slot of this thread moved.
__device__ __forceinline__ bool descent_next(
    const int32_t* t, int32_t last, const int32_t* hi, int64_t m,
    int32_t* pre, unsigned* mask, int64_t warp, int64_t warps, int lane) {
  const int64_t groups = (m + 31) >> 5;
  bool more = false;
  for (int64_t w0 = warp << 5; w0 < groups; w0 += warps << 5) {
    const unsigned word = w0 + lane < groups ? mask[w0 + lane] : 0u;
    unsigned todo = __ballot_sync(0xffffffffu, word != 0);
    while (todo) {
      int64_t s[kDescentGroups];
      int b[kDescentGroups];
      unsigned bits[kDescentGroups];
#pragma unroll
      for (int u = 0; u < kDescentGroups; ++u) {
        b[u] = todo ? __ffs(todo) - 1 : -1;
        bits[u] = __shfl_sync(0xffffffffu, word, b[u] < 0 ? 0 : b[u]);
        if (b[u] < 0) bits[u] = 0;
        todo &= todo - 1;
        s[u] = ((w0 + (b[u] < 0 ? 0 : b[u])) << 5) + lane;
      }
      int32_t h[kDescentGroups], c[kDescentGroups];
#pragma unroll
      for (int u = 0; u < kDescentGroups; ++u) {
        const bool on = bits[u] >> lane & 1u;
        h[u] = on ? __ldg(hi + s[u]) : 0;
        c[u] = on ? pre[s[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < kDescentGroups; ++u) {
        const bool on = bits[u] >> lane & 1u;
        const int32_t cand = on ? t[clip(c[u], last)] : 0;
        const bool up = on && cand < h[u];
        if (up) pre[s[u]] = cand;
        const unsigned vote = __ballot_sync(0xffffffffu, up);
        if (lane == 0 && vote != bits[u]) mask[w0 + b[u]] = vote;
        more |= up;
      }
    }
  }
  return more;
}

// The stream descent of one round: ctl set to [levels - 1, 0, 0, 0, 0],
// then levels 0 .. levels-1, each the climb over t_j (t_0 = P, t_j for j
// >= 1 in row (j-1) % 2) and, below the last, the squaring into row j % 2
// and a grid barrier. In position space (P[p] in (p, n], so t_{j+1}[x] =
// t_j[t_j[x]] >= t_j[x]) a slot whose step at level j does not move
// (t_j[cur] >= hi) will not move at any level above, where cur's
// ancestors are higher still: so the mask keeps the slots still moving,
// and the levels stop at the barrier after which none is, or after the
// first level squared all n or equal to the one before. Nothing at all
// once the execution has stopped.
__global__ void __launch_bounds__(kLadderBlock)
stream_descent(const int32_t* P, int32_t* rows, int64_t stride, int64_t T,
               const int32_t* lo, const int32_t* hi, int64_t m,
               int64_t row_stride, int32_t* pre, unsigned* mask, int levels,
               int32_t* ctl, const int64_t* ex, int32_t* bar) {
  __shared__ unsigned stop;
  if (sheep::stopped(ex)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[kRows] = levels - 1;
    for (int w = kRows + 1; w < sheep::kCtlWords; ++w) ctl[w] = 0;
  }
  const int64_t off = sheep::row_offset(ex, row_stride);
  lo += off;
  hi += off;
  const int32_t last = (int32_t)(T - 1);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < levels; ++j) {
    const int32_t* src = j == 0 ? P : rows + (int64_t)((j - 1) & 1) * stride;
    const bool more =
        j == 0
            ? descent_first(P, last, lo, hi, m, pre, mask, tid >> 5,
                            step >> 5, lane)
            : descent_next(src, last, hi, m, pre, mask, tid >> 5, step >> 5,
                           lane);
    if (j + 1 == levels) break;
    bool diff = false, live = false;
    square_level(src, rows + (int64_t)(j & 1) * stride, T, tid, step, diff,
                 live);
    if (block_barrier(bar, diff, live, more, j, nullptr, &stop)) break;
  }
}

// A pointer chase on one thread of a grid of `blocks` blocks: `steps`
// dependent loads cur <- t[cur] from `start`, the end written to out; with
// 0 steps the grid does nothing (an empty kernel: the launch floor). The
// yardsticks of climb_jumps' chain (chip_smoke.py phase 3e).
__global__ void __launch_bounds__(kThreads)
chase(const int32_t* t, int32_t last, int32_t start, int steps,
      int32_t* out) {
  if (steps == 0 || blockIdx.x != 0 || threadIdx.x != 0) return;
  int32_t cur = start;
  for (int k = 0; k < steps; ++k) cur = __ldg(t + clip(cur, last));
  *out = cur;
}

// One row copied (T read, T written) on the ladder's grid: the stream
// floor that a level's time is held against (chip_smoke.py phase 3c).
__global__ void __launch_bounds__(kLadderBlock)
copy_row(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
         int64_t T) {
  const int64_t quads = T >> 2;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int64_t q = tid; q < quads; q += step) d4[q] = __ldg(s4 + q);
  const int64_t p = (quads << 2) + tid;
  if (p < T) dst[p] = src[p];
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
          // a step that does not move leaves cur, and so every later
          // step's cand, as it was
          for (int j = 0; j < jumps; ++j) {
            const int32_t cand = __ldg(P + cur);
            if (cand >= h) break;
            cur = cand;
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

Wave wave_lift, wave_descent, wave_climb, wave_jumps;

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

cudaError_t ladder_grid(long long T, int levels, unsigned* blocks) {
  if (levels < 2) {  // nothing but ctl to zero
    *blocks = 1;
    return cudaSuccess;
  }
  return wave_blocks(wave_lift, lift_ladder,
                     (T / 4 + kLadderQuads - 1) / kLadderQuads, blocks,
                     kLadderBlock);
}

}  // namespace

// The ladder of one round in one cooperative launch: ctl zeroed, then
// levels t_1 .. t_{levels-1} into the stack, row k-1 (at stack +
// (k-1)*stride) holding t_k, up to the first all-n level. ex: the
// execution's state or null; bar: the barrier's int32[kBarWords] scratch,
// zero when allocated, used by one ladder at a time. A launch the card
// refuses (the wave not co-resident) returns its error.
extern "C" int sheep_lift_stack(const void* P, long long T, void* stack,
                                long long stride, int levels, void* ctl,
                                const void* ex, void* bar, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL || levels < 1 || levels > 32)
    return (int)cudaErrorInvalidValue;
  if (stride < T || stride % 4 || !aligned16(P) || !aligned16(stack))
    return (int)cudaErrorMisalignedAddress;
  unsigned blocks = 0;
  cudaError_t err = ladder_grid(T, levels, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int32_t* p = (const int32_t*)P;
  int32_t* st = (int32_t*)stack;
  int64_t stride64 = stride, T64 = T;
  int32_t* c = (int32_t*)ctl;
  const int64_t* e = (const int64_t*)ex;
  int32_t* b = (int32_t*)bar;
  void* args[] = {&p, &st, &stride64, &T64, &levels, &c, &e, &b};
  return (int)cudaLaunchCooperativeKernel((const void*)lift_ladder,
                                          dim3(blocks), dim3(kLadderBlock),
                                          args, 0, (cudaStream_t)stream);
}

extern "C" int sheep_lift_bar_words() { return kBarWords; }

// The ladder's grid for T entries: blocks (one wave) and threads a block.
extern "C" int sheep_lift_grid(long long T, int* blocks, int* threads) {
  unsigned b = 0;
  const cudaError_t err = ladder_grid(T, 2, &b);
  *blocks = (int)b;
  *threads = kLadderBlock;
  return (int)err;
}

// One row of T entries copied on the ladder's grid: the stream floor of a
// level.
extern "C" int sheep_lift_copy_row(const void* src, void* dst, long long T,
                                   void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (!aligned16(src) || !aligned16(dst))
    return (int)cudaErrorMisalignedAddress;
  unsigned blocks = 0;
  const cudaError_t err = ladder_grid(T, 2, &blocks);
  if (err != cudaSuccess) return (int)err;
  copy_row<<<blocks, kLadderBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, T);
  return (int)cudaGetLastError();
}

// The stream descent of one round in one cooperative launch: ctl set to
// [levels - 1, 0, 0, 0, 0], pre (m slots) written at the live slots of lo
// (lo != T - 1) with their climb over `levels` levels of P, the squared
// levels in the two rows at rows and rows + stride, the live mask in mask
// (one bit a slot, (m + 31) / 32 words). ex: the execution's state or
// null; row_stride: the blocks' row length when lo and hi are [N, C]
// blocks, else 0; bar: the barrier's scratch, as sheep_lift_stack's. A
// launch the card refuses (the wave not co-resident) returns its error.
extern "C" int sheep_stream_descent(const void* P, long long T, void* rows,
                                    long long stride, const void* lo,
                                    const void* hi, long long m,
                                    long long row_stride, void* pre,
                                    void* mask, int levels, void* ctl,
                                    const void* ex, void* bar, void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL || levels < 1 || levels > 32 || m <= 0 ||
      m > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (levels > 1 && (stride < T || stride % 4 || !aligned16(P) ||
                     !aligned16(rows) ||
                     !aligned16((const int32_t*)rows + stride)))
    return (int)cudaErrorMisalignedAddress;
  unsigned blocks = 0;
  const long long work = std::max((T / 4 + kLadderQuads - 1) / kLadderQuads,
                                  (m + kDescentGroups - 1) / kDescentGroups);
  cudaError_t err = wave_blocks(wave_descent, stream_descent, work, &blocks,
                                kLadderBlock);
  if (err != cudaSuccess) return (int)err;
  const int32_t* p = (const int32_t*)P;
  int32_t* r = (int32_t*)rows;
  int64_t stride64 = stride, T64 = T, m64 = m, rs = row_stride;
  const int32_t* l = (const int32_t*)lo;
  const int32_t* h = (const int32_t*)hi;
  int32_t* out = (int32_t*)pre;
  unsigned* mk = (unsigned*)mask;
  int32_t* c = (int32_t*)ctl;
  const int64_t* e = (const int64_t*)ex;
  int32_t* b = (int32_t*)bar;
  void* args[] = {&p, &r, &stride64, &T64, &l, &h, &m64, &rs,
                  &out, &mk, &levels, &c, &e, &b};
  return (int)cudaLaunchCooperativeKernel((const void*)stream_descent,
                                          dim3(blocks), dim3(kLadderBlock),
                                          args, 0, (cudaStream_t)stream);
}

// A pointer chase of `steps` dependent loads over t (T entries) from
// `start` on one thread of `blocks` blocks of kThreads, its end in out;
// with 0 steps an empty kernel on that grid.
extern "C" int sheep_lift_chase(const void* t, long long T, int start,
                                int steps, void* out, int blocks,
                                void* stream) {
  if (T <= 0 || T > 0x7FFFFFFFLL || steps < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  chase<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t, (int32_t)(T - 1), start, steps, (int32_t*)out);
  return (int)cudaGetLastError();
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
