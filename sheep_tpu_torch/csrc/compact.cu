// compact_live: the live-pair compaction of the adaptive fixpoint driver,
// the counterpart of compact_actives(..., dedup=True)
// (sheep_tpu/ops/elim.py:1055), its two-key sort included; with dedup 0,
// of compact_actives(..., dedup=False), the sharded driver's.
//
// Input: the round's (lo, hi) pairs, int32, both in [0, n]. Output:
// out_lo, out_hi [size]: the pairs that are live (lo != n) and the first
// of their run of equal pairs (every pair with dedup 0), in ascending
// (lo, hi) order, then (n, n) up to size. A pair past size is dropped, as jnp.nonzero(..., size=size)
// drops it; the driver sizes size above the live count.
//
// Each pair is one key lo << b | hi, b the bits of n, so the keys sort
// alone (no permutation) over their 2b bits where the JAX package's
// lax.sort orders (lo, hi) as two keys. Only the live keys are sorted: a
// round's slots are mostly dead (90% at a 10% live share), and sorting
// them all was most of the call. One cooperative launch on the caller's
// stream, its phases apart by grid barriers; no host read and no library
// sort, the live count L staying on the card:
//   filter   a chunk of slots a block: its live slots counted, one
//            atomic reservation, then the live keys written (warp
//            ballots for the ranks; the order is free, the sort that
//            follows being stable), each counted at its digit of every
//            pass; out filled with (n, n). lo is read twice (the second
//            time mostly from L1), hi at the live slots.
//   starts   each pass's digit counts scanned into the digits' starts;
//            the look-back words of the tiles L needs zeroed.
//   passes   one 8-bit digit each, of a stable LSD radix sort in the
//            onesweep style: a block ranks a tile of keys by digit
//            (a warp's equal digits by a ballot a digit bit, the warps in
//            order through shared-memory counts), publishes the tile's
//            count of each digit at once, stages the keys in shared
//            memory in sorted order, learns each digit's keys in earlier
//            tiles by decoupled look-back (a 64-bit word a tile and
//            digit, windows of kWindow words loaded together) and writes
//            the staged keys in runs. Tiles of kTile keys, or of a
//            half or a quarter of that where one wave of blocks takes
//            them all.
//   unique   the sorted keys' first-of-run ones (all are live; every key
//            with dedup 0) written at their rank below size, the ranks by
//            the same look-back (a warp reads 32 tiles' words at once).
// Bound by bytes: lo read (4 B a slot), the 32 B sectors of hi that hold a
// live slot, and the outputs written (8 B a slot of size). On top: the live keys written by the filter, read and
// written by each sort pass, read by the compaction (8 B each time; 2b =
// 46 bits at n = 2^22, six passes), and (n, n) written once more where a
// pair lands. At C <= 2^22 the keys (32 MB in two buffers at most) stay
// mostly in L2. At a few live keys the barriers and the passes' latency
// set the time.
//
// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers, the scratch it allocated and its CUDA
// stream, and gets back the first CUDA error of the launches (0 if none).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sheep;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;  // one digit a thread
constexpr int kItems = 16;               // keys a thread a tile
constexpr int kTile = kThreads * kItems;
// fewer live keys: tiles of 4 or 8 keys a thread, the shortest that one
// wave of blocks takes all of (a shorter tile is less latency a pass)
constexpr int kSmallTile = kThreads * 4;
constexpr int kMaxSmallTiles = 1024;
constexpr int kFilterRows = 16;          // rows of 32 slots a warp loads
constexpr int kMaxPasses = 8;            // 2b <= 62 bits
static_assert(kRadix == kThreads, "a digit a thread");

// control words, zero between calls: the live keys L, then each pass's
// digit counts (its digits' starts once counted)
enum : int {
  kLive = 0,
  kHist = 1,
  kCompactCtl = kHist + kMaxPasses * kRadix,
};

// look-back words: the count in the low 32 bits, its kind above
constexpr uint64_t kAggregate = 1ull << 32;  // this tile's own count
constexpr uint64_t kInclusive = 2ull << 32;  // this and every earlier tile
// a look-back wait that outlasts this traps instead of hanging the card
constexpr unsigned long long kWaitTimeoutNs = 10000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A tile's count, published for the tiles after it: inclusive of every
// earlier tile's for tile 0, its own (an aggregate) for the others.
__device__ __forceinline__ void publish(uint64_t* word, int64_t tile,
                                        int64_t stride, uint32_t count) {
  store_relaxed(word + tile * stride, (tile ? kAggregate : kInclusive) | count);
}

// The earlier tiles' counts of one word column, for a tile that has
// published its own: walk back from tile - 1 over windows of kWindow
// words loaded together, adding aggregates up to and with the first
// inclusive word, and wait where a word is not yet written (an earlier
// tile is held by a running block, which waits only on tiles before its
// own; a wait past kWaitTimeoutNs traps). Then publish the tile's
// inclusive count.
constexpr int kWindow = 16;

__device__ uint32_t look_back(uint64_t* word, int64_t tile, int64_t stride,
                              uint32_t count) {
  if (tile == 0) return 0;
  uint32_t before = 0;
  const unsigned long long t0 = global_ns();
  for (int64_t j = tile - 1;;) {
    uint64_t w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      w[i] = j - i >= 0 ? load_relaxed(word + (j - i) * stride) : kInclusive;
    int i = 0;
    bool done = false;
#pragma unroll
    for (; i < kWindow; ++i) {
      if ((w[i] >> 32) == 0) break;
      before += (uint32_t)w[i];
      if (w[i] & kInclusive) {
        done = true;
        break;
      }
    }
    if (done) break;
    j -= i;
    if (i < kWindow && global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
  store_relaxed(word + tile * stride, kInclusive | (before + count));
  return before;
}

// The same for one word a tile, by a whole warp: lane i loads tile j - i,
// so a window is 32 tiles; every lane returns the sum.
__device__ uint32_t warp_look_back(uint64_t* word, int64_t tile,
                                   uint32_t count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) return 0;
  uint32_t before = 0;
  const unsigned long long t0 = global_ns();
  for (int64_t j = tile - 1;;) {
    const uint64_t w = j - lane >= 0 ? load_relaxed(word + j - lane)
                                     : kInclusive;
    const unsigned waiting = __ballot_sync(kFull, (w >> 32) == 0);
    const unsigned inclusive = __ballot_sync(kFull, (w & kInclusive) != 0);
    const int first_wait = waiting ? __ffs(waiting) - 1 : 32;
    const int first_incl = inclusive ? __ffs(inclusive) - 1 : 32;
    const int take = first_wait <= first_incl ? first_wait : first_incl + 1;
    before += __reduce_add_sync(kFull, lane < take ? (uint32_t)w : 0u);
    if (first_incl < first_wait) break;
    j -= take;
    if (take < 32 && global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
  if (lane == 0)
    store_relaxed(word + tile, kInclusive | (before + count));
  return before;
}

// The filter of the block's chunk of slots (rows of 32, row r to warp r
// mod kWarps): the live slots counted (lo read), one atomic reservation
// for the block, then the live keys written (lo again, mostly from L1,
// and hi at the live slots), each warp's in slot order from its own
// offset, each key counted in `count` (shared) at its digit of every
// pass. kFilterRows rows a warp are loaded before they are used.
__device__ void filter_chunk(const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int64_t m,
                             int32_t n, int b, int passes,
                             uint64_t* __restrict__ keys, int32_t* ctl,
                             int32_t* count, int32_t* warp_live,
                             int64_t* base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t rows_all = (m + 31) / 32;
  const int64_t per = (rows_all + gridDim.x - 1) / gridDim.x;
  const int64_t r0 = blockIdx.x * per;
  const int64_t r1 = r0 + per < rows_all ? r0 + per : rows_all;
  int live = 0;
  for (int64_t r = r0 + warp; r < r1; r += kWarps * kFilterRows) {
    int32_t l[kFilterRows];
#pragma unroll
    for (int u = 0; u < kFilterRows; ++u) {
      const int64_t i = (r + u * kWarps) * 32 + lane;
      l[u] = r + u * kWarps < r1 && i < m ? lo[i] : n;
    }
#pragma unroll
    for (int u = 0; u < kFilterRows; ++u)
      live += __popc(__ballot_sync(kFull, l[u] != n));
  }
  if (lane == 0) warp_live[warp] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_live[w];
    *base = total ? atomicAdd(ctl + kLive, total) : 0;
  }
  __syncthreads();
  int64_t at = *base;
  for (int w = 0; w < warp; ++w) at += warp_live[w];
  for (int64_t r = r0 + warp; r < r1; r += kWarps * kFilterRows) {
    int32_t l[kFilterRows], h[kFilterRows];
#pragma unroll
    for (int u = 0; u < kFilterRows; ++u) {
      const int64_t i = (r + u * kWarps) * 32 + lane;
      l[u] = r + u * kWarps < r1 && i < m ? lo[i] : n;
    }
#pragma unroll
    for (int u = 0; u < kFilterRows; ++u)  // hi of the live slots only
      h[u] = l[u] != n ? hi[(r + u * kWarps) * 32 + lane] : 0;
#pragma unroll
    for (int u = 0; u < kFilterRows; ++u) {
      const unsigned votes = __ballot_sync(kFull, l[u] != n);
      if (l[u] != n) {
        const uint64_t key = ((uint64_t)(uint32_t)l[u] << b) | (uint32_t)h[u];
        keys[at + __popc(votes & ((1u << lane) - 1u))] = key;
        for (int p = 0; p < passes; ++p)
          atomicAdd(count + p * kRadix +
                        (int)((key >> (p * kDigitBits)) & (kRadix - 1)),
                    1);
      }
      at += __popc(votes);
    }
  }
}

// Each pass's counts to exclusive starts, in place, a warp a pass
__device__ void digit_starts(int32_t* hist, int passes) {
  const int lane = threadIdx.x & 31;
  constexpr int per = kRadix / 32;
  for (int p = threadIdx.x >> 5; p < passes; p += kWarps) {
    int c[per], sum = 0;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      c[i] = __ldcg(hist + p * kRadix + lane * per + i);
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      hist[p * kRadix + lane * per + i] = run;
      run += c[i];
    }
  }
}

struct PassSmem {
  uint64_t staged[kTile];  // the filter's digit counts alias it
  int32_t warp_count[kWarps][kRadix];
  int32_t digit_start[kRadix];
  int64_t digit_base[kRadix];
  int32_t warp_sum[kWarps];
  int64_t base;
};

// One tile of a sort pass: its keys ranked by digit within each warp (in
// tile order), the tile's digit counts published, the keys staged in
// shared memory in sorted order, the digits' keys in earlier tiles by
// look-back, then written in runs: a key at staged position i to
// starts[digit] + (earlier tiles' keys of its digit) + i - (its digit's
// start in the tile).
template <int kIt>  // keys a thread
__device__ void pass_tile(const uint64_t* __restrict__ in,
                          uint64_t* __restrict__ out, int shift, int64_t L,
                          int64_t t, const int32_t* starts, uint64_t* look,
                          PassSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  constexpr int tile = kThreads * kIt;
  for (int w = 0; w < kWarps; ++w) sm.warp_count[w][threadIdx.x] = 0;
  __syncthreads();
  const int64_t first = t * tile + (int64_t)warp * 32 * kIt + lane;
  uint64_t key[kIt];
  int rank[kIt];
  // every key loaded before the first __syncwarp, which orders memory
#pragma unroll
  for (int it = 0; it < kIt; ++it)
    key[it] = first + it * 32 < L ? in[first + it * 32] : 0;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const bool valid = first + it * 32 < L;
    const int d = valid ? (int)((key[it] >> shift) & (kRadix - 1)) : kRadix;
    // the lanes with the same digit: a ballot a digit bit
    unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
    for (int bit = 0; bit < kDigitBits; ++bit) {
      const unsigned ones = __ballot_sync(kFull, (d >> bit) & 1);
      peers &= (d >> bit) & 1 ? ones : ~ones;
    }
    rank[it] = valid ? sm.warp_count[warp][d] + __popc(peers & below) : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      sm.warp_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: its digit's keys in earlier warps and in the tile, the
  // tile's count published at once, then the digit's start in the tile
  const int d = threadIdx.x;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = sm.warp_count[w][d];
    sm.warp_count[w][d] = total;
    total += c;
  }
  publish(look + d, t, kRadix, (uint32_t)total);
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sm.warp_sum[warp] = incl;
  __syncthreads();
  int start = incl - total;
  for (int w = 0; w < warp; ++w) start += sm.warp_sum[w];
  sm.digit_start[d] = start;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    if (first + it * 32 < L) {
      const int dd = (int)((key[it] >> shift) & (kRadix - 1));
      sm.staged[sm.digit_start[dd] + sm.warp_count[warp][dd] + rank[it]] =
          key[it];
    }
  }
  sm.digit_base[d] = (int64_t)__ldcg(starts + d) +
                     look_back(look + d, t, kRadix, (uint32_t)total) - start;
  __syncthreads();
  const int count = (int)(L - t * tile < tile ? L - t * tile : tile);
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const uint64_t k = sm.staged[i];
    out[sm.digit_base[(k >> shift) & (kRadix - 1)] + i] = k;
  }
  __syncthreads();  // staged and the tables are read
}

// One tile of the sorted keys: the first of each run (all are live; each
// key without dedup) written at its rank among them, if below size; the
// ranks of earlier tiles by look-back.
template <int kIt>
__device__ void unique_tile(const uint64_t* __restrict__ keys, int b,
                            int dedup, int64_t L, int64_t t, uint64_t* look,
                            int32_t* __restrict__ out_lo,
                            int32_t* __restrict__ out_hi, int64_t size,
                            PassSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t low = (1ull << b) - 1ull;
  const unsigned below = (1u << lane) - 1u;
  const int64_t first = t * kThreads * kIt + (int64_t)warp * 32 * kIt + lane;
  uint64_t key[kIt];
  unsigned votes[kIt];
  int kept = 0;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int64_t i = first + it * 32;
    bool k = false;
    key[it] = 0;
    if (i < L) {
      key[it] = keys[i];
      k = !dedup || i == 0 || keys[i - 1] != key[it];
    }
    votes[it] = __ballot_sync(kFull, k);
    kept += __popc(votes[it]);
  }
  if (lane == 0) sm.warp_sum[warp] = kept;
  __syncthreads();
  if (warp == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += sm.warp_sum[w];
    if (lane == 0) publish(look, t, 1, total);
    const uint32_t before = warp_look_back(look, t, total);
    if (lane == 0) sm.base = before;
  }
  __syncthreads();
  int64_t at = sm.base;
  for (int w = 0; w < warp; ++w) at += sm.warp_sum[w];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int64_t pos = at + __popc(votes[it] & below);
    if ((votes[it] >> lane & 1u) && pos < size) {
      out_lo[pos] = (int32_t)(key[it] >> b);
      out_hi[pos] = (int32_t)(key[it] & low);
    }
    at += __popc(votes[it]);
  }
  __syncthreads();  // warp_sum and base are read
}

// The whole compaction, one cooperative launch, its phases apart by grid
// barriers: the filter (and (n, n) over out), the digits' starts and the
// look-back words of the tiles L needs zeroed, each sort pass from one
// key buffer to the other, the first-of-run keys; a tile of a pass goes
// to block t mod grid, so an earlier tile is always held by a running
// block. The control words are left zero.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
               int64_t m, int32_t n, int b, int passes,
               uint64_t* __restrict__ keys_a, uint64_t* __restrict__ keys_b,
               int32_t* __restrict__ ctl, uint64_t* __restrict__ look,
               int64_t look_stride, int32_t* __restrict__ out_lo,
               int32_t* __restrict__ out_hi, int64_t size, int dedup) {
  __shared__ PassSmem sm;
  cg::grid_group grid = cg::this_grid();
  int32_t* count = reinterpret_cast<int32_t*>(sm.staged);
  for (int j = threadIdx.x; j < passes * kRadix; j += kThreads) count[j] = 0;
  __syncthreads();
  filter_chunk(lo, hi, m, n, b, passes, keys_a, ctl, count, sm.warp_sum,
               &sm.base);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < size;
       j += step) {
    out_lo[j] = n;
    out_hi[j] = n;
  }
  __syncthreads();  // every warp's counts are in
  for (int j = threadIdx.x; j < passes * kRadix; j += kThreads)
    if (count[j]) atomicAdd(ctl + kHist + j, count[j]);
  grid.sync();
  const int64_t L = __ldcg(ctl + kLive);
  const int64_t wave =
      gridDim.x < kMaxSmallTiles ? gridDim.x : kMaxSmallTiles;
  int items = kItems;
  for (int it = kItems / 2; it >= 4; it /= 2)
    if ((L + kThreads * it - 1) / (kThreads * it) <= wave) items = it;
  const int64_t tile_keys = (int64_t)kThreads * items;
  const int64_t tiles = (L + tile_keys - 1) / tile_keys;
  for (int p = 0; p <= passes; ++p) {
    const int64_t used = p < passes ? tiles * kRadix : tiles;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < used; j += step)
      look[p * look_stride + j] = 0;
  }
  if (blockIdx.x == 0) digit_starts(ctl + kHist, passes);
  grid.sync();
  for (int p = 0; p < passes; ++p) {
    const uint64_t* in = p % 2 ? keys_b : keys_a;
    uint64_t* out = p % 2 ? keys_a : keys_b;
    const int32_t* starts = ctl + kHist + p * kRadix;
    uint64_t* words = look + p * look_stride;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      if (items == 4)
        pass_tile<4>(in, out, p * kDigitBits, L, t, starts, words, sm);
      else if (items == 8)
        pass_tile<8>(in, out, p * kDigitBits, L, t, starts, words, sm);
      else
        pass_tile<kItems>(in, out, p * kDigitBits, L, t, starts, words, sm);
    }
    grid.sync();
  }
  // every block has read L and the starts: leave the words zero
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < kCompactCtl; j += kThreads) ctl[j] = 0;
  const uint64_t* sorted = passes % 2 ? keys_b : keys_a;
  uint64_t* words = look + passes * look_stride;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (items == 4)
      unique_tile<4>(sorted, b, dedup, L, t, words, out_lo, out_hi, size,
                     sm);
    else if (items == 8)
      unique_tile<8>(sorted, b, dedup, L, t, words, out_lo, out_hi, size,
                     sm);
    else
      unique_tile<kItems>(sorted, b, dedup, L, t, words, out_lo, out_hi,
                          size, sm);
  }
}

int passes_of(int b) { return (2 * b + kDigitBits - 1) / kDigitBits; }

}  // namespace

// Sizes of a call over m slots at b bits a half key (b = the bits of n):
// the sort's passes, the control words (int32, zero before the first
// call; every call leaves them zero) and the look-back words (uint64; row
// stride, rows passes + 1).
extern "C" int sheep_compact_passes(int b) { return passes_of(b); }
extern "C" int sheep_compact_ctl_words() { return kCompactCtl; }
extern "C" long long sheep_compact_look_stride(long long m) {
  long long tiles = (m + kTile - 1) / kTile;
  long long small = (m + kSmallTile - 1) / kSmallTile;
  if (small > kMaxSmallTiles) small = kMaxSmallTiles;
  if (small > tiles) tiles = small;
  return tiles * kRadix > 1 ? tiles * kRadix : 1;
}

// out_lo/out_hi [size] <- the live first-of-run pairs of (lo, hi) [m]
// (every live pair with dedup 0) in ascending order, then (n, n): one
// cooperative launch of at most the
// blocks the card holds at once. Scratch: keys uint64 [2 max(m, 1)] (two
// buffers), look uint64 [(passes + 1) * sheep_compact_look_stride(m)],
// ctl int32 [sheep_compact_ctl_words()].
extern "C" int sheep_compact_live(const void* lo, const void* hi, long long m,
                                  int n, int b, void* keys, void* look,
                                  void* ctl, void* out_lo, void* out_hi,
                                  long long size, int dedup, void* stream) {
  if (m < 0 || size < 0 || m > 0x7FFFFFFFLL || n < 0 || b < 1 || b > 31)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long chunks = (m + kThreads * 8 - 1) / (kThreads * 8);
  if (chunks < blocks) blocks = chunks > 0 ? chunks : 1;
  int64_t m64 = m, size64 = size;
  int passes = passes_of(b);
  int64_t stride = sheep_compact_look_stride(m);
  uint64_t* a = (uint64_t*)keys;
  uint64_t* z = a + (m > 0 ? m : 1);
  void* args[] = {(void*)&lo, (void*)&hi, &m64, &n, &b, &passes, &a, &z,
                  &ctl, &look, &stride, &out_lo, &out_hi, &size64, &dedup};
  return (int)cudaLaunchCooperativeKernel((const void*)compact_kernel,
                                          dim3((unsigned)blocks),
                                          dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}

extern "C" const char* sheep_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
