// The refinement's device programs (B11), the counterparts of the XLA
// programs of sheep_tpu/ops/refine.py:
//
//   neighbor_hist   neighbor_hist_chunk (:42) and neighbor_hist_block (:63)
//   hist_stats      hist_stats (:83)
//   plan_moves      plan_moves (:100)
//
// neighbor_hist: for each valid edge (u, v) of a (C, 2) int32 chunk (both
// ends in [0, n), u != v), hist[u, assign[v]] += 1 and hist[v, assign[u]]
// += 1, and the chunk's (cut, total) under the same mask. Blocked mode
// keeps only the rows [base, base + vb) of a (vb, k) buffer. The reference
// sends every invalid edge (padding, self-loops) to the sentinel row n (vb
// in blocked mode, or the row of vertex n when it lies in the block); that
// row is never read (the planner and the move accounting skip vid == n, the
// cut comes from the counters), so the kernels drop invalid edges and
// leave that row as they found it.
//   What bounds it: the histogram is (n + 1) k int32, 1 GiB at s22 and
// k = 64, far past the 50 MB L2, and a chunk's updates land on random rows:
// one update at a time, each is a random read-modify-write of a DRAM
// sector. So the updates are binned by row range first and applied a range
// at a time, four launches on the caller's stream:
//   hist_count    edges read as int2, the invalid ones dropped; each
//                 update counted in its bucket by shared-memory atomics,
//                 the block's counts added to the bucket totals. Dense
//                 calls (an update for every eight cells or more) bin by
//                 tiles: the largest power-of-two number of rows whose k
//                 cells fit kTileCells int32 (128 KB), when that makes at
//                 most kMaxBuckets buckets; the others by kMaxBuckets
//                 power-of-two row ranges.
//   hist_scan     one block: the totals to bucket starts, cursors and
//                 work items (a bucket in items of at most kItemUpdates
//                 or kHashItem updates), the totals back to zero and the
//                 apply's work counter to zero (the metadata is zeroed
//                 once, when it is allocated).
//   hist_scatter  the edges again, with assign[u] and assign[v] (16 MiB at
//                 s22, in L2; only where an update or the counts need
//                 them) and the fused (cut, total); a batch of 4096 edges
//                 is ordered by bucket in shared memory (ranks by
//                 shared-memory atomics, a block scan of the batch's
//                 counts, one global reservation a bucket it touches) and
//                 written as a run a bucket. Each update is one uint32
//                 word: its row within the bucket above col_bits bits of
//                 its column.
//   hist_apply_*  persistent blocks take work items from the counter. Tiled
//                 (dense): the item's updates are added into a zeroed tile
//                 by shared-memory atomics, then the touched cells into the
//                 histogram: by int4 load-add-store in address order where
//                 the tile is swept and the block owns the rows, otherwise
//                 by red (a global add that returns nothing). Hashed
//                 (sparse): a shared-memory hash table keyed by the words
//                 counts the item's updates, and each distinct cell is
//                 added by red.
// Each distinct cell is added once a work item, and a tile's or a bucket's
// cells together, not an update at a time at random; the price is 16 B of
// scratch traffic an edge (two 4 B words written and read once) and a
// second read of the edges. Measured on an H100 (PERF.md): a sparse
// call's red of its distinct cells (k = 64: ~8 M cells a 2^22-edge chunk,
// each in its own 32 B sector) is what bounds it; the scatter's gathers and
// short runs of words come next. Scratch: a word for each of 2C updates
// (32 MiB at C = 2^22) and the buckets' metadata. Any k: a word must stay
// below 2^31 (bucket rows times the column's bits), which any histogram
// that fits the card meets. Integer adds in any order give the same
// counts. Bound by bytes: 8 B an edge read, the 32 B sector of each
// histogram cell an edge touches read and written back, and the assignment
// table once.
//
// hist_stats: best = the FIRST argmax of each row (a lane keeps its first
// maximum, a tie goes to the smaller column, as jnp.argmax), bestv its
// value, cur = hist[r, cur_part[r]] and gain = bestv - cur, which the
// caller computes next anyway. Bound by bytes: the histogram read once.
// A row of k = 64 is two loads a lane of a warp: a warp a row keeps too
// few bytes in flight to keep the memory busy, so whole-row tiles stream
// through a ring of
// kStatsStages shared-memory stages: a producer warp copies each tile
// (tile_rows x k int32, tile_rows a multiple of 4, so every tile starts
// 16 B aligned) with a 1-D TMA bulk copy (cp.async.bulk, completed on an
// mbarrier by its byte count) under an L2 evict-first policy, the
// histogram being read once; a last tile whose bytes are not a multiple
// of 16 (or a histogram not 16 B aligned) is copied with plain loads.
// Consumer warps reduce each staged row with a group of lanes (the power
// of two at or above k, or k / 4 where k is a multiple of 4 and a lane
// reads int4s, at most 32) and shuffles, read cur from the staged row (the
// tile's current parts loaded while it arrives), and store the tile's four
// outputs coalesced; their results alternate between two buffers, so one
// barrier a tile keeps the consumers together. A row wider than a quarter
// stage (k > 2048) goes to hist_stats_wide: a block a row, plain loads.
//
// plan_moves: one parity half-round of capacity-capped moves. Each part p
// accepts the first head_p = max(cap - load_p, 0) of the parity's movers
// to it (gain > 0, vid < n), in gain-descending then vid-ascending order,
// the order of the reference's stable lexsort((-gain, part_key)). Only
// an over-subscribed part (movers above its head) needs an order, and
// only at one key: its head-th mover's. So each such part finds that
// key, a threshold (G, V), by a radix selection, and a mover is accepted
// iff gain > G, or gain == G and vid <= V: no sort, no rank of any other
// row, no host read. One cooperative launch on the caller's stream, its
// phases apart by grid barriers:
//   count    one pass over the rows: the loads from assign[:n], and for
//            each mover its target's movers and a bin of min(gain, bins0
//            - 1) (shared counters where k parts of bins0 <= 256 bins fit
//            kPlanSmem, else global atomics).
//   walk     a warp a part, over its bins from the top: the threshold, or
//            the bin that holds it (a gain, or the overflow bin of larger
//            gains) and the movers still to take there.
//   digits   while a part is open, at most kGainPasses + ceil(vid bits /
//            8) steps of one 8-bit digit each: the overflow bin's gain
//            digits from the top, then the vids at the threshold gain
//            from the bottom, binned by global atomics (a warp's equal
//            bins added once) and walked a warp a part. The first step
//            reads the parity's rows and keeps the open parts' movers in
//            their threshold bin as (vid, part, gain) candidates; the
//            others read only those.
//   write    out[v] = best[v] if v is accepted, else assign[v].
// Bound by bytes: gain and the assignment read and the new assignment
// written (12 B a row), and the 32 B sectors of best that hold a mover (4 B
// a row more where movers are dense, little where they are few). The
// count reads the assignment and best/gain's
// sectors, the first digit step best/gain again (32 MB at s22, mostly in
// L2), the write all three: about 9 B a row on top, where the sort it
// replaced moved 12 B a row five times. The scratch stays zero between
// calls (a walk zeroes the bins it reads), so no memset either.

// Bound to PyTorch through plain C functions (loaded with ctypes): the
// caller passes device pointers, the scratch it allocated and its CUDA
// stream, and gets back the first CUDA error of the launches (0 if none).

#include <cooperative_groups.h>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sheep;

constexpr unsigned kFull = 0xffffffffu;

// -- neighbor_hist ----------------------------------------------------------

constexpr int kTileCells = 32768;     // the apply's tile: 128 KB of int32
constexpr int kMaxBuckets = 2048;     // buckets of a call
constexpr int kList = 4096;           // touched cells a tile walks by list
constexpr int kSweep = 4;             // int4 cells a thread a sweep step
constexpr int kBigThreads = 1024;     // scan, scatter and apply blocks
constexpr int kBatchEdges = 4 * kBigThreads;  // a scatter batch
constexpr int kEdgesPerThread = kBatchEdges / kBigThreads;
constexpr int kBatchUpdates = 2 * kBatchEdges;
constexpr int kBucketsPerThread = kMaxBuckets / kBigThreads;
constexpr int kItemUpdates = 16384;   // updates of a tiled work item
constexpr int kWordsPerThread = kItemUpdates / kBigThreads;
constexpr int kHashBits = 14;         // the hashed apply's table
constexpr int kHashSlots = 1 << kHashBits;
constexpr int kHashItem = kHashSlots / 2;  // updates of a hashed item
constexpr int kHashPerThread = kHashItem / kBigThreads;
constexpr uint32_t kEmpty = 0xffffffffu;  // no word: they stay below 2^31
// metadata words: totals, starts (+1), cursors, item starts (+1), the
// apply's work counter
constexpr int kMetaWords = 4 * kMaxBuckets + 3;

using BigScan = cub::BlockScan<int32_t, kBigThreads>;

__device__ __forceinline__ bool valid_edge(int32_t u, int32_t v, int32_t n) {
  return (uint32_t)u < (uint32_t)n && (uint32_t)v < (uint32_t)n && u != v;
}

// sum over a block of kBigThreads into thread 0's return value
__device__ __forceinline__ int big_block_sum(int x, int* smem) {
  x = __reduce_add_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBigThreads / 32; ++w) s += smem[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
hist_count(const int2* __restrict__ edges, int64_t m, int32_t n,
           int64_t base, int64_t rows, int shift_b, int buckets,
           int32_t* __restrict__ total) {
  extern __shared__ int32_t count[];
  for (int b = threadIdx.x; b < buckets; b += kThreads) count[b] = 0;
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += step) {
    const int2 e = edges[i];
    if (!valid_edge(e.x, e.y, n)) continue;
    const int64_t lu = (int64_t)e.x - base, lv = (int64_t)e.y - base;
    if ((uint64_t)lu < (uint64_t)rows) atomicAdd(count + (lu >> shift_b), 1);
    if ((uint64_t)lv < (uint64_t)rows) atomicAdd(count + (lv >> shift_b), 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads)
    if (count[b]) atomicAdd(total + b, count[b]);
}

__global__ void __launch_bounds__(kBigThreads)
hist_scan(int32_t* __restrict__ total, int buckets, int item_size,
          int32_t* __restrict__ start, int32_t* __restrict__ cursor,
          int32_t* __restrict__ items, int32_t* __restrict__ work) {
  __shared__ typename BigScan::TempStorage tmp;
  int32_t c[kBucketsPerThread];
  int32_t sum = 0, slices = 0;
#pragma unroll
  for (int p = 0; p < kBucketsPerThread; ++p) {
    const int b = threadIdx.x * kBucketsPerThread + p;
    c[p] = b < buckets ? total[b] : 0;
    if (b < buckets) total[b] = 0;
    sum += c[p];
    slices += (c[p] + item_size - 1) / item_size;
  }
  int32_t at, all, item_at, item_all;
  BigScan(tmp).ExclusiveSum(sum, at, all);
  __syncthreads();
  BigScan(tmp).ExclusiveSum(slices, item_at, item_all);
#pragma unroll
  for (int p = 0; p < kBucketsPerThread; ++p) {
    const int b = threadIdx.x * kBucketsPerThread + p;
    if (b < buckets) {
      start[b] = at;
      cursor[b] = at;
      items[b] = item_at;
    }
    at += c[p];
    item_at += (c[p] + item_size - 1) / item_size;
  }
  if (threadIdx.x == 0) {
    start[buckets] = all;
    items[buckets] = item_all;
    *work = 0;
  }
}

// shared memory of hist_scatter: the batch's counts (then offsets), its
// reserved slots, and its words and their destinations in bucket order
constexpr size_t kScatterSmem =
    (size_t)(2 * kMaxBuckets + 2 * kBatchUpdates) * 4;

__global__ void __launch_bounds__(kBigThreads)
hist_scatter(const int2* __restrict__ edges, int64_t m,
             const int32_t* __restrict__ assign, int32_t n, int64_t base,
             int64_t rows, int shift_b, int col_bits,
             int32_t* __restrict__ cursor, uint32_t* __restrict__ words,
             unsigned long long* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  int32_t* offset = smem;                     // [kMaxBuckets]
  int32_t* slot = offset + kMaxBuckets;       // [kMaxBuckets]
  uint32_t* staged = (uint32_t*)(slot + kMaxBuckets);  // [kBatchUpdates]
  int32_t* dest = (int32_t*)(staged + kBatchUpdates);  // [kBatchUpdates]
  __shared__ typename BigScan::TempStorage tmp;
  __shared__ int sums[kBigThreads / 32];
  for (int b = threadIdx.x; b < kMaxBuckets; b += kBigThreads) offset[b] = 0;
  __syncthreads();
  const uint64_t row_mask = (1ull << shift_b) - 1;
  const bool fused = counts != nullptr;
  int cut = 0, total = 0;
  for (int64_t b0 = (int64_t)blockIdx.x * kBatchEdges; b0 < m;
       b0 += (int64_t)gridDim.x * kBatchEdges) {
    int32_t bucket[2 * kEdgesPerThread], rank[2 * kEdgesPerThread];
    uint32_t word[2 * kEdgesPerThread];
    int2 e[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      const int64_t i = b0 + j * kBigThreads + threadIdx.x;
      e[j] = i < m ? __ldcs(edges + i) : make_int2(-1, -1);
    }
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      bucket[2 * j] = bucket[2 * j + 1] = -1;
      if (!valid_edge(e[j].x, e[j].y, n)) continue;
      const int64_t lu = (int64_t)e[j].x - base, lv = (int64_t)e[j].y - base;
      const bool in_u = (uint64_t)lu < (uint64_t)rows,
                 in_v = (uint64_t)lv < (uint64_t)rows;
      // the parts only where an update or the counts need them
      const int32_t pv = in_u || fused ? __ldg(assign + e[j].y) : 0;
      const int32_t pu = in_v || fused ? __ldg(assign + e[j].x) : 0;
      cut += pu != pv;
      total += 1;
      if (in_u) {
        bucket[2 * j] = (int32_t)(lu >> shift_b);
        word[2 * j] = ((uint32_t)(lu & row_mask) << col_bits) | (uint32_t)pv;
      }
      if (in_v) {
        bucket[2 * j + 1] = (int32_t)(lv >> shift_b);
        word[2 * j + 1] =
            ((uint32_t)(lv & row_mask) << col_bits) | (uint32_t)pu;
      }
    }
#pragma unroll
    for (int q = 0; q < 2 * kEdgesPerThread; ++q)
      if (bucket[q] >= 0) rank[q] = atomicAdd(offset + bucket[q], 1);
    __syncthreads();
    // the batch's counts to offsets, and a run reserved in each bucket
    // that has any: the runs of concurrent batches lie together, so a
    // bucket's words are written in few open lines at a time
    int32_t c[kBucketsPerThread];
    int32_t sum = 0;
#pragma unroll
    for (int p = 0; p < kBucketsPerThread; ++p) {
      c[p] = offset[threadIdx.x * kBucketsPerThread + p];
      sum += c[p];
    }
    int32_t at, staged_count;
    BigScan(tmp).ExclusiveSum(sum, at, staged_count);
#pragma unroll
    for (int p = 0; p < kBucketsPerThread; ++p) {
      const int b = threadIdx.x * kBucketsPerThread + p;
      if (c[p] > 0) slot[b] = atomicAdd(cursor + b, c[p]);
      offset[b] = at;
      at += c[p];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2 * kEdgesPerThread; ++q)
      if (bucket[q] >= 0) {
        const int s = offset[bucket[q]] + rank[q];
        staged[s] = word[q];
        dest[s] = slot[bucket[q]] + rank[q];
      }
    __syncthreads();
    for (int s = threadIdx.x; s < staged_count; s += kBigThreads)
      words[dest[s]] = staged[s];
#pragma unroll
    for (int p = 0; p < kBucketsPerThread; ++p)
      offset[threadIdx.x * kBucketsPerThread + p] = 0;
    __syncthreads();
  }
  if (fused) {
    const int c = big_block_sum(cut, sums);
    const int t = big_block_sum(total, sums);
    if (threadIdx.x == 0) {
      atomicAdd(counts, (unsigned long long)c);
      atomicAdd(counts + 1, (unsigned long long)t);
    }
  }
}

// The apply's blocks take work items from the counter: an item is up to
// item_size updates of one bucket. Returns the item's bucket, or -1 when
// none is left; lo and count are its updates in words, shared whether its
// bucket has other items (whose blocks add to the same rows). item_at:
// the item starts in shared memory.
__device__ __forceinline__ int next_item(int32_t* work,
                                         const int32_t* item_at,
                                         int buckets,
                                         const int32_t* __restrict__ start,
                                         int item_size, int* s_item,
                                         int32_t* lo, int32_t* count,
                                         bool* shared) {
  __syncthreads();  // the last item's s_item and words read by all
  if (threadIdx.x == 0) *s_item = atomicAdd(work, 1);
  __syncthreads();
  const int item = *s_item;
  if (item >= item_at[buckets]) return -1;
  // the bucket: the last with item_at[b] <= item
  int b = 0;
  for (int span = buckets; span > 1;) {
    const int half = span >> 1;
    if (item_at[b + half] <= item) b += half;
    span -= half;
  }
  *shared = item_at[b + 1] - item_at[b] > 1;
  *lo = start[b] + (item - item_at[b]) * item_size;
  *count = min(start[b + 1] - *lo, item_size);
  return b;
}

// Dense calls, a bucket one tile (2^shift_r rows of k cells): the item's
// words staged, its updates added into the tile by shared-memory atomics,
// then the touched cells into the histogram. Where at most kList distinct
// cells are touched (their first touches listed as they land), by red (a
// global add that returns nothing) down the list; otherwise a sweep of the
// tile in address order, by int4 load-add-store when the bucket is one item
// (its rows the block's alone in the launch; vec: the histogram 16 B
// aligned), else by red. Dynamic shared memory: the item starts (buckets +
// 1), the words, the tile and the list.
__global__ void __launch_bounds__(kBigThreads)
hist_apply_tile(const uint32_t* __restrict__ words,
                const int32_t* __restrict__ start,
                const int32_t* __restrict__ items, int buckets,
                int32_t* __restrict__ work, int64_t rows, int32_t k,
                int shift_r, int col_bits, int vec,
                int32_t* __restrict__ hist) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* item_at = smem;
  uint32_t* word = (uint32_t*)(item_at + ((buckets + 4) & ~3));
  int32_t* tile = (int32_t*)(word + kItemUpdates);
  int32_t* list = tile + ((int64_t)k << shift_r);
  __shared__ int s_item, s_listed;
  const uint32_t col_mask = (1u << col_bits) - 1;
  const int tile_rows = 1 << shift_r;
  for (int b = threadIdx.x; b <= buckets; b += kBigThreads)
    item_at[b] = items[b];
  for (int c = threadIdx.x; c < (tile_rows * k); c += kBigThreads)
    tile[c] = 0;
  if (threadIdx.x == 0) s_listed = 0;
  int32_t lo, count;
  bool shared;
  for (int b; (b = next_item(work, item_at, buckets, start, kItemUpdates,
                             &s_item, &lo, &count, &shared)) >= 0;) {
#pragma unroll
    for (int q = 0; q < kWordsPerThread; ++q) {
      const int i = q * kBigThreads + threadIdx.x;
      if (i < count) word[i] = words[lo + i];
    }
    __syncthreads();
    for (int i0 = 0; i0 < count; i0 += kBigThreads) {
      const int i = i0 + threadIdx.x;
      bool first = false;
      int32_t cell = 0;
      if (i < count) {
        const uint32_t w = word[i];
        cell = (int32_t)(w >> col_bits) * k + (int32_t)(w & col_mask);
        first = atomicAdd(tile + cell, 1) == 0;
      }
      const unsigned firsts = __ballot_sync(kFull, first);
      if (firsts) {
        const int lane = threadIdx.x & 31;
        int at = 0;
        if (lane == __ffs(firsts) - 1)
          at = atomicAdd(&s_listed, __popc(firsts));
        at = __shfl_sync(kFull, at, __ffs(firsts) - 1);
        if (first) {
          const int idx = at + __popc(firsts & ((1u << lane) - 1));
          if (idx < kList) list[idx] = cell;
        }
      }
    }
    __syncthreads();
    const int64_t row0 = (int64_t)b << shift_r;
    const int64_t left = rows - row0;
    const int cells = (int)(left < tile_rows ? left : tile_rows) * k;
    int32_t* g = hist + row0 * k;
    const int listed = s_listed;
    if (listed <= kList) {
      for (int j = threadIdx.x; j < listed; j += kBigThreads) {
        const int32_t c = list[j];
        atomicAdd(g + c, tile[c]);
        tile[c] = 0;
      }
    } else if (vec && !shared) {
      const int cells4 = cells >> 2;
      int4* tile4 = (int4*)tile;
      int4* g4 = (int4*)g;
      for (int c0 = 0; c0 < cells4; c0 += kSweep * kBigThreads) {
        int4 add[kSweep], old[kSweep];
        bool any[kSweep];
#pragma unroll
        for (int q = 0; q < kSweep; ++q) {
          const int c = c0 + q * kBigThreads + threadIdx.x;
          add[q] = c < cells4 ? tile4[c] : make_int4(0, 0, 0, 0);
          any[q] = (add[q].x | add[q].y | add[q].z | add[q].w) != 0;
        }
#pragma unroll
        for (int q = 0; q < kSweep; ++q)
          if (any[q]) old[q] = g4[c0 + q * kBigThreads + threadIdx.x];
#pragma unroll
        for (int q = 0; q < kSweep; ++q)
          if (any[q]) {
            const int c = c0 + q * kBigThreads + threadIdx.x;
            g4[c] = make_int4(old[q].x + add[q].x, old[q].y + add[q].y,
                              old[q].z + add[q].z, old[q].w + add[q].w);
            tile4[c] = make_int4(0, 0, 0, 0);
          }
      }
      // the last cells (fewer than four) of the histogram's last tile
      const int c = 4 * cells4 + threadIdx.x;
      if (c < cells && tile[c]) {
        g[c] += tile[c];
        tile[c] = 0;
      }
    } else {
      for (int c = threadIdx.x; c < cells; c += kBigThreads)
        if (tile[c]) {
          atomicAdd(g + c, tile[c]);
          tile[c] = 0;
        }
    }
    __syncthreads();  // s_listed read by all, the tile clear
    if (threadIdx.x == 0) s_listed = 0;
  }
}

// Sparse calls: the item's updates are counted in a shared-memory hash
// table keyed by their words (a word names its cell within the bucket),
// kHashSlots slots for at most kHashItem updates, then each distinct cell
// is added into the histogram by red, and its slot emptied. Dynamic shared
// memory: the item starts, the keys and the counts.
__global__ void __launch_bounds__(kBigThreads)
hist_apply_hash(const uint32_t* __restrict__ words,
                const int32_t* __restrict__ start,
                const int32_t* __restrict__ items, int buckets,
                int32_t* __restrict__ work, int32_t k, int shift_b,
                int col_bits, int32_t* __restrict__ hist) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* item_at = smem;
  uint32_t* key = (uint32_t*)(item_at + ((buckets + 4) & ~3));
  int32_t* hits = (int32_t*)(key + kHashSlots);
  __shared__ int s_item;
  const uint32_t col_mask = (1u << col_bits) - 1;
  for (int b = threadIdx.x; b <= buckets; b += kBigThreads)
    item_at[b] = items[b];
  for (int j = threadIdx.x; j < kHashSlots; j += kBigThreads) {
    key[j] = kEmpty;
    hits[j] = 0;
  }
  int32_t lo, count;
  bool shared;
  for (int b; (b = next_item(work, item_at, buckets, start, kHashItem,
                             &s_item, &lo, &count, &shared)) >= 0;) {
    uint32_t w[kHashPerThread];
#pragma unroll
    for (int q = 0; q < kHashPerThread; ++q) {
      const int i = q * kBigThreads + threadIdx.x;
      w[q] = i < count ? words[lo + i] : kEmpty;
    }
#pragma unroll
    for (int q = 0; q < kHashPerThread; ++q) {
      if (w[q] == kEmpty) continue;
      uint32_t h = (w[q] * 0x9e3779b1u) >> (32 - kHashBits);
      for (;;) {
        const uint32_t was = atomicCAS(key + h, kEmpty, w[q]);
        if (was == kEmpty || was == w[q]) break;
        h = (h + 1) & (kHashSlots - 1);
      }
      atomicAdd(hits + h, 1);
    }
    __syncthreads();
    const int64_t row_b = (int64_t)b << shift_b;
    for (int j = threadIdx.x; j < kHashSlots; j += kBigThreads) {
      const uint32_t c = key[j];
      if (c == kEmpty) continue;
      atomicAdd(hist + (row_b + (c >> col_bits)) * k + (c & col_mask),
                hits[j]);
      key[j] = kEmpty;
      hits[j] = 0;
    }
  }
}

// -- hist_stats -------------------------------------------------------------

constexpr int kStatsStages = 4;
constexpr int kStageBytes = 32768;
constexpr int kStatsMaxTileRows = 1024;
constexpr int kStatsConsumerWarps = 16;
constexpr int kStatsConsumers = 32 * kStatsConsumerWarps;
constexpr int kStatsThreads = kStatsConsumers + 32;  // warp 0 produces
constexpr int kStatsRowsPerThread = kStatsMaxTileRows / kStatsConsumers;
// the stages, two tiles' (best, bestv) and the full and empty barriers
constexpr size_t kStatsSmem = (size_t)kStatsStages * kStageBytes +
                              4 * kStatsMaxTileRows * 4 +
                              2 * kStatsStages * 8;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// a 1-D TMA bulk copy global -> shared, completed on bar by its bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kStatsConsumers) : "memory");
}

// the first maximum of two (value, column) candidates, as jnp.argmax
__device__ __forceinline__ void keep_first_max(int32_t& bv, int32_t& bi,
                                               int32_t ov, int32_t oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

// kVec 4 (k a multiple of 4): a lane reads four columns at a time
template <int kVec>
__global__ void __launch_bounds__(kStatsThreads, 1)
hist_stats_ring(const int32_t* __restrict__ hist, int64_t rows, int32_t k,
                int tile_rows, int lanes, int bulk,
                const int32_t* __restrict__ cur_part,
                int32_t* __restrict__ best, int32_t* __restrict__ bestv,
                int32_t* __restrict__ cur, int32_t* __restrict__ gain) {
  extern __shared__ __align__(128) unsigned char ring[];
  int32_t* res = (int32_t*)(ring + (size_t)kStatsStages * kStageBytes);
  uint64_t* full = (uint64_t*)(res + 4 * kStatsMaxTileRows);
  uint64_t* empty = full + kStatsStages;
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStatsStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kStatsConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const uint64_t policy = evict_first_policy();
    int i = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      const int s = i % kStatsStages;
      if (i >= kStatsStages)
        mbar_wait(empty + s, ((i / kStatsStages) & 1) ^ 1);
      const int64_t r0 = t * tile_rows;
      const int nr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
      const int32_t* src = hist + r0 * k;
      int32_t* dst = (int32_t*)(ring + (size_t)s * kStageBytes);
      const uint32_t bytes = (uint32_t)nr * (uint32_t)k * 4u;
      if (bulk && bytes % 16 == 0) {
        if (lane == 0) {
          mbar_expect(full + s, bytes);
          bulk_load(dst, src, bytes, full + s, policy);
        }
      } else {
        for (int j = lane; j < nr * k; j += 32) dst[j] = src[j];
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
      }
    }
    return;
  }
  const int ct = threadIdx.x - 32;
  const int groups = kStatsConsumers / lanes;
  const int group = ct / lanes, gl = ct % lanes;
  int i = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % kStatsStages;
    const int64_t r0 = t * tile_rows;
    const int nr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    // the tile's current parts, in flight while its rows arrive
    int32_t part[kStatsRowsPerThread];
#pragma unroll
    for (int q = 0; q < kStatsRowsPerThread; ++q) {
      const int j = ct + q * kStatsConsumers;
      part[q] = j < nr ? cur_part[r0 + j] : 0;
    }
    int32_t* res_best = res + (i & 1) * 2 * kStatsMaxTileRows;
    int32_t* res_val = res_best + kStatsMaxTileRows;
    mbar_wait(full + s, (i / kStatsStages) & 1);
    const int32_t* st = (const int32_t*)(ring + (size_t)s * kStageBytes);
    // every lane of a warp runs the same steps: the shuffles take them all
    for (int j0 = 0; j0 < nr; j0 += groups) {
      const int j = j0 + group;
      // a lane without a column holds the index k, which loses every tie
      int32_t bv = INT32_MIN, bi = k;
      if (j < nr) {
        const int32_t* row = st + j * k;
        if (kVec == 4) {
          for (int32_t c = 4 * gl; c < k; c += 4 * lanes) {
            const int4 x = *(const int4*)(row + c);
            if (x.x > bv) { bv = x.x; bi = c; }
            if (x.y > bv) { bv = x.y; bi = c + 1; }
            if (x.z > bv) { bv = x.z; bi = c + 2; }
            if (x.w > bv) { bv = x.w; bi = c + 3; }
          }
        } else {
          for (int32_t c = gl; c < k; c += lanes) {
            const int32_t x = row[c];
            if (x > bv) {
              bv = x;
              bi = c;
            }
          }
        }
      }
      for (int d = lanes >> 1; d >= 1; d >>= 1)
        keep_first_max(bv, bi, __shfl_xor_sync(kFull, bv, d),
                       __shfl_xor_sync(kFull, bi, d));
      if (j < nr && gl == 0) {
        res_best[j] = bi;
        res_val[j] = bv;
      }
    }
    // the tile's results are in; the other buffer is the next tile's, so
    // one barrier a tile keeps them apart
    consumers_sync();
#pragma unroll
    for (int q = 0; q < kStatsRowsPerThread; ++q) {
      const int j = ct + q * kStatsConsumers;
      if (j >= nr) break;
      const int64_t r = r0 + j;
      const int32_t v = res_val[j];
      const int32_t c = st[j * k + clip(part[q], k - 1)];
      best[r] = res_best[j];
      bestv[r] = v;
      cur[r] = c;
      gain[r] = v - c;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
}

// k > 2048: a block a row
__global__ void __launch_bounds__(kThreads)
hist_stats_wide(const int32_t* __restrict__ hist, int64_t rows, int32_t k,
                const int32_t* __restrict__ cur_part,
                int32_t* __restrict__ best, int32_t* __restrict__ bestv,
                int32_t* __restrict__ cur, int32_t* __restrict__ gain) {
  __shared__ int32_t sv[kWarps], si[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int32_t* row = hist + r * k;
    int32_t bv = INT32_MIN, bi = k;
    for (int32_t c = threadIdx.x; c < k; c += kThreads) {
      const int32_t x = row[c];
      if (x > bv) {
        bv = x;
        bi = c;
      }
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
      keep_first_max(bv, bi, __shfl_xor_sync(kFull, bv, d),
                     __shfl_xor_sync(kFull, bi, d));
    if (lane == 0) {
      sv[warp] = bv;
      si[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) keep_first_max(bv, bi, sv[w], si[w]);
      const int32_t c = row[clip(cur_part[r], k - 1)];
      best[r] = bi;
      bestv[r] = bv;
      cur[r] = c;
      gain[r] = bv - c;
    }
    __syncthreads();
  }
}

// -- plan_moves -------------------------------------------------------------

constexpr int kPlanThreads = 1024;    // the plan's blocks
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kDigitBits = 8;         // a refinement digit
constexpr int kDigits = 1 << kDigitBits;
constexpr int kGainPasses = 4;        // 31 bits of gain, a digit a pass
constexpr int kPlanSmem = 112 * 1024;  // the count's shared counters
constexpr int kMaxBinsPerLane = kDigits / 32;
constexpr int kUnroll = 4;  // rows a thread loads before it uses them
// the per-part words of the scratch, each an int32[k] row
enum : int {
  kLoads = 0,   // assign[:n] in part p (zero between calls)
  kMovers = 1,  // the parity's movers to p (zero between calls)
  kState = 2,   // the digit step p is at, -1 once its threshold is known
  kPrefix = 3,  // the digits found so far (gain steps, then vid steps)
  kNeed = 4,    // movers still to accept among those matching the prefix
  kGain = 5,    // threshold gain G
  kVid = 6,     // threshold vid V: accepted iff gain > G or (== G, vid <= V)
  kBin0 = 7,    // the count's bin that holds the threshold
  kPartWords = 8,
};
// control words: open parts, candidates kept
enum : int { kActive = 0, kCands = 1, kPlanCtl = 2 };

// The walk of one part's bins by a warp: bins [0, nbins) of row (nbins a
// power of two, at most kDigits), read from L2 and zeroed; `need` (>= 1,
// at most the row's total) selects the bin d where the count walked
// before it, from the top (descending) or the bottom, is below need and
// reaches it with d's count. Every lane returns d, the count before d
// and d's count; with need 0 the bins are only zeroed.
struct Step {
  int d, before, count;
};

__device__ Step warp_walk(int32_t* row, int nbins, int need, bool desc) {
  const int lane = threadIdx.x & 31;
  const int per = nbins >= 32 ? nbins / 32 : 1;
  int c[kMaxBinsPerLane];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kMaxBinsPerLane; ++i) {
    const int b = lane * per + i;
    c[i] = i < per && b < nbins ? __ldcg(row + b) : 0;
    sum += c[i];
  }
#pragma unroll
  for (int i = 0; i < kMaxBinsPerLane; ++i) {
    const int b = lane * per + i;
    if (i < per && b < nbins && c[i]) row[b] = 0;
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int before = desc ? total - incl : incl - sum;
  const bool mine = need > 0 && before < need && need <= before + sum;
  Step st{0, 0, 0};
  if (mine) {
    for (int j = 0; j < per; ++j) {
      const int i = desc ? per - 1 - j : j;
      if (before + c[i] >= need) {
        st = Step{lane * per + i, before, c[i]};
        break;
      }
      before += c[i];
    }
  }
  const unsigned who = __ballot_sync(kFull, mine);
  if (who) {
    const int src = __ffs(who) - 1;
    st.d = __shfl_sync(kFull, st.d, src);
    st.before = __shfl_sync(kFull, st.before, src);
    st.count = __shfl_sync(kFull, st.count, src);
  }
  return st;
}

// The count: every row below n adds its part to the loads; a mover of the
// parity (gain > 0, best in [0, k)) adds one to its target's movers and
// to the target's bin min(gain, bins0 - 1). Shared counters when they
// fit (kShared), added to the scratch's at the end. kUnroll pairs of rows
// a thread are loaded before any is counted, to keep loads in flight.
template <bool kShared>
__device__ void plan_count(const int32_t* __restrict__ best,
                           const int32_t* __restrict__ gain,
                           const int32_t* __restrict__ assign, int64_t n,
                           int32_t k, int parity, int bins0, int32_t* hist,
                           int32_t* part, int32_t* sm) {
  int32_t* loads = kShared ? sm + (int64_t)k * bins0 : part + kLoads * k;
  int32_t* movers = kShared ? loads + k : part + kMovers * k;
  if (kShared) {
    for (int64_t j = threadIdx.x; j < (int64_t)k * (bins0 + 2);
         j += blockDim.x)
      sm[j] = 0;
    __syncthreads();
  }
  const int64_t pairs = (n + 1) / 2;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j0 < pairs; j0 += kUnroll * step) {
    int32_t a0[kUnroll], a1[kUnroll], g[kUnroll], p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v0 = 2 * (j0 + u * step), v = v0 + parity;
      const bool in = j0 + u * step < pairs;
      a0[u] = in ? assign[v0] : -1;
      a1[u] = in && v0 + 1 < n ? assign[v0 + 1] : -1;
      g[u] = in && v < n ? gain[v] : 0;
      p[u] = g[u] > 0 ? best[v] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((uint32_t)a0[u] < (uint32_t)k) atomicAdd(loads + a0[u], 1);
      if ((uint32_t)a1[u] < (uint32_t)k) atomicAdd(loads + a1[u], 1);
      if (g[u] > 0 && (uint32_t)p[u] < (uint32_t)k) {
        atomicAdd(movers + p[u], 1);
        const int bin = g[u] < bins0 - 1 ? g[u] : bins0 - 1;
        atomicAdd(kShared ? sm + (int64_t)p[u] * bins0 + bin
                          : hist + (int64_t)p[u] * kDigits + bin, 1);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < (int64_t)k * bins0; j += blockDim.x)
      if (sm[j]) atomicAdd(hist + (j / bins0) * kDigits + j % bins0, sm[j]);
    for (int32_t q = threadIdx.x; q < k; q += blockDim.x) {
      if (loads[q]) atomicAdd(part + kLoads * k + q, loads[q]);
      if (movers[q]) atomicAdd(part + kMovers * k + q, movers[q]);
    }
  }
}

// The first walk, a warp a part: a part whose movers fit its head
// max(cap - load, 0) takes them all, a part with no room none; any other
// finds the bin of its head-th mover in (gain desc) order: if that bin's
// movers all fit, the threshold is the bin's lowest gain, else the part
// stays open at step 0 (gain digits: the bin is the overflow bin) or
// kGainPasses (vid digits: the bin is one gain).
__device__ void plan_walk0(int32_t k, int bins0, int32_t cap, int32_t* hist,
                           int32_t* part, int32_t* ctl) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kPlanWarps;
  for (int64_t p = (int64_t)blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
       p < k; p += warps) {
    int32_t* lp = part + kLoads * k + p;
    int32_t* mp = part + kMovers * k + p;
    const int64_t room = (int64_t)cap - __ldcg(lp);
    const int64_t head = room > 0 ? room : 0;
    const int32_t mov = __ldcg(mp);
    const bool split = mov > head && head > 0;
    const int need = split ? (int)head : 0;
    const Step st = warp_walk(hist + p * kDigits, bins0, need, true);
    if (lane == 0) {
      *lp = 0;
      *mp = 0;
      int32_t state = -1, g = 0;
      if (mov > head && head == 0) {
        g = INT32_MAX;  // no room: none accepted
      } else if (split) {
        const int rest = need - st.before;
        if (st.count == rest) {
          g = st.d - 1;  // the whole bin fits: gain >= d
        } else {
          state = st.d < bins0 - 1 ? kGainPasses : 0;
          g = st.d;
          part[kPrefix * k + p] = 0;
          part[kNeed * k + p] = rest;
          part[kBin0 * k + p] = st.d;
          atomicAdd(ctl + kActive, 1);
        }
      }  // else every mover fits: gain > 0
      part[kState * k + p] = state;
      part[kGain * k + p] = g;
      part[kVid * k + p] = -1;
    }
  }
}

// One digit step's binning. Pass 0 reads the parity's rows and keeps the
// movers in the bin that holds their open part's threshold as candidates
// (vid, part, gain), in any order; later passes read the candidates. A
// candidate of a part at a gain step s (digit kGainPasses - 1 - s of the
// gain, from the top) whose gain matches the prefix, or at a vid step
// whose gain is the threshold's and whose vid matches the prefix, adds
// one to its part's bin of that digit (a warp's equal bins added once).
__device__ void plan_bin(const int32_t* __restrict__ best,
                         const int32_t* __restrict__ gain, int64_t n,
                         int32_t k, int parity, int bins0, int pass,
                         int vid_passes, int32_t* hist, const int32_t* part,
                         int32_t* ctl, int4* cand) {
  const int lane = threadIdx.x & 31;
  const int32_t* state = part + kState * k;
  const int32_t* prefix = part + kPrefix * k;
  const int32_t* thr = part + kGain * k;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const int64_t items = pass == 0 ? (n + 1) / 2 : __ldcg(ctl + kCands);
  for (int64_t i0 = first; i0 < items; i0 += kUnroll * step) {
    // every lane's rows first, kUnroll of them, so their loads overlap
    int32_t v[kUnroll], p[kUnroll], g[kUnroll], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * step + lane;
      v[u] = -1;
      p[u] = -1;
      g[u] = 0;
      if (i < items) {
        if (pass == 0) {
          const int64_t vv = 2 * i + parity;
          v[u] = (int32_t)vv;
          g[u] = vv < n ? gain[vv] : 0;
        } else {
          const int4 c = cand[i];
          v[u] = c.x;
          p[u] = c.y;
          g[u] = c.z;
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (g[u] > 0) p[u] = best[v[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = -1;
      if (g[u] > 0 && (uint32_t)p[u] < (uint32_t)k) {
        const int32_t sp = state[p[u]];
        const int bin = g[u] < bins0 - 1 ? g[u] : bins0 - 1;
        if (sp >= 0 && (pass > 0 || bin == part[kBin0 * k + p[u]]))
          s[u] = sp;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (pass == 0) {  // keep the candidates
        const unsigned keep = __ballot_sync(kFull, s[u] >= 0);
        if (keep) {
          const int leader = __ffs(keep) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(ctl + kCands, __popc(keep));
          base = __shfl_sync(kFull, base, leader);
          if (s[u] >= 0)
            cand[base + __popc(keep & ((1u << lane) - 1u))] =
                make_int4(v[u], p[u], g[u], 0);
        }
      }
      int digit = -1;
      if (s[u] >= 0) {
        if (s[u] < kGainPasses) {
          const int sh = kDigitBits * (kGainPasses - 1 - s[u]);
          if (((int64_t)g[u] >> (sh + kDigitBits)) == prefix[p[u]])
            digit = (g[u] >> sh) & (kDigits - 1);
        } else {
          const int sh = kDigitBits * (vid_passes - 1 - (s[u] - kGainPasses));
          if (g[u] == thr[p[u]] &&
              ((int64_t)v[u] >> (sh + kDigitBits)) == prefix[p[u]])
            digit = (v[u] >> sh) & (kDigits - 1);
        }
      }
      const uint64_t key =
          digit >= 0 ? ((uint64_t)(uint32_t)p[u] << kDigitBits) | digit
                     : ~0ull;
      const unsigned peers = __match_any_sync(kFull, key);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(hist + (int64_t)p[u] * kDigits + digit, __popc(peers));
    }
  }
}

// One digit step's walk, a warp an open part: the part's bins (gain
// digits from the top, vid digits from the bottom) move it to its next
// step, or close it where the digit's movers all fit or the last digit
// is found.
__device__ void plan_walk(int32_t k, int vid_passes, int32_t* hist,
                          int32_t* part, int32_t* ctl) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kPlanWarps;
  for (int64_t p = (int64_t)blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
       p < k; p += warps) {
    const int32_t s = part[kState * k + p];
    if (s < 0) continue;
    const int need = part[kNeed * k + p];
    const int64_t pre = part[kPrefix * k + p];
    const bool gain_step = s < kGainPasses;
    const int sh =
        kDigitBits * (gain_step ? kGainPasses - 1 - s
                                : vid_passes - 1 - (s - kGainPasses));
    const Step st = warp_walk(hist + p * kDigits, kDigits, need, gain_step);
    if (lane == 0) {
      const int64_t next = (pre << kDigitBits) | st.d;
      const int rest = need - st.before;
      int32_t ns = s + 1;
      if (gain_step) {
        if (st.count == rest) {  // the digit's movers all fit
          part[kGain * k + p] = (int32_t)((next << sh) - 1);
          part[kVid * k + p] = -1;
          ns = -1;
        } else if (sh == 0) {  // the gain is known: on to the vids
          part[kGain * k + p] = (int32_t)next;
          part[kPrefix * k + p] = 0;
        } else {
          part[kPrefix * k + p] = (int32_t)next;
        }
      } else if (st.count == rest || sh == 0) {
        part[kVid * k + p] = (int32_t)(((next + 1) << sh) - 1);
        ns = -1;
      } else {
        part[kPrefix * k + p] = (int32_t)next;
      }
      if (ns >= 0) {
        part[kNeed * k + p] = rest;
      } else {
        atomicSub(ctl + kActive, 1);
      }
      part[kState * k + p] = ns;
    }
  }
}

// The whole plan, one cooperative launch: the count, the first walk,
// then digit steps (binning, walk) while a part is open, then out[v] =
// best[v] for the accepted movers of the parity, else assign[v], for
// every row v <= n. Grid barriers between the phases; every block reads
// the open parts' count after the same barrier, so all leave together.
template <bool kShared>
__global__ void __launch_bounds__(kPlanThreads)
plan_moves_kernel(const int32_t* __restrict__ best,
                  const int32_t* __restrict__ gain,
                  const int32_t* __restrict__ assign, int64_t n, int32_t k,
                  int parity, int bins0, int32_t cap, int vid_passes,
                  int32_t* __restrict__ hist, int32_t* __restrict__ part,
                  int32_t* __restrict__ ctl, int4* __restrict__ cand,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[kActive] = 0;
    ctl[kCands] = 0;
  }
  plan_count<kShared>(best, gain, assign, n, k, parity, bins0, hist, part,
                      sm);
  grid.sync();
  plan_walk0(k, bins0, cap, hist, part, ctl);
  grid.sync();
  for (int pass = 0; pass < kGainPasses + vid_passes; ++pass) {
    if (__ldcg(ctl + kActive) == 0) break;
    plan_bin(best, gain, n, k, parity, bins0, pass, vid_passes, hist, part,
             ctl, cand);
    grid.sync();
    plan_walk(k, vid_passes, hist, part, ctl);
    grid.sync();
  }
  const int32_t* thr = part + kGain * k;
  const int32_t* last = part + kVid * k;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v0 <= n;
       v0 += kUnroll * step) {
    int32_t r[kUnroll], g[kUnroll], p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * step;
      r[u] = v <= n ? assign[v] : 0;
      g[u] = v < n && (v & 1) == parity ? gain[v] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      p[u] = g[u] > 0 ? best[v0 + u * step] : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * step;
      if (g[u] > 0 && (uint32_t)p[u] < (uint32_t)k) {
        const int32_t t = thr[p[u]];
        if (g[u] > t || (g[u] == t && v <= last[p[u]])) r[u] = p[u];
      }
      if (v <= n) out[v] = r[u];
    }
  }
}

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

Wave count_wave, stats_wide_wave;

// the card's SMs and the blocks of `threads` with `smem` bytes of dynamic
// shared memory one SM holds, with the opt-in to that much shared memory
template <typename Kernel>
cudaError_t resident(Kernel kernel, int threads, size_t smem,
                     long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// How a call bins its updates (see the top of the file): into tiles when
// its updates are dense (at least one for eight cells) and a tile of rows
// fits in shared memory with at most kMaxBuckets of them, else into
// kMaxBuckets ranges for the hashed apply; a word must stay below 2^31.
struct Binning {
  bool tiled;
  int shift_b, col_bits, buckets;
};

cudaError_t binning(long long rows, int k, long long m, Binning* b) {
  b->shift_b = 0;
  if (k <= kTileCells)
    while ((2LL << b->shift_b) * k <= kTileCells) ++b->shift_b;
  b->tiled = k <= kTileCells &&
             ((rows - 1) >> b->shift_b) + 1 <= kMaxBuckets &&
             16 * m >= rows * k;
  if (!b->tiled) b->shift_b = 0;
  while (((rows - 1) >> b->shift_b) + 1 > kMaxBuckets) ++b->shift_b;
  b->buckets = (int)(((rows - 1) >> b->shift_b) + 1);
  b->col_bits = bit_length(k - 1);
  return b->shift_b + b->col_bits <= 31 ? cudaSuccess
                                         : cudaErrorInvalidValue;
}

}  // namespace

// int32 words of neighbor_hist's metadata scratch, zeroed once when it is
// allocated: every call leaves it ready for the next.
extern "C" int sheep_refine_hist_meta_words() { return kMetaWords; }

// hist [rows, k] += the chunk's edges [m, 2] (rows = n + 1, or vb in
// blocked mode with rows [base, base + vb) kept); counts [2] (uint64, may
// be null) += (cut, total) of the chunk. Scratch: words, uint32 [>= 2m];
// meta, int32 [sheep_refine_hist_meta_words()], zeroed before first use.
extern "C" int sheep_refine_hist(const void* edges, long long m,
                                 const void* assign, int n, int k,
                                 int blocked, long long base, long long vb,
                                 void* hist, void* counts, void* words,
                                 long long words_cap, void* meta,
                                 void* stream) {
  if (m < 0 || m >= (1LL << 30) || n < 0 || k < 1 || (blocked && vb < 1) ||
      words_cap < 2 * m)
    return (int)cudaErrorInvalidValue;
  const long long rows = blocked ? vb : n;
  if (m == 0 || rows == 0) return 0;
  Binning bin;
  cudaError_t err = binning(rows, k, m, &bin);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* total = (int32_t*)meta;
  int32_t* start = total + kMaxBuckets;
  int32_t* cursor = start + kMaxBuckets + 1;
  int32_t* items = cursor + kMaxBuckets;
  int32_t* work = items + kMaxBuckets + 1;
  const long long at = blocked ? base : 0;
  unsigned blocks = 0;
  err = wave_blocks(count_wave, hist_count, m, &blocks);
  if (err != cudaSuccess) return (int)err;
  hist_count<<<blocks, kThreads, (size_t)bin.buckets * 4, s>>>(
      (const int2*)edges, m, n, at, rows, bin.shift_b, bin.buckets, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_scan<<<1, kBigThreads, 0, s>>>(
      total, bin.buckets, bin.tiled ? kItemUpdates : kHashItem, start,
      cursor, items, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long cap = 0;
  err = resident(hist_scatter, kBigThreads, kScatterSmem, &cap);
  if (err != cudaSuccess) return (int)err;
  const long long batches = (m + kBatchEdges - 1) / kBatchEdges;
  hist_scatter<<<(unsigned)(batches < cap ? batches : cap), kBigThreads,
                 kScatterSmem, s>>>(
      (const int2*)edges, m, (const int32_t*)assign, n, at, rows,
      bin.shift_b, bin.col_bits, cursor, (uint32_t*)words,
      (unsigned long long*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t item_smem = (size_t)((bin.buckets + 4) & ~3) * 4;
  if (bin.tiled) {
    const size_t smem = item_smem + (size_t)kItemUpdates * 4 +
                        (((size_t)k << bin.shift_b) + kList) * 4;
    const int vec = (uintptr_t)hist % 16 == 0 &&
                    ((long long)k << bin.shift_b) % 4 == 0;
    err = resident(hist_apply_tile, kBigThreads, smem, &cap);
    if (err != cudaSuccess) return (int)err;
    hist_apply_tile<<<(unsigned)cap, kBigThreads, smem, s>>>(
        (const uint32_t*)words, start, items, bin.buckets, work, rows, k,
        bin.shift_b, bin.col_bits, vec, (int32_t*)hist);
  } else {
    const size_t smem = item_smem + (size_t)kHashSlots * 8;
    err = resident(hist_apply_hash, kBigThreads, smem, &cap);
    if (err != cudaSuccess) return (int)err;
    hist_apply_hash<<<(unsigned)cap, kBigThreads, smem, s>>>(
        (const uint32_t*)words, start, items, bin.buckets, work, k,
        bin.shift_b, bin.col_bits, (int32_t*)hist);
  }
  return (int)cudaGetLastError();
}

// best, bestv, cur, gain [rows] <- the stats of hist [rows, k] at the
// current parts cur_part [rows].
extern "C" int sheep_refine_stats(const void* hist, long long rows, int k,
                                  const void* cur_part, void* best,
                                  void* bestv, void* cur, void* gain,
                                  void* stream) {
  if (rows < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int tile_rows = kStageBytes / 4 / k;
  if (tile_rows > kStatsMaxTileRows) tile_rows = kStatsMaxTileRows;
  tile_rows &= ~3;
  cudaError_t err;
  if (tile_rows < 4) {
    unsigned blocks = 0;
    err = wave_blocks(stats_wide_wave, hist_stats_wide, rows * kThreads,
                      &blocks);
    if (err != cudaSuccess) return (int)err;
    hist_stats_wide<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)hist, rows, k, (const int32_t*)cur_part,
        (int32_t*)best, (int32_t*)bestv, (int32_t*)cur, (int32_t*)gain);
    return (int)cudaGetLastError();
  }
  const bool vec = k % 4 == 0;
  const int width = vec ? k / 4 : k;
  int lanes = 1;
  while (lanes < width && lanes < 32) lanes <<= 1;
  const int bulk = (uintptr_t)hist % 16 == 0;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  long long cap = 0;
  if (vec) {
    err = resident(hist_stats_ring<4>, kStatsThreads, kStatsSmem, &cap);
    if (err != cudaSuccess) return (int)err;
    hist_stats_ring<4><<<(unsigned)(tiles < cap ? tiles : cap),
                         kStatsThreads, kStatsSmem, s>>>(
        (const int32_t*)hist, rows, k, tile_rows, lanes, bulk,
        (const int32_t*)cur_part, (int32_t*)best, (int32_t*)bestv,
        (int32_t*)cur, (int32_t*)gain);
  } else {
    err = resident(hist_stats_ring<1>, kStatsThreads, kStatsSmem, &cap);
    if (err != cudaSuccess) return (int)err;
    hist_stats_ring<1><<<(unsigned)(tiles < cap ? tiles : cap),
                         kStatsThreads, kStatsSmem, s>>>(
        (const int32_t*)hist, rows, k, tile_rows, lanes, bulk,
        (const int32_t*)cur_part, (int32_t*)best, (int32_t*)bestv,
        (int32_t*)cur, (int32_t*)gain);
  }
  return (int)cudaGetLastError();
}

// The count's bins a part, a power of two: shared counters (bins, loads
// and movers of every part) when kPlanSmem holds them with at least 16
// bins, else kDigits bins counted by global atomics.
static int plan_bins(int k, bool* shared) {
  for (int b = kDigits; b >= 16; b >>= 1)
    if (4LL * k * (b + 2) <= kPlanSmem) {
      *shared = true;
      return b;
    }
  *shared = false;
  return kDigits;
}

// the vid digits of n rows: enough for n - 1, the largest mover's vid
static int vid_passes(long long n) {
  return (bit_length(n > 2 ? n - 1 : 1) + kDigitBits - 1) / kDigitBits;
}

// The rows of a parity half-round, ceil(n / 2) rounded for either parity:
// the most candidates a call keeps.
extern "C" long long sheep_refine_plan_rows(long long n) {
  return (n + 1) / 2;
}

// Scratch words: hist int32 [k * digits], part int32 [part_words * k],
// ctl int32 [ctl_words], all zero before the first call (every call
// leaves the bins, loads and movers zero); cand int4
// [sheep_refine_plan_rows(n)].
extern "C" int sheep_refine_plan_digits() { return kDigits; }
extern "C" int sheep_refine_plan_part_words() { return kPartWords; }
extern "C" int sheep_refine_plan_ctl_words() { return kPlanCtl; }

// out [n + 1] <- assign [n + 1] with the accepted movers of the parity
// moved to their best part: one cooperative launch of the blocks the card
// holds at once.
extern "C" int sheep_refine_plan(const void* best, const void* gain,
                                 const void* assign, int n, int k, int cap,
                                 int parity, void* hist, void* part,
                                 void* ctl, void* cand, void* out,
                                 void* stream) {
  if (n < 0 || k < 1 || (parity != 0 && parity != 1))
    return (int)cudaErrorInvalidValue;
  bool shared = false;
  int bins0 = plan_bins(k, &shared);
  const size_t smem = shared ? (size_t)4 * k * (bins0 + 2) : 0;
  const void* kernel = shared ? (const void*)plan_moves_kernel<true>
                              : (const void*)plan_moves_kernel<false>;
  long long blocks = 0;
  cudaError_t err = shared ? resident(plan_moves_kernel<true>, kPlanThreads,
                                      smem, &blocks)
                           : resident(plan_moves_kernel<false>, kPlanThreads,
                                      0, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long rows = sheep_refine_plan_rows(n);
  const long long want = (rows + kPlanThreads - 1) / kPlanThreads;
  if (want < blocks) blocks = want > 0 ? want : 1;
  int64_t n64 = n;
  int vp = vid_passes(n);
  void* args[] = {(void*)&best, (void*)&gain, (void*)&assign, &n64, &k,
                  &parity, &bins0, &cap, &vp, &hist, &part, &ctl, &cand,
                  &out};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                          dim3(kPlanThreads), args, smem,
                                          (cudaStream_t)stream);
}

extern "C" const char* sheep_refine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
