// sheep_core — the port's native host code: the greedy tree split, the
// text edge-list parser, the elimination-forest pass of the fixpoint's
// host tail and the host loops of the counter-hash generators.
//
// Copies of sheep_tree_split, sheep_parse_text, sheep_build_elim_tree,
// sheep_rmat_hash_range and sheep_sbm_hash_range from the JAX package's
// native core (sheep_tpu/core/csrc/sheep_core.cpp), so that the port
// imports and builds nothing of that package. The Python copy of the spec
// (sheep_tpu_torch/core/pure.py tree_split) and this function give
// bit-identical assignments; the tests hold both, and the JAX package's
// two, to each other. Exposed as a plain C ABI over caller-allocated
// numpy buffers, loaded with ctypes (sheep_tpu_torch/core/native.py) and
// built with the host C++ compiler at first use (sheep_tpu_torch/ops/
// _build.py), without -march=native or floating-point contraction.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <queue>
#include <utility>
#include <vector>

using i64 = int64_t;
using i32 = int32_t;

extern "C" {

// ------------------------------------------------------------ tree split

// Greedy bag-packing split — the same semantics as the Python reference
// (sheep_tpu_torch/core/pure.py tree_split): walk vertices in ascending
// elimination order accumulating un-assigned subtree weight; at capacity,
// first-fit-pack child subtrees (descending) into <=cap bags handed to the
// least-loaded part. See that docstring for the invariants.
//
// Unlike the JAX package's copy, it checks the two arguments it indexes
// by, in the O(n) passes it makes anyway, and writes nothing to assign
// when one is bad: it returns -1 when pos is not a permutation of [0, n),
// -2 when parent is not a forest in pos order (a parent >= n, or one that
// does not come after its child), and 0 otherwise.
int sheep_tree_split(const i64* parent, const i64* pos, const double* w,
                     i64 n, i64 k, double alpha, i32* assign) {
  // w == nullptr means unit weights — callers need not materialize an
  // O(n) array of ones (8 GB at n = 2^30)
  auto W = [&](i64 v) { return w ? w[v] : 1.0; };

  // pos is a permutation of [0, n), so the position-order walk is its
  // inverse — O(n) fill instead of an O(n log n) comparator sort
  std::vector<i64> order(n, -1);
  for (i64 v = 0; v < n; ++v) {
    const i64 p = pos[v];
    if (p < 0 || p >= n || order[p] >= 0) return -1;
    order[p] = v;
  }

  double total = 0;
  for (i64 v = 0; v < n; ++v) total += W(v);
  double cap = std::max(alpha * total / double(k), 1.0);

  // children of v, position-ordered, in CSR layout: vertices are
  // processed in position order and every child precedes its parent,
  // so the original per-vertex push_back discovery order IS position
  // order — and "still uncut when the parent processes" is exactly
  // cut_part[c] < 0 at that moment. One flat array replaces the old
  // vector-of-vectors (whose 24 B/vertex of headers alone was 26 GB
  // at n = 2^30, the RMAT-30 class this split must handle).
  std::vector<i64> kid_off(n + 1, 0);
  for (i64 v = 0; v < n; ++v) {
    if (parent[v] < 0) continue;
    if (parent[v] >= n || pos[parent[v]] <= pos[v]) return -2;
    ++kid_off[parent[v] + 1];
  }
  for (i64 v = 0; v < n; ++v) kid_off[v + 1] += kid_off[v];
  std::vector<i64> kid_list(kid_off[n]);
  {
    std::vector<i64> fill(kid_off.begin(), kid_off.end() - 1);
    for (i64 idx = 0; idx < n; ++idx) {
      i64 v = order[idx];
      if (parent[v] >= 0) kid_list[fill[parent[v]]++] = v;
    }
  }

  std::vector<double> rem(n);
  for (i64 v = 0; v < n; ++v) rem[v] = W(v);
  std::vector<i32> cut_part(n, -1);

  // least-loaded part heap: (load, part), min by load then part id
  using Entry = std::pair<double, i64>;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> loads;
  for (i64 p = 0; p < k; ++p) loads.push({0.0, p});

  auto flush = [&](const std::vector<i64>& bag, i64 extra, double bagw) {
    Entry e = loads.top();
    loads.pop();
    for (i64 x : bag) cut_part[x] = (i32)e.second;
    if (extra >= 0) cut_part[extra] = (i32)e.second;
    loads.push({e.first + bagw, e.second});
  };

  std::vector<i64> bag;
  std::vector<i64> kids;  // reused scratch: the uncut children of v
  for (i64 idx = 0; idx < n; ++idx) {
    i64 v = order[idx];
    kids.clear();
    for (i64 j = kid_off[v]; j < kid_off[v + 1]; ++j) {
      i64 c = kid_list[j];
      if (cut_part[c] < 0) kids.push_back(c);
    }
    double tot = W(v);
    for (i64 c : kids) tot += rem[c];
    bool is_root = parent[v] < 0;
    if (tot < cap && !is_root) {
      rem[v] = tot;
      continue;
    }
    // stable: equal-rem ties keep discovery order, matching the Python
    // reference's list.sort so native/pure assignments are bit-identical
    std::stable_sort(kids.begin(), kids.end(),
                     [&](i64 a, i64 b) { return rem[a] > rem[b]; });
    bag.clear();
    double bagw = 0.0;
    for (i64 c : kids) {
      if (!bag.empty() && bagw + rem[c] > cap) {
        flush(bag, -1, bagw);
        bag.clear();
        bagw = 0.0;
      }
      bag.push_back(c);
      bagw += rem[c];
    }
    if (is_root || bagw + W(v) >= cap) {
      flush(bag, v, bagw + W(v));
    } else {
      rem[v] = bagw + W(v);
    }
  }

  // top-down labeling: nearest cut ancestor owns the vertex
  for (i64 idx = n - 1; idx >= 0; --idx) {
    i64 v = order[idx];
    assign[v] = cut_part[v] >= 0 ? cut_part[v]
                                 : (parent[v] >= 0 ? assign[parent[v]] : 0);
  }
  return 0;
}

// ----------------------------------------------------- text edge parsing

// The reference's default text grammar (its sheep_parse_text): complete
// lines of buf only. A line's leading spaces, tabs and '\r' are skipped;
// a line that then starts with '#' or '%' is a comment. A field is a run
// of the digits 0-9 and ends at the first other byte, so a sign makes the
// line malformed and "6 7.0" reads (6, 7); the two fields are separated
// by spaces and tabs, and whatever follows the second is ignored. A line
// without two fields is skipped. Writes at most max_edges (u, v) pairs to
// out and returns their number; *consumed is the length of the prefix of
// buf whose lines were parsed (the caller feeds the rest again, with the
// next block, or with a '\n' appended at the end of the input).
i64 sheep_parse_text(const char* buf, i64 len, i64* out, i64 max_edges,
                     i64* consumed) {
  i64 w = 0;
  i64 i = 0;
  *consumed = 0;
  while (i < len && w < max_edges) {
    i64 j = i;
    while (j < len && buf[j] != '\n') j++;
    if (j == len) break;  // incomplete line: left for the next block
    i64 p = i;
    while (p < j && (buf[p] == ' ' || buf[p] == '\t' || buf[p] == '\r')) p++;
    if (p < j && buf[p] != '#' && buf[p] != '%') {
      i64 u = 0, v = 0;
      bool ok = false;
      while (p < j && buf[p] >= '0' && buf[p] <= '9') {
        u = u * 10 + (buf[p] - '0');
        p++;
        ok = true;
      }
      while (p < j && (buf[p] == ' ' || buf[p] == '\t')) p++;
      bool ok2 = false;
      while (p < j && buf[p] >= '0' && buf[p] <= '9') {
        v = v * 10 + (buf[p] - '0');
        p++;
        ok2 = true;
      }
      if (ok && ok2) {
        out[2 * w] = u;
        out[2 * w + 1] = v;
        w++;
      }
    }
    i = j + 1;
    *consumed = i;
  }
  return w;
}

// ------------------------------------------------------- elim tree build

// Extend the elimination forest `parent` (int64[n], -1 for a root) in
// place with the constraints of m edges (pairs of vertex ids; self-loops
// and ids outside [0, n) are skipped): Liu's sorted union-find pass over
// the forest's tree edges and the edges, as the reference's
// sheep_build_elim_tree. Constraints are counting-sorted by the position
// of their later endpoint; in that order each links the root of its
// earlier endpoint's component under the later endpoint (a fresh DSU with
// path compression; a component's root is its latest vertex). The result
// is the unique elimination forest of the forest's edges and the new
// ones, which is what the fixpoint's host tail needs.
//
// Unlike the JAX package's copy, it checks what it indexes by, in the
// O(n) passes it makes anyway, and changes nothing when one is bad: it
// returns -1 when pos is not a permutation of [0, n), -2 when a parent is
// >= n, and 0 otherwise.
int sheep_build_elim_tree(const i64* edges, i64 m, const i64* pos, i64 n,
                          i64* parent) {
  // order[p] = vertex at position p
  std::vector<i64> order(n, -1);
  for (i64 v = 0; v < n; ++v) {
    const i64 p = pos[v];
    if (p < 0 || p >= n || order[p] >= 0) return -1;
    order[p] = v;
  }
  for (i64 v = 0; v < n; ++v)
    if (parent[v] >= n) return -2;

  // constraints (key, lo), key = the later endpoint's position; a tree
  // edge v -> parent[v] gives (pos[parent[v]], v)
  std::vector<i64> counts(n + 1, 0);
  auto skip = [&](i64 a, i64 b) {
    return a == b || a < 0 || b < 0 || a >= n || b >= n;
  };
  for (i64 v = 0; v < n; ++v)
    if (parent[v] >= 0) counts[pos[parent[v]]]++;
  for (i64 i = 0; i < m; ++i) {
    const i64 a = edges[2 * i], b = edges[2 * i + 1];
    if (!skip(a, b)) counts[std::max(pos[a], pos[b])]++;
  }
  i64 total = 0;
  for (i64 p = 0; p <= n; ++p) {
    const i64 c = counts[p];
    counts[p] = total;
    total += c;
  }
  std::vector<i64> keys(total), los(total);
  auto place = [&](i64 lo, i64 k) {
    const i64 at = counts[k]++;
    keys[at] = k;
    los[at] = lo;
  };
  for (i64 v = 0; v < n; ++v)
    if (parent[v] >= 0) place(v, pos[parent[v]]);
  for (i64 i = 0; i < m; ++i) {
    i64 a = edges[2 * i], b = edges[2 * i + 1];
    if (skip(a, b)) continue;
    if (pos[a] > pos[b]) std::swap(a, b);
    place(a, pos[b]);
  }

  // Liu's pass
  std::vector<i64> dsu(n);
  std::iota(dsu.begin(), dsu.end(), 0);
  auto find = [&](i64 x) {
    i64 root = x;
    while (dsu[root] != root) root = dsu[root];
    while (dsu[x] != root) {
      const i64 nx = dsu[x];
      dsu[x] = root;
      x = nx;
    }
    return root;
  };
  for (i64 i = 0; i < total; ++i) {
    const i64 hi = order[keys[i]];
    const i64 r = find(los[i]);
    if (r != hi) {
      parent[r] = hi;
      dsu[r] = hi;
    }
  }
  return 0;
}

// ------------------------------------------------ counter-hash generators

// murmur3 fmix32 over elo ^ key, folded with ehi ^ key2 mid-mix: one field
// of edge counter (ehi, elo), as io/generators.py _hash_fields
static inline uint32_t hash_field(uint32_t elo, uint32_t ehi, uint32_t key,
                                  uint32_t key2) {
  uint32_t h = elo ^ key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= ehi ^ key2;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Edges [start, start+count) of the counter-hash R-MAT stream into out
// (count, 2), bit-equal to io/generators.py _rmat_hash_uv: one field a
// bit level, the two 16-bit halves against the integer thresholds.
void sheep_rmat_hash_range(i64 scale, i64 start, i64 count,
                           const uint32_t* keys, const uint32_t* keys2,
                           uint32_t t_u, uint32_t t_v0, uint32_t t_v1,
                           i64* out) {
  for (i64 i = 0; i < count; ++i) {
    uint64_t e = (uint64_t)(start + i);
    uint32_t elo = (uint32_t)e, ehi = (uint32_t)(e >> 32);
    uint32_t u = 0, v = 0;
    for (i64 b = 0; b < scale; ++b) {
      uint32_t h = hash_field(elo, ehi, keys[b], keys2[b]);
      uint32_t ubit = (h >> 16) < t_u;
      uint32_t vbit = (h & 0xFFFFu) < (ubit ? t_v1 : t_v0);
      u |= ubit << b;
      v |= vbit << b;
    }
    out[2 * i] = (i64)u;
    out[2 * i + 1] = (i64)v;
  }
}

// Edges [start, start+count) of the counter-hash planted partition into
// out (count, 2), bit-equal to io/generators.py _sbm_hash_uv: five fields
// (decide, bu, bv, uoff, voff).
void sheep_sbm_hash_range(i64 start, i64 count, const uint32_t* keys,
                          const uint32_t* keys2, uint32_t t_out,
                          i64 n_blocks, i64 block_bits, i64* out) {
  uint32_t nb1 = (uint32_t)(n_blocks - 1);
  uint32_t off_mask = (uint32_t)((1u << block_bits) - 1u);
  for (i64 i = 0; i < count; ++i) {
    uint64_t e = (uint64_t)(start + i);
    uint32_t elo = (uint32_t)e, ehi = (uint32_t)(e >> 32);
    uint32_t f[5];
    for (int j = 0; j < 5; ++j) f[j] = hash_field(elo, ehi, keys[j], keys2[j]);
    uint32_t bu = f[1] & nb1;
    uint32_t bvr = f[2] % nb1;  // [0, n_blocks-1)
    uint32_t bv = bvr + (bvr >= bu ? 1u : 0u);
    uint32_t b2 = (f[0] < t_out) ? bv : bu;
    out[2 * i] = (i64)(((uint64_t)bu << block_bits) | (f[3] & off_mask));
    out[2 * i + 1] = (i64)(((uint64_t)b2 << block_bits) | (f[4] & off_mask));
  }
}

// ------------------------------------------------------------- utilities

i64 sheep_core_abi_version() { return 5; }

}  // extern "C"
