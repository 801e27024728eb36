// K4: fm_bfs -- the range BFS (the reference's FMTree locate) on the block
// table (fm_common.cuh): the text positions of the row ranges of a query
// batch on an index whose source suffix array is only k-ordered, and the
// (total, checksum) pair of those positions.
//
// Replaces:
//   kt_fm_bfs_stats    -> batch_bfs_stats_device (kiss_tpu/models/
//                         fm_index.py:695-711) and the host's sum(lo) +
//                         (sum(hi) << 16) checksum assembly (:1041-1044);
//   kt_fm_bfs_segments +
//   kt_fm_bfs_expand   -> bfs_locate_device / _bfs_emit (:640-692).
//
// What is computed. Query q's tree has the node [beg[q], end[q]) at depth
//   0; the children of a node [b, e) at depth d < sa_intv - 1 are
//   [LF(c, b), LF(c, e)) for c = 0..3 (column = parent column * 4 + c).
//   Each node emits sa_samp[mark_rank(b) .. mark_rank(e)) + d. The
//   positions come query-major, within a query by depth, within a depth by
//   column: kiss_tpu's order. An empty node has only empty children and
//   emits nothing, so only non-empty nodes are walked (the reference also
//   expands only what it finds, fm_index.hpp:486-489).
//
// What bounds it on the H100: dependent random reads. A node needs the
//   block-table entries of its two endpoints (one 32-byte sector each, the
//   24.4 MB table at N = 48.8M stays in L2), which give its mark ranks and
//   all four children's LFs; a child's entries depend on them. The
//   positions are random reads of sa_samp (98 MB at N = 48.8M), one an
//   occurrence.
//
// What the design does about it. A thread a query walking its tree depth
//   first (the design before this one) spent 70% of its stats time on the
//   walk alone, kept its stack in local memory, ran the lanes of a warp on
//   trees of different shapes, and walked each tree twice to locate. Here:
//   - a block takes a tile of kThreads queries, 32 a warp, and each warp
//     walks its queries' trees level by level with no barrier but its own,
//     in rounds of 32 nodes of one level: a lane reads its node's first row
//     and, for a wider node, its end, both entries in flight together, and
//     takes there the mark rank, the mark and BWT symbol and all four LFs.
//     A one-row node's child is the LF of its symbol; a wider node's are
//     the non-empty [LF(c, b), LF(c, e)). Rows are below 2^32 (the wrapper
//     refuses larger indexes), so the arithmetic is 32-bit, and the
//     superblock values come from one 16-byte load (fm_index.block_table
//     keeps K4's 32-bit copy of them at the end of each superblock row).
//   - the frontier lives in shared memory, the levels one after another:
//     the children of a round are appended by a warp ballot of their
//     counts, so each level stays in (query, column) order, and a visited
//     node's rows are overwritten by its segment (mark rank, marked rows).
//     No stack and no local memory.
//   - the frontier is bounded: LF maps rows one to one, so the nodes of one
//     depth are disjoint and a query of len rows has at most min(4^d, len)
//     of them at depth d, at most t = sum_d min(4^d, len) in its tree. A
//     warp keeps in shared memory, in query order, the queries with t <=
//     kWideNodes while their t sum to at most its part of the frontier. The
//     others (a range of a quarter of the SA, a warp already full) take the
//     spill route: the same rounds of the same walk, with their levels in
//     the warp's share of a global pool, taken by one atomic add of their
//     t. A launch whose warps need more pool than the caller gave reports
//     the exact need, from the lengths alone, and is run again.
//   - stats (kt_fm_bfs_stats): a node's positions sum in O(1) from
//     samp_sum (prefix sums of sa_samp, a table of the index):
//     samp_sum[me] - samp_sum[mb] + d (me - mb). The two reads are issued
//     at one visit and added two visits later, so they overlap the walk.
//     Block sums go in by one 64-bit atomic each: integer sums, in any
//     order.
//   - locate (kt_fm_bfs_segments, then kt_fm_bfs_expand) walks each tree
//     once. After the walk a tile knows each query's segments and rows; a
//     block scan gives each query its offsets in the tile, and a decoupled
//     look-back (K1's scheme: tiles take their numbers from an atomic
//     ticket, so one only waits for tiles that have started, publish their
//     aggregate, then their inclusive prefix) gives the tile its global
//     (segments, rows): the first warp reads the statuses of the 32 tiles
//     before at once and sums back to the nearest inclusive prefix. Then
//     each warp writes its segments (output offset, sa_samp start | depth)
//     in kiss_tpu's order, level by level. The segment arrays are sized by
//     the caller and every write is bounded; the last tile reports the true
//     (segments, positions), which the host reads once. kt_fm_bfs_expand
//     then runs over the output slots on the blocks the card holds at once,
//     each slot finding its segment by a binary search of the offsets, so
//     one range of a quarter of the SA is spread over the card. sa_samp is
//     read and the positions written evict-first, so the block table stays
//     in L2.
//
// The level bookkeeping is sized by a compile-time bound on sa_intv: 8 (the
// CLI uses 4) or 32; the C entry points refuse other values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;  // a block: a tile of kThreads queries
constexpr int kWarps = kThreads / 32;
constexpr int kSmallIntv = 8;
constexpr int kLargeIntv = 32;
// a query whose tree may hold more nodes takes the spill route
constexpr long long kWideNodes = 64;
// a segment's sa_samp start with its depth in the top bits
constexpr int kDepthShift = 58;
constexpr long long kStartMask = (1ll << kDepthShift) - 1;
// report (int64 [4]): stats (total, checksum, spilled queries, pool
// need); locate (segments, positions, spilled queries, pool need)
constexpr int kReport = 4;
constexpr int kSpilled = 2;
constexpr int kPoolNeed = 3;
// look-back status of a tile: flag, aggregate (segments, rows), inclusive
// prefix (segments, rows)
constexpr int kStatus = 5;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
constexpr unsigned long long kSpinLimitNs = 4000000000ull;  // 4 s
// a scan of (rows | segment << 48) over a round: rows below 2^48
constexpr unsigned long long kRowMask = (1ull << 48) - 1;

struct Tables {
  const uint4* blk;
  const long long* sup;
  const long long* pri;
  int sa_intv;
};

// A frontier: nodes appended level after level, node i is rows [x[i],
// y[i]) of the tile's query q[i] until it is visited, then (its mark rank,
// its marked rows). In shared memory, or the tile's share of the pool.
struct Store {
  uint32_t* x;
  uint32_t* y;
  uint8_t* q;
};

// a warp's part of a tile's frontier holds kPerWarp nodes (the levels of
// its 32 queries' trees): kMaxIntv a query, 24 at the bound 32, which keeps
// the locate kernel within the 48 KB of static shared memory
template <int kMaxIntv>
struct Frontier {
  static constexpr int kPerWarp = 32 * (kMaxIntv <= kSmallIntv ? kMaxIntv : 24);
  uint32_t x[kWarps][kPerWarp];
  uint32_t y[kWarps][kPerWarp];
  uint8_t q[kWarps][kPerWarp];
};

// sum_d min(4^d, len), d < depth: the most non-empty nodes the tree of a
// range of len rows can hold
__device__ __forceinline__ long long tree_bound(long long len, int depth) {
  long long t = 0, w = 1;
  for (int d = 0; d < depth; ++d) {
    t += w < len ? w : len;
    if (w < len) w *= 4;
  }
  return t;
}

// K4 holds rows below 2^32, so the walk's arithmetic is 32-bit. Each
// superblock row of the table keeps a 32-bit copy of what K4 needs in its
// last 16 bytes (fm_index.block_table): LF(0..2, 65536 s) and the marks
// before row 65536 s; LF(3, x) = sum_c cnt[c] + x - [pri < x] - LF(0..2,
// x). A read at a row is then its entry and one 16-byte load, the same
// readers as fm_common.cuh's for all four symbols at once.
__device__ __forceinline__ fm::Entry entry_at(const uint4* __restrict__ blk,
                                              uint32_t i) {
  const uint4* p = blk + 2 * (i >> fm::kBlockShift);
  return fm::Entry{__ldg(p), __ldg(p + 1)};
}

__device__ __forceinline__ uint4 super_at(const long long* __restrict__ sup,
                                          uint32_t i) {
  return __ldg((const uint4*)(sup + (i >> fm::kSuperShift) * fm::kSupCols +
                              6));
}

// sum_c cnt[c]: the LFs at row 0 are the counts
__device__ __forceinline__ uint32_t cnt_sum(const long long* __restrict__ sup) {
  return (uint32_t)(__ldg(sup) + __ldg(sup + 1) + __ldg(sup + 2) +
                    __ldg(sup + 3));
}

// marked rows r < i (fm::mark_rank); sv: i's superblock words
__device__ __forceinline__ uint32_t rank_at(const fm::Entry& e,
                                            const uint4& sv, uint32_t i) {
  const uint32_t off = i & 63;
  const uint32_t lo = off >= 32 ? 0xFFFFFFFFu : (1u << off) - 1u;
  const uint32_t hi = off > 32 ? (1u << (off - 32)) - 1u : 0u;
  return sv.w + (e.marks.w >> 16) + __popc(e.marks.x & lo) +
         __popc(e.marks.y & hi);
}

// row i is marked | its BWT symbol << 1 (fm::marked, fm::bwt_at)
__device__ __forceinline__ uint32_t bits_at(const fm::Entry& e, uint32_t i) {
  const uint32_t off = i & 63;
  const uint32_t m = off < 32 ? e.marks.x >> off : e.marks.y >> (off - 32);
  const uint32_t w = off < 32 ? (off < 16 ? e.bwt.x : e.bwt.y)
                              : (off < 48 ? e.bwt.z : e.bwt.w);
  return (m & 1u) | ((w >> (2 * (off & 15))) & 3u) << 1;
}

// LF(c, i) for c = 0..3 (fm::lf): the superblock's, the counts of the rows
// [65536 s, 64 j) in the entry, and the dibits of the block below i, the
// sentinel row packing as symbol 0 and counting as none
__device__ __forceinline__ void lf_all(const fm::Entry& e, const uint4& sv,
                                       uint32_t cnts, uint32_t pri,
                                       uint32_t i, uint32_t* lf) {
  constexpr uint32_t kLanes = 0x55555555u;
  const uint32_t off = i & 63, block0 = i & ~63u, super0 = i & ~65535u;
  const uint32_t w[4] = {e.bwt.x, e.bwt.y, e.bwt.z, e.bwt.w};
  uint32_t n1 = 0, n2 = 0, n3 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int take = (int)off - 16 * k;  // dibits of word k below i
    const uint32_t m =
        take >= 16 ? kLanes : take <= 0 ? 0u : kLanes & ((1u << (2 * take)) - 1u);
    const uint32_t lo = w[k] & m, hi = (w[k] >> 1) & m;
    n1 += __popc(lo & ~hi);
    n2 += __popc(hi & ~lo);
    n3 += __popc(lo & hi);
  }
  const uint32_t n0 = off - n1 - n2 - n3 - (uint32_t)(block0 <= pri && pri < i);
  const uint32_t r0 = e.marks.z & 0xFFFFu, r1 = e.marks.z >> 16;
  const uint32_t r2 = e.marks.w & 0xFFFFu;
  const uint32_t before = (uint32_t)(super0 <= pri && pri < block0);
  const uint32_t r3 = (block0 - super0) - r0 - r1 - r2 - before;
  const uint32_t lf3 = cnts + super0 - (uint32_t)(pri < super0) - sv.x - sv.y -
                       sv.z;
  lf[0] = sv.x + r0 + n0;
  lf[1] = sv.y + r1 + n1;
  lf[2] = sv.z + r2 + n2;
  lf[3] = lf3 + r3 + n3;
}

__device__ __forceinline__ unsigned long long warp_incl(unsigned long long v,
                                                        int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// exclusive prefix of v over the block, and the block's sum in every
// thread; two barriers
__device__ __forceinline__ unsigned long long block_excl(
    unsigned long long v, unsigned long long* red, unsigned long long& sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long inc = warp_incl(v, lane);
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  unsigned long long before = 0;
  sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long s = red[w];
    before += w < warp ? s : 0ull;
    sum += s;
  }
  __syncthreads();
  return before + inc - v;
}

// the lanes below this one: their sum of k (0..7), by three ballots;
// total: the warp's sum
__device__ __forceinline__ int ballot_excl(int k, int lane, int& total) {
  const unsigned int below = (1u << lane) - 1u;
  int pre = 0;
  total = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const unsigned int m = __ballot_sync(kFull, (k >> b) & 1);
    pre += __popc(m & below) << b;
    total += __popc(m) << b;
  }
  return pre;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A tile's (segments, rows), then its flag: a reader that acquires the
// flag sees the values written before it. The aggregate and the inclusive
// prefix have their own slots, so neither is overwritten.
__device__ __forceinline__ void publish(unsigned long long* st,
                                        unsigned long long flag,
                                        unsigned long long segs,
                                        unsigned long long rows) {
  unsigned long long* v = st + (flag == kAggregate ? 1 : 3);
  __stcg(v, segs);
  __stcg(v + 1, rows);
  st_release(st, flag);
}

// The flag of a tile once it has published. Traps after kSpinLimitNs: a
// fault in the protocol must end in an error, not in a hung card.
__device__ __forceinline__ unsigned long long wait_flag(
    const unsigned long long* st) {
  unsigned long long f = ld_acquire(st);
  if (f) return f;
  const unsigned long long t0 = global_ns();
  for (unsigned int polls = 1;; ++polls) {
    f = ld_acquire(st);
    if (f) return f;
    if ((polls & 255u) == 0 && global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// Level 0 of a warp's 32 queries, query q0 + lane (the tile's query qt0 +
// lane): in the warp's part of the shared frontier, in query order, while
// the tree bounds sum to at most kPerWarp nodes; the others (a bound over
// kWideNodes, or no room left) in the warp's share of the pool (x, y and q
// arrays of pool_cap nodes each), taken by one atomic add. Sets s1 to that
// share; n0, n1: the nodes of level 0 in each store.
template <int kPerWarp>
__device__ __forceinline__ void setup(const Tables& t,
                                      const long long* __restrict__ beg,
                                      const long long* __restrict__ end,
                                      long long nq, long long q0, int qt0,
                                      const Store& s0, Store& s1,
                                      uint32_t& n0, uint32_t& n1,
                                      uint8_t* pool, long long pool_cap,
                                      unsigned long long* report) {
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  const long long q = q0 + lane;
  long long b = 0, e = 0;
  if (q < nq) {
    b = __ldg(beg + q);
    e = __ldg(end + q);
  }
  const long long len = e > b ? e - b : 0;
  const long long tb = tree_bound(len, t.sa_intv);
  const bool wide = tb > kWideNodes;
  const unsigned long long tc = wide ? 0ull : (unsigned long long)tb;
  const unsigned long long fill = warp_incl(tc, lane) - tc;
  const bool in_shared = len > 0 && !wide && fill + tc <= kPerWarp;
  const bool spilled = len > 0 && !in_shared;
  const unsigned int m0 = __ballot_sync(kFull, in_shared);
  const unsigned int m1 = __ballot_sync(kFull, spilled);
  const unsigned long long need =
      __shfl_sync(kFull, warp_incl(spilled ? (unsigned long long)tb : 0ull,
                                   lane), 31);
  // a warp's share is indexed in 32 bits: 32 ranges needing 2^32 nodes
  // (tens of GB of positions) end the launch with an error
  if (need >> 32) __trap();
  long long base = 0;
  if (lane == 0 && need) {
    base = (long long)atomicAdd(report + kPoolNeed, need);
    atomicAdd(report + kSpilled, (unsigned long long)__popc(m1));
  }
  base = __shfl_sync(kFull, base, 0);
  const bool ok = base + (long long)need <= pool_cap;
  s1.x = (uint32_t*)pool + base;
  s1.y = (uint32_t*)pool + pool_cap + base;
  s1.q = pool + 8 * pool_cap + base;
  if (in_shared) {
    const int i = __popc(m0 & below);
    s0.x[i] = (uint32_t)b;
    s0.y[i] = (uint32_t)e;
    s0.q[i] = (uint8_t)(qt0 + lane);
  }
  if (spilled && ok) {
    const int i = __popc(m1 & below);
    s1.x[i] = (uint32_t)b;
    s1.y[i] = (uint32_t)e;
    s1.q[i] = (uint8_t)(qt0 + lane);
  }
  n0 = __popc(m0);
  n1 = ok ? __popc(m1) : 0u;
  __syncwarp();
}

// Walk a warp's trees level by level, its shared and its spilled nodes of
// a level in the same rounds of 32 nodes, with no barrier but the warp's:
// visit(d, node, store, query, mark_rank(b), mark_rank(e)) once a node, in
// level order. levels (shared, or null) receives where each level starts
// in each store: [d] and [kMaxIntv + 1 + d].
//
// A lane reads at its node's first row and, for a wider node, at its end,
// both entries in flight together: the mark rank, the mark and BWT symbol,
// and all four LFs at each. So a one-row node and a wider one take the
// same steps, the wider one twice over, side by side.
template <int kMaxIntv, typename Visit, bool kSkeleton = false>
__device__ __forceinline__ void walk(const Tables& t, uint32_t pri,
                                     uint32_t cnts, const Store& s0,
                                     const Store& s1, uint32_t n0,
                                     uint32_t n1, uint32_t* levels,
                                     Visit& visit) {
  const int lane = threadIdx.x & 31;
  uint32_t begin0 = 0, end0 = n0, begin1 = 0, end1 = n1;
  for (int d = 0; d < t.sa_intv; ++d) {
    if (levels != nullptr && lane == 0) {
      levels[d] = begin0;
      levels[d + 1] = end0;
      levels[kMaxIntv + 1 + d] = begin1;
      levels[kMaxIntv + 2 + d] = end1;
    }
    const bool leaf = d + 1 == t.sa_intv;
    const uint32_t m0 = end0 - begin0, total = m0 + end1 - begin1;
    uint32_t next0 = end0, next1 = end1;
    for (uint32_t r = 0; r < total; r += 32) {
      const uint32_t i = r + lane;
      const bool active = i < total;
      const bool g = i >= m0;
      const uint32_t j = g ? begin1 + (i - m0) : begin0 + i;
      uint32_t* const sx = g ? s1.x : s0.x;
      uint32_t* const sy = g ? s1.y : s0.y;
      uint8_t* const sq = g ? s1.q : s0.q;
      uint32_t b = 0, e = 0;
      int ql = 0;
      if (active) {
        b = sx[j];
        e = sy[j];
        ql = sq[j];
      }
      const bool wide = !kSkeleton && active && e > b + 1;
      fm::Entry ab{}, ae{};
      uint4 sb{}, se{};
      if (kSkeleton) {
        // the experiment's skeleton: every node one row, its reads made up
        ab = fm::Entry{make_uint4(b, b * 3u, b * 5u, b * 7u),
                       make_uint4(b ^ 0x5555u, b * 11u, 0u, 0u)};
        sb = make_uint4(b & 1023u, 3u, 5u, 7u);
      } else if (active) {
        ab = entry_at(t.blk, b);
        sb = super_at(t.sup, b);
      }
      if (wide) {
        ae = entry_at(t.blk, e);
        se = super_at(t.sup, e);
      }
      uint32_t cb[4] = {0, 0, 0, 0}, ce[4] = {0, 0, 0, 0};
      unsigned int kids = 0;  // bit c: child c is non-empty
      if (active) {
        const uint32_t mb = rank_at(ab, sb, b);
        uint32_t me;
        if (!leaf) lf_all(ab, sb, cnts, pri, b, cb);
        if (wide) {
          me = rank_at(ae, se, e);
          if (!leaf) {
            lf_all(ae, se, cnts, pri, e, ce);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              kids |= (unsigned int)(cb[c] < ce[c]) << c;
            }
          }
        } else {
          // one row: its one child by its symbol (none at the sentinel
          // row), as the reference expands a singleton
          const uint32_t bits = bits_at(ab, b);
          me = mb + (bits & 1u);
          if (!leaf && b != pri) {
            const int c = (int)(bits >> 1);
            cb[0] = c == 0 ? cb[0] : c == 1 ? cb[1] : c == 2 ? cb[2] : cb[3];
            ce[0] = cb[0] + 1;
            kids = 1;
          }
        }
        visit(d, j, sx, sy, ql, mb, me);
      }
      // the children go to the end of their store's next level, in node
      // order and by symbol within a node
      const int nk = __popc(kids);
      int all0, all1 = 0, p1 = 0;
      const int p0 = ballot_excl(g ? 0 : nk, lane, all0);
      if (end1 > begin1) p1 = ballot_excl(g ? nk : 0, lane, all1);
      if (kids) {
        uint32_t pos = g ? next1 + p1 : next0 + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if ((kids >> c) & 1u) {
            sx[pos] = cb[c];
            sy[pos] = ce[c];
            sq[pos] = (uint8_t)ql;
            ++pos;
          }
        }
      }
      next0 += all0;
      next1 += all1;
    }
    __syncwarp();
    begin0 = end0;
    end0 = next0;
    begin1 = end1;
    end1 = next1;
  }
}

// stats: kMode 0 as the kernel runs; for the experiment alone (fm_query_
// time.py), 1 without the samp_sum reads, 2 with a visit that does nothing
// (the walk alone), 3 the walk's skeleton: no reads of the tables, every
// node one row with one child
template <int kMode>
struct StatsVisit {
  const long long* samp_sum;
  unsigned long long total, checksum;
  // samp_sum reads in flight, added two visits later
  long long hi, lo, hi2, lo2;

  __device__ __forceinline__ void fold() {
    // modulo 2^64, as the prefix sums and the plain int64 sum wrap
    checksum += (unsigned long long)hi2 - (unsigned long long)lo2;
    hi2 = hi;
    lo2 = lo;
    hi = lo = 0;
  }

  __device__ __forceinline__ void operator()(int d, uint32_t, uint32_t*,
                                             uint32_t*, int, uint32_t mb,
                                             uint32_t me) {
    if (kMode >= 2) return;
    fold();
    if (me > mb) {
      total += (unsigned long long)(me - mb);
      checksum += (unsigned long long)d * (unsigned long long)(me - mb);
      if (kMode == 0) {
        hi = __ldcs(samp_sum + me);
        lo = __ldcs(samp_sum + mb);
      } else {
        checksum += (unsigned long long)(me ^ mb);
      }
    }
  }
};

template <int kMaxIntv, int kMode>
__global__ void __launch_bounds__(kThreads, 7) bfs_stats_kernel(
    Tables t, const long long* __restrict__ samp_sum,
    const long long* __restrict__ beg, const long long* __restrict__ end,
    long long nq, uint8_t* pool, long long pool_cap,
    unsigned long long* __restrict__ out) {
  using F = Frontier<kMaxIntv>;
  __shared__ F f;
  __shared__ unsigned long long red[kWarps];
  const int warp = threadIdx.x >> 5;
  const Store s0{f.x[warp], f.y[warp], f.q[warp]};
  Store s1;
  uint32_t n0, n1;
  setup<F::kPerWarp>(t, beg, end, nq, (long long)blockIdx.x * kThreads + 32 * warp,
                     32 * warp, s0, s1, n0, n1, pool, pool_cap, out);
  StatsVisit<kMode> visit{samp_sum, 0ull, 0ull, 0ll, 0ll, 0ll, 0ll};
  walk<kMaxIntv, StatsVisit<kMode>, kMode == 3>(
      t, (uint32_t)__ldg(t.pri), cnt_sum(t.sup), s0, s1, n0, n1, nullptr,
      visit);
  visit.fold();
  visit.fold();
  unsigned long long total, checksum;
  block_excl(visit.total, red, total);
  block_excl(visit.checksum, red, checksum);
  if (threadIdx.x == 0) {
    if (total) atomicAdd(out, total);
    if (checksum) atomicAdd(out + 1, checksum);
  }
}

// locate: a node's segment in place of its rows, and its query's segments
// and rows counted
struct SegmentVisit {
  unsigned long long* segs;
  unsigned long long* rows;

  __device__ __forceinline__ void operator()(int, uint32_t j, uint32_t* sx,
                                             uint32_t* sy, int ql, uint32_t mb,
                                             uint32_t me) {
    sx[j] = mb;
    sy[j] = me - mb;
    if (me > mb) {
      atomicAdd(segs + ql, 1ull);
      atomicAdd(rows + ql, (unsigned long long)(me - mb));
    }
  }
};

// scratch: report [kReport], the ticket, then kStatus words a tile, all
// zero at launch
template <int kMaxIntv>
__global__ void __launch_bounds__(kThreads, 8) bfs_segments_kernel(
    Tables t, const long long* __restrict__ beg,
    const long long* __restrict__ end, long long nq, uint8_t* pool,
    long long pool_cap, long long* __restrict__ seg_off,
    long long* __restrict__ seg_start, long long seg_cap,
    unsigned long long* scratch) {
  using F = Frontier<kMaxIntv>;
  constexpr int kLevels = 2 * (kMaxIntv + 1);
  __shared__ F f;
  __shared__ uint32_t levels[kWarps][kLevels];
  __shared__ unsigned long long red[kWarps];
  // a query's segments and rows: in the walk, then in the level being
  // written
  __shared__ unsigned long long q_segs[kThreads], q_rows[kThreads];
  // a query's next segment and row in the tile
  __shared__ unsigned long long cur_seg[kThreads], cur_row[kThreads];
  // a level's segments and rows before the query's first node there
  __shared__ unsigned long long first_seg[kThreads], first_row[kThreads];
  __shared__ unsigned long long base[2];  // the tiles before: segments, rows
  __shared__ unsigned int s_tile;
  unsigned long long* report = scratch;
  unsigned long long* status = scratch + kReport + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (unsigned int)atomicAdd(scratch + kReport, 1ull);
  q_segs[tid] = q_rows[tid] = 0;
  __syncthreads();
  const unsigned int tile = s_tile;
  const Store s0{f.x[warp], f.y[warp], f.q[warp]};
  Store s1;
  uint32_t n0, n1;
  setup<F::kPerWarp>(t, beg, end, nq, (long long)tile * kThreads + 32 * warp,
                     32 * warp, s0, s1, n0, n1, pool, pool_cap, report);
  SegmentVisit visit{q_segs, q_rows};
  walk<kMaxIntv>(t, (uint32_t)__ldg(t.pri), cnt_sum(t.sup), s0, s1, n0, n1,
                 levels[warp], visit);
  __syncthreads();

  unsigned long long tile_segs, tile_rows;
  const unsigned long long my_segs = q_segs[tid], my_rows = q_rows[tid];
  cur_seg[tid] = block_excl(my_segs, red, tile_segs);
  cur_row[tid] = block_excl(my_rows, red, tile_rows);
  q_segs[tid] = q_rows[tid] = 0;
  // the look-back, by the first warp: its lanes read the statuses of the
  // 32 tiles before at once, and sum back to the nearest inclusive prefix
  if (warp == 0) {
    unsigned long long* mine = status + (long long)tile * kStatus;
    unsigned long long segs = 0, rows = 0;
    if (tile == 0) {
      if (lane == 0) publish(mine, kInclusive, tile_segs, tile_rows);
    } else {
      if (lane == 0) publish(mine, kAggregate, tile_segs, tile_rows);
      for (long long p = (long long)tile - 1 - lane;; p -= 32) {
        // before tile 0: an inclusive prefix of nothing
        unsigned long long fl = kInclusive, vs = 0, vr = 0;
        if (p >= 0) {
          const unsigned long long* st = status + p * kStatus;
          fl = wait_flag(st);
          const unsigned long long* v = st + (fl == kInclusive ? 3 : 1);
          vs = __ldcg(v);
          vr = __ldcg(v + 1);
        }
        const unsigned int inc = __ballot_sync(kFull, fl == kInclusive);
        const int k = inc ? __ffs(inc) - 1 : 32;  // the nearest inclusive
        if (lane > k) vs = vr = 0;
        segs += __shfl_sync(kFull, warp_incl(vs, lane), 31);
        rows += __shfl_sync(kFull, warp_incl(vr, lane), 31);
        if (inc) break;
      }
      if (lane == 0) publish(mine, kInclusive, segs + tile_segs, rows + tile_rows);
    }
    if (lane == 0) {
      base[0] = segs;
      base[1] = rows;
      if (tile == gridDim.x - 1) {
        report[0] = segs + tile_segs;
        report[1] = rows + tile_rows;
      }
    }
  }
  __syncthreads();

  // each warp writes its queries' segments, each at its place: the tiles
  // before, the tile's queries before, the query's segments at lower
  // depths, its segments before it at this depth (a level is in (query,
  // column) order)
  const uint32_t* lv = levels[warp];
  for (int g = 0; g < 2; ++g) {
    const uint32_t* const sx = g ? s1.x : s0.x;
    const uint32_t* const sy = g ? s1.y : s0.y;
    const uint8_t* const sq = g ? s1.q : s0.q;
    for (int d = 0; d < t.sa_intv; ++d) {
      const uint32_t lb = lv[g * (kMaxIntv + 1) + d];
      const uint32_t n = lv[g * (kMaxIntv + 1) + d + 1] - lb;
      unsigned long long lvl_segs = 0, lvl_rows = 0;
      for (uint32_t r = 0; r < n; r += 32) {
        const uint32_t i = r + lane;
        const uint32_t j = lb + i;
        unsigned long long cnt = 0;
        int ql = 0;
        bool first = false;
        if (i < n) {
          cnt = sy[j];
          ql = sq[j];
          first = i == 0 || sq[j - 1] != ql;
        }
        const unsigned long long v = cnt | (unsigned long long)(cnt > 0) << 48;
        const unsigned long long inc = warp_incl(v, lane);
        const unsigned long long sum = __shfl_sync(kFull, inc, 31);
        const unsigned long long sg = lvl_segs + ((inc - v) >> 48);
        const unsigned long long rw = lvl_rows + ((inc - v) & kRowMask);
        if (first) {
          first_seg[ql] = sg;
          first_row[ql] = rw;
        }
        __syncwarp();
        if (cnt > 0) {
          const unsigned long long idx =
              base[0] + cur_seg[ql] + (sg - first_seg[ql]);
          if (idx < (unsigned long long)seg_cap) {
            seg_off[idx] =
                (long long)(base[1] + cur_row[ql] + (rw - first_row[ql]));
            seg_start[idx] = (long long)sx[j] | ((long long)d << kDepthShift);
          }
          atomicAdd(q_segs + ql, 1ull);
          atomicAdd(q_rows + ql, cnt);
        }
        lvl_segs += sum >> 48;
        lvl_rows += sum & kRowMask;
        __syncwarp();
      }
      cur_seg[tid] += q_segs[tid];
      cur_row[tid] += q_rows[tid];
      q_segs[tid] = q_rows[tid] = 0;
      __syncwarp();
    }
  }
}

// slot r of segment s (the last with seg_off[s] <= r) holds
// sa_samp[start_s + r - seg_off[s]] + depth_s
__global__ void __launch_bounds__(kThreads) bfs_expand_kernel(
    const long long* __restrict__ sa_samp,
    const long long* __restrict__ seg_off,
    const long long* __restrict__ seg_start, long long nseg, long long total,
    long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < total;
       r += stride) {
    long long lo = 0, hi = nseg - 1;
    while (lo < hi) {
      const long long mid = (lo + hi + 1) >> 1;
      if (__ldg(seg_off + mid) <= r) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const long long v = __ldg(seg_start + lo);
    const long long i = (v & kStartMask) + (r - __ldg(seg_off + lo));
    __stcs(out + r, __ldcs(sa_samp + i) + (v >> kDepthShift));
  }
}

// blocks of the expand pass resident on the whole card at once
long long expand_grid() {
  static long long grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bfs_expand_kernel,
                                                  kThreads, 0);
    grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  return grid;
}

unsigned int tiles(long long nq) {
  return (unsigned int)((nq + kThreads - 1) / kThreads);
}

bool intv_ok(int sa_intv) { return sa_intv >= 2 && sa_intv <= kLargeIntv; }

template <int kMaxIntv, int kMode>
void launch_stats(const Tables& t, const void* samp_sum, const void* beg,
                  const void* end, long long nq, void* pool,
                  long long pool_cap, void* out, cudaStream_t s) {
  bfs_stats_kernel<kMaxIntv, kMode><<<tiles(nq), kThreads, 0, s>>>(
      t, (const long long*)samp_sum, (const long long*)beg,
      (const long long*)end, nq, (uint8_t*)pool, pool_cap,
      (unsigned long long*)out);
}

template <int kMaxIntv>
void launch_segments(const Tables& t, const void* beg, const void* end,
                     long long nq, void* pool, long long pool_cap,
                     void* seg_off, void* seg_start, long long seg_cap,
                     void* scratch, cudaStream_t s) {
  bfs_segments_kernel<kMaxIntv><<<tiles(nq), kThreads, 0, s>>>(
      t, (const long long*)beg, (const long long*)end, nq, (uint8_t*)pool,
      pool_cap, (long long*)seg_off, (long long*)seg_start, seg_cap,
      (unsigned long long*)scratch);
}

Tables tables(const void* blk, const void* sup, const void* pri,
              int sa_intv) {
  return Tables{(const uint4*)blk, (const long long*)sup,
                (const long long*)pri, sa_intv};
}

}  // namespace

// out: int64 [4] receives (total, checksum, spilled queries, pool need):
// the number of positions the range BFS of the nq ranges [beg[q], end[q])
// emits and their sum, the queries walked on the spill route, and the pool
// nodes they need; when that need exceeds pool_cap the sums are not valid
// and the caller runs the launch again with a pool of that size.
// samp_sum: int64 [len(sa_samp) + 1], samp_sum[k] = sa_samp[0 .. k) summed.
// pool: uint8 [9 * pool_cap] scratch.
extern "C" int kt_fm_bfs_stats(const void* blk, const void* sup,
                               const void* pri, const void* samp_sum,
                               int sa_intv, const void* beg, const void* end,
                               long long nq, void* pool, long long pool_cap,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!intv_ok(sa_intv)) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(out, 0, kReport * sizeof(long long), s);
  const Tables t = tables(blk, sup, pri, sa_intv);
  if (nq > 0) {
    if (sa_intv <= kSmallIntv) {
      launch_stats<kSmallIntv, 0>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    } else {
      launch_stats<kLargeIntv, 0>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    }
  }
  return (int)cudaGetLastError();
}

// The stats pass split, for the experiment alone (fm_query_time.py): mode
// 0 as kt_fm_bfs_stats, 1 without the samp_sum reads, 2 with a visit that
// does nothing (the walk alone), 3 the walk's skeleton (no table reads,
// every node one row with one child; its sums mean nothing); sa_intv 2 ..
// 8.
extern "C" int kt_fm_bfs_stats_split(int mode, const void* blk,
                                     const void* sup, const void* pri,
                                     const void* samp_sum, int sa_intv,
                                     const void* beg, const void* end,
                                     long long nq, void* pool,
                                     long long pool_cap, void* out,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (sa_intv < 2 || sa_intv > kSmallIntv || mode < 0 || mode > 3) {
    return (int)cudaErrorInvalidValue;
  }
  cudaMemsetAsync(out, 0, kReport * sizeof(long long), s);
  const Tables t = tables(blk, sup, pri, sa_intv);
  if (nq > 0) {
    if (mode == 0) {
      launch_stats<kSmallIntv, 0>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    } else if (mode == 1) {
      launch_stats<kSmallIntv, 1>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    } else if (mode == 2) {
      launch_stats<kSmallIntv, 2>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    } else {
      launch_stats<kSmallIntv, 3>(t, samp_sum, beg, end, nq, pool, pool_cap,
                                  out, s);
    }
  }
  return (int)cudaGetLastError();
}

// The locate walk: seg_off / seg_start int64 [seg_cap] receive the
// non-empty segments in kiss_tpu's order (each one's output offset, and
// its sa_samp start | depth << 58), writes past seg_cap dropped. scratch:
// int64 [5 + 5 * ceil(nq / 128)]; its first four receive (segments,
// positions, spilled queries, pool need). The segments are valid when
// segments <= seg_cap and pool need <= pool_cap; otherwise the caller runs
// the launch again with those sizes. pool: uint8 [9 * pool_cap] scratch.
extern "C" int kt_fm_bfs_segments(const void* blk, const void* sup,
                                  const void* pri, int sa_intv,
                                  const void* beg, const void* end,
                                  long long nq, void* pool,
                                  long long pool_cap, void* seg_off,
                                  void* seg_start, long long seg_cap,
                                  void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!intv_ok(sa_intv)) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(scratch, 0,
                  (kReport + 1 + (size_t)kStatus * tiles(nq)) *
                      sizeof(long long),
                  s);
  const Tables t = tables(blk, sup, pri, sa_intv);
  if (nq > 0) {
    if (sa_intv <= kSmallIntv) {
      launch_segments<kSmallIntv>(t, beg, end, nq, pool, pool_cap, seg_off,
                                  seg_start, seg_cap, scratch, s);
    } else {
      launch_segments<kLargeIntv>(t, beg, end, nq, pool, pool_cap, seg_off,
                                  seg_start, seg_cap, scratch, s);
    }
  }
  return (int)cudaGetLastError();
}

// out: int64 [total] receives the positions of the nseg segments of
// kt_fm_bfs_segments in kiss_tpu's order.
extern "C" int kt_fm_bfs_expand(const void* sa_samp, const void* seg_off,
                                const void* seg_start, long long nseg,
                                long long total, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0 && nseg > 0) {
    long long grid = (total + kThreads - 1) / kThreads;
    if (grid > expand_grid()) grid = expand_grid();
    bfs_expand_kernel<<<(unsigned int)grid, kThreads, 0, s>>>(
        (const long long*)sa_samp, (const long long*)seg_off,
        (const long long*)seg_start, nseg, total, (long long*)out);
  }
  return (int)cudaGetLastError();
}
