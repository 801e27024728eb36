// K4: fm_bfs -- the range BFS (the reference's FMTree locate) on the block
// table (fm_common.cuh): the text positions of the row ranges of a query
// batch on an index whose source suffix array is only k-ordered, and the
// (total, checksum) pair of those positions.
//
// Replaces:
//   kt_fm_bfs_stats  -> batch_bfs_stats_device (kiss_tpu/models/
//                       fm_index.py:695-711) and the host's sum(lo) +
//                       (sum(hi) << 16) checksum assembly (:1041-1044);
//   kt_fm_bfs_count +
//   kt_fm_bfs_locate -> bfs_locate_device / _bfs_emit (:640-692).
//
// What is computed. Query q's tree has the node [beg[q], end[q]) at depth
//   0; the children of a node [b, e) at depth d < sa_intv - 1 are
//   [LF(c, b), LF(c, e)) for c = 0..3 (column = parent column * 4 + c).
//   Each node emits sa_samp[mark_rank(b) .. mark_rank(e)) + d. The
//   positions come query-major, within a query by depth, within a depth by
//   column: kiss_tpu's order.
//
// What bounds it on the H100: dependent random reads. A node needs the
//   block-table entries of its two endpoints (one 32-byte sector each, the
//   24.4 MB table at N = 48.8M stays in L2), which give its mark ranks and
//   all four children's LFs; a child's entries depend on them. The
//   positions are random reads of sa_samp (98 MB at N = 48.8M), one an
//   occurrence. The plain version expands every node, 4^(sa_intv - 1)
//   leaves a query, and materialises each level.
//
// What the design does about it:
//   - empty nodes are pruned: a node with b == e has only empty children and
//     emits nothing, so the emitted set and its order are unchanged (the
//     reference also expands only what it finds, fm_index.hpp:486-489).
//     With ranges of one or two rows most of the 85 nodes of a query at
//     sa_intv 4 are empty.
//   - one thread walks a query's tree depth first with an explicit stack
//     of at most 3 (sa_intv - 1) + 1 nodes, visiting symbols 0..3 in order
//     and reading the two endpoint entries of a node once. A node of one
//     row (most of them, for 25-mers) reads one entry and takes one LF: its
//     only child is by its BWT symbol (fm_index.hpp:486-489). A depth-first
//     preorder restricted to one depth visits that depth's nodes in
//     increasing column, so the per-depth cursors of kt_fm_bfs_locate
//     write kiss_tpu's order.
//   - stats (one launch, no wait before it): a node's segment sums in O(1)
//     from samp_sum, the prefix sums of sa_samp (a table of the index, built
//     with the block table): samp_sum[me] - samp_sum[mb] + d (me - mb). So
//     a thread's work is bounded by its tree, whatever its range's length.
//     The sums are reduced each block and added by one unsigned 64-bit
//     atomic each: integer sums, so the atomics' order does not change them.
//   - locate: pass 1 (kt_fm_bfs_count) counts each (query, depth)'s
//     non-empty segments and their rows, in two rows of (query, depth)
//     columns; the wrapper takes the inclusive prefix sum of each row as a
//     1-D tensor, which PyTorch scans device-wide (a 2-D tensor it scans
//     with a few threads a row or column: at 1M queries on the H100 559 ms
//     along the outer dimension of [columns, 2], 7.8 ms along the inner one
//     of [2, columns]), and reads (segments, rows) once, to size the
//     output. Pass 2 writes each segment (its output
//     offset, its sa_samp start and depth) at its (query, depth) cursor;
//     pass 3 runs
//     over the output slots on the blocks the card holds at once, each slot
//     finding its segment by binary search of the offsets (the design of
//     K3's stats pass), so one range of a quarter of the SA is spread over
//     the card. sa_samp is read and the positions written evict-first, so
//     the block table stays in L2.
//
// The stack is sized by a compile-time bound on sa_intv: 8 (the CLI uses
// 4) or 32; the C entry points refuse other values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kSmallIntv = 8;
constexpr int kLargeIntv = 32;
// a segment's sa_samp start with its depth in the top bits
constexpr int kDepthShift = 58;
constexpr long long kStartMask = (1ll << kDepthShift) - 1;

struct Tables {
  const uint4* blk;
  const long long* sup;
  const long long* pri;
  int sa_intv;
};

// Visit every non-empty node of the tree of [b0, e0) in depth-first
// preorder, children in symbol order: visit(depth, mark_rank(b),
// mark_rank(e)).
template <int kMaxIntv, typename Visit>
__device__ __forceinline__ void walk_tree(const Tables& t, long long pri,
                                          long long b0, long long e0,
                                          Visit& visit) {
  constexpr int kStack = 3 * (kMaxIntv - 1) + 1;
  long long sb[kStack], se[kStack];
  unsigned char sd[kStack];
  int top = 0;
  if (b0 < e0) {
    sb[0] = b0;
    se[0] = e0;
    sd[0] = 0;
    top = 1;
  }
  while (top > 0) {
    --top;
    const long long b = sb[top], e = se[top];
    const int d = sd[top];
    const fm::Entry eb = fm::load_entry(t.blk, b);
    if (e == b + 1) {
      // one row: its mark rank and its one child (none at the sentinel
      // row) from its own entry, as the reference expands a singleton
      const long long mb = fm::mark_rank(eb, t.sup, b);
      visit(d, mb, mb + (long long)fm::marked(eb, b));
      if (d + 1 < t.sa_intv && b != pri) {
        const long long cb = fm::lf(eb, t.sup, pri, fm::bwt_at(eb, b), b);
        sb[top] = cb;
        se[top] = cb + 1;
        sd[top] = (unsigned char)(d + 1);
        ++top;
      }
      continue;
    }
    const fm::Entry ee = fm::load_entry(t.blk, e);
    visit(d, fm::mark_rank(eb, t.sup, b), fm::mark_rank(ee, t.sup, e));
    if (d + 1 == t.sa_intv) continue;
    // pushed 3..0, so symbol 0 is visited first
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      const long long cb = fm::lf(eb, t.sup, pri, c, b);
      const long long ce = fm::lf(ee, t.sup, pri, c, e);
      if (cb < ce) {
        sb[top] = cb;
        se[top] = ce;
        sd[top] = (unsigned char)(d + 1);
        ++top;
      }
    }
  }
}

template <int kMaxIntv>
__global__ void __launch_bounds__(kThreads) bfs_stats_kernel(
    Tables t, const long long* __restrict__ samp_sum,
    const long long* __restrict__ beg, const long long* __restrict__ end,
    long long nq, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long warp_sums[2][kThreads / 32];
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned long long total = 0, checksum = 0;
  if (q < nq) {
    auto visit = [&](int d, long long mb, long long me) {
      if (me > mb) {
        total += (unsigned long long)(me - mb);
        // modulo 2^64, as the prefix sums and the plain int64 sum wrap
        checksum += (unsigned long long)__ldcs(samp_sum + me) -
                    (unsigned long long)__ldcs(samp_sum + mb) +
                    (unsigned long long)d * (unsigned long long)(me - mb);
      }
    };
    walk_tree<kMaxIntv>(t, *t.pri, __ldg(beg + q), __ldg(end + q), visit);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_down_sync(kFull, total, o);
    checksum += __shfl_down_sync(kFull, checksum, o);
  }
  if (lane == 0) {
    warp_sums[0][warp] = total;
    warp_sums[1][warp] = checksum;
  }
  __syncthreads();
  if (warp == 0) {
    total = lane < kThreads / 32 ? warp_sums[0][lane] : 0ull;
    checksum = lane < kThreads / 32 ? warp_sums[1][lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_down_sync(kFull, total, o);
      checksum += __shfl_down_sync(kFull, checksum, o);
    }
    if (lane == 0) {
      if (total) atomicAdd(out, total);
      if (checksum) atomicAdd(out + 1, checksum);
    }
  }
}

// pass 1: counts[0][q sa_intv + d] and counts[1][q sa_intv + d] = the
// non-empty segments of query q at depth d and their rows
template <int kMaxIntv>
__global__ void __launch_bounds__(kThreads) bfs_count_kernel(
    Tables t, const long long* __restrict__ beg,
    const long long* __restrict__ end, long long nq,
    long long* __restrict__ counts) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= nq) return;
  long long nseg[kMaxIntv], nrow[kMaxIntv];
  for (int d = 0; d < t.sa_intv; ++d) nseg[d] = nrow[d] = 0;
  auto visit = [&](int d, long long mb, long long me) {
    if (me > mb) {
      ++nseg[d];
      nrow[d] += me - mb;
    }
  };
  walk_tree<kMaxIntv>(t, *t.pri, __ldg(beg + q), __ldg(end + q), visit);
  const long long cols = nq * t.sa_intv;
  for (int d = 0; d < t.sa_intv; ++d) {
    counts[q * t.sa_intv + d] = nseg[d];
    counts[cols + q * t.sa_intv + d] = nrow[d];
  }
}

// pass 2: each non-empty segment's output offset and sa_samp start | depth,
// at its (query, depth) cursor; incl is the inclusive prefix sum of each
// row of counts
template <int kMaxIntv>
__global__ void __launch_bounds__(kThreads) bfs_segments_kernel(
    Tables t, const long long* __restrict__ beg,
    const long long* __restrict__ end, long long nq,
    const long long* __restrict__ counts, const long long* __restrict__ incl,
    long long* __restrict__ seg_off, long long* __restrict__ seg_start) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= nq) return;
  long long seg[kMaxIntv], slot[kMaxIntv];
  const long long cols = nq * t.sa_intv;
  for (int d = 0; d < t.sa_intv; ++d) {
    const long long i = q * t.sa_intv + d;
    seg[d] = incl[i] - counts[i];
    slot[d] = incl[cols + i] - counts[cols + i];
  }
  auto visit = [&](int d, long long mb, long long me) {
    if (me > mb) {
      const long long s = seg[d]++;
      seg_off[s] = slot[d];
      seg_start[s] = mb | ((long long)d << kDepthShift);
      slot[d] += me - mb;
    }
  };
  walk_tree<kMaxIntv>(t, *t.pri, __ldg(beg + q), __ldg(end + q), visit);
}

// pass 3: slot r of segment s (the last with seg_off[s] <= r) holds
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

unsigned int query_blocks(long long nq) {
  return (unsigned int)((nq + kThreads - 1) / kThreads);
}

bool intv_ok(int sa_intv) { return sa_intv >= 2 && sa_intv <= kLargeIntv; }

template <int kMaxIntv>
void launch_stats(const Tables& t, const long long* samp_sum,
                  const long long* beg, const long long* end, long long nq,
                  unsigned long long* out, cudaStream_t s) {
  bfs_stats_kernel<kMaxIntv><<<query_blocks(nq), kThreads, 0, s>>>(
      t, samp_sum, beg, end, nq, out);
}

template <int kMaxIntv>
void launch_count(const Tables& t, const long long* beg, const long long* end,
                  long long nq, long long* counts, cudaStream_t s) {
  bfs_count_kernel<kMaxIntv><<<query_blocks(nq), kThreads, 0, s>>>(
      t, beg, end, nq, counts);
}

template <int kMaxIntv>
void launch_segments(const Tables& t, const long long* beg,
                     const long long* end, long long nq,
                     const long long* counts, const long long* incl,
                     long long* seg_off, long long* seg_start,
                     cudaStream_t s) {
  bfs_segments_kernel<kMaxIntv><<<query_blocks(nq), kThreads, 0, s>>>(
      t, beg, end, nq, counts, incl, seg_off, seg_start);
}

}  // namespace

// out: int64 [2] receives (total, checksum): the number of positions the
// range BFS of the nq ranges [beg[q], end[q]) emits and their sum.
// samp_sum: int64 [len(sa_samp) + 1], samp_sum[k] = sa_samp[0 .. k) summed.
extern "C" int kt_fm_bfs_stats(const void* blk, const void* sup,
                               const void* pri, const void* samp_sum,
                               int sa_intv, const void* beg, const void* end,
                               long long nq, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!intv_ok(sa_intv)) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), s);
  Tables t{(const uint4*)blk, (const long long*)sup, (const long long*)pri,
           sa_intv};
  if (nq > 0) {
    if (sa_intv <= kSmallIntv) {
      launch_stats<kSmallIntv>(t, (const long long*)samp_sum,
                               (const long long*)beg, (const long long*)end,
                               nq, (unsigned long long*)out, s);
    } else {
      launch_stats<kLargeIntv>(t, (const long long*)samp_sum,
                               (const long long*)beg, (const long long*)end,
                               nq, (unsigned long long*)out, s);
    }
  }
  return (int)cudaGetLastError();
}

// pass 1 of the locate entry point. counts: int64 [2, nq * sa_intv]
// receives, in column q * sa_intv + d, the non-empty segments of query q at
// depth d (row 0) and their rows (row 1).
extern "C" int kt_fm_bfs_count(const void* blk, const void* sup,
                               const void* pri, int sa_intv, const void* beg,
                               const void* end, long long nq, void* counts,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!intv_ok(sa_intv)) return (int)cudaErrorInvalidValue;
  Tables t{(const uint4*)blk, (const long long*)sup, (const long long*)pri,
           sa_intv};
  if (nq > 0) {
    if (sa_intv <= kSmallIntv) {
      launch_count<kSmallIntv>(t, (const long long*)beg,
                               (const long long*)end, nq, (long long*)counts,
                               s);
    } else {
      launch_count<kLargeIntv>(t, (const long long*)beg,
                               (const long long*)end, nq, (long long*)counts,
                               s);
    }
  }
  return (int)cudaGetLastError();
}

// passes 2 and 3: out int64 [total] receives the positions in kiss_tpu's
// order. incl is the inclusive prefix sum of each row of kt_fm_bfs_count's
// counts, whose last column is (nseg, total); seg_off and seg_start are
// int64 [nseg] scratch.
extern "C" int kt_fm_bfs_locate(const void* blk, const void* sup,
                                const void* pri, const void* sa_samp,
                                int sa_intv, const void* beg, const void* end,
                                long long nq, const void* counts,
                                const void* incl, long long nseg,
                                long long total, void* seg_off,
                                void* seg_start, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!intv_ok(sa_intv)) return (int)cudaErrorInvalidValue;
  Tables t{(const uint4*)blk, (const long long*)sup, (const long long*)pri,
           sa_intv};
  if (nq > 0 && nseg > 0) {
    if (sa_intv <= kSmallIntv) {
      launch_segments<kSmallIntv>(
          t, (const long long*)beg, (const long long*)end, nq,
          (const long long*)counts, (const long long*)incl,
          (long long*)seg_off, (long long*)seg_start, s);
    } else {
      launch_segments<kLargeIntv>(
          t, (const long long*)beg, (const long long*)end, nq,
          (const long long*)counts, (const long long*)incl,
          (long long*)seg_off, (long long*)seg_start, s);
    }
  }
  if (total > 0 && nseg > 0) {
    long long grid = (total + kThreads - 1) / kThreads;
    if (grid > expand_grid()) grid = expand_grid();
    bfs_expand_kernel<<<(unsigned int)grid, kThreads, 0, s>>>(
        (const long long*)sa_samp, (const long long*)seg_off,
        (const long long*)seg_start, nseg, total, (long long*)out);
  }
  return (int)cudaGetLastError();
}
