// K3: fm_locate -- text positions of suffix-array rows by the sampled-SA
// LF walk on the block table (fm_common.cuh), and the fused (expand, walk,
// checksum) pass of a query batch.
//
// Replaces:
//   kt_fm_locate_rows  -> locate_rows_device (kiss_tpu/models/fm_index.py:
//                         615-637) with _lf_own_symbol, _b_at, _b_rank
//                         (:316-332, :359-383);
//   kt_fm_locate_stats -> batch_locate_stats_device (:582-612) with
//                         _ragged_seg_ids (:569-579) and the host's
//                         sum(lo) + (sum(hi) << 16) checksum assembly
//                         (:1041-1044).
//
// What bounds it on the H100: random reads. A row walks up to
//   sa_intv - 1 LF steps to a marked row, each at an address that depends
//   on the step before, then reads one sa_samp entry: 98 MB at N = 48.8M,
//   so one random read from device memory a located row, which no layout
//   of the index tables saves. Expanding the batch's ranges into rows
//   needs, for each row, the query it belongs to: a search over the
//   ranges' ends.
//
// What the design does about it:
//   - a walk step reads one 32-byte block-table entry: the mark bit of
//     row i; if unmarked, bwt[i] and the counts for LF(bwt[i], i), whose
//     entry is the next read; at a marked row the mark rank, from the same
//     entry. Then one sa_samp read, marked evict-first (__ldcs), as are
//     the rows read and the positions written by the rows entry point:
//     the 98 MB stream of samples then does not push the block table out
//     of L2 (on the H100: the 1M random rows 15% faster, the 1M-range
//     stats pass 7%). The sa_samp reads are random reads from device
//     memory, one a located row, and they set the pass's floor.
//   - the stats pass finds each row's range by a binary search of the
//     inclusive prefix sum of the range lengths (17 dependent loads at a
//     100,000-query batch, served by L1 and L2), on a grid of the blocks
//     the card holds at once, each striding over the rows. A merge path
//     over range starts and rows (one search a block, each tile's ranges
//     staged in shared memory) was 5% slower at a 100,000-query batch and
//     2% at 1M on the H100, and was taken out.
//   - the host does not wait before the launch: the kernel reads the total
//     from the inclusive prefix sum and writes (total, checksum) into one
//     2-element device tensor, which the wrapper downloads once. Positions
//     are summed in registers, reduced each block in int64 with warp
//     shuffles, and added by one unsigned 64-bit atomic per block: the
//     checksum is a sum of integers, so the order of the atomics does not
//     change it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;  // both kernels

struct Index {
  const uint4* blk;
  const long long* sup;
  const long long* pri;
  const long long* sa_samp;
  int sa_intv;
};

// the text position of row i (compute_sa, the reference's
// fm_index.hpp:210-222): at most sa_intv - 1 LF steps to a marked row
__device__ __forceinline__ long long locate_one(const Index& ix, long long pri,
                                                long long i) {
  if (ix.sa_intv == 1) return __ldcs(ix.sa_samp + i);
  fm::Entry e = fm::load_entry(ix.blk, i);
  for (int s = 0;; ++s) {
    if (fm::marked(e, i) || s == ix.sa_intv - 1) {
      return __ldcs(ix.sa_samp + fm::mark_rank(e, ix.sup, i)) + s;
    }
    i = fm::lf(e, ix.sup, pri, fm::bwt_at(e, i), i);
    e = fm::load_entry(ix.blk, i);
  }
}

__global__ void __launch_bounds__(kThreads) locate_rows_kernel(
    Index ix, const long long* __restrict__ rows, long long nrows,
    long long* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  __stcs(out + r, locate_one(ix, *ix.pri, __ldcs(rows + r)));
}

// exclusive start of range q
__device__ __forceinline__ long long start_of(
    const long long* __restrict__ incl, long long q) {
  return q > 0 ? incl[q - 1] : 0;
}

__global__ void __launch_bounds__(kThreads) locate_stats_kernel(
    Index ix, const long long* __restrict__ beg,
    const long long* __restrict__ incl, long long nq,
    unsigned long long* __restrict__ out) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const long long total = incl[nq - 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = (unsigned long long)total;
  if (total == 0) return;
  const long long pri = *ix.pri;
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < total;
       r += stride) {
    // the first range whose inclusive end passes r: empty ranges end where
    // the range before them does and are passed over
    long long lo = 0, hi = nq - 1;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(incl + mid) > r) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    acc += (unsigned long long)locate_one(
        ix, pri, __ldg(beg + lo) + (r - start_of(incl, lo)));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    if (lane == 0 && acc) atomicAdd(out + 1, acc);
  }
}

// blocks resident on the whole card at once: the stats pass's grid
int stats_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  locate_stats_kernel,
                                                  kThreads, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  return grid;
}

}  // namespace

extern "C" int kt_fm_locate_rows(const void* blk, const void* sup,
                                 const void* pri, const void* sa_samp,
                                 int sa_intv, const void* rows,
                                 long long nrows, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Index ix{(const uint4*)blk, (const long long*)sup, (const long long*)pri,
           (const long long*)sa_samp, sa_intv};
  const long long blocks = (nrows + kThreads - 1) / kThreads;
  if (blocks > 0) {
    locate_rows_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(
        ix, (const long long*)rows, nrows, (long long*)out);
  }
  return (int)cudaGetLastError();
}

// out: int64 [2], receives (total, checksum): total = incl[nq - 1], the
// checksum the sum of the positions of every row in [beg[q], beg[q] +
// len[q]) for all q, where incl is the inclusive prefix sum of len
// (nq >= 1).
extern "C" int kt_fm_locate_stats(const void* blk, const void* sup,
                                  const void* pri, const void* sa_samp,
                                  int sa_intv, const void* beg,
                                  const void* incl, long long nq, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), s);
  Index ix{(const uint4*)blk, (const long long*)sup, (const long long*)pri,
           (const long long*)sa_samp, sa_intv};
  if (nq > 0) {
    locate_stats_kernel<<<stats_grid(), kThreads, 0, s>>>(
        ix, (const long long*)beg, (const long long*)incl, nq,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
