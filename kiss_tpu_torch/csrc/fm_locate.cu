// K3: fm_locate -- text positions of suffix-array rows by the sampled-SA
// LF walk, and the fused (expand, walk, checksum) pass of a query batch.
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
// What bounds it on the H100: dependent random reads. A row walks up to
//   sa_intv - 1 LF steps; each step reads one b_tab row (12 bytes) and one
//   lf_tab row (20 bytes) at addresses that depend on the previous step,
//   then one sa_samp entry. The range expansion adds a binary search over
//   the batch's exclusive starts (log2 Q reads, cached in L1/L2).
//
// What the simple design does about it: one thread per row, so many walks
//   are in flight; the walk stops at the first marked row, as compute_sa
//   does (the reference, fm_index.hpp:210-222); the stats pass never
//   writes rows or positions to memory: it expands, walks and sums in
//   registers, reduces each block in int64 with warp shuffles, and adds
//   one unsigned 64-bit atomic per block. The checksum is a sum of
//   integers, so the order of the atomics does not change it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr unsigned int kFull = 0xFFFFFFFFu;

struct Index {
  const uint32_t* lf_tab;
  const uint32_t* b_tab;
  const long long* cnt;
  const long long* pri;
  const long long* sa_samp;
  int sa_intv;
};

__device__ __forceinline__ long long locate_one(const Index& ix, long long pri,
                                                long long i) {
  if (ix.sa_intv == 1) return ix.sa_samp[i];
  long long steps = 0;
  bool done = fm::b_at(ix.b_tab, i);
  for (int s = 0; s < ix.sa_intv - 1 && !done; ++s) {
    i = fm::lf_own(ix.lf_tab, ix.cnt, pri, i);
    ++steps;
    done = fm::b_at(ix.b_tab, i);
  }
  return ix.sa_samp[fm::b_rank(ix.b_tab, i)] + steps;
}

__global__ void locate_rows_kernel(Index ix, const long long* __restrict__ rows,
                                   long long nrows, long long* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  out[r] = locate_one(ix, *ix.pri, rows[r]);
}

__global__ void locate_stats_kernel(Index ix, const long long* __restrict__ beg,
                                    const long long* __restrict__ starts,
                                    long long nq, long long total,
                                    unsigned long long* __restrict__ checksum) {
  const long long pri = *ix.pri;
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < total; r += stride) {
    // the last query whose exclusive start is <= r (starts[0] == 0); a
    // zero-length query shares its successor's start and is passed over
    long long lo = 0, hi = nq;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      if (starts[mid] <= r) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    acc += (unsigned long long)locate_one(ix, pri, beg[lo] + (r - starts[lo]));
  }
  __shared__ unsigned long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    if (lane == 0 && acc) atomicAdd(checksum, acc);
  }
}

}  // namespace

extern "C" int kt_fm_locate_rows(const void* lf_tab, const void* b_tab,
                                 const void* cnt, const void* pri,
                                 const void* sa_samp, int sa_intv,
                                 const void* rows, long long nrows, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Index ix{(const uint32_t*)lf_tab, (const uint32_t*)b_tab,
           (const long long*)cnt,   (const long long*)pri,
           (const long long*)sa_samp, sa_intv};
  const int threads = 256;
  const long long blocks = (nrows + threads - 1) / threads;
  if (blocks > 0) {
    locate_rows_kernel<<<(unsigned int)blocks, threads, 0, s>>>(
        ix, (const long long*)rows, nrows, (long long*)out);
  }
  return (int)cudaGetLastError();
}

// checksum: one unsigned 64-bit counter (zeroed here) receiving the sum of
// the positions of every row in [beg[q], beg[q] + len[q]) for all q, where
// starts is the exclusive prefix sum of len and total its sum.
extern "C" int kt_fm_locate_stats(const void* lf_tab, const void* b_tab,
                                  const void* cnt, const void* pri,
                                  const void* sa_samp, int sa_intv,
                                  const void* beg, const void* starts,
                                  long long nq, long long total,
                                  void* checksum, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(checksum, 0, sizeof(unsigned long long), s);
  Index ix{(const uint32_t*)lf_tab, (const uint32_t*)b_tab,
           (const long long*)cnt,   (const long long*)pri,
           (const long long*)sa_samp, sa_intv};
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  if (blocks > 0) {
    locate_stats_kernel<<<(unsigned int)blocks, threads, 0, s>>>(
        ix, (const long long*)beg, (const long long*)starts, nq, total,
        (unsigned long long*)checksum);
  }
  return (int)cudaGetLastError();
}
