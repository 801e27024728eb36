// K2: fm_backward_search -- batched backward search over 2-bit packed
// patterns, on the block table (fm_common.cuh).
//
// Replaces: get_range_packed_device (kiss_tpu/models/fm_index.py:443-497)
//   with _lf / _occ / _sel4 (:278-307) and pack.count_symbol_prefix
//   (kiss_tpu/ops/pack.py:201-219). Also serves counts_packed_device and
//   FMIndex._build_lookup (early_stop = 0).
//
// What bounds it on the H100: the L2's rate of random 32-byte sectors.
//   Each LF step of a query reads, for each range bound, the block-table
//   entry of the bound's row at an address that depends on the step
//   before. At 1M queries the card holds enough chains in flight that the
//   sector rate, not one chain's latency, sets the time; at the CLI's
//   100,000-query chunk every query is resident at once and the chains'
//   latency shows too.
//
// What the design does about it: one thread per query; a step reads one
//   aligned 32-byte entry per bound, with two 16-byte non-coherent loads,
//   and one entry for both bounds when they fall in the same 64-row block
//   (usual once a 25-mer's range has narrowed), and one superblock read
//   when they fall in the same superblock; the table (24.4 MB at
//   N = 48.8M) stays in L2. Blocks of 64 threads, so the 1,563 blocks of a
//   100,000-query chunk spread evenly over the 132 SMs. Dead ranges stop
//   early (early_stop), as the reference's compute_range does.
//
// Pattern symbol j of query q is (qwords[q * qw + j / 16] >> 2 (j % 16)) & 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ int symbol_at(const uint32_t* w, int j) {
  return (int)((w[j >> 4] >> (2 * (j & 15))) & 3u);
}

__global__ void __launch_bounds__(kThreads) backward_search_kernel(
    const uint4* __restrict__ blk, const long long* __restrict__ sup,
    const long long* __restrict__ pri_p,
    const long long* __restrict__ lookup, long long lookup_n,
    const uint32_t* __restrict__ qwords, long long nq, int qw, int qlen,
    int lookup_len, int early_stop, long long* __restrict__ beg_out,
    long long* __restrict__ end_out, long long* __restrict__ offs_out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const long long pri = *pri_p;
  const uint32_t* w = qwords + q * qw;
  long long b = 0;
  long long e = lookup[lookup_n - 1];
  int steps = qlen;
  if (lookup_len > 0 && qlen >= lookup_len) {
    // seed from the lookup table on the last lookup_len characters
    long long key = 0;
    for (int j = qlen - lookup_len; j < qlen; ++j) {
      key = (key << 2) | symbol_at(w, j);
    }
    b = lookup[key];
    e = lookup[key + 1];
    steps = qlen - lookup_len;
  }
  long long offs = steps;
  for (int j = steps - 1; j >= 0; --j) {
    if (early_stop && e <= b) break;
    const int c = symbol_at(w, j);
    const fm::Entry eb = fm::load_entry(blk, b);
    const fm::Entry ee = ((b ^ e) >> fm::kBlockShift) == 0
                             ? eb
                             : fm::load_entry(blk, e);
    const long long sb = fm::lf_super(sup, c, b);
    const long long se = ((b ^ e) >> fm::kSuperShift) == 0
                             ? sb
                             : fm::lf_super(sup, c, e);
    b = sb + fm::lf_in_super(eb, pri, c, b);
    e = se + fm::lf_in_super(ee, pri, c, e);
    offs = j;
  }
  beg_out[q] = b;
  end_out[q] = e;
  offs_out[q] = offs;
}

}  // namespace

extern "C" int kt_fm_backward_search(
    const void* blk, const void* sup, const void* pri, const void* lookup,
    long long lookup_n, const void* qwords, long long nq, int qw, int qlen,
    int lookup_len, int early_stop, void* beg, void* end, void* offs,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > 0) {
    backward_search_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(
        (const uint4*)blk, (const long long*)sup, (const long long*)pri,
        (const long long*)lookup, lookup_n,
        (const uint32_t*)qwords, nq, qw, qlen, lookup_len, early_stop,
        (long long*)beg, (long long*)end, (long long*)offs);
  }
  return (int)cudaGetLastError();
}
