// K2: fm_backward_search -- batched backward search over 2-bit packed
// patterns.
//
// Replaces: get_range_packed_device (kiss_tpu/models/fm_index.py:443-497)
//   with _lf / _occ / _sel4 (:278-307) and pack.count_symbol_prefix
//   (kiss_tpu/ops/pack.py:201-219). Also serves counts_packed_device and
//   FMIndex._build_lookup (early_stop = 0).
//
// What bounds it on the H100: dependent random reads. Each LF step of a
//   query reads one 20-byte lf_tab row per range bound at an address that
//   depends on the previous step, so a query is a chain of qlen latency-
//   bound loads into a table of N/16 rows (61 MB at N = 48.8M, about the
//   size of the 50 MB L2). Arithmetic is a few integer ops and a __popc.
//
// What the simple design does about it: one thread per query, so the
//   card hides the latency of each chain behind many queries in flight
//   (1M queries are 7,800 blocks of 128 threads); the occ counts and the
//   BWT word of a 16-row block share one lf_tab row, so a bound costs one
//   row read per step; dead ranges stop early (early_stop), as the
//   reference's compute_range does.
//
// Pattern symbol j of query q is (qwords[q * qw + j / 16] >> 2 (j % 16)) & 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

__device__ __forceinline__ int symbol_at(const uint32_t* w, int j) {
  return (int)((w[j >> 4] >> (2 * (j & 15))) & 3u);
}

__global__ void backward_search_kernel(
    const uint32_t* __restrict__ lf_tab, const long long* __restrict__ cnt,
    const long long* __restrict__ pri_p, const long long* __restrict__ lookup,
    long long lookup_n, const uint32_t* __restrict__ qwords, long long nq,
    int qw, int qlen, int lookup_len, int early_stop,
    long long* __restrict__ beg_out, long long* __restrict__ end_out,
    long long* __restrict__ offs_out) {
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
    b = fm::lf(lf_tab, cnt, pri, c, b);
    e = fm::lf(lf_tab, cnt, pri, c, e);
    offs = j;
  }
  beg_out[q] = b;
  end_out[q] = e;
  offs_out[q] = offs;
}

}  // namespace

extern "C" int kt_fm_backward_search(
    const void* lf_tab, const void* cnt, const void* pri, const void* lookup,
    long long lookup_n, const void* qwords, long long nq, int qw, int qlen,
    int lookup_len, int early_stop, void* beg, void* end, void* offs,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const long long blocks = (nq + threads - 1) / threads;
  if (blocks > 0) {
    backward_search_kernel<<<(unsigned int)blocks, threads, 0, s>>>(
        (const uint32_t*)lf_tab, (const long long*)cnt, (const long long*)pri,
        (const long long*)lookup, lookup_n, (const uint32_t*)qwords, nq, qw,
        qlen, lookup_len, early_stop, (long long*)beg, (long long*)end,
        (long long*)offs);
  }
  return (int)cudaGetLastError();
}
