// Device helpers shared by the FM-index kernels (fm_search.cu, fm_locate.cu).
//
// Table layouts are those of kiss_tpu/models/fm_index.py (kept byte for
// byte by the port):
//   lf_tab[j] = [occ of symbols 0..3 before 16-row block j (absolute),
//                packed BWT word j (16 dibits, LSB-first)]   uint32 [N/16+1, 5]
//   b_tab[k]  = [marks before 64-row block k, mark words 2k and 2k+1]
//                                                           uint32 [N/64+1, 3]
// Counts, rows and positions are int64.

#pragma once

#include <stdint.h>

namespace fm {

constexpr uint32_t kLanes = 0x55555555u;

// occurrences of symbol c in the first t (< 16) dibits of word
__device__ __forceinline__ int count_prefix(uint32_t word, int c, int t) {
  const uint32_t x = word ^ ((uint32_t)c * kLanes);
  const uint32_t zeros = ~x & (~x >> 1) & kLanes;
  const uint32_t mask = ((1u << (2 * t)) - 1u) & kLanes;
  return __popc(zeros & mask);
}

// LF(c, i) = cnt[c] + occ(c, i), with one lf_tab row read
// (_lf/_occ, kiss_tpu/models/fm_index.py:287-307)
__device__ __forceinline__ long long lf(const uint32_t* __restrict__ lf_tab,
                                        const long long* __restrict__ cnt,
                                        long long pri, int c, long long i) {
  const uint32_t* row = lf_tab + (i >> 4) * 5;
  const int t = (int)(i & 15);
  // the sentinel row packs as symbol 0 but counts as no symbol
  const int pass_pri = (c == 0) && (i - t <= pri) && (pri < i);
  return cnt[c] + (long long)row[c] + count_prefix(row[4], c, t) - pass_pri;
}

// LF(bwt[i], i) (_lf_own_symbol, fm_index.py:316-332)
__device__ __forceinline__ long long lf_own(const uint32_t* __restrict__ lf_tab,
                                            const long long* __restrict__ cnt,
                                            long long pri, long long i) {
  const uint32_t word = lf_tab[(i >> 4) * 5 + 4];
  const int c = (int)((word >> (2 * (i & 15))) & 3u);
  return lf(lf_tab, cnt, pri, c, i);
}

// is row i a sampled row (_b_at, fm_index.py:378-382)
__device__ __forceinline__ bool b_at(const uint32_t* __restrict__ b_tab,
                                     long long i) {
  const uint32_t* row = b_tab + (i >> 6) * 3;
  const uint32_t w = ((i >> 5) & 1) ? row[2] : row[1];
  return (w >> (i & 31)) & 1u;
}

// marks in rows [0, i) (_b_rank, fm_index.py:359-375)
__device__ __forceinline__ long long b_rank(const uint32_t* __restrict__ b_tab,
                                            long long i) {
  const uint32_t* row = b_tab + (i >> 6) * 3;
  const int off = (int)(i & 63);
  const uint32_t m0 = off >= 32 ? 0xFFFFFFFFu : ((1u << off) - 1u);
  const uint32_t m1 = off > 32 ? ((1u << (off - 32)) - 1u) : 0u;
  return (long long)row[0] + __popc(row[1] & m0) + __popc(row[2] & m1);
}

}  // namespace fm
