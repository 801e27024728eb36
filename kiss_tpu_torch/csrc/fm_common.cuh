// Device readers of the block table, shared by the FM-index kernels
// K2 (fm_search.cu) and K3 (fm_locate.cu).
//
// Layout (built by block_table, kiss_tpu_torch/models/fm_index.py, from
// lf_tab and b_tab; device-only, never serialized):
//   blk[j], one aligned 32-byte entry (8 uint32) per 64-row block j:
//     words 0-3  BWT words 4j .. 4j+3 (64 dibits, LSB-first)
//     words 4-5  mark words 2j, 2j+1 (row r is marked: bit r & 63)
//     word 6     occ0 | occ1 << 16    counts of the rows [65536 s, 64 j)
//     word 7     occ2 | marks << 16   of superblock s = j >> 10
//     occ3 = 64 (j & 1023) - occ0 - occ1 - occ2, less one if the sentinel
//     row (pri: packs as symbol 0, counts as none) lies among those rows.
//   sup[s] = int64 [LF(0..3, 65536 s), marks before row 65536 s, 0, then
//     K4's 32-bit copy of LF(0..2, 65536 s) and the marks in 16 bytes]
//     (LF(c, i) = cnt[c] + occ(c, i)).
// Counts, rows and positions are int64.
//
// What bounds the kernels on the H100: dependent random reads. An LF step
//   or a walk step needs the counts before row i and the BWT dibits of
//   i's block, at an address that depends on the step before. Read from
//   lf_tab (a 20-byte row per 16 rows: 61 MB at N = 48.8M, beyond the
//   50 MB L2) and b_tab (12 bytes per 64 rows), a step costs up to four
//   4-byte loads over 1.9 sectors (K2) and a walk step up to five over
//   two tables; the card serves about 100 G such sectors a second.
//
// What the layout does about it: one 32-byte sector per step, fetched by
//   two 16-byte loads of the same aligned entry; 24.4 MB at N = 48.8M, so
//   the table stays in L2 beside what streams past it. The superblock
//   table (745 rows of 64 bytes at N = 48.8M) is read through the
//   read-only cache, where it stays: one 8-byte load a step, independent
//   of the entry's, which also carries cnt. When both bounds of a K2 range
//   fall in one block, one entry serves both; in one superblock, one
//   superblock read.

#pragma once

#include <stdint.h>

namespace fm {

constexpr int kBlockShift = 6;   // 64 rows an entry
constexpr int kSuperShift = 16;  // 65,536 rows a superblock
constexpr int kSupCols = 8;

struct Entry {
  uint4 bwt;    // words 0-3
  uint4 marks;  // words 4-7: mark words, then the two count words
};

// the entry of row i's block: two 16-byte non-coherent loads of one
// aligned sector
__device__ __forceinline__ Entry load_entry(const uint4* __restrict__ blk,
                                            long long i) {
  const uint4* p = blk + 2 * (i >> kBlockShift);
  return Entry{__ldg(p), __ldg(p + 1)};
}

__device__ __forceinline__ unsigned long long mark_bits(const Entry& e) {
  return (unsigned long long)e.marks.y << 32 | e.marks.x;
}

// is row i (its entry is e) a sampled row (_b_at, fm_index.py:378-382)
__device__ __forceinline__ bool marked(const Entry& e, long long i) {
  return (mark_bits(e) >> (i & 63)) & 1ull;
}

// the dibit of row i (its entry is e)
__device__ __forceinline__ int bwt_at(const Entry& e, long long i) {
  const int off = (int)(i & 63);
  const uint32_t w = off < 32 ? (off < 16 ? e.bwt.x : e.bwt.y)
                              : (off < 48 ? e.bwt.z : e.bwt.w);
  return (int)((w >> (2 * (off & 15))) & 3u);
}

// occurrences of symbol c among the first off (< 64) dibits of the block
__device__ __forceinline__ int count_in_block(const Entry& e, int c,
                                              int off) {
  const unsigned long long lanes = 0x5555555555555555ull;
  const unsigned long long pat = (unsigned long long)c * lanes;
  const unsigned long long x0 =
      ((unsigned long long)e.bwt.y << 32 | e.bwt.x) ^ pat;
  const unsigned long long x1 =
      ((unsigned long long)e.bwt.w << 32 | e.bwt.z) ^ pat;
  const unsigned long long z0 = ~x0 & (~x0 >> 1) & lanes;
  const unsigned long long z1 = ~x1 & (~x1 >> 1) & lanes;
  const unsigned long long m0 =
      off >= 32 ? ~0ull : ((1ull << (2 * off)) - 1ull);
  const unsigned long long m1 =
      off > 32 ? ((1ull << (2 * (off - 32))) - 1ull) : 0ull;
  return __popcll(z0 & m0) + __popcll(z1 & m1);
}

// LF(c, i) less LF(c, 65536 s), s = i >> 16: the rows r in [65536 s, i)
// with bwt[r] == c, the sentinel row counting as none, from i's entry
// alone (_occ, kiss_tpu/models/fm_index.py:287-301)
__device__ __forceinline__ int lf_in_super(const Entry& e, long long pri,
                                           int c, long long i) {
  const long long block0 = i & ~63ll;
  const long long super0 = i & ~65535ll;
  const int r0 = (int)(e.marks.z & 0xFFFFu), r1 = (int)(e.marks.z >> 16);
  const int r2 = (int)(e.marks.w & 0xFFFFu);
  int rel;
  if (c == 0) {
    rel = r0;
  } else if (c == 1) {
    rel = r1;
  } else if (c == 2) {
    rel = r2;
  } else {
    rel = (int)(block0 - super0) - r0 - r1 - r2 -
          (int)(super0 <= pri && pri < block0);
  }
  int in = count_in_block(e, c, (int)(i & 63));
  in -= (int)(c == 0 && block0 <= pri && pri < i);
  return rel + in;
}

// LF(c, 65536 (i >> 16)) = cnt[c] + occ(c, 65536 (i >> 16))
__device__ __forceinline__ long long lf_super(
    const long long* __restrict__ sup, int c, long long i) {
  return __ldg(sup + (i >> kSuperShift) * kSupCols + c);
}

// LF(c, i) = cnt[c] + occ(c, i)
__device__ __forceinline__ long long lf(const Entry& e,
                                        const long long* __restrict__ sup,
                                        long long pri, int c, long long i) {
  return lf_super(sup, c, i) + lf_in_super(e, pri, c, i);
}

// marked rows r < i (_b_rank, fm_index.py:359-375)
__device__ __forceinline__ long long mark_rank(
    const Entry& e, const long long* __restrict__ sup, long long i) {
  const int off = (int)(i & 63);
  const unsigned long long below = mark_bits(e) & ((1ull << off) - 1ull);
  return __ldg(sup + (i >> kSuperShift) * kSupCols + 4) +
         (long long)(e.marks.w >> 16) + __popcll(below);
}

}  // namespace fm
