// K6: occ_tables -- the FM-index's occurrence tables from the packed BWT.
//
// Replaces: no TPU kernel. The JAX package builds these tables with the
//   jitted occ scans of kiss_tpu/models/fm_index.py:build_index_device
//   (:178-189: the per-word symbol counts, occ2's exclusive cumsum within
//   each superblock, occ1's exclusive cumsum of the superblock totals),
//   which XLA fuses. In eager PyTorch the same chain is int64 popcount
//   passes, a [words, 4] count table, a cumsum along the outer dimension of
//   the superblock totals (one thread a column on CUDA: about 250 ms at N =
//   248M) and the re-expansion of occ1 into lf_tab. This kernel writes all
//   of it in one pass over the words.
//
// What it computes, for nwords packed BWT words (16 rows a word, 2 bits a
//   row, LSB-first), `rows` valid rows, the sentinel's row `pri` (counted as
//   no symbol; a value outside [0, rows) means the sentinel is not among
//   these rows), an int64 [4] offset `occ_off` (the counts before the first
//   row) and table_rows >= nwords rows of output (R1 = ceil(table_rows /
//   16)):
//   - c(j): each symbol's count among the valid rows of word j (0 for j >=
//     nwords), by XOR with the replicated symbol, the zero-lane mask and
//     __popc, as pack.count_symbol_prefix counts;
//   - occ2 int32 [table_rows, 4]: c(16 s) + ... + c(j - 1) for row j of
//     superblock s = j / 16 (so 0 at j = 16 s);
//   - occ1 int64 [R1, 4]: occ_off + c(0) + ... + c(16 s - 1);
//   - lf_tab uint32 bits [table_rows, 5]: occ1[j / 16] + occ2[j] mod 2^32,
//     then word j (0 for j >= nwords);
//   - totals int64 [4]: c(0) + ... + c(nwords - 1), without the offset.
//   Bit for bit what fm_index.occ_tables_plain returns.
//
// What bounds it on the H100: the bytes it moves. 4 bytes read and 36
//   written (16 of occ2, 20 of lf_tab) a word, and 32 written a superblock
//   of occ1: 652 MB at N = 248,387,329, 0.195 ms at 3.35 TB/s.
//
// What the design does about it:
//   - a thread takes four neighbouring words (a quarter superblock, 64 rows)
//     in one 16-byte load; a block of 256 threads takes a tile of 1024
//     words (16,384 rows), so every load of a warp is 512 contiguous bytes;
//   - a word's four counts are packed as four 16-bit fields of one 64-bit
//     integer, and a tile's counts never pass 16,384, so one 64-bit add sums
//     four symbols: the superblock's scan is two shuffles inside groups of
//     four lanes, the tile's a warp scan and a pass over eight warp totals;
//   - the tiles' totals are carried by a single-pass decoupled look-back
//     (K4's scheme, csrc/fm_bfs.cu): a tile takes its number from an atomic
//     ticket, so it waits only for tiles that have started; it publishes its
//     aggregate, then its inclusive prefix; its first warp reads the statuses
//     of the 32 tiles before it at once and sums back to the nearest
//     inclusive prefix. The counts of one launch stay below 2^32 (rows <
//     2^32), so an inclusive prefix is two 64-bit words of two 32-bit fields;
//   - occ2's 16-byte rows and lf_tab's 20-byte rows are staged in shared
//     memory and stored by the whole block as contiguous 16-byte stores;
//     occ1 is stored a symbol a lane, 256 contiguous bytes a warp.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = 4;
constexpr int kTileRows = kThreads * kWordsPerThread;  // table rows a tile
constexpr int kSupRows = 16;  // table rows (words) of a 256-row superblock
constexpr int kLfWords = 5;   // 32-bit words of an lf_tab row
constexpr uint32_t kLanes = 0x55555555u;
// look-back status of a tile: flag, aggregate (four 16-bit fields),
// inclusive prefix (symbols 0, 1 and 2, 3 as two 32-bit fields each)
constexpr int kStatus = 4;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
constexpr unsigned long long kSpinLimitNs = 4000000000ull;  // 4 s

__device__ __forceinline__ uint32_t field(unsigned long long x, int c) {
  return (uint32_t)(x >> (16 * c)) & 0xFFFFu;
}

// the four 16-bit fields of x as two words of two 32-bit fields
__device__ __forceinline__ unsigned long long low_pair(unsigned long long x) {
  return (unsigned long long)field(x, 0) |
         (unsigned long long)field(x, 1) << 32;
}
__device__ __forceinline__ unsigned long long high_pair(unsigned long long x) {
  return (unsigned long long)field(x, 2) |
         (unsigned long long)field(x, 3) << 32;
}

// each symbol's count among the lanes of w that `mask` keeps (a lane's low
// bit), symbol c in bits [16 c, 16 c + 16)
__device__ __forceinline__ unsigned long long word_counts(uint32_t w,
                                                          uint32_t mask) {
  unsigned long long out = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t nx = ~(w ^ (kLanes * (uint32_t)c));
    out |= (unsigned long long)__popc(nx & (nx >> 1) & mask) << (16 * c);
  }
  return out;
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

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

// scratch: the ticket, then kStatus words a tile, all zero at launch
__global__ void __launch_bounds__(kThreads) occ_tables_kernel(
    const uint32_t* __restrict__ words, long long nwords, long long rows,
    const long long* __restrict__ pri_p, const long long* __restrict__ off_p,
    long long table_rows, int32_t* __restrict__ occ2,
    long long* __restrict__ occ1, uint32_t* __restrict__ lf_tab,
    long long* __restrict__ totals, unsigned long long* scratch) {
  __shared__ __align__(16) uint4 s_occ2[kTileRows];
  __shared__ __align__(16) uint32_t s_lf[kTileRows * kLfWords];
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_prefix[2];
  __shared__ unsigned int s_tile;
  unsigned long long* status = scratch + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (unsigned int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long j0 = tile * kTileRows + kWordsPerThread * tid;

  // the thread's four words (0 past the last) and their counts
  uint32_t w[kWordsPerThread];
  const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  if (aligned && j0 + kWordsPerThread <= nwords) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(words + j0));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      w[k] = j0 + k < nwords ? __ldcs(words + j0 + k) : 0u;
    }
  }
  const long long pri = __ldg(pri_p);
  unsigned long long before_word[kWordsPerThread], mine = 0;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const long long r = 16 * (j0 + k);  // the word's first row
    const long long left = j0 + k < nwords ? rows - r : 0;
    uint32_t mask = left >= 16 ? kLanes
                    : left <= 0 ? 0u
                                : ((1u << (2 * (int)left)) - 1) & kLanes;
    if (pri >= r && pri < r + 16) mask &= ~(1u << (2 * (int)(pri - r)));
    before_word[k] = mine;
    mine += word_counts(w[k], mask);
  }

  // the superblock's counts before the thread (its group of four lanes)
  unsigned long long g = mine;
  unsigned long long y = __shfl_up_sync(kFull, g, 1, 4);
  if ((lane & 3) >= 1) g += y;
  y = __shfl_up_sync(kFull, g, 2, 4);
  if ((lane & 3) >= 2) g += y;
  const unsigned long long in_sup = g - mine;
  // the tile's counts before the thread, and the tile's aggregate
  const unsigned long long wi = warp_incl(mine, lane);
  if (lane == 31) s_warp[warp] = wi;
  __syncthreads();
  unsigned long long in_tile = wi - mine, agg = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const unsigned long long s = s_warp[i];
    in_tile += i < warp ? s : 0ull;
    agg += s;
  }

  // occ2's rows need nothing from the tiles before: stage them first
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const unsigned long long v = in_sup + before_word[k];
    s_occ2[kWordsPerThread * tid + k] =
        make_uint4(field(v, 0), field(v, 1), field(v, 2), field(v, 3));
  }

  // the look-back, by the first warp
  if (warp == 0) {
    unsigned long long* st_mine = status + tile * kStatus;
    unsigned long long lo = 0, hi = 0;  // the tiles before: two pairs
    if (tile > 0) {
      if (lane == 0) {
        __stcg(st_mine + 1, agg);
        st_release(st_mine, kAggregate);
      }
      for (long long p = tile - 1 - lane;; p -= 32) {
        // before tile 0: an inclusive prefix of nothing
        unsigned long long fl = kInclusive, vlo = 0, vhi = 0;
        if (p >= 0) {
          const unsigned long long* st = status + p * kStatus;
          fl = wait_flag(st);
          if (fl == kInclusive) {
            vlo = __ldcg(st + 2);
            vhi = __ldcg(st + 3);
          } else {
            const unsigned long long a = __ldcg(st + 1);
            vlo = low_pair(a);
            vhi = high_pair(a);
          }
        }
        const unsigned int inc = __ballot_sync(kFull, fl == kInclusive);
        const int nearest = inc ? __ffs(inc) - 1 : 32;
        if (lane > nearest) vlo = vhi = 0;
        lo += warp_sum(vlo);
        hi += warp_sum(vhi);
        if (inc) break;
      }
    }
    if (lane == 0) {
      const unsigned long long ilo = lo + low_pair(agg);
      const unsigned long long ihi = hi + high_pair(agg);
      __stcg(st_mine + 2, ilo);
      __stcg(st_mine + 3, ihi);
      st_release(st_mine, kInclusive);
      s_prefix[0] = lo;
      s_prefix[1] = hi;
      if (tile == gridDim.x - 1) {
        totals[0] = (long long)(ilo & kFull);
        totals[1] = (long long)(ilo >> 32);
        totals[2] = (long long)(ihi & kFull);
        totals[3] = (long long)(ihi >> 32);
      }
    }
  }
  __syncthreads();

  long long base[4];  // the counts before the tile, offset included
  base[0] = __ldg(off_p) + (long long)(s_prefix[0] & kFull);
  base[1] = __ldg(off_p + 1) + (long long)(s_prefix[0] >> 32);
  base[2] = __ldg(off_p + 2) + (long long)(s_prefix[1] & kFull);
  base[3] = __ldg(off_p + 3) + (long long)(s_prefix[1] >> 32);

  // occ1: lane c of a superblock's group stores symbol c
  const long long tile_row0 = tile * kTileRows;
  {
    const long long sup = (tile_row0 + kWordsPerThread * (tid & ~3)) /
                          kSupRows;
    const int c = lane & 3;
    if (sup * kSupRows < table_rows) {
      const long long b = c == 0 ? base[0] : c == 1 ? base[1]
                          : c == 2 ? base[2] : base[3];
      occ1[4 * sup + c] = b + field(in_tile - in_sup, c);
    }
  }
  // lf_tab's four rows (80 bytes, 16-byte aligned) into shared memory in
  // five 16-byte stores; occ2's rows out of it
  {
    uint32_t r[kWordsPerThread * kLfWords];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const unsigned long long v = in_tile + before_word[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[kLfWords * k + c] = (uint32_t)(base[c] + field(v, c));
      }
      r[kLfWords * k + 4] = w[k];
    }
    uint4* dst = reinterpret_cast<uint4*>(s_lf) + kLfWords * tid;
#pragma unroll
    for (int i = 0; i < kLfWords; ++i) {
      dst[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
    }
  }
  const int valid = (int)min((long long)kTileRows, table_rows - tile_row0);
  uint4* out2 = reinterpret_cast<uint4*>(occ2) + tile_row0;
  for (int i = tid; i < valid; i += kThreads) out2[i] = s_occ2[i];
  __syncthreads();
  if (valid == kTileRows) {
    constexpr int kVecs = kTileRows * kLfWords / 4;
    uint4* out = reinterpret_cast<uint4*>(lf_tab + tile_row0 * kLfWords);
    const uint4* in = reinterpret_cast<const uint4*>(s_lf);
    for (int i = tid; i < kVecs; i += kThreads) out[i] = in[i];
  } else {
    uint32_t* out = lf_tab + tile_row0 * kLfWords;
    for (int i = tid; i < valid * kLfWords; i += kThreads) out[i] = s_lf[i];
  }
}

}  // namespace

// words: nwords uint32 (int32 bits); pri: one int64 on the card; occ_off:
// four int64 on the card; occ2 int32 [table_rows, 4] and lf_tab uint32
// [table_rows, 5], both 16-byte aligned (a fresh torch.empty is); occ1 int64
// [ceil(table_rows / 16), 4]; totals int64 [4]; scratch 1 + 4 ceil(table_rows
// / 1024) uint64, zeroed here. rows <= 16 nwords, rows < 2^32, nwords <=
// table_rows.
extern "C" int kt_occ_tables(const void* words, long long nwords,
                             long long rows, const void* pri,
                             const void* occ_off, long long table_rows,
                             void* occ2, void* occ1, void* lf_tab,
                             void* totals, void* scratch, void* stream) {
  if (nwords < 0 || rows < 0 || rows > 16 * nwords || rows >= (1LL << 32) ||
      table_rows < nwords ||
      (reinterpret_cast<uintptr_t>(occ2) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(lf_tab) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (table_rows + kTileRows - 1) / kTileRows;
  cudaMemsetAsync(scratch, 0, (1 + (size_t)kStatus * tiles) * 8, s);
  cudaMemsetAsync(totals, 0, 4 * sizeof(long long), s);
  if (tiles > 0) {
    occ_tables_kernel<<<(unsigned int)tiles, kThreads, 0, s>>>(
        (const uint32_t*)words, nwords, rows, (const long long*)pri,
        (const long long*)occ_off, table_rows, (int32_t*)occ2,
        (long long*)occ1, (uint32_t*)lf_tab, (long long*)totals,
        (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}
