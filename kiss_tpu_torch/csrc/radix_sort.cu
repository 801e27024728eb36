// K1: radix_sort_words -- stable LSD radix sort of W <= 9 32-bit key words.
//
// Replaces: lax.sort(words, num_keys=W) in kiss_tpu/ops/suffix_sort.py --
//   _seed_sort_impl (:334, 5 words for DNA), _full_round_impl (:389),
//   _tail_refine (:469, 8 rank keys + payload, is_stable=True) and
//   _rank_block_sort_impl (:521).
//
// What bounds it on the H100: device-memory traffic. An 8-bit digit pass
//   must read and write 8 bytes a key (the word being sorted and a 32-bit
//   index), and bringing the next word into the current order is a random
//   gather that pays a 32-byte sector for 4 bytes. Everything a pass moves
//   beyond that (a histogram pass over the keys, tile counts written and
//   scanned, half-used sectors on the scatter's writes) is what a design
//   can save.
//
// What the design does about it (the host side is the wrapper in
// kiss_tpu_torch/ops/radix_sort.py, which also holds the pass plan):
//   - one counting kernel over all W words finds every (word, byte) whose
//     digits all fall in one bucket; those passes are skipped, and a word
//     with no pass left is never touched (packed words often have constant
//     high bytes). The same counts are each pass's digit totals;
//   - words are sorted least significant first; only the word being sorted
//     and a 32-bit index travel through its passes;
//   - a pass is ONE kernel (onesweep_pass_kernel). A tile of 8192
//     keys ranks its keys, counts its 256 digits on the way, and learns how
//     many keys of each digit the tiles before it hold by a decoupled
//     look-back: every tile publishes, per digit, first its own count
//     ("aggregate") and then its count plus all earlier tiles' ("inclusive
//     prefix") in a status array; a tile sums the aggregates of the tiles
//     before it, newest first, until it meets an inclusive prefix. Value,
//     flag and the pass's number share one 64-bit word, written and read
//     whole in L2, so a reader that sees the flag sees the value (and needs
//     no fence: the word carries nothing but itself), a pass never
//     mistakes an earlier pass's entry for its own and the
//     array is zeroed once a sort, not once a pass. Tiles take their number
//     from an atomic counter, not from blockIdx: a tile only ever waits for
//     tiles that have already started, so the wait cannot deadlock; and it
//     is bounded: after kSpinLimitNs a waiting thread traps, which ends the
//     launch with an error instead of hanging the card;
//   - ranking inside the tile: each warp owns a contiguous run of the tile
//     and walks it in rounds of 32 keys. The lanes of a round that share a
//     digit are found with 8 ballots (one per digit bit); the rank of a key
//     is its warp's running count of the digit plus the lanes below it with
//     the same digit, which keeps the input order, as LSD requires. The
//     running counts are per-warp shared-memory counters updated by the
//     lowest lane of each group: no atomics;
//   - keys and indices are placed in shared memory in digit order, then
//     written out by consecutive threads to consecutive global slots of
//     each digit run; with 8192 keys a tile a run averages 128 bytes;
//   - the last pass of a word writes, in place of the spent key, the next
//     word to sort gathered through the index it holds anyway
//     (next_word[idx]), so no separate gather runs between words;
//   - at the end all W words are brought into the final order. The most
//     significant sorted word is already in order in the key buffer and is
//     copied; a word that never needed a pass is constant and is copied
//     from the input; the others are first laid side by side, four words
//     to a 16-byte entry, so that the random read through the index costs
//     one sector a key and not one a word.
//
// Layout: keys[w * n + i] is word w of key i, word 0 most significant.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kCountThreads = 512;

// status word of (tile, digit): value in bits 0..31, flag in 32..33, the
// pass's number (from 1; 0 is the zeroed array) in 34..63
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
constexpr unsigned long long kSpinLimitNs = 4000000000ull;  // 4 s

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A status word is read and written whole, straight in L2 (gpu scope), and
// carries nothing but itself: value, flag and the pass's number are one
// 64-bit word, so a reader that sees the flag has the value, and neither
// side needs a fence. On the H100 a pass took 0.545 ms with
// st.release.gpu / ld.acquire.gpu here and 0.47 ms without.
__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The status word at p once this pass has written it. Traps when that
// takes longer than kSpinLimitNs: a fault in the protocol must end in an
// error, not in a hung card.
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p, unsigned long long epoch) {
  unsigned long long s = ld_status(p);
  if ((s >> kEpochShift) == epoch) return s;
  const unsigned long long t0 = global_ns();
  for (unsigned int polls = 1;; ++polls) {
    s = ld_status(p);
    if ((s >> kEpochShift) == epoch) return s;
    if ((polls & 255u) == 0 && global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// inclusive scan of x over the 32 lanes of a warp
__device__ __forceinline__ unsigned int warp_scan(unsigned int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// the valid lanes of the warp whose 8-bit digit equals this lane's: one
// ballot per digit bit (__match_any_sync gives the same set but takes a
// turn per distinct value, some 30 for random digits)
__device__ __forceinline__ unsigned int same_digit_lanes(unsigned int d,
                                                         bool valid) {
  unsigned int peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned int set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// counts[(w * 4 + b) * 256 + d] = #keys whose byte b of word w is d.
// Shared-memory atomics, one per key byte; a warp whose 32 keys agree in a
// byte (a constant byte, the common case worth detecting) adds 32 at once.
__global__ void __launch_bounds__(kCountThreads)
digit_counts_kernel(const uint32_t* __restrict__ keys, long long n,
                    unsigned int* __restrict__ counts) {
  __shared__ unsigned int h[4 * kBins];
  for (int i = threadIdx.x; i < 4 * kBins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const uint32_t* k = keys + (long long)blockIdx.y * n;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long rounds = (n + stride - 1) / stride;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kBatch = 4;  // independent loads a thread keeps in flight
  for (long long r = 0; r < rounds; r += kBatch, i += kBatch * stride) {
    uint32_t batch[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      batch[q] = i + q * stride < n ? k[i + q * stride] : 0u;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool valid = i + q * stride < n;
      const uint32_t v = batch[q];
      const bool whole = __all_sync(kFull, valid);
      const uint32_t v0 = __shfl_sync(kFull, v, 0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const unsigned int d = (v >> (8 * b)) & 0xFFu;
        const bool same =
            whole && __all_sync(kFull, d == ((v0 >> (8 * b)) & 0xFFu));
        if (same) {
          if (lane == 0) atomicAdd(&h[b * kBins + d], 32u);
        } else if (valid) {
          atomicAdd(&h[b * kBins + d], 1u);
        }
      }
    }
  }
  __syncthreads();
  unsigned int* out = counts + (long long)blockIdx.y * 4 * kBins;
  for (int j = threadIdx.x; j < 4 * kBins; j += blockDim.x) {
    if (h[j]) atomicAdd(&out[j], h[j]);
  }
}

// Where slot j of the tile's digit order lies in shared memory: one word
// of padding every 32, so that the keys of one round, which for keys in
// order (a position word) go to slots a whole run apart, do not all fall
// on one bank.
__device__ __forceinline__ int staged(int slot) { return slot + (slot >> 5); }

// One stable 8-bit digit pass over (key, index) in one kernel: see the
// note at the top. THREADS >= 256 (a thread per digit in the middle part).
// Dynamic shared memory: TILE keys and TILE indices (padded, see staged),
// WARPS x 256 counters.
template <int THREADS, int ITEMS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
onesweep_pass_kernel(const uint32_t* __restrict__ keys_in,
                     const int* __restrict__ idx_in,
                     uint32_t* __restrict__ keys_out,
                     int* __restrict__ idx_out, long long n, int shift,
                     const unsigned int* __restrict__ digit_totals,
                     unsigned long long* status, unsigned int* ticket,
                     unsigned long long epoch,
                     const uint32_t* __restrict__ next_word) {
  constexpr int WARPS = THREADS / 32;
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARP_RUN = 32 * ITEMS;
  static_assert(THREADS >= kBins && THREADS % 32 == 0, "a thread per digit");
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int STAGE = TILE + TILE / 32;
  uint32_t* s_key = smem;
  int* s_idx = (int*)(smem + STAGE);
  unsigned int(*wcnt)[kBins] = (unsigned int(*)[kBins])(smem + 2 * STAGE);
  __shared__ unsigned int run_base[kBins];  // global slot - tile slot
  __shared__ unsigned int wsum_local[kBins / 32];
  __shared__ unsigned int wsum_global[kBins / 32];
  __shared__ unsigned int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1u);
  for (int j = tid; j < WARPS * kBins; j += THREADS) (&wcnt[0][0])[j] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile0 = tile * TILE;

  // phase A: load the warp's run of keys (rounds of 32, coalesced), find
  // each round's groups of equal digits, then walk the rounds in order:
  // rank = the warp's count of the digit so far + lanes below in the group
  const long long start = tile0 + (long long)warp * WARP_RUN;
  uint32_t key[ITEMS];
  unsigned int rank[ITEMS];  // first the round's peer lanes, then the rank
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = start + r * 32 + lane;
    key[r] = i < n ? keys_in[i] : 0u;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    rank[r] = same_digit_lanes((key[r] >> shift) & 0xFFu,
                               start + r * 32 + lane < n);
  }
  const unsigned int lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = start + r * 32 + lane < n;
    const unsigned int d = (key[r] >> shift) & 0xFFu;
    const unsigned int peers = rank[r];
    const unsigned int below = __popc(peers & lanes_below);
    const unsigned int seen = valid ? wcnt[warp][d] : 0u;
    rank[r] = seen + below;
    __syncwarp();
    if (valid && below == 0) wcnt[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // phase B (thread = digit): the tile's count of the digit, published at
  // once; each warp's offset inside the digit's run; the run's start
  // inside the tile and the digit's first global slot (two scans over the
  // digits); then the look-back for the count of the tiles before
  unsigned int count = 0, total = 0, xl = 0, xg = 0;
  unsigned long long* mine = status + tile * kBins + tid;
  if (tid < kBins) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned int c = wcnt[w][tid];
      wcnt[w][tid] = count;
      count += c;
    }
    st_status(mine, (epoch << kEpochShift) |
                         (tile == 0 ? kInclusive : kAggregate) | count);
    total = digit_totals[tid];
    xl = warp_scan(count, lane);
    xg = warp_scan(total, lane);
    if (lane == 31) {
      wsum_local[warp] = xl;
      wsum_global[warp] = xg;
    }
  }
  __syncthreads();
  if (tid < kBins) {
    unsigned int before_l = 0, before_g = 0;
    for (int w = 0; w < warp; ++w) {
      before_l += wsum_local[w];
      before_g += wsum_global[w];
    }
    const unsigned int local_start = before_l + xl - count;
    unsigned int earlier = 0;  // keys of this digit in the tiles before
    if (tile > 0) {
      for (long long p = tile - 1;; --p) {
        const unsigned long long s =
            wait_status(status + p * kBins + tid, epoch);
        earlier += (unsigned int)s;
        if (s & kInclusive) break;  // tile 0 always publishes inclusive
      }
      st_status(mine,
                (epoch << kEpochShift) | kInclusive | (earlier + count));
    }
    run_base[tid] = before_g + xg - total + earlier - local_start;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wcnt[w][tid] += local_start;
  }
  __syncthreads();

  // phase C: the key's slot in digit order; key and index into shared
  // memory there
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = start + r * 32 + lane;
    if (i < n) {
      const unsigned int slot = wcnt[warp][(key[r] >> shift) & 0xFFu] + rank[r];
      s_key[staged(slot)] = key[r];
      s_idx[staged(slot)] = idx_in ? idx_in[i] : (int)i;
    }
  }
  __syncthreads();

  // phase D: consecutive threads write consecutive slots of each digit run
  const long long left = n - tile0;
  const int tile_n = left < TILE ? (int)left : TILE;
  if (!next_word) {
    for (int j = tid; j < tile_n; j += THREADS) {
      const uint32_t k = s_key[staged(j)];
      const unsigned int pos =
          run_base[(k >> shift) & 0xFFu] + (unsigned int)j;
      keys_out[pos] = k;
      idx_out[pos] = s_idx[staged(j)];
    }
    return;
  }
  // with the next word riding along: a thread starts a batch of gathers
  // before it stores the first, or each would wait for the one before
  constexpr int kBatch = 4;
  static_assert(ITEMS % kBatch == 0, "whole batches");
#pragma unroll 1
  for (int b = 0; b < ITEMS; b += kBatch) {
    uint32_t word[kBatch];
    int id[kBatch];
    unsigned int pos[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int j = tid + (b + q) * THREADS;
      if (j < tile_n) {
        id[q] = s_idx[staged(j)];
        pos[q] = run_base[(s_key[staged(j)] >> shift) & 0xFFu] +
                 (unsigned int)j;
        word[q] = next_word[id[q]];
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (tid + (b + q) * THREADS < tile_n) {
        keys_out[pos[q]] = word[q];
        idx_out[pos[q]] = id[q];
      }
    }
  }
}

// The last step of a sort, for the rows the interleaved gather below does
// not take (skip_mask): dst[r][j] = src[r][idx[j]] for the rows r in
// gather_mask; the row `top_row` (if >= 0) is copied from top_sorted,
// already in order; every other row is copied from src as it is (a
// constant word).
__global__ void gather_words_kernel(const uint32_t* __restrict__ src,
                                    int nrows, long long n,
                                    const int* __restrict__ idx,
                                    unsigned int gather_mask,
                                    unsigned int skip_mask,
                                    const uint32_t* __restrict__ top_sorted,
                                    int top_row, uint32_t* __restrict__ dst) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const long long from = gather_mask ? idx[j] : j;
    for (int r = 0; r < nrows; ++r) {
      if ((skip_mask >> r) & 1u) continue;
      dst[r * n + j] = r == top_row ? top_sorted[j]
                       : src[r * n + (((gather_mask >> r) & 1u) ? from : j)];
    }
  }
}

// Rows of src side by side: rows4[j] = (src[r0][j], src[r1][j], src[r2][j],
// src[r3][j]) for the up to 4 rows r0..r3 (a negative row: 0). A random
// read of key j's words then costs one 32-byte sector instead of one per
// word.
struct Rows4 {
  int r[4];
};

__global__ void interleave_rows_kernel(const uint32_t* __restrict__ src,
                                       long long n, Rows4 rows,
                                       uint4* __restrict__ rows4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    uint4 v;
    v.x = rows.r[0] >= 0 ? src[rows.r[0] * n + j] : 0u;
    v.y = rows.r[1] >= 0 ? src[rows.r[1] * n + j] : 0u;
    v.z = rows.r[2] >= 0 ? src[rows.r[2] * n + j] : 0u;
    v.w = rows.r[3] >= 0 ? src[rows.r[3] * n + j] : 0u;
    rows4[j] = v;
  }
}

// dst[rq][j] = rows4[idx[j]].q for the rows of interleave_rows_kernel
__global__ void gather_rows_kernel(const uint4* __restrict__ rows4,
                                   long long n, const int* __restrict__ idx,
                                   Rows4 rows, uint32_t* __restrict__ dst) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const uint4 v = rows4[idx[j]];
    if (rows.r[0] >= 0) dst[rows.r[0] * n + j] = v.x;
    if (rows.r[1] >= 0) dst[rows.r[1] * n + j] = v.y;
    if (rows.r[2] >= 0) dst[rows.r[2] * n + j] = v.z;
    if (rows.r[3] >= 0) dst[rows.r[3] * n + j] = v.w;
  }
}

// Shape of the pass kernel: 512 threads x 16 keys, 2 blocks an SM (the
// fastest of the shapes measured on the H100, PERF.md).
constexpr int kPassThreads = 512;
constexpr int kPassItems = 16;
constexpr int kPassBlocks = 2;
constexpr int kPassTile = kPassThreads * kPassItems;
constexpr int kMaxDevices = 64;

int launch_pass(const void* keys_in, const void* idx_in, void* keys_out,
                void* idx_out, long long n, int shift,
                const void* digit_totals, void* status, void* ticket,
                long long epoch, const void* next_word, cudaStream_t s) {
  constexpr size_t bytes =
      sizeof(uint32_t) *
      (2 * (kPassTile + kPassTile / 32) + (kPassThreads / 32) * kBins);
  auto kernel = onesweep_pass_kernel<kPassThreads, kPassItems, kPassBlocks>;
  // above 48 KB of dynamic shared memory a kernel needs the attribute: set
  // once a device, not on each of a sort's launches
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const unsigned int tiles = (unsigned int)((n + kPassTile - 1) / kPassTile);
  kernel<<<tiles, kPassThreads, bytes, s>>>(
      (const uint32_t*)keys_in, (const int*)idx_in, (uint32_t*)keys_out,
      (int*)idx_out, n, shift, (const unsigned int*)digit_totals,
      (unsigned long long*)status, (unsigned int*)ticket,
      (unsigned long long)epoch, (const uint32_t*)next_word);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// counts: W * 4 * 256 32-bit counters (zeroed here)
extern "C" int kt_radix_digit_counts(const void* keys, int nwords, long long n,
                                     void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, sizeof(unsigned int) * nwords * 4 * kBins, s);
  long long blocks = (n + kCountThreads - 1) / kCountThreads;
  if (blocks > 528) blocks = 528;  // 4 blocks on each of 132 SMs
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned int)blocks, (unsigned int)nwords);
  digit_counts_kernel<<<grid, kCountThreads, 0, s>>>((const uint32_t*)keys, n,
                                                      (unsigned int*)counts);
  return (int)cudaGetLastError();
}

// Keys a tile of the pass kernel holds. The wrapper sizes the status array
// with it.
extern "C" int kt_radix_tile_keys() { return kPassTile; }

// One stable pass on byte (shift / 8) of a single key word carrying a
// 32-bit index, in one kernel. idx_in may be null (the identity).
// digit_totals: the 256 digit counts of the word's byte (from
// kt_radix_digit_counts). status: 256 64-bit words a tile, zeroed once
// before a sort's first pass; ticket: a 32-bit zero that no other pass
// uses; epoch: the pass's number within the sort, from 1. next_word, when
// not null, is the word whose values, gathered through the index, are
// written to keys_out in place of the sorted keys.
extern "C" int kt_radix_onesweep_pass(const void* keys_in, const void* idx_in,
                                      void* keys_out, void* idx_out,
                                      long long n, int shift,
                                      const void* digit_totals, void* status,
                                      void* ticket, long long epoch,
                                      const void* next_word, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return launch_pass(keys_in, idx_in, keys_out, idx_out, n, shift,
                     digit_totals, status, ticket, epoch, next_word,
                     (cudaStream_t)stream);
}

// dst[r][j] = src[r][idx[j]] for the rows r of src (row length n) whose bit
// is set in gather_mask; rows in skip_mask are left alone; row top_row (or
// -1) is copied from top_sorted, every other row from src in place.
extern "C" int kt_gather_words(const void* src, int nrows, long long n,
                               const void* idx, unsigned int gather_mask,
                               unsigned int skip_mask, const void* top_sorted,
                               int top_row, void* dst, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  if (blocks > 0) {
    gather_words_kernel<<<(unsigned int)blocks, 256, 0, s>>>(
        (const uint32_t*)src, nrows, n, (const int*)idx, gather_mask,
        skip_mask, (const uint32_t*)top_sorted, top_row, (uint32_t*)dst);
  }
  return (int)cudaGetLastError();
}

// dst[r][j] = src[r][idx[j]] for the up to four rows r0..r3 (negative: no
// row) by way of rows4, n 16-byte entries of scratch: the rows are first
// laid side by side, then each key's entry is read once.
extern "C" int kt_gather_rows4(const void* src, long long n, const void* idx,
                               int r0, int r1, int r2, int r3, void* rows4,
                               void* dst, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  if (blocks > 0) {
    const Rows4 rows = {{r0, r1, r2, r3}};
    interleave_rows_kernel<<<(unsigned int)blocks, 256, 0, s>>>(
        (const uint32_t*)src, n, rows, (uint4*)rows4);
    gather_rows_kernel<<<(unsigned int)blocks, 256, 0, s>>>(
        (const uint4*)rows4, n, (const int*)idx, rows, (uint32_t*)dst);
  }
  return (int)cudaGetLastError();
}
