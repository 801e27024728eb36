// K1: radix_sort_words -- stable LSD radix sort of W <= 9 32-bit key words.
//
// Replaces: lax.sort(words, num_keys=W) in kiss_tpu/ops/suffix_sort.py --
//   _seed_sort_impl (:334, 5 words for DNA), _full_round_impl (:389),
//   _tail_refine (:469, 8 rank keys + payload, is_stable=True) and
//   _rank_block_sort_impl (:521).
//
// What bounds it on the H100: device-memory traffic of the scatter passes
//   (8 bytes of key + index read and written per key per 8-bit digit),
//   the random gathers that bring each word into the current order, and
//   the write pattern: a scatter that writes each key straight to its
//   global slot hits 256 digit runs per tile with a few keys each.
//
// What the simple design does about it (the host side is the wrapper in
// kiss_tpu_torch/ops/radix_sort.py):
//   - one counting kernel over all W words finds every (word, byte) whose
//     digits all fall in one bucket; those passes are skipped, and a word
//     with no pass left is never touched (packed words often have
//     constant high bytes);
//   - words are sorted least significant first; only the word being
//     sorted and a 32-bit index travel through its passes
//     (kt_radix_sort_pass). The next word is gathered into the current
//     order once (kt_gather_words), and all W words once at the end;
//   - each pass is three kernels: a per-tile digit histogram, a
//     digit-major exclusive scan over the tiles, and a stable scatter;
//   - the scatter ranks keys inside a 4096-key tile with __match_any_sync:
//     each warp owns a contiguous run of the tile and walks it in order,
//     so the rank (warp offset + earlier rounds + lanes below with the
//     same digit) keeps the input order, which LSD requires. Keys are
//     first placed in shared memory in digit order, then written out by
//     consecutive threads to consecutive global slots of each digit run;
//   - warp-aggregated shared atomics (one add per digit group per warp)
//     keep the histograms cheap when many keys share a digit.
//
// Layout: keys[w * n + i] is word w of key i, word 0 most significant.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps; also the digit count
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // rounds of 32 keys per warp
constexpr int kWarpRun = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // 4096 keys per tile
constexpr int kBins = 256;
constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr unsigned int kNoDigit = 0x100u;  // tail lanes: matches no digit

__device__ __forceinline__ bool is_leader(unsigned int peers, int lane) {
  return (__ffs(peers) - 1) == lane;
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

// counts[(w * 4 + b) * 256 + d] = #keys whose byte b of word w is d
__global__ void digit_counts_kernel(const uint32_t* __restrict__ keys,
                                    long long n,
                                    unsigned int* __restrict__ counts) {
  __shared__ unsigned int h[4 * kBins];
  for (int i = threadIdx.x; i < 4 * kBins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const uint32_t* k = keys + (long long)blockIdx.y * n;
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps_per_block;
  for (long long c = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
       c * 32 < n; c += stride) {
    const long long i = c * 32 + lane;
    const bool valid = i < n;
    const uint32_t v = valid ? k[i] : 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned int d = valid ? ((v >> (8 * b)) & 0xFFu) : kNoDigit;
      const unsigned int peers = __match_any_sync(kFull, d);
      if (valid && is_leader(peers, lane)) {
        atomicAdd(&h[b * kBins + d], (unsigned int)__popc(peers));
      }
    }
  }
  __syncthreads();
  unsigned int* out = counts + (long long)blockIdx.y * 4 * kBins;
  for (int i = threadIdx.x; i < 4 * kBins; i += blockDim.x) {
    if (h[i]) atomicAdd(&out[i], h[i]);
  }
}

// hist[d * tiles + t] = #keys of tile t whose digit is d
__global__ void tile_hist_kernel(const uint32_t* __restrict__ keys,
                                 long long n, int shift,
                                 unsigned int* __restrict__ hist, int tiles) {
  __shared__ unsigned int h[kBins];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const long long i = t0 + (long long)r * kThreads + threadIdx.x;
    const bool valid = i < n;
    const unsigned int d = valid ? ((keys[i] >> shift) & 0xFFu) : kNoDigit;
    const unsigned int peers = __match_any_sync(kFull, d);
    if (valid && is_leader(peers, lane)) {
      atomicAdd(&h[d], (unsigned int)__popc(peers));
    }
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// in place: each digit's row of tile counts -> its exclusive prefix sums
// (one block of 1024 threads per digit)
__global__ void row_scan_kernel(unsigned int* __restrict__ hist, int tiles) {
  __shared__ unsigned int warp_sums[32];
  __shared__ unsigned int carry;
  unsigned int* row = hist + (long long)blockIdx.x * tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned int v = i < tiles ? row[i] : 0u;
    const unsigned int x = warp_scan(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const unsigned int s = lane < nwarps ? warp_sums[lane] : 0u;
      warp_sums[lane] = warp_scan(s, lane);  // inclusive over warps
    }
    __syncthreads();
    const unsigned int before = carry + (warp ? warp_sums[warp - 1] : 0u);
    if (i < tiles) row[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
}

// stable scatter of one 8-bit digit pass over (key, index)
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ keys_in,
               const int* __restrict__ idx_in, uint32_t* __restrict__ keys_out,
               int* __restrict__ idx_out, long long n, int shift,
               const unsigned int* __restrict__ tile_offsets,
               const unsigned int* __restrict__ digit_totals, int tiles) {
  __shared__ uint32_t s_key[kTile];
  __shared__ int s_idx[kTile];
  __shared__ unsigned int wcnt[kWarps][kBins];
  __shared__ unsigned int local_start[kBins];
  __shared__ unsigned int global_base[kBins];
  __shared__ unsigned int wsum_local[kWarps];
  __shared__ unsigned int wsum_global[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile0 = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
  __syncthreads();

  // phase A: load; per-warp digit counts. Warp w owns keys
  // [tile0 + w * kWarpRun, + kWarpRun), walked in rounds of 32.
  const long long start = tile0 + (long long)warp * kWarpRun;
  uint32_t key[kItems];
  int idx[kItems];
  unsigned int peers[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = start + r * 32 + lane;
    const bool valid = i < n;
    key[r] = valid ? keys_in[i] : 0u;
    idx[r] = valid ? (idx_in ? idx_in[i] : (int)i) : 0;
    const unsigned int d = valid ? ((key[r] >> shift) & 0xFFu) : kNoDigit;
    peers[r] = __match_any_sync(kFull, d);
    if (valid && is_leader(peers[r], lane)) wcnt[warp][d] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();

  // phase B (thread = digit): offsets of each warp inside the digit's run,
  // the digit's start inside the tile, and its global base
  unsigned int tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned int c = wcnt[w][tid];
    wcnt[w][tid] = tile_count;
    tile_count += c;
  }
  const unsigned int total = digit_totals[tid];
  const unsigned int xl = warp_scan(tile_count, lane);
  const unsigned int xg = warp_scan(total, lane);
  if (lane == 31) {
    wsum_local[warp] = xl;
    wsum_global[warp] = xg;
  }
  __syncthreads();
  unsigned int before_l = 0, before_g = 0;
  for (int w = 0; w < warp; ++w) {
    before_l += wsum_local[w];
    before_g += wsum_global[w];
  }
  local_start[tid] = before_l + xl - tile_count;
  global_base[tid] =
      before_g + xg - total + tile_offsets[(long long)tid * tiles + blockIdx.x];
  __syncthreads();

  // phase C: stable local rank -> the key's slot in digit order (smem)
  const unsigned int lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool valid = start + r * 32 + lane < n;
    const unsigned int d = (key[r] >> shift) & 0xFFu;
    unsigned int slot = 0;
    if (valid) slot = local_start[d] + wcnt[warp][d] + __popc(peers[r] & lanes_below);
    __syncwarp();
    if (valid && is_leader(peers[r], lane)) wcnt[warp][d] += __popc(peers[r]);
    __syncwarp();
    if (valid) {
      s_key[slot] = key[r];
      s_idx[slot] = idx[r];
    }
  }
  __syncthreads();

  // phase D: consecutive threads write consecutive slots of each digit run
  const long long left = n - tile0;
  const int tile_n = left < kTile ? (int)left : kTile;
  for (int j = tid; j < tile_n; j += kThreads) {
    const uint32_t k = s_key[j];
    const unsigned int d = (k >> shift) & 0xFFu;
    const unsigned int pos = global_base[d] + (unsigned int)j - local_start[d];
    keys_out[pos] = k;
    idx_out[pos] = s_idx[j];
  }
}

// dst[r * n + j] = src[r * n + idx[j]] for rows r < nrows
__global__ void gather_words_kernel(const uint32_t* __restrict__ src,
                                    int nrows, long long n,
                                    const int* __restrict__ idx,
                                    uint32_t* __restrict__ dst) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const long long from = idx[j];
    for (int r = 0; r < nrows; ++r) dst[r * n + j] = src[r * n + from];
  }
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
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned int)blocks, (unsigned int)nwords);
  digit_counts_kernel<<<grid, kThreads, 0, s>>>((const uint32_t*)keys, n,
                                                 (unsigned int*)counts);
  return (int)cudaGetLastError();
}

// One stable pass on byte (shift / 8) of a single key word carrying a
// 32-bit index. idx_in may be null (the identity). tile_hist holds
// 256 * ceil(n / 4096) counters; digit_totals the 256 digit counts of the
// word's byte (from kt_radix_digit_counts).
extern "C" int kt_radix_sort_pass(const void* keys_in, const void* idx_in,
                                  void* keys_out, void* idx_out, long long n,
                                  int shift, void* tile_hist,
                                  const void* digit_totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)((n + kTile - 1) / kTile);
  unsigned int* hist = (unsigned int*)tile_hist;
  tile_hist_kernel<<<tiles, kThreads, 0, s>>>((const uint32_t*)keys_in, n,
                                              shift, hist, tiles);
  row_scan_kernel<<<kBins, 1024, 0, s>>>(hist, tiles);
  scatter_kernel<<<tiles, kThreads, 0, s>>>(
      (const uint32_t*)keys_in, (const int*)idx_in, (uint32_t*)keys_out,
      (int*)idx_out, n, shift, hist, (const unsigned int*)digit_totals, tiles);
  return (int)cudaGetLastError();
}

// dst[r][j] = src[r][idx[j]] for the nrows rows of src (row length n)
extern "C" int kt_gather_words(const void* src, int nrows, long long n,
                               const void* idx, void* dst, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  if (blocks > 0) {
    gather_words_kernel<<<(unsigned int)blocks, 256, 0, s>>>(
        (const uint32_t*)src, nrows, n, (const int*)idx, (uint32_t*)dst);
  }
  return (int)cudaGetLastError();
}
