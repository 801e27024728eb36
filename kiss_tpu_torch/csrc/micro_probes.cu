// P1-P7: the hardware probes -- streaming copy, one bitonic stage, in-tile
// sort, table gather, grid copy, 2-D copy, integer multiply-add chain.
//
// Replaces the seven Pallas probes of the TPU:
//   kt_probe_stream_copy -> stream_copy   (experiments/micro_pallas.py:52)
//   kt_probe_one_stage   -> one_stage     (experiments/micro_pallas.py:101)
//   kt_probe_tile_sort   -> tile_sort     (experiments/micro_pallas.py:147)
//   kt_probe_gather      -> kernel_gather (experiments/micro_pallas.py:176)
//   kt_probe_copy_grid   -> copy_grid     (experiments/micro_copy.py:43)
//   kt_probe_copy_2d     -> copy_2d       (experiments/micro_copy.py:62)
//   kt_probe_heavy       -> run_heavy     (experiments/micro_copy.py:103)
//
// What bounds them on the H100: device-memory bytes for all but two. The
//   multiply-add chain does 128 integer operations per 8 bytes moved and is
//   bound by the integer lanes. The in-tile sort runs log2(T)(log2(T)+1)/2
//   compare-exchange steps over every pair, so it is bound by shared-memory
//   traffic in the steps it keeps on chip and by device memory in the steps
//   whose partners are further apart than a block's shared memory holds.
//
// What the simple design does about it:
//   - the four elementwise probes share one kernel template: a block owns
//     one tile of `rows * 128` elements (the TPU probes' block, kept as the
//     work of one thread block so the probes can still sweep it) and moves
//     it 16 bytes a thread, neighbouring threads on neighbouring addresses;
//   - the 2-D copy spreads each row of the [tiles, rows * 128] view over
//     many small blocks (blockIdx.y is the row), the other launch geometry;
//   - the gather stages the table in dynamic shared memory when it fits a
//     block's 227 KB (one block per SM, each walking several tiles), and
//     otherwise reads it through the read-only cache, where a small table
//     stays resident in L2;
//   - one bitonic stage is one thread per pair, straight from device
//     memory: partners i and i | d are read and written once;
//   - the in-tile sort sorts sub-blocks of 8192 pairs in shared memory
//     (every step with d < 8192), and runs the steps with d >= 8192 through
//     the one-stage kernel in place.
//
// Keys are unsigned 32-bit, payloads signed 32-bit; pairs order by (key,
// payload). Every entry point returns cudaGetLastError() after its launches
// (or the error of the attribute call that a launch needed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMapThreads = 512;
constexpr int kSortSub = 8192;  // pairs a block sorts in shared memory
constexpr int kSortThreads = 1024;
constexpr int kHeavySteps = 64;
constexpr long long kMaxGrid = 0x7FFFFFFFll;

struct AddOne {
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return x + 1u;
  }
};

struct Identity {
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const { return x; }
};

// 64 dependent multiply-adds. The factors are kernel arguments, not
// constants, so the compiler cannot fold the chain into one multiply-add.
struct MulAddChain {
  uint32_t mul, add;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
#pragma unroll
    for (int s = 0; s < kHeavySteps; ++s) v = v * mul + add;
    return v;
  }
};

// o[i] = op(x[i]) over 16-byte vectors; block b owns the tiles b,
// b + gridDim.x, ... of tile_vec vectors each (the last tile may be short)
template <class Op>
__global__ void tile_map_kernel(const uint4* __restrict__ x,
                                uint4* __restrict__ o, long long nvec,
                                long long tile_vec, Op op) {
  for (long long lo = blockIdx.x * tile_vec; lo < nvec;
       lo += gridDim.x * tile_vec) {
    const long long hi = lo + tile_vec < nvec ? lo + tile_vec : nvec;
#pragma unroll 4
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      uint4 a = x[i];
      a.x = op(a.x);
      a.y = op(a.y);
      a.z = op(a.z);
      a.w = op(a.w);
      o[i] = a;
    }
  }
}

template <class Op>
int launch_tile_map(const void* x, void* o, long long nvec, long long tile_vec,
                    Op op, void* stream) {
  if (nvec > 0) {
    long long tiles = (nvec + tile_vec - 1) / tile_vec;
    if (tiles > kMaxGrid) tiles = kMaxGrid;
    int threads = kMapThreads;
    if (tile_vec < threads) threads = (int)((tile_vec + 31) / 32) * 32;
    tile_map_kernel<Op><<<(unsigned int)tiles, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint4*)x, (uint4*)o, nvec, tile_vec, op);
  }
  return (int)cudaGetLastError();
}

// identity copy of a [rows2d, row_vec] array of 16-byte vectors: blockIdx.y
// is the row, and a block moves 4 vectors a thread of that row
constexpr int kCopy2dThreads = 256;
constexpr int kCopy2dItems = 4;

__global__ void copy_2d_kernel(const uint4* __restrict__ x,
                               uint4* __restrict__ o, long long row_vec) {
  const uint4* xr = x + blockIdx.y * row_vec;
  uint4* orow = o + blockIdx.y * row_vec;
  const long long c0 =
      (long long)blockIdx.x * (kCopy2dThreads * kCopy2dItems) + threadIdx.x;
  uint4 a[kCopy2dItems];
#pragma unroll
  for (int u = 0; u < kCopy2dItems; ++u) {
    const long long c = c0 + u * kCopy2dThreads;
    if (c < row_vec) a[u] = xr[c];
  }
#pragma unroll
  for (int u = 0; u < kCopy2dItems; ++u) {
    const long long c = c0 + u * kCopy2dThreads;
    if (c < row_vec) orow[c] = a[u];
  }
}

// o[i] = x[idx[i]]; kShared stages the table in dynamic shared memory first.
// An index is clamped as an unsigned number to the last entry, so no value
// of idx makes the kernel read outside the table.
template <bool kShared>
__global__ void gather_kernel(const uint32_t* __restrict__ x, int n_table,
                              const int4* __restrict__ idx,
                              uint4* __restrict__ o, long long nvec,
                              long long tile_vec) {
  extern __shared__ uint32_t table[];
  if (kShared) {
    for (int t = threadIdx.x; t < n_table; t += blockDim.x) table[t] = x[t];
    __syncthreads();
  }
  const uint32_t last = (uint32_t)n_table - 1u;
  const uint32_t* src = kShared ? table : x;
  for (long long lo = blockIdx.x * tile_vec; lo < nvec;
       lo += gridDim.x * tile_vec) {
    const long long hi = lo + tile_vec < nvec ? lo + tile_vec : nvec;
#pragma unroll 4
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int4 j = idx[i];
      const uint32_t jx = min((uint32_t)j.x, last);
      const uint32_t jy = min((uint32_t)j.y, last);
      const uint32_t jz = min((uint32_t)j.z, last);
      const uint32_t jw = min((uint32_t)j.w, last);
      uint4 r;
      if (kShared) {
        r.x = src[jx];
        r.y = src[jy];
        r.z = src[jz];
        r.w = src[jw];
      } else {
        r.x = __ldg(src + jx);
        r.y = __ldg(src + jy);
        r.z = __ldg(src + jz);
        r.w = __ldg(src + jw);
      }
      o[i] = r;
    }
  }
}

__device__ __forceinline__ bool pair_less(uint32_t ka, int va, uint32_t kb,
                                          int vb) {
  return ka < kb || (ka == kb && va < vb);
}

// One compare-exchange of partners i, i | d (d a power of two) for every
// pair of the array. Each element keeps itself or takes its partner by the
// rule of the TPU kernel (micro_pallas.py:90-96): keep_min = ((idx & 2 *
// stage_d) == 0) == ((idx & d) == 0) with idx local to its tile of `tile`
// elements, and an element keeps itself when it is the smaller one and
// keep_min holds, or is not the smaller one and keep_min does not hold.
// Safe in place (ko == k, vo == v): a pair belongs to one thread.
__global__ void one_stage_kernel(const uint32_t* k, const int* v, uint32_t* ko,
                                 int* vo, long long npairs, long long tile,
                                 int tile_pow2, long long d,
                                 long long stage_d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < npairs; p += stride) {
    const long long i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
    const long long j = i | d;
    const long long li = tile_pow2 ? (i & (tile - 1)) : (i % tile);
    const long long lj = tile_pow2 ? (j & (tile - 1)) : (j % tile);
    // (li & d) == 0 and (lj & d) != 0: the tile is a multiple of 2 * d
    const bool keep_min_i = (li & (2 * stage_d)) == 0;
    const bool keep_min_j = (lj & (2 * stage_d)) != 0;
    const uint32_t ki = k[i], kj = k[j];
    const int vi = v[i], vj = v[j];
    const bool lt_i = pair_less(ki, vi, kj, vj);
    const bool lt_j = pair_less(kj, vj, ki, vi);
    const bool self_i = keep_min_i ? lt_i : !lt_i;
    const bool self_j = keep_min_j ? lt_j : !lt_j;
    ko[i] = self_i ? ki : kj;
    vo[i] = self_i ? vi : vj;
    ko[j] = self_j ? kj : ki;
    vo[j] = self_j ? vj : vi;
  }
}

int launch_one_stage(const void* k, const void* v, void* ko, void* vo,
                     long long n, long long tile, long long d,
                     long long stage_d, cudaStream_t s) {
  const long long npairs = n / 2;
  if (npairs > 0) {
    const int threads = 256;
    long long blocks = (npairs + threads - 1) / threads;
    if (blocks > kMaxGrid) blocks = kMaxGrid;
    one_stage_kernel<<<(unsigned int)blocks, threads, 0, s>>>(
        (const uint32_t*)k, (const int*)v, (uint32_t*)ko, (int*)vo, npairs,
        tile, (tile & (tile - 1)) == 0, d, stage_d);
  }
  return (int)cudaGetLastError();
}

// Bitonic steps inside a sub-block of `sub` consecutive pairs held in
// shared memory (sub a power of two that divides the power-of-two tile).
// merge_size == 0: the full network up to runs of `sub` (sizes 2 .. sub).
// merge_size > sub: the steps d = sub / 2 .. 1 of the merge of runs of
// merge_size. A run is ascending where (tile-local index & size) == 0.
// Safe in place: a block reads its sub-block whole before it writes it.
__global__ void bitonic_local_kernel(const uint32_t* k, const int* v,
                                     uint32_t* ko, int* vo, long long tile,
                                     int sub, long long merge_size) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sk = smem;
  int* sv = (int*)(smem + sub);
  const long long base = (long long)blockIdx.x * sub;
  const long long local0 = base & (tile - 1);
  const uint4* k4 = (const uint4*)(k + base);
  const int4* v4 = (const int4*)(v + base);
  for (int s = threadIdx.x; s < sub / 4; s += blockDim.x) {
    ((uint4*)sk)[s] = k4[s];
    ((int4*)sv)[s] = v4[s];
  }
  __syncthreads();
  long long size = merge_size ? merge_size : 2;
  const long long last = merge_size ? merge_size : sub;
  for (; size <= last; size <<= 1) {
    const long long top = size >> 1;
    for (int d = top < sub / 2 ? (int)top : sub / 2; d > 0; d >>= 1) {
      for (int p = threadIdx.x; p < sub / 2; p += blockDim.x) {
        const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        const int j = i | d;
        const bool asc = ((local0 + i) & size) == 0;
        const uint32_t ki = sk[i], kj = sk[j];
        const int vi = sv[i], vj = sv[j];
        if (pair_less(kj, vj, ki, vi) == asc) {
          sk[i] = kj;
          sk[j] = ki;
          sv[i] = vj;
          sv[j] = vi;
        }
      }
      __syncthreads();
    }
  }
  uint4* ko4 = (uint4*)(ko + base);
  int4* vo4 = (int4*)(vo + base);
  for (int s = threadIdx.x; s < sub / 4; s += blockDim.x) {
    ko4[s] = ((uint4*)sk)[s];
    vo4[s] = ((int4*)sv)[s];
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1) {
    sms = 1;
  }
  return sms;
}

}  // namespace

// P1: o = x + 1 (mod 2^32) over nvec 16-byte vectors, tile_vec a block
extern "C" int kt_probe_stream_copy(const void* x, void* o, long long nvec,
                                    long long tile_vec, void* stream) {
  return launch_tile_map(x, o, nvec, tile_vec, AddOne{}, stream);
}

// P5: o = x, the same grid of tiles
extern "C" int kt_probe_copy_grid(const void* x, void* o, long long nvec,
                                  long long tile_vec, void* stream) {
  return launch_tile_map(x, o, nvec, tile_vec, Identity{}, stream);
}

// P7: 64 x (v = v * mul + add) per element (mod 2^32)
extern "C" int kt_probe_heavy(const void* x, void* o, long long nvec,
                              long long tile_vec, unsigned int mul,
                              unsigned int add, void* stream) {
  return launch_tile_map(x, o, nvec, tile_vec, MulAddChain{mul, add}, stream);
}

// P6: o = x for a [rows2d, row_vec] array of 16-byte vectors (rows2d <= 65535)
extern "C" int kt_probe_copy_2d(const void* x, void* o, long long rows2d,
                                long long row_vec, void* stream) {
  if (rows2d > 0 && row_vec > 0) {
    const int per_block = kCopy2dThreads * kCopy2dItems;
    const dim3 grid((unsigned int)((row_vec + per_block - 1) / per_block),
                    (unsigned int)rows2d);
    copy_2d_kernel<<<grid, kCopy2dThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (uint4*)o, row_vec);
  }
  return (int)cudaGetLastError();
}

// P4: o[i] = x[idx[i]] for nvec vectors of 4 indices, each in [0, n_table).
// use_shared != 0 stages the table (n_table * 4 bytes, at most 232448) in
// shared memory; 0 reads it through the read-only cache.
extern "C" int kt_probe_gather(const void* x, int n_table, const void* idx,
                               void* o, long long nvec, long long tile_vec,
                               int use_shared, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nvec <= 0) return (int)cudaGetLastError();
  long long tiles = (nvec + tile_vec - 1) / tile_vec;
  if (tiles > kMaxGrid) tiles = kMaxGrid;
  if (use_shared) {
    const size_t bytes = (size_t)n_table * sizeof(uint32_t);
    const cudaError_t err = cudaFuncSetAttribute(
        gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const long long sms = sm_count();
    gather_kernel<true><<<(unsigned int)(tiles < sms ? tiles : sms), 1024,
                          bytes, s>>>((const uint32_t*)x, n_table,
                                      (const int4*)idx, (uint4*)o, nvec,
                                      tile_vec);
  } else {
    gather_kernel<false><<<(unsigned int)tiles, kMapThreads, 0, s>>>(
        (const uint32_t*)x, n_table, (const int4*)idx, (uint4*)o, nvec,
        tile_vec);
  }
  return (int)cudaGetLastError();
}

// P2: one compare-exchange stage over n elements in tiles of `tile`
// (n a multiple of tile, tile a multiple of 2 * d, d a power of two)
extern "C" int kt_probe_one_stage(const void* k, const void* v, void* ko,
                                  void* vo, long long n, long long tile,
                                  long long d, long long stage_d,
                                  void* stream) {
  return launch_one_stage(k, v, ko, vo, n, tile, d, stage_d,
                          (cudaStream_t)stream);
}

// P3: every tile of `tile` elements (a power of two >= 128 that divides n)
// sorted ascending by (key, payload) into ko, vo
extern "C" int kt_probe_tile_sort(const void* k, const void* v, void* ko,
                                  void* vo, long long n, long long tile,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int sub = tile < kSortSub ? (int)tile : kSortSub;
  const int threads = sub / 2 < kSortThreads ? sub / 2 : kSortThreads;
  const size_t bytes = (size_t)sub * 2 * sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      bitonic_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)(n / sub);
  bitonic_local_kernel<<<blocks, threads, bytes, s>>>(
      (const uint32_t*)k, (const int*)v, (uint32_t*)ko, (int*)vo, tile, sub,
      0);
  for (long long size = 2ll * sub; size <= tile; size <<= 1) {
    for (long long d = size >> 1; d >= sub; d >>= 1) {
      const int rc = launch_one_stage(ko, vo, ko, vo, n, tile, d, size >> 1, s);
      if (rc != 0) return rc;
    }
    bitonic_local_kernel<<<blocks, threads, bytes, s>>>(
        (const uint32_t*)ko, (const int*)vo, (uint32_t*)ko, (int*)vo, tile,
        sub, size);
  }
  return (int)cudaGetLastError();
}
