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
// What the design does about it:
//   - the three elementwise probes (streaming copy, grid copy, multiply-add
//     chain) share one kernel template. A block owns a whole tile of
//     `rows * 128` elements (the TPU probes' block, kept as the work of one
//     thread block so the probes can still sweep it; more tiles than a grid
//     holds are walked b, b + gridDim.x, ...). A memory-bound copy runs at
//     the rate of the bytes it keeps in flight, and with large tiles there
//     are few blocks, so what one block keeps in flight decides:
//       batched loads -- every thread starts four 16-byte loads before its
//         first store: threads x 64 bytes in flight a block. All three
//         probes run so while there is at least a tile for every SM, and
//         the two that compute always: their threads touch every byte
//         anyway, and on the card a trip through shared memory with a
//         barrier per stage cost more than its deeper queue of loads gained;
//       ring -- the grid copy with fewer tiles than SMs, where a block
//         alone has to keep an SM's share of the card's traffic in flight.
//         The block is one warp and no thread touches the data. Its elected
//         thread moves the tile through a ring of 6 stages of 16 KB in
//         shared memory: an asynchronous bulk copy (cp.async.bulk, the 1-D
//         form that needs no tensor map) from device memory for every stage
//         of the ring, each completing on its stage's mbarrier, and an
//         asynchronous bulk copy back to device memory from every stage
//         that has arrived. A stage is refilled as soon as the store started
//         before the newest one has read its stage
//         (cp.async.bulk.wait_group.read 1), so five stages of loads stay
//         in flight whatever `rows` is;
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

// ---- asynchronous bulk copies and their barriers (PTX, sm_90)

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// one arrival that also announces `bytes` of bulk copies to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// nanoseconds of the card's own clock
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the barrier's phase of the given parity has completed. A
// barrier that does not complete within kWaitLimitNs (a byte count or a
// parity gone wrong) traps: the launch then ends in an error, not a hang.
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const unsigned long long now = global_ns();
    if (t0 == 0) t0 = now;
    if (now - t0 > kWaitLimitNs) __trap();
  }
}

// device memory -> shared memory, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared memory -> device memory, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// until all but the newest kPending bulk groups have read their source
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// ---- the elementwise template: o[i] = op(x[i]) over 16-byte vectors

template <class Op>
__device__ __forceinline__ uint4 map4(uint4 a, const Op& op) {
  return make_uint4(op(a.x), op(a.y), op(a.z), op(a.w));
}

// The batched loads: the block walks its tile in batches of blockDim.x *
// kBatchLoads vectors, and a thread starts all the loads of a batch before
// its first store, so a block keeps threads x 64 bytes of loads in flight.
constexpr int kBatchLoads = 4;

template <class Op>
__global__ void tile_batch_kernel(const uint4* __restrict__ x,
                                  uint4* __restrict__ o, long long nvec,
                                  long long tile_vec, Op op) {
  for (long long lo = blockIdx.x * tile_vec; lo < nvec;
       lo += gridDim.x * tile_vec) {
    const long long hi = lo + tile_vec < nvec ? lo + tile_vec : nvec;
    for (long long base = lo + threadIdx.x; base < hi;
         base += (long long)blockDim.x * kBatchLoads) {
      uint4 a[kBatchLoads];
#pragma unroll
      for (int u = 0; u < kBatchLoads; ++u) {
        const long long i = base + (long long)u * blockDim.x;
        if (i < hi) a[u] = x[i];
      }
#pragma unroll
      for (int u = 0; u < kBatchLoads; ++u) {
        const long long i = base + (long long)u * blockDim.x;
        if (i < hi) o[i] = map4(a[u], op);
      }
    }
  }
}

// The ring, identity copy only: block b copies tile b (a block per tile,
// launched as one warp whose thread 0 is the elected thread and the only
// one that works) through kRingStages buffers of kStageVec vectors in
// dynamic shared memory, one mbarrier each. The tile is cut into chunks of
// a stage (the last may be short, and a tile smaller than a stage is one
// chunk). Chunk c lives in stage c % kRingStages and completes phase
// (c / kRingStages) & 1 of that stage's barrier. The first kRingStages loads
// are started up front; then, for every chunk in order: wait for its load,
// store it, and refill the stage of the chunk before it with the next chunk
// not yet loaded, once that chunk's store has read the stage.
constexpr int kStageVec = 1024;  // 16 KB a stage
constexpr int kRingStages = 6;   // 96 KB a block: two blocks fit one SM
constexpr uint32_t kStageBytes = kStageVec * 16u;
constexpr int kRingBytes = kRingStages * (int)kStageBytes;

__global__ void tile_ring_copy_kernel(const uint4* __restrict__ x,
                                      uint4* __restrict__ o, long long nvec,
                                      long long tile_vec) {
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) uint64_t full[kRingStages];
  if (threadIdx.x != 0) return;
  const uint32_t ring0 = shared_addr(ring);
  const uint32_t full0 = shared_addr(full);
  for (int s = 0; s < kRingStages; ++s) mbar_init(full0 + 8u * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const long long lo = blockIdx.x * tile_vec;
  const long long tile_len = tile_vec < nvec - lo ? tile_vec : nvec - lo;
  const long long chunks = (tile_len + kStageVec - 1) / kStageVec;
  x += lo;
  o += lo;
  const auto chunk_bytes = [&](long long c) {
    const long long left = tile_len - c * kStageVec;
    return (uint32_t)(left < kStageVec ? left : kStageVec) * 16u;
  };
  const auto load = [&](long long c) {
    const uint32_t s = (uint32_t)(c % kRingStages);
    mbar_expect_tx(full0 + 8u * s, chunk_bytes(c));
    bulk_load(ring0 + s * kStageBytes, x + c * kStageVec, chunk_bytes(c),
              full0 + 8u * s);
  };

  long long loaded = 0;
  for (; loaded < chunks && loaded < kRingStages; ++loaded) load(loaded);
  for (long long c = 0; c < chunks; ++c) {
    const uint32_t s = (uint32_t)(c % kRingStages);
    mbar_wait(full0 + 8u * s, (uint32_t)(c / kRingStages) & 1u);
    bulk_store(o + c * kStageVec, ring0 + s * kStageBytes, chunk_bytes(c));
    if (c > 0 && loaded < chunks) {
      // the store of chunk c - 1 has read its stage, which is the one that
      // chunk `loaded` = c - 1 + kRingStages belongs in
      bulk_wait_read<1>();
      load(loaded++);
    }
  }
  // shared memory must outlive the last stores' reads of it
  bulk_wait_read<0>();
}

// What a launch needs to know of the current device, asked once a device:
// its number of SMs, and whether the ring kernel has been given its shared
// memory there (above 48 KB a launch needs the attribute; and as much of
// the SM's L1 as shared memory as it takes to hold two rings).
struct DeviceFacts {
  int sms = 0;
  bool ring_ready = false;
};

constexpr int kMaxDevices = 64;

cudaError_t device_facts(DeviceFacts** facts) {
  static DeviceFacts known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceFacts& d = known[dev];
  if (d.sms == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (sms < 1) return cudaErrorInvalidDevice;
    d.sms = sms;
  }
  *facts = &d;
  return cudaSuccess;
}

cudaError_t ready_ring(DeviceFacts& d) {
  if (d.ring_ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      tile_ring_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_ring_copy_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  d.ring_ready = err == cudaSuccess;
  return err;
}

// What the card measured fastest, by what a launch can observe. Batched
// loads where the threads have work to do on the data anyway: on 1024
// threads for the one add, on 512 for the multiply-add chain, whose 61
// registers a thread let two such blocks share an SM where one block of
// 1024 leaves the SM idle between two tiles. For the identity copy the same
// batched loads while there is at least a tile for every SM, and the ring
// when there are fewer: then a block alone has to keep an SM's share of the
// card's bytes in flight, and the ring holds more of them than 1024 threads'
// registers do.
template <class Op>
constexpr int kBatchThreads = 1024;
template <>
constexpr int kBatchThreads<MulAddChain> = 512;

template <class Op>
constexpr bool kRingWhenFewTiles = false;
template <>
constexpr bool kRingWhenFewTiles<Identity> = true;

// threads rounded up to whole warps that `work` items keep busy
int warps_for(long long work, int threads) {
  return work < threads ? (int)((work + 31) / 32) * 32 : threads;
}

// P1, P5 and P7: a block per tile of tile_vec vectors (the last may be
// short); more tiles than a grid holds are walked b, b + gridDim.x, ...
template <class Op>
int launch_tile_map(const void* x, void* o, long long nvec, long long tile_vec,
                    Op op, void* stream) {
  if (nvec <= 0) return (int)cudaGetLastError();
  if (tile_vec < 1) return (int)cudaErrorInvalidValue;
  if (tile_vec > nvec) tile_vec = nvec;
  const long long tiles = (nvec + tile_vec - 1) / tile_vec;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint4* xv = (const uint4*)x;
  uint4* ov = (uint4*)o;
  if (kRingWhenFewTiles<Op>) {
    DeviceFacts* d = nullptr;
    cudaError_t err = device_facts(&d);
    const bool ring = err == cudaSuccess && tiles < d->sms;
    if (ring) err = ready_ring(*d);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here, not by the next launch
      return (int)err;
    }
    if (ring) {
      tile_ring_copy_kernel<<<(unsigned int)tiles, 32, kRingBytes, s>>>(
          xv, ov, nvec, tile_vec);
      return (int)cudaGetLastError();
    }
  }
  const long long grid = tiles < kMaxGrid ? tiles : kMaxGrid;
  const long long batches = (tile_vec + kBatchLoads - 1) / kBatchLoads;
  tile_batch_kernel<Op>
      <<<(unsigned int)grid, warps_for(batches, kBatchThreads<Op>), 0, s>>>(
          xv, ov, nvec, tile_vec, op);
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

}  // namespace

// P1: o = x + 1 (mod 2^32) over nvec 16-byte vectors in tiles of tile_vec
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
  return launch_tile_map(x, o, nvec, tile_vec, MulAddChain{mul, add},
                                 stream);
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
    DeviceFacts* d = nullptr;
    const cudaError_t asked = device_facts(&d);
    if (asked != cudaSuccess) return (int)asked;
    const long long sms = d->sms;
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
