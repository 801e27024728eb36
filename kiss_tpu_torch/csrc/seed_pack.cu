// K5: seed_key_words -- the seed sort's key words, written in K1's layout.
//
// Replaces: no TPU kernel. The JAX package builds these words with jnp ops
//   (kiss_tpu/ops/pack.py: suffix_key_words_2bit, fused_end_pos, then
//   _pack_fields in kiss_tpu/ops/suffix_sort.py), which XLA fuses; in
//   eager PyTorch the same chain is some 70 int64 shift and OR kernels over
//   the text (about 40 bytes a row a character), the largest piece of the
//   port's sort. This kernel is that chain in one pass.
//
// What it computes, for a text of n bytes, seed_chars in [1, 64] and
//   fbits = max(bit_length(n), 1): W = ceil(seed_chars / 16) + 1 rows of
//   N = n + 1 uint32 words (int32 bits), out[w * N + p]:
//   - w < W - 1: characters p + 16w .. p + 16w + c - 1 of the text, c =
//     min(16, seed_chars - 16w), each as its byte value shifted left by
//     2 (15 - j) and ORed in, big-endian; a character at or past n counts
//     as 0. A byte above 3 spills into its neighbours' lanes exactly as the
//     plain int64 chain's OR does before its mask to 32 bits;
//   - w = W - 1: the fused end/position word, n - p where n - p <
//     seed_chars, else p + seed_chars, shifted left by 32 - fbits (the
//     aligned placement _field_layout gives it).
//   Bit for bit what pack.seed_key_words_plain returns.
//
// What bounds it on the H100: the bytes it writes. 4 W bytes a row out for
//   1 byte a row in: 1.025 GB at N = 48.8M and W = 5, 0.306 ms at
//   3.35 TB/s.
//
// What the design does about it:
//   - a block stages its tile of text (4096 columns) with a 4-byte front
//     and a 64-byte back halo in shared memory, read once from device
//     memory in aligned 32-bit loads; every character a word needs comes
//     from there;
//   - a thread owns groups of 4 neighbouring columns of a row; a warp's
//     32 groups are 128 neighbouring columns, stored as one 16-byte store
//     a thread, so every store is coalesced and wide. Row w begins at word
//     w * N, which is 16-byte aligned only when w * N is a multiple of 4,
//     so row w's groups are shifted by (w * N) mod 4 columns: every full
//     group is an aligned uint4, and only the groups that cross column 0 or
//     N store word by word;
//   - the words of a group are rolled, not rebuilt: word(p + 1) =
//     (word(p) << 2) | (byte(p + c) << 2 (16 - c)), exact in 32-bit
//     arithmetic for any byte, so a column costs 3 operations past the
//     group's first;
//   - columns and row offsets are 64-bit: N may reach 2^32 - 1, where
//     w * N passes 2^32.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // groups of 4 columns a thread, in each row
constexpr int kTileCols = 4 * kThreads * kGroups;  // 4096
constexpr int kMaxChars = 64;
constexpr int kFront = 4;  // a row's groups start up to 3 columns early
constexpr int kStaged = kFront + kTileCols + kMaxChars;  // bytes, 4 | kStaged

__global__ void __launch_bounds__(kThreads) seed_key_words_kernel(
    const unsigned char* __restrict__ text, long long n, int seed_chars,
    int fbits, uint32_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char tile[kStaged];
  const long long N = n + 1;
  const long long base = (long long)blockIdx.x * kTileCols;
  // tile[i] = text[base - kFront + i], 0 outside [0, n)
  const long long lo = base - kFront;
  const bool aligned = (reinterpret_cast<uintptr_t>(text) & 3) == 0;
  for (int i = threadIdx.x; i < kStaged / 4; i += kThreads) {
    const long long at = lo + 4LL * i;
    uint32_t v = 0;
    if (aligned && at >= 0 && at + 4 <= n) {
      v = __ldg(reinterpret_cast<const uint32_t*>(text + at));
    } else {
      for (int b = 0; b < 4; ++b) {
        const long long q = at + b;
        if (q >= 0 && q < n) v |= (uint32_t)text[q] << (8 * b);
      }
    }
    reinterpret_cast<uint32_t*>(tile)[i] = v;
  }
  __syncthreads();

  const int raw_words = (seed_chars + 15) / 16;
  const int fshift = 32 - fbits;
  for (int w = 0; w <= raw_words; ++w) {
    uint32_t* row = out + (long long)w * N;
    const int r = (int)(((long long)w * N) & 3);
    const int c = w < raw_words ? min(16, seed_chars - 16 * w) : 0;
    const int in_shift = 2 * (16 - c);
    for (int k = 0; k < kGroups; ++k) {
      const int g = k * kThreads + threadIdx.x;
      const long long col = base + 4LL * g - r;
      if (col >= N) break;  // the later groups lie further right
      uint32_t v[4];
      if (w < raw_words) {
        // s[j]: character j of word w of column col
        const unsigned char* s = tile + kFront + 4 * g - r + 16 * w;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j < c) word |= (uint32_t)s[j] << (2 * (15 - j));
        }
        v[0] = word;
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          word = (word << 2) | ((uint32_t)s[c - 1 + i] << in_shift);
          v[i] = word;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long p = col + i;
          const long long left = n - p;
          const long long f = left < seed_chars ? left : p + seed_chars;
          v[i] = (uint32_t)f << fshift;
        }
      }
      if (col >= 0 && col + 4 <= N) {
        *reinterpret_cast<uint4*>(row + col) =
            make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (col + i >= 0 && col + i < N) row[col + i] = v[i];
        }
      }
    }
  }
}

}  // namespace

// text: n bytes (int8 or uint8); out: W * (n + 1) 32-bit words, 16-byte
// aligned (a fresh torch.empty is), every one written here.
extern "C" int kt_seed_key_words(const void* text, long long n,
                                 int seed_chars, int fbits, void* out,
                                 void* stream) {
  if (n < 0 || seed_chars < 1 || seed_chars > kMaxChars || fbits < 1 ||
      fbits > 32 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n + 1 + 3 + kTileCols - 1) / kTileCols;
  seed_key_words_kernel<<<(unsigned int)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const unsigned char*)text, n, seed_chars, fbits, (uint32_t*)out);
  return (int)cudaGetLastError();
}
