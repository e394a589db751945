// Hand-written Hopper (sm_90a) kernels for the sketch hot paths.
//
// K1 and K2 hash every k-byte window of uppercased DNA rows with the
// canonical-strand MurmurHash3 x64_128 (first 64-bit word, seed given) that
// sourmash uses for DNA: the window and its reverse complement are compared
// lexicographically and the lesser is hashed. A window is valid when all of
// its k bytes are A, C, G or T; a zero pad byte is never valid.
//
// K3 hashes every k-byte window of amino-acid rows (protein, or dayhoff/hp
// class bytes) as it is, with the same murmur; a window is valid when none
// of its bytes is 0, the record separator and row padding.
//
// The complement is the branchless ASCII map of the TPU kernel
// (`sourmash_tpu/ops/pallas_sketch.py:_complement_bytes`): c ^ 4 when bit 1
// of c is set, else c ^ 21. It swaps A<->T and C<->G and maps every other
// byte to a non-ACGT byte, so invalid windows hash the same garbage as the
// reference kernels and the outputs compare bit for bit everywhere.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;   // windows per segment: K1's compaction unit
constexpr int kTile = 256;  // windows (threads) per block: two segments
constexpr int kWarpsPerSeg = kSeg / 32;
constexpr int kStaticSmemLimit = 48 * 1024;

constexpr uint64_t kC1 = 0x87c37b91114253d5ULL;
constexpr uint64_t kC2 = 0x4cf5ad432745937fULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// A, C, G, T are 65, 67, 71, 84: bits 1, 3, 7, 20 above 64.
__device__ __forceinline__ bool is_acgt(uint32_t c) {
  constexpr uint64_t kMask = (1ULL << 1) | (1ULL << 3) | (1ULL << 7) | (1ULL << 20);
  return (c >> 6) == 1u && ((kMask >> (c & 63u)) & 1ULL);
}

__device__ __forceinline__ uint32_t complement(uint32_t c) {
  return c ^ ((c & 2u) ? 4u : 21u);
}

// Byte i of the canonical window starting at s: s[i] on the forward
// strand, complement(s[k-1-i]) on the reverse. Branch-free in `rev`, so a
// warp whose windows pick different strands does not diverge.
__device__ __forceinline__ uint32_t canon_byte(const uint8_t* s, int k, bool rev, int i) {
  uint32_t c = s[rev ? k - 1 - i : i];
  return rev ? complement(c) : c;
}

// Little-endian word of `len` (1..8) window bytes from position `start`;
// clears `ok` if one of them is not valid. DNA (kAA false): canonical bytes,
// valid when ACGT. Amino acids (kAA true): the bytes as they are, valid when
// not 0.
template <bool kAA>
__device__ __forceinline__ uint64_t window_word(const uint8_t* s, int k, bool rev,
                                                int start, int len, bool& ok) {
  uint64_t w = 0;
  for (int i = 0; i < len; ++i) {
    uint32_t c = kAA ? s[start + i] : canon_byte(s, k, rev, start + i);
    ok = ok && (kAA ? c != 0u : is_acgt(c));
    w |= static_cast<uint64_t>(c) << (8 * i);
  }
  return w;
}

// MurmurHash3 x64_128, first 64-bit word, of the k-byte window at s
// (shared memory) read through window_word<kAA>, and its validity.
template <bool kAA>
__device__ __forceinline__ uint64_t murmur_window(const uint8_t* s, int k, bool rev,
                                                  uint64_t seed, bool& ok) {
  ok = true;
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = window_word<kAA>(s, k, rev, 16 * b, 8, ok);
    uint64_t k2 = window_word<kAA>(s, k, rev, 16 * b + 8, 8, ok);
    k1 *= kC1; k1 = rotl64(k1, 31); k1 *= kC2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= kC2; k2 = rotl64(k2, 33); k2 *= kC1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const int tail = k & 15;
  const int base = 16 * nblocks;
  if (tail > 8) {
    uint64_t k2 = window_word<kAA>(s, k, rev, base + 8, tail - 8, ok);
    k2 *= kC2; k2 = rotl64(k2, 33); k2 *= kC1; h2 ^= k2;
  }
  if (tail > 0) {
    uint64_t k1 = window_word<kAA>(s, k, rev, base, tail < 8 ? tail : 8, ok);
    k1 *= kC1; k1 = rotl64(k1, 31); k1 *= kC2; h1 ^= k1;
  }
  h1 ^= static_cast<uint64_t>(k);
  h2 ^= static_cast<uint64_t>(k);
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// Canonical hash of the k-byte DNA window at s (shared memory) and its
// validity (every byte ACGT).
__device__ uint64_t window_hash(const uint8_t* s, int k, uint64_t seed, bool& ok) {
  // strand: the first byte where the window and its reverse complement
  // differ decides; a palindrome hashes the forward strand
  bool rev = false;
  for (int j = 0; j < k; ++j) {
    uint32_t f = s[j];
    uint32_t r = complement(s[k - 1 - j]);
    if (f != r) {
      rev = r < f;
      break;
    }
  }
  return murmur_window<false>(s, k, rev, seed, ok);
}

// Hash of the k-byte amino-acid window at s (shared memory), as it is, and
// its validity (no zero byte: zero separates records and pads rows).
__device__ uint64_t aa_window_hash(const uint8_t* s, int k, uint64_t seed, bool& ok) {
  return murmur_window<true>(s, k, false, seed, ok);
}

// Stage bytes [w0, w0 + kTile + k - 1) of one row into shared memory with
// coalesced loads; bytes past the row's end read as 0 (never valid).
__device__ __forceinline__ void stage_row(const uint8_t* row, int S, int64_t w0,
                                          int span, uint8_t* smem) {
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    int64_t p = w0 + i;
    smem[i] = p < S ? row[p] : 0;
  }
}

// K2. Replaces sourmash_tpu/ops/pallas_sketch.py:window_hash_pairs_pallas
// (kernel _sketch_block_kernel over _hash_streams).
//
// Bound: integer ALU, not memory. A window reads ~1 new byte and writes 9
// (hash + validity), while its murmur costs ~130 32-bit integer operations
// (each 64-bit multiply is several IMADs) and the canonical byte gather as
// many again. Design: one thread per window, a block's bytes plus the k-1
// halo staged once in shared memory so every byte is read from device
// memory once; the strand choice is branch-free in the byte loop, and the
// early-exit strand compare only diverges for the rare windows that share
// a long prefix with their reverse complement.
__global__ void __launch_bounds__(kTile)
window_hashes_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k,
                     uint64_t seed, uint64_t* __restrict__ hashes,
                     uint8_t* __restrict__ valid) {
  extern __shared__ uint8_t smem[];
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_row(seq + static_cast<int64_t>(b) * S, S, w0, kTile + k - 1, smem);
  __syncthreads();

  const int64_t w = w0 + threadIdx.x;
  if (w >= n_pad) return;
  bool ok;
  uint64_t h = window_hash(smem + threadIdx.x, k, seed, ok);
  const int64_t out = static_cast<int64_t>(b) * n_pad + w;
  hashes[out] = h;
  valid[out] = ok ? 1 : 0;
}

// K3. Replaces sourmash_tpu/ops/pallas_sketch.py:aa_window_hash_pairs_pallas
// (kernel _sketch_block_kernel over _aa_hash_streams).
//
// Bound: about half K2's integer work per window (no strand compare, one
// byte stream), so at sourmash's protein k=10 the 9 bytes written per
// window bound it, and integer ALU from k ~ 16 up. Design: K2's, one thread
// per window over the block's bytes plus the k-1 halo in shared memory; the
// murmur runs on native uint64_t.
__global__ void __launch_bounds__(kTile)
aa_window_hashes_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k,
                        uint64_t seed, uint64_t* __restrict__ hashes,
                        uint8_t* __restrict__ valid) {
  extern __shared__ uint8_t smem[];
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_row(seq + static_cast<int64_t>(b) * S, S, w0, kTile + k - 1, smem);
  __syncthreads();

  const int64_t w = w0 + threadIdx.x;
  if (w >= n_pad) return;
  bool ok;
  uint64_t h = aa_window_hash(smem + threadIdx.x, k, seed, ok);
  const int64_t out = static_cast<int64_t>(b) * n_pad + w;
  hashes[out] = h;
  valid[out] = ok ? 1 : 0;
}

// K1. Replaces sourmash_tpu/ops/pallas_sketch.py:sketch_survivor_slots_pallas
// (kernel _sketch_slots_kernel over _hash_streams).
//
// Bound: integer ALU, as K2; its output is a few bytes per 128 windows.
// Design: K2's per-window hash, then the threshold, then a rank within the
// 128-window segment from four warps: __ballot_sync of the survivors,
// __popc below the lane, and a shared prefix of the four warp counts. A
// survivor of rank r < slots writes slot r; unused slots are written 0 and
// the segment's TRUE count is written even when it exceeds `slots`, so the
// caller can send that row to K2.
__global__ void __launch_bounds__(kTile)
survivor_slots_kernel(const uint8_t* __restrict__ seq, int S, int n, int R, int k,
                      uint64_t seed, uint64_t max_hash, int slots,
                      uint32_t* __restrict__ slots_hi, uint32_t* __restrict__ slots_lo,
                      int32_t* __restrict__ counts) {
  extern __shared__ uint8_t smem[];
  __shared__ int warp_count[kTile / 32];
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_row(seq + static_cast<int64_t>(b) * S, S, w0, kTile + k - 1, smem);
  __syncthreads();

  const int t = threadIdx.x;
  const int64_t w = w0 + t;
  bool keep = false;
  uint64_t h = 0;
  if (w < n) {
    bool ok;
    h = window_hash(smem + t, k, seed, ok);
    keep = ok && h <= max_hash;
  }

  const int warp = t >> 5;
  const int lane = t & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();

  const int seg_in_block = t / kSeg;
  const int first_warp = seg_in_block * kWarpsPerSeg;
  int before = 0, total = 0;
  for (int i = 0; i < kWarpsPerSeg; ++i) {
    const int c = warp_count[first_warp + i];
    total += c;
    if (first_warp + i < warp) before += c;
  }
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * (kTile / kSeg) + seg_in_block;
  if (seg >= R) return;

  const int64_t base = (static_cast<int64_t>(b) * R + seg) * slots;
  const int rank = before + __popc(ballot & ((1u << lane) - 1u));
  if (keep && rank < slots) {
    slots_hi[base + rank] = static_cast<uint32_t>(h >> 32);
    slots_lo[base + rank] = static_cast<uint32_t>(h);
  }
  const int r = t % kSeg;
  if (r < slots && r >= total) {
    slots_hi[base + r] = 0;
    slots_lo[base + r] = 0;
  }
  if (r == 0) counts[static_cast<int64_t>(b) * R + seg] = total;
}

// Dynamic shared memory for one block: the tile's bytes plus the k-1 halo.
// Above the 48 KB default (less the kernels' small static arrays) a kernel
// must opt in; beyond the card's per-block maximum the launch is refused
// and the error returned.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, int k, size_t* bytes) {
  *bytes = static_cast<size_t>(kTile) + static_cast<size_t>(k) - 1;
  if (*bytes + 1024 <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

extern "C" {

const char* sm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hashes [B, n_pad] u64, valid [B, n_pad] u8 for rows seq [B, S] u8.
int sm_window_hashes(const void* seq, int B, int S, int n_pad, int ksize,
                     uint64_t seed, void* hashes, void* valid, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare_smem(window_hashes_kernel, ksize, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_pad + kTile - 1) / kTile, B);
  window_hashes_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), S, n_pad, ksize, seed,
      static_cast<uint64_t*>(hashes), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// hashes [B, n_pad] u64, valid [B, n_pad] u8 for amino-acid rows seq [B, S] u8.
int sm_aa_window_hashes(const void* seq, int B, int S, int n_pad, int ksize,
                        uint64_t seed, void* hashes, void* valid, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare_smem(aa_window_hashes_kernel, ksize, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_pad + kTile - 1) / kTile, B);
  aa_window_hashes_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), S, n_pad, ksize, seed,
      static_cast<uint64_t*>(hashes), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// slots_hi, slots_lo [B, R, slots] u32 and counts [B, R] i32 for rows
// seq [B, S] u8 with n = S - ksize + 1 windows and R = ceil(n / 128).
int sm_survivor_slots(const void* seq, int B, int S, int n, int R, int ksize,
                      uint64_t seed, uint64_t max_hash, int slots,
                      void* slots_hi, void* slots_lo, void* counts, void* stream) {
  if (slots < 1 || slots > kSeg) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare_smem(survivor_slots_kernel, ksize, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segs_per_block = kTile / kSeg;
  dim3 grid((R + segs_per_block - 1) / segs_per_block, B);
  survivor_slots_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), S, n, R, ksize, seed, max_hash, slots,
      static_cast<uint32_t*>(slots_hi), static_cast<uint32_t*>(slots_lo),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
