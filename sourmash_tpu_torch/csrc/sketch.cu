// Hand-written Hopper (sm_90a) kernels for the sketch hot paths.
//
// K1 and K2 hash every k-byte window of uppercased DNA rows with the
// canonical-strand MurmurHash3 x64_128 (first 64-bit word, seed given) that
// sourmash uses for DNA; the hash, the complement and the validity rule are
// in sketch_common.cuh.
//
// K3 hashes every k-byte window of amino-acid rows (protein, or dayhoff/hp
// class bytes) as it is, with the same murmur; a window is valid when none
// of its bytes is 0, the record separator and row padding.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include "sketch_common.cuh"

namespace {

// Hash of the k-byte amino-acid window at s (shared memory), as it is, and
// its validity (no zero byte: zero separates records and pads rows).
__device__ uint64_t aa_window_hash(const uint8_t* s, int k, uint64_t seed, bool& ok) {
  return murmur_window<true>(s, k, false, seed, ok);
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

// K1's tile: each thread takes kK1Win windows, kTile apart, so window j of
// thread t sits in lane t % 32 of warp (t / 32) % 4 of segment 2j + t / 128
// of the block's 1024 windows, and a segment's ranks follow window order.
constexpr int kK1Win = 4;
constexpr int kK1Tile = kK1Win * kTile;

// Staged positions of a K1 tile: its windows and the k-1 halo, in whole
// 32-position plane words.
__host__ __device__ constexpr int k1_staged(int k) {
  return (kK1Tile + k - 1 + 31) / 32 * 32;
}

// K1's dynamic shared memory: the staged bytes L, their reverse complement
// (L more, then 16 bytes of reach for the last word's aligned loads) and
// five planes of L / 32 + 1 words (one spare each).
__host__ __device__ constexpr int k1_smem_bytes(int k) {
  return 2 * k1_staged(k) + 16 + 5 * 4 * (k1_staged(k) / 32 + 1);
}

// K1. Replaces sourmash_tpu/ops/pallas_sketch.py:sketch_survivor_slots_pallas
// (kernel _sketch_slots_kernel over _hash_streams).
//
// Bound: integer issue. Murmur is ~100 instructions a window and the
// output a few bytes per 128 windows; what held the one-window-per-thread
// form at ~30 % of the issue rate was latency: a dependent, strand-selected
// shared load per canonical byte and an early-exit strand loop.
//
// Design. K1's output depends on valid windows only. Staging reads the
// tile's L bytes once and writes them, their reverse complement (rc[L-1-i]
// = complement(fwd[i])) and, per 32 positions, five ballot planes: not-ACGT,
// the two bits of the base code (A<C<G<T as 0<1<2<3, the bytes' order) and
// those two bits of the reverse complement (~brev of the forward words).
// A window's validity is a funnel shift of the not-ACGT plane; its strand is
// the lowest base where its forward codes and its reverse complement's
// codes (read forward from the rc planes) differ, 32 bases a step, the
// forward strand for a palindrome. Its canonical bytes are then a run of
// either the forward or the rc bytes, so each murmur word is two funnel
// shifts of aligned 32-bit shared loads, with no per-byte select and no
// byte reversal. Each thread hashes kK1Win independent windows whose murmur
// chains interleave, and a block stages 1024 windows, so the k-1 halo and
// the staging are paid once per 1024 windows; one barrier after staging
// and one for the compaction of the block's eight segments. k is a
// template constant for sourmash's usual 21, 31 and 51, where murmur's
// block and tail structure and the word offsets fold away; kK = 0 reads k
// from its argument, for every other k.
template <int kK>
__global__ void __launch_bounds__(kTile)
survivor_slots_kernel(const uint8_t* __restrict__ seq, int S, int n, int R, int k_arg,
                      uint64_t seed, uint64_t max_hash, int slots,
                      uint32_t* __restrict__ slots_hi, uint32_t* __restrict__ slots_lo,
                      int32_t* __restrict__ counts) {
  // a name of its own keeps this alignment off the `smem` of K2 and K3
  extern __shared__ __align__(16) uint8_t k1_smem[];
  __shared__ int warp_count[kK1Win][kTile / 32];
  const int k = kK > 0 ? kK : k_arg;
  const int L = k1_staged(k);
  const int words = L / 32;
  uint8_t* rc = k1_smem + L;
  uint32_t* bad = reinterpret_cast<uint32_t*>(k1_smem + 2 * L + 16);
  uint32_t* f1 = bad + words + 1;
  uint32_t* f0 = f1 + words + 1;
  uint32_t* r1 = f0 + words + 1;
  uint32_t* r0 = r1 + words + 1;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kK1Tile;
  const uint8_t* row = seq + static_cast<int64_t>(b) * S;
  // L and kTile are multiples of 32, so every lane of a warp takes part in
  // each ballot; the warp's 32 positions are one word of every plane
  for (int i = t; i < L; i += kTile) {
    const int64_t p = w0 + i;
    const uint32_t c = p < S ? row[p] : 0u;  // past the row: 0, never valid
    k1_smem[i] = static_cast<uint8_t>(c);
    rc[L - 1 - i] = static_cast<uint8_t>(complement(c));
    const uint32_t code = base_code(c);
    const unsigned nb = __ballot_sync(0xffffffffu, !is_acgt(c));
    const unsigned c1 = __ballot_sync(0xffffffffu, (code & 2u) != 0);
    const unsigned c0 = __ballot_sync(0xffffffffu, (code & 1u) != 0);
    if ((t & 31) == 0) {
      const int m = i >> 5;
      bad[m] = nb;
      f1[m] = c1;
      f0[m] = c0;
      r1[words - 1 - m] = ~__brev(c1);
      r0[words - 1 - m] = ~__brev(c0);
    }
  }
  if (t == 0) bad[words] = f1[words] = f0[words] = r1[words] = r0[words] = 0;
  __syncthreads();

  const uint32_t* smem32 = reinterpret_cast<const uint32_t*>(k1_smem);
  bool keep[kK1Win];
  uint64_t hash[kK1Win];
#pragma unroll
  for (int j = 0; j < kK1Win; ++j) {
    const int s = j * kTile + t;  // the window's position in the tile
    bool ok = true, rev = false, decided = false;
#pragma unroll
    for (int c = 0; c < k; c += 32) {
      const uint32_t m = low_mask(k - c);
      ok = ok && (plane_bits(bad, s + c) & m) == 0;
      // forward bases c.. against reverse-complement bases c.., which
      // start at rc position L - s - k
      const uint32_t a1 = plane_bits(f1, s + c) & m, a0 = plane_bits(f0, s + c) & m;
      const int q = L - s - k + c;
      const uint32_t b1 = plane_bits(r1, q) & m, b0 = plane_bits(r0, q) & m;
      const uint32_t diff = (a1 ^ b1) | (a0 ^ b0);
      const uint32_t greater = (a1 & ~b1) | (~(a1 ^ b1) & a0 & ~b0);
      rev = decided ? rev : (greater & diff & (0u - diff)) != 0;
      decided = decided || diff != 0;
    }
    // the canonical window: bytes s.. of the tile, or rc bytes L - s - k..
    const int off = rev ? 2 * L - s - k : s;
    const uint32_t* at = smem32 + (off >> 2);
    const int sh = 8 * (off & 3);
    const uint64_t h = murmur_words(k, seed, [&](int start, int len) {
      const uint32_t* p = at + (start >> 2);
      const uint64_t x = static_cast<uint64_t>(__funnelshift_r(p[1], p[2], sh)) << 32 |
                         __funnelshift_r(p[0], p[1], sh);
      return len >= 8 ? x : x & ((1ULL << (8 * len)) - 1);
    });
    keep[j] = ok && w0 + s < n && h <= max_hash;
    hash[j] = h;
  }
  write_segment_slots<kK1Win>(keep, hash, warp_count, b, R, slots, slots_hi, slots_lo,
                              counts);
}

template <int kK>
cudaError_t launch_survivor_slots(const void* seq, int B, int S, int n, int R, int ksize,
                                  uint64_t seed, uint64_t max_hash, int slots,
                                  void* slots_hi, void* slots_lo, void* counts,
                                  cudaStream_t stream) {
  const size_t smem = k1_smem_bytes(ksize);
  cudaError_t err = opt_in_smem(survivor_slots_kernel<kK>, smem);
  if (err != cudaSuccess) return err;
  constexpr int segs_per_block = kK1Tile / kSeg;
  dim3 grid((R + segs_per_block - 1) / segs_per_block, B);
  survivor_slots_kernel<kK><<<grid, kTile, smem, stream>>>(
      static_cast<const uint8_t*>(seq), S, n, R, ksize, seed, max_hash, slots,
      static_cast<uint32_t*>(slots_hi), static_cast<uint32_t*>(slots_lo),
      static_cast<int32_t*>(counts));
  return cudaGetLastError();
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ksize) {
    case 21:
      err = launch_survivor_slots<21>(seq, B, S, n, R, ksize, seed, max_hash, slots,
                                      slots_hi, slots_lo, counts, s);
      break;
    case 31:
      err = launch_survivor_slots<31>(seq, B, S, n, R, ksize, seed, max_hash, slots,
                                      slots_hi, slots_lo, counts, s);
      break;
    case 51:
      err = launch_survivor_slots<51>(seq, B, S, n, R, ksize, seed, max_hash, slots,
                                      slots_hi, slots_lo, counts, s);
      break;
    default:
      err = launch_survivor_slots<0>(seq, B, S, n, R, ksize, seed, max_hash, slots,
                                     slots_hi, slots_lo, counts, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
