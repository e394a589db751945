// Device functions shared by the sketch kernels (sketch.cu: K1, K2, K3) and
// the sketch-kernel instruments (sketch_parts.cu: T2, T3, T4). K1 and K2
// share the DNA tile below, K3 has the amino-acid tile after it.
//
// The hash is the canonical-strand MurmurHash3 x64_128 (first 64-bit word,
// seed given) that sourmash uses for DNA: a k-byte window and its reverse
// complement are compared lexicographically and the lesser is hashed. A
// window is valid when all of its k bytes are A, C, G or T; a zero pad byte
// is never valid. Amino-acid windows hash their bytes as they are with the
// same murmur, and are valid when none of their bytes is 0.
//
// The complement is the branchless ASCII map of the TPU kernel
// (`sourmash_tpu/ops/pallas_sketch.py:_complement_bytes`): c ^ 4 when bit 1
// of c is set, else c ^ 21. It swaps A<->T and C<->G and maps every other
// byte to a non-ACGT byte, so invalid windows hash the same garbage as the
// reference kernels and the outputs compare bit for bit everywhere.
//
// The build key of every library that includes this header covers it
// (ops/_build.py), so an edit here rebuilds both.

#pragma once

#include <cstdint>
#include <type_traits>

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

// MurmurHash3 x64_128, first 64-bit word, of k input bytes handed over as
// little-endian words: word(start, len) is the word of bytes [start,
// start + len) (start a multiple of 8, len 1..8). Each word is asked for
// once, just before the round that uses it.
template <typename Word>
__device__ __forceinline__ uint64_t murmur_words(int k, uint64_t seed, Word word) {
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = word(16 * b, 8);
    uint64_t k2 = word(16 * b + 8, 8);
    k1 *= kC1; k1 = rotl64(k1, 31); k1 *= kC2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= kC2; k2 = rotl64(k2, 33); k2 *= kC1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const int tail = k & 15;
  const int base = 16 * nblocks;
  if (tail > 8) {
    uint64_t k2 = word(base + 8, tail - 8);
    k2 *= kC2; k2 = rotl64(k2, 33); k2 *= kC1; h2 ^= k2;
  }
  if (tail > 0) {
    uint64_t k1 = word(base, tail < 8 ? tail : 8);
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

// The strand of the k-byte DNA window at s: true when its reverse
// complement is the lesser. The first byte where the two differ decides; a
// palindrome takes the forward strand.
__device__ __forceinline__ bool reverse_is_less(const uint8_t* s, int k) {
  for (int j = 0; j < k; ++j) {
    uint32_t f = s[j];
    uint32_t r = complement(s[k - 1 - j]);
    if (f != r) return r < f;
  }
  return false;
}

// K1's per-segment compaction, run by every thread of a kTile block once
// it holds the survivor flags and hashes of its kWin windows, window j at
// position j * kTile + threadIdx.x of a tile of 2 * kWin segments: a rank
// within the 128-window segment from four warps (__ballot_sync of the
// survivors, __popc below the lane, a shared prefix of the four warp
// counts), one barrier for all kWin. A survivor of rank r < slots writes
// slot r; unused slots are written 0 and the segment's TRUE count is
// written even when it exceeds `slots`.
template <int kWin>
__device__ __forceinline__ void write_segment_slots(
    const bool (&keep)[kWin], const uint64_t (&h)[kWin], int (*warp_count)[kTile / 32],
    int b, int R, int slots, uint32_t* __restrict__ slots_hi,
    uint32_t* __restrict__ slots_lo, int32_t* __restrict__ counts) {
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  unsigned ballot[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, keep[j]);
    if (lane == 0) warp_count[j][warp] = __popc(ballot[j]);
  }
  __syncthreads();

  const int seg_in_tile = t / kSeg;
  const int first_warp = seg_in_tile * kWarpsPerSeg;
  const int r = t % kSeg;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    int before = 0, total = 0;
    for (int i = 0; i < kWarpsPerSeg; ++i) {
      const int c = warp_count[j][first_warp + i];
      total += c;
      if (first_warp + i < warp) before += c;
    }
    const int64_t seg = (static_cast<int64_t>(blockIdx.x) * kWin + j) * (kTile / kSeg) +
                        seg_in_tile;
    if (seg >= R) return;  // the later windows' segments lie further on

    const int64_t base = (static_cast<int64_t>(b) * R + seg) * slots;
    const int rank = before + __popc(ballot[j] & ((1u << lane) - 1u));
    if (keep[j] && rank < slots) {
      slots_hi[base + rank] = static_cast<uint32_t>(h[j] >> 32);
      slots_lo[base + rank] = static_cast<uint32_t>(h[j]);
    }
    if (r < slots && r >= total) {
      slots_hi[base + r] = 0;
      slots_lo[base + r] = 0;
    }
    if (r == 0) counts[static_cast<int64_t>(b) * R + seg] = total;
  }
}

// -- bit planes: the DNA strand and validity 32 bases at a time --------------

// 32 bits of a bit plane (bit i = position i of the staged tile) from
// position q on.
__device__ __forceinline__ uint32_t plane_bits(const uint32_t* plane, int q) {
  return __funnelshift_r(plane[q >> 5], plane[(q >> 5) + 1], q & 31);
}

__device__ __forceinline__ uint32_t low_mask(int len) {
  return len >= 32 ? ~0u : (1u << len) - 1u;
}

// 2-bit base code in the bytes' order: A 0 < C 1 < G 2 < T 3 (anything for
// other bytes). The complement's code is 3 - code.
__device__ __forceinline__ uint32_t base_code(uint32_t c) {
  return ((c >> 1) & 3u) ^ ((c >> 2) & 1u);
}

// -- the DNA tile of K1 and K2 ------------------------------------------------
//
// A block of kTile threads stages kDnaTile windows of one row once: the
// tile's L bytes (its windows and the k-1 halo, in whole 32-position plane
// words), their reverse complement (rc[L-1-i] = complement(fwd[i])) and,
// per 32 positions, five ballot planes: not-ACGT, the two bits of the base
// code (A<C<G<T as 0<1<2<3, the bytes' order) and those two bits of the
// reverse complement (~brev of the forward words). Each thread takes
// kDnaWin windows, kTile apart: window j of thread t is tile position
// j * kTile + t, so each set of kTile windows is laid out as one window a
// thread, and each of the thread's stores coalesces across its warp.

constexpr int kDnaWin = 4;
constexpr int kDnaTile = kDnaWin * kTile;

// Staged positions of a tile: its windows and the k-1 halo, in whole
// 32-position plane words.
__host__ __device__ constexpr int dna_staged(int k) {
  return (kDnaTile + k - 1 + 31) / 32 * 32;
}

// A tile's dynamic shared memory: the staged bytes L, their reverse
// complement (L more, then 16 bytes of reach for the last word's aligned
// loads) and five planes of L / 32 + 1 words (one spare each).
__host__ __device__ constexpr int dna_smem_bytes(int k) {
  return 2 * dna_staged(k) + 16 + 5 * 4 * (dna_staged(k) / 32 + 1);
}

struct DnaTile {
  const uint8_t* bytes;  // L forward bytes, then the L reverse-complement bytes
  const uint32_t* bad;   // not ACGT
  const uint32_t* f1;    // base code bits, forward
  const uint32_t* f0;
  const uint32_t* r1;    // base code bits, reverse complement
  const uint32_t* r0;
  int L;
};

// Stage the tile of positions [w0, w0 + L) of one row into `smem`
// (dna_smem_bytes(k), 16-byte aligned); bytes past the row read 0, never
// valid. Every thread of the kTile block calls it; the caller synchronises.
__device__ __forceinline__ DnaTile stage_dna_tile(const uint8_t* row, int S, int64_t w0,
                                                 int k, uint8_t* smem) {
  const int L = dna_staged(k);
  const int words = L / 32;
  uint8_t* rc = smem + L;
  uint32_t* bad = reinterpret_cast<uint32_t*>(smem + 2 * L + 16);
  uint32_t* f1 = bad + words + 1;
  uint32_t* f0 = f1 + words + 1;
  uint32_t* r1 = f0 + words + 1;
  uint32_t* r0 = r1 + words + 1;
  const int t = threadIdx.x;
  // L and kTile are multiples of 32, so every lane of a warp takes part in
  // each ballot; the warp's 32 positions are one word of every plane
  for (int i = t; i < L; i += kTile) {
    const int64_t p = w0 + i;
    const uint32_t c = p < S ? row[p] : 0u;
    smem[i] = static_cast<uint8_t>(c);
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
  return DnaTile{smem, bad, f1, f0, r1, r0, L};
}

// Validity of the k-window at tile position s (a funnel shift of the
// not-ACGT plane) and, for a valid window, its strand from the code
// planes: the lowest base where its forward codes and its reverse
// complement's codes (read forward from the rc planes, at L - s - k)
// differ, 32 bases a step; the forward strand for a palindrome. `rev` is
// meaningless for an invalid window: codes cannot order other bytes.
__device__ __forceinline__ void plane_strand(const DnaTile& tile, int s, int k, bool& ok,
                                             bool& rev) {
  ok = true;
  rev = false;
  bool decided = false;
#pragma unroll
  for (int c = 0; c < k; c += 32) {
    const uint32_t m = low_mask(k - c);
    ok = ok && (plane_bits(tile.bad, s + c) & m) == 0;
    const uint32_t a1 = plane_bits(tile.f1, s + c) & m, a0 = plane_bits(tile.f0, s + c) & m;
    const int q = tile.L - s - k + c;
    const uint32_t b1 = plane_bits(tile.r1, q) & m, b0 = plane_bits(tile.r0, q) & m;
    const uint32_t diff = (a1 ^ b1) | (a0 ^ b0);
    const uint32_t greater = (a1 & ~b1) | (~(a1 ^ b1) & a0 & ~b0);
    rev = decided ? rev : (greater & diff & (0u - diff)) != 0;
    decided = decided || diff != 0;
  }
}

// Murmur of the k staged bytes that start sh / 8 bytes into the aligned
// word at `at` (sh in {0, 8, 16, 24}): each murmur word is two funnel
// shifts of aligned 32-bit shared loads, with no per-byte loop. The loads
// reach up to 11 bytes past the k bytes; what they read there is masked
// off.
__device__ __forceinline__ uint64_t funnel_murmur(const uint32_t* at, int sh, int k,
                                                  uint64_t seed) {
  return murmur_words(k, seed, [&](int start, int len) {
    const uint32_t* p = at + (start >> 2);
    const uint64_t x = static_cast<uint64_t>(__funnelshift_r(p[1], p[2], sh)) << 32 |
                       __funnelshift_r(p[0], p[1], sh);
    return len >= 8 ? x : x & ((1ULL << (8 * len)) - 1);
  });
}

// Murmur of the canonical k-window at tile position s: bytes s.. of the
// tile, or rc bytes L - s - k.. when `rev`. rc holds complement() of every
// byte, 0 and other bytes included, so this is the reference's garbage
// hash for an invalid window too.
__device__ __forceinline__ uint64_t tile_murmur(const DnaTile& tile, int s, int k, bool rev,
                                                uint64_t seed) {
  const int off = rev ? 2 * tile.L - s - k : s;
  return funnel_murmur(reinterpret_cast<const uint32_t*>(tile.bytes) + (off >> 2),
                       8 * (off & 3), k, seed);
}

// -- the amino-acid tile of K3 -------------------------------------------------
//
// A block of kTile threads stages kAaTile windows of one row once: the
// tile's L bytes as they are (its windows and the k-1 halo, in whole
// 32-position plane words), 16 zeroed bytes of reach for the last words'
// aligned loads, and one ballot plane marking the zero bytes. There is no
// strand and no code plane. Each thread takes kAaWin consecutive windows,
// s = kAaWin * threadIdx.x onwards: they share one read of the zero plane
// and their aligned word loads (window s + j is the same words funnel-
// shifted by 8 * j), and the thread writes their hashes as two 16-byte
// stores and their validity as one 4-byte store.

constexpr int kAaWin = 4;
constexpr int kAaTile = kAaWin * kTile;

__host__ __device__ constexpr int aa_staged(int k) {
  return (kAaTile + k - 1 + 31) / 32 * 32;
}

// A tile's dynamic shared memory: the L staged bytes, 16 bytes of reach
// and the zero plane of L / 32 + 1 words (one spare).
__host__ __device__ constexpr int aa_smem_bytes(int k) {
  return aa_staged(k) + 16 + 4 * (aa_staged(k) / 32 + 1);
}

struct AaTile {
  const uint8_t* bytes;  // L bytes, then the 16 zero bytes of reach
  const uint32_t* zero;  // bit i of word m: staged byte 32m + i is 0
};

// Stage the tile of positions [w0, w0 + L) of one row into `smem`
// (aa_smem_bytes(k), 16-byte aligned); bytes past the row read 0. Every
// thread of the kTile block calls it; the caller synchronises.
__device__ __forceinline__ AaTile stage_aa_tile(const uint8_t* row, int S, int w0, int k,
                                               uint8_t* smem) {
  const int L = aa_staged(k);
  uint32_t* zero = reinterpret_cast<uint32_t*>(smem + L + 16);
  const uint8_t* src = row + w0;
  const int in_row = S - w0;  // staged positions below this lie in the row
  const int t = threadIdx.x;
  // L and kTile are multiples of 32, so every lane of a warp takes part in
  // each ballot; the warp's 32 positions are one word of the plane. Whole
  // rounds of kTile positions, then the part round (warp-uniform).
  auto stage = [&](int i) {
    const uint32_t c = i < in_row ? src[i] : 0u;
    smem[i] = static_cast<uint8_t>(c);
    const unsigned z = __ballot_sync(0xffffffffu, c == 0u);
    if ((t & 31) == 0) zero[i >> 5] = z;
  };
#pragma unroll
  for (int r = 0; r < L / kTile; ++r) stage(r * kTile + t);
  if (t < L % kTile) stage(L / kTile * kTile + t);
  if (t < 4) reinterpret_cast<uint32_t*>(smem + L)[t] = 0u;
  if (t == 4) zero[L / 32] = 0u;
  return AaTile{smem, zero};
}

// Validity of the kAaWin windows at tile positions s.. (s a multiple of
// kAaWin) as one little-endian word, byte j 1 when window s + j holds no
// zero byte: funnel shifts of the zero plane, 32 positions a step. The
// windows share each step's two plane words ((s & 31) + j stays below 32).
__device__ __forceinline__ uint32_t aa_valid_word(const AaTile& tile, int s, int k) {
  bool ok[kAaWin];
#pragma unroll
  for (int j = 0; j < kAaWin; ++j) ok[j] = true;
#pragma unroll
  for (int c = 0; c < k; c += 32) {
    const int q = s + c;
    const uint32_t lo = tile.zero[q >> 5], hi = tile.zero[(q >> 5) + 1];
    const uint32_t m = low_mask(k - c);
#pragma unroll
    for (int j = 0; j < kAaWin; ++j)
      ok[j] = ok[j] && (__funnelshift_r(lo, hi, (q & 31) + j) & m) == 0;
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < kAaWin; ++j) v |= static_cast<uint32_t>(ok[j]) << (8 * j);
  return v;
}

// f(std::integral_constant<int, K>) with K = k for sourmash's usual 21, 31
// and 51, else K = 0 (the kernel reads k at run time): the DNA
// kernels' instantiations (K1, K2, T2 pass A).
template <typename F>
cudaError_t with_template_k(int k, F f) {
  switch (k) {
    case 21: return f(std::integral_constant<int, 21>{});
    case 31: return f(std::integral_constant<int, 31>{});
    case 51: return f(std::integral_constant<int, 51>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory where that exceeds
// the 48 KB default (less the kernels' small static arrays); beyond the
// card's per-block maximum the launch is refused and the error returned.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes + 1024 <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
