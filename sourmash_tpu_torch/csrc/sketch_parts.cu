// Hand-written Hopper (sm_90a) kernels of the sketch-kernel instruments:
// K1 (sketch.cu survivor_slots_kernel) taken apart, to find where its time
// goes. Each replaces one Pallas experiment under tools/ and is driven by
// the tool of the same name under sourmash_tpu_torch/tools/.
//
// T2 split_words + split_slots: K1 cut at the word boundary.
// T3 survivor_slots_v2: K1 with a small live set, value-equal to K1.
// T4 murmur_only, assembly_only, mulchain: microkernels over the tool's
//    block layout, [nblk * (rows + 8), 128] int32 values in, [nblk * rows,
//    128] u32 out, element (r, lane) of block b computed from the block's
//    values at r * 128 + lane onwards.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include "sketch_common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kExtraRows = 8;  // T4 blocks: rows + 8 lookahead rows of 128 values
// T4's k and seed, the JAX tool's KSIZE and SEED. The kernels take k as an
// argument, not a template constant, so murmur and the canonical gather
// compile as they do in K1, whose k is a runtime value.
constexpr int kT4K = 31;
constexpr uint64_t kT4Seed = 42;

// Word `start / 8` of the canonical window at s: its len = min(8, k -
// start) canonical bytes, or 0 past the window.
__device__ __forceinline__ uint64_t canonical_word(const uint8_t* s, int k, bool rev,
                                                   int start, bool& ok) {
  if (start >= k) return 0;
  return window_word(s, k, rev, start, min(8, k - start), ok);
}

// T2 pass A. Replaces tools/exp_split_kernel.py:split_sketch's first call
// (kernel _assembly_kernel): every window's canonical bytes as nw
// little-endian 64-bit words (zero past k) and its validity.
//
// Bound: bytes. A window writes 8 * nw + 1 bytes (33 at k = 31) and its
// canonical gather costs ~10 integer ops per byte. Design: K2's, one
// thread per window over the tile's bytes plus the k-1 halo in shared
// memory; the words go out as 16-byte stores (nw is even).
__global__ void __launch_bounds__(kTile)
split_words_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k, int nw,
                   ulonglong2* __restrict__ words, uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_row(seq + static_cast<int64_t>(b) * S, S, w0, kTile + k - 1, smem);
  __syncthreads();

  const int64_t w = w0 + threadIdx.x;
  if (w >= n_pad) return;
  const uint8_t* s = smem + threadIdx.x;
  const bool rev = reverse_is_less(s, k);
  bool ok = true;
  const int64_t out = static_cast<int64_t>(b) * n_pad + w;
  ulonglong2* dst = words + out * (nw / 2);
  for (int i = 0; i < nw; i += 2) {
    ulonglong2 pair;
    pair.x = canonical_word(s, k, rev, 8 * i, ok);
    pair.y = canonical_word(s, k, rev, 8 * i + 8, ok);
    dst[i / 2] = pair;
  }
  valid[out] = ok ? 1 : 0;
}

// T2 pass B. Replaces tools/exp_split_kernel.py:split_sketch's second call
// (kernel _murmur_slots_kernel): murmur of pass A's words, the threshold
// and K1's per-segment compaction.
//
// Bound: integer ALU (murmur, ~130 ops a window) against 8 * nw + 1 bytes
// read. Design: one thread per window reads its words with 16-byte loads
// as murmur asks for them; an invalid window is not hashed (it can never
// survive), then write_segment_slots as in K1.
__global__ void __launch_bounds__(kTile)
split_slots_kernel(const ulonglong2* __restrict__ words, const uint8_t* __restrict__ valid,
                   int n_pad, int R, int k, int nw, uint64_t seed, uint64_t max_hash,
                   int slots, uint32_t* __restrict__ slots_hi,
                   uint32_t* __restrict__ slots_lo, int32_t* __restrict__ counts) {
  __shared__ int warp_count[1][kTile / 32];
  const int b = blockIdx.y;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  bool keep = false;
  uint64_t h = 0;
  if (w < n_pad) {
    const int64_t at = static_cast<int64_t>(b) * n_pad + w;
    const ulonglong2* src = words + at * (nw / 2);
    if (valid[at]) {
      h = murmur_words(k, seed, [&](int start, int) {
        const ulonglong2 pair = src[start >> 4];
        return static_cast<uint64_t>((start & 8) ? pair.y : pair.x);
      });
      keep = h <= max_hash;
    }
  }
  const bool keeps[1] = {keep};
  const uint64_t hs[1] = {h};
  write_segment_slots<1>(keeps, hs, warp_count, b, R, slots, slots_hi, slots_lo, counts);
}

// -- T3 helpers (its bit-plane helpers are in sketch_common.cuh) ---------------

// Eight bytes of shared memory from any byte offset, little-endian, from
// three aligned 32-bit loads.
__device__ __forceinline__ uint64_t load8(const uint8_t* smem, int pos) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(smem) + (pos >> 2);
  const int sh = 8 * (pos & 3);
  const uint32_t lo = __funnelshift_r(w[0], w[1], sh);
  const uint32_t hi = __funnelshift_r(w[1], w[2], sh);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return static_cast<uint64_t>(__byte_perm(static_cast<uint32_t>(x), 0, 0x0123)) << 32 |
         __byte_perm(static_cast<uint32_t>(x >> 32), 0, 0x0123);
}

// The complement of eight bytes at once (complement(), byte by byte).
__device__ __forceinline__ uint64_t complement8(uint64_t x) {
  const uint64_t bit1 = (x >> 1) & 0x0101010101010101ULL;
  return x ^ (0x1515151515151515ULL ^ (bit1 * 0x11));
}

// T3. Replaces tools/exp_v2_kernel.py:v2_sketch (kernel _slots_kernel_v2
// over _hash_streams_v2): K1's output, value-equal.
//
// Bound: integer ALU, as K1. Design: K1's output depends on valid windows
// only, so the strand and the validity come first from bit planes, and the
// per-byte canonical gather goes. Staging writes the tile's bytes and, per
// 32 positions, three ballots: not-ACGT, and the two bits of the base code
// (A<C<G<T as 0<1<2<3, the bytes' order). A window's forward codes are a
// funnel shift of the planes, its reverse complement's a bit reversal of
// them, inverted; the lowest differing base decides the strand, 32 bases
// per step. Each murmur word is then read as eight bytes of the chosen
// strand (three 32-bit shared loads; byte-reversed and complemented eight
// at a time on the reverse strand) just before the round that uses it.
__global__ void __launch_bounds__(kTile)
survivor_slots_v2_kernel(const uint8_t* __restrict__ seq, int S, int n, int R, int k,
                         int staged, uint64_t seed, uint64_t max_hash, int slots,
                         uint32_t* __restrict__ slots_hi, uint32_t* __restrict__ slots_lo,
                         int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_count[1][kTile / 32];
  const int plane_words = staged / 32 + 1;
  uint32_t* bad = reinterpret_cast<uint32_t*>(smem + staged);
  uint32_t* code1 = bad + plane_words;
  uint32_t* code0 = code1 + plane_words;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const uint8_t* row = seq + static_cast<int64_t>(b) * S;
  // staged and kTile are multiples of 32, so every lane of a warp takes
  // part in each ballot
  for (int i = t; i < staged; i += kTile) {
    const int64_t p = w0 + i;
    const uint32_t c = p < S ? row[p] : 0;
    smem[i] = static_cast<uint8_t>(c);
    const uint32_t code = base_code(c);
    const unsigned nb = __ballot_sync(0xffffffffu, !is_acgt(c));
    const unsigned c1 = __ballot_sync(0xffffffffu, (code & 2u) != 0);
    const unsigned c0 = __ballot_sync(0xffffffffu, (code & 1u) != 0);
    if ((t & 31) == 0) {
      bad[i >> 5] = nb;
      code1[i >> 5] = c1;
      code0[i >> 5] = c0;
    }
  }
  if (t == 0) bad[plane_words - 1] = code1[plane_words - 1] = code0[plane_words - 1] = 0;
  __syncthreads();

  const int64_t w = w0 + t;
  bool keep = false;
  uint64_t h = 0;
  if (w < n) {
    bool ok = true, rev = false, decided = false;
    for (int c = 0; c < k; c += 32) {
      const int len = min(32, k - c);
      const uint32_t m = low_mask(len);
      ok = ok && (plane_bits(bad, t + c) & m) == 0;
      if (!decided) {
        // forward bases c.., and reverse-complement bases c.. (positions
        // q + len - 1 down to q)
        const uint32_t f1 = plane_bits(code1, t + c) & m;
        const uint32_t f0 = plane_bits(code0, t + c) & m;
        const int q = t + k - c - len;
        const uint32_t r1 = ~(__brev(plane_bits(code1, q)) >> (32 - len)) & m;
        const uint32_t r0 = ~(__brev(plane_bits(code0, q)) >> (32 - len)) & m;
        const uint32_t diff = (f1 ^ r1) | (f0 ^ r0);
        if (diff) {
          const uint32_t f_greater = (f1 & ~r1) | (~(f1 ^ r1) & f0 & ~r0);
          rev = (f_greater & diff & (0u - diff)) != 0;
          decided = true;
        }
      }
    }
    if (ok) {
      h = murmur_words(k, seed, [&](int start, int len) {
        const int pos = rev ? t + k - start - len : t + start;
        const uint64_t x = load8(smem, pos);
        const uint64_t r = complement8(bswap64(x) >> (64 - 8 * len));
        const uint64_t m = len >= 8 ? ~0ULL : (1ULL << (8 * len)) - 1;
        return (rev ? r : x) & m;
      });
      keep = h <= max_hash;
    }
  }
  const bool keeps[1] = {keep};
  const uint64_t hs[1] = {h};
  write_segment_slots<1>(keeps, hs, warp_count, b, R, slots, slots_hi, slots_lo, counts);
}

// -- T4: microkernels over the tool's block layout -----------------------------

// T4 grids are (tiles of a block's rows * 128 windows, blocks): window w of
// block blk reads the block's values from blk * (rows + 8) * 128 + w on and
// writes output element blk * rows * 128 + w.

// T4 murmur-only. Replaces tools/profile_sketch_parts.py:_murmur_only_kernel:
// murmur of k bytes given as fake words (x ^ 2i) << 32 | (x ^ (2i + 1)),
// then hi ^ lo. Bound: integer ALU (murmur alone). Design: one thread per
// element; the words are made as murmur asks for them.
__global__ void __launch_bounds__(kTile)
murmur_only_kernel(const int32_t* __restrict__ blocks, int rows, int k, uint64_t seed,
                   uint32_t* __restrict__ out) {
  const int per = rows * kLanes;
  const int w = blockIdx.x * kTile + threadIdx.x;
  if (w >= per) return;
  const int64_t blk = blockIdx.y;
  const uint32_t x = static_cast<uint32_t>(blocks[blk * (per + kExtraRows * kLanes) + w]);
  const uint64_t h = murmur_words(k, seed, [&](int start, int) {
    const uint32_t j = 2u * static_cast<uint32_t>(start >> 3);
    return static_cast<uint64_t>(x ^ j) << 32 | (x ^ (j + 1u));
  });
  out[blk * per + w] = static_cast<uint32_t>(h >> 32) ^ static_cast<uint32_t>(h);
}

// T4 assembly-only. Replaces tools/profile_sketch_parts.py:
// _assembly_only_kernel: the XOR of the canonical window's 32-bit limbs,
// xor its validity, for the window at each element (the low byte of each
// value is the base). Bound: integer ALU (the canonical gather alone).
// Design: K2's, over the block's values staged as bytes in shared memory.
__global__ void __launch_bounds__(kTile)
assembly_only_kernel(const int32_t* __restrict__ blocks, int rows, int k,
                     uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per = rows * kLanes;
  const int values = (rows + kExtraRows) * kLanes;
  const int64_t blk = blockIdx.y;
  const int w0 = blockIdx.x * kTile;
  const int32_t* src = blocks + blk * values;
  for (int i = threadIdx.x; i < kTile + k - 1; i += kTile) {
    const int p = w0 + i;
    smem[i] = p < values ? static_cast<uint8_t>(src[p]) : 0;
  }
  __syncthreads();

  const int w = w0 + threadIdx.x;
  if (w >= per) return;
  const uint8_t* s = smem + threadIdx.x;
  const bool rev = reverse_is_less(s, k);
  bool ok = true;
  uint64_t x = 0;
  for (int start = 0; start < k; start += 8) x ^= canonical_word(s, k, rev, start, ok);
  out[blk * per + w] = static_cast<uint32_t>(x >> 32) ^ static_cast<uint32_t>(x) ^ (ok ? 1u : 0u);
}

// T4 mul-chain. Replaces tools/profile_sketch_parts.py:_mulchain_kernel:
// n_rounds of v *= C1, v = rotl(v, 31), v ^= v with its halves swapped,
// from v = x << 32 | (x ^ 1); then hi ^ lo. After one round the halves are
// equal, so the output is 0 for every n_rounds >= 1 (1 for none), as the
// JAX function's is. Bound: integer ALU, by construction: the chain
// measures the card's 64-bit multiply-rotate rate. Design: the empty asm on
// the high half hides that the result is 0, so the compiler must keep the
// chain.
__global__ void __launch_bounds__(kTile)
mulchain_kernel(const int32_t* __restrict__ blocks, int rows, int n_rounds,
                uint32_t* __restrict__ out) {
  const int per = rows * kLanes;
  const int w = blockIdx.x * kTile + threadIdx.x;
  if (w >= per) return;
  const int64_t blk = blockIdx.y;
  const uint32_t x = static_cast<uint32_t>(blocks[blk * (per + kExtraRows * kLanes) + w]);
  uint64_t v = static_cast<uint64_t>(x) << 32 | (x ^ 1u);
#pragma unroll 8
  for (int r = 0; r < n_rounds; ++r) {
    v *= kC1;
    v = rotl64(v, 31);
    v ^= rotl64(v, 32);
  }
  uint32_t hi = static_cast<uint32_t>(v >> 32);
  asm volatile("" : "+r"(hi));
  out[blk * per + w] = hi ^ static_cast<uint32_t>(v);
}

inline dim3 grid_t4(int nblk, int rows) {
  return dim3((rows * kLanes + kTile - 1) / kTile, nblk);
}

}  // namespace

extern "C" {

const char* sp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// words [B, n_pad, nw] u64 (nw even), valid [B, n_pad] u8 for rows seq [B, S] u8.
int sp_split_words(const void* seq, int B, int S, int n_pad, int ksize, int nw,
                   void* words, void* valid, void* stream) {
  if (nw < 2 || nw % 2 || 8 * nw < ksize) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare_smem(split_words_kernel, ksize, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_pad + kTile - 1) / kTile, B);
  split_words_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), S, n_pad, ksize, nw,
      static_cast<ulonglong2*>(words), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// slots_hi, slots_lo [B, R, slots] u32 and counts [B, R] i32 from
// words [B, n_pad = 128 R, nw] u64 and valid [B, n_pad] u8.
int sp_split_slots(const void* words, const void* valid, int B, int n_pad, int R, int ksize,
                   int nw, uint64_t seed, uint64_t max_hash, int slots, void* slots_hi,
                   void* slots_lo, void* counts, void* stream) {
  if (slots < 1 || slots > kSeg || nw < 2 || nw % 2 || 8 * nw < ksize)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_pad + kTile - 1) / kTile, B);
  split_slots_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(words), static_cast<const uint8_t*>(valid), n_pad, R,
      ksize, nw, seed, max_hash, slots, static_cast<uint32_t*>(slots_hi),
      static_cast<uint32_t*>(slots_lo), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// K1's outputs (see sm_survivor_slots) for rows seq [B, S] u8.
int sp_survivor_slots_v2(const void* seq, int B, int S, int n, int R, int ksize,
                         uint64_t seed, uint64_t max_hash, int slots, void* slots_hi,
                         void* slots_lo, void* counts, void* stream) {
  if (slots < 1 || slots > kSeg) return static_cast<int>(cudaErrorInvalidValue);
  // the tile's bytes, the k-1 halo and 12 bytes for load8's reach, in
  // whole 32-byte plane words; then three planes, one spare word each
  const int staged = (kTile + ksize - 1 + 12 + 31) / 32 * 32;
  const size_t smem = staged + 3 * sizeof(uint32_t) * (staged / 32 + 1);
  cudaError_t err = opt_in_smem(survivor_slots_v2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segs_per_block = kTile / kSeg;
  dim3 grid((R + segs_per_block - 1) / segs_per_block, B);
  survivor_slots_v2_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), S, n, R, ksize, staged, seed, max_hash, slots,
      static_cast<uint32_t*>(slots_hi), static_cast<uint32_t*>(slots_lo),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// out [nblk * rows, 128] u32 from blocks [nblk * (rows + 8), 128] i32,
// at k = kT4K (and seed kT4Seed).
int sp_murmur_only(const void* blocks, int nblk, int rows, void* out, void* stream) {
  murmur_only_kernel<<<grid_t4(nblk, rows), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, kT4K, kT4Seed, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int sp_assembly_only(const void* blocks, int nblk, int rows, void* out, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare_smem(assembly_only_kernel, kT4K, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  assembly_only_kernel<<<grid_t4(nblk, rows), kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, kT4K, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int sp_mulchain(const void* blocks, int nblk, int rows, int n_rounds, void* out,
                void* stream) {
  mulchain_kernel<<<grid_t4(nblk, rows), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, n_rounds, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
