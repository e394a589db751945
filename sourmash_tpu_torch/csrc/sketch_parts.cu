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
// The integer-pipe probe (int_probe_kernel): chains of one kind of integer
//    instruction over mulchain's layout, the card's IMAD.WIDE.U32, IMAD and
//    ALU rates, which set the "operations" bounds (chip_smoke.py). It
//    replaces no TPU kernel: it answers the JAX tool's question (what is
//    the integer roofline?) on this card.
//
// T2 pass A and T4 assembly-only stage K2's DNA tile (sketch_common.cuh)
// and take each window's canonical words as eight-byte loads of the
// forward or the reverse-complement run; a window holding a byte other
// than ACGT takes its strand from strand8, eight bytes at a time. T3
// stages the same tile and hashes as K1 does, one window at a time.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include "sketch_common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kExtraRows = 8;  // T4 blocks: rows + 8 lookahead rows of 128 values
// T4's k and seed, the JAX tool's KSIZE and SEED. murmur_only is launched
// at this k as a template constant, so its murmur folds the block loop and
// the tail branches as K1's k = 31 body does; assembly_only stages its
// tile at this k.
constexpr int kT4K = 31;
constexpr uint64_t kT4Seed = 42;

// -- eight bytes at a time over a staged tile ---------------------------------

// Eight bytes of shared memory from any byte offset, little-endian, from
// three aligned 32-bit loads and two funnel shifts.
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

// The low `len` (1..8) bytes of x.
__device__ __forceinline__ uint64_t low_bytes(uint64_t x, int len) {
  return len >= 8 ? x : x & ((1ULL << (8 * len)) - 1);
}

// The strand of the k-window at tile position s, for any bytes: true when
// its reverse complement is the lesser. `bytes` holds the tile's L forward
// bytes, then their reverse complement (rc[L-1-i] = complement(fwd[i]))
// and 16 bytes of reach, so the window's reverse complement is the run at
// 2L - s - k. Eight bytes of each run a step, masked to the window: the
// first step where they differ decides, by their lowest differing byte,
// which is the highest byte where the byte-swapped words differ. A
// palindrome takes the forward strand. Equal to reverse_is_less.
__device__ __forceinline__ bool strand8(const uint8_t* bytes, int L, int s, int k) {
  const int r = 2 * L - s - k;
#pragma unroll
  for (int c = 0; c < k; c += 8) {
    const uint64_t x = low_bytes(load8(bytes, s + c), k - c);
    const uint64_t y = low_bytes(load8(bytes, r + c), k - c);
    if (x != y) return bswap64(y) < bswap64(x);
  }
  return false;
}

// Word c (bytes 8c..8c+7, zero past k) of the k-window whose run starts at
// byte `off` of the staged tile: the forward run at s, or the rc run at
// 2L - s - k. The loads reach up to 11 bytes past the window; what they
// read there is masked off.
__device__ __forceinline__ uint64_t run_word(const uint8_t* bytes, int off, int k, int c) {
  return 8 * c < k ? low_bytes(load8(bytes, off + 8 * c), k - 8 * c) : 0;
}

// -- T2 pass A --------------------------------------------------------------

// Words a window of split_words: ceil(k / 8), rounded up to even.
__host__ __device__ constexpr int split_nw(int k) { return ((k + 7) / 8 + 1) / 2 * 2; }

// split_words' dynamic shared memory: K2's tile, then the words of kTile
// windows (16-byte aligned).
__host__ __device__ constexpr int split_words_at(int k) {
  return (dna_smem_bytes(k) + 15) / 16 * 16;
}
__host__ __device__ constexpr int split_smem_bytes(int k) {
  return split_words_at(k) + kTile * 8 * split_nw(k);
}

// T2 pass A. Replaces tools/exp_split_kernel.py:split_sketch's first call
// (kernel _assembly_kernel): every window's canonical bytes as nw
// little-endian 64-bit words (zero past k) and its validity.
//
// Bound: bytes. A window writes 8 * nw + 1 bytes (33 at k = 31) and reads
// about one. Design: K2's DNA tile: a block stages kDnaTile windows of a
// row with their reverse complement and the ballot planes, and each
// thread takes kDnaWin windows kTile apart. Validity is a funnel shift of
// the not-ACGT plane; a valid window takes its strand from the code
// planes, one holding another byte from strand8 (a branch taken only where
// such windows occur: N runs, the zero tail). Its words are eight-byte
// loads of the chosen run, with no per-byte gather. So that every warp
// store covers one contiguous run of the output, each set of kTile windows
// (window j * kTile + t of thread t) puts its words in shared memory, and
// the block copies the set's kTile * nw words out as 16-byte stores,
// neighbouring threads on neighbouring addresses. k is a template constant
// for 21, 31 and 51; kK = 0 reads k from its argument.
template <int kK>
__global__ void __launch_bounds__(kTile)
split_words_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k_arg,
                   ulonglong2* __restrict__ words, uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t dna_smem[];
  const int k = kK > 0 ? kK : k_arg;
  const int pairs = split_nw(k) / 2;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kDnaTile;
  const DnaTile tile = stage_dna_tile(seq + static_cast<int64_t>(b) * S, S, w0, k, dna_smem);
  ulonglong2* staged = reinterpret_cast<ulonglong2*>(dna_smem + split_words_at(k));
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kDnaWin; ++j) {
    const int64_t first = static_cast<int64_t>(b) * n_pad + w0 + j * kTile;
    // n_pad is a multiple of 128: the set is whole, half in or out
    const int64_t left = n_pad - (w0 + j * kTile);
    const int in_set = left < kTile ? static_cast<int>(left) : kTile;
    if (in_set <= 0) break;  // block-uniform: the later sets lie further on
    const int s = j * kTile + t;
    bool ok, rev;
    plane_strand(tile, s, k, ok, rev);
    if (!ok) rev = strand8(tile.bytes, tile.L, s, k);
    const int off = rev ? 2 * tile.L - s - k : s;
    for (int i = 0; i < pairs; ++i)
      staged[t * pairs + i] = make_ulonglong2(run_word(tile.bytes, off, k, 2 * i),
                                              run_word(tile.bytes, off, k, 2 * i + 1));
    if (t < in_set) valid[first + t] = ok ? 1 : 0;
    __syncthreads();
    ulonglong2* dst = words + first * pairs;
    for (int i = t; i < in_set * pairs; i += kTile) dst[i] = staged[i];
    __syncthreads();
  }
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

// -- T3 ----------------------------------------------------------------------

// T3. Replaces tools/exp_v2_kernel.py:v2_sketch (kernel _slots_kernel_v2
// over _hash_streams_v2): K1's output, value-equal.
//
// Bound: integer issue, as K1's (murmur is ~100 instructions a window).
// The JAX experiment's one idea is a small live set: the same math in an
// order that keeps few values live at once. Design: K1's DNA tile
// (sketch_common.cuh), staged once per kDnaTile windows; validity and
// strand from its planes (plane_strand), the murmur words two funnel shifts
// of the forward or the rc run (tile_murmur), K1's segment order and
// compaction (write_segment_slots<kDnaWin>). What keeps it an instrument
// and not a copy of K1: each thread finishes one window before it starts
// the next (the loop is not unrolled), so one murmur state is live at a
// time where K1 interleaves kDnaWin; and only a valid window is hashed (an
// invalid one can never survive), where K1 hashes every window and masks.
// The loop index is not a constant, so a window's survivor flag and hash
// reach the thread's kDnaWin registers by selects. k is a template
// constant for 21, 31 and 51; kK = 0 reads k from its argument.
template <int kK>
__global__ void __launch_bounds__(kTile)
survivor_slots_v2_kernel(const uint8_t* __restrict__ seq, int S, int n, int R, int k_arg,
                         uint64_t seed, uint64_t max_hash, int slots,
                         uint32_t* __restrict__ slots_hi, uint32_t* __restrict__ slots_lo,
                         int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t dna_smem[];
  __shared__ int warp_count[kDnaWin][kTile / 32];
  const int k = kK > 0 ? kK : k_arg;
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kDnaTile;
  const DnaTile tile = stage_dna_tile(seq + static_cast<int64_t>(b) * S, S, w0, k, dna_smem);
  __syncthreads();

  bool keep[kDnaWin] = {};
  uint64_t hash[kDnaWin] = {};
#pragma unroll 1
  for (int j = 0; j < kDnaWin; ++j) {
    const int s = j * kTile + threadIdx.x;  // the window's position in the tile
    bool ok, rev;
    plane_strand(tile, s, k, ok, rev);
    uint64_t h = 0;
    if (ok) h = tile_murmur(tile, s, k, rev, seed);
    const bool kept = ok && w0 + s < n && h <= max_hash;
#pragma unroll
    for (int i = 0; i < kDnaWin; ++i) {
      keep[i] = i == j ? kept : keep[i];
      hash[i] = i == j ? h : hash[i];
    }
  }
  write_segment_slots<kDnaWin>(keep, hash, warp_count, b, R, slots, slots_hi, slots_lo,
                               counts);
}

// -- T4: microkernels over the tool's block layout -----------------------------

// T4 grids are (tiles of a block's rows * 128 windows, blocks), kTile
// windows a tile (kDnaTile for assembly-only, kTile * kMulChains for
// murmur-only, the mul-chain and the probe): window w of block blk reads
// the block's values from blk * (rows + 8) * 128 + w on and writes output
// element blk * rows * 128 + w.

// Elements a thread of murmur_only, the mul-chain and the probe: four
// consecutive values, one 16-byte load and one 16-byte store.
constexpr int kMulChains = 4;
static_assert(kLanes % kMulChains == 0, "a block's rows hold whole groups of values");

// -- murmur on 32-bit halves, for the IMAD pipe ----------------------------------
//
// The card's IMAD pipe issues an IMAD in one of its 64 slots an SM a clock
// and an IMAD.WIDE.U32 in about two, beside the ALU's 64 (the integer-pipe
// probe below). A 64-bit multiply by a constant needs one wide and two
// plain IMADs; everything else in murmur can run on the ALU. nvcc compiles
// murmur_words' 64-bit code with much more on the IMAD pipe: each multiply
// as three multiplies and an add, rotl64(k * c, r) as a second multiply
// by c << r, and 64-bit shifts and adds as IMAD.WIDE.U32, IMAD.IADD and
// IMAD.X. Spelled out on 32-bit halves, each multiply is its three IMADs,
// each rotate two funnel shifts (SHF), each add an IADD3 pair, each xor a
// LOP3: the IMAD pipe carries the multiplies (and h * 5 + c, a wide and a
// plain IMAD) and little else.
struct Half64 {
  uint32_t lo, hi;
};

__device__ __forceinline__ Half64 h64(uint64_t x) {
  return {static_cast<uint32_t>(x), static_cast<uint32_t>(x >> 32)};
}

// x * c mod 2^64: IMAD.WIDE.U32 of the low halves, then two IMADs into
// its high half. In PTX, because from C nvcc splits the high half into two
// products and an add (an IMAD.IADD as often as not).
__device__ __forceinline__ Half64 hmul(Half64 x, uint64_t c) {
  Half64 r;
  asm("{\n\t.reg .u64 w;\n\t.reg .u32 t;\n\t"
      "mul.wide.u32 w, %2, %4;\n\t"
      "mov.b64 {%0, t}, w;\n\t"
      "mad.lo.u32 t, %2, %5, t;\n\t"
      "mad.lo.u32 %1, %3, %4, t;\n\t}"
      : "=r"(r.lo), "=r"(r.hi)
      : "r"(x.lo), "r"(x.hi), "r"(static_cast<uint32_t>(c)), "r"(static_cast<uint32_t>(c >> 32)));
  return r;
}

// rotl64(x, r), 0 < r < 64, r != 32: two funnel shifts.
template <int r>
__device__ __forceinline__ Half64 hrotl(Half64 x) {
  static_assert(r > 0 && r < 64 && r != 32, "a rotate of two funnel shifts");
  if (r < 32) return {__funnelshift_l(x.hi, x.lo, r), __funnelshift_l(x.lo, x.hi, r)};
  return {__funnelshift_l(x.lo, x.hi, r - 32), __funnelshift_l(x.hi, x.lo, r - 32)};
}

__device__ __forceinline__ Half64 hadd(Half64 a, Half64 b) {
  Half64 r;
  asm("add.cc.u32 %0, %2, %4;\n\taddc.u32 %1, %3, %5;"
      : "=r"(r.lo), "=r"(r.hi) : "r"(a.lo), "r"(a.hi), "r"(b.lo), "r"(b.hi));
  return r;
}

__device__ __forceinline__ Half64 hxor(Half64 a, Half64 b) { return {a.lo ^ b.lo, a.hi ^ b.hi}; }

// h * 5 + c: a wide multiply-add and a multiply-add (and an add where c
// has a high half).
__device__ __forceinline__ Half64 hmul5add(Half64 h, uint64_t c) {
  const uint64_t w = static_cast<uint64_t>(h.lo) * 5u + static_cast<uint32_t>(c);
  return {static_cast<uint32_t>(w),
          h.hi * 5u + static_cast<uint32_t>(w >> 32) + static_cast<uint32_t>(c >> 32)};
}

// fmix64 on halves: k >> 33 touches only the low half.
__device__ __forceinline__ Half64 hfmix(Half64 k) {
  k.lo ^= k.hi >> 1;
  k = hmul(k, 0xff51afd7ed558ccdULL);
  k.lo ^= k.hi >> 1;
  k = hmul(k, 0xc4ceb9fe1a85ec53ULL);
  k.lo ^= k.hi >> 1;
  return k;
}

// murmur_words' function (sketch_common.cuh) on halves: word(start, len)
// gives the Half64 of bytes [start, start + len). With k a constant the
// block loop and the tail branches fold. The first block's h1 + h2 adds
// the seed: (r + seed) * 5 + c is r * 5 + (5 * seed + c), one add fewer.
template <typename Word>
__device__ __forceinline__ uint64_t murmur_halves(int k, uint64_t seed, Word word) {
  constexpr uint64_t kN1 = 0x52dce729u, kN2 = 0x38495ab5u;
  auto mix1 = [](Half64 x) { return hmul(hrotl<31>(hmul(x, kC1)), kC2); };
  auto mix2 = [](Half64 x) { return hmul(hrotl<33>(hmul(x, kC2)), kC1); };
  Half64 h1 = h64(seed), h2 = h1;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    const Half64 r = hrotl<27>(hxor(h1, mix1(word(16 * b, 8))));
    h1 = b == 0 ? hmul5add(r, 5 * seed + kN1) : hmul5add(hadd(r, h2), kN1);
    h2 = hmul5add(hadd(hrotl<31>(hxor(h2, mix2(word(16 * b + 8, 8)))), h1), kN2);
  }
  const int tail = k & 15;
  const int base = 16 * nblocks;
  if (tail > 8) h2 = hxor(h2, mix2(word(base + 8, tail - 8)));
  if (tail > 0) h1 = hxor(h1, mix1(word(base, tail < 8 ? tail : 8)));
  h1.lo ^= static_cast<uint32_t>(k);
  h2.lo ^= static_cast<uint32_t>(k);
  h1 = hadd(h1, h2);
  h2 = hadd(h2, h1);
  const Half64 h = hadd(hfmix(h1), hfmix(h2));
  return static_cast<uint64_t>(h.hi) << 32 | h.lo;
}

// T4 murmur-only. Replaces tools/profile_sketch_parts.py:_murmur_only_kernel:
// per element x, murmur (seed kT4Seed) of k bytes given as the unmasked
// fake words (x ^ 2i) << 32 | (x ^ (2i + 1)), then hi ^ lo.
//
// Bound: integer issue (murmur alone: at k = 31 twelve multiplies by
// 64-bit constants and two by 5 on the IMAD pipe, 52 slots an element; six
// 64-bit rotates, the fmix shift-xors and the xors, 38 ALU-only ops; no
// memory to speak of): the IMAD pipe binds. Design: k is a template
// constant (kT4K), so the block loop and the tail branches fold as in K1's
// k = 31 body; murmur on 32-bit halves (murmur_halves) keeps the IMAD pipe
// to the multiplies and puts rotates, adds and xors on the ALU beside it;
// each thread takes kMulChains consecutive elements with one 16-byte load
// and one 16-byte store, so the index math, the bounds check and the
// memory instructions are paid once per four murmurs, and the four hashes
// are independent work to interleave. Each fake word is two 32-bit xors of
// x on the register halves.
template <int kK>
__global__ void __launch_bounds__(kTile)
murmur_only_kernel(const int32_t* __restrict__ blocks, int rows, uint32_t* __restrict__ out) {
  const int groups = rows * kLanes / kMulChains;
  const int g = blockIdx.x * kTile + threadIdx.x;
  if (g >= groups) return;
  const int64_t blk = blockIdx.y;
  const int4 x = reinterpret_cast<const int4*>(blocks + blk * (rows + kExtraRows) * kLanes)[g];
  const uint32_t xs[kMulChains] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                                   static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
  uint32_t o[kMulChains];
#pragma unroll
  for (int c = 0; c < kMulChains; ++c) {
    const uint64_t h = murmur_halves(kK, kT4Seed, [&](int start, int) {
      const uint32_t j = 2u * static_cast<uint32_t>(start >> 3);
      return Half64{xs[c] ^ (j + 1u), xs[c] ^ j};
    });
    o[c] = static_cast<uint32_t>(h >> 32) ^ static_cast<uint32_t>(h);
  }
  reinterpret_cast<uint4*>(out + blk * rows * kLanes)[g] = make_uint4(o[0], o[1], o[2], o[3]);
}

// T4's tile: K2's DNA tile staged from a block's int32 values at k =
// kT4K, with the not-ACGT plane and no code planes (strand8 orders any
// bytes). Its dynamic shared memory: the L staged bytes, their reverse
// complement, 16 bytes of reach, the plane (L / 32 + 1 words).
constexpr int kT4Staged = dna_staged(kT4K);
constexpr int kT4Smem = 2 * kT4Staged + 16 + 4 * (kT4Staged / 32 + 1);
static_assert(kT4K > 8 && kT4K <= 32,
              "T4's first eight bytes are a whole word; its validity one funnel shift");

// The complement() of four bytes at once.
__device__ __forceinline__ uint32_t complement4(uint32_t x) {
  const uint32_t bit1 = (x >> 1) & 0x01010101u;
  return x ^ (0x15151515u ^ (bit1 * 0x11u));
}

// Stage positions [w0, w0 + L) of one T4 block of `values` int32 values
// (w0 a multiple of kDnaTile) into smem: the low byte of each value, read
// four values at a time with 16-byte loads; positions past the block read
// 0, never valid. Each quad of values is one 32-bit word of the forward
// bytes, one of the reverse complement (byte-reversed, complemented) and a
// nibble of the not-ACGT plane; the 8 lanes that hold one plane word
// gather its nibbles by shuffles. Every thread of the kTile block calls
// it; the caller synchronises.
__device__ __forceinline__ void stage_value_tile(const int32_t* __restrict__ src, int values,
                                                 int w0, uint8_t* smem) {
  constexpr int kQuads = kT4Staged / 4;  // a multiple of 8: whole plane words
  uint32_t* fwd = reinterpret_cast<uint32_t*>(smem);
  uint32_t* rc = fwd + kQuads;
  uint32_t* bad = reinterpret_cast<uint32_t*>(smem + 2 * kT4Staged + 16);
  const int4* in = reinterpret_cast<const int4*>(src + w0);
  const int in_block = (values - w0) / 4;  // quads below this lie in the block
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int r = 0; r < (kQuads + kTile - 1) / kTile; ++r) {
    const int q = r * kTile + t;
    if (r * kTile + (t & ~31) >= kQuads) break;  // warp-uniform: whole warps take part
    const int4 v = q < in_block && q < kQuads ? in[q] : make_int4(0, 0, 0, 0);
    const uint32_t f = __byte_perm(__byte_perm(v.x, v.y, 0x0040), __byte_perm(v.z, v.w, 0x0040),
                                   0x5410);
    uint32_t nb = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) nb |= static_cast<uint32_t>(!is_acgt((f >> (8 * i)) & 0xFFu)) << i;
    uint32_t word = nb << (4 * (lane & 7));
    word |= __shfl_xor_sync(0xffffffffu, word, 1);
    word |= __shfl_xor_sync(0xffffffffu, word, 2);
    word |= __shfl_xor_sync(0xffffffffu, word, 4);
    if (q < kQuads) {
      fwd[q] = f;
      rc[kQuads - 1 - q] = complement4(__byte_perm(f, 0, 0x0123));
      if ((lane & 7) == 0) bad[q >> 3] = word;
    }
  }
  if (t < 4) reinterpret_cast<uint32_t*>(smem + 2 * kT4Staged)[t] = 0u;
  if (t == 4) bad[kT4Staged / 32] = 0u;
}

// T4 assembly-only. Replaces tools/profile_sketch_parts.py:
// _assembly_only_kernel: the XOR of the canonical window's 32-bit limbs,
// xor its validity, for the window at each element (the low byte of each
// value is the base): K1's and K2's window assembly without murmur.
//
// Bound: bytes (4 read and 4 written a window), but the staging and each
// window's ~40 instructions come near the card's issue rate at that pace.
// Design: K2's tile staged from the values (stage_value_tile); each thread
// takes kDnaWin windows kTile apart, as K1 and K2 do, so the instrument
// assembles words as K1 does. The tool's values are random bytes, so
// almost every window holds a byte that is not ACGT and the code planes
// could not order it: every window takes its strand from strand8, whose
// first step (the first eight bytes of each run, also word 0 of the
// chosen one) decides but for a window that shares them with its reverse
// complement. Validity is a funnel shift of the plane; the other words are
// eight-byte loads of the chosen run, as K1's murmur reads them. Each of a
// thread's output stores coalesces across its warp.
__global__ void __launch_bounds__(kTile)
assembly_only_kernel(const int32_t* __restrict__ blocks, int rows, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t t4_smem[];
  constexpr int k = kT4K, L = kT4Staged;
  const int per = rows * kLanes;
  const int values = (rows + kExtraRows) * kLanes;
  const int64_t blk = blockIdx.y;
  const int w0 = blockIdx.x * kDnaTile;
  stage_value_tile(blocks + blk * values, values, w0, t4_smem);
  __syncthreads();

  const uint32_t* bad = reinterpret_cast<const uint32_t*>(t4_smem + 2 * L + 16);
  uint32_t* orow = out + blk * per + w0;
#pragma unroll
  for (int j = 0; j < kDnaWin; ++j) {
    const int s = j * kTile + threadIdx.x;
    const bool ok = (plane_bits(bad, s) & low_mask(k)) == 0;
    // strand8's first step, kept as word 0 of the chosen run; the rest of
    // strand8 runs only where it does not decide
    const int r = 2 * L - s - k;
    const uint64_t x0 = load8(t4_smem, s), y0 = load8(t4_smem, r);
    const bool rev = x0 != y0 ? bswap64(y0) < bswap64(x0) : strand8(t4_smem, L, s, k);
    uint64_t x = rev ? y0 : x0;
#pragma unroll
    for (int c = 1; 8 * c < k; ++c) x ^= run_word(t4_smem, rev ? r : s, k, c);
    if (w0 + s < per)
      orow[s] = static_cast<uint32_t>(x >> 32) ^ static_cast<uint32_t>(x) ^ (ok ? 1u : 0u);
  }
}

// T4 mul-chain. Replaces tools/profile_sketch_parts.py:_mulchain_kernel:
// n_rounds of v *= C1, v = rotl(v, 31), v ^= v with its halves swapped,
// from v = x << 32 | (x ^ 1); then hi ^ lo. After one round the halves are
// equal, so the output is 0 for every n_rounds >= 1 (1 for none), as the
// JAX function's is.
//
// Bound: integer issue, by construction: the chain measures the card's
// 64-bit multiply-rotate rate (a round: the multiply's IMAD-pipe slots, two
// funnel shifts, two xors). Each round depends on the one before, so a
// single chain a thread waits on the multiply's latency, and a thread that
// loads, computes and stores one value in turn adds its memory time to the
// rounds'. Design: each thread takes kMulChains consecutive values with one
// 16-byte load, runs their chains interleaved round by round (kMulChains
// independent multiplies in flight a step) and writes the outputs with one
// 16-byte store. The empty asm on each chain's high half hides that the
// result is 0, so the compiler must keep every chain.
__global__ void __launch_bounds__(kTile)
mulchain_kernel(const int32_t* __restrict__ blocks, int rows, int n_rounds,
                uint32_t* __restrict__ out) {
  const int groups = rows * kLanes / kMulChains;
  const int g = blockIdx.x * kTile + threadIdx.x;
  if (g >= groups) return;
  const int64_t blk = blockIdx.y;
  const int4 x = reinterpret_cast<const int4*>(blocks + blk * (rows + kExtraRows) * kLanes)[g];
  const uint32_t xs[kMulChains] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                                   static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
  uint64_t v[kMulChains];
#pragma unroll
  for (int c = 0; c < kMulChains; ++c) v[c] = static_cast<uint64_t>(xs[c]) << 32 | (xs[c] ^ 1u);
#pragma unroll 8
  for (int r = 0; r < n_rounds; ++r) {
#pragma unroll
    for (int c = 0; c < kMulChains; ++c) {
      v[c] *= kC1;
      v[c] = rotl64(v[c], 31);
      v[c] ^= rotl64(v[c], 32);
    }
  }
  uint32_t o[kMulChains];
#pragma unroll
  for (int c = 0; c < kMulChains; ++c) {
    uint32_t hi = static_cast<uint32_t>(v[c] >> 32);
    asm volatile("" : "+r"(hi));
    o[c] = hi ^ static_cast<uint32_t>(v[c]);
  }
  reinterpret_cast<uint4*>(out + blk * rows * kLanes)[g] = make_uint4(o[0], o[1], o[2], o[3]);
}

// -- the integer-pipe probe -----------------------------------------------------

// What one round of a probe chain does to v = hi << 32 | lo.
enum IntProbeMode : int {
  kProbeMul64 = 0,  // v *= kC1: an IMAD.WIDE.U32 and two IMADs
  kProbeMul32 = 1,  // lo = lo * c + hi and hi = hi * c' + lo: one IMAD a half
  kProbeAlu = 2,    // v = rotl64(v, 31), then hi ^= lo: two SHFs and a LOP3
  kProbeMix = 3,    // a mul64 round, then an alu round
};
// mul32's multipliers: C1's halves, the high one made even, so that a round
// is invertible (the determinant c * c' - 1 odd) and no chain decays to 0
constexpr uint32_t kProbeC = static_cast<uint32_t>(kC1);
constexpr uint32_t kProbeC2 = static_cast<uint32_t>(kC1 >> 32) ^ 1u;

template <int kMode>
__device__ __forceinline__ void probe_round(uint32_t& hi, uint32_t& lo) {
  if (kMode == kProbeMul64 || kMode == kProbeMix) {
    const uint64_t v = (static_cast<uint64_t>(hi) << 32 | lo) * kC1;
    hi = static_cast<uint32_t>(v >> 32);
    lo = static_cast<uint32_t>(v);
  }
  if (kMode == kProbeMul32) {
    const uint32_t l = lo * kProbeC + hi;
    hi = hi * kProbeC2 + lo;
    lo = l;
  }
  if (kMode == kProbeAlu || kMode == kProbeMix) {
    const uint64_t v = rotl64(static_cast<uint64_t>(hi) << 32 | lo, 31);
    lo = static_cast<uint32_t>(v);
    hi = static_cast<uint32_t>(v >> 32) ^ lo;
  }
  // the compiler may not see through a round: no two rounds fold into one
  asm volatile("" : "+r"(hi), "+r"(lo));
}

// The integer-pipe probe. Replaces no TPU kernel: it measures what the
// card's integer pipes give, for chip_smoke's "operations" bounds.
// n_rounds rounds of probe_round<kMode> on v = x << 32 | (x * kProbeC),
// then hi ^ lo, over mulchain's layout and grid: kMulChains consecutive values
// a thread from one 16-byte load, their chains interleaved round by round,
// one 16-byte store. Each round depends on the one before, and the empty
// asm at its end keeps the compiler from folding rounds, so the time per
// round (the slope over n_rounds) is the instructions' issue cost. The alu
// round xors only the high half: mulchain's half-swap xor leaves the
// halves equal (one LOP3), and a chain of it alone is 0 after two rounds.
// The low half starts as a product of x, not a bit mask of it: the alu
// round is linear over GF(2), and from x ^ 1 its hi ^ lo is one constant
// after 64 rounds.
// Bound: integer issue, by construction.
template <int kMode>
__global__ void __launch_bounds__(kTile)
int_probe_kernel(const int32_t* __restrict__ blocks, int rows, int n_rounds,
                 uint32_t* __restrict__ out) {
  const int groups = rows * kLanes / kMulChains;
  const int g = blockIdx.x * kTile + threadIdx.x;
  if (g >= groups) return;
  const int64_t blk = blockIdx.y;
  const int4 x = reinterpret_cast<const int4*>(blocks + blk * (rows + kExtraRows) * kLanes)[g];
  uint32_t hi[kMulChains] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                             static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
  uint32_t lo[kMulChains];
#pragma unroll
  for (int c = 0; c < kMulChains; ++c) lo[c] = hi[c] * kProbeC;
#pragma unroll 8
  for (int r = 0; r < n_rounds; ++r) {
#pragma unroll
    for (int c = 0; c < kMulChains; ++c) probe_round<kMode>(hi[c], lo[c]);
  }
  reinterpret_cast<uint4*>(out + blk * rows * kLanes)[g] =
      make_uint4(hi[0] ^ lo[0], hi[1] ^ lo[1], hi[2] ^ lo[2], hi[3] ^ lo[3]);
}

}  // namespace

extern "C" {

const char* sp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// words [B, n_pad, nw] u64, valid [B, n_pad] u8 for rows seq [B, S] u8:
// nw = ceil(k / 8) rounded up to even, n_pad a multiple of 128, words
// 16-byte aligned.
int sp_split_words(const void* seq, int B, int S, int n_pad, int ksize, int nw,
                   void* words, void* valid, void* stream) {
  if (nw != split_nw(ksize) || n_pad % kSeg || reinterpret_cast<uintptr_t>(words) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_template_k(ksize, [&](auto kk) {
    constexpr int kK = decltype(kk)::value;
    const size_t smem = split_smem_bytes(ksize);
    cudaError_t err = opt_in_smem(split_words_kernel<kK>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((n_pad + kDnaTile - 1) / kDnaTile, B);
    split_words_kernel<kK><<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq), S, n_pad, ksize, static_cast<ulonglong2*>(words),
        static_cast<uint8_t*>(valid));
    return cudaGetLastError();
  }));
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
  return static_cast<int>(with_template_k(ksize, [&](auto kk) {
    constexpr int kK = decltype(kk)::value;
    const size_t smem = dna_smem_bytes(ksize);
    cudaError_t err = opt_in_smem(survivor_slots_v2_kernel<kK>, smem);
    if (err != cudaSuccess) return err;
    constexpr int segs_per_block = kDnaTile / kSeg;
    dim3 grid((R + segs_per_block - 1) / segs_per_block, B);
    survivor_slots_v2_kernel<kK><<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq), S, n, R, ksize, seed, max_hash, slots,
        static_cast<uint32_t*>(slots_hi), static_cast<uint32_t*>(slots_lo),
        static_cast<int32_t*>(counts));
    return cudaGetLastError();
  }));
}

// out [nblk * rows, 128] u32 from blocks [nblk * (rows + 8), 128] i32,
// at k = kT4K (and seed kT4Seed); blocks and out 16-byte aligned.
int sp_murmur_only(const void* blocks, int nblk, int rows, void* out, void* stream) {
  if (reinterpret_cast<uintptr_t>(blocks) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((rows * kLanes / kMulChains + kTile - 1) / kTile, nblk);
  murmur_only_kernel<kT4K><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// blocks 16-byte aligned.
int sp_assembly_only(const void* blocks, int nblk, int rows, void* out, void* stream) {
  if (reinterpret_cast<uintptr_t>(blocks) % 16) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((rows * kLanes + kDnaTile - 1) / kDnaTile, nblk);
  assembly_only_kernel<<<grid, kTile, kT4Smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// blocks and out 16-byte aligned.
int sp_mulchain(const void* blocks, int nblk, int rows, int n_rounds, void* out,
                void* stream) {
  if (reinterpret_cast<uintptr_t>(blocks) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((rows * kLanes / kMulChains + kTile - 1) / kTile, nblk);
  mulchain_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), rows, n_rounds, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The probe in `mode` (IntProbeMode), n_rounds rounds, mulchain's layout;
// blocks and out 16-byte aligned.
int sp_int_probe(const void* blocks, int nblk, int rows, int mode, int n_rounds, void* out,
                 void* stream) {
  if (reinterpret_cast<uintptr_t>(blocks) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((rows * kLanes / kMulChains + kTile - 1) / kTile, nblk);
  auto run = [&](auto kernel) {
    kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blocks), rows, n_rounds, static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  switch (mode) {
    case kProbeMul64: return run(int_probe_kernel<kProbeMul64>);
    case kProbeMul32: return run(int_probe_kernel<kProbeMul32>);
    case kProbeAlu: return run(int_probe_kernel<kProbeAlu>);
    case kProbeMix: return run(int_probe_kernel<kProbeMix>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
