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

#include <type_traits>

#include "sketch_common.cuh"

namespace {

// K2. Replaces sourmash_tpu/ops/pallas_sketch.py:window_hash_pairs_pallas
// (kernel _sketch_block_kernel over _hash_streams).
//
// Bound: integer issue. Murmur is ~100 instructions a window, while a
// window reads ~1 new byte and writes 9 (hash + validity). Design: K1's
// tile (sketch_common.cuh): a block stages kDnaTile windows, their reverse
// complement and the five ballot planes once; each thread hashes kDnaWin
// windows, kTile apart, so each of its hash (8 B) and validity (1 B)
// stores coalesces across the warp. Validity is a funnel shift of the
// not-ACGT plane; a valid window takes its strand from the code planes,
// and its murmur words are two funnel shifts of aligned loads of the
// forward or the rc run, with no per-byte select. K2 writes every window,
// invalid and pad windows included, and must give the reference's garbage
// hash there: 2-bit codes cannot order bytes other than ACGT, so a window
// holding one takes its strand from the reference's byte compare
// (reverse_is_less over the staged bytes), a branch taken only where such
// windows occur (N runs, pad windows). Its canonical bytes are still a run
// of the forward or the rc bytes, since rc holds complement() of every
// byte. k is a template constant for 21, 31 and 51; kK = 0 reads it from
// its argument.
template <int kK>
__global__ void __launch_bounds__(kTile)
window_hashes_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k_arg,
                     uint64_t seed, uint64_t* __restrict__ hashes,
                     uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t dna_smem[];
  const int k = kK > 0 ? kK : k_arg;
  const int b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kDnaTile;
  const DnaTile tile = stage_dna_tile(seq + static_cast<int64_t>(b) * S, S, w0, k, dna_smem);
  __syncthreads();

  uint64_t* hrow = hashes + static_cast<int64_t>(b) * n_pad + w0;
  uint8_t* vrow = valid + static_cast<int64_t>(b) * n_pad + w0;
#pragma unroll
  for (int j = 0; j < kDnaWin; ++j) {
    const int s = j * kTile + threadIdx.x;
    bool ok, rev;
    plane_strand(tile, s, k, ok, rev);
    if (!ok) rev = reverse_is_less(tile.bytes + s, k);
    const uint64_t h = tile_murmur(tile, s, k, rev, seed);
    if (w0 + s < n_pad) {
      hrow[s] = h;
      vrow[s] = ok ? 1 : 0;
    }
  }
}

// K3. Replaces sourmash_tpu/ops/pallas_sketch.py:aa_window_hash_pairs_pallas
// (kernel _sketch_block_kernel over _aa_hash_streams).
//
// Bound: about half K2's integer work per window (no strand, one byte
// stream), so at sourmash's protein k=10 the 9 bytes written per window
// bound it, and integer issue from k ~ 16 up. Design: the amino-acid tile
// (sketch_common.cuh): a block stages kAaTile windows and the k-1 halo
// once, with a ballot plane of the zero bytes; validity is a funnel shift
// of that plane, the murmur words two funnel shifts of aligned 32-bit
// shared loads, with no per-byte loop. Each thread hashes kAaWin
// consecutive windows, whose murmur chains interleave and which share
// their loads, and writes them with 16-byte hash stores and one 4-byte
// validity store. Every window is hashed as its bytes are, zero bytes,
// pad windows and the bytes past the row (staged as 0) included. k is a
// template constant for sourmash's protein 10, dayhoff 16 and hp 42;
// kK = 0 reads it from its argument.
template <int kK>
__global__ void __launch_bounds__(kTile)
aa_window_hashes_kernel(const uint8_t* __restrict__ seq, int S, int n_pad, int k_arg,
                        uint64_t seed, uint64_t* __restrict__ hashes,
                        uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t aa_smem[];
  const int k = kK > 0 ? kK : k_arg;
  const int b = blockIdx.y;
  const int w0 = blockIdx.x * kAaTile;  // n_pad < 2^31 (the wrapper's range check)
  const AaTile tile = stage_aa_tile(seq + static_cast<int64_t>(b) * S, S, w0, k, aa_smem);
  __syncthreads();

  const int s = kAaWin * threadIdx.x;
  // n_pad is a multiple of kAaWin: a thread's windows are all in or all out
  if (w0 + s >= n_pad) return;
  const uint32_t* at = reinterpret_cast<const uint32_t*>(tile.bytes) + threadIdx.x;
  uint64_t h[kAaWin];
#pragma unroll
  for (int j = 0; j < kAaWin; ++j) h[j] = funnel_murmur(at, 8 * j, k, seed);
  const int64_t out = static_cast<int64_t>(b) * n_pad + w0 + s;
  ulonglong2* hout = reinterpret_cast<ulonglong2*>(hashes + out);
  hout[0] = make_ulonglong2(h[0], h[1]);
  hout[1] = make_ulonglong2(h[2], h[3]);
  *reinterpret_cast<uint32_t*>(valid + out) = aa_valid_word(tile, s, k);
}

// K1. Replaces sourmash_tpu/ops/pallas_sketch.py:sketch_survivor_slots_pallas
// (kernel _sketch_slots_kernel over _hash_streams).
//
// Bound: integer issue. Murmur is ~100 instructions a window and the
// output a few bytes per 128 windows; what held the one-window-per-thread
// form at ~30 % of the issue rate was latency: a dependent, strand-selected
// shared load per canonical byte and an early-exit strand loop.
//
// Design. K1's output depends on valid windows only, so each window takes
// its validity and strand from the planes of the DNA tile
// (sketch_common.cuh) and its murmur words from two funnel shifts of the
// forward or the rc run, with no per-byte select and no byte reversal.
// Each thread hashes kDnaWin independent windows whose murmur chains
// interleave, and a block stages kDnaTile windows, so the k-1 halo and the
// staging are paid once per 1024 windows; one barrier after staging and
// one for the compaction of the block's eight segments (a segment's ranks
// follow window order: window j of thread t sits in lane t % 32 of warp
// (t / 32) % 4 of segment 2j + t / 128). k is a template constant for
// sourmash's usual 21, 31 and 51, where murmur's block and tail structure
// and the word offsets fold away; kK = 0 reads k from its argument, for
// every other k.
template <int kK>
__global__ void __launch_bounds__(kTile)
survivor_slots_kernel(const uint8_t* __restrict__ seq, int S, int n, int R, int k_arg,
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

  bool keep[kDnaWin];
  uint64_t hash[kDnaWin];
#pragma unroll
  for (int j = 0; j < kDnaWin; ++j) {
    const int s = j * kTile + threadIdx.x;  // the window's position in the tile
    bool ok, rev;
    plane_strand(tile, s, k, ok, rev);
    const uint64_t h = tile_murmur(tile, s, k, rev, seed);
    keep[j] = ok && w0 + s < n && h <= max_hash;
    hash[j] = h;
  }
  write_segment_slots<kDnaWin>(keep, hash, warp_count, b, R, slots, slots_hi, slots_lo,
                               counts);
}

// f(std::integral_constant<int, K>) with K = k for sourmash's protein 10,
// dayhoff 16 and hp 42, else K = 0 (the kernel reads k at run time).
template <typename F>
cudaError_t with_template_aa_k(int k, F f) {
  switch (k) {
    case 10: return f(std::integral_constant<int, 10>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 42: return f(std::integral_constant<int, 42>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

}  // namespace

extern "C" {

const char* sm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hashes [B, n_pad] u64, valid [B, n_pad] u8 for rows seq [B, S] u8.
int sm_window_hashes(const void* seq, int B, int S, int n_pad, int ksize,
                     uint64_t seed, void* hashes, void* valid, void* stream) {
  return static_cast<int>(with_template_k(ksize, [&](auto kk) {
    constexpr int kK = decltype(kk)::value;
    const size_t smem = dna_smem_bytes(ksize);
    cudaError_t err = opt_in_smem(window_hashes_kernel<kK>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((n_pad + kDnaTile - 1) / kDnaTile, B);
    window_hashes_kernel<kK><<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq), S, n_pad, ksize, seed,
        static_cast<uint64_t*>(hashes), static_cast<uint8_t*>(valid));
    return cudaGetLastError();
  }));
}

// hashes [B, n_pad] u64, valid [B, n_pad] u8 for amino-acid rows seq [B, S] u8
// (n_pad a multiple of 128; hashes 16-byte and valid 4-byte aligned).
int sm_aa_window_hashes(const void* seq, int B, int S, int n_pad, int ksize,
                        uint64_t seed, void* hashes, void* valid, void* stream) {
  if (n_pad % kAaWin != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_template_aa_k(ksize, [&](auto kk) {
    constexpr int kK = decltype(kk)::value;
    const size_t smem = aa_smem_bytes(ksize);
    cudaError_t err = opt_in_smem(aa_window_hashes_kernel<kK>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((n_pad + kAaTile - 1) / kAaTile, B);
    aa_window_hashes_kernel<kK><<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq), S, n_pad, ksize, seed,
        static_cast<uint64_t*>(hashes), static_cast<uint8_t*>(valid));
    return cudaGetLastError();
  }));
}

// slots_hi, slots_lo [B, R, slots] u32 and counts [B, R] i32 for rows
// seq [B, S] u8 with n = S - ksize + 1 windows and R = ceil(n / 128).
int sm_survivor_slots(const void* seq, int B, int S, int n, int R, int ksize,
                      uint64_t seed, uint64_t max_hash, int slots,
                      void* slots_hi, void* slots_lo, void* counts, void* stream) {
  if (slots < 1 || slots > kSeg) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_template_k(ksize, [&](auto kk) {
    constexpr int kK = decltype(kk)::value;
    const size_t smem = dna_smem_bytes(ksize);
    cudaError_t err = opt_in_smem(survivor_slots_kernel<kK>, smem);
    if (err != cudaSuccess) return err;
    constexpr int segs_per_block = kDnaTile / kSeg;
    dim3 grid((R + segs_per_block - 1) / segs_per_block, B);
    survivor_slots_kernel<kK><<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq), S, n, R, ksize, seed, max_hash, slots,
        static_cast<uint32_t*>(slots_hi), static_cast<uint32_t*>(slots_lo),
        static_cast<int32_t*>(counts));
    return cudaGetLastError();
  }));
}

}  // extern "C"
