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

  write_segment_slots(keep, h, warp_count, b, R, slots, slots_hi, slots_lo, counts);
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
