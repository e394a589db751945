// Hand-written Hopper (sm_90a) kernel of the sharded gather program
// (`sourmash_tpu_torch/parallel/`): shard_match (X8), the shard-local dense
// compare of a block of queries against one shard's rows.
//
// It replaces the XLA loops `sourmash_tpu/parallel/__init__.py:146
// _local_counts` (the sharded counter and the gather round's decrement)
// and `:306 build_chunk` (the membership builder and the gather round's
// winner row); no Pallas kernel computed them. One kernel serves all
// three uses:
//
//   counts[q, row0 + r] = popc of M[q, row0 + r, :, :]
//   M[q, row0 + r, s, w] bit j = alive(q, s, 32w + j) and the query slot
//     (s, 32w + j) equals one of row r's occupied slots k < Scnt[r, 32w + j]
//     of that bucket,
//
// for query planes qhi/qlo [bq, dq, B] (u32 limbs), their alive words
// [bq, dq, B/32] (bit j of word w: bucket 32w + j), subject planes shi/slo
// [rows, d, B] with occupancy scnt [rows, B] u8 (past it, slots hold
// anything: validity comes from occupancy alone, so 2^64-1 is a hash like
// any other). M is optional (the counter and the decrement need counts
// only); counts and M have out_rows rows, of which this launch writes
// [row0, row0 + rows), so the builder writes its chunks in place. A row's
// count equals `_local_counts` when its occupied values are distinct in
// each bucket, as every pack gives them.
//
// Bound: the compares, bq * rows * dq * B * (occupied slots) on the run's
// data, against the integer pipes; then the M words written once. Design:
// a block of 8 warps covers 8 words (256 buckets, a bucket a lane) of a
// tile of 4 rows. Each thread holds its bucket's first 8 occupied slots of
// its 4 rows in registers (slots past 8 are read from global memory, which
// a pack of mean load <= 2.5 rarely needs), so the subject planes are read
// once per block, and loops over the query block and its slots, 4 slots'
// loads issued together (the loop is bound by load latency, not by its
// compares): the alive word is warp-uniform (a dead word costs one load
// and no compare), the live query limbs are read coalesced, one ballot a
// row gives the row's word with no atomics, its popcount the count; lane
// t stores row t's word. A row's count is added once per query by one
// atomic a warp.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// The entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // subject rows of a block
constexpr int kRegSlots = 8;   // occupied slots of each row held in registers
constexpr int kWarps = 8;      // words of a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 4;      // query slots whose loads a thread issues together

template <bool kBits>
__global__ void __launch_bounds__(kThreads, 2)
shard_match_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                   const uint32_t* __restrict__ alive, int bq, int dq, int B,
                   const uint32_t* __restrict__ shi, const uint32_t* __restrict__ slo,
                   const uint8_t* __restrict__ scnt, int rows, int d, int out_rows,
                   int row0, int32_t* __restrict__ counts, uint32_t* __restrict__ M) {
  const int W = B >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (w >= W) return;  // the whole warp leaves together
  const int b = (w << 5) + lane;
  const int r_base = blockIdx.x * kRows;

  uint32_t sh[kRows][kRegSlots], sl[kRows][kRegSlots];
  int cnt[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int r = r_base + t;
    cnt[t] = r < rows ? min(static_cast<int>(scnt[(size_t)r * B + b]), d) : 0;
#pragma unroll
    for (int k = 0; k < kRegSlots; ++k) {
      const size_t at = ((size_t)r * d + k) * B + b;
      const bool in = k < cnt[t];
      sh[t][k] = in ? shi[at] : 0u;
      sl[t][k] = in ? slo[at] : 0u;
    }
  }

  for (int q = 0; q < bq; ++q) {
    int acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0;
    for (int s0 = 0; s0 < dq; s0 += kSlots) {
      // kSlots query slots' alive words, then their live limbs, loaded
      // together: independent loads in flight instead of a chain a slot
      uint32_t a[kSlots], h[kSlots], l[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j)  // the same word in every lane
        a[j] = s0 + j < dq ? alive[((size_t)q * dq + s0 + j) * W + w] : 0u;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const bool live = (a[j] >> lane) & 1u;
        const size_t at = ((size_t)q * dq + s0 + j) * B + b;
        h[j] = live ? qhi[at] : 0u;
        l[j] = live ? qlo[at] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int s = s0 + j;
        uint32_t word[kRows];
#pragma unroll
        for (int t = 0; t < kRows; ++t) word[t] = 0u;
        if (a[j] != 0u) {
          const bool live = (a[j] >> lane) & 1u;
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            bool hit = false;
#pragma unroll
            for (int k = 0; k < kRegSlots; ++k)
              hit |= (k < cnt[t]) & (sh[t][k] == h[j]) & (sl[t][k] == l[j]);
            for (int k = kRegSlots; live && k < cnt[t]; ++k) {
              const size_t at = ((size_t)(r_base + t) * d + k) * B + b;
              hit |= (shi[at] == h[j]) & (slo[at] == l[j]);
            }
            word[t] = __ballot_sync(0xffffffffu, live && hit);
            acc[t] += __popc(word[t]);
          }
        }
        if (kBits && s < dq) {
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            const int r = r_base + t;
            if (lane == t && r < rows)
              M[(((size_t)q * out_rows + row0 + r) * dq + s) * W + w] = word[t];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = r_base + t;
      if (lane == t && r < rows && acc[t])
        atomicAdd(&counts[(size_t)q * out_rows + row0 + r], acc[t]);
    }
  }
}

}  // namespace

extern "C" {

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts [bq, out_rows] i32 (rows [row0, row0 + rows) zeroed by the
// caller) += the matches of each query of qhi/qlo [bq, dq, B] u32 (alive
// words [bq, dq, B/32], B a multiple of 32) against rows shi/slo
// [rows, d, B] u32, occupancy scnt [rows, B] u8; with M (else null), the
// match words M [bq, out_rows, dq, B/32] of those rows are written too.
int pm_shard_match(const void* qhi, const void* qlo, const void* alive, int bq, int dq, int B,
                   const void* shi, const void* slo, const void* scnt, int rows, int d,
                   int out_rows, int row0, void* counts, void* M, void* stream) {
  if (bq <= 0 || dq <= 0 || rows <= 0 || B < 32) return 0;
  if (B % 32 || row0 < 0 || row0 + rows > out_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = B >> 5;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)((W + kWarps - 1) / kWarps));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qh = static_cast<const uint32_t*>(qhi);
  const auto* ql = static_cast<const uint32_t*>(qlo);
  const auto* al = static_cast<const uint32_t*>(alive);
  const auto* sh = static_cast<const uint32_t*>(shi);
  const auto* sl = static_cast<const uint32_t*>(slo);
  const auto* sc = static_cast<const uint8_t*>(scnt);
  auto* out = static_cast<int32_t*>(counts);
  if (M != nullptr) {
    shard_match_kernel<true><<<grid, kThreads, 0, st>>>(
        qh, ql, al, bq, dq, B, sh, sl, sc, rows, d, out_rows, row0, out,
        static_cast<uint32_t*>(M));
  } else {
    shard_match_kernel<false><<<grid, kThreads, 0, st>>>(
        qh, ql, al, bq, dq, B, sh, sl, sc, rows, d, out_rows, row0, out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
