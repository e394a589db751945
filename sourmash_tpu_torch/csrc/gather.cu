// Hand-written Hopper (sm_90a) kernels for the gather hot paths: the
// bucketed counts (T1), the membership bitsets (X4) and the greedy round
// decrement (X5).
//
// Layout (`sourmash_tpu_torch/ops/bucketed.py`): a sketch is bucketed by
// the low log2(B) bits of its hashes; a bank row holds d = 8 slots per
// bucket as two u32 limb planes hi, lo [rows, d, B] (PAD = 0xFFFFFFFF in
// both limbs past a bucket's occupancy cnt [rows, B]); a query holds
// dq slots per bucket as planes [dq, B]. Limbs cross from torch as int32
// bit patterns and are compared here as uint32.
//
// counts_rows replaces `tools/exp_pallas_counts.py:_counts_rows_pallas`
// (T1, body `_counts_kernel`): the raw count of equal limb pairs between
// the query planes and every row, PAD==PAD hits included (the pad
// correction happens outside, in f32). With per-row cutoffs it is the
// accumulator of `sourmash_tpu/ops/bucketed.py:_counts_qvm_cutoff_impl`: a
// hit counts only where the query limb pair is <= the row's cut, unsigned.
// Work is rows * B * d * dq limb-pair compares, so it is bound by integer
// issue, not bytes (the planes are read once, the query planes stay in
// L2). One thread holds the d slots of kRows rows of one bucket in
// registers and walks the bucket's dq query slots, so each query load
// feeds kRows * d compares; adjacent threads take adjacent buckets, so
// every load coalesces. Counts reduce within the warp, then one atomicAdd
// per warp and row.
//
// membership_bits is the hand-written form of
// `sourmash_tpu/ops/bucketed.py:_membership_bits_packed` (X4): for
// selected rows of one chunk, bit j of word w is set when query hash
// 32w + j (slotmap: its flat slot position slot * B + bucket, or dq * B
// for none) sits in a valid slot (k2 < cnt) of the row's bucket. One
// thread per (query hash, group of kMemRows rows); the 32 lanes of a warp
// are the 32 bits of one word (__ballot_sync). No [nm, dq, B] transient.
// Bound by the gathered reads of the rows' slots.
//
// round_dec is the AND + popcount step of `sourmash_tpu/index/flat.py`
// (`_dec_counts`, and the decrement inside `_schedule_scan`): out[r] =
// sum_w popc(M[r, w] & rm[w]). One block per row; bound by reading M.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 8;          // subject slots per bucket
constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 4;       // counts_rows: rows per thread
constexpr int kMemRows = 8;    // membership_bits: rows per thread

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

template <bool kCut>
__global__ void __launch_bounds__(kThreads)
counts_rows_kernel(const uint32_t* __restrict__ qhi,
                   const uint32_t* __restrict__ qlo, int dq, int B,
                   const uint32_t* __restrict__ shi,
                   const uint32_t* __restrict__ slo, int rows,
                   const uint32_t* __restrict__ cut_hi,
                   const uint32_t* __restrict__ cut_lo,
                   int32_t* __restrict__ out) {
  const int blocks_per_row = (B + kThreads - 1) / kThreads;
  const int row0 = (blockIdx.x / blocks_per_row) * kRows;
  const int b = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  const bool in_b = b < B;

  uint32_t sh[kRows][kD], sl[kRows][kD];
  uint32_t ch[kRows], cl[kRows];
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; r++) {
    live[r] = in_b && row0 + r < rows;
    const size_t base = ((size_t)(row0 + r) * kD) * (size_t)B + (size_t)b;
#pragma unroll
    for (int k = 0; k < kD; k++) {
      sh[r][k] = live[r] ? shi[base + (size_t)k * B] : 0u;
      sl[r][k] = live[r] ? slo[base + (size_t)k * B] : 0u;
    }
    ch[r] = (kCut && live[r]) ? cut_hi[row0 + r] : 0u;
    cl[r] = (kCut && live[r]) ? cut_lo[row0 + r] : 0u;
  }

  int count[kRows];
#pragma unroll
  for (int r = 0; r < kRows; r++) count[r] = 0;
  if (in_b) {
    for (int q = 0; q < dq; q++) {
      const uint32_t qh = __ldg(qhi + (size_t)q * B + b);
      const uint32_t ql = __ldg(qlo + (size_t)q * B + b);
#pragma unroll
      for (int r = 0; r < kRows; r++) {
        int hits = 0;
#pragma unroll
        for (int k = 0; k < kD; k++) hits += (sh[r][k] == qh) & (sl[r][k] == ql);
        if (kCut) {
          const bool le = qh < ch[r] || (qh == ch[r] && ql <= cl[r]);
          hits = le ? hits : 0;
        }
        count[r] += hits;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; r++) {
    const int c = warp_sum(live[r] ? count[r] : 0);
    if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(out + row0 + r, c);
  }
}

__global__ void __launch_bounds__(kThreads)
membership_bits_kernel(const uint32_t* __restrict__ qhi,
                       const uint32_t* __restrict__ qlo, int dq, int B,
                       const uint32_t* __restrict__ shi,
                       const uint32_t* __restrict__ slo,
                       const uint8_t* __restrict__ scnt,
                       const int64_t* __restrict__ sel, int nm,
                       const int32_t* __restrict__ slotmap, int W,
                       uint32_t* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;  // query hash index
  const int word = p >> 5;
  const int row0 = blockIdx.y * kMemRows;
  const int n_pos = dq * B;
  const int pos = word < W ? slotmap[p] : n_pos;
  const bool has = pos >= 0 && pos < n_pos;
  uint32_t qh = 0u, ql = 0u;
  int b = 0;
  if (has) {
    qh = qhi[pos];
    ql = qlo[pos];
    b = pos % B;
  }
  for (int i = 0; i < kMemRows; i++) {
    const int r = row0 + i;
    if (r >= nm) break;  // uniform across the block
    bool hit = false;
    if (has) {
      const size_t s = (size_t)sel[r];
      const int c = scnt[s * B + b];
      const size_t base = s * kD * (size_t)B + (size_t)b;
      for (int k = 0; k < c; k++)
        hit |= (shi[base + (size_t)k * B] == qh) & (slo[base + (size_t)k * B] == ql);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0 && word < W) out[(size_t)r * W + word] = bits;
  }
}

__global__ void __launch_bounds__(kThreads)
round_dec_kernel(const uint32_t* __restrict__ M, const uint32_t* __restrict__ rm,
                 int W, int32_t* __restrict__ out) {
  __shared__ int partial[kThreads / 32];
  const size_t row = blockIdx.x;
  const uint32_t* m = M + row * (size_t)W;
  int acc = 0;
  for (int w = threadIdx.x; w < W; w += kThreads) acc += __popc(m[w] & __ldg(rm + w));
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0;
    v = warp_sum(v);
    if (threadIdx.x == 0) out[row] = v;
  }
}

}  // namespace

extern "C" {

const char* gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [rows] i32 (zeroed by the caller) += raw limb-pair matches of the
// query planes [dq, B] against subject planes [rows, 8, B]; with cut_hi and
// cut_lo [rows] (both or neither), only query pairs <= the row's cut.
int gm_counts_rows(const void* qhi, const void* qlo, int dq, int B,
                   const void* shi, const void* slo, int rows,
                   const void* cut_hi, const void* cut_lo, void* out,
                   void* stream) {
  const int blocks_per_row = (B + kThreads - 1) / kThreads;
  const long long grid = (long long)((rows + kRows - 1) / kRows) * blocks_per_row;
  if (grid <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qh = static_cast<const uint32_t*>(qhi);
  const auto* ql = static_cast<const uint32_t*>(qlo);
  const auto* sh = static_cast<const uint32_t*>(shi);
  const auto* sl = static_cast<const uint32_t*>(slo);
  auto* o = static_cast<int32_t*>(out);
  if (cut_hi != nullptr) {
    counts_rows_kernel<true><<<(unsigned)grid, kThreads, 0, s>>>(
        qh, ql, dq, B, sh, sl, rows, static_cast<const uint32_t*>(cut_hi),
        static_cast<const uint32_t*>(cut_lo), o);
  } else {
    counts_rows_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
        qh, ql, dq, B, sh, sl, rows, nullptr, nullptr, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [nm, W] u32 membership words of rows sel [nm] (i64) of one chunk's
// planes [rows, 8, B] / cnt [rows, B] u8, over query hashes slotmap [W*32].
int gm_membership_bits(const void* qhi, const void* qlo, int dq, int B,
                       const void* shi, const void* slo, const void* scnt,
                       const void* sel, int nm, const void* slotmap, int W,
                       void* out, void* stream) {
  if (nm <= 0 || W <= 0) return 0;
  dim3 grid((unsigned)(((long long)W * 32 + kThreads - 1) / kThreads),
            (unsigned)((nm + kMemRows - 1) / kMemRows));
  membership_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo), dq, B,
      static_cast<const uint32_t*>(shi), static_cast<const uint32_t*>(slo),
      static_cast<const uint8_t*>(scnt), static_cast<const int64_t*>(sel), nm,
      static_cast<const int32_t*>(slotmap), W, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [k] i32 = per-row popcount of M [k, W] & rm [W].
int gm_round_dec(const void* M, const void* rm, int k, int W, void* out,
                 void* stream) {
  if (k <= 0) return 0;
  round_dec_kernel<<<(unsigned)k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(M), static_cast<const uint32_t*>(rm), W,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
