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
// 32w + j (slotmap: its flat slot position slot * B + bucket) sits in a
// valid slot (k2 < cnt) of the row's bucket. The loop is driven by the
// rows' valid slots, not by the query: one block per selected row walks
// its buckets (adjacent threads on adjacent buckets, so the cnt bytes and
// each slot's limbs are read coalesced, and only the ~1 valid slot per
// bucket is read), binary-searches each valid (hi, lo) pair in the first
// qcnt[b] slots of its bucket's sorted query column (the query planes stay
// in L2; the search reads hi limbs, a lo limb only where the hi limbs are
// equal, as each probe is a 32-byte L2 sector of its own), and maps a hit
// through the inverse slot map inv (flat position -> query index, -1 for
// none) to its bit. The row's words are built in
// shared memory and written once, coalesced; past the block's shared
// memory the bits go to the zeroed output by atomicOr. Exact for any slot
// map whose inverse is given: query hashes are distinct, and so are a
// row's slots, and a PAD query slot (k2 >= qcnt[b]) is never searched, so
// a slot position that holds no query hash gets no bit, as in the
// query-driven definition (2^64-1, the PAD value, never sits in a valid
// bank slot: the pack spills it). Bound by reading the rows' cnt bytes and
// valid slots and writing the words.
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
constexpr int kMemThreads = 1024;  // membership_bits: threads per row

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

template <bool kShared>
__global__ void __launch_bounds__(kMemThreads)
membership_bits_kernel(const uint32_t* __restrict__ qhi,
                       const uint32_t* __restrict__ qlo,
                       const int32_t* __restrict__ qcnt, int B,
                       const uint32_t* __restrict__ shi,
                       const uint32_t* __restrict__ slo,
                       const uint8_t* __restrict__ scnt,
                       const int64_t* __restrict__ sel,
                       const int32_t* __restrict__ inv, int W,
                       uint32_t* __restrict__ out) {
  extern __shared__ uint32_t row_bits[];  // kShared: the row's W words
  const int t = threadIdx.x;
  uint32_t* dst = out + (size_t)blockIdx.x * W;
  uint32_t* bits = kShared ? row_bits : dst;
  if (kShared) {
    for (int w = t; w < W; w += kMemThreads) row_bits[w] = 0u;
    __syncthreads();
  }
  const size_t s = (size_t)sel[blockIdx.x];
  const uint8_t* cnt = scnt + s * B;
  const uint32_t* rh = shi + s * kD * B;
  const uint32_t* rl = slo + s * kD * B;
  const long long nbits = 32LL * W;
  for (int b = t; b < B; b += kMemThreads) {
    const int c = cnt[b];
    for (int k2 = 0; k2 < c; k2++) {
      const uint32_t h = rh[k2 * B + b];
      const uint32_t l = rl[k2 * B + b];
      // the first of the bucket's qcnt[b] sorted query slots whose hi limb
      // is >= h, by the hi limbs alone; lo limbs are read only along the
      // (rarely longer than one) run of slots whose hi limb equals h
      const int qn = __ldg(qcnt + b);
      int lo = 0, len = qn;
      while (len > 0) {
        const int half = len >> 1;
        const int mid = lo + half;
        const bool less = __ldg(qhi + mid * B + b) < h;
        lo = less ? mid + 1 : lo;
        len = less ? len - half - 1 : half;
      }
      for (int p = lo; p < qn && __ldg(qhi + p * B + b) == h; p++) {
        if (__ldg(qlo + p * B + b) == l) {
          const int j = __ldg(inv + p * B + b);
          if (j >= 0 && j < nbits) atomicOr(bits + (j >> 5), 1u << (j & 31));
          break;
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int w = t; w < W; w += kMemThreads) dst[w] = row_bits[w];
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
// planes [rows, 8, B] / cnt [rows, B] u8, against query planes [dq, B]
// with occupancy qcnt [B] i32 and inverse slot map inv [dq * B] i32.
int gm_membership_bits(const void* qhi, const void* qlo, const void* qcnt, int B,
                       const void* shi, const void* slo, const void* scnt,
                       const void* sel, int nm, const void* inv, int W,
                       void* out, void* stream) {
  if (nm <= 0 || W <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * (size_t)W;
  const bool shared = smem <= (size_t)smem_max;
  if (shared) {
    err = cudaFuncSetAttribute(membership_bits_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  } else {
    err = cudaMemsetAsync(out, 0, smem * (size_t)nm, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = shared ? membership_bits_kernel<true> : membership_bits_kernel<false>;
  kernel<<<(unsigned)nm, kMemThreads, shared ? smem : 0, st>>>(
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo),
      static_cast<const int32_t*>(qcnt), B,
      static_cast<const uint32_t*>(shi), static_cast<const uint32_t*>(slo),
      static_cast<const uint8_t*>(scnt), static_cast<const int64_t*>(sel),
      static_cast<const int32_t*>(inv), W, static_cast<uint32_t*>(out));
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
