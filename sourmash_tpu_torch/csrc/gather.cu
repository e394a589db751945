// Hand-written Hopper (sm_90a) kernels for the gather hot paths: the
// bucketed counts (T1), the membership bitsets (X4) and the greedy round
// decrement (X5), and the batch forms of the last two.
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
// correction happens outside). With per-row cutoffs it is the accumulator
// of `sourmash_tpu/ops/bucketed.py:_counts_qvm_cutoff_impl`: a hit counts
// only where the query limb pair is <= the row's cut, unsigned.
// Precondition: each bucket's query column qhi/qlo[:, b] is ascending in
// unsigned (hi, lo) order, PAD (the largest pair) last; both query packs
// give this, and the wrapper checks it. The bank side needs no order.
// Then a row slot's count is the length of its value's run in the column:
// lower_bound(v) and a walk along the (0, 1 or, for repeated query
// values, more) equal pairs, and for a PAD slot the bucket's PAD run,
// found once per bucket. Bound by reading the bank planes once (the
// search is ~log2(dq) probes a slot, not dq compares). Design: one block
// per 32 buckets and a range of rows; lane j takes bucket 32 * blockIdx.x
// + j and each warp one row at a time, so a row's slot limbs are read
// coalesced and exactly once (streaming loads). The block's query columns
// are staged in shared memory as [dq][32] pairs, so the probes of a warp,
// one column a lane, hit distinct banks. Past the card's shared memory
// (dq above ~900: a large query against a bank of few buckets) the
// columns are searched where they are, in L2. The binary search is
// branch-free with steps that depend on dq alone, so a warp's lanes stay
// together. Counts reduce within the warp, then one atomicAdd per warp
// and row.
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
// The batch forms serve multigather, where a block of queries meets one
// collection (its block counts, X3b counts_block, are a join in
// block_join.cu):
// - membership_bits_batch (X4b), the hand-written form of
//   `_membership_bits_packed_batch`: membership_bits over a query axis,
//   with each valid bank slot's test one probe of a hash table of its
//   query in place of a binary search. The search's ~8 steps along a
//   column strided by B were each a dependent load of a 32-byte L2 sector
//   of its own, then a lo-limb load and an inv load. membership_table_kernel
//   builds, once a launch, one table a query from what the planes and inv
//   encode: each valid query slot (k2 < qcnt[q, b]) whose inverse-map
//   entry j is a bit of the words (0 <= j < 32 W) inserts its (hi, lo)
//   value as a 64-bit key, j as its payload. Open addressing, linear
//   probing by groups of four keys (one 32-byte sector), at most 2/5 full,
//   the home group from the high bits of the key times a 64-bit odd
//   constant (a scaled sketch's hashes have zero top bits, and the bucket
//   took the low ones); the payloads sit in an array of their own, read
//   only on a hit, so the hot part of a ~600 k-hash query's table is 12 MB
//   and fits the 50 MB L2 while that query's blocks run (blockIdx.y = q is
//   the slow grid axis). membership_probe_kernel keeps X4's row side and
//   output side: one block per (selected row, query), adjacent threads on
//   adjacent buckets (cnt bytes and slot limbs read streaming, so they do
//   not push the table out of L2), the row's words built in shared memory
//   and written once. A thread owns eight buckets and takes their valid
//   slots four at a time, level-major, four look-ups in flight. A query
//   with no entry skips its rows' walk. Past the block's shared memory the
//   bits go to the zeroed output by atomicOr, as X4's do. What bounds it
//   on the H100 (chip_smoke phase 2 times the probe kernel by input;
//   PERF.md): the walk itself (its instructions and dependent loads, a
//   warp waiting on its lane with the longest list), then the row reads
//   and the output write; the table's size moves it little while its hot
//   part fits L2, and 16-byte key-and-payload slots (24 MB tables) made it
//   slower. Walking level by level, groups of two keys, three blocks an
//   SM, a software-pipelined walk, rows staged in shared memory by
//   cp.async, a warp queue in shared memory and four buckets a list were
//   each no faster.
// - round_dec_batch (X5b), the decrement inside
//   `sourmash_tpu/index/flat.py:_schedule_scan_batch`: out[q, r] =
//   sum_w popc(M[q, r, w] & rm[q, w]), one block per (row, query), so a
//   round of the whole query block is one launch.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 8;          // subject slots per bucket
constexpr int kThreads = 256;  // threads per block
constexpr int kMemThreads = 1024;  // membership_bits: threads per row

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

constexpr int kCountBuckets = 32;  // counts_rows: buckets per block, one a lane
constexpr int kCountWarps = kThreads / 32;
constexpr uint64_t kPadPair = ~0ULL;  // (PAD, PAD)

__device__ __forceinline__ uint64_t limb_pair(uint32_t hi, uint32_t lo) {
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// The first position of an ascending column of n pairs, col(i), whose pair
// is >= v (n if none), by a branch-free binary search whose steps depend
// on n alone.
template <typename Col>
__device__ __forceinline__ int lower_bound(const Col& col, int n, uint64_t v) {
  if (n == 0) return 0;
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = col(base + half) < v ? base + half : base;
    n -= half;
  }
  return base + (col(base) < v ? 1 : 0);
}

template <bool kCut, bool kShared>
__global__ void __launch_bounds__(kThreads)
counts_rows_kernel(const uint32_t* __restrict__ qhi,
                   const uint32_t* __restrict__ qlo, int dq, int B,
                   const uint32_t* __restrict__ shi,
                   const uint32_t* __restrict__ slo, int rows, int rows_per_block,
                   const uint32_t* __restrict__ cut_hi,
                   const uint32_t* __restrict__ cut_lo,
                   int32_t* __restrict__ out) {
  extern __shared__ uint64_t qcol[];  // kShared: [dq][kCountBuckets] query pairs
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCountBuckets + lane;
  const bool in_b = b < B;
  if (kShared) {
    for (int i = threadIdx.x; i < dq * kCountBuckets; i += kThreads) {
      const int bb = blockIdx.x * kCountBuckets + i % kCountBuckets;
      const size_t at = (size_t)(i / kCountBuckets) * B + bb;
      qcol[i] = bb < B ? limb_pair(qhi[at], qlo[at]) : kPadPair;
    }
    __syncthreads();
  }
  const auto col = [&](int i) -> uint64_t {
    if (kShared) return qcol[i * kCountBuckets + lane];
    const size_t at = (size_t)i * B + b;
    return limb_pair(__ldg(qhi + at), __ldg(qlo + at));
  };
  const int n = in_b ? dq : 0;
  const int pad_run = n - lower_bound(col, n, kPadPair);

  const int row0 = static_cast<int>(blockIdx.y) * rows_per_block;
  const int row_end = min(rows, row0 + rows_per_block);
  for (int r = row0 + static_cast<int>(threadIdx.x >> 5); r < row_end; r += kCountWarps) {
    int count = 0;
    if (in_b) {
      const size_t base = (size_t)r * kD * B + b;
      uint64_t v[kD];
#pragma unroll
      for (int k = 0; k < kD; k++)
        v[k] = limb_pair(__ldcs(shi + base + (size_t)k * B), __ldcs(slo + base + (size_t)k * B));
      const uint64_t cut = kCut ? limb_pair(cut_hi[r], cut_lo[r]) : kPadPair;
#pragma unroll
      for (int k = 0; k < kD; k++) {
        if (v[k] == kPadPair) {
          count += cut == kPadPair ? pad_run : 0;
        } else if (v[k] <= cut) {
          for (int p = lower_bound(col, n, v[k]); p < n && col(p) == v[k]; p++) count++;
        }
      }
    }
    const int c = warp_sum(count);
    if (lane == 0 && c != 0) atomicAdd(out + r, c);
  }
}

// Set, in the row's W words `bits` (shared memory or the zeroed output),
// the bit of every query hash that sits in a valid slot of the row: the
// body of membership_bits.
__device__ __forceinline__ void row_membership(const uint32_t* __restrict__ qhi,
                                               const uint32_t* __restrict__ qlo,
                                               const int32_t* __restrict__ qcnt, int B,
                                               const uint8_t* __restrict__ cnt,
                                               const uint32_t* __restrict__ rh,
                                               const uint32_t* __restrict__ rl,
                                               const int32_t* __restrict__ inv, int W,
                                               uint32_t* bits) {
  const long long nbits = 32LL * W;
  for (int b = threadIdx.x; b < B; b += kMemThreads) {
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
  row_membership(qhi, qlo, qcnt, B, scnt + s * B, shi + s * kD * B, slo + s * kD * B, inv, W,
                 bits);
  if (kShared) {
    __syncthreads();
    for (int w = t; w < W; w += kMemThreads) dst[w] = row_bits[w];
  }
}

// membership_bits_batch's table of query q: keys [groups, kGroup] (the PAD
// pair, never a valid bank slot's value, where no entry is), payloads
// [groups, kGroup] alongside; filled[q] != 0 once an entry went in.
constexpr int kGroup = 4;              // keys a group: one 32-byte sector
constexpr int kBuildThreads = 256;
constexpr int kProbeThreads = 512;     // membership_bits_batch: threads per (row, query)
constexpr int kProbeUnroll = 4;        // look-ups a thread has in flight
constexpr int kChunk = 8;              // buckets a thread owns at a time
constexpr uint64_t kLevels = 0x0101010101010101ULL;  // bit 8 k at every level k < kD

__device__ __forceinline__ uint32_t table_home(uint64_t key, uint32_t groups) {
  return __umulhi(static_cast<uint32_t>((key * 0x9E3779B97F4A7C15ULL) >> 32), groups);
}

__device__ __forceinline__ uint32_t next_group(uint32_t g, uint32_t groups) {
  return g + 1 == groups ? 0u : g + 1;
}

// key `half` (0 or 1) of two packed in a 16-byte load of a group
__device__ __forceinline__ uint64_t key_at(const uint4& v, int half) {
  return half ? limb_pair(v.w, v.z) : limb_pair(v.y, v.x);
}

// One thread per query slot position i = k2 * B + b of query blockIdx.y:
// a valid slot whose inverse-map entry is a bit of the words inserts its
// value with that bit as payload. A group fills slot by slot (a CAS moves
// on only past a taken slot), so its taken slots are a prefix; a repeated
// value keeps its first entry.
__global__ void __launch_bounds__(kBuildThreads)
membership_table_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                        const int32_t* __restrict__ qcnt, int dq, int B,
                        const int32_t* __restrict__ inv, long long nbits, uint32_t groups,
                        unsigned long long* __restrict__ keys, int32_t* __restrict__ payload,
                        int32_t* __restrict__ filled) {
  const size_t q = blockIdx.y;
  const int n = dq * B;
  const int i = blockIdx.x * kBuildThreads + threadIdx.x;
  bool inserted = false;
  if (i < n && i / B < qcnt[q * B + i % B]) {
    const size_t at = q * n + i;
    const int j = inv[at];
    const uint64_t key = limb_pair(qhi[at], qlo[at]);
    if (j >= 0 && j < nbits && key != kPadPair) {
      unsigned long long* kq = keys + q * groups * kGroup;
      for (uint32_t g = table_home(key, groups); !inserted; g = next_group(g, groups)) {
        // the group as L2 holds it now; a CAS only on a slot seen free
        const uint4 a = __ldcg(reinterpret_cast<const uint4*>(kq) + 2 * (size_t)g);
        const uint4 c = __ldcg(reinterpret_cast<const uint4*>(kq) + 2 * (size_t)g + 1);
        uint64_t seen[kGroup] = {key_at(a, 0), key_at(a, 1), key_at(c, 0), key_at(c, 1)};
        for (int s = 0; s < kGroup && !inserted; s++) {
          const size_t slot = (size_t)g * kGroup + s;
          if (seen[s] == kPadPair) seen[s] = atomicCAS(kq + slot, kPadPair, key);
          if (seen[s] == kPadPair) payload[q * groups * kGroup + slot] = j;
          inserted = seen[s] == kPadPair || seen[s] == key;
        }
      }
    }
  }
  if (__syncthreads_or(inserted) && threadIdx.x == 0) filled[q] = 1;
}

// Block (x, y) builds the words of selection x of query y, out [bq, cap,
// W]: every valid slot of the row probes query y's table; a hit's payload
// is its bit. A thread owns kChunk buckets b0 + u * kProbeThreads and takes
// their valid slots kProbeUnroll at a time, level-major (slot level k of
// every owned bucket before level k + 1).
template <bool kShared>
__global__ void __launch_bounds__(kProbeThreads, 2)
membership_probe_kernel(const unsigned long long* __restrict__ keys,
                        const int32_t* __restrict__ payload,
                        const int32_t* __restrict__ filled, uint32_t groups, int B,
                        const uint32_t* __restrict__ shi, const uint32_t* __restrict__ slo,
                        const uint8_t* __restrict__ scnt, const int64_t* __restrict__ sel,
                        int cap, int W, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t row_bits[];  // kShared: the row's W words
  const int t = threadIdx.x;
  const size_t q = blockIdx.y;
  uint32_t* dst = out + (q * cap + blockIdx.x) * (size_t)W;
  uint32_t* bits = kShared ? row_bits : dst;
  if (kShared) {
    for (int w = t; w < W; w += kProbeThreads) row_bits[w] = 0u;
    __syncthreads();
  }
  if (filled[q]) {
    const size_t s = (size_t)sel[q * cap + blockIdx.x];
    const uint8_t* cnt = scnt + s * B;
    const uint32_t* rh = shi + s * kD * B;
    const uint32_t* rl = slo + s * kD * B;
    const uint4* kq = reinterpret_cast<const uint4*>(keys + q * groups * kGroup);
    const int32_t* pq = payload + q * groups * kGroup;
    constexpr int U = kProbeUnroll;
    for (int b0 = t; b0 < B; b0 += kProbeThreads * kChunk) {
      // bit 8 k + u: bucket u of the chunk holds a valid slot at level k
      uint64_t slots = 0;
#pragma unroll
      for (int u = 0; u < kChunk; u++) {
        const int b = b0 + u * kProbeThreads;
        const int c = b < B ? min(static_cast<int>(__ldcs(cnt + b)), kD) : 0;
        slots |= (c ? kLevels >> (8 * (kD - c)) : 0ULL) << u;
      }
      while (slots) {
        uint64_t key[U];
        uint32_t g[U];
        uint4 lo[U], hi[U];  // the group's keys 0-1 and 2-3
        bool live[U];
        int hit[U];
#pragma unroll
        for (int v = 0; v < U; v++) {
          hit[v] = -1;
          key[v] = kPadPair;
          if (slots) {
            const int at = __ffsll(static_cast<long long>(slots)) - 1;
            slots &= slots - 1;
            const size_t i = (size_t)(at >> 3) * B + b0 + (at & 7) * kProbeThreads;
            key[v] = limb_pair(__ldcs(rh + i), __ldcs(rl + i));
          }
        }
#pragma unroll
        for (int v = 0; v < U; v++) {
          live[v] = key[v] != kPadPair;
          if (live[v]) {
            g[v] = table_home(key[v], groups);
            lo[v] = __ldg(kq + 2 * (size_t)g[v]);
            hi[v] = __ldg(kq + 2 * (size_t)g[v] + 1);
          }
        }
        // walk on where a group is full without the key; a group with a
        // free slot ends the walk
        for (bool more = true; more;) {
          more = false;
#pragma unroll
          for (int v = 0; v < U; v++) {
            if (!live[v]) continue;
            const int at = key_at(lo[v], 0) == key[v]   ? 0
                           : key_at(lo[v], 1) == key[v] ? 1
                           : key_at(hi[v], 0) == key[v] ? 2
                           : key_at(hi[v], 1) == key[v] ? 3
                                                        : -1;
            if (at >= 0) {
              hit[v] = static_cast<int>(g[v]) * kGroup + at;
              live[v] = false;
            } else if (key_at(hi[v], 1) == kPadPair) {
              live[v] = false;
            } else {
              g[v] = next_group(g[v], groups);
              lo[v] = __ldg(kq + 2 * (size_t)g[v]);
              hi[v] = __ldg(kq + 2 * (size_t)g[v] + 1);
              more = true;
            }
          }
        }
        int j[U];
#pragma unroll
        for (int v = 0; v < U; v++) j[v] = hit[v] >= 0 ? __ldg(pq + hit[v]) : -1;
#pragma unroll
        for (int v = 0; v < U; v++)
          if (j[v] >= 0) atomicOr(bits + (j[v] >> 5), 1u << (j[v] & 31));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int w = t; w < W; w += kProbeThreads) __stcs(dst + w, row_bits[w]);
  }
}

// sum_w popc(m[w] & rm[w]) over the block, returned to thread 0.
__device__ __forceinline__ int block_popc_and(const uint32_t* __restrict__ m,
                                              const uint32_t* __restrict__ rm, int W) {
  __shared__ int partial[kThreads / 32];
  int acc = 0;
  for (int w = threadIdx.x; w < W; w += kThreads) acc += __popc(m[w] & __ldg(rm + w));
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  int v = 0;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0;
    v = warp_sum(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
round_dec_kernel(const uint32_t* __restrict__ M, const uint32_t* __restrict__ rm,
                 int W, int32_t* __restrict__ out) {
  const size_t row = blockIdx.x;
  const int v = block_popc_and(M + row * (size_t)W, rm, W);
  if (threadIdx.x == 0) out[row] = v;
}

// round_dec over a query axis: block (r, q) reduces row r of query q's
// matrix M [Q, k, W] against rm [Q, W] into out [Q, k].
__global__ void __launch_bounds__(kThreads)
round_dec_batch_kernel(const uint32_t* __restrict__ M, const uint32_t* __restrict__ rm,
                       int k, int W, int32_t* __restrict__ out) {
  const size_t row = (size_t)blockIdx.y * k + blockIdx.x;
  const int v = block_popc_and(M + row * (size_t)W, rm + (size_t)blockIdx.y * W, W);
  if (threadIdx.x == 0) out[row] = v;
}

}  // namespace

extern "C" {

const char* gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [rows] i32 (zeroed by the caller) += raw limb-pair matches of the
// query planes [dq, B] (each column ascending) against subject planes
// [rows, 8, B]; with cut_hi and cut_lo [rows] (both or neither), only
// query pairs <= the row's cut.
int gm_counts_rows(const void* qhi, const void* qlo, int dq, int B,
                   const void* shi, const void* slo, int rows,
                   const void* cut_hi, const void* cut_lo, void* out,
                   void* stream) {
  if (rows <= 0 || B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint64_t) * kCountBuckets * (size_t)dq;
  const bool shared = smem <= (size_t)smem_max;
  const bool cut = cut_hi != nullptr;
  auto kernel = cut ? (shared ? counts_rows_kernel<true, true> : counts_rows_kernel<true, false>)
                    : (shared ? counts_rows_kernel<false, true> : counts_rows_kernel<false, false>);
  if (shared) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // rows per block: up to 256 (the staged columns then cost ~10 % of the
  // block's row reads), fewer where that leaves under ~16 blocks an SM
  const int tiles = (B + kCountBuckets - 1) / kCountBuckets;
  int rows_per_block = 256;
  while (rows_per_block > kCountWarps &&
         (long long)tiles * ((rows + rows_per_block - 1) / rows_per_block) < 16LL * sms)
    rows_per_block /= 2;
  while ((rows + rows_per_block - 1) / rows_per_block > 65535) rows_per_block *= 2;
  dim3 grid(tiles, (rows + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kThreads, shared ? smem : 0, s>>>(
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo), dq, B,
      static_cast<const uint32_t*>(shi), static_cast<const uint32_t*>(slo), rows,
      rows_per_block, static_cast<const uint32_t*>(cut_hi),
      static_cast<const uint32_t*>(cut_lo), static_cast<int32_t*>(out));
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

// out [bq, cap, W] u32 membership words: for each query q, rows sel[q]
// [cap] (i64) of one chunk's planes [rows, 8, B] / cnt [rows, B] u8,
// against query planes qhi/qlo[q] [dq, B] with occupancy qcnt[q] [B] i32
// and inverse slot map inv[q] [dq * B] i32 (dq * B < 2^31). `table`:
// scratch for bq tables of `groups` groups each (4 * groups > the entries
// of any query; groups < 2^29): keys [bq, groups, 4] u64, then payloads
// [bq, groups, 4] i32, then filled flags [bq] i32, bq * (48 * groups + 4)
// bytes. Three steps on the stream: the tables cleared, built, probed.
int gm_membership_bits_batch(const void* qhi, const void* qlo, const void* qcnt, int bq,
                             int dq, int B, const void* shi, const void* slo,
                             const void* scnt, const void* sel, int cap, const void* inv,
                             int W, void* table, int groups, void* out, void* stream) {
  if (bq <= 0 || cap <= 0 || W <= 0) return 0;
  if (bq > 65535 || groups <= 0 || groups >= (1 << 29))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * (size_t)W;
  const bool shared = smem <= (size_t)smem_max;
  if (shared) {
    err = cudaFuncSetAttribute(membership_probe_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  } else {
    err = cudaMemsetAsync(out, 0, smem * (size_t)cap * bq, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t entries = (size_t)bq * groups * kGroup;
  auto* keys = static_cast<unsigned long long*>(table);
  auto* payload = reinterpret_cast<int32_t*>(keys + entries);
  int32_t* filled = payload + entries;
  err = cudaMemsetAsync(keys, 0xFF, sizeof(unsigned long long) * entries, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(filled, 0, sizeof(int32_t) * bq, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = dq * B;
  if (n > 0) {
    membership_table_kernel<<<dim3((unsigned)((n + kBuildThreads - 1) / kBuildThreads),
                                   (unsigned)bq), kBuildThreads, 0, st>>>(
        static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo),
        static_cast<const int32_t*>(qcnt), dq, B, static_cast<const int32_t*>(inv),
        32LL * W, (uint32_t)groups, keys, payload, filled);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = shared ? membership_probe_kernel<true> : membership_probe_kernel<false>;
  kernel<<<dim3((unsigned)cap, (unsigned)bq), kProbeThreads, shared ? smem : 0, st>>>(
      keys, payload, filled, (uint32_t)groups, B, static_cast<const uint32_t*>(shi),
      static_cast<const uint32_t*>(slo), static_cast<const uint8_t*>(scnt),
      static_cast<const int64_t*>(sel), cap, W, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [Q, k] i32 = per-row popcount of M [Q, k, W] & rm [Q, W].
int gm_round_dec_batch(const void* M, const void* rm, int Q, int k, int W, void* out,
                       void* stream) {
  if (Q <= 0 || k <= 0) return 0;
  if (Q > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  round_dec_batch_kernel<<<dim3((unsigned)k, (unsigned)Q), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(M), static_cast<const uint32_t*>(rm), k, W,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
