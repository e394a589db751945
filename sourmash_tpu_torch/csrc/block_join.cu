// Hand-written Hopper (sm_90a) kernel for a block of queries against a
// chunk's rows, as a hash join per tile of adjacent buckets: the exact
// stored-element intersection count of every (query, row) pair
// (counts_block), and the sum of abundance products over every pair's
// shared hashes (products_block). One kernel, templated on weighted.
//
// Replaces:
// - counts_block (X3b): `sourmash_tpu/ops/bucketed.py:_counts_block_impl`
//   (:619), the broadcast compare of a query block [bq, dq, B] against a
//   chunk [rows, 8, B] minus its PAD==PAD correction, as
//   `counts_block_dispatch` (:650) drives it for multigather, and with a
//   bank's own rows as the query block for compare's block route;
// - products_block (X6, block route): `sourmash_tpu/ops/bucketed.py:
//   _products_block_impl` (:1025) on `_pack_weighted`'s planes.
// The port's first kernels for both searched every row slot in every
// staged query column of its bucket (~16 searches a row slot at
// multigather's block of 16): instruction issue, 7 % of its bound, 8.2x
// behind torch.sparse.mm (PERF.md). A join visits each shared hash once,
// as a sparse product does.
//
// out[q, r] is the count, or the sum of Qav * Sav, over the pairs (valid
// slot of query q, valid slot of row r) of one bucket that hold the same
// (hi, lo) pair. Slot k of bucket b is valid iff k < min(cnt[., b],
// depth): Qcnt [bq, B] (int32 for the counts, uint8 weighted) and Scnt
// [rows, B] uint8. So the counts are exact, with no PAD correction. A
// value held by several slots of either side counts once a slot, as the
// broadcast compare counts it (a chained table gives this for free).
// Precondition, as every pack of the port gives it: a valid value sits in
// bucket value & (B - 1). The join needs no column order.
//
// Layout: planes hi, lo [n, depth, B] of u32 limbs (int32 bit patterns
// from torch), abundances [n, depth, B] int32, for both sides.
//
// Design: one block per tile of 2^tile_log2 adjacent buckets (B >= 2
// tiles), one block of 1024 threads an SM. The block inserts the query
// block's valid slots of its buckets into a hash table (join_common.cuh:
// a value's list of (query[, abundance]) entries) and a 16 KB bit filter
// (two bits a value, in one word), a thread a (query, slot, bucket), so a
// bucket of hundreds of one query's hashes does not run on one thread; a
// tile with no query entry returns at once. Then it streams every row's
// valid slots of those buckets through the filter, and those it passes
// through the table: each probe finds its value (or the empty mark) and
// walks the value's list, adding 1, or qa * sa, to out[q, r] by a 32-bit
// or 64-bit atomicAdd (the output, 512 KB at [16, 8192] int32, stays in
// L2). Integer sums are exact in any order of the atomics. The table
// holds the query side only, so the wrapper plans the tiles from the
// block's per-bucket query loads (the host's, for multigather: no
// readback), the widest that one block holds; a tile past one block's
// shared memory works in a global scratch.
//
// Bound: bytes, reading each side's occupancy and valid slots once (8
// bytes a slot, 12 with its abundance) and writing the output once; the
// atomics (one a matching slot pair: the sum of the output, for the
// counts) go to L2, whose atomic rate is not in the bound model. Where
// the time goes instead, and what the design does about it (PERF.md):
// - Row reads: slot k of a row is one run of 4 * 2^tile_log2 bytes of each
//   limb plane for the tile's buckets ([rows, d, B] layout), read whole if
//   any of its buckets holds a slot k; at tiles under 8 buckets a read
//   pulls a whole 32-byte sector. So the widest tiles: one block an SM
//   holds twice the entries two do.
// - Memory latency: a thread keeps one bucket and takes kUnroll rows a
//   round, reads their occupancies at once, then slot level by slot level
//   (every row's slot k at once), so a round waits on one latency a level,
//   ~6 at a mean load of 1.3, not one a slot.
// - Misses: most row slots share no hash with the block, and an absent
//   value walks ~5 table slots at the table's 2/3 load, the warp waiting
//   on its longest walk; the filter turns most of them away with one
//   shared read.
// - Occupancy reads: Scnt [rows, B] is read 2^tile_log2 bytes a row, strided
//   by B, and the tiles that run together share its sectors in L2. For the
//   counts bank a PAD slot is never valid, so the slots up to the first
//   PAD could stand in for Scnt, at one more slot level a round: that
//   measured slower (PERF.md), and the weighted planes hold 2^64-1 as a
//   valid hash, so both read the occupancy.
// - A query block much larger than the rows (a metagenome block against a
//   bank of B = 128) puts tens of thousands of entries in each tile's
//   table, in global memory: the insert's L2 atomics then cost most.
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// The entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "join_common.cuh"

namespace {

using join::Table;

// One block of 1024 threads an SM (32 warps): the table gets the whole of
// the SM's shared memory, so tiles are twice as wide as at two blocks of
// 512 (phase 8's block: tiles of 8 buckets, a row's slot one 32-byte
// sector of each limb plane).
constexpr int kThreads = 1024;
constexpr int kUnroll = 8;        // rows a thread takes a round of the probe
constexpr int kInsertUnroll = 4;  // query slots a thread reads at once
constexpr int kFilterWords = 4096;  // the tile's bit filter: 16 KB

// The filter word and its two bits of value v: from the low half of the
// high word of the table's multiplicative hash (its slot comes from the
// top bits), so both depend on every bit of v.
__device__ __forceinline__ void filter_bits(unsigned long long v, int* word, unsigned* bits) {
  const unsigned g = static_cast<unsigned>((v * 0x9E3779B97F4A7C15ull) >> 32);
  *word = static_cast<int>((g >> 10) & (kFilterWords - 1));
  *bits = (1u << (g & 31)) | (1u << ((g >> 5) & 31));
}

// Insert the valid slots of buckets [b0, b0 + 2^tile_log2) of every query
// of the block into the table and the filter; *fill counts the entries.
// A thread takes one (query, slot, bucket) of the tile at a time, so a
// bucket loaded with hundreds of one query's hashes spreads over as many
// threads, and the reads of slot k of a query are one run of the tile's
// buckets; each thread reads kInsertUnroll slots' occupancy and value at once
// (the value whether valid or not: it lies inside the planes) before it
// inserts them. Entries past the plan's n for the tile are dropped, never
// written (a plan is made from the same loads, so none are).
template <bool kWeighted>
__device__ __forceinline__ void insert_queries(
    const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
    const int32_t* __restrict__ qav,
    const typename std::conditional<kWeighted, uint8_t, int32_t>::type* __restrict__ qcnt,
    int bq, int dq, int B, int b0, int tile_log2, Table t, int n, int slots,
    unsigned long long empty, unsigned* filter, int* fill) {
  const int mask = (1 << tile_log2) - 1;
  const int b = b0 + (static_cast<int>(threadIdx.x) & mask);  // kThreads is a multiple of 16
  const int total = (bq * dq) << tile_log2;  // (query, slot, bucket) of the tile
  for (int base = 0; base < total; base += kThreads * kInsertUnroll) {
    int q[kInsertUnroll], valid[kInsertUnroll];
    unsigned long long v[kInsertUnroll];
    int32_t a[kInsertUnroll];
#pragma unroll
    for (int u = 0; u < kInsertUnroll; u++) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      const int qk = i >> tile_log2;  // q * dq + k
      q[u] = qk / dq;
      valid[u] = 0;
      if (i < total) {
        const size_t src = (size_t)qk * B + b;
        valid[u] = qk - q[u] * dq < static_cast<int>(__ldg(qcnt + (size_t)q[u] * B + b));
        v[u] = join::load_value(qhi, qlo, src);
        if (kWeighted) a[u] = __ldg(qav + src);
      }
    }
#pragma unroll
    for (int u = 0; u < kInsertUnroll; u++) {
      const int e = join::warp_alloc(valid[u], fill);
      if (valid[u] && e < n) {
        int word;
        unsigned bits;
        filter_bits(v[u], &word, &bits);
        atomicOr(filter + word, bits);
        const int s = join::claim(t, slots, empty, v[u]);
        t.row[e] = q[u];
        if (kWeighted) t.ab[e] = a[u];
        join::link(t, s, e);
      }
    }
  }
}

// Add row r's slot value v (abundance sa) to out[q, r] for every query
// entry of v in the table; a value the filter rules out probes nothing.
template <bool kWeighted>
__device__ __forceinline__ void add_matches(Table t, int slots, unsigned long long empty,
                                            const unsigned* filter, unsigned long long v, int r,
                                            int32_t sa, int rows, void* out) {
  int word;
  unsigned bits;
  filter_bits(v, &word, &bits);
  if ((filter[word] & bits) != bits) return;
  const int s = join::find(t, slots, empty, v);
  if (s < 0) return;
  for (int e = t.head[s]; e >= 0; e = t.next[e]) {
    const size_t cell = (size_t)t.row[e] * rows + r;
    if (kWeighted) {
      const long long prod = static_cast<long long>(t.ab[e]) * sa;
      if (prod != 0)
        atomicAdd(static_cast<unsigned long long*>(out) + cell,
                  static_cast<unsigned long long>(prod));
    } else {
      atomicAdd(static_cast<int*>(out) + cell, 1);
    }
  }
}

// Stream every row's valid slots of the tile's buckets through the filter
// and the table. A thread keeps one bucket of the tile and takes kUnroll
// rows a round: their occupancies in one read each, then slot level by
// slot level, every row's slot k read together (a level ends the round
// once no lane of the warp has a slot k left), so a round waits on one
// memory latency for the occupancies and one a level, not one a slot.
template <bool kWeighted>
__device__ __forceinline__ void probe_rows(const uint32_t* __restrict__ shi,
                                           const uint32_t* __restrict__ slo,
                                           const int32_t* __restrict__ sav,
                                           const uint8_t* __restrict__ scnt, int rows, int d,
                                           int B, int b0, int tile_log2, Table t, int slots,
                                           unsigned long long empty, const unsigned* filter,
                                           void* out) {
  const int mask = (1 << tile_log2) - 1;
  const int b = b0 + (static_cast<int>(threadIdx.x) & mask);  // kThreads is a multiple of 16
  const int rstep = kThreads >> tile_log2;                     // rows a block takes a round
  for (int r0 = 0; r0 < rows; r0 += rstep * kUnroll) {
    const int r1 = r0 + (static_cast<int>(threadIdx.x) >> tile_log2);
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int r = r1 + u * rstep;
      c[u] = r < rows ? min(static_cast<int>(__ldg(scnt + (size_t)r * B + b)), d) : 0;
    }
    for (int k = 0;; k++) {
      bool more = false;
#pragma unroll
      for (int u = 0; u < kUnroll; u++) more |= k < c[u];
      if (!__any_sync(join::kFull, more)) break;
      unsigned long long v[kUnroll];
      int32_t a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        if (k < c[u]) {
          const size_t at = ((size_t)(r1 + u * rstep) * d + k) * B + b;
          v[u] = join::load_value(shi, slo, at);
          if (kWeighted) a[u] = __ldg(sav + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        if (k < c[u])
          add_matches<kWeighted>(t, slots, empty, filter, v[u], r1 + u * rstep,
                                 kWeighted ? a[u] : 0, rows, out);
      }
    }
  }
}

// out [bq, rows] (int32, or int64 weighted; zeroed by the caller) += the
// tiles' joins of the query block against the rows: grid (B >> tile_log2
// tiles). Dynamic shared memory: the filter's words, then the table as
// join_common.cuh lays it out.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, 1)
block_join_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                  const int32_t* __restrict__ qav, const void* __restrict__ qcnt, int bq, int dq,
                  const uint32_t* __restrict__ shi, const uint32_t* __restrict__ slo,
                  const int32_t* __restrict__ sav, const uint8_t* __restrict__ scnt, int rows,
                  int d, int B, int tile_log2, const long long* __restrict__ meta,
                  unsigned long long* g_key, int* g_head, int* g_next, int* g_row,
                  int32_t* g_ab, int cap, void* out) {
  using QC = typename std::conditional<kWeighted, uint8_t, int32_t>::type;
  extern __shared__ unsigned long long smem[];
  __shared__ int fill;
  unsigned* filter = reinterpret_cast<unsigned*>(smem);
  if (threadIdx.x == 0) fill = 0;
  join::with_tile_table<kWeighted>(meta, smem + kFilterWords / 2, cap, g_key, g_head, g_next,
                                   g_row, g_ab, [&](int n, Table t) {
    if (n == 0) return;  // no query entry in the tile: no row slot of it matches
    const int b0 = blockIdx.x << tile_log2;
    const int slots = join::table_slots(n);
    const unsigned long long empty = join::empty_mark(b0, tile_log2, B);
    join::clear(t, slots, empty);
    for (int w = threadIdx.x; w < kFilterWords; w += kThreads) filter[w] = 0;
    __syncthreads();
    insert_queries<kWeighted>(qhi, qlo, qav, static_cast<const QC*>(qcnt), bq, dq, B, b0,
                              tile_log2, t, n, slots, empty, filter, &fill);
    __syncthreads();
    probe_rows<kWeighted>(shi, slo, sav, scnt, rows, d, B, b0, tile_log2, t, slots, empty,
                          filter, out);
  });
}

}  // namespace

extern "C" {

const char* bj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most query entries a tile may hold in shared memory beside the
// filter, one block an SM.
int bj_join_capacity(int weighted, int* cap) {
  return join::capacity(weighted != 0, 1, 4 * kFilterWords, cap);
}

// out [bq, rows] (int32; int64 where qav and sav are given; zeroed by the
// caller) += for each query q and row r the count (or sum of abundance
// products) of the values their valid slots share: query planes qhi, qlo
// (, qav) [bq, dq, B] with occupancy qcnt [bq, B] (int32; uint8 weighted),
// row planes shi, slo (, sav) [rows, d, B] with occupancy scnt [rows, B]
// u8, tiles of 2^tile_log2 buckets (B >= 2 tiles),
// meta [B >> tile_log2, 3] i64: a tile's query entries, its entry offset
// in the global scratch g_next, g_row, g_ab i32 (-1: the tile has cap or
// fewer entries and works in shared memory) and its table offset in
// g_key u64, g_head i32.
int bj_join(const void* qhi, const void* qlo, const void* qav, const void* qcnt, int bq, int dq,
            const void* shi, const void* slo, const void* sav, const void* scnt, int rows, int d,
            int B, int tile_log2, const void* meta, void* g_key, void* g_head,
            void* g_next, void* g_row, void* g_ab, int cap, void* out, void* stream) {
  if (bq <= 0 || dq <= 0 || rows <= 0 || d <= 0 || B <= 0) return 0;
  const bool weighted = qav != nullptr;
  if (tile_log2 < 0 || tile_log2 > 4 || B < (2 << tile_log2) || (B & (B - 1)) || cap < 0 ||
      weighted != (sav != nullptr) ||
      ((long long)bq * dq << tile_log2) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * kFilterWords + join::smem_bytes(cap, weighted);
  auto kernel = weighted ? block_join_kernel<true> : block_join_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B >> tile_log2;
  kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo),
      static_cast<const int32_t*>(qav), qcnt, bq, dq, static_cast<const uint32_t*>(shi),
      static_cast<const uint32_t*>(slo), static_cast<const int32_t*>(sav),
      static_cast<const uint8_t*>(scnt), rows, d, B, tile_log2,
      static_cast<const long long*>(meta), static_cast<unsigned long long*>(g_key),
      static_cast<int*>(g_head), static_cast<int*>(g_next), static_cast<int*>(g_row),
      static_cast<int32_t*>(g_ab), cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
