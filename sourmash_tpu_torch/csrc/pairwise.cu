// Hand-written Hopper (sm_90a) kernel for compare's all-pairs matrices, as a
// hash join per tile of adjacent buckets: the stored-element intersection
// count of every pair of a bank's rows (pairwise_counts), and the sum of
// abundance products over every pair's shared hashes (pairwise_products).
//
// Replaces, over all rows of one bank at once:
// - pairwise_counts: `sourmash_tpu/ops/bucketed.py:_counts_block_impl`
//   with every row as the query block, as `pairwise_counts_bucketed` drives
//   it (X3b at compare's shape), PAD correction included;
// - pairwise_products: `sourmash_tpu/ops/bucketed.py:_products_block_impl`
//   over all rows, as `pairwise_weighted_products` drives it (X6).
// Both broadcast each query row against every row: ~16 G slot compares a
// 2,000-sketch matrix. A join reads each valid slot once and visits each
// shared hash once, as a sparse product does: ~36 M pair increments for
// that matrix. (block_join.cu joins a block of queries against a chunk's
// rows with the same table, join_common.cuh.)
//
// Layout: planes hi, lo [rows, d, B] of u32 limbs (int32 bit patterns from
// torch), abundances av [rows, d, B] int32 for the products, occupancy
// cnt [rows, B] u8, which the kernel takes transposed (cnt_t [B, rows]: a
// tile's occupancies are one run of bytes). Slot k of bucket b of row r is
// valid iff k < min(cnt[r, b], d); validity comes from cnt alone (the
// counts bank holds PAD past the occupancy, the weighted planes zeros, and
// 2^64-1 is a valid hash in the weighted planes). Preconditions, as every
// pack of the port gives them: the valid slots of a row hold distinct
// values, and a value sits in bucket value & (B - 1). So two equal hashes
// fall in the same bucket, and a join inside each bucket is exact.
//
// Design: one block per tile of 2^tile_log2 adjacent buckets (B >= 2 tiles;
// the wrapper picks the width from the buckets' loads so that two blocks
// share an SM). The block reads the tile's occupancy bytes of every row
// (adjacent in cnt_t) and, for each valid slot (slot k of a row for
// adjacent buckets is one run of bytes, so the reads come in whole or
// partial sectors), inserts its value into a hash table in shared memory:
// open addressing with linear probing, a 64-bit atomicCAS claiming a slot
// (empty: a value of a bucket outside the tile, which no valid slot
// holds), and the slot's list of entries (row[, abundance]) grown by one
// atomicExch on its head. An
// entry's place comes from one shared atomicAdd a warp, after a warp scan.
// Then each entry walks the entries after it in its value's list: a value
// held by g rows adds 1 (or a_i * a_j) to the cell [min, max] of each of
// its g (g - 1) / 2 pairs by atomicAdd into the [rows, rows] output in
// device memory (16.8 MB int32 or 33.5 MB int64 at 2,048 rows: L2-
// resident). The diagonal (each slot with itself) is summed over a row's
// lanes at insertion and added once a row and tile. The wrapper zeroes the
// output and mirrors the upper triangle. Integer sums are exact in any
// order of the atomics.
//
// Any load is right: a tile whose entries exceed shared memory (a bucket
// loaded across many rows, up to rows * d entries) runs the same table on
// a scratch area in global memory that the wrapper allocates; meta[t] =
// (entries, entry offset or -1 for shared memory, table offset).
// __syncthreads orders the block's global accesses as it does its shared
// ones, and the atomics act in L2.
//
// Bound: bytes, reading the occupancies and the valid slots once (8 bytes
// a slot, 12 with its abundance) and writing the output once; the pair
// increments (sum over values of g (g - 1) / 2 atomics, and one a row and
// tile for the diagonal) go to L2, whose atomic rate is not in the bound
// model. The table groups equal values in one insertion an entry; a sort
// of each tile's entries would take ~log2(n)^2 / 2 passes, each ending in
// a barrier, and took twice the time of the whole table kernel when
// measured (PERF.md, PR 12).

#include <cuda_runtime.h>

#include <cstdint>

#include "join_common.cuh"

namespace {

using join::kFull;
using join::Table;

constexpr int kThreads = 512;  // a join block; two share an SM

// Insert the valid slots of buckets [b0, b0 + 2^tile_log2) of every row
// into the table; *fill counts the entries. Each slot's pair with itself
// (1, or a^2) is summed over the row's lanes (adjacent: a row's buckets of
// the tile) and added to the diagonal once.
template <bool kWeighted>
__device__ __forceinline__ void insert(const uint32_t* __restrict__ hi,
                                       const uint32_t* __restrict__ lo,
                                       const int32_t* __restrict__ av,
                                       const uint8_t* __restrict__ cnt_t, int rows, int d,
                                       int B, int b0, int tile_log2, Table t, int slots,
                                       unsigned long long empty, int* fill, void* out) {
  const int mask = (1 << tile_log2) - 1;
  const int pairs = rows << tile_log2;  // (row, bucket) pairs of the tile
  for (int base = 0; base < pairs; base += kThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    int r = 0, b = 0, c = 0;
    if (i < pairs) {
      r = i >> tile_log2;
      b = b0 + (i & mask);
      c = min(static_cast<int>(cnt_t[(size_t)b * rows + r]), d);
    }
    const int at = join::warp_alloc(c, fill);
    long long self = kWeighted ? 0 : c;
    for (int k = 0; k < c; k++) {
      const size_t src = ((size_t)r * d + k) * B + b;
      const int s = join::claim(t, slots, empty, join::load_value(hi, lo, src));
      const int e = at + k;
      t.row[e] = r;
      if (kWeighted) {
        const int32_t a = __ldg(av + src);
        t.ab[e] = a;
        self += static_cast<long long>(a) * a;
      }
      join::link(t, s, e);
    }
    for (int o = 1; o <= mask; o <<= 1) self += __shfl_xor_sync(kFull, self, o);
    if ((i & mask) == 0 && self != 0) {
      const size_t cell = (size_t)r * rows + r;
      if (kWeighted)
        atomicAdd(static_cast<unsigned long long*>(out) + cell,
                  static_cast<unsigned long long>(self));
      else
        atomicAdd(static_cast<int*>(out) + cell, static_cast<int>(self));
    }
  }
}

// Each of n entries adds its pairs with the entries after it in its
// value's list (the entries inserted before it).
template <bool kWeighted>
__device__ __forceinline__ void walk(Table t, int n, int rows, void* out) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ri = t.row[i];
    const long long a = kWeighted ? t.ab[i] : 0;
    for (int j = t.next[i]; j >= 0; j = t.next[j]) {
      const int rj = t.row[j];
      const size_t cell = static_cast<size_t>(min(ri, rj)) * rows + max(ri, rj);
      if (kWeighted) {
        const long long prod = a * t.ab[j];
        if (prod != 0)
          atomicAdd(static_cast<unsigned long long*>(out) + cell,
                    static_cast<unsigned long long>(prod));
      } else {
        atomicAdd(static_cast<int*>(out) + cell, 1);
      }
    }
  }
}

// out [rows, rows] (int32, or int64 weighted; zeroed by the caller) +=
// the upper triangle of the tiles' joins: grid (B >> tile_log2 tiles),
// tables as join_common.cuh lays them out.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_join_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
                     const int32_t* __restrict__ av, const uint8_t* __restrict__ cnt_t,
                     int rows, int d, int B, int tile_log2,
                     const long long* __restrict__ meta, unsigned long long* g_key,
                     int* g_head, int* g_next, int* g_row, int32_t* g_ab, int cap, void* out) {
  extern __shared__ unsigned long long smem[];
  __shared__ int fill;
  if (threadIdx.x == 0) fill = 0;
  join::with_tile_table<kWeighted>(meta, smem, cap, g_key, g_head, g_next, g_row, g_ab,
                                   [&](int n, Table t) {
    const int b0 = blockIdx.x << tile_log2;
    const int slots = join::table_slots(n);
    const unsigned long long empty = join::empty_mark(b0, tile_log2, B);
    join::clear(t, slots, empty);
    __syncthreads();
    insert<kWeighted>(hi, lo, av, cnt_t, rows, d, B, b0, tile_log2, t, slots, empty, &fill, out);
    __syncthreads();
    walk<kWeighted>(t, fill, rows, out);
  });
}

}  // namespace

extern "C" {

const char* pw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most entries a tile may hold in shared memory when `blocks` blocks
// share an SM (1: the opt-in maximum of one block).
int pw_join_capacity(int weighted, int blocks, int* cap) {
  return join::capacity(weighted != 0, blocks, 0, cap);
}

// out [rows, rows] (int32; int64 where av is given; zeroed by the caller)
// += for each pair of rows r <= s the count (or sum of abundance
// products) of the values their valid slots share, in cell [r, s]: planes
// hi, lo (, av) [rows, d, B], occupancy cnt_t [B, rows] u8 (transposed), tiles of
// 2^tile_log2 buckets (B >= 2 tiles), meta [B >> tile_log2, 3] i64: a
// tile's entries, its entry offset in the global scratch g_next, g_row,
// g_ab i32 (-1: the tile has cap or fewer entries and works in shared
// memory) and its table offset in g_key u64, g_head i32.
int pw_join(const void* hi, const void* lo, const void* av, const void* cnt_t, int rows, int d,
            int B, int tile_log2, const void* meta, void* g_key, void* g_head, void* g_next,
            void* g_row, void* g_ab, int cap, void* out, void* stream) {
  if (rows <= 0 || d <= 0 || B <= 0) return 0;
  if (tile_log2 < 0 || tile_log2 > 4 || B < (2 << tile_log2) || (B & (B - 1)) || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool weighted = av != nullptr;
  const size_t smem = join::smem_bytes(cap, weighted);
  auto kernel = weighted ? pairwise_join_kernel<true> : pairwise_join_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B >> tile_log2;
  kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(av), static_cast<const uint8_t*>(cnt_t), rows, d, B, tile_log2,
      static_cast<const long long*>(meta), static_cast<unsigned long long*>(g_key),
      static_cast<int*>(g_head), static_cast<int*>(g_next), static_cast<int*>(g_row),
      static_cast<int32_t*>(g_ab), cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
