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
// Both broadcast each query row against every row, and the port's block
// kernels (counts_block, products_block in gather.cu) search each row slot
// in every staged query column: ~16 G searches a 2,000-sketch matrix. A
// join reads each valid slot once and visits each shared hash once, as a
// sparse product does: ~36 M pair increments for that matrix.
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

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kJoinThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmem = 64;  // the block's fill counter, with room to spare

// a tile's hash table (values, list heads) and entries (list links, rows
// and, for the products, abundances), in shared or in global memory
struct Table {
  unsigned long long* key;
  int* head;
  int* next;
  int* row;
  int32_t* ab;
};

// table slots for n entries: a load of at most 2/3
__host__ __device__ constexpr int table_slots(int n) { return n + (n >> 1) + 1; }

__host__ __device__ constexpr size_t smem_bytes(int cap, bool weighted) {
  return (sizeof(unsigned long long) + sizeof(int)) * (size_t)table_slots(cap) +
         (2 * sizeof(int) + (weighted ? sizeof(int32_t) : 0)) * (size_t)cap;
}

// the table's first probe of value v: the high bits of a multiplicative
// hash, scaled to `slots`
__device__ __forceinline__ int first_slot(unsigned long long v, int slots) {
  const unsigned long long h = v * 0x9E3779B97F4A7C15ull;
  return static_cast<int>(__umulhi(static_cast<unsigned>(h >> 32), static_cast<unsigned>(slots)));
}

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
  const int lane = threadIdx.x & 31;
  const int mask = (1 << tile_log2) - 1;
  const int pairs = rows << tile_log2;  // (row, bucket) pairs of the tile
  for (int base = 0; base < pairs; base += kJoinThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    int r = 0, b = 0, c = 0;
    if (i < pairs) {
      r = i >> tile_log2;
      b = b0 + (i & mask);
      c = min(static_cast<int>(cnt_t[(size_t)b * rows + r]), d);
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int at = 0;
    if (lane == 31 && total) at = atomicAdd(fill, total);
    at = __shfl_sync(kFull, at, 31) + incl - c;
    long long self = kWeighted ? 0 : c;
    for (int k = 0; k < c; k++) {
      const size_t src = ((size_t)r * d + k) * B + b;
      const unsigned long long v =
          (static_cast<unsigned long long>(__ldg(hi + src)) << 32) | __ldg(lo + src);
      int s = first_slot(v, slots);
      for (;;) {
        const unsigned long long prev = atomicCAS(t.key + s, empty, v);
        if (prev == empty || prev == v) break;
        s = s + 1 == slots ? 0 : s + 1;
      }
      const int e = at + k;
      t.row[e] = r;
      if (kWeighted) {
        const int32_t a = __ldg(av + src);
        t.ab[e] = a;
        self += static_cast<long long>(a) * a;
      }
      t.next[e] = atomicExch(t.head + s, e);
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
  for (int i = threadIdx.x; i < n; i += kJoinThreads) {
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

template <bool kWeighted>
__device__ __forceinline__ void join_tile(const uint32_t* __restrict__ hi,
                                          const uint32_t* __restrict__ lo,
                                          const int32_t* __restrict__ av,
                                          const uint8_t* __restrict__ cnt_t, int rows, int d,
                                          int B, int tile_log2, int n, Table t, int* fill,
                                          void* out) {
  const int b0 = blockIdx.x << tile_log2;
  const int slots = table_slots(n);
  // a value of the bucket past the tile's (B >= 2 tiles), which no valid
  // slot of the tile holds
  const unsigned long long empty =
      static_cast<unsigned long long>((b0 + (1 << tile_log2)) & (B - 1));
  for (int s = threadIdx.x; s < slots; s += kJoinThreads) {
    t.key[s] = empty;
    t.head[s] = -1;
  }
  __syncthreads();
  insert<kWeighted>(hi, lo, av, cnt_t, rows, d, B, b0, tile_log2, t, slots, empty, fill, out);
  __syncthreads();
  walk<kWeighted>(t, *fill, rows, out);
}

// out [rows, rows] (int32, or int64 weighted; zeroed by the caller) +=
// the upper triangle of the tiles' joins: grid (B >> tile_log2 tiles).
// Dynamic shared memory for a tile of up to cap entries: the table's
// values and heads (table_slots(cap) each), then cap links, rows and
// (weighted) abundances.
template <bool kWeighted>
__global__ void __launch_bounds__(kJoinThreads, 2)
pairwise_join_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
                     const int32_t* __restrict__ av, const uint8_t* __restrict__ cnt_t,
                     int rows, int d, int B, int tile_log2,
                     const long long* __restrict__ meta, unsigned long long* g_key,
                     int* g_head, int* g_next, int* g_row, int32_t* g_ab, int cap, void* out) {
  extern __shared__ unsigned long long smem[];
  __shared__ int fill;
  if (threadIdx.x == 0) fill = 0;
  const int n = static_cast<int>(meta[3 * blockIdx.x]);
  const long long off = meta[3 * blockIdx.x + 1];
  const long long toff = meta[3 * blockIdx.x + 2];
  // two inlined copies, so the shared one addresses shared memory directly
  if (off < 0) {
    const int slots = table_slots(cap);
    int* head = reinterpret_cast<int*>(smem + slots);
    int* next = head + slots;
    int* row = next + cap;
    join_tile<kWeighted>(hi, lo, av, cnt_t, rows, d, B, tile_log2, n,
                         Table{smem, head, next, row, kWeighted ? row + cap : nullptr}, &fill,
                         out);
  } else {
    join_tile<kWeighted>(hi, lo, av, cnt_t, rows, d, B, tile_log2, n,
                         Table{g_key + toff, g_head + toff, g_next + off, g_row + off,
                               kWeighted ? g_ab + off : nullptr},
                         &fill, out);
  }
}

}  // namespace

extern "C" {

const char* pw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most entries a tile may hold in shared memory when `blocks` blocks
// share an SM (1: the opt-in maximum of one block).
int pw_join_capacity(int weighted, int blocks, int* cap) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long limit =
      std::min<long long>(optin, per_sm / blocks - reserved) - kStaticSmem;
  int lo = 0, hi = 1 << 20;  // the largest c with smem_bytes(c) <= limit
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if ((long long)smem_bytes(mid, weighted != 0) <= limit)
      lo = mid;
    else
      hi = mid - 1;
  }
  *cap = lo;
  return 0;
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
  const size_t smem = smem_bytes(cap, weighted);
  auto kernel = weighted ? pairwise_join_kernel<true> : pairwise_join_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B >> tile_log2;
  kernel<<<tiles, kJoinThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(av), static_cast<const uint8_t*>(cnt_t), rows, d, B, tile_log2,
      static_cast<const long long*>(meta), static_cast<unsigned long long*>(g_key),
      static_cast<int*>(g_head), static_cast<int*>(g_next), static_cast<int*>(g_row),
      static_cast<int32_t*>(g_ab), cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
