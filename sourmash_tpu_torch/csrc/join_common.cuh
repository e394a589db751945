// The hash table shared by the port's per-tile hash joins: compare's
// all-pairs joins (pairwise.cu) and the joins of a query block against a
// chunk's rows (block_join.cu).
//
// A tile of 2^tile_log2 adjacent buckets of a bucketed bank (a value sits
// in bucket value & (B - 1)) is one block's table: open addressing with
// linear probing over 64-bit values, a 64-bit atomicCAS claiming a slot,
// and each slot's list of entries (row[, abundance]) linked through
// `next` by one atomicExch on its head. The empty mark is a value of the
// bucket past the tile's (B >= 2 tiles), which no valid slot of the tile
// holds. A tile of up to `cap` entries works in dynamic shared memory
// (the table's values and heads, table_slots(cap) each, then cap links,
// rows and, weighted, abundances); a tile past that works on a scratch
// area in global memory that the wrapper allocates, through the same
// code: meta[t] = (entries, entry offset or -1 for shared memory, table
// offset). __syncthreads orders the block's global accesses as it does
// its shared ones, and the atomics act in L2.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace join {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmem = 64;  // the block's fill counter, with room to spare

// a tile's hash table (values, list heads) and entries (list links, rows
// and, weighted, abundances), in shared or in global memory
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

// a value of the bucket past tile [b0, b0 + 2^tile_log2) (B >= 2 tiles),
// which no valid slot of the tile holds
__device__ __forceinline__ unsigned long long empty_mark(int b0, int tile_log2, int B) {
  return static_cast<unsigned long long>((b0 + (1 << tile_log2)) & (B - 1));
}

__device__ __forceinline__ unsigned long long load_value(const uint32_t* __restrict__ hi,
                                                         const uint32_t* __restrict__ lo,
                                                         size_t at) {
  return (static_cast<unsigned long long>(__ldg(hi + at)) << 32) | __ldg(lo + at);
}

// the table's first probe of value v: the high bits of a multiplicative
// hash, scaled to `slots`
__device__ __forceinline__ int first_slot(unsigned long long v, int slots) {
  const unsigned long long h = v * 0x9E3779B97F4A7C15ull;
  return static_cast<int>(__umulhi(static_cast<unsigned>(h >> 32), static_cast<unsigned>(slots)));
}

// Clear the table of a tile of n entries.
__device__ __forceinline__ void clear(Table t, int slots, unsigned long long empty) {
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    t.key[s] = empty;
    t.head[s] = -1;
  }
}

// The slot holding v, claimed for it if v is not in the table yet.
__device__ __forceinline__ int claim(Table t, int slots, unsigned long long empty,
                                     unsigned long long v) {
  int s = first_slot(v, slots);
  for (;;) {
    const unsigned long long prev = atomicCAS(t.key + s, empty, v);
    if (prev == empty || prev == v) return s;
    s = s + 1 == slots ? 0 : s + 1;
  }
}

// The slot holding v, or -1 (the table is complete: no claim races it).
__device__ __forceinline__ int find(Table t, int slots, unsigned long long empty,
                                    unsigned long long v) {
  int s = first_slot(v, slots);
  for (;;) {
    const unsigned long long k = t.key[s];
    if (k == v) return s;
    if (k == empty) return -1;
    s = s + 1 == slots ? 0 : s + 1;
  }
}

// Link entry e (already written) into the list of slot s.
__device__ __forceinline__ void link(Table t, int s, int e) { t.next[e] = atomicExch(t.head + s, e); }

// The first of c entries of this lane in the tile's entry arrays: one
// warp scan and one shared atomicAdd a warp on *fill. Every lane of the
// warp calls it.
__device__ __forceinline__ int warp_alloc(int c, int* fill) {
  const int lane = threadIdx.x & 31;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int at = 0;
  if (lane == 31 && total) at = atomicAdd(fill, total);
  return __shfl_sync(kFull, at, 31) + incl - c;
}

// Run body(n, table) on this block's tile, meta[blockIdx.x] = (entries n,
// entry offset in the global scratch or -1, table offset): two inlined
// copies, so the shared one addresses shared memory directly.
template <bool kWeighted, typename Body>
__device__ __forceinline__ void with_tile_table(const long long* __restrict__ meta,
                                                unsigned long long* smem, int cap,
                                                unsigned long long* g_key, int* g_head,
                                                int* g_next, int* g_row, int32_t* g_ab,
                                                Body&& body) {
  const int n = static_cast<int>(meta[3 * blockIdx.x]);
  const long long off = meta[3 * blockIdx.x + 1];
  const long long toff = meta[3 * blockIdx.x + 2];
  if (off < 0) {
    const int slots = table_slots(cap);
    int* head = reinterpret_cast<int*>(smem + slots);
    int* next = head + slots;
    int* row = next + cap;
    body(n, Table{smem, head, next, row, kWeighted ? row + cap : nullptr});
  } else {
    body(n, Table{g_key + toff, g_head + toff, g_next + off, g_row + off,
                  kWeighted ? g_ab + off : nullptr});
  }
}

// The most entries a tile may hold in shared memory when `blocks` join
// blocks share an SM (1: the opt-in maximum of one block), each keeping
// `reserved` more bytes of dynamic shared memory, on the current device.
inline int capacity(bool weighted, int blocks, int reserved_bytes, int* cap) {
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
      std::min<long long>(optin, per_sm / blocks - reserved) - kStaticSmem - reserved_bytes;
  int lo = 0, hi = 1 << 20;  // the largest c with smem_bytes(c) <= limit
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if ((long long)smem_bytes(mid, weighted) <= limit)
      lo = mid;
    else
      hi = mid - 1;
  }
  *cap = lo;
  return 0;
}

}  // namespace join
