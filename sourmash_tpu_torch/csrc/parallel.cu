// Hand-written Hopper (sm_90a) kernels of the sharded gather program
// (`sourmash_tpu_torch/parallel/`): shard_match (X8), the shard-local
// match of a block of queries against one shard's rows.
//
// It replaces the XLA loops `sourmash_tpu/parallel/__init__.py:146
// _local_counts` (the sharded counter and the gather round's decrement)
// and `:306 build_chunk` (the membership builder and the gather round's
// winner row); no Pallas kernel computed them. One call serves all three
// uses:
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
// only); counts and M have out_rows rows, of which this call writes
// [row0, row0 + rows), so the builder writes its chunks in place.
//
// Bound: bytes. Each side's occupancy and alive or occupied slots read
// once, the counts and M's words written once (at the fused program's
// chunk, M is ~0.83 GB of mostly zero words). The lookups are random reads
// of L2: one a row slot and query, and one more a match. Design, a table
// build and one of two match kernels, all sized here from (bq, dq, B)
// (plan_for: no readback, no host sync); the caller gives the tables'
// scratch, of `cuda_gather.shard_match_table_bytes` (plan_for's
// table_bytes; a smaller scratch is refused):
//
// 1. alive_table_kernel: for each query and bucket, an open-addressed
//    table of the alive slots of a range of at most kRangeSlots query
//    slots (dq past it: the ranges one after the other, the tables rebuilt
//    for each and the counts added up), T = 2^tlog entries, the least
//    power of two above 1.5 slots (a load of at most 2/3), linear probing
//    from a hash of the value's bits above log2(B) (every value of a bucket
//    shares its low bits). An entry is (fingerprint << bits) | slot, 16
//    bits (8 + 8) below 255 slots a range, else 32 (16 + 16); an empty
//    entry is one whose slot field is all ones, never a value: 2^64-1 is a
//    hash. A block builds the tables of a run of buckets in shared memory
//    (shared atomics, no global ones) and writes them out whole. At the
//    chunk, the tables take 8.4 MB and stay in L2 beside the query planes
//    (13 MB), which confirm a fingerprint match.
// 2. A block owns one row; its 1,024 threads take a bucket at a time: the
//    occupancy and the first two levels of slots, then both home entries,
//    then their walks; the deeper levels go one slot at a time, and a
//    value repeated in a row's bucket is skipped (it matches the same
//    slots). The lookups are latency-bound random reads of L2, so the
//    block is as wide as the registers allow (32 a thread, two blocks an
//    SM): more threads in flight beat more buckets a thread.
//    - shard_words_kernel, for one query: a hit sets bit (s, b) of the
//      row's [dq, W] lines staged in shared memory, which go out whole in
//      16-byte stores, zeros included, so each word of M is written once
//      (no memset, no read-modify-write, no global atomics). Lines past a
//      block's 110 KiB go out in stages of slots, or, where one slot's
//      line passes it (B > 32 * kStageWords), of words; the row is looked
//      up again for each stage.
//    - shard_count_kernel, counts only, for up to kMaxQueries queries: each
//      bucket's slots are read once for all of them.
//    A count is a block reduction (shared atomics) and one plain store.
// Queries go kMaxGridY at a time (the grid's y).
//
// Plain C interface, loaded with ctypes (sourmash_tpu_torch/ops/_build.py).
// The entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuildThreads = 256;
constexpr int kBuildBytes = 65536;  // a build block's tables
constexpr int kMinTableLog2 = 4;
constexpr int kRangeSlots = 8192;    // query slots of a table: 2^14 entries of 4 bytes at most
constexpr int kMatchThreads = 1024;  // two blocks an SM: 32 registers a thread
constexpr int kStageWords = 28160;   // a match block's staged words: 110 KiB
constexpr int kMaxQueries = 32;      // queries of a counts-only block
constexpr int kMaxGridY = 65535;

// Entry<E>: (fingerprint << kSlotBits) | slot; empty: slot field all ones,
// which no slot of a range reaches
template <typename E>
struct Entry {
  static constexpr int kSlotBits = 4 * static_cast<int>(sizeof(E));
  static constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
  static constexpr E kEmpty = static_cast<E>(~0u);
  __device__ __forceinline__ static uint32_t fp(unsigned long long x) {
    return static_cast<uint32_t>(x >> 16) & kSlotMask;
  }
  __device__ __forceinline__ static E make(unsigned long long x, int s) {
    return static_cast<E>((fp(x) << kSlotBits) | static_cast<uint32_t>(s));
  }
};

// The sizes of a call, from its shapes alone.
struct Plan {
  int ranges;       // ranges of query slots, one table build each
  int range;        // slots a range (the last may hold fewer)
  int tlog;         // log2 of a (query, bucket) table's entries
  int entry_bytes;  // 2 or 4
  int nb;           // buckets a build block
  unsigned long long table_bytes;
};

Plan plan_for(int bq, int dq, int B) {
  Plan p;
  p.ranges = (dq + kRangeSlots - 1) / kRangeSlots;
  p.range = (dq + p.ranges - 1) / p.ranges;
  p.tlog = kMinTableLog2;
  while ((1 << p.tlog) <= p.range + p.range / 2) ++p.tlog;
  p.entry_bytes = p.range < 255 ? 2 : 4;
  const int table = (1 << p.tlog) * p.entry_bytes;
  p.nb = kBuildBytes / table < 32 ? kBuildBytes / table : 32;
  p.table_bytes = static_cast<unsigned long long>(bq) * B * table;
  return p;
}

__device__ __forceinline__ unsigned long long load_value(const uint32_t* __restrict__ hi,
                                                         const uint32_t* __restrict__ lo,
                                                         size_t at) {
  return (static_cast<unsigned long long>(__ldg(hi + at)) << 32) | __ldg(lo + at);
}

// the hash of a value within its bucket: its bits above log2(B), mixed
__device__ __forceinline__ unsigned long long mix(unsigned long long v, int shift) {
  return (v >> shift) * 0x9E3779B97F4A7C15ull;
}

__device__ __forceinline__ int home(unsigned long long x, int tlog) {
  return static_cast<int>(x >> (64 - tlog));
}

// claim an empty entry of a table in shared memory: a 32-bit compare and
// swap, on the entry's word for 16-bit entries
__device__ __forceinline__ bool claim(uint32_t* p, uint32_t e) {
  return atomicCAS(p, 0xffffffffu, e) == 0xffffffffu;
}

__device__ __forceinline__ bool claim(uint16_t* p, uint16_t e) {
  uint32_t* w = reinterpret_cast<uint32_t*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  const int sh = (reinterpret_cast<uintptr_t>(p) & 2) ? 16 : 0;
  uint32_t old = *w;
  for (;;) {
    if (((old >> sh) & 0xffffu) != 0xffffu) return false;
    const uint32_t got = atomicCAS(w, old, (old & ~(0xffffu << sh)) | (uint32_t(e) << sh));
    if (got == old) return true;
    old = got;
  }
}

// the tables of queries [q0, q0 + gridDim.x / (B / nb)) over slots [t0, t1)
template <typename E>
__global__ void __launch_bounds__(kBuildThreads)
alive_table_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                   const uint32_t* __restrict__ alive, int q0, int dq, int t0, int t1, int B,
                   int shift, int tlog, int nb, E* __restrict__ table) {
  extern __shared__ uint4 smem4[];
  E* tab = reinterpret_cast<E*>(smem4);
  const int T = 1 << tlog;
  const int W = B >> 5;
  const int per_q = B / nb;
  const int q = q0 + static_cast<int>(blockIdx.x) / per_q;
  const int b0 = (static_cast<int>(blockIdx.x) % per_q) * nb;
  const int n4 = nb * T * static_cast<int>(sizeof(E)) / 16;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncthreads();
  // nb (a power of two <= 32) adjacent buckets, a lane each; the block's
  // kBuildThreads / nb slot phases
  const int bi = threadIdx.x & (nb - 1);
  const int b = b0 + bi;
  E* mine = tab + bi * T;
  for (int s = t0 + static_cast<int>(threadIdx.x) / nb; s < t1; s += kBuildThreads / nb) {
    const size_t qs = static_cast<size_t>(q) * dq + s;
    if (!((__ldg(alive + qs * W + (b >> 5)) >> (b & 31)) & 1u)) continue;
    const unsigned long long x = mix(load_value(qhi, qlo, qs * B + b), shift);
    const E e = Entry<E>::make(x, s - t0);
    // T > 1.5 (t1 - t0): an empty entry is always left
    for (int h = home(x, tlog); !claim(mine + h, e); h = (h + 1) & (T - 1)) {
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(table + (static_cast<size_t>(q) * B + b0) * T);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) out[i] = smem4[i];
}

template <typename E>
struct Query {
  const E* table;  // its [B, T] entries
  const uint32_t* qhi;
  const uint32_t* qlo;
  size_t base;  // q * dq
  int tlog, shift;
  int t0;  // the range's first slot: an entry's slot is s - t0
};

template <typename E>
__device__ __forceinline__ Query<E> query(const E* table, const uint32_t* qhi, const uint32_t* qlo,
                                          int q, int dq, int B, int tlog, int shift, int t0) {
  return Query<E>{table + static_cast<size_t>(q) * B * (1 << tlog), qhi, qlo,
                  static_cast<size_t>(q) * dq, tlog, shift, t0};
}

// Where a hit's bit goes: the stage of slots [s0, s1) by words [w0, w0 + nw).
struct Stage {
  uint32_t* words;
  int s0, s1, w0, nw;
};

// The alive slots of query Q's bucket b holding v (x = mix(v)), from
// position h, whose entry is e, to the first empty entry: each hit counted
// and, with the words, its bit set in the stage where its slot lies in
// [s0, s1).
template <typename E, bool kBits>
__device__ __forceinline__ int walk(const Query<E>& Q, const E* __restrict__ bt, int h, E e,
                                    unsigned long long x, unsigned long long v, int B, int b,
                                    const Stage& S) {
  const int tmask = (1 << Q.tlog) - 1;
  const uint32_t fp = Entry<E>::fp(x);
  int hits = 0;
  while (e != Entry<E>::kEmpty) {
    if ((static_cast<uint32_t>(e) >> Entry<E>::kSlotBits) == fp) {
      const int s = Q.t0 + static_cast<int>(e & Entry<E>::kSlotMask);
      if (load_value(Q.qhi, Q.qlo, (Q.base + s) * B + b) == v) {
        ++hits;
        if (kBits && s >= S.s0 && s < S.s1)
          atomicOr(S.words + (s - S.s0) * S.nw + (b >> 5) - S.w0, 1u << (b & 31));
      }
    }
    h = (h + 1) & tmask;
    e = __ldg(bt + h);
  }
  return hits;
}

struct Row {
  const uint32_t* shi;
  const uint32_t* slo;
  const uint8_t* cnt;  // its occupancy
  size_t base;         // r * d
  int B, d;
  __device__ __forceinline__ unsigned long long at(int k, int b) const {
    return load_value(shi, slo, (base + k) * B + b);
  }
};

// A thread's bucket b: its occupancy min(Scnt, d) and levels 0 and 1, read
// whatever the occupancy (the planes are dense).
struct Slots {
  int b, c;
  unsigned long long v0, v1;

  __device__ __forceinline__ Slots(const Row& R, int bucket) : b(bucket) {
    c = min(static_cast<int>(R.cnt[b]), R.d);
    v0 = R.d > 0 ? R.at(0, b) : 0ull;
    v1 = R.d > 1 ? R.at(1, b) : 0ull;
  }
};

// One query's matches of a bucket's occupied slots: the home entries of
// levels 0 and 1 loaded together, then their walks, then the deeper levels
// a slot at a time (a value repeated in a row's bucket matches the same
// slots: skipped).
template <typename E, bool kBits>
__device__ __forceinline__ int bucket_matches(const Query<E>& Q, const Row& R, const Slots& g,
                                              const Stage& S) {
  const int B = R.B, b = g.b;
  const E* bt = Q.table + (static_cast<size_t>(b) << Q.tlog);
  const unsigned long long x0 = mix(g.v0, Q.shift), x1 = mix(g.v1, Q.shift);
  const E e0 = g.c > 0 ? __ldg(bt + home(x0, Q.tlog)) : Entry<E>::kEmpty;
  const E e1 = g.c > 1 && g.v1 != g.v0 ? __ldg(bt + home(x1, Q.tlog)) : Entry<E>::kEmpty;
  int found = walk<E, kBits>(Q, bt, home(x0, Q.tlog), e0, x0, g.v0, B, b, S);
  found += walk<E, kBits>(Q, bt, home(x1, Q.tlog), e1, x1, g.v1, B, b, S);
  for (int k = 2; k < g.c; ++k) {
    const unsigned long long u = R.at(k, b);
    bool repeat = u == g.v0 || u == g.v1;
    for (int k2 = 2; k2 < k && !repeat; ++k2) repeat = R.at(k2, b) == u;
    if (repeat) continue;
    const unsigned long long x = mix(u, Q.shift);
    const int h = home(x, Q.tlog);
    found += walk<E, kBits>(Q, bt, h, __ldg(bt + h), x, u, B, b, S);
  }
  return found;
}

// Row blockIdx.x against query q0 + blockIdx.y over slots [t0, t1): the
// words of those slots, in stages of ss slots by sw words, and the count
// (added to the earlier ranges' where `add`).
template <typename E>
__global__ void __launch_bounds__(kMatchThreads, 2)
shard_words_kernel(const E* __restrict__ table, int tlog, int shift,
                   const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo, int q0,
                   int dq, int t0, int t1, int B, const uint32_t* __restrict__ shi,
                   const uint32_t* __restrict__ slo, const uint8_t* __restrict__ scnt, int d,
                   int out_rows, int row0, int ss, int sw, bool add, int32_t* __restrict__ counts,
                   uint32_t* __restrict__ M) {
  extern __shared__ uint4 stage4[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(stage4);
  __shared__ int hits;
  const int r = blockIdx.x, q = q0 + blockIdx.y;
  const int W = B >> 5;
  const Row R{shi, slo, scnt + static_cast<size_t>(r) * B, static_cast<size_t>(r) * d, B, d};
  const Query<E> Q = query(table, qhi, qlo, q, dq, B, tlog, shift, t0);
  const size_t line = (static_cast<size_t>(q) * out_rows + row0 + r) * dq;
  if (threadIdx.x == 0) hits = 0;
  for (int w0 = 0; w0 < W; w0 += sw) {
    const int nw = min(W, w0 + sw) - w0;
    for (int s0 = t0; s0 < t1; s0 += ss) {
      const Stage S{stage, s0, min(t1, s0 + ss), w0, nw};
      const int words = (S.s1 - s0) * nw;  // contiguous in M: nw == W, or one slot
      for (int i = threadIdx.x; i < (words + 3) >> 2; i += blockDim.x)
        stage4[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      int found = 0;
      for (int b = 32 * w0 + threadIdx.x; b < 32 * (w0 + nw); b += blockDim.x)
        found += bucket_matches<E, true>(Q, R, Slots(R, b), S);
      if (s0 == t0 && found) atomicAdd(&hits, found);
      __syncthreads();
      // the stage's lines, whole
      uint32_t* dst = M + (line + s0) * W + w0;
      if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0 && (words & 3) == 0) {
        uint4* dst4 = reinterpret_cast<uint4*>(dst);
        for (int i = threadIdx.x; i < words >> 2; i += blockDim.x) dst4[i] = stage4[i];
      } else {
        for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = stage[i];
      }
      __syncthreads();  // the stores read the stage before the next stage clears it
    }
  }
  if (threadIdx.x == 0) {
    int32_t* c = counts + static_cast<size_t>(q) * out_rows + row0 + r;
    *c = add ? *c + hits : hits;
  }
}

// Row blockIdx.x against queries [qa, qa + qpb) of [q0, q1), qa = q0 +
// blockIdx.y * qpb, over slots [t0, t1): the counts (added to the earlier
// ranges' where `add`).
template <typename E>
__global__ void __launch_bounds__(kMatchThreads, 2)
shard_count_kernel(const E* __restrict__ table, int tlog, int shift,
                   const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo, int q0,
                   int q1, int dq, int t0, int B, const uint32_t* __restrict__ shi,
                   const uint32_t* __restrict__ slo, const uint8_t* __restrict__ scnt, int d,
                   int out_rows, int row0, int qpb, bool add, int32_t* __restrict__ counts) {
  __shared__ int q_hits[kMaxQueries];
  const int r = blockIdx.x;
  const int qa = q0 + blockIdx.y * qpb, qb = min(q1, qa + qpb);
  const Row R{shi, slo, scnt + static_cast<size_t>(r) * B, static_cast<size_t>(r) * d, B, d};
  const Stage none{nullptr, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < qb - qa; i += blockDim.x) q_hits[i] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const Slots g(R, b);
    for (int q = qa; q < qb; ++q) {
      const Query<E> Q = query(table, qhi, qlo, q, dq, B, tlog, shift, t0);
      const int found = bucket_matches<E, false>(Q, R, g, none);
      if (found) atomicAdd(q_hits + (q - qa), found);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qb - qa; i += blockDim.x) {
    int32_t* c = counts + static_cast<size_t>(qa + i) * out_rows + row0 + r;
    *c = add ? *c + q_hits[i] : q_hits[i];
  }
}

template <typename E>
int launch(const Plan& p, const uint32_t* qh, const uint32_t* ql, const uint32_t* al, int bq,
           int dq, int B, const uint32_t* sh, const uint32_t* sl, const uint8_t* sc, int rows,
           int d, int out_rows, int row0, E* tab, int32_t* counts, uint32_t* M, cudaStream_t st) {
  const int W = B >> 5;
  int shift = 0;
  while ((2ll << shift) <= B) ++shift;
  const int build_smem = p.nb * (1 << p.tlog) * static_cast<int>(sizeof(E));
  // queries a launch: the grids' y, and the build grid's x under 2^31
  const int per_q = B / p.nb;
  const int nq = kMaxGridY < INT_MAX / per_q ? kMaxGridY : INT_MAX / per_q;
  const int qpb = bq < kMaxQueries ? bq : kMaxQueries;
  // a stage: ss slots by sw words, in kStageWords
  const int sw = W < kStageWords ? W : kStageWords;
  const int ss = kStageWords / sw < p.range ? kStageWords / sw : p.range;
  const int stage_smem = ((ss * sw + 3) / 4) * 16;
  cudaError_t err = cudaFuncSetAttribute(alive_table_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, build_smem);
  if (err == cudaSuccess && M != nullptr)
    err = cudaFuncSetAttribute(shard_words_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t0 = 0; t0 < dq; t0 += p.range) {
    const int t1 = t0 + p.range < dq ? t0 + p.range : dq;
    for (int q0 = 0; q0 < bq; q0 += nq) {
      const int q1 = q0 + nq < bq ? q0 + nq : bq;
      alive_table_kernel<E><<<(unsigned)(q1 - q0) * (unsigned)per_q, kBuildThreads, build_smem,
                              st>>>(qh, ql, al, q0, dq, t0, t1, B, shift, p.tlog, p.nb, tab);
    }
    for (int q0 = 0; q0 < bq; q0 += nq) {
      const int q1 = q0 + nq < bq ? q0 + nq : bq;
      if (M != nullptr) {
        shard_words_kernel<E><<<dim3((unsigned)rows, (unsigned)(q1 - q0)), kMatchThreads,
                                stage_smem, st>>>(tab, p.tlog, shift, qh, ql, q0, dq, t0, t1, B,
                                                  sh, sl, sc, d, out_rows, row0, ss, sw, t0 > 0,
                                                  counts, M);
      } else {
        const dim3 grid((unsigned)rows, (unsigned)((q1 - q0 + qpb - 1) / qpb));
        shard_count_kernel<E><<<grid, kMatchThreads, 0, st>>>(
            tab, p.tlog, shift, qh, ql, q0, q1, dq, t0, B, sh, sl, sc, d, out_rows, row0, qpb,
            t0 > 0, counts);
      }
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts [bq, out_rows] i32 rows [row0, row0 + rows) = the matches of each
// query of qhi/qlo [bq, dq, B] u32 (alive words [bq, dq, B/32], B a
// multiple of 32) against rows shi/slo [rows, d, B] u32, occupancy scnt
// [rows, B] u8; with M (else null), the match words M [bq, out_rows, dq,
// B/32] of those rows are written too. table: scratch of table_bytes, at
// least plan_for(bq, dq, B).table_bytes, written and read here.
int pm_shard_match(const void* qhi, const void* qlo, const void* alive, int bq, int dq, int B,
                   const void* shi, const void* slo, const void* scnt, int rows, int d,
                   int out_rows, int row0, void* table, unsigned long long table_bytes,
                   void* counts, void* M, void* stream) {
  if (bq <= 0 || dq <= 0 || rows <= 0) return 0;
  if (B < 32 || B % 32) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(bq, dq, B);
  if (row0 < 0 || row0 > out_rows - rows || d < 0 || table_bytes < p.table_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qh = static_cast<const uint32_t*>(qhi);
  const auto* ql = static_cast<const uint32_t*>(qlo);
  const auto* al = static_cast<const uint32_t*>(alive);
  const auto* sh = static_cast<const uint32_t*>(shi);
  const auto* sl = static_cast<const uint32_t*>(slo);
  const auto* sc = static_cast<const uint8_t*>(scnt);
  auto* out = static_cast<int32_t*>(counts);
  auto* m = static_cast<uint32_t*>(M);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.entry_bytes == 2)
    return launch<uint16_t>(p, qh, ql, al, bq, dq, B, sh, sl, sc, rows, d, out_rows, row0,
                            static_cast<uint16_t*>(table), out, m, st);
  return launch<uint32_t>(p, qh, ql, al, bq, dq, B, sh, sl, sc, rows, d, out_rows, row0,
                          static_cast<uint32_t*>(table), out, m, st);
}

}  // extern "C"
