// Membership-bitset builder: for each dataset row, which query hashes
// does it contain?
//
// Inputs are sorted u64 arrays (the query, and k datasets concatenated
// with offsets). Output M is a [k, W] u32 bitset over QUERY POSITIONS:
// bit (p & 31) of word p >> 5 in row r is set iff query[p] is in
// dataset r. This is the matrix the device gather-round scan consumes
// (index/flat.py DeviceGatherSchedule); at reference-database scale a
// metagenome can match tens of thousands of datasets, and the numpy
// build (a [k, nq] bool intermediate) was the wall.
//
// Rows are independent -> thread-chunked. Per row: galloping binary
// search of each dataset hash in the query (datasets are much smaller
// than metagenome queries). The port's copy of
// sourmash_tpu/native/membership.cpp.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static void membership_range(const uint64_t* q, int64_t nq,
                             const uint64_t* vals, const int64_t* offs,
                             int64_t r0, int64_t r1, uint32_t* M, int64_t W) {
  for (int64_t r = r0; r < r1; r++) {
    uint32_t* row = M + (size_t)r * W;
    std::memset(row, 0, (size_t)W * 4);
    int64_t lo = 0;  // query positions only advance: both sides sorted
    for (int64_t i = offs[r]; i < offs[r + 1]; i++) {
      const uint64_t v = vals[i];
      // gallop forward from lo, then binary search the bracket
      int64_t step = 1, hi = lo;
      while (hi < nq && q[hi] < v) {
        lo = hi;
        hi += step;
        step <<= 1;
      }
      if (hi > nq) hi = nq;
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (q[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < nq && q[lo] == v)
        row[lo >> 5] |= (uint32_t)1 << (lo & 31);
    }
  }
}

}  // namespace

extern "C" {

// M must hold k*W u32 (zeroed here). Returns 0.
int64_t membership_bits_native(const uint64_t* q, int64_t nq,
                               const uint64_t* vals, const int64_t* offs,
                               int64_t k, uint32_t* M, int64_t W,
                               int32_t n_threads) {
  if (k <= 0) return 0;
  int32_t nt = n_threads;
  if (nt <= 0) {
    nt = (int32_t)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  if (offs[k] < (1 << 16)) nt = 1;
  if ((int64_t)nt > k) nt = (int32_t)k;
  std::vector<std::thread> threads;
  const int64_t per = (k + nt - 1) / nt;
  for (int32_t t = 0; t < nt; t++) {
    const int64_t r0 = (int64_t)t * per;
    const int64_t r1 = r0 + per < k ? r0 + per : k;
    if (r0 >= r1) break;
    threads.emplace_back(membership_range, q, nq, vals, offs, r0, r1, M, W);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
