// Native bucketed-plane packer: the host-side index build hot loop.
//
// Packs rows of per-row-sorted distinct u64 hashes into the bucketed
// hi/lo/cnt planes consumed by the device counting kernels
// (ops/bucketed.py BucketedRows). Within a (row, bucket) the input's
// ascending hash order IS the slot order, so packing is a single O(N)
// pass per row with no sort — and rows are independent, so the pass is
// thread-chunked. Replaces the numpy global-argsort pack for large
// builds; the reference parallelizes its equivalent index construction
// with rayon (reference src/core/src/index/revindex/disk_revindex.rs:96-112).
// The port's copy of sourmash_tpu/native/pack.cpp.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

struct SpillEntry {
  int64_t row;
  uint64_t val;
};

// First-touch page faults dominate fresh multi-GB plane buffers (~6us per
// 4K fault on cloud VMs: 3 GB of planes costs ~5 s before any packing).
// With transparent_hugepage=madvise, asking for 2 MB pages cuts the fault
// count ~500x.
static void advise_huge(void* p, size_t len) {
#ifdef __linux__
  const uintptr_t a = (uintptr_t)p;
  const uintptr_t start = (a + 4095) & ~(uintptr_t)4095;
  const uintptr_t end = (a + len) & ~(uintptr_t)4095;
  if (end > start) madvise((void*)start, end - start, MADV_HUGEPAGE);
#else
  (void)p;
  (void)len;
#endif
}

// Pack rows [r0, r1). Layout: hi/lo are [rows, d, B] u32 (PAD-prefilled),
// cnt is [rows, B] u8 (zeroed). Values equal to 2**64-1 (the PAD
// sentinel) and elements past the d-th slot of a bucket spill to the
// exact host-side join lists, in ascending value order per row (the
// input is sorted, so appends stay sorted; 2**64-1 is always last).
// When hi/lo are null, only cnt and the spill lists are produced (the
// planes are packed ON DEVICE from the raw limb rows — see
// ops/bucketed.device_pack_rows — and only the exact spill join needs
// host-side state).
static void pack_rows_range(const uint64_t* vals, const int64_t* offs,
                            int64_t r0, int64_t r1, int64_t B, int32_t d,
                            uint32_t* hi, uint32_t* lo, uint8_t* cnt,
                            std::vector<SpillEntry>* spills) {
  const uint64_t mask = (uint64_t)(B - 1);
  const size_t slab = (size_t)d * B;
  for (int64_t r = r0; r < r1; r++) {
    uint32_t* hrow = hi ? hi + (size_t)r * slab : nullptr;
    uint32_t* lrow = lo ? lo + (size_t)r * slab : nullptr;
    uint8_t* crow = cnt + (size_t)r * B;
    // PAD-fill this row's slabs right before scattering into them: the
    // slab (a few hundred KB) stays cache-hot, so the fill+scatter is one
    // memory pass instead of a global memset pass plus a cold scatter
    if (hrow) {
      std::memset(hrow, 0xFF, slab * 4);
      std::memset(lrow, 0xFF, slab * 4);
    }
    std::memset(crow, 0, (size_t)B);
    for (int64_t i = offs[r]; i < offs[r + 1]; i++) {
      const uint64_t v = vals[i];
      if (v == UINT64_MAX) {  // PAD collision guard (scaled=1 only)
        spills->push_back({r, v});
        continue;
      }
      const int64_t b = (int64_t)(v & mask);
      const uint8_t c = crow[b];
      if (c < d) {
        if (hrow) {
          hrow[(size_t)c * B + b] = (uint32_t)(v >> 32);
          lrow[(size_t)c * B + b] = (uint32_t)(v & 0xFFFFFFFFu);
        }
        crow[b] = (uint8_t)(c + 1);  // stored count == min(load, d)
      } else {  // Poisson tail past d slots: exact host join
        spills->push_back({r, v});
      }
    }
  }
}

}  // namespace

extern "C" {

// Pack n rows (concatenated `vals` with `offs[n+1]` boundaries) into
// bucketed planes of `rows` >= n padded rows. Fills hi/lo with the PAD
// pattern and zeroes cnt itself (callers pass uninitialized buffers).
// Spilled (row, value) pairs are written ascending by row then value.
// Returns the spill count, or -(needed) if spill_cap is too small
// (caller retries with the returned size).
int64_t pack_rows_native(const uint64_t* vals, const int64_t* offs,
                         int64_t n, int64_t rows, int64_t B, int32_t d,
                         uint32_t* hi, uint32_t* lo, uint8_t* cnt,
                         int64_t* spill_rows, uint64_t* spill_vals,
                         int64_t spill_cap, int32_t n_threads) {
  const size_t plane_bytes = (size_t)rows * (size_t)d * (size_t)B * 4;
  if (hi) {
    advise_huge(hi, plane_bytes);
    advise_huge(lo, plane_bytes);
  }
  advise_huge(cnt, (size_t)rows * (size_t)B);

  // data rows [0, n) are PAD-filled inside pack_rows_range (cache-fused);
  // only the padding rows [n, rows) need a bulk fill here
  if (rows > n) {
    const size_t slab = (size_t)d * (size_t)B;
    const size_t pad_rows = (size_t)(rows - n);
    if (hi) {
      std::memset(hi + (size_t)n * slab, 0xFF, pad_rows * slab * 4);
      std::memset(lo + (size_t)n * slab, 0xFF, pad_rows * slab * 4);
    }
    std::memset(cnt + (size_t)n * B, 0, pad_rows * (size_t)B);
  }
  if (n <= 0) return 0;

  int32_t nt = n_threads;
  if (nt <= 0) {
    nt = (int32_t)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  if (offs[n] < (1 << 18)) nt = 1;  // small packs: thread spawn dominates
  if ((int64_t)nt > n) nt = (int32_t)n;

  std::vector<std::vector<SpillEntry>> spills(nt);
  std::vector<std::thread> threads;
  const int64_t per = (n + nt - 1) / nt;
  for (int32_t t = 0; t < nt; t++) {
    const int64_t r0 = (int64_t)t * per;
    const int64_t r1 = r0 + per < n ? r0 + per : n;
    if (r0 >= r1) break;
    threads.emplace_back(pack_rows_range, vals, offs, r0, r1, B, d, hi, lo,
                         cnt, &spills[t]);
  }
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& v : spills) total += (int64_t)v.size();
  if (total > spill_cap) return -total;
  int64_t off = 0;
  for (auto& v : spills) {  // thread ranges are contiguous: rows ascend
    for (auto& e : v) {
      spill_rows[off] = e.row;
      spill_vals[off] = e.val;
      off++;
    }
  }
  return total;
}

// Split concatenated u64 rows into PAD-padded [rows, L] hi/lo u32 limb
// planes (the raw upload format for the on-device pack kernel). Rows are
// independent -> thread-chunked; the PAD fill of each row's tail is fused
// with the copy so the row stays cache-hot (one memory pass).
void split_limbs_native(const uint64_t* vals, const int64_t* offs,
                        int64_t n, int64_t rows, int64_t L, uint32_t* hi,
                        uint32_t* lo, int32_t n_threads) {
  const size_t plane_bytes = (size_t)rows * (size_t)L * 4;
  advise_huge(hi, plane_bytes);
  advise_huge(lo, plane_bytes);
  if (rows > n) {
    std::memset(hi + (size_t)n * L, 0xFF, (size_t)(rows - n) * L * 4);
    std::memset(lo + (size_t)n * L, 0xFF, (size_t)(rows - n) * L * 4);
  }
  if (n <= 0) return;

  int32_t nt = n_threads;
  if (nt <= 0) {
    nt = (int32_t)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  if (offs[n] < (1 << 18)) nt = 1;
  if ((int64_t)nt > n) nt = (int32_t)n;

  auto worker = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) {
      uint32_t* hrow = hi + (size_t)r * L;
      uint32_t* lrow = lo + (size_t)r * L;
      const int64_t len = offs[r + 1] - offs[r];
      const uint64_t* v = vals + offs[r];
      for (int64_t i = 0; i < len; i++) {
        hrow[i] = (uint32_t)(v[i] >> 32);
        lrow[i] = (uint32_t)(v[i] & 0xFFFFFFFFu);
      }
      if (len < L) {
        std::memset(hrow + len, 0xFF, (size_t)(L - len) * 4);
        std::memset(lrow + len, 0xFF, (size_t)(L - len) * 4);
      }
    }
  };
  std::vector<std::thread> threads;
  const int64_t per = (n + nt - 1) / nt;
  for (int32_t t = 0; t < nt; t++) {
    const int64_t r0 = (int64_t)t * per;
    const int64_t r1 = r0 + per < n ? r0 + per : n;
    if (r0 >= r1) break;
    threads.emplace_back(worker, r0, r1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
