// Native host sketching hot loop: canonical k-mer MurmurHash3 x64_128 +
// scaled threshold, the CPU-side equivalent of the Pallas sketch kernel.
//
// Behavioral reference: sourmash src/core/src/signature.rs:246-306
// (SeqToHashes window iteration: validity, canonical = lexicographic
// min(kmer, revcomp), murmur64 of the winning byte string) — implementation
// is an original C++ design (rolling revcomp buffer, invalid-run tracking,
// thread-chunked for long sequences; the reference's analogous hot loop is
// Rust behind a C ABI).
//
// MurmurHash3 x64_128 below follows the public-domain algorithm by Austin
// Appleby (only the 64-bit .0 half is used, seed default 42 — matching
// lib.rs:57 _hash_murmur).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static inline uint64_t getblock64(const uint8_t* p, int i) {
  uint64_t v;
  std::memcpy(&v, p + 8 * i, 8);  // little-endian hosts only
  return v;
}

// MurmurHash3 x64_128, returning the low 64 bits (matches
// murmurhash3::murmurhash3_x64_128(...).0 used by the reference).
static uint64_t murmur3_x64_128_lo(const uint8_t* data, int len,
                                   uint32_t seed) {
  const int nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int i = 0; i < nblocks; i++) {
    uint64_t k1 = getblock64(data, i * 2 + 0);
    uint64_t k2 = getblock64(data, i * 2 + 1);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
    case 9:
      k2 ^= ((uint64_t)tail[8]) << 0;
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      [[fallthrough]];
    case 8: k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
    case 7: k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
    case 6: k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
    case 5: k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
    case 4: k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
    case 3: k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= ((uint64_t)tail[0]) << 0;
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

struct Tables {
  uint8_t comp[256];
  uint8_t valid[256];
  Tables() {
    for (int i = 0; i < 256; i++) { comp[i] = 'N'; valid[i] = 0; }
    comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
    valid['A'] = valid['C'] = valid['G'] = valid['T'] = 1;
  }
};
static const Tables T;

// Sketch windows [w0, w1) of an uppercased sequence. Appends surviving
// canonical hashes (h <= max_hash) in window order; records the first
// invalid byte position seen in any window (or -1).
static void sketch_range(const uint8_t* seq, int64_t w0, int64_t w1,
                         int32_t k, uint32_t seed, uint64_t max_hash,
                         std::vector<uint64_t>* out, int64_t* first_bad) {
  std::vector<uint8_t> rc(k);
  // last invalid byte position at or before the current scan point
  int64_t last_bad = -1;
  for (int64_t j = w0; j < w0 + k - 1 && j < w1 + k - 1; j++) {
    if (!T.valid[seq[j]]) { last_bad = j; if (*first_bad < 0) *first_bad = j; }
  }
  // prime the rolling revcomp buffer as if window w0-1 had just been done:
  // rc_prev[j] = comp(seq[w0 + k - 2 - j]), so the first loop iteration's
  // shift+insert yields revcomp(seq[w0 .. w0+k-1]) exactly
  for (int32_t i = 0; i < k - 1; i++) rc[k - 2 - i] = T.comp[seq[w0 + i]];

  for (int64_t p = w0; p < w1; p++) {
    const uint8_t nb = seq[p + k - 1];  // newest byte of this window
    if (!T.valid[nb]) {
      last_bad = p + k - 1;
      if (*first_bad < 0) *first_bad = p + k - 1;
    }
    // slide revcomp: drop comp(seq[p-1])'s slot, insert comp(newest) at 0
    std::memmove(rc.data() + 1, rc.data(), k - 1);
    rc[0] = T.comp[nb];
    if (last_bad >= p) continue;  // window [p, p+k) contains an invalid byte
    const uint8_t* fwd = seq + p;
    const uint8_t* key = std::memcmp(fwd, rc.data(), k) <= 0 ? fwd : rc.data();
    uint64_t h = murmur3_x64_128_lo(key, k, seed);
    if (h <= max_hash) out->push_back(h);
  }
}

}  // namespace

namespace {

// Hash every k-byte window (no canonicalization or validity — protein
// windows are hashed as-is, reference signature.rs:362-393).
static void hash_range(const uint8_t* seq, int64_t w0, int64_t w1, int32_t k,
                       uint32_t seed, uint64_t* out) {
  for (int64_t p = w0; p < w1; p++)
    out[p] = murmur3_x64_128_lo(seq + p, k, seed);
}

}  // namespace

extern "C" {

// out[i] = murmur64(seq[i .. i+k)), for all n-k+1 windows. Thread-chunked.
int64_t hash_windows(const uint8_t* seq, int64_t n, int32_t k, uint32_t seed,
                     uint64_t* out, int32_t n_threads) {
  int64_t nwin = n - k + 1;
  if (nwin <= 0 || k <= 0) return 0;
  int32_t nt = n_threads;
  if (nt <= 0) {
    nt = (int32_t)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  if (nwin < (1 << 18)) nt = 1;
  if ((int64_t)nt > nwin) nt = (int32_t)nwin;
  if (nt == 1) {  // a short record: no thread to start and join
    hash_range(seq, 0, nwin, k, seed, out);
    return nwin;
  }
  std::vector<std::thread> threads;
  int64_t per = (nwin + nt - 1) / nt;
  for (int32_t t = 0; t < nt; t++) {
    int64_t w0 = (int64_t)t * per;
    int64_t w1 = w0 + per < nwin ? w0 + per : nwin;
    if (w0 >= w1) break;
    threads.emplace_back(hash_range, seq, w0, w1, k, seed, out);
  }
  for (auto& th : threads) th.join();
  return nwin;
}

// Returns the number of surviving hashes written to out (in window order,
// with multiplicity), or -(needed) if out_cap was too small. first_bad_out
// receives the first invalid byte position (-1 if the sequence is clean).
// seq must be uppercased; n = byte length; windows = n - k + 1.
int64_t sketch_hashes(const uint8_t* seq, int64_t n, int32_t k, uint32_t seed,
                      uint64_t max_hash, uint64_t* out, int64_t out_cap,
                      int64_t* first_bad_out, int32_t n_threads) {
  *first_bad_out = -1;
  int64_t nwin = n - k + 1;
  if (nwin <= 0 || k <= 0) return 0;

  int32_t nt = n_threads;
  if (nt <= 0) {
    nt = (int32_t)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  }
  if (nwin < (1 << 18)) nt = 1;
  if ((int64_t)nt > nwin) nt = (int32_t)nwin;

  std::vector<std::vector<uint64_t>> outs(nt);
  std::vector<int64_t> bads(nt, -1);
  std::vector<std::thread> threads;
  int64_t per = (nwin + nt - 1) / nt;
  for (int32_t t = 0; t < nt; t++) {
    int64_t w0 = (int64_t)t * per;
    int64_t w1 = w0 + per < nwin ? w0 + per : nwin;
    if (w0 >= w1) break;
    if (nt == 1) {  // a short record: no thread to start and join
      sketch_range(seq, w0, w1, k, seed, max_hash, &outs[t], &bads[t]);
      break;
    }
    threads.emplace_back(sketch_range, seq, w0, w1, k, seed, max_hash,
                         &outs[t], &bads[t]);
  }
  for (auto& th : threads) th.join();

  for (int32_t t = 0; t < nt; t++)
    if (bads[t] >= 0 && (*first_bad_out < 0 || bads[t] < *first_bad_out))
      *first_bad_out = bads[t];

  int64_t total = 0;
  for (auto& v : outs) total += (int64_t)v.size();
  if (total > out_cap) return -total;
  int64_t off = 0;
  for (auto& v : outs) {
    std::memcpy(out + off, v.data(), v.size() * sizeof(uint64_t));
    off += (int64_t)v.size();
  }
  return total;
}

}  // extern "C"
