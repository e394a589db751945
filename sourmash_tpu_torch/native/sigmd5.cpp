// Native sketch-md5: MD5 over the decimal ksize string followed by each
// min's decimal string — the reference's md5sum identity
// (sourmash src/core/src/sketch/minhash.rs:290-307). Loading a
// zip collection computes this for EVERY member (manifest membership is
// md5-keyed), and the Python join-then-hash costs ~1.4 ms per
// genome-scale sketch; this native path converts u64 -> decimal and
// digests in one pass.
//
// MD5 implemented from the RFC 1321 specification (public algorithm).

#include <cstdint>
#include <cstring>

namespace {

struct Md5State {
  uint32_t h[4];
  uint64_t nbytes;
  uint8_t buf[64];
  size_t buf_len;
};

static const uint32_t MD5_K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const uint8_t MD5_R[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

static inline uint32_t rotl(uint32_t x, uint8_t r) {
  return (x << r) | (x >> (32 - r));
}

static void md5_block(Md5State* s, const uint8_t* p) {
  uint32_t m[16];
  for (int i = 0; i < 16; i++) std::memcpy(&m[i], p + 4 * i, 4);  // LE host
  uint32_t a = s->h[0], b = s->h[1], c = s->h[2], d = s->h[3];
  for (int i = 0; i < 64; i++) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    const uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + MD5_K[i] + m[g], MD5_R[i]);
    a = tmp;
  }
  s->h[0] += a;
  s->h[1] += b;
  s->h[2] += c;
  s->h[3] += d;
}

static void md5_init(Md5State* s) {
  s->h[0] = 0x67452301;
  s->h[1] = 0xefcdab89;
  s->h[2] = 0x98badcfe;
  s->h[3] = 0x10325476;
  s->nbytes = 0;
  s->buf_len = 0;
}

static void md5_update(Md5State* s, const uint8_t* data, size_t len) {
  s->nbytes += len;
  if (s->buf_len) {
    const size_t need = 64 - s->buf_len;
    const size_t take = len < need ? len : need;
    std::memcpy(s->buf + s->buf_len, data, take);
    s->buf_len += take;
    data += take;
    len -= take;
    if (s->buf_len == 64) {
      md5_block(s, s->buf);
      s->buf_len = 0;
    }
  }
  while (len >= 64) {
    md5_block(s, data);
    data += 64;
    len -= 64;
  }
  if (len) {
    std::memcpy(s->buf, data, len);
    s->buf_len = len;
  }
}

static void md5_final(Md5State* s, uint8_t out[16]) {
  const uint64_t bitlen = s->nbytes * 8;
  const uint8_t one = 0x80;
  const uint8_t zero = 0x00;
  md5_update(s, &one, 1);
  while (s->buf_len != 56) md5_update(s, &zero, 1);
  std::memcpy(s->buf + 56, &bitlen, 8);  // little-endian length tail
  md5_block(s, s->buf);
  std::memcpy(out, s->h, 16);
}

// write v's decimal digits into buf, return length
static inline int u64_dec(uint64_t v, char* buf) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (v % 10));
    v /= 10;
  } while (v);
  for (int i = 0; i < n; i++) buf[i] = tmp[n - 1 - i];
  return n;
}

}  // namespace

extern "C" {

// MD5 over str(ksize) + str(min_0) + str(min_1) + ... as ASCII decimal,
// hex-encoded into out_hex[32] (no NUL). Returns 0.
int64_t sketch_md5_hex(int64_t ksize, const uint64_t* mins, int64_t n,
                       char* out_hex) {
  Md5State s;
  md5_init(&s);
  char dec[24];
  int len = u64_dec((uint64_t)ksize, dec);
  md5_update(&s, (const uint8_t*)dec, (size_t)len);
  for (int64_t i = 0; i < n; i++) {
    len = u64_dec(mins[i], dec);
    md5_update(&s, (const uint8_t*)dec, (size_t)len);
  }
  uint8_t digest[16];
  md5_final(&s, digest);
  static const char hexd[] = "0123456789abcdef";
  for (int i = 0; i < 16; i++) {
    out_hex[2 * i] = hexd[digest[i] >> 4];
    out_hex[2 * i + 1] = hexd[digest[i] & 15];
  }
  return 0;
}

}  // extern "C"
