// Targeted .sig JSON accelerator: extract the "mins"/"abundances"
// integer arrays — 99% of a signature file's bytes — in one native
// pass, so the Python json module only parses the small remainder.
//
// This is NOT a JSON parser: it is a string-aware scanner. It walks the
// buffer tracking JSON string state (quotes + backslash escapes); when a
// completed string token is immediately followed by ':' it is a key, and
// keys named exactly `mins` or `abundances` must introduce an array of
// unsigned integers, which is parsed into u64s. Anything unexpected —
// a non-'[' value, floats, signs, exponents, overflow, malformed
// strings — makes the whole call bail (return -1) and the caller falls
// back to the plain Python path, so behavior never diverges on unusual
// input.

#include <cstdint>

namespace {

struct Scan {
  const uint8_t* b;
  int64_t n;
  int64_t i = 0;

  bool ws() {  // skip whitespace; false at EOF
    while (i < n) {
      const uint8_t c = b[i];
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r')
        i++;
      else
        return true;
    }
    return false;
  }
};

// scan buf; when fill=false only count, else write outputs.
// returns 0 ok / -1 bail. Outputs: values (u64 stream), arr_off
// ([n_arrays+1] value offsets), spans ([n_arrays*2] byte start..end of
// the bracketed array, end exclusive), kind ([n_arrays] 0=mins 1=abund).
static int64_t scan_impl(const uint8_t* buf, int64_t n, bool fill,
                         int64_t* n_arrays_io, int64_t* n_values_io,
                         uint64_t* values, int64_t* arr_off, int64_t* spans,
                         uint8_t* kind) {
  Scan s{buf, n};
  int64_t n_arrays = 0, n_values = 0;
  while (s.i < n) {
    const uint8_t c = buf[s.i];
    if (c != '"') {
      s.i++;
      continue;
    }
    // string token
    const int64_t str_start = ++s.i;
    bool esc = false;
    while (s.i < n) {
      const uint8_t d = buf[s.i];
      if (esc)
        esc = false;
      else if (d == '\\')
        esc = true;
      else if (d == '"')
        break;
      s.i++;
    }
    if (s.i >= n) return -1;  // unterminated string
    const int64_t str_end = s.i;  // exclusive
    s.i++;                        // past closing quote
    if (!s.ws()) break;
    if (buf[s.i] != ':') continue;  // a string VALUE, not a key
    const int64_t len = str_end - str_start;
    int k = -1;
    if (len == 4 && buf[str_start] == 'm' && buf[str_start + 1] == 'i' &&
        buf[str_start + 2] == 'n' && buf[str_start + 3] == 's')
      k = 0;
    else if (len == 10 && buf[str_start] == 'a' && buf[str_start + 1] == 'b' &&
             buf[str_start + 2] == 'u' && buf[str_start + 3] == 'n' &&
             buf[str_start + 4] == 'd' && buf[str_start + 5] == 'a' &&
             buf[str_start + 6] == 'n' && buf[str_start + 7] == 'c' &&
             buf[str_start + 8] == 'e' && buf[str_start + 9] == 's')
      k = 1;
    if (k < 0) continue;  // some other key: its value scans normally
    s.i++;                // past ':'
    if (!s.ws()) return -1;
    if (buf[s.i] != '[') return -1;  // null / object / scalar: bail
    const int64_t span_start = s.i;
    s.i++;
    if (fill) {
      arr_off[n_arrays] = n_values;
      kind[n_arrays] = (uint8_t)k;
    }
    if (!s.ws()) return -1;
    if (buf[s.i] != ']') {
      while (true) {
        if (!s.ws()) return -1;
        uint8_t d = buf[s.i];
        if (d < '0' || d > '9') return -1;  // sign/float/exp/etc: bail
        uint64_t v = 0;
        while (s.i < n) {
          d = buf[s.i];
          if (d < '0' || d > '9') break;
          const uint64_t dig = d - '0';
          if (v > (~0ULL - dig) / 10ULL) return -1;  // u64 overflow
          v = v * 10ULL + dig;
          s.i++;
        }
        if (d == '.' || d == 'e' || d == 'E') return -1;  // float: bail
        if (fill) values[n_values] = v;
        n_values++;
        if (!s.ws()) return -1;
        if (buf[s.i] == ',') {
          s.i++;
          continue;
        }
        if (buf[s.i] == ']') break;
        return -1;
      }
    }
    // s.i at ']'
    s.i++;
    if (fill) {
      spans[2 * n_arrays] = span_start;
      spans[2 * n_arrays + 1] = s.i;
    }
    n_arrays++;
  }
  if (fill) arr_off[n_arrays] = n_values;
  *n_arrays_io = n_arrays;
  *n_values_io = n_values;
  return 0;
}

}  // namespace

extern "C" {

int64_t sig_scan_arrays(const uint8_t* buf, int64_t n, int64_t* n_arrays,
                        int64_t* n_values) {
  return scan_impl(buf, n, false, n_arrays, n_values, nullptr, nullptr,
                   nullptr, nullptr);
}

int64_t sig_extract_arrays(const uint8_t* buf, int64_t n, uint64_t* values,
                           int64_t* arr_off, int64_t* spans, uint8_t* kind) {
  int64_t na = 0, nv = 0;
  return scan_impl(buf, n, true, &na, &nv, values, arr_off, spans, kind);
}

}  // extern "C"
