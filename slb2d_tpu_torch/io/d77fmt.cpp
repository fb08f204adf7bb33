// The display-77 lines of a chunk's records, formatted natively (built as
// libd77fmt.so beside this file, loaded by io/native.py through ctypes).
//
// A run at display 77 writes ~1,600 lines of 15 "%0.20f" columns; Python's
// f"{x:.20f}" costs ~1 us a value, so the lines of a chunk are formatted
// here in one call, byte for byte what io/writers.py's Python path writes.
//
// Build: make -C slb2d_tpu_torch/io

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// ---- exact "%0.20f" without printf -----------------------------------
//
// For |v| < 1e15, v*10^20 = m * 5^20 * 2^(e+20) computed exactly in
// unsigned __int128 (53-bit mantissa x 47-bit 5^20 = 100 bits), rounded
// half-to-even on the right shift: the correctly rounded digits that glibc
// and Python give under the default rounding mode, at ~20x printf's speed.

const unsigned __int128 POW5_20 = []() {
  unsigned __int128 p = 1;
  for (int i = 0; i < 20; i++) p *= 5;
  return p;
}();
const unsigned __int128 POW10_20 = []() {
  unsigned __int128 p = 1;
  for (int i = 0; i < 20; i++) p *= 10;
  return p;
}();

// 10-digit zero-padded u64 (< 1e10) into out.
inline void put10(uint64_t v, char *out) {
  for (int k = 9; k >= 0; k--) {
    out[k] = char('0' + v % 10);
    v /= 10;
  }
}

// "%0.20f" of a finite |v| < 1e15 into out; returns chars written (<= 37).
inline int fmt20_small(double v, char *out) {
  char *p = out;
  uint64_t bits;
  memcpy(&bits, &v, 8);
  if (bits >> 63) *p++ = '-';       // incl. -0.0, like printf and Python
  uint64_t mant = bits & ((1ULL << 52) - 1);
  int be = int((bits >> 52) & 0x7ff);
  int e;                            // v = m * 2^e
  uint64_t m;
  if (be) { m = mant | (1ULL << 52); e = be - 1075; }
  else    { m = mant;               e = -1074; }

  unsigned __int128 q = 0;
  if (m) {
    unsigned __int128 P = (unsigned __int128)m * POW5_20;
    int s = e + 20;
    if (s >= 0) {
      q = P << s;                   // |v| < 1e15 keeps this in range
    } else if (s >= -127) {
      unsigned __int128 half = (unsigned __int128)1 << (-s - 1);
      unsigned __int128 rem = P & ((half << 1) - 1);
      q = P >> -s;
      if (rem > half || (rem == half && (q & 1))) q += 1;
    }                               // s < -127: rounds to 0
  }
  uint64_t ip = (uint64_t)(q / POW10_20);
  unsigned __int128 fp = q % POW10_20;
  char ibuf[24];
  int ilen = 0;
  do { ibuf[ilen++] = char('0' + ip % 10); ip /= 10; } while (ip);
  while (ilen) *p++ = ibuf[--ilen];
  *p++ = '.';
  put10((uint64_t)(fp / 10000000000ULL), p);
  put10((uint64_t)(fp % 10000000000ULL), p + 10);
  p += 20;
  return int(p - out);
}

// Python's f"{v:.20f}" into out (room for 352 chars): fmt20_small's
// digits below 1e15, printf's exact digits from there up to the largest
// double (331 chars), and "nan", "inf", "-inf" as Python spells them
// (printf writes "-nan" for a NaN whose sign bit is set; Python never).
inline int fmt20_py(double v, char *out) {
  if (std::isnan(v)) { memcpy(out, "nan", 3); return 3; }
  if (std::isinf(v)) {
    if (v < 0) { memcpy(out, "-inf", 4); return 4; }
    memcpy(out, "inf", 3);
    return 3;
  }
  if (v > -1e15 && v < 1e15) return fmt20_small(v, out);
  int n = snprintf(out, 352, "%0.20f", v);
  return n < 0 ? 0 : n;
}

}  // namespace

extern "C" {

// The display-77 lines of R records into buf, as io/writers.py writes
// them.  rows: R x 15 doubles, a line's columns (t in column 13, the norm
// in column 6).  For each record, in this order: with `echo`, the line
// "\n# t=<t> norm=<norm>\n" that the writer echoes to stdout; with
// `lines`, head (NUL-terminated) and the 15 columns, each as Python's
// f"{x:.20f}", joined by spaces and ended by a newline.  Returns the bytes
// written, or -1 where they would pass cap.
long long slb_format_d77_rows(const double *rows, long long R,
                              const char *head, int echo, int lines,
                              char *buf, long long cap) {
  char *p = buf, *end = buf + cap;
  char tmp[352];
  auto put = [&](const char *s, size_t n) {
    if ((size_t)(end - p) < n) return false;
    memcpy(p, s, n);
    p += n;
    return true;
  };
  auto num = [&](double v) { return put(tmp, (size_t)fmt20_py(v, tmp)); };
  const size_t hlen = strlen(head);
  for (long long r = 0; r < R; r++) {
    const double *row = rows + r * 15;
    if (echo && !(put("\n# t=", 5) && num(row[13]) && put(" norm=", 6) &&
                  num(row[6]) && put("\n", 1)))
      return -1;
    if (lines) {
      if (!put(head, hlen)) return -1;
      for (int k = 0; k < 15; k++)
        if (!((k == 0 || put(" ", 1)) && num(row[k]))) return -1;
      if (!put("\n", 1)) return -1;
    }
  }
  return (long long)(p - buf);
}

}  // extern "C"
