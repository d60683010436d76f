// Host image codec of the port: JPEG decode (baseline and progressive
// Huffman), JPEG encode (baseline 4:2:0), PNG row un-filtering, and decode
// plus letterbox of a batch over worker threads.
//
// Plain C interface for ctypes; no Python or PyTorch header. Nothing throws
// across it: each entry point returns 0, or a nonzero code with a message in
// the caller's buffer.
//
// The decoder computes what libjpeg(-turbo) computes with its defaults, which
// is what PIL's decoder runs: the accurate integer IDCT (jidctint.c), fancy
// (triangular) upsampling (jdsample.c) and the fixed-point YCbCr -> RGB
// (jdcolor.c), so its pixels equal PIL's byte for byte. It takes 8-bit
// samples, 1 or 3 components, sampling factors 1 or 2, restart intervals;
// it refuses arithmetic coding, 12-bit, lossless, hierarchical, CMYK/YCCK,
// and progressive files whose scans leave low-frequency coefficients
// unrefined (libjpeg block-smooths those). A truncated or corrupt stream is
// an error, never a partial image.
//
// The letterbox is edgeyolo_tpu/native/io.cpp's: PIL BILINEAR semantics with
// a float triangle filter (antialiased on downscale), gray-114 pads split by
// round(d -+ 0.1), rounding half to even as Python's round().

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

using u8 = uint8_t;

[[noreturn]] void fail(const std::string& msg) { throw std::runtime_error(msg); }

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
}

// Zigzag index -> natural (row-major) index of an 8x8 block.
struct Zigzag {
  int nat[64];
  Zigzag() {
    int i = 0;
    for (int s = 0; s < 15; ++s) {
      if (s % 2 == 0) {  // up and right
        for (int y = std::min(s, 7); y >= 0 && s - y < 8; --y) nat[i++] = y * 8 + (s - y);
      } else {  // down and left
        for (int x = std::min(s, 7); x >= 0 && s - x < 8; --x) nat[i++] = (s - x) * 8 + x;
      }
    }
  }
};
const Zigzag kZigzag;

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------
struct Huffman {
  bool defined = false;
  u8 vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valptr[17];    // index into vals of the first code of each length
  int mincode[17];
  uint16_t fast[512];  // 9-bit lookahead: (length << 8) | value, 0 if longer
};

void build_huffman(Huffman& h, const u8* counts, const u8* vals, int nvals) {
  std::memcpy(h.vals, vals, static_cast<size_t>(nvals));
  std::memset(h.fast, 0, sizeof(h.fast));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int f = 0; f < (1 << shift); ++f)
          h.fast[(code << shift) | f] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

// ---------------------------------------------------------------------------
// Entropy-coded data reader: stops at a marker and feeds zero bits after it;
// a consumer that takes any of those bits has read past the data (truncated
// or corrupt), which `overrun` records.
// ---------------------------------------------------------------------------
struct BitReader {
  const u8* p;
  const u8* end;
  uint64_t buf = 0;
  int cnt = 0;
  long long real = 0;  // bits in buf that came from the stream
  bool at_marker = false;
  bool overrun = false;

  BitReader(const u8* p_, const u8* end_) : p(p_), end(end_) {}

  void fill() {
    while (cnt <= 56) {
      unsigned b = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p != 0xFF) {
          b = *p++;
        } else if (p + 1 < end && p[1] == 0x00) {
          b = 0xFF;
          p += 2;
        } else {
          at_marker = true;  // p stays on the marker's 0xFF
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
      if (!at_marker) real += 8;
    }
  }
  void take(int n) {
    buf <<= n;
    cnt -= n;
    real -= n;
    if (real < 0) overrun = true;
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    take(n);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    uint16_t f = h.fast[buf >> (64 - 9)];
    if (f) {
      take(f >> 8);
      return f & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      int code = static_cast<int>(buf >> (64 - len));
      if (code <= h.maxcode[len]) {
        take(len);
        return h.vals[h.valptr[len] + code - h.mincode[len]];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  // Drop the buffered bits and step over RSTn (after any fill 0xFF bytes).
  void restart(int expected) {
    if (overrun) fail("corrupt JPEG data: premature end of data segment");
    buf = 0;
    cnt = 0;
    real = 0;
    at_marker = false;
    while (p < end && *p == 0xFF && p + 1 < end && p[1] == 0xFF) ++p;
    if (p + 1 >= end || p[0] != 0xFF || p[1] != 0xD0 + expected)
      fail("corrupt JPEG data: missing restart marker");
    p += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------------------
// Frame and decoder
// ---------------------------------------------------------------------------
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;      // blocks covering the component (width_in_blocks)
  int pbw = 0, pbh = 0;    // blocks of the MCU grid (interleaved scans)
  int dw = 0, dh = 0;      // downsampled size in samples
  std::vector<int16_t> coef;  // pbh x pbw blocks of 64, natural order
  uint16_t q[64];
  bool q_latched = false;
  int coef_bits[64];
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
};

struct Decoder {
  const u8* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool have_frame = false, progressive = false, done = false;
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  int eobrun = 0;

  Decoder(const u8* d, size_t n) : data(d), len(n) {}

  int u16(size_t at) const {
    if (at + 2 > len) fail("truncated JPEG");
    return (data[at] << 8) | data[at + 1];
  }

  // Returns the next marker code, positioned after it.
  int next_marker() {
    for (;;) {  // libjpeg skips garbage (and stuffed 0xFF 0x00 pairs) with a warning
      while (pos < len && data[pos] != 0xFF) ++pos;
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) fail("truncated JPEG: no EOI marker");
      if (data[pos] != 0x00) return data[pos++];
    }
  }

  void read_dqt(size_t at, size_t n) {
    size_t end = at + n;
    while (at < end) {
      int pq = data[at] >> 4, tq = data[at] & 15;
      if (tq > 3) fail("corrupt JPEG: bad DQT table id");
      ++at;
      if (at + (pq ? 128 : 64) > end) fail("corrupt JPEG: short DQT");
      for (int k = 0; k < 64; ++k) {
        int val = pq ? u16(at + 2 * k) : data[at + k];
        qt[tq][kZigzag.nat[k]] = static_cast<uint16_t>(val);
      }
      at += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t at, size_t n) {
    size_t end = at + n;
    while (at < end) {
      if (at + 17 > end) fail("corrupt JPEG: short DHT");
      int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT table id");
      const u8* counts = data + at + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || at + 17 + total > end) fail("corrupt JPEG: bad DHT counts");
      build_huffman(tc ? ac[th] : dc[th], counts, data + at + 17, total);
      at += 17 + total;
    }
  }

  void read_sof(size_t at, size_t n, int marker) {
    if (have_frame) fail("corrupt JPEG: two frame headers");
    int precision = data[at];
    H = u16(at + 1);
    W = u16(at + 3);
    ncomp = data[at + 5];
    if (precision != 8) fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    if (H == 0) fail("unsupported JPEG: height defined by a DNL marker");
    if (W == 0) fail("corrupt JPEG: zero width");
    if (ncomp == 4) fail("unsupported JPEG: CMYK/YCCK (4 components)");
    if (ncomp != 1 && ncomp != 3)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (n < 6 + 3 * static_cast<size_t>(ncomp)) fail("corrupt JPEG: short frame header");
    progressive = marker == 0xC2;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = data[at + 6 + 3 * c];
      k.h = data[at + 7 + 3 * c] >> 4;
      k.v = data[at + 7 + 3 * c] & 15;
      k.tq = data[at + 8 + 3 * c];
      if (k.h < 1 || k.h > 2 || k.v < 1 || k.v > 2)
        fail("unsupported JPEG: sampling factor " + std::to_string(k.h) + "x" +
             std::to_string(k.v) + " (1 or 2 only)");
      if (k.tq > 3) fail("corrupt JPEG: bad quantisation table id");
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.dw = (W * k.h + hmax - 1) / hmax;
      k.dh = (H * k.v + vmax - 1) / vmax;
      k.bw = (k.dw + 7) / 8;
      k.bh = (k.dh + 7) / 8;
      k.pbw = mcux * k.h;
      k.pbh = mcuy * k.v;
      k.coef.assign(static_cast<size_t>(k.pbw) * k.pbh * 64, 0);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  int16_t* block(Component& k, int bx, int by) {
    return k.coef.data() + (static_cast<size_t>(by) * k.pbw + bx) * 64;
  }

  // One block of a scan. Sequential: the whole block; progressive: one pass.
  void decode_block(BitReader& br, Component& k, int16_t* blk, int ss, int se, int ah, int al) {
    if (!progressive) {
      int t = br.decode(dc[k.dc_tbl]);
      int diff = t ? extend(br.bits(t), t) : 0;
      k.dc_pred += diff;
      blk[0] = static_cast<int16_t>(k.dc_pred);
      const Huffman& a = ac[k.ac_tbl];
      for (int i = 1; i < 64; ++i) {
        int rs = br.decode(a);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail("corrupt JPEG data: coefficient index past 63");
          blk[kZigzag.nat[i]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scan
      if (ah == 0) {
        int t = br.decode(dc[k.dc_tbl]);
        int diff = t ? extend(br.bits(t), t) : 0;
        k.dc_pred += diff;
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(k.dc_pred) << al);
      } else if (br.bit()) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& a = ac[k.ac_tbl];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int i = ss; i <= se; ++i) {
        int rs = br.decode(a);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail("corrupt JPEG data: coefficient index past 63");
          blk[kZigzag.nat[i]] =
              static_cast<int16_t>(static_cast<unsigned>(extend(br.bits(s), s)) << al);
        } else if (r == 15) {
          i += 15;
        } else {
          eobrun = (1 << r) - 1;
          if (r) eobrun += br.bits(r);
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -(1 << al);
    int i = ss;
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        int rs = br.decode(a);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: bad refinement value");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = blk + kZigzag.nat[i];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) {
          if (i > 63) fail("corrupt JPEG data: coefficient index past 63");
          blk[kZigzag.nat[i]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kZigzag.nat[i];
        if (*c != 0 && br.bit() && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  void read_sos(size_t at, size_t n) {
    if (!have_frame) fail("corrupt JPEG: scan before frame header");
    int ns = data[at];
    if (ns < 1 || ns > ncomp || n < 4 + 2 * static_cast<size_t>(ns))
      fail("corrupt JPEG: bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cid = data[at + 1 + 2 * i], tables = data[at + 2 + 2 * i];
      int c = 0;
      while (c < ncomp && comp[c].id != cid) ++c;
      if (c == ncomp) fail("corrupt JPEG: scan names an unknown component");
      sc[i] = &comp[c];
      sc[i]->dc_tbl = tables >> 4;
      sc[i]->ac_tbl = tables & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) fail("corrupt JPEG: bad Huffman table id");
    }
    size_t p = at + 1 + 2 * ns;
    int ss = data[p], se = data[p + 1], ah = data[p + 2] >> 4, al = data[p + 2] & 15;
    if (progressive) {
      bool bad = ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1);
      if (bad) fail("corrupt JPEG: bad progressive scan parameters");
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        for (int k = ss; k <= se; ++k) {
          if ((ah == 0) != (cb[k] < 0) || (ah != 0 && cb[k] != ah))
            fail("corrupt JPEG: progressive scans out of order");
          cb[k] = al;
        }
      }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("corrupt JPEG: bad sequential scan parameters");
    }
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (!k.q_latched) {  // libjpeg latches the table at the component's first scan
        if (!qt_defined[k.tq]) fail("corrupt JPEG: undefined quantisation table");
        std::memcpy(k.q, qt[k.tq], sizeof(k.q));
        k.q_latched = true;
      }
      bool need_dc = !progressive || ss == 0 ? (ah == 0) : false;
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[k.dc_tbl].defined) || (need_ac && !ac[k.ac_tbl].defined))
        fail("corrupt JPEG: undefined Huffman table");
      k.dc_pred = 0;
    }
    BitReader br(data + pos, data + len);
    eobrun = 0;
    int done_mcus = 0, rst = 0;
    auto restart_check = [&]() {
      if (restart_interval && done_mcus % restart_interval == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        eobrun = 0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      }
    };
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component& k = *sc[0];
      int total = k.bw * k.bh;
      for (int b = 0; b < total; ++b) {
        if (b > 0) restart_check();
        decode_block(br, k, block(k, b % k.bw, b / k.bw), ss, se, ah, al);
        ++done_mcus;
      }
    } else {
      int total = mcux * mcuy;
      for (int m = 0; m < total; ++m) {
        if (m > 0) restart_check();
        int mx = m % mcux, my = m / mcux;
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          for (int by = 0; by < k.v; ++by)
            for (int bx = 0; bx < k.h; ++bx)
              decode_block(br, k, block(k, mx * k.h + bx, my * k.v + by), ss, se, ah, al);
        }
        ++done_mcus;
      }
    }
    if (br.overrun) fail("corrupt JPEG data: premature end of data segment");
    pos = static_cast<size_t>(br.p - data);
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        done = true;
        break;
      }
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      size_t n = static_cast<size_t>(u16(pos));
      if (n < 2 || pos + n > len) fail("truncated JPEG: marker segment past the end");
      size_t at = pos + 2, body = n - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(at, body, m);
          break;
        case 0xC3: fail("unsupported JPEG: lossless");
        case 0xC5: case 0xC6: case 0xC7: fail("unsupported JPEG: hierarchical (differential)");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:
          fail("unsupported JPEG: arithmetic coding");
        case 0xDE: case 0xDF: fail("unsupported JPEG: hierarchical");
        case 0xDC: fail("unsupported JPEG: DNL marker");
        case 0xC4: read_dht(at, body); break;
        case 0xDB: read_dqt(at, body); break;
        case 0xDD:
          restart_interval = u16(at);
          break;
        case 0xE0:
          if (body >= 5 && std::memcmp(data + at, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (body >= 12 && std::memcmp(data + at, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[at + 11];
          }
          break;
        case 0xDA:
          pos += n;
          read_sos(at, body);
          continue;
        default:
          break;  // APPn, COM and others: skipped
      }
      pos += n;
    }
    if (!have_frame) fail("corrupt JPEG: no frame header");
    for (int c = 0; c < ncomp; ++c) {
      if (!comp[c].q_latched) fail("corrupt JPEG: a component has no scan");
    }
    if (progressive) {
      // libjpeg block-smooths (jdcoefct.c smoothing_ok) when the DC is known and
      // a coefficient among the first ten is not fully refined
      bool useful = false, ok = true;
      for (int c = 0; c < ncomp; ++c) {
        if (comp[c].coef_bits[0] < 0) ok = false;
        for (int k = 1; k < 10; ++k) useful |= comp[c].coef_bits[k] != 0;
      }
      if (ok && useful)
        fail("unsupported JPEG: progressive scans leave coefficients unrefined (block smoothing)");
    }
  }
};

// ---------------------------------------------------------------------------
// Accurate integer IDCT (libjpeg jidctint.c, jpeg_idct_islow)
// ---------------------------------------------------------------------------
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr long F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
               F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
               F2_562 = 20995, F3_072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// Post-IDCT range limit of jdmaster.c (prepare_range_limit_table), indexed by
// (x & 1023) where x is the centred sample.
struct RangeLimit {
  u8 t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<u8>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<u8>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, u8* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    long z1 = (z2 + z3) * F0_541;
    long tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    long tmp0 = (z2 + z3) * (1L << CONST_BITS), tmp1 = (z2 - z3) * (1L << CONST_BITS);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, S));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, S));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, S));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, S));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, S));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, S));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, S));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, S));
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    u8* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      u8 v = kRange.t[static_cast<int>(descale(wp[0], PASS1_BITS + 3)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * F0_541;
    long tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    long tmp0 = (static_cast<long>(wp[0]) + wp[4]) * (1L << CONST_BITS);
    long tmp1 = (static_cast<long>(wp[0]) - wp[4]) * (1L << CONST_BITS);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, S2)) & 1023];
    op[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, S2)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, S2)) & 1023];
    op[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, S2)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, S2)) & 1023];
    op[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, S2)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, S2)) & 1023];
    op[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, S2)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Reduced-size IDCTs (libjpeg jidctred.c: jpeg_idct_4x4, _2x2, _1x1), which
// decode a block at 1/2, 1/4 or 1/8 scale in the DCT domain. Their all-zero
// shortcuts give the full path's values, so only the full path is written.
// ---------------------------------------------------------------------------
constexpr long R0_211 = 1730, R0_509 = 4176, R0_601 = 4926, R0_720 = 5906, R0_850 = 6967,
               R1_061 = 8697, R1_272 = 10426, R1_451 = 11893, R2_172 = 17799, R3_624 = 29692;

void idct_4x4(const int16_t* in, const uint16_t* q, u8* out, int stride) {
  int ws[32];  // 4 rows of 8 columns (column 4 unused)
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    long tmp0 = static_cast<long>(ip[0] * qp[0]) * (1L << (CONST_BITS + 1));
    long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    long tmp2 = z2 * F1_847 + z3 * -F0_765;
    long tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    long z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    long z4 = ip[8] * qp[8];
    tmp0 = z1 * -R0_211 + z2 * R1_451 + z3 * -R2_172 + z4 * R1_061;
    tmp2 = z1 * -R0_509 + z2 * -R0_601 + z3 * F0_899 + z4 * F2_562;
    constexpr int S = CONST_BITS - PASS1_BITS + 1;
    ws[c] = static_cast<int>(descale(tmp10 + tmp2, S));
    ws[24 + c] = static_cast<int>(descale(tmp10 - tmp2, S));
    ws[8 + c] = static_cast<int>(descale(tmp12 + tmp0, S));
    ws[16 + c] = static_cast<int>(descale(tmp12 - tmp0, S));
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    u8* op = out + static_cast<size_t>(r) * stride;
    long tmp0 = static_cast<long>(wp[0]) * (1L << (CONST_BITS + 1));
    long tmp2 = wp[2] * F1_847 + wp[6] * -F0_765;
    long tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    long z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -R0_211 + z2 * R1_451 + z3 * -R2_172 + z4 * R1_061;
    tmp2 = z1 * -R0_509 + z2 * -R0_601 + z3 * F0_899 + z4 * F2_562;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp2, S2)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp10 - tmp2, S2)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp12 + tmp0, S2)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 - tmp0, S2)) & 1023];
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, u8* out, int stride) {
  int ws[16];  // 2 rows of 8 columns (columns 2, 4 and 6 unused)
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    long tmp10 = static_cast<long>(ip[0] * qp[0]) * (1L << (CONST_BITS + 2));
    long tmp0 = static_cast<long>(ip[56] * qp[56]) * -R0_720 +
                static_cast<long>(ip[40] * qp[40]) * R0_850 +
                static_cast<long>(ip[24] * qp[24]) * -R1_272 +
                static_cast<long>(ip[8] * qp[8]) * R3_624;
    constexpr int S = CONST_BITS - PASS1_BITS + 2;
    ws[c] = static_cast<int>(descale(tmp10 + tmp0, S));
    ws[8 + c] = static_cast<int>(descale(tmp10 - tmp0, S));
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    u8* op = out + static_cast<size_t>(r) * stride;
    long tmp10 = static_cast<long>(wp[0]) * (1L << (CONST_BITS + 2));
    long tmp0 = wp[7] * -R0_720 + wp[5] * R0_850 + wp[3] * -R1_272 + wp[1] * R3_624;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp0, S2)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp10 - tmp0, S2)) & 1023];
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, u8* out, int) {
  out[0] = kRange.t[static_cast<int>(descale(in[0] * q[0], 3)) & 1023];
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c, fancy) into a full-resolution plane of W x H
// ---------------------------------------------------------------------------
// src: the component's samples, dw x dh valid in a plane of `sstride` columns.
// `fancy` is libjpeg's do_fancy: off when the luma blocks decode to 1 x 1.
void upsample(const u8* src, int sstride, int dw, int dh, int fh, int fv, bool fancy, u8* dst,
              int W, int H) {
  std::vector<u8> row(static_cast<size_t>(2 * dw + 2));
  std::vector<int> cs(static_cast<size_t>(dw));
  auto srow = [&](int y) { return src + static_cast<size_t>(std::clamp(y, 0, dh - 1)) * sstride; };
  for (int y = 0; y < H; ++y) {
    u8* out = dst + static_cast<size_t>(y) * W;
    if (fh == 1 && fv == 1) {
      std::memcpy(out, srow(y), static_cast<size_t>(W));
      continue;
    }
    if (fancy && fv == 2 && (fh == 1 || dw > 2)) {  // vertical triangle: 3/4 nearer row, 1/4 further
      const u8* near = srow(y / 2);
      const u8* far = srow(y % 2 == 0 ? y / 2 - 1 : y / 2 + 1);
      if (fh == 1) {
        int bias = y % 2 == 0 ? 1 : 2;
        for (int x = 0; x < W; ++x) out[x] = static_cast<u8>((near[x] * 3 + far[x] + bias) >> 2);
        continue;
      }
      // h2v2: column sums, then the horizontal triangle with biases 8 and 7
      for (int x = 0; x < dw; ++x) cs[x] = near[x] * 3 + far[x];
      u8* o = row.data();
      o[0] = static_cast<u8>((cs[0] * 4 + 8) >> 4);
      o[1] = static_cast<u8>((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        o[2 * x] = static_cast<u8>((cs[x] * 3 + cs[x - 1] + 8) >> 4);
        o[2 * x + 1] = static_cast<u8>((cs[x] * 3 + cs[x + 1] + 7) >> 4);
      }
      o[2 * dw - 2] = static_cast<u8>((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
      o[2 * dw - 1] = static_cast<u8>((cs[dw - 1] * 4 + 7) >> 4);
      std::memcpy(out, o, static_cast<size_t>(W));
      continue;
    }
    const u8* in = srow(fv == 2 ? y / 2 : y);  // no vertical filter: replicate rows
    if (fh == 1) {
      std::memcpy(out, in, static_cast<size_t>(W));
    } else if (fancy && dw > 2 && fv == 1) {  // h2v1 fancy: biases 1 and 2
      u8* o = row.data();
      o[0] = in[0];
      o[1] = static_cast<u8>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        o[2 * x] = static_cast<u8>((in[x] * 3 + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<u8>((in[x] * 3 + in[x + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = static_cast<u8>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
      std::memcpy(out, o, static_cast<size_t>(W));
    } else {  // plain replication (libjpeg's h2v1/h2v2_upsample: narrow images, 1/8 scale)
      for (int x = 0; x < W; ++x) out[x] = in[x / 2];
    }
  }
}

// YCbCr -> RGB tables of jdcolor.c (build_ycc_rgb_table)
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SB = 16;
    constexpr long HALF = 1L << (SB - 1);
    auto fix = [](double x) { return static_cast<long>(x * (1L << SB) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      long x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
  }
};
const YccTables kYcc;

inline u8 clamp255(int v) { return static_cast<u8>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

struct Image {
  int w = 0, h = 0;    // decoded size (after any DCT-domain scale)
  int w0 = 0, h0 = 0;  // the frame's size
  std::vector<u8> rgb;
};

// edgeyolo_tpu/native/io.cpp's choice of scale for a letterbox to `target`:
// halve while the decoded long side keeps at least twice the target, to 1/8.
int prescale_denom(int w0, int h0, int target) {
  int long_side = std::max(w0, h0), denom = 1;
  while (target > 0 && denom < 8 && long_side / (denom * 2) >= 2 * target) denom *= 2;
  return denom;
}

inline int div_up(long a, long b) { return static_cast<int>((a + b - 1) / b); }

// Decodes at 1/denom scale (denom 1, 2, 4 or 8) as libjpeg does with
// scale_num 1 (jdmaster.c jpeg_calc_output_dimensions): the luma blocks
// decode to m = 8/denom samples a side; a chroma component takes the
// largest size up to 8 that leaves it at the luma's resolution (so 4:2:0
// chroma needs no upsampling once scaled); what remains is upsampled, with
// the triangle filters only while m > 1. A `target` > 0 picks the denom
// from the frame's size (prescale_denom) instead.
Image decode_jpeg(const u8* buf, size_t len, int denom = 1, int target = 0) {
  Decoder d(buf, len);
  d.parse();
  if (target > 0) denom = prescale_denom(d.W, d.H, target);
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) fail("JPEG scale must be 1/1, 1/2, 1/4 or 1/8");
  const int m = 8 / denom;
  Image img;
  img.w0 = d.W;
  img.h0 = d.H;
  img.w = div_up(static_cast<long>(d.W) * m, 8);
  img.h = div_up(static_cast<long>(d.H) * m, 8);
  const int W = img.w, H = img.h;
  std::vector<std::vector<u8>> planes(static_cast<size_t>(d.ncomp));
  for (int c = 0; c < d.ncomp; ++c) {
    Component& k = d.comp[c];
    int ss = m;
    while (ss < 8 && (d.hmax * m) % (k.h * ss * 2) == 0 && (d.vmax * m) % (k.v * ss * 2) == 0) ss *= 2;
    void (*idct)(const int16_t*, const uint16_t*, u8*, int) =
        ss == 8 ? idct_islow : ss == 4 ? idct_4x4 : ss == 2 ? idct_2x2 : idct_1x1;
    int stride = k.bw * ss;
    std::vector<u8> samples(static_cast<size_t>(stride) * k.bh * ss);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct(d.block(k, bx, by), k.q,
             samples.data() + static_cast<size_t>(by) * ss * stride + bx * ss, stride);
    int dw = div_up(static_cast<long>(d.W) * k.h * ss, d.hmax * 8L);
    int dh = div_up(static_cast<long>(d.H) * k.v * ss, d.vmax * 8L);
    planes[c].resize(static_cast<size_t>(W) * H);
    upsample(samples.data(), stride, dw, dh, d.hmax * m / (k.h * ss), d.vmax * m / (k.v * ss),
             m > 1, planes[c].data(), W, H);
  }
  img.rgb.resize(static_cast<size_t>(W) * H * 3);
  u8* o = img.rgb.data();
  size_t n = static_cast<size_t>(W) * H;
  if (d.ncomp == 1) {
    const u8* y = planes[0].data();
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = y[i];
    return img;
  }
  bool rgb = false;  // jdapimin.c default_decompress_parms
  if (d.jfif) rgb = false;
  else if (d.adobe) rgb = d.adobe_transform == 0;
  else rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  const u8 *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
  if (rgb) {
    for (size_t i = 0; i < n; ++i) {
      o[3 * i] = p0[i];
      o[3 * i + 1] = p1[i];
      o[3 * i + 2] = p2[i];
    }
    return img;
  }
  for (size_t i = 0; i < n; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    o[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    o[3 * i + 1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    o[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
  return img;
}

// ---------------------------------------------------------------------------
// Baseline encoder: 4:2:0, 4:2:2, 4:4:0, 4:4:4 or gray, Annex K tables, jfdctint forward
// DCT, libjpeg's downsampling, edge padding and dummy blocks (so its files are libjpeg's)
// ---------------------------------------------------------------------------
const u8 kStdQ[2][64] = {  // natural order
    {16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

const u8 kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                           {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const u8 kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const u8 kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                           {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const u8 kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct Codes {
  uint16_t code[256];
  u8 size[256];
};

Codes make_codes(const u8* bits, const u8* vals) {
  Codes c{};
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      c.code[vals[k]] = static_cast<uint16_t>(code);
      c.size[vals[k]] = static_cast<u8>(len);
    }
    code <<= 1;
  }
  return c;
}

struct BitWriter {
  std::vector<u8>& out;
  uint64_t acc = 0;
  int n = 0;  // pending bits in the low end of acc
  explicit BitWriter(std::vector<u8>& o) : out(o) {}
  void put(uint32_t bits, int len) {
    acc = (acc << len) | (bits & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      n -= 8;
      u8 b = static_cast<u8>(acc >> n);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);  // byte stuffing
    }
  }
  void flush() {
    if (n) put((1u << (8 - n)) - 1, 8 - n);  // pad with 1-bits
  }
};

// jfdctint.c: 8x8 forward DCT, output scaled up by 8
void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    int step = pass == 0 ? 1 : 8, line = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * line;
      long tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      long tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      long tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      long tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int sh = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
      if (pass == 0) {
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        p[0] = static_cast<int>(descale(tmp10 + tmp11, PASS1_BITS));
        p[4 * step] = static_cast<int>(descale(tmp10 - tmp11, PASS1_BITS));
      }
      long z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = static_cast<int>(descale(z1 + tmp13 * F0_765, sh));
      p[6 * step] = static_cast<int>(descale(z1 + tmp12 * -F1_847, sh));
      z1 = tmp4 + tmp7;
      long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      long z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
      p[5 * step] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
      p[3 * step] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
      p[step] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
    }
  }
}

void put16(std::vector<u8>& o, int v) {
  o.push_back(static_cast<u8>(v >> 8));
  o.push_back(static_cast<u8>(v & 0xFF));
}

// (sh, sv): the luma sampling factors over chroma's 1 x 1 (2, 2 is 4:2:0; 2, 1 is
// 4:2:2; 1, 2 is 4:4:0; 1, 1 is 4:4:4); gray is one component at 1 x 1.
std::vector<u8> encode_jpeg(const u8* rgb, int W, int H, int channels, int quality, int sh,
                            int sv) {
  if (W < 1 || H < 1 || W > 65535 || H > 65535) fail("JPEG size out of range");
  if (channels != 1 && channels != 3) fail("JPEG encode takes 1 or 3 channels");
  if (sh < 1 || sh > 2 || sv < 1 || sv > 2) fail("JPEG sampling factors are 1 or 2");
  quality = std::clamp(quality, 1, 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jpeg_quality_scaling
  uint16_t q[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i)
      q[t][i] = static_cast<uint16_t>(std::clamp((kStdQ[t][i] * scale + 50) / 100, 1, 255));
  const bool color = channels == 3;
  if (!color) sh = sv = 1;
  const int mw = 8 * sh, mh = 8 * sv;  // the MCU
  const int PW = (W + mw - 1) / mw * mw, PH = (H + mh - 1) / mh * mh;
  // planes padded to the MCU grid by edge replication
  std::vector<std::vector<u8>> planes(static_cast<size_t>(channels),
                                      std::vector<u8>(static_cast<size_t>(PW) * PH));
  for (int y = 0; y < PH; ++y) {
    const u8* src = rgb + static_cast<size_t>(std::min(y, H - 1)) * W * channels;
    for (int x = 0; x < PW; ++x) {
      const u8* px = src + static_cast<size_t>(std::min(x, W - 1)) * channels;
      size_t i = static_cast<size_t>(y) * PW + x;
      if (!color) {
        planes[0][i] = px[0];
        continue;
      }
      // jccolor.c rgb_ycc_convert
      constexpr long HALF = 1L << 15, OFF = 128L << 16;
      long r = px[0], g = px[1], b = px[2];
      planes[0][i] = static_cast<u8>((19595 * r + 38470 * g + 7471 * b + HALF) >> 16);
      planes[1][i] = static_cast<u8>((-11059 * r - 21709 * g + 32768 * b + OFF + HALF - 1) >> 16);
      planes[2][i] = static_cast<u8>((32768 * r - 27439 * g - 5329 * b + OFF + HALF - 1) >> 16);
    }
  }
  const int CW = PW / sh, CH = PH / sv;
  if (color && sh * sv > 1) {  // jcsample.c: h2v1, h2v2 and (for h1v2) int_downsample
    const int real = (H + sv - 1) / sv;
    for (int c = 1; c < 3; ++c) {
      std::vector<u8> down(static_cast<size_t>(CW) * CH);
      for (int y = 0; y < CH; ++y)
        for (int x = 0; x < CW; ++x) {
          const u8* a = planes[c].data() + static_cast<size_t>(sv * y) * PW + sh * x;
          int v;
          if (sh == 2 && sv == 2) v = (a[0] + a[1] + a[PW] + a[PW + 1] + 1 + (x & 1)) >> 2;
          else if (sh == 2) v = (a[0] + a[1] + (x & 1)) >> 1;  // bias 0, 1 alternating
          else v = (a[0] + a[PW] + 1) / 2;
          down[static_cast<size_t>(y) * CW + x] = static_cast<u8>(v);
        }
      // below the image, libjpeg (jcprepct.c) repeats the last downsampled row
      for (int y = real; y < CH; ++y)
        std::memcpy(down.data() + static_cast<size_t>(y) * CW,
                    down.data() + static_cast<size_t>(real - 1) * CW, static_cast<size_t>(CW));
      planes[c] = std::move(down);
    }
  }
  std::vector<u8> out;
  out.reserve(static_cast<size_t>(W) * H / 2 + 1024);
  const u8 hdr[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), hdr, hdr + sizeof(hdr));
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back(static_cast<u8>(t));
    for (int k = 0; k < 64; ++k) out.push_back(static_cast<u8>(q[t][kZigzag.nat[k]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * channels);
  out.push_back(8);
  put16(out, H);
  put16(out, W);
  out.push_back(static_cast<u8>(channels));
  for (int c = 0; c < channels; ++c) {
    out.push_back(static_cast<u8>(c + 1));
    out.push_back(static_cast<u8>(c == 0 ? (sh << 4) | sv : 0x11));
    out.push_back(c == 0 ? 0 : 1);
  }
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    for (int kind = 0; kind < 2; ++kind) {
      const u8* bits = kind == 0 ? kDcBits[t] : kAcBits[t];
      const u8* vals = kind == 0 ? kDcVals : kAcVals[t];
      int nv = 0;
      for (int i = 0; i < 16; ++i) nv += bits[i];
      out.push_back(0xFF);
      out.push_back(0xC4);
      put16(out, 3 + 16 + nv);
      out.push_back(static_cast<u8>((kind << 4) | t));
      out.insert(out.end(), bits, bits + 16);
      out.insert(out.end(), vals, vals + nv);
    }
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * channels);
  out.push_back(static_cast<u8>(channels));
  for (int c = 0; c < channels; ++c) {
    out.push_back(static_cast<u8>(c + 1));
    out.push_back(c == 0 ? 0x00 : 0x11);
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);
  Codes dcc[2] = {make_codes(kDcBits[0], kDcVals), make_codes(kDcBits[1], kDcVals)};
  Codes acc[2] = {make_codes(kAcBits[0], kAcVals[0]), make_codes(kAcBits[1], kAcVals[1])};
  BitWriter bw(out);
  int pred[3] = {0, 0, 0};
  // Returns the block's quantised DC. A dummy block (luma past the image's
  // blocks, filling the MCU) is coded as libjpeg codes it: AC 0, DC `dummy_dc`.
  auto encode_block = [&](int c, const u8* src, int stride, const int* dummy_dc) {
    int t = c == 0 ? 0 : 1;
    int qz[64] = {};
    if (dummy_dc) {
      qz[0] = *dummy_dc;
    } else {
      int blk[64];
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) blk[y * 8 + x] = src[static_cast<size_t>(y) * stride + x] - 128;
      fdct_islow(blk);
      for (int i = 0; i < 64; ++i) {  // jcdctmgr.c quantize: round half away from zero
        int div = q[t][i] * 8, v = blk[i];
        qz[i] = v < 0 ? -((-v + div / 2) / div) : (v + div / 2) / div;
      }
    }
    auto emit_value = [&](int v, const Codes& cd, int sym_hi) {
      int a = v < 0 ? -v : v, nb = 0;
      while (a) { ++nb; a >>= 1; }
      int sym = sym_hi | nb;
      bw.put(cd.code[sym], cd.size[sym]);
      if (nb) bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
    };
    emit_value(qz[0] - pred[c], dcc[t], 0);
    pred[c] = qz[0];
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = qz[kZigzag.nat[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(acc[t].code[0xF0], acc[t].size[0xF0]);
        run -= 16;
      }
      emit_value(v, acc[t], run << 4);
      run = 0;
    }
    if (run) bw.put(acc[t].code[0], acc[t].size[0]);
    return qz[0];
  };
  const int wib = (W + 7) / 8, hib = (H + 7) / 8;  // luma blocks that cover the image
  for (int my = 0; my < PH / mh; ++my)
    for (int mx = 0; mx < PW / mw; ++mx) {
      // jccoefct.c: a dummy block (past the image, filling the MCU) copies the DC of
      // the block before it; a dummy row, that of the last block of the row above
      int dc[4];
      for (int by = 0; by < sv; ++by)
        for (int bx = 0; bx < sh; ++bx) {
          int k = by * sh + bx;
          const int* dummy = my * sv + by >= hib ? &dc[by * sh - 1]
                             : (mx * sh + bx >= wib ? &dc[k - 1] : nullptr);
          dc[k] = encode_block(0, planes[0].data() + static_cast<size_t>(my * mh + by * 8) * PW +
                                      mx * mw + bx * 8, PW, dummy);
        }
      if (color)
        for (int c = 1; c < 3; ++c)
          encode_block(c, planes[c].data() + static_cast<size_t>(my) * 8 * CW + mx * 8, CW,
                       nullptr);
    }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

// ---------------------------------------------------------------------------
// Letterbox (edgeyolo_tpu/native/io.cpp make_taps / resize_bilinear)
// ---------------------------------------------------------------------------
struct Taps {
  std::vector<int> start, count;
  std::vector<float> weight;
  int max_taps = 0;
};

Taps make_taps(int src_n, int dst_n) {
  Taps t;
  double scale = static_cast<double>(src_n) / dst_n;
  double support = scale > 1.0 ? scale : 1.0;
  t.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.start.resize(dst_n);
  t.count.resize(dst_n);
  t.weight.assign(static_cast<size_t>(dst_n) * t.max_taps, 0.f);
  for (int i = 0; i < dst_n; ++i) {
    double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, src_n);
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double d = (j + 0.5 - center) / support;
      double w = d < 0 ? 1.0 + d : 1.0 - d;
      if (w < 0) w = 0;
      t.weight[static_cast<size_t>(i) * t.max_taps + (j - lo)] = static_cast<float>(w);
      total += w;
    }
    if (total > 0)
      for (int j = 0; j < hi - lo; ++j)
        t.weight[static_cast<size_t>(i) * t.max_taps + j] /= static_cast<float>(total);
    t.start[i] = lo;
    t.count[i] = hi - lo;
  }
  return t;
}

void resize_bilinear(const u8* src, int sh, int sw, u8* dst, int dh, int dw, int dstride) {
  Taps tx = make_taps(sw, dw), ty = make_taps(sh, dh);
  std::vector<float> mid(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const u8* row = src + static_cast<size_t>(y) * sw * 3;
    float* m = mid.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      const float* w = tx.weight.data() + static_cast<size_t>(x) * tx.max_taps;
      for (int j = 0; j < tx.count[x]; ++j) {
        const u8* p = row + (static_cast<size_t>(tx.start[x]) + j) * 3;
        a0 += w[j] * p[0];
        a1 += w[j] * p[1];
        a2 += w[j] * p[2];
      }
      m[x * 3] = a0;
      m[x * 3 + 1] = a1;
      m[x * 3 + 2] = a2;
    }
  }
  for (int y = 0; y < dh; ++y) {
    u8* d = dst + static_cast<size_t>(y) * dstride;
    const float* w = ty.weight.data() + static_cast<size_t>(y) * ty.max_taps;
    for (int x = 0; x < dw * 3; ++x) {
      float a = 0.f;
      for (int j = 0; j < ty.count[y]; ++j)
        a += w[j] * mid[(static_cast<size_t>(ty.start[y]) + j) * dw * 3 + x];
      int v = static_cast<int>(a + 0.5f);
      d[x] = static_cast<u8>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
extern "C" {

struct EyioSource {  // one image of a batch: JPEG bytes, or RGB pixels
  const uint8_t* data;
  uint64_t len;
  int32_t kind;  // 0: JPEG bytes; 1: (h, w, 3) uint8 pixels
  int32_t h, w;
};

struct EyioMeta {
  int32_t h0, w0;
  double r;
  int32_t pw, ph;
};

// Decodes at 1/denom scale (1, 2, 4 or 8) into `out` (h x w x 3), whose size
// the caller computed from the frame header; a frame of another size is an error.
int eyio_jpeg_decode(const uint8_t* buf, uint64_t len, int32_t denom, uint8_t* out, int32_t w,
                     int32_t h, char* err, int errlen) {
  try {
    Image img = decode_jpeg(buf, len, denom);
    if (img.w != w || img.h != h) fail("JPEG frame size differs from its first header");
    std::memcpy(out, img.rgb.data(), img.rgb.size());
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Encodes (h, w, channels) uint8 pixels, luma sampled (sh, sv) against chroma;
// *out is malloc'd, freed by eyio_free.
int eyio_jpeg_encode(const uint8_t* pixels, int32_t w, int32_t h, int32_t channels,
                     int32_t quality, int32_t sh, int32_t sv, uint8_t** out, uint64_t* out_len,
                     char* err, int errlen) {
  try {
    std::vector<u8> bytes = encode_jpeg(pixels, w, h, channels, quality, sh, sv);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) fail("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    *out_len = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

void eyio_free(void* p) { std::free(p); }

// PNG: undo the five row filters of `h` rows of `stride` bytes (each row led
// by its filter byte) into out (h x stride).
int eyio_png_unfilter(const uint8_t* raw, uint64_t len, int32_t h, int32_t stride, int32_t bpp,
                      uint8_t* out, char* err, int errlen) {
  if (len < static_cast<uint64_t>(h) * (static_cast<uint64_t>(stride) + 1)) {
    set_err(err, errlen, "PNG image data is truncated");
    return 1;
  }
  std::vector<u8> zero(static_cast<size_t>(stride), 0);
  for (int y = 0; y < h; ++y) {
    const u8* in = raw + static_cast<size_t>(y) * (stride + 1);
    int ftype = in[0];
    ++in;
    u8* cur = out + static_cast<size_t>(y) * stride;
    const u8* prev = y ? cur - stride : zero.data();
    switch (ftype) {
      case 0: std::memcpy(cur, in, static_cast<size_t>(stride)); break;
      case 1:
        for (int i = 0; i < stride; ++i) cur[i] = static_cast<u8>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = static_cast<u8>(in[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<u8>(in[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
          int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          cur[i] = static_cast<u8>(in[i] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c)));
        }
        break;
      default: {
        char msg[64];
        std::snprintf(msg, sizeof(msg), "bad PNG filter type %d", ftype);
        set_err(err, errlen, msg);
        return 1;
      }
    }
  }
  return 0;
}

// Decode (JPEG sources) and letterbox n images onto (H, W) canvases of `out`
// (n x H x W x 3), over `threads` threads, each writing its own images. Onto a
// square canvas a JPEG decodes at the DCT-domain scale of native/io.cpp
// (prescale_denom); a rect canvas takes the full-size decode, as JAX's PIL
// path does there. Returns 0, or 1 + the index of the first image that
// failed, with its message.
int eyio_letterbox_batch(int32_t n, const EyioSource* src, int32_t H, int32_t W, int32_t scaleup,
                         int32_t threads, uint8_t* out, EyioMeta* meta, char* err, int errlen) {
  std::vector<std::string> errors(static_cast<size_t>(n));
  const size_t frame = static_cast<size_t>(H) * W * 3;
  auto one = [&](int i) {
    try {
      Image dec;
      const u8* px;
      int h0, w0;
      int hd, wd;  // the decoded size
      if (src[i].kind == 0) {
        dec = decode_jpeg(src[i].data, src[i].len, 1, H == W ? H : 0);
        px = dec.rgb.data();
        h0 = dec.h0;
        w0 = dec.w0;
        hd = dec.h;
        wd = dec.w;
      } else {
        px = src[i].data;
        h0 = hd = src[i].h;
        w0 = wd = src[i].w;
        if (src[i].len != static_cast<uint64_t>(h0) * w0 * 3) fail("pixel buffer size mismatch");
      }
      double r = std::min(static_cast<double>(H) / h0, static_cast<double>(W) / w0);
      if (!scaleup) r = std::min(r, 1.0);
      // Python's round(): half to even, as nearbyint in the default rounding mode
      int nw = static_cast<int>(std::nearbyint(w0 * r)), nh = static_cast<int>(std::nearbyint(h0 * r));
      if (nw < 1 || nh < 1) fail("image too small to letterbox");
      int left = static_cast<int>(std::nearbyint((W - nw) / 2.0 - 0.1));
      int top = static_cast<int>(std::nearbyint((H - nh) / 2.0 - 0.1));
      u8* o = out + frame * i;
      std::memset(o, 114, frame);
      u8* dst = o + (static_cast<size_t>(top) * W + left) * 3;
      if (nw == wd && nh == hd) {
        for (int y = 0; y < hd; ++y)
          std::memcpy(dst + static_cast<size_t>(y) * W * 3, px + static_cast<size_t>(y) * wd * 3,
                      static_cast<size_t>(wd) * 3);
      } else {
        resize_bilinear(px, hd, wd, dst, nh, nw, W * 3);
      }
      meta[i] = EyioMeta{h0, w0, r, left, top};
    } catch (const std::exception& e) {
      errors[i] = e.what();
    }
  };
  int nt = std::max(1, std::min<int>(threads, n));
  if (nt == 1) {
    for (int i = 0; i < n; ++i) one(i);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(nt));
    bool started = true;
    try {
      for (int t = 0; t < nt; ++t)
        pool.emplace_back([&, t]() {
          for (int i = t; i < n; i += nt) one(i);
        });
    } catch (const std::exception&) {
      started = false;
    }
    for (auto& th : pool) th.join();
    if (!started) {
      set_err(err, errlen, "could not start the decode threads");
      return -1;
    }
  }
  for (int i = 0; i < n; ++i) {
    if (!errors[i].empty()) {
      set_err(err, errlen, errors[i].c_str());
      return 1 + i;
    }
  }
  return 0;
}

}  // extern "C"
