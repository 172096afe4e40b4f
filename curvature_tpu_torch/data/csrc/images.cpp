// Image decoders and Pillow's bicubic resampler for the image-folder
// loaders (curvature_tpu_torch/data/images.py binds this with ctypes).
//
// Each entry point is held bit for bit to what the JAX loader reads through
// PIL (`Image.open(p).convert("RGB")`, then `Image.resize`):
//
// * JPEG: baseline and progressive Huffman (SOF0/1/2), restart intervals,
//   1, 3 or 4 components at any integral sampling, decoded as
//   libjpeg-turbo decodes by default: the JDCT_ISLOW integer IDCT
//   (jidctint.c), fancy upsampling (jdsample.c h2v1/h2v2/h1v2, box
//   replication otherwise), the fixed-point YCbCr->RGB tables (jdcolor.c),
//   YCCK->CMYK, and Pillow's CMYK;I -> RGB conversion. Progressive block
//   smoothing is not implemented: after a complete file every coefficient
//   is known and libjpeg turns it off. Arithmetic coding, lossless,
//   hierarchical and 12-bit files raise, naming the marker; so does a file
//   that ends before its EOI marker (PIL: "image file is truncated").
// * PNG: the five filters and Adam7 de-interlacing of the inflated stream
//   (the caller inflates with zlib), then Pillow's mode rules to RGB.
// * Resize: Pillow's two-pass fixed-point convolution (Resample.c) with
//   the bicubic filter (a = -0.5), 22 fractional bits, horizontal pass
//   first.
//
// Every entry point writes into caller-owned buffers and keeps no state
// between calls, so threads may call it at once (ctypes drops the GIL).
// Errors come back as a non-zero return and a message in `err`.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off
// (contracted multiply-adds would change the resampler's weights).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  }
  return 1;
}

// ---------------------------------------------------------------- JPEG --

// zigzag index -> natural (row-major) index, with 16 guard entries for
// corrupt run lengths (libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memset(look_len, 0, sizeof(look_len));
    std::memcpy(vals, symbols, (size_t)nsym);
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)l;
            look_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) fail("corrupt JPEG data: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks in the padded MCU grid
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  int dw = 0, dh = 0;          // downsampled width and height
  int pred = 0;
  bool latched = false;
  uint16_t quant[64];          // natural order, latched at first scan
  std::vector<int16_t> coef;   // [bh * bw * 64]
  std::vector<uint8_t> plane;  // [bh * 8, bw * 8] after the IDCT
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int eobrun = 0;
  // bit reader
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  // -- bytes and markers --
  int byte() {
    if (pos >= n) fail("image file is truncated");
    return d[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    // skip to 0xFF <non-zero, non-0xFF> (libjpeg's next_marker)
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // -- entropy-coded segment --
  void reset_bits() {
    buf = 0;
    cnt = 0;
    at_marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (pos >= n) fail("image file is truncated");
        int c = d[pos];
        if (c == 0xFF) {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p >= n) fail("image file is truncated");
          if (d[p] == 0) {
            b = 0xFF;
            pos = p + 1;
          } else {
            at_marker = true;  // pos stays on the marker's 0xFF
          }
        } else {
          b = (uint64_t)c;
          ++pos;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = (int)(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return bits(1); }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int decode(const Huff& h) {
    if (cnt < 16) fill();
    int look = (int)(buf >> (64 - kLookBits));
    int len = h.look_len[look];
    if (len) {
      buf <<= len;
      cnt -= len;
      return h.look_val[look];
    }
    int code16 = (int)(buf >> 48);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int code = code16 >> (16 - l);
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.vals[h.valoff[l] + code];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  void restart() {
    reset_bits();
    // the RSTn marker that ends the interval
    for (;;) {
      if (pos + 1 >= n) fail("image file is truncated");
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        break;
      }
      ++pos;
    }
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
    eobrun = 0;
  }

  // -- segments --
  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = byte();
      int t = pq & 15;
      if (t > 3) fail("corrupt JPEG data: bad quantization table");
      for (int k = 0; k < 64; ++k) {
        int v = (pq >> 4) ? u16() : byte();
        qt[t][kNatural[k]] = (uint16_t)v;
      }
      qt_defined[t] = true;
      len -= 1 + ((pq >> 4) ? 128 : 64);
    }
  }
  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc = byte();
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = (uint8_t)byte();
        total += counts[i];
      }
      if (total > 256 || (tc & 15) > 3)
        fail("corrupt JPEG data: bad Huffman table");
      uint8_t sym[256];
      for (int i = 0; i < total; ++i) sym[i] = (uint8_t)byte();
      ((tc >> 4) ? ac : dc)[tc & 15].build(counts, sym, total);
      len -= 17 + total;
    }
  }
  void read_sof(int marker) {
    if (frame) fail("corrupt JPEG data: two frames");
    int len = u16();
    int precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (precision != 8) {
      fail("JPEG with " + std::to_string(precision) +
           "-bit samples: not supported (8-bit only)");
    }
    if (width <= 0 || height <= 0)
      fail("JPEG with an unsupported frame size (DNL marker)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG with " + std::to_string(ncomp) + " components");
    if (len != 8 + 3 * ncomp) fail("corrupt JPEG data: bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt JPEG data: bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }
  void read_app(int marker) {
    int len = u16() - 2;
    if (len < 0) fail("corrupt JPEG data: bad marker length");
    if (pos + (size_t)len > n) fail("image file is truncated");
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 5 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos += (size_t)len;
  }
  void skip_segment() {
    int len = u16() - 2;
    if (len < 0) fail("corrupt JPEG data: bad marker length");
    if (pos + (size_t)len > n) fail("image file is truncated");
    pos += (size_t)len;
  }

  // -- scans --
  void decode_block(Component& c, int by, int bx, int ss, int se, int ah,
                    int al) {
    int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
    if (!progressive) {
      int t = decode(dc[c.td]);
      int diff = t ? extend(bits(t), t) : 0;
      c.pred += diff;
      blk[0] = (int16_t)c.pred;
      const Huff& h = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(bits(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int t = decode(dc[c.td]);
        int diff = t ? extend(bits(t), t) : 0;
        c.pred += diff;
        blk[0] = (int16_t)(c.pred * (1 << al));
      } else if (bit()) {
        blk[0] = (int16_t)(blk[0] | (1 << al));
      }
      return;
    }
    const Huff& h = ac[c.ta];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)(extend(bits(s), s) * (1 << al));
        } else {
          if (r < 15) {
            eobrun = (1 << r) - 1;
            if (r) eobrun += bits(r);
            break;
          }
          k += 15;
        }
      }
      return;
    }
    // AC refinement (libjpeg's decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            if (bit() && (*co & p1) == 0)
              *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* co = blk + kNatural[k];
        if (*co != 0 && bit() && (*co & p1) == 0)
          *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
      }
      --eobrun;
    }
  }

  void read_sos() {
    if (!frame) fail("corrupt JPEG data: scan before frame");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
      fail("corrupt JPEG data: bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int t = byte();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) fail("corrupt JPEG data: unknown component in scan");
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3)
        fail("corrupt JPEG data: bad table selector");
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (se > 63 || ss > se || (ss == 0 && se != 0) ||
               (ss > 0 && ns != 1) || al > 13) {
      fail("corrupt JPEG data: bad progression parameters");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!qt_defined[c.tq])
          fail("corrupt JPEG data: undefined quantization table");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c.td].defined) || (need_ac && !ac[c.ta].defined))
        fail("corrupt JPEG data: undefined Huffman table");
      c.pred = 0;
    }
    eobrun = 0;
    reset_bits();
    int todo = restart_interval;
    auto tick = [&](bool last) {
      if (restart_interval && --todo == 0 && !last) {
        restart();
        todo = restart_interval;
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx) {
          decode_block(c, by, bx, ss, se, ah, al);
          tick(by == c.hblocks - 1 && bx == c.wblocks - 1);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                decode_block(c, my * c.v + v, mx * c.h + h, ss, se, ah, al);
          }
          tick(my == mcuy - 1 && mx == mcux - 1);
        }
    }
    reset_bits();
  }

  void parse() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m);
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3): not supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF: {
          char b[64];
          std::snprintf(b, sizeof b, "hierarchical JPEG (SOF%d): not supported",
                        m - 0xC0);
          fail(b);
        }
        case 0xC9:
        case 0xCA:
        case 0xCB: {
          char b[64];
          std::snprintf(b, sizeof b,
                        "arithmetic-coded JPEG (SOF%d): not supported",
                        m - 0xC0);
          fail(b);
        }
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC): not supported");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          u16();
          restart_interval = u16();
          break;
        }
        case 0xDA:
          read_sos();
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF)
            read_app(m);
          else
            skip_segment();
      }
    }
    if (!frame) fail("corrupt JPEG data: no frame");
  }

  // -- reconstruction --
  static inline uint8_t idct_limit(int x) {
    // libjpeg's post-IDCT range limit (the SIMD IDCT saturates the same way
    // on every input a real encoder produces)
    x += 128;
    return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299,
                      F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int nbits) {
      return (int)((x + ((int64_t)1 << (nbits - 1))) >> nbits);
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dcval = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = descale(tmp10 + tmp3, CB - P1);
      wp[56] = descale(tmp10 - tmp3, CB - P1);
      wp[8] = descale(tmp11 + tmp2, CB - P1);
      wp[48] = descale(tmp11 - tmp2, CB - P1);
      wp[16] = descale(tmp12 + tmp1, CB - P1);
      wp[40] = descale(tmp12 - tmp1, CB - P1);
      wp[24] = descale(tmp13 + tmp0, CB - P1);
      wp[32] = descale(tmp13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB + P1 + 3;
      op[0] = idct_limit(descale(tmp10 + tmp3, S));
      op[7] = idct_limit(descale(tmp10 - tmp3, S));
      op[1] = idct_limit(descale(tmp11 + tmp2, S));
      op[6] = idct_limit(descale(tmp11 - tmp2, S));
      op[2] = idct_limit(descale(tmp12 + tmp1, S));
      op[5] = idct_limit(descale(tmp12 - tmp1, S));
      op[3] = idct_limit(descale(tmp13 + tmp0, S));
      op[4] = idct_limit(descale(tmp13 - tmp0, S));
    }
  }

  void reconstruct_planes() {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (!c.latched) fail("image file is truncated (a component has no scan)");
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                     &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
    }
  }

  // one component brought to width x height (jdsample.c)
  void upsample(const Component& c, uint8_t* out) const {
    const int stride = c.bw * 8;
    const uint8_t* in = c.plane.data();
    const int hr = hmax / c.h, vr = vmax / c.v;
    if (hmax % c.h || vmax % c.v)
      fail("JPEG with fractional sampling factors: not supported");
    const int W = width, H = height, dw = c.dw, dh = c.dh;
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y)
        std::memcpy(out + (size_t)y * W, in + (size_t)y * stride, (size_t)W);
      return;
    }
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const uint8_t* r = in + (size_t)y * stride;
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < dw; ++x) {
          int v3 = r[x] * 3;
          int ox = 2 * x;
          if (ox < W) o[ox] = (uint8_t)((v3 + r[std::max(x - 1, 0)] + 1) >> 2);
          if (ox + 1 < W)
            o[ox + 1] = (uint8_t)((v3 + r[std::min(x + 1, dw - 1)] + 2) >> 2);
        }
      }
      return;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1;
        int ny = (y & 1) ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        const uint8_t* r0 = in + (size_t)iy * stride;
        const uint8_t* r1 = in + (size_t)ny * stride;
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; ++x)
          o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
      }
      return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> cs((size_t)dw);
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1;
        int ny = (y & 1) ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
        const uint8_t* r0 = in + (size_t)iy * stride;
        const uint8_t* r1 = in + (size_t)ny * stride;
        for (int x = 0; x < dw; ++x) cs[x] = r0[x] * 3 + r1[x];
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < dw; ++x) {
          int t3 = cs[x] * 3;
          int ox = 2 * x;
          if (ox < W) o[ox] = (uint8_t)((t3 + cs[std::max(x - 1, 0)] + 8) >> 4);
          if (ox + 1 < W)
            o[ox + 1] =
                (uint8_t)((t3 + cs[std::min(x + 1, dw - 1)] + 7) >> 4);
        }
      }
      return;
    }
    // h2v1_upsample, h2v2_upsample, int_upsample: box replication
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = in + (size_t)(y / vr) * stride;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; ++x) o[x] = r[x / hr];
    }
  }

  // -> RGB as Pillow's convert("RGB") of what libjpeg hands it
  void to_rgb(uint8_t* rgb) {
    reconstruct_planes();
    const size_t np = (size_t)width * height;
    std::vector<uint8_t> full((size_t)ncomp * np);
    for (int i = 0; i < ncomp; ++i) upsample(comp[i], &full[i * np]);
    if (ncomp == 1) {
      for (size_t p = 0; p < np; ++p)
        rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = full[p];
      return;
    }
    // jdcolor.c's tables
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t* c0 = &full[0];
    const uint8_t* c1 = &full[np];
    const uint8_t* c2 = &full[2 * np];
    if (ncomp == 3) {
      bool ycc = true;
      if (!jfif && adobe) {
        ycc = adobe_transform != 0;
      } else if (!jfif && !adobe) {
        ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
      }
      if (!ycc) {
        for (size_t p = 0; p < np; ++p) {
          rgb[3 * p] = c0[p];
          rgb[3 * p + 1] = c1[p];
          rgb[3 * p + 2] = c2[p];
        }
        return;
      }
      for (size_t p = 0; p < np; ++p) {
        int y = c0[p], cb = c1[p], cr = c2[p];
        rgb[3 * p] = clamp(y + cr_r[cr]);
        rgb[3 * p + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        rgb[3 * p + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // 4 components: CMYK (Adobe transform 0, or no Adobe marker) or YCCK,
    // handed to Pillow as inverted CMYK ("CMYK;I") and converted by its
    // cmyk2rgb
    const uint8_t* c3 = &full[3 * np];
    bool ycck = adobe && adobe_transform != 0;
    for (size_t p = 0; p < np; ++p) {
      int cmyk[4];
      if (ycck) {
        int y = c0[p], cb = c1[p], cr = c2[p];
        cmyk[0] = clamp(255 - (y + cr_r[cr]));
        cmyk[1] = clamp(255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> SB)));
        cmyk[2] = clamp(255 - (y + cb_b[cb]));
      } else {
        cmyk[0] = c0[p];
        cmyk[1] = c1[p];
        cmyk[2] = c2[p];
      }
      cmyk[3] = c3[p];
      for (int k = 0; k < 4; ++k) cmyk[k] = 255 - cmyk[k];
      int nk = 255 - cmyk[3];
      for (int k = 0; k < 3; ++k) {
        int t = cmyk[k] * nk + 128;
        int md = ((t >> 8) + t) >> 8;
        rgb[3 * p + k] = clamp(nk - md);
      }
    }
  }
};

// ----------------------------------------------------------------- PNG --

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// undo the filters of `h` rows of `rowbytes` bytes; returns bytes consumed
size_t unfilter(const uint8_t* src, size_t avail, int h, size_t rowbytes,
                int bpp, uint8_t* dst) {
  size_t need = (size_t)h * (rowbytes + 1);
  if (need > avail) fail("image file is truncated (PNG data ends early)");
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < h; ++y) {
    int f = src[(size_t)y * (rowbytes + 1)];
    const uint8_t* s = src + (size_t)y * (rowbytes + 1) + 1;
    uint8_t* o = dst + (size_t)y * rowbytes;
    const uint8_t* up = y ? dst + (size_t)(y - 1) * rowbytes : zero.data();
    for (size_t x = 0; x < rowbytes; ++x) {
      int a = x >= (size_t)bpp ? o[x - bpp] : 0;
      int b = up[x];
      int c = x >= (size_t)bpp ? up[x - bpp] : 0;
      int v = s[x];
      switch (f) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: fail("broken PNG file: unknown filter type");
      }
      o[x] = (uint8_t)v;
    }
  }
  return need;
}

inline int get_sample(const uint8_t* row, int x, int bits) {
  if (bits == 8) return row[x];
  if (bits == 16) return (row[2 * x] << 8) | row[2 * x + 1];
  int per = 8 / bits;
  int shift = 8 - bits * (x % per + 1);
  return (row[x / per] >> shift) & ((1 << bits) - 1);
}

// ------------------------------------------------------------ resample --

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

constexpr int kPrecision = 32 - 8 - 2;

// Resample.c's precompute_coeffs + normalize_coeffs_8bpc
int coeffs(int in_size, int out_size, std::vector<int>& bounds,
           std::vector<int32_t>& kk) {
  double scale = (double)in_size / out_size, fscale = scale;
  if (fscale < 1.0) fscale = 1.0;
  double support = 2.0 * fscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize, 0.0);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / fscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i)
    kk[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << kPrecision))
                       : (int32_t)(0.5 + pre[i] * (1 << kPrecision));
  return ksize;
}

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecision << 8)) return 255;
  if (v <= 0) return 0;
  return (uint8_t)(v >> kPrecision);
}

}  // namespace

extern "C" {

// width, height and component count of a JPEG (0 on success)
int ct_jpeg_info(const uint8_t* data, int64_t n, int* width, int* height,
                 int* ncomp, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    j.pos = 2;
    for (;;) {
      int m = j.next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        j.read_sof(m);
        break;
      }
      if (m == 0xD9 || m == 0xDA) fail("corrupt JPEG data: no frame");
      if (m >= 0xD0 && m <= 0xD7) continue;
      if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC)
        break;  // reported by ct_jpeg_decode, which names the marker
      j.skip_segment();
    }
    *width = j.width;
    *height = j.height;
    *ncomp = j.ncomp;
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

// a JPEG as [height, width, 3] RGB into `rgb` (sized from ct_jpeg_info)
int ct_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* rgb,
                   int64_t rgb_size, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse();
    if ((int64_t)j.width * j.height * 3 != rgb_size)
      fail("output buffer does not match the frame size");
    j.to_rgb(rgb);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

// The inflated IDAT stream of a PNG as [height, width, 3] RGB, by Pillow's
// rules for convert("RGB"): a palette (`npal` RGB triples; an index past
// it reads black) is looked up, tRNS and alpha are dropped, 16-bit colour
// keeps the high byte, 16-bit grey (Pillow's I;16) clips at 255, 1/2/4-bit
// grey scales to 0..255.
int ct_png_decode(const uint8_t* raw, int64_t rawlen, int width, int height,
                  int depth, int color_type, int interlace,
                  const uint8_t* palette, int npal, uint8_t* rgb, char* err,
                  int errlen) {
  try {
    int chans;
    switch (color_type) {
      case 0: chans = 1; break;
      case 2: chans = 3; break;
      case 3: chans = 1; break;
      case 4: chans = 2; break;
      case 6: chans = 4; break;
      default: fail("broken PNG file: unknown colour type");
    }
    const int bits = chans * depth;
    const int bpp = std::max(1, bits / 8);
    const size_t rowbytes = ((size_t)width * bits + 7) / 8;
    std::vector<uint8_t> px(rowbytes * height);
    if (!interlace) {
      unfilter(raw, (size_t)rawlen, height, rowbytes, bpp, px.data());
    } else {
      static const int xs0[7] = {0, 4, 0, 2, 0, 1, 0};
      static const int ys0[7] = {0, 0, 4, 0, 2, 0, 1};
      static const int dxs[7] = {8, 8, 4, 4, 2, 2, 1};
      static const int dys[7] = {8, 8, 8, 4, 4, 2, 2};
      size_t off = 0;
      for (int p = 0; p < 7; ++p) {
        int pw = (width - xs0[p] + dxs[p] - 1) / dxs[p];
        int ph = (height - ys0[p] + dys[p] - 1) / dys[p];
        if (pw <= 0 || ph <= 0) continue;
        size_t prb = ((size_t)pw * bits + 7) / 8;
        std::vector<uint8_t> pass(prb * ph);
        off += unfilter(raw + off, (size_t)rawlen - off, ph, prb, bpp,
                        pass.data());
        for (int y = 0; y < ph; ++y) {
          const uint8_t* sr = &pass[(size_t)y * prb];
          uint8_t* dr = &px[(size_t)(ys0[p] + y * dys[p]) * rowbytes];
          for (int x = 0; x < pw; ++x) {
            int ox = xs0[p] + x * dxs[p];
            if (bits >= 8) {
              std::memcpy(dr + (size_t)ox * bpp, sr + (size_t)x * bpp,
                          (size_t)bpp);
            } else {
              int v = get_sample(sr, x, bits);
              int per = 8 / bits;
              int shift = 8 - bits * (ox % per + 1);
              dr[ox / per] = (uint8_t)((dr[ox / per] & ~(((1 << bits) - 1)
                                                          << shift)) |
                                       (v << shift));
            }
          }
        }
      }
    }
    for (int y = 0; y < height; ++y) {
      const uint8_t* r = &px[(size_t)y * rowbytes];
      uint8_t* o = rgb + (size_t)y * width * 3;
      for (int x = 0; x < width; ++x, o += 3) {
        if (color_type == 3) {
          int i = get_sample(r, x, depth);
          if (i < npal) {
            o[0] = palette[3 * i];
            o[1] = palette[3 * i + 1];
            o[2] = palette[3 * i + 2];
          } else {
            o[0] = o[1] = o[2] = 0;
          }
          continue;
        }
        if (color_type == 0 || color_type == 4) {
          int v = get_sample(r, x * chans, depth);
          if (depth == 16) {
            // Pillow: I;16 for grey (clips at 255), LA;16B for grey+alpha
            v = color_type == 0 ? std::min(v, 255) : v >> 8;
          } else {
            v = v * 255 / ((1 << depth) - 1);
          }
          o[0] = o[1] = o[2] = (uint8_t)v;
          continue;
        }
        for (int k = 0; k < 3; ++k) {
          int v = get_sample(r, x * chans + k, depth);
          o[k] = (uint8_t)(depth == 16 ? v >> 8 : v);
        }
      }
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

// Pillow's Image.resize((out_w, out_h)) of an RGB [h, w, 3] image
// (BICUBIC, the default filter): horizontal pass over the rows the
// vertical pass reads, then the vertical pass, each only if its size
// changes.
int ct_resize_bicubic(const uint8_t* in, int w, int h, uint8_t* out,
                      int out_w, int out_h, char* err, int errlen) {
  try {
    if (w <= 0 || h <= 0 || out_w <= 0 || out_h <= 0)
      fail("resize: empty image");
    const bool need_h = out_w != w, need_v = out_h != h;
    std::vector<int> bh, bv;
    std::vector<int32_t> kh, kv;
    int ksh = coeffs(w, out_w, bh, kh);
    int ksv = coeffs(h, out_h, bv, kv);
    int yfirst = bv[0];
    int ylast = bv[out_h * 2 - 2] + bv[out_h * 2 - 1];
    std::vector<uint8_t> tmp;
    const uint8_t* src = in;
    int src_w = w;
    if (need_h) {
      if (!need_v) {
        yfirst = 0;
        ylast = h;
      }
      int rows = ylast - yfirst;
      tmp.resize((size_t)rows * out_w * 3);
      for (int yy = 0; yy < rows; ++yy) {
        const uint8_t* r = in + (size_t)(yy + yfirst) * w * 3;
        uint8_t* o = &tmp[(size_t)yy * out_w * 3];
        for (int xx = 0; xx < out_w; ++xx) {
          int xmin = bh[2 * xx], xmax = bh[2 * xx + 1];
          const int32_t* k = &kh[(size_t)xx * ksh];
          int32_t s0 = 1 << (kPrecision - 1), s1 = s0, s2 = s0;
          for (int x = 0; x < xmax; ++x) {
            const uint8_t* p = r + (size_t)(x + xmin) * 3;
            s0 += p[0] * k[x];
            s1 += p[1] * k[x];
            s2 += p[2] * k[x];
          }
          o[3 * xx] = clip8(s0);
          o[3 * xx + 1] = clip8(s1);
          o[3 * xx + 2] = clip8(s2);
        }
      }
      if (!need_v) {
        std::memcpy(out, tmp.data(), tmp.size());
        return 0;
      }
      for (int i = 0; i < out_h; ++i) bv[2 * i] -= yfirst;
      src = tmp.data();
      src_w = out_w;
    } else if (!need_v) {
      std::memcpy(out, in, (size_t)w * h * 3);
      return 0;
    }
    const size_t row = (size_t)src_w * 3;
    std::vector<int32_t> acc(row);
    for (int yy = 0; yy < out_h; ++yy) {
      int ymin = bv[2 * yy], ymax = bv[2 * yy + 1];
      const int32_t* k = &kv[(size_t)yy * ksv];
      std::fill(acc.begin(), acc.end(), 1 << (kPrecision - 1));
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* r = src + (size_t)(y + ymin) * row;
        const int32_t ky = k[y];
        for (size_t xx = 0; xx < row; ++xx) acc[xx] += r[xx] * ky;
      }
      uint8_t* o = out + (size_t)yy * row;
      for (size_t xx = 0; xx < row; ++xx) o[xx] = clip8(acc[xx]);
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

}  // extern "C"
