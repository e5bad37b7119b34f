// Baseline JPEG decoder for the host data path (bound by data/../jpeg.py).
//
// Huffman-coded sequential DCT (SOF0, SOF1), 8-bit samples, 1 or 3
// components, any integral sampling factors, interleaved or one scan per
// component, restart markers. It reproduces libjpeg's default output bit for
// bit: the accurate integer IDCT (jidctint.c), fancy chroma upsampling
// (jdsample.c: h2v1, h1v2 and h2v2 triangle filters; box replication for
// other ratios and for planes at most two samples wide) and the fixed-point
// YCbCr -> RGB conversion (jdcolor.c). Progressive, lossless, hierarchical,
// arithmetic-coded and 12-bit files return LF_JPEG_UNSUPPORTED.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { OK = 0, UNSUPPORTED = 1, CORRUPT = 2 };

const int ZIGZAG[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                        11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                        13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                        36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                        38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int LOOKAHEAD = 9;

struct Huffman {
  bool present = false;
  uint8_t fast_len[1 << LOOKAHEAD];
  uint8_t fast_val[1 << LOOKAHEAD];
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int width = 0, height = 0;  // downsampled size in samples
  int stride = 0, rows = 0;   // plane size, padded to whole MCUs
  int dc_pred = 0;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t *d;
  size_t n, pos = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0, restart_interval = 0;
  bool frame = false, jfif = false;
  int adobe_transform = -1;
  Component comp[3];
  // Bit reader over the entropy-coded segment.
  uint32_t bits = 0;
  int nbits = 0;
  bool at_marker = false;

  Decoder(const uint8_t *data, size_t size) : d(data), n(size) {}

  int u16(size_t at) const { return (d[at] << 8) | d[at + 1]; }

  void fill() {
    while (nbits <= 24) {
      int b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          int next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // a marker ends the segment: pad with zeros
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
  }

  int get(int k) {
    if (k == 0) return 0;
    fill();
    int v = int(bits >> (32 - k));
    bits <<= k;
    nbits -= k;
    return v;
  }

  int extend(int v, int s) const {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  bool decode(const Huffman &h, int *out) {
    fill();
    int look = int(bits >> (32 - LOOKAHEAD));
    if (h.fast_len[look]) {
      int l = h.fast_len[look];
      bits <<= l;
      nbits -= l;
      *out = h.fast_val[look];
      return true;
    }
    for (int l = LOOKAHEAD + 1; l <= 16; l++) {
      int code = int(bits >> (32 - l));
      if (code <= h.maxcode[l]) {
        bits <<= l;
        nbits -= l;
        *out = h.vals[h.valptr[l] + code - h.mincode[l]];
        return true;
      }
    }
    return false;
  }

  void restart() {
    bits = 0;
    nbits = 0;
    at_marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7))
      pos++;
    if (pos + 1 < n) pos += 2;
    for (int c = 0; c < ncomp; c++) comp[c].dc_pred = 0;
  }

  int read_dqt(size_t at, size_t end) {
    while (at < end) {
      int pq = d[at] >> 4, tq = d[at] & 15;
      at++;
      if (tq > 3 || pq > 1) return CORRUPT;
      if (at + 64 * (pq + 1) > end) return CORRUPT;
      for (int k = 0; k < 64; k++) {
        qt[tq][ZIGZAG[k]] = pq ? uint16_t(u16(at + 2 * k)) : d[at + k];
      }
      at += 64 * (pq + 1);
      qt_present[tq] = true;
    }
    return OK;
  }

  int read_dht(size_t at, size_t end) {
    while (at < end) {
      if (at + 17 > end) return CORRUPT;
      int tc = d[at] >> 4, th = d[at] & 15;
      if (tc > 1 || th > 3) return CORRUPT;
      Huffman &h = tc ? ac[th] : dc[th];
      int counts[17], total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = d[at + l];
      at += 17;
      if (total > 256 || at + total > end) return CORRUPT;
      memcpy(h.vals, d + at, total);
      at += total;
      memset(h.fast_len, 0, sizeof(h.fast_len));
      int code = 0, k = 0;
      for (int l = 1; l <= 16; l++) {
        h.valptr[l] = k;
        h.mincode[l] = code;
        for (int i = 0; i < counts[l]; i++, k++, code++) {
          if (l <= LOOKAHEAD) {
            int shift = LOOKAHEAD - l;
            for (int j = 0; j < (1 << shift); j++) {
              h.fast_len[(code << shift) | j] = uint8_t(l);
              h.fast_val[(code << shift) | j] = h.vals[k];
            }
          }
        }
        h.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      h.maxcode[17] = 0x7FFFFFFF;
      h.present = true;
    }
    return OK;
  }

  int read_sof(size_t at, size_t end, int marker) {
    if (marker != 0xC0 && marker != 0xC1) return UNSUPPORTED;
    if (frame) return CORRUPT;
    if (at + 6 > end) return CORRUPT;
    if (d[at] != 8) return UNSUPPORTED;
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = d[at + 5];
    if (ncomp != 1 && ncomp != 3) return UNSUPPORTED;
    if (width == 0 || height == 0) return UNSUPPORTED;
    if (at + 6 + 3 * ncomp > end) return CORRUPT;
    for (int c = 0; c < ncomp; c++) {
      Component &cp = comp[c];
      cp.id = d[at + 6 + 3 * c];
      cp.h = d[at + 7 + 3 * c] >> 4;
      cp.v = d[at + 7 + 3 * c] & 15;
      cp.tq = d[at + 8 + 3 * c];
      if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3) return CORRUPT;
      if (cp.h > hmax) hmax = cp.h;
      if (cp.v > vmax) vmax = cp.v;
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    frame = true;
    return OK;
  }

  // Parse markers up to the frame header, or through the whole file.
  int parse(bool decode_scans) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return CORRUPT;
    pos = 2;
    while (true) {
      while (pos < n && d[pos] != 0xFF) pos++;  // skip stray bytes
      while (pos < n && d[pos] == 0xFF) pos++;  // fill bytes
      if (pos >= n) return frame ? OK : CORRUPT;
      int marker = d[pos++];
      if (marker == 0xD9) return frame ? OK : CORRUPT;
      if (marker >= 0xD0 && marker <= 0xD7) continue;
      if (pos + 2 > n) return CORRUPT;
      size_t len = u16(pos);
      size_t at = pos + 2, end = pos + len;
      if (len < 2 || end > n) return CORRUPT;
      pos = end;
      int err = OK;
      if (marker == 0xDB) {
        err = read_dqt(at, end);
      } else if (marker == 0xC4) {
        err = read_dht(at, end);
      } else if (marker == 0xCC) {
        return UNSUPPORTED;  // arithmetic coding conditioning
      } else if (marker >= 0xC0 && marker <= 0xCF) {
        err = read_sof(at, end, marker);
        if (err == OK && !decode_scans) return OK;
      } else if (marker == 0xDD) {
        if (len < 4) return CORRUPT;
        restart_interval = u16(at);
      } else if (marker == 0xE0) {
        if (len >= 7 && memcmp(d + at, "JFIF", 4) == 0) jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 14 && memcmp(d + at, "Adobe", 5) == 0) adobe_transform = d[at + 11];
      } else if (marker == 0xDA) {
        if (!frame) return CORRUPT;
        err = scan(at, end);
      }
      if (err != OK) return err;
    }
  }

  int scan(size_t at, size_t end) {
    int ns = d[at];
    if (ns < 1 || ns > ncomp || at + 1 + 2 * ns + 3 > end) return CORRUPT;
    Component *sc[3];
    for (int i = 0; i < ns; i++) {
      int id = d[at + 1 + 2 * i], c = 0;
      while (c < ncomp && comp[c].id != id) c++;
      if (c == ncomp) return CORRUPT;
      sc[i] = &comp[c];
      sc[i]->td = d[at + 2 + 2 * i] >> 4;
      sc[i]->ta = d[at + 2 + 2 * i] & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) return CORRUPT;
      if (!dc[sc[i]->td].present || !ac[sc[i]->ta].present) return CORRUPT;
      if (!qt_present[sc[i]->tq]) return CORRUPT;
      sc[i]->dc_pred = 0;
    }
    size_t tail = at + 1 + 2 * ns;
    if (d[tail] != 0 || d[tail + 1] != 63 || d[tail + 2] != 0) return UNSUPPORTED;
    for (int c = 0; c < ncomp; c++) allocate(comp[c]);
    bits = 0;
    nbits = 0;
    at_marker = false;
    int err = OK;
    if (ns == 1) {
      Component &cp = *sc[0];
      int bw = (cp.width + 7) / 8, bh = (cp.height + 7) / 8, count = 0;
      for (int by = 0; by < bh && err == OK; by++)
        for (int bx = 0; bx < bw && err == OK; bx++) {
          if (restart_interval && count && count % restart_interval == 0) restart();
          err = block(cp, bx, by);
          count++;
        }
    } else {
      int count = 0;
      for (int my = 0; my < mcus_y && err == OK; my++)
        for (int mx = 0; mx < mcus_x && err == OK; mx++) {
          if (restart_interval && count && count % restart_interval == 0) restart();
          for (int i = 0; i < ns && err == OK; i++)
            for (int v = 0; v < sc[i]->v && err == OK; v++)
              for (int h = 0; h < sc[i]->h && err == OK; h++)
                err = block(*sc[i], mx * sc[i]->h + h, my * sc[i]->v + v);
          count++;
        }
    }
    return err;  // marker parsing resumes where the segment ended
  }

  void allocate(Component &cp) {
    if (!cp.plane.empty()) return;
    cp.width = (width * cp.h + hmax - 1) / hmax;
    cp.height = (height * cp.v + vmax - 1) / vmax;
    cp.stride = mcus_x * cp.h * 8;
    cp.rows = mcus_y * cp.v * 8;
    cp.plane.assign(size_t(cp.stride) * cp.rows, 0);
  }

  int block(Component &cp, int bx, int by) {
    int coef[64] = {0};
    int s;
    if (!decode(dc[cp.td], &s)) return CORRUPT;
    if (s > 16) return CORRUPT;
    cp.dc_pred += s ? extend(get(s), s) : 0;
    coef[0] = cp.dc_pred;
    const Huffman &h = ac[cp.ta];
    for (int k = 1; k < 64;) {
      int rs;
      if (!decode(h, &rs)) return CORRUPT;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return CORRUPT;
        coef[ZIGZAG[k]] = extend(get(s), s);
        k++;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    idct_islow(coef, qt[cp.tq], cp.plane.data() + size_t(by) * 8 * cp.stride + bx * 8,
               cp.stride);
    return OK;
  }

  // jidctint.c: the accurate integer inverse DCT.
  static void idct_islow(const int *coef, const uint16_t *q, uint8_t *out, int stride) {
    constexpr int CONST_BITS = 13, PASS1_BITS = 2;
    constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                      F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                      F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int n) { return int((x + (int64_t(1) << (n - 1))) >> n); };
    for (int c = 0; c < 8; c++) {
      int64_t in[8];
      for (int r = 0; r < 8; r++) in[r] = int64_t(coef[r * 8 + c]) * q[r * 8 + c];
      int64_t z2 = in[2], z3 = in[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = (in[0] + in[4]) << CONST_BITS, tmp1 = (in[0] - in[4]) << CONST_BITS;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = in[7]; tmp1 = in[5]; tmp2 = in[3]; tmp3 = in[1];
      z1 = tmp0 + tmp3; z2 = tmp1 + tmp2; z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298; tmp1 *= F2_053; tmp2 *= F3_072; tmp3 *= F1_501;
      z1 *= -F0_899; z2 *= -F2_562; z3 *= -F1_961; z4 *= -F0_390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      constexpr int n1 = CONST_BITS - PASS1_BITS;
      ws[0 * 8 + c] = descale(tmp10 + tmp3, n1);
      ws[7 * 8 + c] = descale(tmp10 - tmp3, n1);
      ws[1 * 8 + c] = descale(tmp11 + tmp2, n1);
      ws[6 * 8 + c] = descale(tmp11 - tmp2, n1);
      ws[2 * 8 + c] = descale(tmp12 + tmp1, n1);
      ws[5 * 8 + c] = descale(tmp12 - tmp1, n1);
      ws[3 * 8 + c] = descale(tmp13 + tmp0, n1);
      ws[4 * 8 + c] = descale(tmp13 - tmp0, n1);
    }
    auto limit = [](int x) {
      x += 128;
      return uint8_t(x < 0 ? 0 : x > 255 ? 255 : x);
    };
    for (int r = 0; r < 8; r++) {
      const int *w = ws + r * 8;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) << CONST_BITS,
              tmp1 = (int64_t(w[0]) - w[4]) << CONST_BITS;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = w[7]; tmp1 = w[5]; tmp2 = w[3]; tmp3 = w[1];
      z1 = tmp0 + tmp3; z2 = tmp1 + tmp2; z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298; tmp1 *= F2_053; tmp2 *= F3_072; tmp3 *= F1_501;
      z1 *= -F0_899; z2 *= -F2_562; z3 *= -F1_961; z4 *= -F0_390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      constexpr int n2 = CONST_BITS + PASS1_BITS + 3;
      uint8_t *o = out + size_t(r) * stride;
      o[0] = limit(descale(tmp10 + tmp3, n2));
      o[7] = limit(descale(tmp10 - tmp3, n2));
      o[1] = limit(descale(tmp11 + tmp2, n2));
      o[6] = limit(descale(tmp11 - tmp2, n2));
      o[2] = limit(descale(tmp12 + tmp1, n2));
      o[5] = limit(descale(tmp12 - tmp1, n2));
      o[3] = limit(descale(tmp13 + tmp0, n2));
      o[4] = limit(descale(tmp13 - tmp0, n2));
    }
  }

  // jdsample.c: component ``cp`` at full size into ``out`` (height x width).
  void upsample(const Component &cp, uint8_t *out) const {
    int rh = hmax / cp.h, rv = vmax / cp.v;
    const uint8_t *p = cp.plane.data();
    int cw = cp.width, ch = cp.height, st = cp.stride;
    auto at = [&](int r, int c) -> int {
      r = r < 0 ? 0 : r >= ch ? ch - 1 : r;
      c = c < 0 ? 0 : c >= cw ? cw - 1 : c;
      return p[size_t(r) * st + c];
    };
    for (int y = 0; y < height; y++) {
      uint8_t *o = out + size_t(y) * width;
      if (rh == 1 && rv == 1) {
        memcpy(o, p + size_t(y) * st, width);
      } else if (rh == 2 && rv == 1 && cw > 2) {
        for (int x = 0; x < width; x++) {
          int c = x >> 1, nb = (x & 1) ? c + 1 : c - 1;
          o[x] = uint8_t((3 * at(y, c) + at(y, nb) + ((x & 1) ? 2 : 1)) >> 2);
        }
      } else if (rh == 1 && rv == 2) {
        int r = y >> 1, nb = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++)
          o[x] = uint8_t((3 * at(r, x) + at(nb, x) + bias) >> 2);
      } else if (rh == 2 && rv == 2 && cw > 2) {
        int r = y >> 1, nb = (y & 1) ? r + 1 : r - 1;
        auto colsum = [&](int c) { return 3 * at(r, c) + at(nb, c); };
        for (int x = 0; x < width; x++) {
          int c = x >> 1;
          o[x] = (x & 1) ? uint8_t((3 * colsum(c) + colsum(c + 1) + 7) >> 4)
                         : uint8_t((3 * colsum(c) + colsum(c - 1) + 8) >> 4);
        }
      } else {
        const uint8_t *row = p + size_t(y / rv) * st;
        for (int x = 0; x < width; x++) o[x] = row[x / rh];
      }
    }
  }

  void convert(uint8_t *out) const {
    size_t npix = size_t(width) * height;
    if (ncomp == 1) {
      upsample(comp[0], out);
      return;
    }
    std::vector<uint8_t> planes(3 * npix);
    for (int c = 0; c < 3; c++) upsample(comp[c], planes.data() + c * npix);
    bool rgb = false;
    if (!jfif) {
      if (adobe_transform >= 0)
        rgb = adobe_transform == 0;
      else
        rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }
    const uint8_t *p0 = planes.data(), *p1 = p0 + npix, *p2 = p1 + npix;
    if (rgb) {
      for (size_t i = 0; i < npix; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16.
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < npix; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

}  // namespace

extern "C" {

// Frame size and component count; 0, or LF_JPEG_UNSUPPORTED (1) or
// LF_JPEG_CORRUPT (2).
int lf_jpeg_info(const uint8_t *data, size_t size, int *width, int *height, int *channels) {
  Decoder dec(data, size);
  int err = dec.parse(false);
  if (err != OK) return err;
  *width = dec.width;
  *height = dec.height;
  *channels = dec.ncomp;
  return OK;
}

// Decode into ``out`` (height x width x channels uint8, as lf_jpeg_info gives).
int lf_jpeg_decode(const uint8_t *data, size_t size, uint8_t *out) {
  Decoder dec(data, size);
  int err = dec.parse(true);
  if (err != OK) return err;
  for (int c = 0; c < dec.ncomp; c++)
    if (dec.comp[c].plane.empty()) return CORRUPT;  // a component no scan covered
  for (int c = 0; c < dec.ncomp; c++)
    if (dec.hmax % dec.comp[c].h || dec.vmax % dec.comp[c].v) return UNSUPPORTED;
  dec.convert(out);
  return OK;
}
}
