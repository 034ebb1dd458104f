// Host library of the port's JPEG decoder and bilinear resampler.
//
// Plain C interface, loaded with ctypes (which releases the GIL for the
// length of each call, so decode threads run in parallel). The stages
// compute what libjpeg-turbo computes for PIL, bit for bit:
//
//   jpeg_decode_scan   Huffman and run-length decoding of one baseline or
//                      extended sequential scan into 8x8 blocks of int16
//                      coefficients (natural order), restart markers
//                      included;
//   jpeg_idct_islow    dequantisation and libjpeg's JDCT_ISLOW integer
//                      IDCT (jidctint.c), samples clamped to [0, 255];
//   jpeg_upsample      "fancy" triangle upsampling (jdsample.c: h2v1,
//                      h1v2, h2v2; plain replication where libjpeg uses
//                      it), edges replicated;
//   jpeg_color         libjpeg's fixed-point YCbCr->RGB tables
//                      (jdcolor.c), or gray/RGB copies;
//   resample_rgb       Pillow's Resample.c bilinear resize of 8-bit RGB:
//                      double-precision triangle coefficients, int32
//                      weights of 22 fractional bits, a horizontal pass
//                      over the rows the vertical pass needs, then the
//                      vertical pass, each rounding with 1 << 21 and
//                      clipping to uint8; a pass whose axis is unchanged
//                      is skipped.
//
// Marker parsing and table handling are in apex_tpu_torch/data/jpeg.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural index, with 16 extra entries so a corrupt
// run past position 63 lands on 63 (as libjpeg's table does)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;

struct Huff {
  uint16_t look[1 << kLook];  // (length << 8) | symbol; 0: longer code
  int32_t maxcode[18];        // largest code of each length, -1: none
  int32_t valoffset[17];
  uint8_t vals[256];
  int nsym;
};

// bits: 16 counts (codes of length 1..16); vals: the symbols in order
bool build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  int size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) {
      if (p >= 256) return false;
      size[p++] = l;
    }
  h->nsym = p;
  uint32_t code = 0;
  int q = 0, si = p ? size[0] : 1;
  while (q < p) {
    while (q < p && size[q] == si) code_of[q++] = code++;
    if (code >= (1u << si)) return false;
    code <<= 1;
    si++;
  }
  q = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      h->valoffset[l] = q - static_cast<int32_t>(code_of[q]);
      q += bits[l - 1];
      h->maxcode[l] = static_cast<int32_t>(code_of[q - 1]);
    } else {
      h->maxcode[l] = -1;
      h->valoffset[l] = 0;
    }
  }
  h->maxcode[17] = 0x7fffffff;
  std::memcpy(h->vals, vals, 256);
  std::memset(h->look, 0, sizeof(h->look));
  q = 0;
  for (int l = 1; l <= kLook; l++)
    for (int i = 0; i < bits[l - 1]; i++, q++) {
      int first = static_cast<int>(code_of[q]) << (kLook - l);
      for (int c = 0; c < (1 << (kLook - l)); c++)
        h->look[first + c] = static_cast<uint16_t>((l << 8) | vals[q]);
    }
  return true;
}

// MSB-first bit reader over entropy-coded data. Stuffed 0xFF00 reads as
// 0xFF; at a marker (or the end of the buffer) it feeds zero bytes and
// counts them in `pad`: a decode that consumes any of those bits read
// past the data, which is an error (a truncated or corrupt file).
struct Bits {
  const uint8_t* buf;
  int64_t len, pos;
  uint64_t acc = 0;
  int n = 0, pad = 0;
  bool marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t c = 0;
      if (marker || pos >= len) {
        pad += 8;
      } else {
        c = buf[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < len && buf[q] == 0xFF) q++;
          if (q < len && buf[q] == 0x00) {
            pos = q + 1;
          } else {               // a marker: stay on its first 0xFF
            marker = true;
            c = 0;
            pad += 8;
          }
        } else {
          pos++;
        }
      }
      acc = (acc << 8) | c;
      n += 8;
    }
  }
  inline bool take(int k) {
    n -= k;
    return n >= pad;
  }
  inline int peek(int k) const {
    return static_cast<int>((acc >> (n - k)) & ((1u << k) - 1));
  }
};

// -1: read past the data; -2: no such Huffman code
inline int decode_sym(Bits* b, const Huff& h) {
  if (b->n < 32) b->fill();
  int e = h.look[b->peek(kLook)];
  if (e) {
    if (!b->take(e >> 8)) return -1;
    return e & 0xFF;
  }
  int l = kLook + 1;
  int32_t code = b->peek(l);
  while (l <= 16 && code > h.maxcode[l]) {
    l++;
    code = b->peek(l);
  }
  if (l > 16) return -2;
  int idx = code + h.valoffset[l];
  if (idx < 0 || idx >= h.nsym) return -2;
  if (!b->take(l)) return -1;
  return h.vals[idx];
}

inline bool receive_extend(Bits* b, int s, int* v) {
  if (s == 0) {
    *v = 0;
    return true;
  }
  if (b->n < 32) b->fill();
  int r = b->peek(s);
  if (!b->take(s)) return false;
  *v = r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  return true;
}

int decode_block(Bits* b, const Huff& dc, const Huff& ac, int* pred,
                 int16_t* blk) {
  std::memset(blk, 0, 64 * sizeof(int16_t));
  int s = decode_sym(b, dc);
  if (s < 0) return s;
  if (s > 16) return -2;
  int diff;
  if (!receive_extend(b, s, &diff)) return -1;
  *pred += diff;
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64;) {
    int rs = decode_sym(b, ac);
    if (rs < 0) return rs;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v;
      if (!receive_extend(b, s, &v)) return -1;
      blk[kNatural[k < 79 ? k : 79]] = static_cast<int16_t>(v);
      k++;
    } else {
      if (r != 15) break;      // end of block
      k += 16;                 // sixteen zeros
    }
  }
  return 0;
}

// the position of the next marker (0xFF then neither 0x00 nor 0xFF) at or
// after pos, or len
int64_t next_marker(const uint8_t* buf, int64_t len, int64_t pos) {
  while (pos + 1 < len) {
    if (buf[pos] == 0xFF && buf[pos + 1] != 0x00 && buf[pos + 1] != 0xFF)
      return pos;
    pos++;
  }
  return len;
}

// libjpeg's islow constants (CONST_BITS = 13)
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
constexpr int kConst = 13, kPass1 = 2;

inline uint8_t clamp8(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_block(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int64_t dc = (static_cast<int64_t>(ip[0]) * qp[0]) * (1 << kPass1);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
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
    constexpr int sh = kConst - kPass1;
    constexpr int64_t rnd = int64_t{1} << (sh - 1);
    wp[0] = (tmp10 + tmp3 + rnd) >> sh;
    wp[56] = (tmp10 - tmp3 + rnd) >> sh;
    wp[8] = (tmp11 + tmp2 + rnd) >> sh;
    wp[48] = (tmp11 - tmp2 + rnd) >> sh;
    wp[16] = (tmp12 + tmp1 + rnd) >> sh;
    wp[40] = (tmp12 - tmp1 + rnd) >> sh;
    wp[24] = (tmp13 + tmp0 + rnd) >> sh;
    wp[32] = (tmp13 - tmp0 + rnd) >> sh;
  }
  for (int r = 0; r < 8; r++) {
    const int64_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    constexpr int sh = kConst + kPass1 + 3;
    constexpr int64_t rnd = int64_t{1} << (sh - 1);
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConst);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << kConst);
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
    int64_t z5 = (z3 + z4) * F1_175;
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
    op[0] = clamp8(((tmp10 + tmp3 + rnd) >> sh) + 128);
    op[7] = clamp8(((tmp10 - tmp3 + rnd) >> sh) + 128);
    op[1] = clamp8(((tmp11 + tmp2 + rnd) >> sh) + 128);
    op[6] = clamp8(((tmp11 - tmp2 + rnd) >> sh) + 128);
    op[2] = clamp8(((tmp12 + tmp1 + rnd) >> sh) + 128);
    op[5] = clamp8(((tmp12 - tmp1 + rnd) >> sh) + 128);
    op[3] = clamp8(((tmp13 + tmp0 + rnd) >> sh) + 128);
    op[4] = clamp8(((tmp13 - tmp0 + rnd) >> sh) + 128);
  }
}

// one full-resolution channel (H x W) from a component plane whose valid
// samples are dw x dh, upsampled by (hf, vf) in {1, 2}
void upsample(const uint8_t* p, int64_t stride, int dw, int dh, int hf,
              int vf, int fancy, int W, int H, uint8_t* out,
              int64_t ostride, int32_t* colsum) {
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + y * ostride;
    int r = vf == 2 ? (y >> 1) : y;
    const uint8_t* row = p + r * stride;
    if (hf == 1 && vf == 1) {
      std::memcpy(o, row, W);
      continue;
    }
    if (hf == 1) {             // h1v2: fancy always (as libjpeg-turbo)
      int rn = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      const uint8_t* nb = p + rn * stride;
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++) o[x] = (3 * row[x] + nb[x] + bias) >> 2;
      continue;
    }
    if (!fancy) {              // plain replication (narrow planes)
      for (int x = 0; x < W; x++) o[x] = row[x >> 1];
      continue;
    }
    if (vf == 1) {             // h2v1
      for (int x = 0; x < W; x++) {
        int c = x >> 1;
        if (x & 1)
          o[x] = (3 * row[c] + row[c + 1 < dw ? c + 1 : dw - 1] + 2) >> 2;
        else
          o[x] = (3 * row[c] + row[c > 0 ? c - 1 : 0] + 1) >> 2;
      }
      continue;
    }
    // h2v2: column sums against the nearer neighbouring row
    int rn = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
    const uint8_t* nb = p + rn * stride;
    for (int c = 0; c < dw; c++) colsum[c] = 3 * row[c] + nb[c];
    for (int x = 0; x < W; x++) {
      int c = x >> 1;
      if (x & 1)
        o[x] = (3 * colsum[c] + colsum[c + 1 < dw ? c + 1 : dw - 1] + 7) >> 4;
      else
        o[x] = (3 * colsum[c] + colsum[c > 0 ? c - 1 : 0] + 8) >> 4;
    }
  }
}

struct YccTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double v) {
      return static_cast<int32_t>(v * (1 << kScale) + 0.5);
    };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const YccTables kYcc;

// Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
// filter, in its order of double operations. bounds: (first input, count)
// per output; kk: ksize weights per output. Returns ksize.
int64_t coeffs(int64_t in_size, float in0, float in1, int64_t out_size,
               std::vector<int32_t>* bounds, std::vector<int32_t>* kk) {
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int64_t ksize = static_cast<int64_t>(std::ceil(support)) * 2 + 1;
  bounds->assign(static_cast<size_t>(out_size * 2), 0);
  kk->assign(static_cast<size_t>(out_size * ksize), 0);
  std::vector<double> w(static_cast<size_t>(ksize));
  for (int64_t xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int64_t xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int64_t x = 0; x < xmax; x++) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      w[x] = t < 1.0 ? 1.0 - t : 0.0;
      ww += w[x];
    }
    for (int64_t x = 0; x < xmax; x++) {
      double k = ww != 0.0 ? w[x] / ww : w[x];
      (*kk)[xx * ksize + x] = static_cast<int32_t>(
          k < 0 ? -0.5 + k * (1 << 22) : 0.5 + k * (1 << 22));
    }
    (*bounds)[2 * xx] = static_cast<int32_t>(xmin);
    (*bounds)[2 * xx + 1] = static_cast<int32_t>(xmax);
  }
  return ksize;
}

// Pillow's horizontal pass: rows [row0, row0 + nrows) of an (H, in_w, 3)
// image into (nrows, out_w, 3).
void resample_h(const uint8_t* in, int64_t in_w, int64_t row0,
                int64_t nrows, const int32_t* bounds, const int32_t* kk,
                int64_t ksize, int64_t out_w, uint8_t* out) {
  for (int64_t y = 0; y < nrows; y++) {
    const uint8_t* row = in + (row0 + y) * in_w * 3;
    uint8_t* o = out + y * out_w * 3;
    for (int64_t x = 0; x < out_w; x++) {
      int32_t xmin = bounds[2 * x], cnt = bounds[2 * x + 1];
      const int32_t* k = kk + x * ksize;
      int32_t s0 = 1 << 21, s1 = 1 << 21, s2 = 1 << 21;
      for (int32_t i = 0; i < cnt; i++) {
        const uint8_t* px = row + (xmin + i) * 3;
        s0 += px[0] * k[i];
        s1 += px[1] * k[i];
        s2 += px[2] * k[i];
      }
      o[3 * x] = clamp8(s0 >> 22);
      o[3 * x + 1] = clamp8(s1 >> 22);
      o[3 * x + 2] = clamp8(s2 >> 22);
    }
  }
}

// Pillow's vertical pass over an (in_h, w, 3) image into (out_h, w, 3):
// each output row accumulates its input rows whole (the same sums, in the
// same order per sample, as Pillow's per-sample loop).
void resample_v(const uint8_t* in, int64_t w, const int32_t* bounds,
                const int32_t* kk, int64_t ksize, int64_t out_h,
                uint8_t* out) {
  int64_t n = w * 3;
  std::vector<int32_t> acc(static_cast<size_t>(n));
  for (int64_t y = 0; y < out_h; y++) {
    int32_t ymin = bounds[2 * y], cnt = bounds[2 * y + 1];
    const int32_t* k = kk + y * ksize;
    for (int64_t x = 0; x < n; x++) acc[x] = 1 << 21;
    for (int32_t i = 0; i < cnt; i++) {
      const uint8_t* row = in + (ymin + i) * n;
      int32_t ki = k[i];
      for (int64_t x = 0; x < n; x++) acc[x] += row[x] * ki;
    }
    uint8_t* o = out + y * n;
    for (int64_t x = 0; x < n; x++) o[x] = clamp8(acc[x] >> 22);
  }
}

}  // namespace

extern "C" {

// Decode one scan. comps: per scan component 7 int32s
//   (h, v, dc table, ac table, blocks wide allocated, blocks wide and
//    high that a non-interleaved scan covers)
// huff: 8 tables of 16 + 256 bytes (DC 0-3, then AC 0-3); coefs: per scan
// component a (rows x blocks wide allocated x 64) int16 array. Returns 0,
// or -1 (data ended early), -2 (bad Huffman code or table), -3 (a missing
// or wrong restart marker); *end is the position of the marker after the
// scan.
int jpeg_decode_scan(const uint8_t* buf, int64_t len, int64_t pos,
                     int ncomp, const int32_t* comps, const uint8_t* huff,
                     int mcus_x, int mcus_y, int restart_interval,
                     int16_t** coefs, int64_t* end) {
  Huff tables[8];
  bool used[8] = {false};
  for (int i = 0; i < ncomp; i++) {
    used[comps[7 * i + 2]] = true;
    used[4 + comps[7 * i + 3]] = true;
  }
  for (int t = 0; t < 8; t++)
    if (used[t] && !build_huff(huff + t * 272, huff + t * 272 + 16,
                               &tables[t]))
      return -2;
  Bits b;
  b.buf = buf;
  b.len = len;
  b.pos = pos;
  int pred[4] = {0, 0, 0, 0};
  int64_t n_mcu;
  if (ncomp == 1)
    n_mcu = static_cast<int64_t>(comps[5]) * comps[6];
  else
    n_mcu = static_cast<int64_t>(mcus_x) * mcus_y;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart_interval && m && m % restart_interval == 0) {
      b.acc = 0;
      b.n = 0;
      b.pad = 0;
      int64_t at = next_marker(buf, len, b.pos);
      if (at + 1 >= len || buf[at + 1] != 0xD0 + next_rst) return -3;
      b.pos = at + 2;
      b.marker = false;
      next_rst = (next_rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    if (ncomp == 1) {
      const int32_t* c = comps;
      int64_t by = m / c[5], bx = m % c[5];
      int16_t* blk = coefs[0] + (by * c[4] + bx) * 64;
      int err = decode_block(&b, tables[c[2]], tables[4 + c[3]], &pred[0],
                             blk);
      if (err) return err;
      continue;
    }
    int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int i = 0; i < ncomp; i++) {
      const int32_t* c = comps + 7 * i;
      for (int v = 0; v < c[1]; v++)
        for (int h = 0; h < c[0]; h++) {
          int64_t by = my * c[1] + v, bx = mx * c[0] + h;
          int16_t* blk = coefs[i] + (by * c[4] + bx) * 64;
          int err = decode_block(&b, tables[c[2]], tables[4 + c[3]],
                                 &pred[i], blk);
          if (err) return err;
        }
    }
  }
  *end = next_marker(buf, len, b.pos);
  return 0;
}

// Dequantise and inverse-transform (rows x cols) blocks of coefficients
// into a (rows * 8) x (cols * 8) plane; qtable in natural order.
void jpeg_idct_islow(const int16_t* coefs, int64_t rows, int64_t cols,
                     const uint16_t* qtable, uint8_t* out) {
  int64_t stride = cols * 8;
  for (int64_t r = 0; r < rows; r++)
    for (int64_t c = 0; c < cols; c++)
      idct_block(coefs + (r * cols + c) * 64, qtable,
                 out + r * 8 * stride + c * 8, stride);
}

// Upsample one plane into channel `ch` of nothing else: out is H x W.
void jpeg_upsample(const uint8_t* plane, int64_t stride, int dw, int dh,
                   int hf, int vf, int W, int H, uint8_t* out) {
  int fancy = !(hf == 2 && dw <= 2);
  int32_t* colsum = new int32_t[dw > 0 ? dw : 1];
  upsample(plane, stride, dw, dh, hf, vf, fancy, W, H, out, W, colsum);
  delete[] colsum;
}

// Full-resolution channels (each H x W) -> interleaved RGB (H x W x 3).
// kind 0: one gray channel; 1: YCbCr; 2: RGB.
void jpeg_color(const uint8_t* c0, const uint8_t* c1, const uint8_t* c2,
                int64_t npix, int kind, uint8_t* out) {
  if (kind == 0) {
    for (int64_t i = 0; i < npix; i++)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = c0[i];
    return;
  }
  if (kind == 2) {
    for (int64_t i = 0; i < npix; i++) {
      out[3 * i] = c0[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c2[i];
    }
    return;
  }
  for (int64_t i = 0; i < npix; i++) {
    int y = c0[i], cb = c1[i], cr = c2[i];
    out[3 * i] = clamp8(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp8(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp8(y + kYcc.cb_b[cb]);
  }
}

// The whole pixel path of a decoded frame in one call: every component's
// IDCT, upsampling to full resolution and the colour conversion into out
// (H x W x 3). dims: per component (rows, cols, dw, dh, hf, vf).
void jpeg_pixels(int ncomp, const int16_t* const* coefs,
                 const uint16_t* const* qtables, const int32_t* dims, int W,
                 int H, int kind, uint8_t* out) {
  std::vector<uint8_t> chans[3];
  for (int i = 0; i < ncomp; i++) {
    const int32_t* d = dims + 6 * i;
    int64_t rows = d[0], cols = d[1];
    std::vector<uint8_t> plane(static_cast<size_t>(rows * cols * 64));
    jpeg_idct_islow(coefs[i], rows, cols, qtables[i], plane.data());
    chans[i].resize(static_cast<size_t>(W) * H);
    jpeg_upsample(plane.data(), cols * 8, d[2], d[3], d[4], d[5], W, H,
                  chans[i].data());
  }
  const uint8_t* c0 = chans[0].data();
  jpeg_color(c0, ncomp > 1 ? chans[1].data() : c0,
             ncomp > 2 ? chans[2].data() : c0, static_cast<int64_t>(W) * H,
             kind, out);
}

// Pillow's resize of an (in_h, in_w, 3) image, BILINEAR, box (x0, y0, x1,
// y1) as floats, to (out_h, out_w, 3). Returns 0, or -1 for a bad size.
int resample_rgb(const uint8_t* in, int64_t in_w, int64_t in_h,
                 const float* box, int64_t out_w, int64_t out_h,
                 uint8_t* out) {
  if (out_w <= 0 || out_h <= 0 || in_w <= 0 || in_h <= 0) return -1;
  std::vector<int32_t> bh, kh, bv, kv;
  int64_t ksh = coeffs(in_w, box[0], box[2], out_w, &bh, &kh);
  int64_t ksv = coeffs(in_h, box[1], box[3], out_h, &bv, &kv);
  bool need_h = out_w != in_w || box[0] != 0.0f ||
                box[2] != static_cast<float>(out_w);
  bool need_v = out_h != in_h || box[1] != 0.0f ||
                box[3] != static_cast<float>(out_h);
  int64_t first = bv[0], last = bv[2 * (out_h - 1)] + bv[2 * (out_h - 1) + 1];
  const uint8_t* cur = in;
  int64_t cur_w = in_w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int64_t y = 0; y < out_h; y++) bv[2 * y] -= static_cast<int32_t>(first);
    tmp.resize(static_cast<size_t>((last - first) * out_w * 3));
    if (!need_v) {
      resample_h(in, in_w, first, last - first, bh.data(), kh.data(), ksh,
                 out_w, out);
      return 0;
    }
    resample_h(in, in_w, first, last - first, bh.data(), kh.data(), ksh,
               out_w, tmp.data());
    cur = tmp.data();
    cur_w = out_w;
  }
  if (need_v) {
    resample_v(cur, cur_w, bv.data(), kv.data(), ksv, out_h, out);
    return 0;
  }
  std::memcpy(out, in, static_cast<size_t>(in_w * in_h * 3));
  return 0;
}

}  // extern "C"
