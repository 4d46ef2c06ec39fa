// Baseline JPEG encoding, for irgs_tpu_torch/utils/jpeg_encode.py, as
// libjpeg-turbo (PIL's encoder) does it at PIL's defaults:
//   jpeg_rgb_to_ycc     jccolor.c rgb_ycc_convert: 16-bit fixed-point
//                       tables, ONE_HALF rounding for Y, ONE_HALF - 1 for
//                       Cb and Cr;
//   jpeg_encode_scan    one interleaved (or single-component) sequential
//                       scan: the edge expansion of jcprepct.c and
//                       jcsample.c (last column and row replicated to whole
//                       blocks and to the iMCU height), the h2v1 and h2v2
//                       box downsampling with its alternating biases, the
//                       accurate integer forward DCT (jfdctint.c), the
//                       reciprocal quantisation of jcdctmgr.c, the dummy
//                       blocks of jccoefct.c at the right and bottom edges,
//                       and Huffman coding with byte stuffing and a final
//                       fill of one bits (jchuff.c).
// The caller writes the markers. Built with g++ at first use; plain C ABI.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jfdctint.c
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    const int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* p = d + ctr * stride;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, sh);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, sh);
      p[5 * step] = descale(tmp5 + z2 + z4, sh);
      p[3 * step] = descale(tmp6 + z2 + z3, sh);
      p[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

// jcdctmgr.c compute_reciprocal, 16-bit DCTELEM (libjpeg-turbo's SIMD
// build): quotient = ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

struct Code {
  uint32_t code[256];
  int8_t len[256];
};

void build_codes(const uint8_t* bits, const uint8_t* vals, Code* t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      t->code[vals[k]] = code++;
      t->len[vals[k]] = static_cast<int8_t>(l);
    }
    code <<= 1;
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int nbits) {
    acc = (acc << nbits) | (v & ((1u << nbits) - 1));
    n += nbits;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  void flush() {
    if (n) put(0x7F, 8 - n);  // fill the last byte with one bits
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// rgb uint8 [n, 3] -> y, cb, cr uint8 [n]
void jpeg_rgb_to_ycc(const uint8_t* rgb, int64_t n, uint8_t* y, uint8_t* cb,
                     uint8_t* cr) {
  const int32_t SCALEBITS = 16, ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
  static int32_t tab[8][256];
  static bool ready = false;
  if (!ready) {
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + ONE_HALF;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    ready = true;
  }
  for (int64_t i = 0; i < n; ++i) {
    int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    y[i] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> SCALEBITS);
    cb[i] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> SCALEBITS);
    cr[i] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> SCALEBITS);
  }
}

// Encode one sequential Huffman scan of all n_comps components (interleaved
// when more than one).
//   planes[i]        uint8 [height, width] full-resolution samples of
//                    component i (already colour converted)
//   hs[i], vs[i]     sampling factors (downsampling by hmax / hs[i] in
//                    1 or 2 across, vmax / vs[i] in 1 or 2 down)
//   qt[i]            uint16 [64] quantisation table of component i, natural
//   huff_bits[i][2][16], huff_vals[i][2][256]: its DC then AC table
// Writes the entropy-coded bytes to out (capacity cap); returns their count,
// -1 if cap is too small, -2 for a sampling the encoder does not do.
int64_t jpeg_encode_scan(const uint8_t** planes, int n_comps, int32_t width,
                         int32_t height, const int32_t* hs, const int32_t* vs,
                         const uint16_t* qt, const uint8_t* huff_bits,
                         const uint8_t* huff_vals, uint8_t* out, int64_t cap) {
  int hmax = 1, vmax = 1;
  for (int i = 0; i < n_comps; ++i) {
    if (hs[i] > hmax) hmax = hs[i];
    if (vs[i] > vmax) vmax = vs[i];
  }
  const int64_t mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
  const int64_t mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  struct Comp {
    int h, v, fx, fy;
    int64_t bw, bh, pw, ph;  // blocks of real samples; padded plane size
    std::vector<uint8_t> plane;
    std::vector<int16_t> coef;  // [mcus_y * v][mcus_x * h][64]
    Code dc, ac;
  };
  std::vector<Comp> comps(n_comps);
  for (int i = 0; i < n_comps; ++i) {
    Comp& c = comps[i];
    c.h = hs[i];
    c.v = vs[i];
    c.fx = hmax / c.h;
    c.fy = vmax / c.v;
    if (hmax % c.h || vmax % c.v || c.fx > 2 || c.fy > 2 ||
        (c.fx == 1 && c.fy == 2))
      return -2;
    const int64_t cw = (static_cast<int64_t>(width) * c.h + hmax - 1) / hmax;
    const int64_t ch = (static_cast<int64_t>(height) * c.v + vmax - 1) / vmax;
    c.bw = (cw + 7) / 8;
    c.bh = (ch + 7) / 8;
    // full-resolution rows padded to a whole row group (max_v rows) and
    // columns to the downsampled blocks' width, by replication
    const int64_t fh = (height + vmax - 1) / vmax * vmax;
    // downsampled plane, padded to whole iMCU rows
    c.pw = c.bw * 8;
    c.ph = mcus_y * c.v * 8;
    c.plane.assign(c.pw * c.ph, 0);
    const uint8_t* src = planes[i];
    auto at = [&](int64_t y, int64_t x) -> int {
      if (y >= height) y = height - 1;
      if (x >= width) x = width - 1;
      return src[y * width + x];
    };
    const int64_t dh = fh / c.fy;
    for (int64_t y = 0; y < dh; ++y) {
      int bias = c.fx == 2 && c.fy == 2 ? 1 : 0;
      for (int64_t x = 0; x < c.pw; ++x) {
        int v;
        if (c.fx == 1 && c.fy == 1) {
          v = at(y, x);
        } else if (c.fy == 1) {  // h2v1: bias 0, 1, 0, 1, ...
          v = (at(y, 2 * x) + at(y, 2 * x + 1) + bias) >> 1;
          bias ^= 1;
        } else {                 // h2v2: bias 1, 2, 1, 2, ...
          v = (at(2 * y, 2 * x) + at(2 * y, 2 * x + 1) +
               at(2 * y + 1, 2 * x) + at(2 * y + 1, 2 * x + 1) + bias) >> 2;
          bias ^= 3;
        }
        c.plane[y * c.pw + x] = static_cast<uint8_t>(v);
      }
    }
    for (int64_t y = dh; y < c.ph; ++y)  // bottom rows: the last row again
      std::memcpy(&c.plane[y * c.pw], &c.plane[(dh - 1) * c.pw], c.pw);
    build_codes(huff_bits + (2 * i) * 16, huff_vals + (2 * i) * 256, &c.dc);
    build_codes(huff_bits + (2 * i + 1) * 16, huff_vals + (2 * i + 1) * 256,
                &c.ac);
    // forward DCT and quantisation of the real blocks; dummy blocks (zero
    // AC, the DC of the block before) fill the MCUs
    const int64_t ah = mcus_y * c.v, aw = mcus_x * c.h;
    c.coef.assign(ah * aw * 64, 0);
    Divisor div[64];
    for (int k = 0; k < 64; ++k)
      div[k] = reciprocal(static_cast<uint32_t>(qt[64 * i + k]) << 3);
    for (int64_t by = 0; by < ah; ++by) {
      for (int64_t bx = 0; bx < aw; ++bx) {
        int16_t* blk = &c.coef[(by * aw + bx) * 64];
        const bool real_row = by < c.bh || by / c.v < mcus_y - 1;
        if (!real_row) {  // a row of dummy blocks at the bottom
          // jccoefct.c: the DC of the MCU's block before this row
          const int64_t mx = bx / c.h;
          const int64_t prev = (by - 1) * aw + mx * c.h + c.h - 1;
          blk[0] = c.coef[prev * 64];
          continue;
        }
        const int64_t last_mx = mcus_x - 1;
        const int64_t last_w = c.bw % c.h ? c.bw % c.h : c.h;
        if (bx / c.h == last_mx && bx % c.h >= last_w) {  // right edge
          blk[0] = c.coef[(by * aw + bx - 1) * 64];
          continue;
        }
        int32_t ws[64];
        for (int r = 0; r < 8; ++r)
          for (int x = 0; x < 8; ++x)
            ws[r * 8 + x] = c.plane[(by * 8 + r) * c.pw + bx * 8 + x] - 128;
        fdct_islow(ws);
        for (int k = 0; k < 64; ++k) {
          int32_t t = ws[k];
          uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
          uint64_t p = static_cast<uint64_t>((a + div[k].corr) & 0xFFFF) *
                       div[k].recip;
          int32_t q = static_cast<int32_t>(p >> div[k].shift);
          blk[k] = static_cast<int16_t>(t < 0 ? -q : q);
        }
      }
    }
  }
  // Huffman coding in MCU order
  Writer w;
  int32_t last_dc[4] = {0, 0, 0, 0};
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      for (int i = 0; i < n_comps; ++i) {
        Comp& c = comps[i];
        const int h = n_comps > 1 ? c.h : 1, v = n_comps > 1 ? c.v : 1;
        const int64_t aw = mcus_x * c.h;
        for (int y = 0; y < v; ++y)
          for (int x = 0; x < h; ++x) {
            int64_t by, bx;
            if (n_comps > 1) {
              by = my * c.v + y;
              bx = mx * c.h + x;
            } else {  // one component: its real blocks, one per MCU
              by = my;
              bx = mx;
            }
            const int16_t* blk = &c.coef[(by * aw + bx) * 64];
            int diff = blk[0] - last_dc[i];
            last_dc[i] = blk[0];
            int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
            int nb = nbits_of(t);
            w.put(c.dc.code[nb], c.dc.len[nb]);
            if (nb) w.put(static_cast<uint32_t>(t2), nb);
            int run = 0;
            for (int k = 1; k < 64; ++k) {
              int v2 = blk[kNaturalOrder[k]];
              if (v2 == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                w.put(c.ac.code[0xF0], c.ac.len[0xF0]);
                run -= 16;
              }
              t = v2 < 0 ? -v2 : v2;
              t2 = v2 < 0 ? v2 - 1 : v2;
              nb = nbits_of(t);
              int sym = (run << 4) + nb;
              w.put(c.ac.code[sym], c.ac.len[sym]);
              w.put(static_cast<uint32_t>(t2), nb);
              run = 0;
            }
            if (run > 0) w.put(c.ac.code[0], c.ac.len[0]);
          }
      }
    }
    if (n_comps == 1 && my + 1 >= comps[0].bh) break;
  }
  w.flush();
  if (static_cast<int64_t>(w.out.size()) > cap) return -1;
  std::memcpy(out, w.out.data(), w.out.size());
  return static_cast<int64_t>(w.out.size());
}

}  // extern "C"
