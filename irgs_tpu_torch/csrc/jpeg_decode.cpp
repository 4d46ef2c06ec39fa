// Entropy decoding of JPEG scans, for irgs_tpu_torch/utils/jpeg.py, as
// libjpeg-turbo (PIL's decoder) does it:
//   jpeg_decode_scan              sequential Huffman (jdhuff.c);
//   jpeg_decode_scan_progressive  progressive Huffman: DC first and refine,
//                                 AC first and refine, EOB runs (jdphuff.c);
//   jpeg_decode_scan_arith        sequential and progressive arithmetic
//                                 coding, the QM coder of ITU-T T.81 Annex D
//                                 with the conditioning of F.1.4.4 and G.1.3
//                                 (jdarith.c);
//   jpeg_decode_scan_lossless     lossless Huffman differences (jdlhuff.c);
//   jpeg_undifference             the lossless predictors 1-7 (jdpred.c);
//   jpeg_smooth                   the block smoothing of a progressive file
//                                 whose scans left coefficient bits unsent
//                                 (jdcoefct.c decompress_smooth_data).
// The caller parses the markers and does the rest of the decode
// (dequantisation, IDCT, upsampling, colour) in numpy. Built with g++ at
// first use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

// zig-zag index -> natural (row-major) index, with 16 guard entries so a
// corrupt run length cannot index past the block (as libjpeg's table)
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Table {
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // huffval index of the first code of each length
  const uint8_t* vals;
  int total;
  bool defined;
  bool bad;              // more codes of a length than fit (all ones)
};

void build_table(const uint8_t* bits, const uint8_t* vals, Table* t) {
  // canonical codes (T.81 C.2): codes of each length follow those of the
  // length before, shifted left by one
  t->defined = t->bad = false;
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l - 1];
  t->total = total;
  if (total == 0) return;
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    if (n) {
      t->valoffset[l] = k - code;
      code += n;
      k += n;
      t->maxcode[l] = code - 1;
      // jpeg_make_d_derived_tbl: no code may be all ones
      if (code >= (1 << l)) t->bad = true;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  // sentinel: ends the search
  t->vals = vals;
  t->defined = true;
}

struct Reader {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t buf = 0;
  int nbits = 0;
  bool hit_marker = false;
  // the buffered bits that came from the data (the rest are zeros fed at
  // a marker); a read past them sets `insufficient`, after which
  // libjpeg-turbo leaves the scan's next MCUs (up to a restart) zero
  int real = 0;
  bool insufficient = false;

  // libjpeg's fill_bit_buffer: 0xFF 0x00 is a stuffed 0xFF; 0xFF fill bytes
  // before a marker are skipped; at a marker (or the end of the data) the
  // reader stops and feeds zeros
  void fill() {
    while (nbits <= 56) {
      int c = 0;
      if (!hit_marker && pos < len) {
        c = data[pos];
        if (c == 0xFF) {
          int64_t p = pos + 1;
          while (p < len && data[p] == 0xFF) ++p;
          if (p < len && data[p] == 0x00) {
            pos = p + 1;
          } else {
            hit_marker = true;  // pos stays at the marker's first 0xFF
            c = 0;
          }
        } else {
          ++pos;
        }
        if (!hit_marker) real += 8;
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }
  void take(int n) {
    if (n > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= n;
    }
  }
  int bit() {
    if (nbits < 1) fill();
    int b = static_cast<int>(buf >> 63);
    buf <<= 1;
    --nbits;
    take(1);
    return b;
  }
  int32_t bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    take(n);
    return v;
  }
  // drop the buffered bits; position at the next marker
  void align() {
    buf = 0;
    nbits = 0;
    hit_marker = false;
    real = 0;
    insufficient = false;
  }
};

// a code longer than 16 bits (17 read) decodes as symbol 0, as
// libjpeg-turbo's jpeg_huff_decode returns it (with a warning)
inline int decode(Reader& r, const Table& t) {
  int32_t code = r.bit();
  int l = 1;
  while (code > t.maxcode[l]) {
    code = (code << 1) | r.bit();
    if (++l > 16) return 0;
  }
  return t.vals[t.valoffset[l] + code];
}

// jpeg_make_d_derived_tbl's checks of a table a scan uses: codes that fit,
// and DC symbols of at most 15
bool table_ok(const Table& t, bool dc) {
  if (t.bad) return false;
  if (dc)
    for (int i = 0; i < t.total; ++i)
      if (t.vals[i] > 15) return false;
  return true;
}

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// the position of the next marker at or after p (libjpeg's next_marker:
// any other bytes are skipped), or len
int64_t next_marker(const uint8_t* data, int64_t len, int64_t p) {
  while (p < len) {
    if (data[p] != 0xFF) {
      ++p;
      continue;
    }
    int64_t q = p + 1;
    while (q < len && data[q] == 0xFF) ++q;
    if (q >= len) return len;
    if (data[q] != 0x00) return q - 1;
    p = q + 1;
  }
  return len;
}

// the RSTn marker at or after `pos`; its end, or -1 if the next marker is
// not a restart marker
int64_t skip_restart(const uint8_t* data, int64_t len, int64_t pos) {
  int64_t p = next_marker(data, len, pos);
  if (p + 1 >= len || data[p + 1] < 0xD0 || data[p + 1] > 0xD7) return -1;
  return p + 2;
}

// Blocks of one MCU: calls f(scan component, block pointer) in MCU order.
struct McuWalker {
  int n_comps;
  const int32_t* comp;  // per scan component: dc, ac, h, v, width, height
  int16_t** coefs;
  template <class F>
  bool walk(int32_t mx, int32_t my, F&& f) const {
    for (int i = 0; i < n_comps; ++i) {
      const int32_t* c = comp + i * 6;
      int h = c[2], v = c[3], bw = c[4];
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx) {
          int64_t row = static_cast<int64_t>(my) * v + by;
          int64_t col = static_cast<int64_t>(mx) * h + bx;
          if (!f(i, coefs[i] + (row * bw + col) * 64)) return false;
        }
    }
    return true;
  }
};

// ---- arithmetic decoding (jdarith.c, jaricom.c) ---------------------------

// T.81 Table D.2: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS; the last entry is the fixed probability 0.5
#define V(i, a, b, c, d) ((static_cast<int64_t>(a) << 16) | ((c) << 8) | ((d) << 7) | (b))
const int64_t kAriTab[113 + 1] = {
    V(0, 0x5a1d, 1, 1, 1),     V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),    V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),    V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),    V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),    V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),  V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),  V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),  V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),  V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),  V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),  V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),  V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),  V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),  V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),  V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),  V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),  V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),  V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),  V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),  V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),  V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),  V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),  V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),  V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),  V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),  V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),  V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),  V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),  V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),  V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),  V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),  V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),  V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),  V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),  V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),  V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),  V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),  V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),  V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),  V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),  V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),  V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),  V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),  V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),  V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),  V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),  V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),  V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0), V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0), V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0), V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct Arith {
  const uint8_t* data;
  int64_t len, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // forces reading two bytes first
  bool marker = false;
  uint8_t dc_stats[4][64];
  uint8_t ac_stats[4][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  bool starved = false;

  // PIL hands libjpeg the file in 64 KiB reads and libjpeg's arithmetic
  // decoder cannot suspend: a fetch at the end of a read (a multiple of
  // 64 KiB) or of the file fails there (jdarith.c get_byte)
  int get_byte() {
    if (pos >= len || (pos & 0xFFFF) == 0) starved = true;
    return pos < len ? data[pos++] : -1;
  }

  int decode(uint8_t* st) {
    // renormalisation and data input (D.2.6)
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!marker) {
          int64_t at = pos;
          d = get_byte();
          if (d == 0xFF) {
            do d = get_byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;  // a stuffed zero
            } else {     // a marker: zeros from here on
              marker = true;
              pos = at;
              d = 0;
            }
          } else if (d < 0) {
            marker = true;
            d = 0;
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two bytes in: a becomes 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    // decoding and estimation (D.2.4, D.2.5)
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (sv & 0x80) ^ nm;
      } else {
        a = qe;
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      } else {
        *st = (sv & 0x80) ^ nm;
      }
    }
    return sv >> 7;
  }

  void reset_coder() {
    c = 0;
    a = 0;
    ct = -16;
    marker = false;
  }
};

}  // namespace

extern "C" {

// Decode one sequential Huffman scan starting at data[pos] (the first byte
// after the SOS header).
//   n_comps           components in the scan (1..4)
//   comp[i * 6 + ...] per scan component: dc table, ac table, blocks per
//                     MCU across (h), down (v), and the width and height in
//                     blocks of its coefficient array
//   huff_bits[8][16]  code counts of DC tables 0-3 then AC tables 0-3
//   huff_vals[8][256] their symbols
//   mcus_x, mcus_y    MCUs of the scan (for one component: its blocks)
//   restart           restart interval in MCUs (0: none)
//   coefs[i]          int16 [height, width, 64] per scan component, natural
//                     order, written in place
// Returns the position after the scan's data (its next marker), or
// -1 for an undefined table, -2 for a bad Huffman code, -3 for a missing
// restart marker, -6 for a table libjpeg-turbo refuses.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t pos,
                         int n_comps, const int32_t* comp,
                         const uint8_t* huff_bits, const uint8_t* huff_vals,
                         int32_t mcus_x, int32_t mcus_y, int32_t restart,
                         int16_t** coefs) {
  Table tables[8];
  for (int t = 0; t < 8; ++t)
    build_table(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
  for (int i = 0; i < n_comps; ++i) {
    if (!tables[comp[i * 6]].defined || !tables[4 + comp[i * 6 + 1]].defined)
      return -1;
    if (!table_ok(tables[comp[i * 6]], true) ||
        !table_ok(tables[4 + comp[i * 6 + 1]], false))
      return -6;
  }

  Reader r{data, len, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  McuWalker w{n_comps, comp, coefs};
  int64_t mcu = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        int64_t p = skip_restart(data, len, r.pos);
        if (p < 0) return -3;
        r.pos = p;
        r.align();
        for (int i = 0; i < 4; ++i) pred[i] = 0;
      }
      if (r.insufficient) continue;   // left zero, as libjpeg-turbo
      bool ok = w.walk(mx, my, [&](int i, int16_t* blk) {
        const Table& dc = tables[comp[i * 6]];
        const Table& ac = tables[4 + comp[i * 6 + 1]];
        int s = decode(r, dc);
        if (s < 0 || s > 16) return false;
        if (s) pred[i] += extend(r.bits(s), s);
        blk[0] = static_cast<int16_t>(pred[i]);
        for (int k = 1; k < 64; ++k) {
          int rs = decode(r, ac);
          if (rs < 0) return false;
          int run = rs >> 4;
          s = rs & 15;
          if (s) {
            k += run;
            blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(r.bits(s), s));
          } else {
            if (run != 15) break;  // end of block
            k += 15;
          }
        }
        return true;
      });
      if (!ok) return -2;
    }
  }
  return next_marker(data, len, r.pos);
}

// One progressive Huffman scan (T.81 G.1.2): Ss..Se the spectral band, Ah
// and Al the successive approximation. A DC scan may interleave components;
// an AC scan has one, and one block per MCU. Arguments and returns as
// jpeg_decode_scan; the coefficients accumulate across scans.
int64_t jpeg_decode_scan_progressive(
    const uint8_t* data, int64_t len, int64_t pos, int n_comps,
    const int32_t* comp, const uint8_t* huff_bits, const uint8_t* huff_vals,
    int32_t mcus_x, int32_t mcus_y, int32_t restart, int ss, int se, int ah,
    int al, int16_t** coefs) {
  Table tables[8];
  for (int t = 0; t < 8; ++t)
    build_table(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
  const bool dc_scan = ss == 0;
  for (int i = 0; i < n_comps; ++i) {
    if (dc_scan && ah == 0 && !tables[comp[i * 6]].defined) return -1;
    if (!dc_scan && !tables[4 + comp[i * 6 + 1]].defined) return -1;
    if (dc_scan && ah == 0 && !table_ok(tables[comp[i * 6]], true)) return -6;
    if (!dc_scan && !table_ok(tables[4 + comp[i * 6 + 1]], false)) return -6;
  }
  Reader r{data, len, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  uint32_t eobrun = 0;
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);
  McuWalker w{n_comps, comp, coefs};
  int64_t mcu = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        int64_t p = skip_restart(data, len, r.pos);
        if (p < 0) return -3;
        r.pos = p;
        r.align();
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eobrun = 0;
      }
      if (r.insufficient) continue;   // left as it is, as libjpeg-turbo
      bool ok = w.walk(mx, my, [&](int i, int16_t* blk) {
        if (dc_scan && ah == 0) {  // DC first
          int s = decode(r, tables[comp[i * 6]]);
          if (s < 0 || s > 16) return false;
          if (s) pred[i] += extend(r.bits(s), s);
          blk[0] = static_cast<int16_t>(pred[i] * (1 << al));
          return true;
        }
        if (dc_scan) {  // DC refine: the next bit of the DC value
          if (r.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
          return true;
        }
        const Table& ac = tables[4 + comp[i * 6 + 1]];
        if (ah == 0) {  // AC first
          if (eobrun > 0) {
            --eobrun;
            return true;
          }
          for (int k = ss; k <= se; ++k) {
            int rs = decode(r, ac);
            if (rs < 0) return false;
            int run = rs >> 4, s = rs & 15;
            if (s) {
              k += run;
              blk[kNaturalOrder[k]] =
                  static_cast<int16_t>(extend(r.bits(s), s) * (1 << al));
            } else if (run == 15) {
              k += 15;
            } else {
              eobrun = 1u << run;
              if (run) eobrun += r.bits(run);
              --eobrun;
              break;
            }
          }
          return true;
        }
        // AC refine
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int rs = decode(r, ac);
            if (rs < 0) return false;
            int run = rs >> 4, s = rs & 15;
            if (s) {
              s = r.bits(1) ? p1 : m1;  // a newly nonzero coefficient
            } else if (run != 15) {
              eobrun = 1u << run;
              if (run) eobrun += r.bits(run);
              break;
            }
            // past already-nonzero coefficients (a correction bit each) and
            // `run` still-zero ones
            do {
              int16_t* co = blk + kNaturalOrder[k];
              if (*co != 0) {
                if (r.bits(1) && (*co & p1) == 0)
                  *co = static_cast<int16_t>(*co >= 0 ? *co + p1 : *co + m1);
              } else {
                if (--run < 0) break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* co = blk + kNaturalOrder[k];
            if (*co != 0 && r.bits(1) && (*co & p1) == 0)
              *co = static_cast<int16_t>(*co >= 0 ? *co + p1 : *co + m1);
          }
          --eobrun;
        }
        return true;
      });
      if (!ok) return -2;
    }
  }
  return next_marker(data, len, r.pos);
}

// One arithmetic-coded scan, sequential (progressive = 0) or progressive
// (T.81 F.2.4, G.1.3). dc_l, dc_u, ac_k: the conditioning of each table
// (DAC). Arguments and returns otherwise as jpeg_decode_scan_progressive;
// -4 for a magnitude or spectral overflow, -5 where PIL's decoder runs out
// of data inside the scan (Arith::get_byte).
int64_t jpeg_decode_scan_arith(const uint8_t* data, int64_t len, int64_t pos,
                               int n_comps, const int32_t* comp,
                               const int32_t* dc_l, const int32_t* dc_u,
                               const int32_t* ac_k, int32_t mcus_x,
                               int32_t mcus_y, int32_t restart,
                               int progressive, int ss, int se, int ah, int al,
                               int16_t** coefs) {
  Arith* e = new Arith();
  e->data = data;
  e->len = len;
  e->pos = pos;
  const bool use_dc = !progressive || (ss == 0 && ah == 0);
  const bool use_ac = !progressive || se != 0;
  int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
  auto reset_stats = [&]() {
    for (int i = 0; i < n_comps; ++i) {
      if (use_dc) std::memset(e->dc_stats[comp[i * 6]], 0, 64);
      if (use_ac) std::memset(e->ac_stats[comp[i * 6 + 1]], 0, 256);
      last_dc[i] = 0;
      dc_ctx[i] = 0;
    }
  };
  reset_stats();
  if (!progressive) {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);

  // F.1.4.4.1 / F.2.4.1: a DC difference with its context; false on overflow
  auto decode_dc = [&](int i) -> bool {
    int tbl = comp[i * 6];
    uint8_t* st = e->dc_stats[tbl] + dc_ctx[i];
    if (e->decode(st) == 0) {
      dc_ctx[i] = 0;
      return true;
    }
    int sign = e->decode(st + 1);
    st += 2 + sign;
    int m = e->decode(st);
    if (m != 0) {
      st = e->dc_stats[tbl] + 20;
      while (e->decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << dc_l[tbl]) >> 1))
      dc_ctx[i] = 0;
    else if (m > static_cast<int>((1L << dc_u[tbl]) >> 1))
      dc_ctx[i] = 12 + sign * 4;
    else
      dc_ctx[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (e->decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[i] = (last_dc[i] + v) & 0xffff;
    return true;
  };
  // F.2.4.2 / G.1.3.2: the AC coefficients Ss..Se of a block in first pass
  auto decode_ac = [&](int i, int16_t* blk) -> bool {
    int tbl = comp[i * 6 + 1];
    for (int k = progressive ? ss : 1; k <= se; ++k) {
      uint8_t* st = e->ac_stats[tbl] + 3 * (k - 1);
      if (e->decode(st)) break;  // EOB
      while (e->decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      int sign = e->decode(e->fixed_bin);
      st += 2;
      int m = e->decode(st);
      if (m != 0) {
        if (e->decode(st)) {
          m <<= 1;
          st = e->ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
          while (e->decode(st)) {
            if ((m <<= 1) == 0x8000) return false;
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (e->decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  };
  auto refine_ac = [&](int i, int16_t* blk) -> bool {
    int tbl = comp[i * 6 + 1];
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNaturalOrder[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = e->ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (e->decode(st)) break;  // EOB
      for (;;) {
        int16_t* co = blk + kNaturalOrder[k];
        if (*co) {
          if (e->decode(st + 2))
            *co = static_cast<int16_t>(*co < 0 ? *co + m1 : *co + p1);
          break;
        }
        if (e->decode(st + 1)) {
          *co = static_cast<int16_t>(e->decode(e->fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  };

  McuWalker w{n_comps, comp, coefs};
  int64_t mcu = 0;
  int64_t status = 0;
  for (int32_t my = 0; my < mcus_y && status == 0; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        int64_t p = skip_restart(data, len, e->pos);
        if (p < 0) {
          status = -3;
          break;
        }
        // libjpeg reads up to the marker's code unless the decoder met it
        if (!e->marker && (p - 1) >> 16 > (e->pos - 1) >> 16) e->starved = true;
        e->pos = p;
        e->reset_coder();
        reset_stats();
      }
      bool ok = w.walk(mx, my, [&](int i, int16_t* blk) {
        if (!progressive) {
          if (!decode_dc(i)) return false;
          blk[0] = static_cast<int16_t>(last_dc[i]);
          return decode_ac(i, blk);
        }
        if (ss == 0 && ah == 0) {
          if (!decode_dc(i)) return false;
          blk[0] = static_cast<int16_t>(last_dc[i] * (1 << al));
          return true;
        }
        if (ss == 0) {
          if (e->decode(e->fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | p1);
          return true;
        }
        return ah == 0 ? decode_ac(i, blk) : refine_ac(i, blk);
      });
      if (!ok) {
        status = -4;
        break;
      }
    }
  }
  if (e->starved) status = -5;
  int64_t end = status ? status : next_marker(data, len, e->pos);
  delete e;
  return end;
}

// One lossless Huffman scan (T.81 H.1.2): the difference of each sample,
// into diffs[i] (int32 [height, width] per scan component, the MCU grid:
// one MCU holds h x v samples of each component). comp[i * 6]: dc table,
// unused, h, v, width, height. Returns as jpeg_decode_scan; restart_rows
// gets 1 for each component row the predictor restarts at (first rows of
// the scan and of each restart interval), rows of the first component's
// MCU rows.
int64_t jpeg_decode_scan_lossless(
    const uint8_t* data, int64_t len, int64_t pos, int n_comps,
    const int32_t* comp, const uint8_t* huff_bits, const uint8_t* huff_vals,
    int32_t mcus_x, int32_t mcus_y, int32_t restart, uint8_t* restart_rows,
    int32_t** diffs) {
  Table tables[8];
  for (int t = 0; t < 8; ++t)
    build_table(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
  for (int i = 0; i < n_comps; ++i)
    if (!tables[comp[i * 6]].defined) return -1;
  Reader r{data, len, pos};
  int64_t mcu = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    restart_rows[my] = my == 0;
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        int64_t p = skip_restart(data, len, r.pos);
        if (p < 0) return -3;
        r.pos = p;
        r.align();
        restart_rows[my] = 1;
      }
      for (int i = 0; i < n_comps; ++i) {
        const int32_t* c = comp + i * 6;
        int h = c[2], v = c[3], cw = c[4];
        for (int y = 0; y < v; ++y)
          for (int x = 0; x < h; ++x) {
            int s = decode(r, tables[c[0]]);
            if (s < 0 || s > 16) return -2;
            int32_t d = 0;
            if (s == 16)
              d = 32768;
            else if (s)
              d = extend(r.bits(s), s);
            int64_t row = static_cast<int64_t>(my) * v + y;
            int64_t col = static_cast<int64_t>(mx) * h + x;
            diffs[i][row * cw + col] = d;
          }
      }
    }
  }
  return next_marker(data, len, r.pos);
}

// Undo the prediction of one component (jdpred.c): diff int32 [rows, stride]
// -> out, the first `width` samples of each row, modulo 2^16. A row with
// first_row[r] set takes the one-dimensional predictor from
// 1 << (7 - point_transform); every other row takes `predictor` (1-7),
// its first sample predicted from the sample above.
void jpeg_undifference(const int32_t* diff, int32_t* out, int32_t rows,
                       int32_t stride, int32_t width, const uint8_t* first_row,
                       int predictor, int point_transform) {
  for (int32_t y = 0; y < rows; ++y) {
    const int32_t* d = diff + static_cast<int64_t>(y) * stride;
    int32_t* o = out + static_cast<int64_t>(y) * stride;
    if (first_row[y]) {
      int32_t ra = (d[0] + (1 << (7 - point_transform))) & 0xFFFF;
      o[0] = ra;
      for (int32_t x = 1; x < width; ++x) {
        ra = (d[x] + ra) & 0xFFFF;
        o[x] = ra;
      }
      continue;
    }
    const int32_t* up = o - stride;
    int32_t rb = up[0];
    int32_t ra = (d[0] + rb) & 0xFFFF;
    o[0] = ra;
    for (int32_t x = 1; x < width; ++x) {
      int32_t rc = rb;
      rb = up[x];
      int32_t p;
      switch (predictor) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      ra = (d[x] + p) & 0xFFFF;
      o[x] = ra;
    }
  }
}

// The block smoothing of libjpeg-turbo's decompress_smooth_data for one
// component of a progressive file: coef int16 [arr_h, arr_w, 64] natural
// order -> out (a copy, the real blocks smoothed). coef_bits[0..9]: the Al
// of the last scan of each of the first ten zig-zag coefficients (-1: never
// sent); q[0..9]: the quantisation values at Q00, Q01, Q10, Q20, Q11, Q02,
// Q03, Q12, Q21, Q30. The neighbourhood is 5 x 5 blocks, taken by the
// library's iMCU-row arithmetic (v_samp, total_imcu_rows).
void jpeg_smooth(const int16_t* coef, int16_t* out, int32_t arr_w,
                 int32_t arr_h, int32_t width_in_blocks,
                 int32_t height_in_blocks, int32_t v_samp,
                 int32_t total_imcu_rows, const int32_t* coef_bits,
                 const int32_t* q) {
  std::memcpy(out, coef, sizeof(int16_t) * 64 * arr_w * arr_h);
  const bool change_dc = coef_bits[1] == -1 && coef_bits[2] == -1 &&
                         coef_bits[3] == -1 && coef_bits[4] == -1 &&
                         coef_bits[5] == -1 && coef_bits[6] == -1 &&
                         coef_bits[7] == -1 && coef_bits[8] == -1 &&
                         coef_bits[9] == -1;
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[2], Q20 = q[3], Q11 = q[4],
                Q02 = q[5], Q03 = q[6], Q12 = q[7], Q21 = q[8], Q30 = q[9];
  const int32_t last = total_imcu_rows - 1;
  auto dcv = [&](int32_t row, int32_t col) -> int {
    if (col < 0) col = 0;
    if (col > width_in_blocks - 1) col = width_in_blocks - 1;
    return coef[(static_cast<int64_t>(row) * arr_w + col) * 64];
  };
  auto estimate = [](int64_t num, int64_t qk, int al) -> int {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  };
  for (int32_t imcu = 0; imcu <= last; ++imcu) {
    int32_t block_rows = v_samp;
    if (imcu == last) {
      block_rows = height_in_blocks % v_samp;
      if (block_rows == 0) block_rows = v_samp;
    }
    const int32_t image_block_rows = block_rows * total_imcu_rows;
    for (int32_t br = 0; br < block_rows; ++br) {
      const int32_t image_block_row = imcu * block_rows + br;
      const int32_t row = imcu * v_samp + br;
      const int32_t prev = image_block_row > 0 ? row - 1 : row;
      const int32_t prev2 = image_block_row > 1 ? row - 2 : prev;
      const int32_t next = image_block_row < image_block_rows - 1 ? row + 1 : row;
      const int32_t next2 =
          image_block_row < image_block_rows - 2 ? row + 2 : next;
      const int32_t rows5[5] = {prev2, prev, row, next, next2};
      for (int32_t col = 0; col < width_in_blocks; ++col) {
        int DC[26];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j)
            DC[1 + 5 * i + j] = dcv(rows5[i], col - 2 + j);
        int16_t* ws = out + (static_cast<int64_t>(row) * arr_w + col) * 64;
        int al;
        int64_t num;
        if ((al = coef_bits[1]) != 0 && ws[1] == 0) {  // AC01
          num = Q00 * (change_dc
                           ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] +
                              13 * DC[7] - 13 * DC[9] + 3 * DC[10] -
                              3 * DC[11] + 38 * DC[12] - 38 * DC[14] +
                              3 * DC[15] - 3 * DC[16] + 13 * DC[17] -
                              13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] +
                              DC[24] + DC[25])
                           : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] +
                              7 * DC[15]));
          ws[1] = static_cast<int16_t>(estimate(num, Q01, al));
        }
        if ((al = coef_bits[2]) != 0 && ws[8] == 0) {  // AC10
          num = Q00 * (change_dc
                           ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] -
                              DC[5] - DC[6] + 13 * DC[7] + 38 * DC[8] +
                              13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] -
                              38 * DC[18] - 13 * DC[19] + DC[20] + DC[21] +
                              3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25])
                           : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] +
                              7 * DC[23]));
          ws[8] = static_cast<int16_t>(estimate(num, Q10, al));
        }
        if ((al = coef_bits[3]) != 0 && ws[16] == 0) {  // AC20
          num = Q00 * (change_dc
                           ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] -
                              5 * DC[12] - 14 * DC[13] - 5 * DC[14] +
                              2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23])
                           : (-DC[3] + 13 * DC[8] - 24 * DC[13] +
                              13 * DC[18] - DC[23]));
          ws[16] = static_cast<int16_t>(estimate(num, Q20, al));
        }
        if ((al = coef_bits[4]) != 0 && ws[9] == 0) {  // AC11
          num = Q00 * (change_dc
                           ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] -
                              9 * DC[17] + 9 * DC[19] + DC[21] - DC[25])
                           : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] -
                              DC[2] - DC[20] + DC[22] - DC[24] + DC[4] -
                              DC[6] + 10 * DC[7] - 10 * DC[9]));
          ws[9] = static_cast<int16_t>(estimate(num, Q11, al));
        }
        if ((al = coef_bits[5]) != 0 && ws[2] == 0) {  // AC02
          num = Q00 * (change_dc
                           ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] +
                              7 * DC[12] - 14 * DC[13] + 7 * DC[14] +
                              DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19])
                           : (-DC[11] + 13 * DC[12] - 24 * DC[13] +
                              13 * DC[14] - DC[15]));
          ws[2] = static_cast<int16_t>(estimate(num, Q02, al));
        }
        if (change_dc) {
          if ((al = coef_bits[6]) != 0 && ws[3] == 0) {  // AC03
            num = Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] -
                         DC[19]);
            ws[3] = static_cast<int16_t>(estimate(num, Q03, al));
          }
          if ((al = coef_bits[7]) != 0 && ws[10] == 0) {  // AC12
            num = Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] -
                         DC[19]);
            ws[10] = static_cast<int16_t>(estimate(num, Q12, al));
          }
          if ((al = coef_bits[8]) != 0 && ws[17] == 0) {  // AC21
            num = Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] -
                         DC[19]);
            ws[17] = static_cast<int16_t>(estimate(num, Q21, al));
          }
          if ((al = coef_bits[9]) != 0 && ws[24] == 0) {  // AC30
            num = Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] -
                         DC[19]);
            ws[24] = static_cast<int16_t>(estimate(num, Q30, al));
          }
          num = Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] -
                       2 * DC[5] - 6 * DC[6] + 6 * DC[7] + 42 * DC[8] +
                       6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] +
                       152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] +
                       6 * DC[17] + 42 * DC[18] + 6 * DC[19] - 6 * DC[20] -
                       2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24] -
                       2 * DC[25]);
          ws[0] = static_cast<int16_t>(estimate(num, Q00, 0));
        }
      }
    }
  }
}

}  // extern "C"
