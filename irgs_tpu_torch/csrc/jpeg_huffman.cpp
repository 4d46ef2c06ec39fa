// Huffman (entropy) decoding of one baseline JPEG scan, for
// irgs_tpu_torch/utils/jpeg.py: the bit reader with byte stuffing and
// markers, restart intervals, DC prediction and the AC run-lengths of
// libjpeg-turbo's jdhuff.c (ITU-T T.81 F.2.2). The caller parses the
// markers and does the rest of the decode (dequantisation, IDCT,
// upsampling, colour) in numpy. Built with g++ at first use; plain C ABI.

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
  bool defined;
};

void build_table(const uint8_t* bits, const uint8_t* vals, Table* t) {
  // canonical codes (T.81 C.2): codes of each length follow those of the
  // length before, shifted left by one
  t->defined = false;
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l - 1];
  if (total == 0) return;
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    if (n) {
      t->valoffset[l] = k - code;
      code += n;
      k += n;
      t->maxcode[l] = code - 1;
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
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }
  int bit() {
    if (nbits < 1) fill();
    int b = static_cast<int>(buf >> 63);
    buf <<= 1;
    --nbits;
    return b;
  }
  int32_t bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }
  // drop the buffered bits; position at the next marker
  void align() {
    buf = 0;
    nbits = 0;
    hit_marker = false;
  }
};

// -1 for a code longer than 16 bits
inline int decode(Reader& r, const Table& t) {
  int32_t code = r.bit();
  int l = 1;
  while (code > t.maxcode[l]) {
    code = (code << 1) | r.bit();
    if (++l > 16) return -1;
  }
  return t.vals[t.valoffset[l] + code];
}

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// the RSTn marker at `pos` (after any 0xFF fill bytes); 1 if found
int skip_restart(Reader& r) {
  int64_t p = r.pos;
  while (p < r.len && r.data[p] != 0xFF) ++p;  // trailing fill bits' bytes
  while (p < r.len && r.data[p] == 0xFF) ++p;
  if (p >= r.len || r.data[p] < 0xD0 || r.data[p] > 0xD7) return 0;
  r.pos = p + 1;
  r.align();
  return 1;
}

}  // namespace

extern "C" {

// Decode one scan starting at data[pos] (the first byte after the SOS
// header).
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
// restart marker.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t pos,
                         int n_comps, const int32_t* comp,
                         const uint8_t* huff_bits, const uint8_t* huff_vals,
                         int32_t mcus_x, int32_t mcus_y, int32_t restart,
                         int16_t** coefs) {
  Table tables[8];
  for (int t = 0; t < 8; ++t)
    build_table(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
  for (int i = 0; i < n_comps; ++i)
    if (!tables[comp[i * 6]].defined || !tables[4 + comp[i * 6 + 1]].defined)
      return -1;

  Reader r{data, len, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t mcu = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        if (!skip_restart(r)) return -3;
        for (int i = 0; i < 4; ++i) pred[i] = 0;
      }
      for (int i = 0; i < n_comps; ++i) {
        const int32_t* c = comp + i * 6;
        const Table& dc = tables[c[0]];
        const Table& ac = tables[4 + c[1]];
        int h = c[2], v = c[3], bw = c[4];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = static_cast<int64_t>(my) * v + by;
            int64_t col = static_cast<int64_t>(mx) * h + bx;
            int16_t* blk = coefs[i] + (row * bw + col) * 64;
            int s = decode(r, dc);
            if (s < 0 || s > 16) return -2;
            if (s) pred[i] += extend(r.bits(s), s);
            blk[0] = static_cast<int16_t>(pred[i]);
            for (int k = 1; k < 64; ++k) {
              int rs = decode(r, ac);
              if (rs < 0) return -2;
              int run = rs >> 4;
              s = rs & 15;
              if (s) {
                k += run;
                blk[kNaturalOrder[k]] =
                    static_cast<int16_t>(extend(r.bits(s), s));
              } else {
                if (run != 15) break;  // end of block
                k += 15;
              }
            }
          }
        }
      }
    }
  }
  // the scan ends at the next marker; whole bytes of padding are skipped
  int64_t p = r.pos;
  while (p < len && !(data[p] == 0xFF && p + 1 < len && data[p + 1] != 0x00 &&
                      data[p + 1] != 0xFF))
    ++p;
  return p;
}

}  // extern "C"
