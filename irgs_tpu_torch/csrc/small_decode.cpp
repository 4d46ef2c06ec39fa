// Run-length and op-stream decoders of PIL's small readers, for
// irgs_tpu_torch/utils/small_codecs.py: Targa RLE (TgaRleDecode.c), PCX RLE
// (PcxDecode.c), SGI RLE (SgiRleDecode.c) and QOI (QoiImagePlugin's
// QoiDecoder), libImaging's PackBits (PackbitsDecode.c, for PSD), the
// RLE of IcnsImagePlugin's read_32, and libtiff's ThunderScan decoder for
// the TIFF reader.
// Each writes the decoder's line buffers as PIL hands them to
// its unpacker (the caller unpacks them to the mode), keeps the quirks
// that decide what a damaged stream gives (a Targa run packet may not cross
// a row, a literal one may; a PCX line is compacted band by band when its
// stride is padded; an SGI row stops at its first zero count or at a
// nonzero last byte, and its line buffer carries over from row to row),
// and fails where PIL fails. Built with g++ at first use; plain C ABI.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int kDone = 0, kShort = 1, kOverrun = -1;
}  // namespace

extern "C" {

// Targa RLE: `depth` bytes a pixel (the header's depth / 8), `linebytes`
// bytes a line as the unpacker reads them, `rows` lines into out (rows *
// linebytes, in the order decoded). Returns 0 when every line is out, 1
// when the data ends first, -1 where a run packet crosses a line.
int tga_rle_decode(const uint8_t* src, int64_t n, int depth, int64_t linebytes,
                   int64_t rows, uint8_t* out) {
  std::vector<uint8_t> line(linebytes > 0 ? linebytes : 1, 0);
  const uint8_t* p = src;
  int64_t left = n, x = 0, y = 0, extra = 0;
  for (;;) {
    if (left < 1) return kShort;
    int64_t cnt = depth * ((p[0] & 0x7f) + 1);
    if (p[0] & 0x80) {
      if (left < 1 + depth) return kShort;
      if (x + cnt > linebytes) return kOverrun;
      if (depth == 1) {
        memset(line.data() + x, p[1], cnt);
      } else {
        for (int64_t i = 0; i < cnt; i += depth)
          memcpy(line.data() + x + i, p + 1, depth);
      }
      p += 1 + depth;
      left -= 1 + depth;
    } else {
      if (left < 1 + cnt) return kShort;
      if (x + cnt > linebytes) {
        extra = cnt;
        cnt = linebytes - x;
        extra -= cnt;
      }
      memcpy(line.data() + x, p + 1, cnt);
      p += 1 + cnt;
      left -= 1 + cnt;
    }
    for (;;) {
      x += cnt;
      if (x >= linebytes) {
        memcpy(out + y * linebytes, line.data(), linebytes);
        x = 0;
        if (++y >= rows) return kDone;
      }
      if (extra == 0) break;
      if (x > 0) break;
      cnt = extra >= linebytes ? linebytes : extra;
      memcpy(line.data() + x, p, cnt);
      p += cnt;
      left -= cnt;
      extra -= cnt;
    }
  }
}

// PCX RLE: lines of `linebytes` (the planes' strides together) for an image
// `xsize` wide whose unpacker takes `bits` bits a pixel; `rows` lines into
// out. Returns 0, 1 (data ends first) or -1 (a run past a line's end, or a
// line too short for the unpacker).
int pcx_decode(const uint8_t* src, int64_t n, int64_t xsize, int bits,
               int64_t linebytes, int64_t rows, uint8_t* out) {
  if ((xsize * bits + 7) / 8 > linebytes) return kOverrun;
  std::vector<uint8_t> line(linebytes, 0);
  const uint8_t* p = src;
  int64_t left = n, x = 0, y = 0;
  for (;;) {
    if (left < 1) return kShort;
    if ((p[0] & 0xC0) == 0xC0) {
      if (left < 2) return kShort;
      for (int c = p[0] & 0x3F; c > 0; c--) {
        if (x >= linebytes) return kOverrun;
        line[x++] = p[1];
      }
      p += 2;
      left -= 2;
    } else {
      line[x++] = p[0];
      p++;
      left--;
    }
    if (x >= linebytes) {
      if (linebytes % xsize && linebytes > xsize) {
        int64_t bands = linebytes / xsize, stride = linebytes / bands;
        for (int64_t i = 1; i < bands; i++)
          memmove(&line[i * xsize], &line[i * stride], xsize);
      }
      memcpy(out + y * linebytes, line.data(), linebytes);
      x = 0;
      if (++y >= rows) return kDone;
    }
  }
}

static int sgi_expand(uint8_t* dest, const uint8_t* s, int n, int z, int xsize,
                      const uint8_t* end, int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (s > end) return -1;
      pixel = *s++;
    } else {
      if (s + 1 > end) return -1;
      pixel = s[1];
      s += 2;
    }
    if (n == 1 && pixel != 0) return n;
    uint8_t count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (s + bpc * count > end) return -1;
      while (count--) {
        memcpy(dest, s, bpc);
        s += bpc;
        dest += z * bpc;
      }
    } else {
      if (s + (bpc == 2 ? 2 : 0) > end) return -1;
      while (count--) {
        memcpy(dest, s, bpc);
        dest += z * bpc;
      }
      s += bpc;
    }
  }
  return 0;
}

// SGI RLE: `buf` is the file past its 512-byte header; `bands` channels of
// `bpc` bytes; out is ysize lines of xsize * bands * bpc bytes in the order
// decoded (the caller flips them). rows_out gets the lines written.
// Returns 0 (every row, or a row that stopped the decoder silently) or -1
// (an offset inside the header, or a packet out of bounds: the length
// table bounds nothing but the packet count).
int sgi_rle_decode(const uint8_t* buf, int64_t bufsize, int64_t xsize,
                   int64_t ysize, int bands, int bpc, uint8_t* out,
                   int64_t* rows_out) {
  *rows_out = 0;
  int64_t tablen = bands * ysize;
  if (bufsize < 8 * tablen) return kOverrun;
  auto rd = [&](int64_t at) {
    return (uint32_t(buf[at]) << 24) | (uint32_t(buf[at + 1]) << 16) |
           (uint32_t(buf[at + 2]) << 8) | uint32_t(buf[at + 3]);
  };
  int64_t linebytes = xsize * bands * bpc;
  std::vector<uint8_t> line(linebytes > 0 ? linebytes : 1, 0);
  const uint8_t* end = buf + bufsize - 1;
  for (int64_t row = 0; row < ysize; row++) {
    for (int c = 0; c < bands; c++) {
      uint32_t off = rd(4 * (row + c * ysize));
      uint32_t len = rd(4 * tablen + 4 * (row + c * ysize));
      if (off < 512) return kOverrun;
      off -= 512;
      int st = sgi_expand(&line[c * bpc], buf + off, int32_t(len), bands,
                          int(xsize), end, bpc);
      if (st == -1) return kOverrun;
      if (st == 1) return kDone;
    }
    memcpy(out + row * linebytes, line.data(), linebytes);
    *rows_out = row + 1;
  }
  return kDone;
}

// QOI: the op stream of QoiDecoder into npix pixels of `bands` (3 or 4)
// bytes. Returns 0, or 1 where the stream ends (or an op is cut) first.
int qoi_decode(const uint8_t* src, int64_t n, int64_t npix, int bands,
               uint8_t* out) {
  uint8_t seen[64][4];
  memset(seen, 0, sizeof(seen));
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t at = 0, px = 0;
  auto put = [&](const uint8_t* v) {
    if (px < npix) memcpy(out + px * bands, v, bands);
    px++;
  };
  while (px < npix) {
    if (at >= n) return kShort;
    uint8_t b = src[at++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (at + 3 > n) return kShort;
      v[0] = src[at], v[1] = src[at + 1], v[2] = src[at + 2], v[3] = prev[3];
      at += 3;
    } else if (b == 0xFF) {
      if (at + 4 > n) return kShort;
      memcpy(v, src + at, 4);
      at += 4;
    } else {
      int op = b >> 6;
      if (op == 0) {
        memcpy(v, seen[b & 63], 4);
      } else if (op == 1) {
        v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = uint8_t(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (at >= n) return kShort;
        uint8_t b2 = src[at++];
        int dg = (b & 63) - 32;
        v[0] = uint8_t(prev[0] + dg + ((b2 >> 4) - 8));
        v[1] = uint8_t(prev[1] + dg);
        v[2] = uint8_t(prev[2] + dg + ((b2 & 15) - 8));
        v[3] = prev[3];
      } else {
        for (int r = (b & 63) + 1; r > 0; r--) put(prev);
        continue;
      }
    }
    memcpy(prev, v, 4);
    memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    put(v);
  }
  return kDone;
}

// ThunderScan (TIFF compression 32809), libtiff's ThunderDecode
// (tif_thunder.c), row by row from the strip's codes: runs of the last
// pixel (none written where the run reaches the row's end), two 3-bit or
// three 2-bit deltas, raw 4-bit values; each row starts from the last
// pixel 0, its pixels packed two a byte. `rows` rows of `cols` pixels into
// out (rows * ceil(cols / 2) bytes) and, per byte, whether libtiff wrote it
// (wrote). Returns 0, or -1 where a row's codes give too few or too many
// pixels (libtiff fails the strip).
int thunder_decode(const uint8_t* src, int64_t n, int64_t rows, int64_t cols,
                   uint8_t* out, uint8_t* wrote) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t rowbytes = (cols + 1) / 2;
  int64_t pos = 0;
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* op = out + r * rowbytes;
    uint8_t* wp = wrote + r * rowbytes;
    unsigned last = 0;
    int64_t npix = 0;
    auto set = [&](unsigned v) {
      last = v & 0xf;
      if (npix < cols) {
        if (npix++ & 1) {
          *op++ |= uint8_t(last);
          ++wp;
        } else {
          op[0] = uint8_t(last << 4);
          wp[0] = 1;
        }
      }
    };
    while (pos < n && npix < cols) {
      int v = src[pos++];
      int d;
      switch (v & 0xc0) {
        case 0x00: {                                  // a run
          int64_t k = v;
          if (npix & 1) {
            op[0] |= uint8_t(last);
            last = *op++;
            ++wp;
            ++npix;
            --k;
          } else {
            last |= last << 4;
          }
          npix += k;
          if (npix < cols)
            for (; k > 0; k -= 2) {
              *op++ = uint8_t(last);
              *wp++ = 1;
            }
          if (k == -1) {
            --op;
            --wp;
            *op &= 0xf0;
          }
          last &= 0xf;
          break;
        }
        case 0x40:                                    // 2-bit deltas
          if ((d = (v >> 4) & 3) != 2) set(unsigned(int(last) + two[d]));
          if ((d = (v >> 2) & 3) != 2) set(unsigned(int(last) + two[d]));
          if ((d = v & 3) != 2) set(unsigned(int(last) + two[d]));
          break;
        case 0x80:                                    // 3-bit deltas
          if ((d = (v >> 3) & 7) != 4) set(unsigned(int(last) + three[d]));
          if ((d = v & 7) != 4) set(unsigned(int(last) + three[d]));
          break;
        default:                                      // raw
          set(unsigned(v));
          break;
      }
    }
    if (npix != cols) return -1;
  }
  return 0;
}

// libImaging's PackbitsDecode over one stream of `rows` lines of
// `rowbytes` (a PSD channel, its per-row byte counts ignored): 0x80 is a
// no-op, and a run or literal that crosses a line's end is cut there, the
// rest dropped (libtiff's PackBits carries it into the next line). Returns
// the bytes taken once every line is out, or -1 when the data ends first.
int64_t packbits_pil_decode(const uint8_t* src, int64_t n, int64_t rowbytes,
                            int64_t rows, uint8_t* out) {
  const uint8_t* p = src;
  int64_t left = n, x = 0, y = 0;
  if (rows <= 0) return 0;
  for (;;) {
    if (left < 1) return -1;
    uint8_t* line = out + y * rowbytes;
    if (p[0] & 0x80) {
      if (p[0] == 0x80) {
        p++;
        left--;
        continue;
      }
      if (left < 2) return -1;
      for (int k = 257 - p[0]; k > 0 && x < rowbytes; k--) line[x++] = p[1];
      p += 2;
      left -= 2;
    } else {
      int64_t cnt = p[0] + 2;
      if (left < cnt) return -1;
      for (int64_t i = 1; i < cnt && x < rowbytes; i++) line[x++] = p[i];
      p += cnt;
      left -= cnt;
    }
    if (x >= rowbytes) {
      x = 0;
      if (++y >= rows) return p - src;
    }
  }
}

// IcnsImagePlugin.read_32's RLE: `bands` planes of `count` bytes from one
// stream; a byte b >= 0x80 repeats the next byte b - 125 times (nothing
// where the file has ended), else the next b + 1 bytes are copied (fewer
// where it ends). Returns 0, 1 where a plane's counts do not add up to
// `count` (PIL's SyntaxError), or 2 where the file ended inside a plane
// (PIL's "buffer is not large enough").
int icns_rle_decode(const uint8_t* src, int64_t n, int64_t count, int bands,
                    uint8_t* out) {
  int64_t pos = 0;
  int rc = 0;
  for (int b = 0; b < bands; b++) {
    uint8_t* plane = out + b * count;
    int64_t left = count, got = 0;
    while (left > 0) {
      if (pos >= n) break;
      int v = src[pos++];
      int64_t block;
      if (v & 0x80) {
        block = v - 125;
        if (pos < n) {
          uint8_t c = src[pos++];
          for (int64_t i = 0; i < block && got < count; i++) plane[got++] = c;
        }
      } else {
        block = v + 1;
        int64_t m = block < n - pos ? block : n - pos;
        for (int64_t i = 0; i < m && got < count; i++) plane[got++] = src[pos + i];
        pos += m;
      }
      left -= block;
    }
    if (left != 0) return 1;
    if (got < count) rc = 2;
  }
  return rc;
}

}  // extern "C"
