// Run-length and op-stream decoders of PIL's small readers, for
// irgs_tpu_torch/utils/small_codecs.py: Targa RLE (TgaRleDecode.c), PCX RLE
// (PcxDecode.c), SGI RLE (SgiRleDecode.c) and QOI (QoiImagePlugin's
// QoiDecoder), libImaging's PackBits (PackbitsDecode.c, for PSD), the
// RLE of IcnsImagePlugin's read_32, libtiff's ThunderScan decoder for
// the TIFF reader, and for Pillow's last small rasters: SunRleDecode.c,
// XbmDecode.c, MspImagePlugin's MspDecoder, FliDecode.c, PcdDecode.c with
// UnpackYCC.c's PhotoYCC conversion, and BitDecode.c (IM's F;n images).
// Each writes the decoder's line buffers as PIL hands them to
// its unpacker (the caller unpacks them to the mode), keeps the quirks
// that decide what a damaged stream gives (a Targa run packet may not cross
// a row, a literal one may; a PCX line is compacted band by band when its
// stride is padded; an SGI row stops at its first zero count or at a
// nonzero last byte, and its line buffer carries over from row to row),
// and fails where PIL fails. Built with g++ at first use; plain C ABI.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int kDone = 0, kShort = 1, kOverrun = -1;

// UnpackYCC.c's PhotoYCC tables as the RGB they give pins them: each
// channel is L[y] plus the chroma terms, clamped to 0..255, with L[y] =
// round(1.3584 y) (the split of a constant between L and the chroma
// tables is free; these put it in the chroma ones)
static const int16_t PCD_CB[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321,
    -318, -316, -314, -312, -310, -307, -305, -303, -301, -298, -296, -294,
    -292, -290, -287, -285, -283, -281, -278, -276, -274, -272, -270, -267,
    -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214,
    -212, -210, -207, -205, -203, -201, -199, -196, -194, -192, -190, -188,
    -185, -183, -181, -179, -176, -174, -172, -170, -168, -165, -163, -161,
    -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108,
    -105, -103, -101, -99, -97, -94, -92, -90, -88, -85, -83, -81,
    -79, -77, -74, -72, -70, -68, -66, -63, -61, -59, -57, -54,
    -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1,
    0, 2, 4, 7, 9, 11, 13, 16, 18, 20, 22, 24,
    27, 29, 31, 33, 35, 38, 40, 42, 44, 47, 49, 51,
    53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104,
    106, 109, 111, 113, 115, 118, 120, 122, 124, 126, 129, 131,
    133, 135, 138, 140, 142, 144, 146, 149, 151, 153, 155, 157,
    160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211,
    213, 215, 217, 220,
};
static const int16_t PCD_CR[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229,
    -227, -225, -223, -221, -219, -218, -216, -214, -212, -210, -208, -207,
    -205, -203, -201, -199, -198, -196, -194, -192, -190, -188, -187, -185,
    -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141,
    -139, -137, -136, -134, -132, -130, -128, -127, -125, -123, -121, -119,
    -117, -116, -114, -112, -110, -108, -106, -105, -103, -101, -99, -97,
    -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54,
    -52, -50, -48, -46, -45, -43, -41, -39, -37, -35, -34, -32,
    -30, -28, -26, -25, -23, -21, -19, -17, -15, -14, -12, -10,
    -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33,
    35, 36, 38, 40, 42, 44, 46, 47, 49, 51, 53, 55,
    56, 58, 60, 62, 64, 66, 67, 69, 71, 73, 75, 77,
    78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120,
    122, 124, 126, 128, 129, 131, 133, 135, 137, 138, 140, 142,
    144, 146, 148, 149, 151, 153, 155, 157, 158, 160, 162, 164,
    166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208,
    209, 211, 213, 215,
};
static const int16_t PCD_GB[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62,
    62, 62, 61, 61, 60, 60, 59, 59, 59, 58, 58, 57,
    57, 56, 56, 56, 55, 55, 54, 54, 53, 53, 52, 52,
    52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42,
    41, 41, 40, 40, 40, 39, 39, 38, 38, 37, 37, 37,
    36, 36, 35, 35, 34, 34, 34, 33, 33, 32, 32, 31,
    31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21,
    21, 20, 20, 19, 19, 19, 18, 18, 17, 17, 16, 16,
    15, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11,
    10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0,
    0, 0, 0, 0, -1, -1, -2, -2, -2, -3, -3, -4,
    -4, -5, -5, -5, -6, -6, -7, -7, -8, -8, -8, -9,
    -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19,
    -20, -20, -21, -21, -21, -22, -22, -23, -23, -24, -24, -24,
    -25, -25, -26, -26, -27, -27, -27, -28, -28, -29, -29, -30,
    -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40,
    -40, -41, -41, -42,
};
static const int16_t PCD_GR[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117,
    116, 115, 114, 113, 112, 111, 110, 109, 108, 108, 107, 106,
    105, 104, 103, 102, 101, 100, 99, 98, 97, 96, 95, 95,
    94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72,
    71, 70, 70, 69, 68, 67, 66, 65, 64, 63, 62, 61,
    60, 59, 58, 57, 57, 56, 55, 54, 53, 52, 51, 50,
    49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28,
    27, 26, 25, 24, 23, 22, 21, 20, 19, 19, 18, 17,
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 6,
    5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16,
    -17, -18, -18, -19, -20, -21, -22, -23, -24, -25, -26, -27,
    -28, -29, -30, -31, -31, -32, -33, -34, -35, -36, -37, -38,
    -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60,
    -61, -62, -63, -64, -65, -66, -67, -68, -69, -69, -70, -71,
    -72, -73, -74, -75, -76, -77, -78, -79, -80, -81, -82, -82,
    -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105,
    -106, -107, -107, -108,
};

inline uint8_t clamp255(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : v; }

inline int i16le(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline int32_t i32le(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// FliDecode.c on `bytes` bytes of one frame into img (h rows of w):
// >= 0 the bytes taken where it waits for more data, -1 at the frame's
// end, -2 where it fails (its errcode)
int64_t fli_step(const uint8_t* buf, int64_t bytes, int64_t w, int64_t h,
                 uint8_t* img) {
  const uint8_t* ptr = buf;
  if (bytes < 4) return 0;
  int64_t framesize = (uint32_t)i32le(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) return -2;
  if (i16le(ptr + 4) != 0xF1FA) return -2;
  int chunks = i16le(ptr + 6);
  ptr += 16;
  bytes -= 16;
  auto oob = [&](const uint8_t* data, int64_t k) {
    return data + k > ptr + bytes;
  };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return -2;
    const uint8_t* data = ptr + 6;
    int x = 0, y, i = 0;
    switch (i16le(ptr + 4)) {
      case 4:
      case 11:
        break;  // COLOR chunks: the plugin's Python reads them
      case 7: {  // SS2, word delta
        int lines = i16le(data), l;
        data += 2;
        for (l = y = 0; l < lines && y < h; l++, y++) {
          uint8_t* line = img + y * w;
          if (oob(data, 2)) return -2;
          int packets = i16le(data), p;
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= h) return -2;
              line = img + y * w;
            } else {
              line[w - 1] = (uint8_t)packets;
            }
            if (oob(data, 2)) return -2;
            packets = i16le(data);
            data += 2;
          }
          for (p = x = 0; p < packets; p++) {
            if (oob(data, 2)) return -2;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(data, 4)) return -2;
              i = 256 - data[1];
              if (x + i + i > w) break;
              for (int j = 0; j < i; j++) {
                line[x++] = data[2];
                line[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * (int)data[1];
              if (x + i > w) break;
              if (oob(data, 2 + i)) return -2;
              memcpy(line + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return -2;
        break;
      }
      case 12: {  // LC, byte delta
        y = i16le(data);
        int ymax = y + i16le(data + 2);
        data += 4;
        for (; y < ymax && y < h; y++) {
          uint8_t* out = img + y * w;
          if (oob(data, 1)) return -2;
          int packets = *data++, p;
          for (p = x = 0; p < packets; p++, x += i) {
            if (oob(data, 2)) return -2;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > w) break;
              if (oob(data, 3)) return -2;
              memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > w) break;
              if (oob(data, 2 + i)) return -2;
              memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return -2;
        break;
      }
      case 13:  // BLACK
        memset(img, 0, w * h);
        break;
      case 15:  // BRUN
        for (y = 0; y < h; y++) {
          uint8_t* out = img + y * w;
          data += 1;  // the packet count is ignored
          for (x = 0; x < w; x += i) {
            if (oob(data, 2)) return -2;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > w) break;
              if (oob(data, i + 1)) return -2;
              memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > w) break;
              memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != w) return -2;
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / w < h) return -2;
        if (w > bytes / h) return ptr - buf;
        for (y = 0; y < h; y++) {
          memcpy(img + y * w, data, w);
          data += w;
        }
        break;
      case 18:  // PSTAMP
        break;
      default:
        return -2;
    }
    int advance = i32le(ptr);
    if (advance == 0 || advance < 0 || advance > bytes) return -2;
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}
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

// SunRleDecode.c: `rows` lines of `linebytes` into out. 0x80 0x00 is a
// literal 0x80, 0x80 n v a run of n + 1 bytes v that carries on into the
// next lines (the carried count is a byte, so a run of 256 crossing a
// line keeps 256 - the bytes before the line's end, modulo 256), any
// other byte a literal. Returns 0, or 1 where the data ends first.
int sun_rle_decode(const uint8_t* src, int64_t n, int64_t linebytes,
                   int64_t rows, uint8_t* out) {
  const uint8_t* ptr = src;
  int64_t bytes = n, x = 0, y = 0;
  uint8_t* buffer = out;
  if (rows <= 0) return kDone;
  for (;;) {
    uint8_t extra_data = 0, extra_bytes = 0;
    int64_t k;
    if (bytes < 1) return kShort;
    if (ptr[0] == 0x80) {
      if (bytes < 2) return kShort;
      k = ptr[1];
      if (k == 0) {
        k = 1;
        buffer[x] = 0x80;
        ptr += 2;
        bytes -= 2;
      } else {
        if (bytes < 3) return kShort;
        k += 1;
        if (x + k > linebytes) {
          extra_bytes = (uint8_t)k;
          k = linebytes - x;
          extra_bytes = (uint8_t)(extra_bytes - k);
          extra_data = ptr[2];
        }
        memset(buffer + x, ptr[2], k);
        ptr += 3;
        bytes -= 3;
      }
    } else {
      k = 1;
      buffer[x] = ptr[0];
      ptr += 1;
      bytes -= 1;
    }
    for (;;) {
      x += k;
      if (x >= linebytes) {
        x = 0;
        if (++y >= rows) return kDone;
        buffer = out + y * linebytes;
      }
      if (extra_bytes == 0 || x > 0) break;
      k = extra_bytes >= linebytes ? linebytes : extra_bytes;
      memset(buffer + x, extra_data, k);
      extra_bytes = (uint8_t)(extra_bytes - k);
    }
  }
}

// XbmDecode.c: each byte is the two characters after an 'x' (hex digits,
// anything else 0), `linebytes` bytes a line, LSB first as its "1;R"
// unpacker reads them (bits are left as stored; the caller unpacks).
// Returns 0, or 1 where the data ends first.
int xbm_decode(const uint8_t* src, int64_t n, int64_t linebytes, int64_t rows,
               uint8_t* out) {
  auto hex = [](uint8_t v) {
    return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
           : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
  };
  int64_t total = linebytes * rows, got = 0, i = 0;
  if (total <= 0) return kDone;
  for (;;) {
    while (i < n && src[i] != 'x') i++;
    if (n - i < 3) return kShort;
    out[got] = (uint8_t)((hex(src[i + 1]) << 4) + hex(src[i + 2]));
    if (++got >= total) return kDone;
    i += 3;
  }
}

// MspImagePlugin's MspDecoder on the file past its 32-byte header and
// row map: each row's `rowlen[y]` bytes (0: a blank line of `stride`
// 0xFF bytes) hold runs (0, count, value) and literals (count, bytes...);
// the rows' bytes are concatenated, unaligned, into out (at most `cap`
// bytes kept). Returns the bytes produced, or -1 where a row is cut or a
// run's count and value lie past its row's end (PIL's OSError).
int64_t msp_rle_decode(const uint8_t* src, int64_t n, const uint16_t* rowlen,
                       int64_t rows, int64_t stride, uint8_t* out,
                       int64_t cap) {
  int64_t pos = 0, got = 0;
  auto put = [&](uint8_t v) {
    if (got < cap) out[got] = v;
    got++;
  };
  for (int64_t y = 0; y < rows; y++) {
    int64_t len = rowlen[y];
    if (len == 0) {
      for (int64_t k = 0; k < stride; k++) put(0xFF);
      continue;
    }
    if (n - pos < len) return -1;
    const uint8_t* row = src + pos;
    pos += len;
    int64_t idx = 0;
    while (idx < len) {
      int type = row[idx++];
      if (type == 0) {
        if (idx + 2 > len) return -1;
        for (int k = 0; k < row[idx]; k++) put(row[idx + 1]);
        idx += 2;
      } else {
        for (int64_t k = 0; k < type && idx + k < len; k++) put(row[idx + k]);
        idx += type;
      }
    }
  }
  return got;
}

// One FLI/FLC frame as Pillow's ImageFile.load drives FliDecode.c: reads
// of `block` bytes (the frame's size field) from src (the file from the
// frame's offset on) appended to what the decoder left, until it ends the
// frame. Returns 0, 1 where the data ends first ("image file is
// truncated"), or -1 where the decoder fails.
int fli_decode(const uint8_t* src, int64_t n, int64_t block, int64_t w,
               int64_t h, uint8_t* img) {
  int64_t start = 0, avail = 0;
  for (;;) {
    int64_t r = block < n - start - avail ? block : n - start - avail;
    if (r <= 0) return kShort;
    avail += r;
    int64_t res = fli_step(src + start, avail, w, h, img);
    if (res == -1) return kDone;
    if (res < -1) return kOverrun;
    start += res;
    avail -= res;
  }
}

// PcdDecode.c with the "YCC;P" unpacker: `rows` (even) lines of `w`
// pixels in pairs of chunks of 3w bytes: two luma lines, then the chroma
// planes (w/2 each) the pair shares; RGB [rows, w, 3] into out. Returns 0
// or 1 where the data ends first.
int pcd_decode(const uint8_t* src, int64_t n, int64_t w, int64_t rows,
               uint8_t* out) {
  int64_t chunk = 3 * w, y = 0;
  const uint8_t* ptr = src;
  for (;;) {
    if (n < chunk) return kShort;
    for (int line = 0; line < 2; line++) {
      uint8_t* o = out + y * w * 3;
      for (int64_t x = 0; x < w; x++) {
        int l = (int)std::lround(1.3584 * ptr[x + line * w]);
        int cb = ptr[(x + 4 * w) / 2], cr = ptr[(x + 5 * w) / 2];
        o[3 * x] = clamp255(l + PCD_CR[cr]);
        o[3 * x + 1] = clamp255(l + PCD_GB[cb] + PCD_GR[cr]);
        o[3 * x + 2] = clamp255(l + PCD_CB[cb]);
      }
      if (++y >= rows) return kDone;
    }
    ptr += chunk;
    n -= chunk;
  }
}

// BitDecode.c as IM's F;n images drive it (pad 8, fill 3, unsigned,
// rows bottom-up): n-bit values taken LSB first from a bit buffer filled
// LSB first; at a row's end the count of buffered bits is reset and the
// bits themselves are not, and past 32 buffered bits the buffer is
// rebuilt from the last byte. float32 [rows, w] into out. Returns 0, 1
// where the data ends first, -1 for a width of bits outside 1..31.
int bit_decode(const uint8_t* src, int64_t n, int bits, int64_t w,
               int64_t rows, float* out) {
  if (bits < 1 || bits >= 32) return kOverrun;
  uint64_t buffer = 0, mask = (1ull << bits) - 1;
  int count = 0;
  int64_t x = 0, y = rows - 1;
  for (int64_t i = 0; i < n; i++) {
    uint8_t byte = src[i];
    buffer |= (uint64_t)byte << count;
    count += 8;
    while (count >= bits) {
      uint64_t data = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[y * w + x] = (float)data;
      if (++x >= w) {
        if (--y < 0) return kDone;
        x = 0;
        count = 0;
      }
    }
  }
  return kShort;
}

}  // extern "C"
