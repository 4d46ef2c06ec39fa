// WebP bitstream decoders of the WebP reader (irgs_tpu_torch/utils/webp.py),
// each computing what libwebp's WebPDecode gives PIL (WebPAnimDecoder,
// default options: RGBA, not premultiplied, fancy upsampling, no
// dithering):
//   webp_vp8l_decode  a VP8L lossless stream (RFC 9649): the predictor
//                     (14 modes), cross-colour, subtract-green and
//                     colour-indexing transforms, the colour cache, meta
//                     prefix codes, LZ77 with the 120-entry distance map;
//                     RGBA out;
//   webp_vp8_decode   a VP8 key frame (RFC 6386): the boolean decoder,
//                     segments, both loop filters, 1-8 token partitions,
//                     the intra predictors, WHT and IDCT, then libwebp's
//                     YUV->RGB (14-bit fixed point) with its 9-3-3-1 fancy
//                     upsampler; RGBA out with alpha 255;
//   webp_alph_decode  an ALPH chunk's payload: raw or VP8L-compressed
//                     (the green channel), then the spatial unfiltering.
// A stream that reads past its end, or that libwebp refuses, returns a
// negative code and no image. Built with g++ at first use; plain C ABI.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum {
  OK = 0,
  ERR_BITSTREAM = -1,   // malformed stream
  ERR_EOF = -2,         // the data ends before the image
  ERR_UNSUPPORTED = -3, // not a key frame, or a frame not shown
  ERR_HEADER = -4,      // the stream's size is not the container's
};

// ------------------------------------------------------------- VP8L ----

// distance codes 1..120 -> (dx, dy) of RFC 9649, section 5.2.2
const int8_t kDistanceMap[120][2] = {
  {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2},
  {-1, 2}, {2, 1}, {-2, 1}, {2, 2}, {-2, 2}, {0, 3}, {3, 0},
  {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3}, {3, 2},
  {-3, 2}, {0, 4}, {4, 0}, {1, 4}, {-1, 4}, {4, 1}, {-4, 1},
  {3, 3}, {-3, 3}, {2, 4}, {-2, 4}, {4, 2}, {-4, 2}, {0, 5},
  {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0}, {1, 5}, {-1, 5},
  {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2}, {4, 4},
  {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0},
  {1, 6}, {-1, 6}, {6, 1}, {-6, 1}, {2, 6}, {-2, 6}, {6, 2},
  {-6, 2}, {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6},
  {6, 3}, {-6, 3}, {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5},
  {-5, 5}, {7, 1}, {-7, 1}, {4, 6}, {-4, 6}, {6, 4}, {-6, 4},
  {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7}, {-3, 7}, {7, 3},
  {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5}, {8, 0}, {4, 7},
  {-4, 7}, {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6},
  {8, 3}, {5, 7}, {-5, 7}, {7, 5}, {-7, 5}, {8, 4}, {6, 7},
  {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6},
  {8, 7}};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

// LSB-first bit reader. Near the end it reads as libwebp's VP8LBitReader
// does once every byte is loaded: its 64-bit word holds the last 8 bytes
// and a read takes word >> (bit position & 63), so bits past the end are 0
// within the word and wrap to its start beyond it. The stream is refused
// once more bits were taken than it holds (libwebp's end-of-stream test:
// a stream shorter than 8 bytes counts as 64 bits).
struct LBits {
  const uint8_t* buf;
  int64_t len;
  int64_t bp = 0;      // bits taken
  int64_t limit;       // bits the stream holds, for the end-of-stream test

  LBits(const uint8_t* b, int64_t n) : buf(b), len(n) {
    limit = n < 8 ? 64 : 8 * n;
  }
  // the next 57 or more bits, bit 0 the next one
  uint64_t window() const {
    const int64_t byte = bp >> 3;
    uint64_t w = 0;
    if (byte + 8 <= len) {
      std::memcpy(&w, buf + byte, 8);       // little-endian host
      return w >> (bp & 7);
    }
    const int64_t start = len < 8 ? 0 : len - 8;   // libwebp's last word
    for (int64_t i = start; i < len; ++i)
      w |= uint64_t(buf[i]) << (8 * (i - start));
    return w >> ((bp - 8 * start) & 63);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = uint32_t(window() & ((uint64_t(1) << n) - 1));
    bp += n;
    return v;
  }
  bool eos() const { return bp > limit; }
};

// A canonical prefix code: a 256-entry root table on the next 8 bits and
// second-level tables for longer codes. Entry: bits 0-15 symbol (or
// subtable offset), 16-23 length (or subtable bits), bit 31 a link.
struct Huff {
  bool single = false;
  int symbol = 0;
  std::vector<uint32_t> table;

  inline int decode(LBits& br) const {
    if (single) return symbol;
    uint64_t w = br.window();
    uint32_t e = table[w & 255];
    if (!(e >> 31)) {
      br.bp += (e >> 16) & 0xff;
      return e & 0xffff;
    }
    int sub = (e >> 16) & 0xff;
    uint32_t e2 = table[(e & 0xffff) + ((w >> 8) & ((1u << sub) - 1))];
    br.bp += 8 + ((e2 >> 16) & 0xff);
    return e2 & 0xffff;
  }
};

uint32_t reverse_bits(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
  return r;
}

// lengths[0..n) -> h; false where libwebp refuses the code: no symbol, a
// length over 15, or a code that is not complete (one symbol alone is a
// code of length 0)
bool build_huff(const int* lengths, int n, Huff& h) {
  int count[16] = {0};
  for (int i = 0; i < n; ++i) {
    if (lengths[i] < 0 || lengths[i] > 15) return false;
    ++count[lengths[i]];
  }
  if (count[0] == n) return false;
  int nsym = n - count[0];
  if (nsym == 1) {
    for (int i = 0; i < n; ++i)
      if (lengths[i]) h.symbol = i;
    h.single = true;
    return true;
  }
  int64_t left = 1;
  for (int len = 1; len <= 15; ++len) {
    left <<= 1;
    left -= count[len];
    if (left < 0) return false;
  }
  if (left != 0) return false;
  uint32_t next[16];
  uint32_t code = 0;
  count[0] = 0;
  for (int len = 1; len <= 15; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  std::vector<uint32_t> rev(n), maxsub(256, 0);
  for (int i = 0; i < n; ++i) {
    int len = lengths[i];
    if (!len) continue;
    rev[i] = reverse_bits(next[len]++, len);
    if (len > 8 && uint32_t(len - 8) > maxsub[rev[i] & 255])
      maxsub[rev[i] & 255] = len - 8;
  }
  h.table.assign(256, 0);
  std::vector<uint32_t> off(256, 0);
  for (int k = 0; k < 256; ++k) {
    if (!maxsub[k]) continue;
    off[k] = uint32_t(h.table.size());
    h.table[k] = 0x80000000u | (maxsub[k] << 16) | off[k];
    h.table.resize(h.table.size() + (size_t(1) << maxsub[k]), 0);
  }
  for (int i = 0; i < n; ++i) {
    int len = lengths[i];
    if (!len) continue;
    if (len <= 8) {
      for (uint32_t k = rev[i]; k < 256; k += 1u << len)
        h.table[k] = (uint32_t(len) << 16) | uint32_t(i);
    } else {
      uint32_t low = rev[i] & 255, sub = maxsub[low];
      for (uint32_t k = rev[i] >> 8; k < (1u << sub); k += 1u << (len - 8))
        h.table[off[low] + k] = (uint32_t(len - 8) << 16) | uint32_t(i);
    }
  }
  return true;
}

struct VP8LDec {
  LBits br;
  // an ALPH stream whose only transform is colour indexing: libwebp reads
  // it with DecodeAlphaData where, with no colour cache and one symbol for
  // each of red, blue and alpha, a read past the end is refused only while
  // pixels remain
  bool alpha_palette = false;
  bool end_read_past_ok = false;
  explicit VP8LDec(const uint8_t* b, int64_t n) : br(b, n) {}
};

bool read_code(VP8LDec& d, int alphabet, Huff& h) {
  LBits& br = d.br;
  std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
  if (br.read(1)) {                          // simple code
    int nsym = br.read(1) + 1;
    int first8 = br.read(1);
    int s = br.read(first8 ? 8 : 1);
    lengths[s] = 1;
    if (nsym == 2) lengths[br.read(8)] = 1;
  } else {                                   // normal code
    int cl[19] = {0};
    int ncodes = br.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huff clh;
    if (!build_huff(cl, 19, clh)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int prev = 8, sym = 0;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      int c = clh.decode(br);
      if (c < 16) {
        lengths[sym++] = c;
        if (c) prev = c;
      } else {
        const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        int rep = br.read(extra[c - 16]) + base[c - 16];
        if (sym + rep > alphabet) return false;
        int v = c == 16 ? prev : 0;
        while (rep-- > 0) lengths[sym++] = v;
      }
    }
  }
  if (br.eos()) return false;
  return build_huff(lengths.data(), alphabet, h);
}

inline int copy_value(LBits& br, int code) {   // prefix code -> value
  if (code < 4) return code + 1;
  int extra = (code - 2) >> 1;
  int offset = (2 + (code & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int d = kDistanceMap[code - 1][1] * xsize + kDistanceMap[code - 1][0];
  return d >= 1 ? d : 1;
}

inline int div_round_up(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

bool decode_sub(VP8LDec& d, int xs, int ys, std::vector<uint32_t>& out);

// the entropy-coded image of xs x ys (colour cache, prefix codes with the
// meta codes where `meta`, LZ77) -> out
bool decode_entropy(VP8LDec& d, int xs, int ys, bool meta,
                    std::vector<uint32_t>& out) {
  LBits& br = d.br;
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  int hbits = 0, hx = 1, ngroups = 1;
  std::vector<uint32_t> groups_of;
  if (meta && br.read(1)) {
    hbits = br.read(3) + 2;
    hx = div_round_up(xs, hbits);
    if (!decode_sub(d, hx, div_round_up(ys, hbits), groups_of)) return false;
    for (auto& p : groups_of) {
      p = (p >> 8) & 0xffff;
      if (int(p) + 1 > ngroups) ngroups = int(p) + 1;
    }
  }
  if (br.eos()) return false;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Huff> codes(size_t(ngroups) * 5);
  for (int g = 0; g < ngroups; ++g)
    for (int j = 0; j < 5; ++j)
      if (!read_code(d, alphabets[j], codes[size_t(g) * 5 + j])) return false;
  bool lenient = meta && d.alpha_palette && !cache_bits;
  for (int g = 0; g < ngroups && lenient; ++g)
    for (int j = 1; j <= 3; ++j)
      lenient &= codes[size_t(g) * 5 + j].single;
  d.end_read_past_ok = lenient;

  const int64_t total = int64_t(xs) * ys;
  out.assign(size_t(total), 0);
  uint32_t* data = out.data();
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  const int cache_shift = 32 - cache_bits;
  int64_t pos = 0, cached = 0;
  int x = 0, y = 0;
  const Huff* h = codes.data();
  while (pos < total) {
    if (hbits) h = &codes[size_t(groups_of[size_t(y >> hbits) * hx +
                                           (x >> hbits)]) * 5];
    int g = h[0].decode(br);
    if (g < 256) {
      int r = h[1].decode(br);
      int b = h[2].decode(br);
      int a = h[3].decode(br);
      data[pos++] = (uint32_t(a) << 24) | (uint32_t(r) << 16) |
                    (uint32_t(g) << 8) | uint32_t(b);
      if (++x == xs) { x = 0; ++y; }
    } else if (g < 280) {
      int len = copy_value(br, g - 256);
      int dist = plane_distance(xs, copy_value(br, h[4].decode(br)));
      if (br.eos() && !lenient) return false;
      if (pos < dist || total - pos < len) return false;
      for (int i = 0; i < len; ++i, ++pos) data[pos] = data[pos - dist];
      x += len;
      while (x >= xs) { x -= xs; ++y; }
    } else {                                 // a colour-cache index
      for (; cached < pos; ++cached)
        cache[(0x1e35a7bdu * data[cached]) >> cache_shift] = data[cached];
      data[pos++] = cache[g - 280];
      if (++x == xs) { x = 0; ++y; }
    }
    if (br.eos() && (!lenient || pos < total)) return false;
  }
  return true;
}

bool decode_sub(VP8LDec& d, int xs, int ys, std::vector<uint32_t>& out) {
  return decode_entropy(d, xs, ys, false, out);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) -
                            int((c >> s) & 0xff))) << s;
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
    out |= uint32_t(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

inline uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  // top points at the pixel above; top[-1] is TL, top[1] TR (for the last
  // column the first pixel of the current row, as the data is contiguous)
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamp_add_sub_full(L, top[0], top[-1]);
    case 13: return clamp_add_sub_half(average2(L, top[0]), top[-1]);
    default: return 0xff000000u;             // 0, and the unused 14, 15
  }
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

// the level-0 image: transforms, then the entropy image, transforms undone
bool decode_vp8l_image(VP8LDec& d, int w, int h, std::vector<uint32_t>& img) {
  LBits& br = d.br;
  std::vector<Transform> tr;
  int seen = 0, xsize = w;
  while (br.read(1)) {
    Transform t;
    t.type = br.read(2);
    if (seen & (1 << t.type)) return false;
    seen |= 1 << t.type;
    t.xsize = xsize;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {
      t.bits = br.read(3) + 2;
      if (!decode_sub(d, div_round_up(xsize, t.bits), div_round_up(h, t.bits),
                      t.data))
        return false;
    } else if (t.type == 3) {
      int ncolors = br.read(8) + 1;
      t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      std::vector<uint32_t> pal;
      if (!decode_sub(d, ncolors, 1, pal)) return false;
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < ncolors; ++i)
        t.data[i] = add_pixels(pal[i], t.data[i - 1]);
      xsize = div_round_up(xsize, t.bits);
    }
    if (br.eos()) return false;
    tr.push_back(std::move(t));
  }
  d.alpha_palette &= tr.size() == 1 && tr[0].type == 3;
  if (!decode_entropy(d, xsize, h, true, img)) return false;
  for (int k = int(tr.size()) - 1; k >= 0; --k) {
    const Transform& t = tr[k];
    const int tw = t.xsize;
    if (t.type == 0) {                       // predictor
      uint32_t* p = img.data();
      const int tiles = div_round_up(tw, t.bits);
      p[0] = add_pixels(p[0], 0xff000000u);
      for (int x = 1; x < tw; ++x) p[x] = add_pixels(p[x], p[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = p + int64_t(y) * tw;
        row[0] = add_pixels(row[0], row[-tw]);
        const uint32_t* modes = t.data.data() + int64_t(y >> t.bits) * tiles;
        for (int x = 1; x < tw; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1],
                                              row + x - tw));
        }
      }
    } else if (t.type == 1) {                // cross-colour
      const int tiles = div_round_up(tw, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = img.data() + int64_t(y) * tw;
        const uint32_t* m = t.data.data() + int64_t(y >> t.bits) * tiles;
        for (int x = 0; x < tw; ++x) {
          uint32_t c = m[x >> t.bits];
          int8_t g2r = int8_t(c & 0xff), g2b = int8_t((c >> 8) & 0xff),
                 r2b = int8_t((c >> 16) & 0xff);
          uint32_t argb = row[x];
          int8_t green = int8_t(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((int(g2r) * green) >> 5)) & 0xff;
          blue += (int(g2b) * green) >> 5;
          blue += (int(r2b) * int8_t(red)) >> 5;
          blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) |
                   uint32_t(blue);
        }
      }
    } else if (t.type == 2) {                // subtract green
      for (auto& px : img) {
        uint32_t g = (px >> 8) & 0xff;
        px = add_pixels(px, (g << 16) | g);
      }
    } else {                                 // colour indexing
      const int packed = div_round_up(tw, t.bits);
      std::vector<uint32_t> out(size_t(tw) * h);
      const int bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
      const int per = (1 << t.bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = img.data() + int64_t(y) * packed;
        uint32_t* dst = out.data() + int64_t(y) * tw;
        for (int x = 0; x < tw; ++x) {
          int g = (src[x >> t.bits] >> 8) & 0xff;
          int idx = (g >> ((x & per) * bpp)) & mask;
          dst[x] = t.data[idx];
        }
      }
      img.swap(out);
    }
  }
  return true;
}

// the alpha unfilters of the WebP container spec (libwebp filters.c):
// 1 horizontal, 2 vertical, 3 gradient; the first row is horizontal
void unfilter_alpha(int filter, uint8_t* a, int w, int h) {
  if (filter == 0) return;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = a + int64_t(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (!prev || filter == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = uint8_t(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = uint8_t(prev[x] + row[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        int top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = uint8_t(row[x] + g);
        top_left = top;
        row[x] = uint8_t(left);
      }
    }
  }
}

}  // namespace

extern "C" {

// A VP8L stream (from its 0x2f signature) of `width` x `height` -> RGBA.
// 0 or a negative code.
int64_t webp_vp8l_decode(const uint8_t* data, int64_t size, int32_t width,
                         int32_t height, uint8_t* rgba) {
  VP8LDec d(data, size);
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0)
    return ERR_BITSTREAM;
  d.br.read(8);
  const int w = d.br.read(14) + 1, h = d.br.read(14) + 1;
  d.br.read(1);
  if (d.br.read(3) != 0) return ERR_BITSTREAM;
  if (w != width || h != height) return ERR_HEADER;
  std::vector<uint32_t> img;
  if (!decode_vp8l_image(d, width, height, img) || d.br.eos())
    return d.br.eos() ? ERR_EOF : ERR_BITSTREAM;
  for (size_t i = 0; i < img.size(); ++i) {
    uint32_t p = img[i];
    rgba[4 * i + 0] = (p >> 16) & 0xff;
    rgba[4 * i + 1] = (p >> 8) & 0xff;
    rgba[4 * i + 2] = p & 0xff;
    rgba[4 * i + 3] = p >> 24;
  }
  return OK;
}

// An ALPH chunk's payload (its header byte first) for a `width` x `height`
// frame -> the alpha plane. 0 or a negative code.
int64_t webp_alph_decode(const uint8_t* data, int64_t size, int32_t width,
                         int32_t height, uint8_t* alpha) {
  if (size <= 1) return ERR_BITSTREAM;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) return ERR_BITSTREAM;
  const int64_t n = int64_t(width) * height;
  if (method == 0) {
    if (size - 1 < n) return ERR_EOF;
    std::memcpy(alpha, data + 1, size_t(n));
  } else {
    VP8LDec d(data + 1, size - 1);
    d.alpha_palette = true;
    std::vector<uint32_t> img;
    const bool ok = decode_vp8l_image(d, width, height, img);
    if (!ok || (d.br.eos() && !d.end_read_past_ok))
      return d.br.eos() ? ERR_EOF : ERR_BITSTREAM;
    for (int64_t i = 0; i < n; ++i) alpha[i] = (img[size_t(i)] >> 8) & 0xff;
  }
  unfilter_alpha(filter, alpha, width, height);
  return OK;
}

}  // extern "C"

// -------------------------------------------------------------- VP8 ----

namespace {

// RFC 6386, section 13.5: default_coeff_probs [type][band][ctx][node]
const uint8_t kCoeffProbs0[4][8][3][11] = {
  {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
    {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
    {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
   {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
    {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
    {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
   {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
    {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
    {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
   {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
    {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
    {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
   {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
    {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
    {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
   {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
    {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
    {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
    {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
    {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
   {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
    {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
    {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
   {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
    {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
    {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
   {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
    {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
    {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
   {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
    {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
    {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
   {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
    {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
    {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
   {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
    {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
    {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
   {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
    {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
    {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
  {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
    {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
    {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
   {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
    {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
    {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
   {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
    {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
    {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
   {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
    {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
    {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
   {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
    {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
    {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
    {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
    {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
    {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
    {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
   {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
    {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
    {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
   {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
    {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
    {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
   {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
    {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
    {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
   {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
    {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
    {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
   {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
    {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
    {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
   {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
    {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
    {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

// RFC 6386, section 13.4: coeff_update_probs
const uint8_t kCoeffUpdateProbs[4][8][3][11] = {
  {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
    {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
    {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
    {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
    {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
    {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

// sub-block intra modes in the RFC's order (section 8.1)
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };

// RFC 6386, section 11.5: kf_bmode_probs [above][left][node]
const uint8_t kBModeProbs[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

// RFC 6386, section 11.2: bmode_tree, leaves as -mode
const int8_t kBModeTree[18] = {-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12,
                               -B_HE, 10, -B_RD, -B_VR, -B_LD, 14,
                               -B_VL, 16, -B_HD, -B_HU};

// RFC 6386, section 14.1: dc_qlookup and ac_qlookup
const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154,
  157};
const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
  152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
  205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
  274, 279, 284};

// RFC 6386, section 13: zigzag order, coefficient bands, and the
// extra-bit probabilities of DCT_CAT3..6 (section 13.2)
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                            6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                         153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The boolean decoder (RFC 6386, section 7) as libwebp's 64-bit builds
// read it: `range` holds range - 1; 7 bytes come in at once while 8 remain,
// then one at a time, into a 64-bit word whose high bits the shifts drop
// (which matters only for a stream no encoder writes, whose value runs
// past its range); the first read past the end sets `eof` (a zero byte is
// shifted in once) — the frame is then refused.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  inline int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);     // libwebp's range_t
    int b;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // libwebp's VP8GetSigned: a coefficient's sign, read at probability 1/2
  // without a branch (the same bit as bit(0x80) unless the value runs 2^31
  // past its range)
  inline int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int literal(int n) {                       // n bits, most significant first
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    int v = literal(n);
    return bit(0x80) ? -v : v;
  }
  int flag() { return bit(0x80); }
};

struct MBInfo {            // the per-column contexts of the row above
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, segment, skip, uvmode;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0, inner = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

// Returns the position of the last non-zero coefficient plus one (libwebp
// GetCoeffs).
int get_coeffs(BoolDec& br, const uint8_t (*bands)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      if (!br.bit(p[3])) {
        if (!br.bit(p[4])) v = 2;
        else v = 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// Returns 1 where the macroblock has no non-zero coefficient (libwebp
// ParseResiduals).
int parse_residuals(BoolDec& br, const uint8_t (*probas)[8][3][11],
                    const QuantMatrix& q, MBInfo& mb, MBInfo& left,
                    MBData& block) {
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  const uint8_t (*ac_proba)[3][11];
  int first;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, probas[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = probas[0];
  } else {
    first = 0;
    ac_proba = probas[3];
  }
  uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(mb.nz >> (4 + ch));
    lnz = uint8_t(left.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, probas[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  mb.nz = uint8_t(out_t_nz);
  left.nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction, in libwebp's work buffer of 32-byte rows ----

const int BPS = 32;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

#undef MUL1
#undef MUL2

// libwebp's Transform_SSE2, which its x86 builds (PIL's) run for the full
// transform: the same steps in 16-bit lanes, each sum wrapping, MUL as
// mulhi(x, k) + x. Coefficients an encoder writes keep every lane in range,
// where this equals transform_one; a corrupt stream's do not.
inline int16_t w16(int v) { return int16_t(v); }
inline int16_t mulhi(int16_t x, int k) { return int16_t((int32_t(x) * k) >> 16); }

void transform_sse2(const int16_t* in, uint8_t* dst) {
  const int k1 = 20091, k2 = -30068;
  int16_t T[4][4];                             // [column][row]
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, k2) - mulhi(i3, k1)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, k1) + mulhi(i3, k2)));
    T[i][0] = w16(a + d);
    T[i][1] = w16(b + c);
    T[i][2] = w16(b - c);
    T[i][3] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r, dst += BPS) {
    const int16_t t0 = T[0][r], t1 = T[1][r], t2 = T[2][r], t3 = T[3][r];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, k2) - mulhi(t3, k1)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, k1) + mulhi(t3, k2)));
    const int16_t o[4] = {int16_t(w16(a + d) >> 3), int16_t(w16(b + c) >> 3),
                          int16_t(w16(b - c) >> 3), int16_t(w16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x) dst[x] = clip8(w16(dst[x] + o[x]));
  }
}

// libwebp's DoTransform: by the block's non-zero code, the full transform
// (code 3) or its C shortcuts for DC only (1) and three coefficients (2),
// which equal transform_one on such blocks
inline void add_residual(uint32_t code, const int16_t* src, uint8_t* dst) {
  if (code == 3) transform_sse2(src, dst);
  else if (code) transform_one(src, dst);
}

// libwebp's DoUVTransform on one 8x8 plane (`bits`: its four blocks'
// codes; a skipped macroblock's coefficients are stale, its bits 0): the
// full transform of all four blocks where any has an AC coefficient, else
// the DC shortcut of each block with a DC
void add_residual_uv(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!bits) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) transform_sse2(src + 16 * n, d);
    else if (src[16 * n]) transform_one(src + 16 * n, d);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (uint8_t(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]),
                               AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]),
                               AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      std::memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      std::memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      std::memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                B = top[1], C = top[2], D = top[3];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2],
                D = top[3];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {                                   // B_HU
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = uint8_t(L);
      break;
    }
  }
}

#undef DST
#undef AVG3
#undef AVG2

// 16x16 luma or 8x8 chroma prediction with the whole-block modes; DC takes
// the samples that exist (no top on the first macroblock row, no left on
// the first column, 128 with neither)
void predict_block(int mode, uint8_t* dst, int size, bool has_top,
                   bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc = (dc + size) >> (shift + 1);
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:                                     // B_HE
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

// ---- loop filter (RFC 6386, section 15; libwebp dsp/dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// simple filter along an edge of 16 pixels; `step` crosses the edge, `next`
// moves along it
void simple_edge(uint8_t* p, int step, int next, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += next)
    if (needs_filter(p, step, t2)) do_filter2(p, step);
}

// normal filter along an edge of `size` pixels: the macroblock edge's
// 6-tap filter (`mb`) or the inner edges' 4-tap one
void normal_edge(uint8_t* p, int step, int next, int size, int thresh,
                 int ithresh, int hev_t, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += next) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_t)) do_filter2(p, step);
    else if (mb) do_filter6(p, step);
    else do_filter4(p, step);
  }
}

// ---- libwebp's YUV -> RGB (yuv.h) and fancy upsampler (upsampling.c) ----

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgba[1] = uint8_t(yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                              mult_hi(v, 13320) + 8708));
  rgba[2] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
  rgba[3] = 0xff;
}

// UpsampleRgbaLinePair: the output rows top (and bottom, where given) of
// `len` pixels from the chroma rows top_uv and cur_uv, each channel as
// libwebp's packed arithmetic computes it
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
              top_dst);
  if (bottom_y)
    yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2,
                (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
                top_dst + (2 * x) * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1,
                  (d03_v + l_v) >> 1, bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                  bottom_dst + (2 * x) * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
                (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                  (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 4);
  }
}

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

int decode_vp8(const uint8_t* data, size_t size, int width, int height,
               uint8_t* rgba) {
  // frame tag (RFC 6386, section 9.1) and the key frame's start code
  if (size < 4) return ERR_EOF;
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(tag & 1);
  const int profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
  const uint32_t part0_len = tag >> 5;
  if (profile > 3) return ERR_BITSTREAM;
  if (!show) return ERR_UNSUPPORTED;
  if (!key_frame) return ERR_UNSUPPORTED;
  data += 3;
  size -= 3;
  if (size < 7) return ERR_EOF;
  if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a)
    return ERR_BITSTREAM;
  const int w = ((data[4] << 8) | data[3]) & 0x3fff;   // the scale bits
  const int h = ((data[6] << 8) | data[5]) & 0x3fff;   // are ignored
  if (w != width || h != height) return ERR_HEADER;
  data += 7;
  size -= 7;
  const int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  if (part0_len > size) return ERR_EOF;
  BoolDec br;
  br.init(data, part0_len);
  data += part0_len;
  size -= part0_len;

  br.flag();                                  // colour space
  br.flag();                                  // clamping type
  // segment header (section 9.3)
  bool use_segment = br.flag(), update_map = false, absolute_delta = true;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_probs[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.flag();
    if (br.flag()) {
      absolute_delta = br.flag();
      for (int s = 0; s < 4; ++s)
        seg_quant[s] = br.flag() ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s)
        seg_filter[s] = br.flag() ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        seg_probs[s] = uint8_t(br.flag() ? br.literal(8) : 255);
  }
  if (br.eof) return ERR_BITSTREAM;
  // filter header (section 9.6)
  const bool simple = br.flag();
  const int level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.flag();
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  if (use_lf_delta && br.flag()) {
    for (int i = 0; i < 4; ++i)
      if (br.flag()) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.flag()) mode_lf_delta[i] = br.signed_literal(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return ERR_BITSTREAM;
  // token partitions (section 9.5)
  const int nparts = 1 << br.literal(2);
  const size_t last = size_t(nparts - 1);
  if (size < 3 * last) return ERR_EOF;
  std::vector<BoolDec> parts(nparts);
  {
    const uint8_t* sz = data;
    const uint8_t* part_start = data + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(part_start, psize);
      part_start += psize;
      left -= psize;
      sz += 3;
    }
    if (left == 0) return ERR_EOF;
    parts[last].init(part_start, left);
  }
  // quantizers (section 9.6, 14.1)
  const int base_q = br.literal(7);
  const int dqy1_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.flag() ? br.signed_literal(4) : 0;
  const int dquv_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dquv_ac = br.flag() ? br.signed_literal(4) : 0;
  QuantMatrix dqm[4];
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (use_segment) {
      q = seg_quant[s];
      if (!absolute_delta) q += base_q;
    }
    QuantMatrix& m = dqm[s];
    m.y1[0] = kDcTable[clip_q(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip_q(q, 127)];
    m.y2[0] = kDcTable[clip_q(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip_q(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip_q(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip_q(q + dquv_ac, 127)];
  }
  br.flag();                                  // refresh_entropy_probs
  // coefficient probabilities (section 13.4)
  uint8_t probas[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          probas[t][b][c][p] = uint8_t(br.bit(kCoeffUpdateProbs[t][b][c][p])
                                           ? br.literal(8)
                                           : kCoeffProbs0[t][b][c][p]);
  const bool use_skip = br.flag();
  const int skip_p = use_skip ? br.literal(8) : 0;

  // filter strengths per segment and block type (libwebp
  // PrecomputeFilterStrengths)
  FInfo fstrengths[4][2];
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level = level;
      if (use_segment) {
        base_level = seg_filter[s];
        if (!absolute_delta) base_level += level;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& info = fstrengths[s][i4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lv + ilevel;
          info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4;
      }
    }
  }

  // the frame, macroblock-aligned
  const int yw = mb_w * 16, uvw = mb_w * 8;
  std::vector<uint8_t> Y(size_t(yw) * mb_h * 16), U(size_t(uvw) * mb_h * 8),
      V(size_t(uvw) * mb_h * 8);
  std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
  std::vector<MBInfo> mb_info(mb_w + 1);   // [0] is the left context
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  uint8_t intra_l[4];
  std::vector<MBData> mb_data(mb_w);
  struct TopSamples { uint8_t y[16], u[8], v[8]; };
  std::vector<TopSamples> yuv_t(mb_w);
  // libwebp's work buffer: Y 16x16 at (8, 1), U and V 8x8 at (8, 18) and
  // (24, 18), each with its left column and top row
  uint8_t work[BPS * 27];
  uint8_t* const y_dst = work + BPS * 1 + 8;
  uint8_t* const u_dst = work + BPS * 18 + 8;
  uint8_t* const v_dst = u_dst + 16;
  std::memset(work, 0, sizeof(work));

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // intra modes of the row (partition 0; section 11)
    std::memset(intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = mb_data[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      block.segment = 0;
      if (update_map)
        block.segment = uint8_t(!br.bit(seg_probs[0])
                                    ? br.bit(seg_probs[1])
                                    : br.bit(seg_probs[2]) + 2);
      block.skip = use_skip ? uint8_t(br.bit(skip_p)) : 0;
      block.is_i4x4 = !br.bit(145);
      if (!block.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                      : (br.bit(163) ? B_VE : B_DC);
        block.imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModeProbs[top[x]][ymode];
            int i = 0;
            do {
              i = kBModeTree[i + br.bit(prob[i >> 1])];
            } while (i > 0);
            ymode = -i;
            top[x] = uint8_t(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = uint8_t(ymode);
        }
      }
      block.uvmode = !br.bit(142)   ? B_DC
                     : !br.bit(114) ? B_VE
                     : br.bit(183)  ? B_TM
                                    : B_HE;
    }
    if (br.eof) return ERR_EOF;
    // tokens of the row (section 13)
    BoolDec& tbr = parts[mb_y & (nparts - 1)];
    mb_info[0].nz = mb_info[0].nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = mb_data[mb_x];
      MBInfo& left = mb_info[0];
      MBInfo& mb = mb_info[mb_x + 1];
      int skip = use_skip ? block.skip : 0;
      if (!skip) {
        skip = parse_residuals(tbr, probas, dqm[block.segment], mb, left,
                               block);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = block.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FInfo f = fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
        finfo[size_t(mb_y) * mb_w + mb_x] = f;
      }
      if (tbr.eof) return ERR_EOF;
    }
    // reconstruction (libwebp ReconstructRow)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = mb_data[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
          std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
      }
      TopSamples* top_yuv = &yuv_t[mb_x];
      const int16_t* coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv->y, 16);
        std::memcpy(u_dst - BPS, top_yuv->u, 8);
        std::memcpy(v_dst - BPS, top_yuv->v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) std::memset(top_right, top_yuv->y[15], 4);
          else std::memcpy(top_right, top_yuv[1].y, 4);
        }
        for (int r = 1; r <= 3; ++r)
          std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(block.imodes[n], dst);
          add_residual(bits >> 30, coeffs + n * 16, dst);
        }
      } else {
        predict_block(block.imodes[0], y_dst, 16, mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n, bits <<= 2)
          add_residual(bits >> 30, coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      predict_block(block.uvmode, u_dst, 8, mb_y > 0, mb_x > 0);
      predict_block(block.uvmode, v_dst, 8, mb_y > 0, mb_x > 0);
      add_residual_uv(block.non_zero_uv & 0xff, coeffs + 16 * 16, u_dst);
      add_residual_uv((block.non_zero_uv >> 8) & 0xff, coeffs + 20 * 16,
                      v_dst);
      if (mb_y < mb_h - 1) {
        std::memcpy(top_yuv->y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv->u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv->v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[size_t(mb_y * 16 + j) * yw + mb_x * 16],
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[size_t(mb_y * 8 + j) * uvw + mb_x * 8],
                    u_dst + j * BPS, 8);
        std::memcpy(&V[size_t(mb_y * 8 + j) * uvw + mb_x * 8],
                    v_dst + j * BPS, 8);
      }
    }
  }

  // loop filter, macroblocks in raster order (libwebp DoFilter)
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yp = &Y[size_t(mb_y * 16) * yw + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_edge(yp, 1, yw, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(yp + k, 1, yw, limit);
          if (mb_y > 0) simple_edge(yp, yw, 1, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4)
              simple_edge(yp + k * yw, yw, 1, limit);
        } else {
          uint8_t* up = &U[size_t(mb_y * 8) * uvw + mb_x * 8];
          uint8_t* vp = &V[size_t(mb_y * 8) * uvw + mb_x * 8];
          const int il = f.ilevel, ht = f.hev_thresh;
          if (mb_x > 0) {
            normal_edge(yp, 1, yw, 16, limit + 4, il, ht, true);
            normal_edge(up, 1, uvw, 8, limit + 4, il, ht, true);
            normal_edge(vp, 1, uvw, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(yp + k, 1, yw, 16, limit, il, ht, false);
            normal_edge(up + 4, 1, uvw, 8, limit, il, ht, false);
            normal_edge(vp + 4, 1, uvw, 8, limit, il, ht, false);
          }
          if (mb_y > 0) {
            normal_edge(yp, yw, 1, 16, limit + 4, il, ht, true);
            normal_edge(up, uvw, 1, 8, limit + 4, il, ht, true);
            normal_edge(vp, uvw, 1, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(yp + k * yw, yw, 1, 16, limit, il, ht, false);
            normal_edge(up + 4 * uvw, uvw, 1, 8, limit, il, ht, false);
            normal_edge(vp + 4 * uvw, uvw, 1, 8, limit, il, ht, false);
          }
        }
      }
    }
  }

  // RGBA with the fancy upsampler (libwebp EmitFancyRGB over the frame)
  const size_t stride = size_t(w) * 4;
  auto yrow = [&](int y) { return &Y[size_t(y) * yw]; };
  auto urow = [&](int y) { return &U[size_t(y) * uvw]; };
  auto vrow = [&](int y) { return &V[size_t(y) * uvw]; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgba,
                nullptr, w);
  for (int y = 1; y + 1 < h; y += 2) {
    const int c = (y + 1) >> 1;
    upsample_pair(yrow(y), yrow(y + 1), urow(c - 1), vrow(c - 1), urow(c),
                  vrow(c), rgba + y * stride, rgba + (y + 1) * stride, w);
  }
  if (h > 1 && !(h & 1)) {
    const int c = (h - 1) >> 1;
    upsample_pair(yrow(h - 1), nullptr, urow(c), vrow(c), urow(c), vrow(c),
                  rgba + size_t(h - 1) * stride, nullptr, w);
  }
  return OK;
}

}  // namespace

extern "C" {

// A VP8 key frame's data (the chunk's payload to the end of the frame's
// data) of `width` x `height` -> RGBA, alpha 255. 0 or a negative code.
int64_t webp_vp8_decode(const uint8_t* data, int64_t size, int32_t width,
                        int32_t height, uint8_t* rgba) {
  return decode_vp8(data, size_t(size), width, height, rgba);
}

}  // extern "C"
