// Host decoders of the TIFF and GIF readers (irgs_tpu_torch/utils/tiff.py,
// utils/gif.py), each as the library that PIL hands the stream to decodes
// it:
//   tiff_lzw_decode   libtiff's LZWDecode (tif_lzw.c): codes MSB-first,
//                     9 to 12 bits, widened one code early (after entry
//                     2^n - 2), CLEAR 256, EOI 257, the table grown to
//                     4096 + 1024 entries before it must be cleared; the
//                     first code after CLEAR must be a literal; a stream
//                     that ends (EOI or no more bits) before `need` bytes
//                     is refused, bytes past `need` are ignored;
//   tiff_lzw_compat_decode  libtiff's LZWDecodeCompat, old-style LZW;
//   packbits_decode   libtiff's PackBitsDecode (tif_packbits.c): a run
//                     past `need` is cut, a stream short of `need` is
//                     refused;
//   gif_lzw_decode    Pillow's GifDecode.c: codes LSB-first from
//                     `bits` + 1 up to 12 bits, widened when the next free
//                     entry reaches 2^n, no CLEAR needed first, the table
//                     frozen (deferred clear) at 4096 entries.
// Built with g++ at first use; plain C ABI.

#include <cstdint>
#include <vector>

namespace {

const int TIFF_CLEAR = 256, TIFF_EOI = 257, TIFF_FIRST = 258;
const int TIFF_CSIZE = 4096 + 1024;

struct Entry {
  int32_t next;      // previous code of the string, -1 for a literal
  int32_t length;    // 0: not defined
  uint8_t value;     // last byte of the string
  uint8_t first;     // first byte of the string
};

}  // namespace

extern "C" {

// Returns `need` on success; -1: corrupt table or code, -2: not enough
// data, -3: an old-style (LSB-first) stream, which libtiff decodes with
// another decoder.
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t need) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -3;
  std::vector<Entry> tab(TIFF_CSIZE);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  for (int i = 256; i < TIFF_CSIZE; ++i) tab[i] = {-1, 0, 0, 0};
  int nbits = 9;
  int64_t free_ent = TIFF_FIRST, maxcode = (1 << nbits) - 2;
  int64_t old = -1;  // no previous code: the next must follow a CLEAR
  uint64_t bitbuf = 0;
  int bitcount = 0;
  int64_t pos = 0, out = 0;
  auto next_code = [&]() -> int {
    while (bitcount < nbits) {
      if (pos >= n) return TIFF_EOI;      // not terminated with EOI
      bitbuf = (bitbuf << 8) | src[pos++];
      bitcount += 8;
    }
    bitcount -= nbits;
    return int((bitbuf >> bitcount) & ((1u << nbits) - 1));
  };
  auto reset = [&]() {
    for (int i = TIFF_FIRST; i < TIFF_CSIZE; ++i) tab[i] = {-1, 0, 0, 0};
    free_ent = TIFF_FIRST;
    nbits = 9;
    maxcode = (1 << nbits) - 2;
  };
  std::vector<uint8_t> str;
  while (out < need) {
    int code = next_code();
    if (code == TIFF_EOI) break;
    if (code == TIFF_CLEAR) {
      do {
        reset();
        code = next_code();
      } while (code == TIFF_CLEAR);
      if (code == TIFF_EOI) break;
      if (code > TIFF_CLEAR) return -1;
      dst[out++] = uint8_t(code);
      old = code;
      continue;
    }
    // add the entry old + first byte of code's string
    if (old < 0 || free_ent < 0 || free_ent >= TIFF_CSIZE) return -1;
    Entry& e = tab[free_ent];
    e.next = int32_t(old);
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 2;
      if (free_ent >= TIFF_CSIZE) free_ent = -1;  // only CLEAR or EOI now
    }
    old = code;
    const Entry& c = tab[code];
    if (c.length == 0) return -1;
    int64_t len = c.length;
    str.resize(len);
    int64_t k = len;
    for (int64_t i = code; i >= 0; i = tab[i].next) str[--k] = tab[i].value;
    int64_t take = len < need - out ? len : need - out;
    for (int64_t i = 0; i < take; ++i) dst[out + i] = str[i];
    out += take;
  }
  return out < need ? -2 : need;
}

// libtiff's LZWDecodeCompat, for old-style streams (the first byte 0, the
// second's low bit set): codes LSB-first, 9 to 12 bits widened one code
// late (after entry 2^n - 1; before the first CLEAR, after entry 510), no
// KwKwK shortcut past the next free entry (such a code has no string),
// the first code a CLEAR. Returns `need` on success; -1: corrupt table or
// code, -2: not enough data.
int64_t tiff_lzw_compat_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t need) {
  std::vector<Entry> tab(TIFF_CSIZE);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  for (int i = 256; i < TIFF_CSIZE; ++i) tab[i] = {-1, 0, 0, 0};
  int nbits = 9;
  int64_t nbitsmask = (1 << nbits) - 1;
  int64_t free_ent = TIFF_FIRST, maxcode = nbitsmask - 1;
  int64_t old = -1;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int64_t pos = 0, out = 0;
  uint64_t bitsleft = uint64_t(n) * 8;
  auto next_code = [&]() -> int {
    nextdata |= uint64_t(pos < n ? src[pos] : 0) << nextbits;
    ++pos;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= uint64_t(pos < n ? src[pos] : 0) << nextbits;
      ++pos;
      nextbits += 8;
    }
    int code = int(nextdata & uint64_t(nbitsmask));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  std::vector<uint8_t> str;
  while (out < need) {
    if (bitsleft < uint64_t(nbits)) break;   // not terminated with EOI
    int code = next_code();
    if (code == TIFF_EOI) break;
    if (code == TIFF_CLEAR) {
      bool ended = false;
      do {
        for (int i = TIFF_FIRST; i < TIFF_CSIZE; ++i) tab[i] = {-1, 0, 0, 0};
        free_ent = TIFF_FIRST;
        nbits = 9;
        nbitsmask = (1 << nbits) - 1;
        maxcode = nbitsmask;
        if (bitsleft < uint64_t(nbits)) {
          ended = true;
          break;
        }
        code = next_code();
      } while (code == TIFF_CLEAR);
      if (ended || code == TIFF_EOI) break;
      if (code > TIFF_CLEAR) return -1;
      dst[out++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= TIFF_CSIZE) return -1;
    Entry& e = tab[free_ent];
    e.next = int32_t(old);
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask;
    }
    old = code;
    if (code >= 256) {
      const Entry& c = tab[code];
      if (c.length == 0) return -1;
      int64_t len = c.length;
      str.resize(len);
      int64_t k = len;
      for (int64_t i = code; i >= 0 && k > 0; i = tab[i].next)
        str[--k] = tab[i].value;
      int64_t take = len < need - out ? len : need - out;
      for (int64_t i = 0; i < take; ++i) dst[out + i] = str[i];
      out += take;
    } else {
      dst[out++] = uint8_t(code);
    }
  }
  return out < need ? -2 : need;
}

// Returns `need` on success, -2 when the data ends first.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t need) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < need) {
    int64_t c = src[pos++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = -c + 1;
      if (run > need - out) run = need - out;
      if (pos >= n) break;
      uint8_t b = src[pos++];
      for (int64_t i = 0; i < run; ++i) dst[out++] = b;
    } else {
      int64_t run = c + 1;
      if (run > need - out) run = need - out;
      if (n - pos < run) break;
      for (int64_t i = 0; i < run; ++i) dst[out++] = src[pos + i];
      pos += run;
    }
  }
  return out < need ? -2 : need;
}

// Decodes a GIF image's LZW stream (its sub-blocks concatenated) into
// `need` pixels in stream order. Returns the pixels written; *status is
// 0 when all were, 1 when the END code came first, 2 when the data ran
// out first, -1 for a broken code (Pillow's IMAGING_CODEC_BROKEN).
int64_t gif_lzw_decode(const uint8_t* src, int64_t n, int bits,
                       uint8_t* dst, int64_t need, int* status) {
  const int GIFTABLE = 4096;
  std::vector<uint8_t> data(GIFTABLE);
  std::vector<int32_t> link(GIFTABLE);
  std::vector<uint8_t> buf(GIFTABLE);
  const int clear = 1 << bits, end = clear + 1;
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2;  // 2: the next code is the first after a clear
  int lastcode = 0;
  uint8_t lastdata = 0;
  uint64_t bitbuf = 0;
  int bitcount = 0;
  int64_t pos = 0, out = 0;
  *status = 0;
  while (out < need) {
    while (bitcount < codesize) {
      if (pos >= n) {
        *status = 2;
        return out;
      }
      bitbuf |= uint64_t(src[pos++]) << bitcount;
      bitcount += 8;
    }
    int c = int(bitbuf & codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) {
      *status = 1;
      return out;
    }
    int len;
    const uint8_t* p;
    if (state == 2) {
      if (c > clear) {
        *status = -1;
        return out;
      }
      lastdata = uint8_t(c);
      lastcode = c;
      state = 3;
      buf[GIFTABLE - 1] = lastdata;
      p = &buf[GIFTABLE - 1];
      len = 1;
    } else {
      int thiscode = c;
      int idx = GIFTABLE;
      if (c > next) {
        *status = -1;
        return out;
      }
      if (c == next) {
        buf[--idx] = lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (idx <= 0 || c >= GIFTABLE) {
          *status = -1;
          return out;
        }
        buf[--idx] = data[c];
        c = link[c];
      }
      lastdata = uint8_t(c);
      buf[--idx] = lastdata;
      if (next < GIFTABLE) {
        data[next] = uint8_t(c);
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      p = &buf[idx];
      len = GIFTABLE - idx;
    }
    int64_t take = len < need - out ? len : need - out;
    for (int64_t i = 0; i < take; ++i) dst[out + i] = p[i];
    out += take;
  }
  return out;
}

}  // extern "C"
