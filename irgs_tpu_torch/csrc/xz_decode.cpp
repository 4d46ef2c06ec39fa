// .xz / LZMA2 for TIFF strips and tiles (compression 34925), for
// irgs_tpu_torch/utils/tiff_codecs.py: the first `need` bytes of a strip,
// as libtiff's LZMADecode has liblzma decode them in one lzma_code call
// over the whole strip and an output buffer of the strip's size. An error
// that liblzma reports once those bytes are out (a chunk that overran its
// compressed size, a range coder left unfinished, the block's check, the
// index, the footer) never fails the strip, and neither here: decoding
// stops at the strip's last byte. Before it, the stream header and block
// header (CRC32, flags, the delta and LZMA2 filters), the LZMA2 chunk
// sequence (dictionary, state and property resets) and the LZMA data
// (distances within the dictionary, the range coder's first byte) fail
// where liblzma fails. Built with g++ at first use; plain C ABI.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kErr = -1, kUnported = -2, kFormat = -3;

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// the xz variable-length integer at p (at most 9 bytes, no trailing zero
// byte) -> bytes used, or 0
int vli(const uint8_t* p, const uint8_t* end, uint64_t* v) {
  *v = 0;
  for (int i = 0; i < 9; ++i) {
    if (p + i >= end) return 0;
    *v |= static_cast<uint64_t>(p[i] & 0x7F) << (7 * i);
    if (!(p[i] & 0x80)) return (i > 0 && p[i] == 0) ? 0 : i + 1;
  }
  return 0;
}

struct Out {
  std::vector<uint8_t> buf;   // LZMA2's output (the dictionary's history)
  int64_t need;
  int64_t dict_start = 0;     // where the dictionary was last reset
  uint64_t dict_size = 0;
  bool full() const { return static_cast<int64_t>(buf.size()) >= need; }
  uint64_t fill() const { return buf.size() - dict_start; }
  // the distances a match may reach back (liblzma's dict.full)
  uint64_t reach() const { return fill() < dict_size ? fill() : dict_size; }
};

struct Rc {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  bool starved = false;
  uint8_t next() {
    if (p >= end) {
      starved = true;
      return 0;
    }
    return *p++;
  }
  void normalize() {
    if (range < (1u << 24)) {
      range <<= 8;
      code = (code << 8) | next();
    }
  }
  int bit(uint16_t* prob) {
    normalize();
    uint32_t bound = (range >> 11) * *prob;
    if (code < bound) {
      range = bound;
      *prob += (2048 - *prob) >> 5;
      return 0;
    }
    range -= bound;
    code -= bound;
    *prob -= *prob >> 5;
    return 1;
  }
  uint32_t tree(uint16_t* probs, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) m = (m << 1) | bit(probs + m);
    return m - (1u << bits);
  }
  uint32_t reverse(uint16_t* probs, int bits) {
    uint32_t m = 1, s = 0;
    for (int i = 0; i < bits; ++i) {
      int b = bit(probs + m);
      m = (m << 1) | b;
      s |= static_cast<uint32_t>(b) << i;
    }
    return s;
  }
  uint32_t direct(int bits) {
    uint32_t s = 0;
    for (int i = 0; i < bits; ++i) {
      normalize();
      range >>= 1;
      uint32_t b = code >= range;
      if (b) code -= range;
      s = (s << 1) | b;
    }
    return s;
  }
};

struct LenCoder {
  uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  void reset() {
    choice = choice2 = 1024;
    for (auto& r : low) for (auto& x : r) x = 1024;
    for (auto& r : mid) for (auto& x : r) x = 1024;
    for (auto& x : high) x = 1024;
  }
  uint32_t decode(Rc& rc, int ps) {
    if (!rc.bit(&choice)) return rc.tree(low[ps], 3);
    if (!rc.bit(&choice2)) return 8 + rc.tree(mid[ps], 3);
    return 16 + rc.tree(high, 8);
  }
};

struct Lzma {
  int lc = 0, lp = 0, pb = 0;
  int state = 0;
  uint32_t rep[4] = {0, 0, 0, 0};
  std::vector<uint16_t> literal;
  uint16_t is_match[12][16], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
      is_rep0_long[12][16], pos_slot[4][64], pos_special[115], align[16];
  LenCoder len, rep_len;
  void reset() {
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
    literal.assign(0x300u << (lc + lp), 1024);
    for (auto& r : is_match) for (auto& x : r) x = 1024;
    for (auto& r : is_rep0_long) for (auto& x : r) x = 1024;
    for (int i = 0; i < 12; ++i)
      is_rep[i] = is_rep0[i] = is_rep1[i] = is_rep2[i] = 1024;
    for (auto& r : pos_slot) for (auto& x : r) x = 1024;
    for (auto& x : pos_special) x = 1024;
    for (auto& x : align) x = 1024;
    len.reset();
    rep_len.reset();
  }
};

// one LZMA chunk of `usize` bytes from `rc` into `out`: 1 once the output
// is full, 0 at the chunk's end (rc finished), or an error
int64_t lzma_chunk(Lzma& z, Rc& rc, Out& out, uint32_t usize) {
  // rc init: five bytes, the first zero
  if (rc.next() != 0) return rc.starved ? kFormat : kErr;
  rc.range = 0xFFFFFFFFu;
  rc.code = 0;
  for (int i = 0; i < 4; ++i) rc.code = (rc.code << 8) | rc.next();
  if (rc.starved) return kFormat;
  uint64_t left = usize;
  while (left > 0) {
    uint64_t pos = out.buf.size() - out.dict_start;
    int ps = static_cast<int>(pos & ((1u << z.pb) - 1));
    int s = z.state;
    if (!rc.bit(&z.is_match[s][ps])) {
      uint8_t prev = out.fill() ? out.buf.back() : 0;
      uint16_t* probs = z.literal.data() +
                        0x300 * (((pos & ((1u << z.lp) - 1)) << z.lc) +
                                 (prev >> (8 - z.lc)));
      uint32_t sym = 1;
      if (s < 7) {
        while (sym < 0x100) sym = (sym << 1) | rc.bit(probs + sym);
      } else {
        uint32_t match = out.buf[out.buf.size() - z.rep[0] - 1];
        uint32_t offs = 0x100;
        while (sym < 0x100) {
          match <<= 1;
          uint32_t mb = match & offs;
          int b = rc.bit(probs + offs + mb + sym);
          sym = (sym << 1) | b;
          offs &= b ? mb : ~mb;
        }
      }
      z.state = s < 4 ? 0 : s < 10 ? s - 3 : s - 6;
      if (rc.starved) return kFormat;
      out.buf.push_back(static_cast<uint8_t>(sym));
      --left;
      if (out.full()) return 1;
      continue;
    }
    uint32_t length;
    if (!rc.bit(&z.is_rep[s])) {
      z.rep[3] = z.rep[2];
      z.rep[2] = z.rep[1];
      z.rep[1] = z.rep[0];
      length = z.len.decode(rc, ps);
      z.state = s < 7 ? 7 : 10;
      uint32_t lps = length < 3 ? length : 3;
      uint32_t slot = rc.tree(z.pos_slot[lps], 6);
      uint32_t dist;
      if (slot < 4) {
        dist = slot;
      } else {
        int nd = static_cast<int>(slot >> 1) - 1;
        dist = (2 | (slot & 1)) << nd;
        if (slot < 14) {
          dist += rc.reverse(z.pos_special + dist - slot - 1, nd);
        } else {
          dist += rc.direct(nd - 4) << 4;
          dist += rc.reverse(z.align, 4);
        }
      }
      z.rep[0] = dist;
      if (rc.starved) return kFormat;
      if (dist == 0xFFFFFFFFu) return kErr;   // an end marker in LZMA2
      if (dist >= out.reach()) return kErr;
    } else {
      if (out.fill() == 0) return kErr;
      if (!rc.bit(&z.is_rep0[s])) {
        if (!rc.bit(&z.is_rep0_long[s][ps])) {
          z.state = s < 7 ? 9 : 11;
          if (rc.starved) return kFormat;
          out.buf.push_back(out.buf[out.buf.size() - z.rep[0] - 1]);
          --left;
          if (out.full()) return 1;
          continue;
        }
      } else {
        uint32_t d;
        if (!rc.bit(&z.is_rep1[s])) {
          d = z.rep[1];
        } else {
          if (!rc.bit(&z.is_rep2[s])) {
            d = z.rep[2];
          } else {
            d = z.rep[3];
            z.rep[3] = z.rep[2];
          }
          z.rep[2] = z.rep[1];
        }
        z.rep[1] = z.rep[0];
        z.rep[0] = d;
      }
      length = z.rep_len.decode(rc, ps);
      z.state = s < 7 ? 8 : 11;
      if (rc.starved) return kFormat;
    }
    length += 2;
    for (uint32_t k = 0; k < length; ++k) {
      if (left == 0) return kErr;         // a match past the chunk's end
      out.buf.push_back(out.buf[out.buf.size() - z.rep[0] - 1]);
      --left;
      if (out.full()) return 1;
    }
  }
  rc.normalize();
  if (rc.code != 0) return kErr;
  return 0;
}

}  // namespace

extern "C" {

// Decode the first `need` bytes of the .xz stream src[0 .. n) into out.
// Returns `need`, or fewer where the stream ends or is cut, or kErr
// (liblzma's error), kUnported (a filter other than delta and LZMA2).
int64_t xz_decode(const uint8_t* src, int64_t n, uint8_t* out_buf,
                  int64_t need) {
  const uint8_t* end = src + n;
  static const uint8_t kMagic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (need <= 0) return 0;
  if (n < 12) return n >= 6 && memcmp(src, kMagic, 6) ? kErr : 0;
  if (memcmp(src, kMagic, 6)) return kErr;
  if (src[6] != 0 || (src[7] & 0xF0)) return kErr;
  uint32_t crc;
  memcpy(&crc, src + 8, 4);
  if (crc32(src + 6, 2) != crc) return kErr;
  const uint8_t* p = src + 12;
  if (p >= end) return 0;
  if (*p == 0) return 0;                  // the index: no block
  int64_t hsize = (static_cast<int64_t>(*p) + 1) * 4;
  if (end - p < hsize) return 0;
  memcpy(&crc, p + hsize - 4, 4);
  if (crc32(p, static_cast<size_t>(hsize - 4)) != crc) return kErr;
  const uint8_t* h = p + 1;
  const uint8_t* hend = p + hsize - 4;
  int flags = *h++;
  if (flags & 0x3C) return kErr;
  uint64_t v;
  int used;
  if (flags & 0x40) {
    if (!(used = vli(h, hend, &v)) || v == 0) return kErr;
    h += used;
  }
  if (flags & 0x80) {
    if (!(used = vli(h, hend, &v))) return kErr;
    h += used;
  }
  int nfilters = (flags & 3) + 1;
  int delta = 0;
  uint32_t dict_size = 0;
  for (int f = 0; f < nfilters; ++f) {
    uint64_t id, psize;
    if (!(used = vli(h, hend, &id))) return kErr;
    h += used;
    if (!(used = vli(h, hend, &psize))) return kErr;
    h += used;
    if (psize > static_cast<uint64_t>(hend - h)) return kErr;
    bool last = f == nfilters - 1;
    if (id == 0x21) {
      if (!last || psize != 1 || h[0] > 40) return kErr;
      dict_size = h[0] == 40 ? 0xFFFFFFFFu
                             : (2u | (h[0] & 1)) << (h[0] / 2 + 11);
    } else if (id == 0x03) {
      if (last || psize != 1 || delta) return kErr;
      delta = h[0] + 1;
    } else {
      return last ? kErr : kUnported;
    }
    h += psize;
  }
  for (; h < hend; ++h)
    if (*h) return kErr;
  p += hsize;

  Out out;
  out.need = need;
  out.dict_size = dict_size;
  Lzma z;
  bool need_dict_reset = true, need_props = true;
  Rc rc;
  rc.end = end;
  int64_t status = 0;
  for (;;) {
    if (p >= end) break;
    int control = *p++;
    if (control == 0) break;
    if (control >= 0xE0 || control == 1) {
      need_props = true;
      need_dict_reset = true;
    } else if (need_dict_reset) {
      status = kErr;
      break;
    }
    if (need_dict_reset) {
      need_dict_reset = false;
      out.dict_start = static_cast<int64_t>(out.buf.size());
    }
    if (control >= 0x80) {
      if (end - p < 4) break;
      uint32_t usize = ((control & 0x1Fu) << 16) + (p[0] << 8) + p[1] + 1;
      uint32_t csize = (p[2] << 8) + p[3] + 1;
      p += 4;
      if (control >= 0xC0) {
        need_props = false;
        if (p >= end) break;
        int d = *p++;
        if (d > (4 * 5 + 4) * 9 + 8) {
          status = kErr;
          break;
        }
        z.pb = d / 45;
        z.lp = (d % 45) / 9;
        z.lc = d % 9;
        if (z.lc + z.lp > 4) {
          status = kErr;
          break;
        }
        z.reset();
      } else if (need_props) {
        status = kErr;
        break;
      } else if (control >= 0xA0) {
        z.reset();
      }
      rc.p = p;
      rc.starved = false;
      int64_t r = lzma_chunk(z, rc, out, usize);
      if (r == 1) break;
      if (r == kFormat) break;            // the data is cut
      if (r < 0) {
        status = r;
        break;
      }
      int64_t in_used = rc.p - p;
      if (in_used != static_cast<int64_t>(csize)) {
        status = kErr;
        break;
      }
      p = rc.p;
    } else {
      if (control > 2) {
        status = kErr;
        break;
      }
      if (end - p < 2) break;
      uint32_t size = (p[0] << 8) + p[1] + 1;
      p += 2;
      uint32_t k = 0;
      for (; k < size && p < end && !out.full(); ++k) out.buf.push_back(*p++);
      if (out.full() || k < size) break;
    }
  }
  if (!out.full() && status < 0) return status;
  int64_t got = static_cast<int64_t>(out.buf.size());
  if (got > need) got = need;
  if (delta) {
    uint8_t hist[256] = {0};
    uint8_t pos = 0;
    for (int64_t i = 0; i < got; ++i) {
      uint8_t b = static_cast<uint8_t>(out.buf[i] + hist[(pos - delta) & 0xFF]);
      hist[pos++] = b;
      out.buf[i] = b;
    }
  }
  if (got > 0) memcpy(out_buf, out.buf.data(), static_cast<size_t>(got));
  return got;
}

}  // extern "C"
