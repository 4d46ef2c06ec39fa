// Zstandard (RFC 8878) for TIFF strips and tiles (compression 50000), for
// irgs_tpu_torch/utils/tiff_codecs.py: one frame decoded as libtiff's
// ZSTDDecode has libzstd's ZSTD_decompressStream decode it into a buffer
// of the strip's size. Covered: the frame header (window, content size,
// checksum flag; a dictionary id is refused), raw, RLE and compressed
// blocks, raw, RLE, Huffman (1 and 4 streams, direct or FSE-coded weights)
// and treeless literals, FSE sequence tables in predefined, RLE,
// compressed and repeat modes, repeat offsets, the content checksum
// (XXH64), and skippable frames. Damaged frames fail where libzstd's
// checks fail (table descriptions, bitstreams that do not end exactly,
// offsets past the window, block and literal sizes), and streaming is
// kept: once the strip's bytes are out, the next block is still decoded
// (and checked) if it is all there, and nothing after it. Built with g++
// at first use; plain C ABI.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kErr = -1, kDict = -2, kWindow = -3, kMagic = -4;
constexpr int64_t kBlockMax = 128 * 1024;

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---- XXH64 ---------------------------------------------------------------
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t round1(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  return (acc ^ round1(0, v)) * P1 + P4;
}
uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, rd64(p));
      v2 = round1(v2, rd64(p + 8));
      v3 = round1(v3, rd64(p + 16));
      v4 = round1(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round1(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bitstreams ----------------------------------------------------------

// Backward bitstream (Huffman streams, FSE weights, sequences): read from
// the last bit down, after the final byte's padding; bits before the
// stream's start read as zero. `pos` counts the bits left; negative once
// the stream is overread.
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t pos = 0;
  bool init(const uint8_t* src, int64_t n) {
    if (n < 1 || src[n - 1] == 0) return false;
    p = src;
    pos = n * 8 - (8 - highbit(src[n - 1]));
    return true;
  }
  int bit(int64_t i) const {
    return i < 0 ? 0 : (p[i >> 3] >> (i & 7)) & 1;
  }
  uint32_t peek(int n) const {
    uint32_t v = 0;
    for (int k = 1; k <= n; ++k) v = (v << 1) | bit(pos - k);
    return v;
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    pos -= n;
    return v;
  }
  bool exact_end() const { return pos == 0; }
  bool overflow() const { return pos < 0; }
};

// ---- FSE -----------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_readNCount: the normalised counts at src -> bytes used, or -1
int64_t read_ncount(const uint8_t* src, int64_t n, int max_symbol,
                    int max_log, std::vector<int16_t>& norm, int* log_out) {
  auto bits = [&](int64_t pos, int k) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t q = pos + i;
      int b = (q >> 3) < n ? (src[q >> 3] >> (q & 7)) & 1 : 0;
      v |= static_cast<uint32_t>(b) << i;
    }
    return v;
  };
  int64_t pos = 0;
  int log = static_cast<int>(bits(0, 4)) + 5;
  pos = 4;
  if (log > 15 || log > max_log) return -1;
  *log_out = log;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  norm.assign(max_symbol + 1, 0);
  for (;;) {
    if (prev0) {
      for (;;) {
        uint32_t r = bits(pos, 2);
        pos += 2;
        sym += static_cast<int>(r);
        if (r != 3) break;
      }
      if (sym > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = bits(pos, nbits - 1);
    if (static_cast<int>(low) < max) {
      count = static_cast<int>(low);
      pos += nbits - 1;
    } else {
      count = static_cast<int>(bits(pos, nbits));
      if (count >= threshold) count -= max;
      pos += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = static_cast<int16_t>(count);
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(static_cast<uint32_t>(remaining)) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (sym > max_symbol) break;
  }
  if (remaining != 1 || sym > max_symbol + 1) return -1;
  int64_t used = (pos + 7) >> 3;
  if (used > n) return -1;
  return used;
}

bool build_fse(const std::vector<int16_t>& norm, int log, Fse* f) {
  int size = 1 << log;
  f->log = log;
  f->t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      f->t[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s] > 0 ? norm[s] : 0;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); ++s)
    for (int i = 0; i < norm[s]; ++i) {
      f->t[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[f->t[u].symbol]++;
    int nb = log - highbit(x);
    f->t[u].nbits = static_cast<uint8_t>(nb);
    f->t[u].base = static_cast<uint16_t>((x << nb) - size);
  }
  return true;
}

void rle_fse(int symbol, Fse* f) {
  f->log = 0;
  f->t.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
}

// ---- Huffman -------------------------------------------------------------

struct Huf {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  bool ok = false;
};

// HUF_readStats + the decoding table -> bytes used, or -1
int64_t read_huffman(const uint8_t* src, int64_t n, Huf* h) {
  if (n < 1) return -1;
  int head = src[0];
  std::vector<uint8_t> w;
  int64_t used;
  if (head >= 128) {
    int count = head - 127;
    int64_t bytes = (count + 1) / 2;
    if (bytes + 1 > n || count >= 255) return -1;
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    used = 1 + bytes;
  } else {
    if (head + 1 > n) return -1;
    std::vector<int16_t> norm;
    int log;
    int64_t hs = read_ncount(src + 1, head, 255, 6, norm, &log);
    if (hs < 0) return -1;
    Fse f;
    if (!build_fse(norm, log, &f)) return -1;
    BackBits b;
    if (!b.init(src + 1 + hs, head - hs)) return -1;
    uint32_t s1 = b.read(log), s2 = b.read(log);
    for (;;) {
      if (w.size() > 253) return -1;
      w.push_back(static_cast<uint8_t>(f.t[s1].symbol));
      s1 = f.t[s1].base + b.read(f.t[s1].nbits);
      if (b.overflow()) {
        w.push_back(static_cast<uint8_t>(f.t[s2].symbol));
        break;
      }
      if (w.size() > 253) return -1;
      w.push_back(static_cast<uint8_t>(f.t[s2].symbol));
      s2 = f.t[s2].base + b.read(f.t[s2].nbits);
      if (b.overflow()) {
        w.push_back(static_cast<uint8_t>(f.t[s1].symbol));
        break;
      }
    }
    used = 1 + head;
  }
  uint32_t total = 0;
  int rank[17] = {0};
  for (uint8_t x : w) {
    if (x > 12) return -1;
    ++rank[x];
    if (x) total += (1u << x) >> 1;
  }
  if (total == 0) return -1;
  int log = highbit(total) + 1;
  if (log > 12) return -1;
  uint32_t rest = (1u << log) - total;
  if ((1u << highbit(rest)) != rest) return -1;
  uint8_t last = static_cast<uint8_t>(highbit(rest) + 1);
  w.push_back(last);
  ++rank[last];
  if (rank[1] < 2 || (rank[1] & 1)) return -1;
  h->log = log;
  h->sym.assign(1 << log, 0);
  h->nbits.assign(1 << log, 0);
  uint32_t start[14] = {0};
  uint32_t next = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = next;
    next += static_cast<uint32_t>(rank[k]) << (k - 1);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    int k = w[s];
    if (!k) continue;
    uint32_t len = (1u << k) >> 1;
    for (uint32_t i = 0; i < len; ++i) {
      h->sym[start[k] + i] = static_cast<uint8_t>(s);
      h->nbits[start[k] + i] = static_cast<uint8_t>(log + 1 - k);
    }
    start[k] += len;
  }
  h->ok = true;
  return used;
}

bool huf_stream(const Huf& h, const uint8_t* src, int64_t n, uint8_t* out,
                int64_t count) {
  BackBits b;
  if (!b.init(src, n)) return false;
  for (int64_t i = 0; i < count; ++i) {
    uint32_t v = b.peek(h.log);
    out[i] = h.sym[v];
    b.pos -= h.nbits[v];
  }
  return b.exact_end();
}

// Four Huffman streams as libzstd's fast 4-stream decoder (a table of at
// most 11 bits) has them: no padding marker is required; the streams are
// decoded in lockstep, five symbols each per round, while the last
// stream has five left and the first stream's reader is seven bytes or
// more above the section's start (a round in which a reader has crossed
// the one before it ends the loop early); a reader that then lies more
// than 8 bytes below its stream's start fails the block; the rest of each
// stream is read on into the bytes before it, down to the section's start,
// where the reader's last 64-bit word is shifted on (zeros, then its own
// bits again); the streams' ends are not checked.
bool huf_4streams_fast(const Huf& h, const uint8_t* sec, const int64_t* start,
                       const int64_t* end, uint8_t* out, int64_t seg,
                       int64_t total) {
  uint64_t word = 0;
  memcpy(&word, sec, 8);
  int64_t pos[4], ip[4], done[4] = {0, 0, 0, 0}, count[4];
  for (int s = 0; s < 4; ++s) {
    uint8_t last = sec[end[s] - 1];
    pos[s] = end[s] * 8 - (last ? 8 - highbit(last) : 0);
    ip[s] = end[s] - 8;
    count[s] = s < 3 ? seg : total - 3 * seg;
  }
  auto symbol = [&](int s) {
    uint32_t v;
    if (pos[s] >= h.log) {
      v = 0;
      for (int k = 1; k <= h.log; ++k) {
        int64_t q = pos[s] - k;
        v = (v << 1) | ((sec[q >> 3] >> (q & 7)) & 1);
      }
    } else {
      uint64_t sh = static_cast<uint64_t>(64 - pos[s]) & 63;
      v = static_cast<uint32_t>((word << sh) >> (64 - h.log));
    }
    out[s * seg + done[s]++] = h.sym[v];
    pos[s] -= h.nbits[v];
  };
  for (;;) {
    int64_t iters = (count[3] - done[3]) / 5;
    if (ip[0] / 7 < iters) iters = ip[0] / 7;
    if (iters <= 0) break;
    if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    for (int64_t it = 0; it < iters; ++it)
      for (int s = 0; s < 4; ++s) {
        for (int k = 0; k < 5; ++k) symbol(s);
        int64_t d = pos[s] - 64;       // reload: ceil((pos - 64) / 8)
        ip[s] = d >= 0 ? (d + 7) / 8 : -((-d) / 8);
      }
  }
  for (int s = 0; s < 4; ++s) {
    if (ip[s] < start[s] - 8) return false;
    while (done[s] < count[s]) symbol(s);
  }
  return true;
}

// ---- sequences -----------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,
                              10, 11, 12, 13, 14, 15,  16,  18,  20,   22,
                              24, 28, 32, 40, 48, 64,  128, 256, 512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

uint32_t ml_base(int code) {
  if (code < 32) return code + 3;
  static const uint32_t b[21] = {35,  37,   39,   41,   43,    47,    51,
                                 59,  67,   83,   99,   131,   259,   515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539};
  return b[code - 32];
}

struct Frame {
  std::vector<uint8_t> out;
  uint64_t window = 0;
  int64_t block_max = 0;
  Huf huf;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// one sequence table: mode 0 predefined, 1 RLE, 2 compressed, 3 repeat;
// -> bytes used, or -1
int64_t seq_table(int mode, const uint8_t* src, int64_t n, int max_symbol,
                  int max_log, const int16_t* def, int def_n, int def_log,
                  Fse* f, bool* have) {
  if (mode == 0) {
    std::vector<int16_t> norm(def, def + def_n);
    build_fse(norm, def_log, f);
    *have = true;
    return 0;
  }
  if (mode == 1) {
    if (n < 1 || src[0] > max_symbol) return -1;
    rle_fse(src[0], f);
    *have = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int16_t> norm;
    int log;
    int64_t used = read_ncount(src, n, max_symbol, max_log, norm, &log);
    if (used < 0 || !build_fse(norm, log, f)) return -1;
    *have = true;
    return used;
  }
  return *have ? 0 : -1;
}

// a compressed block -> false where libzstd reports an error
bool compressed_block(Frame& fr, const uint8_t* src, int64_t n) {
  if (n < 2) return false;
  // literals
  int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  int64_t lit_size = 0, lh = 0, lit_csize = 0;
  std::vector<uint8_t> lits;
  if (type == 0 || type == 1) {
    if (sf == 0 || sf == 2) {
      lh = 1;
      lit_size = src[0] >> 3;
    } else if (sf == 1) {
      lh = 2;
      lit_size = (src[0] >> 4) + (static_cast<int64_t>(src[1]) << 4);
    } else {
      if (n < 3) return false;
      lh = 3;
      lit_size = (src[0] >> 4) + (static_cast<int64_t>(src[1]) << 4) +
                 (static_cast<int64_t>(src[2]) << 12);
    }
    if (lit_size > fr.block_max) return false;
    if (type == 0) {
      if (lh + lit_size > n) return false;
      lits.assign(src + lh, src + lh + lit_size);
      lh += lit_size;
    } else {
      if (lh + 1 > n || (lh == 3 && n < 4)) return false;
      lits.assign(lit_size, src[lh]);
      lh += 1;
    }
  } else {
    if (n < 5) return false;
    int streams = sf == 0 ? 1 : 4;
    uint32_t h3 = src[0] | (src[1] << 8) | (src[2] << 16);
    if (sf <= 1) {
      lh = 3;
      lit_size = (h3 >> 4) & 0x3FF;
      lit_csize = (h3 >> 14) & 0x3FF;
    } else if (sf == 2) {
      uint32_t h4 = h3 | (static_cast<uint32_t>(src[3]) << 24);
      lh = 4;
      lit_size = (h4 >> 4) & 0x3FFF;
      lit_csize = h4 >> 18;
    } else {
      uint64_t h5 = h3 | (static_cast<uint64_t>(src[3]) << 24) |
                    (static_cast<uint64_t>(src[4]) << 32);
      lh = 5;
      lit_size = (h5 >> 4) & 0x3FFFF;
      lit_csize = (h5 >> 22) & 0x3FFFF;
    }
    if (lit_size > fr.block_max) return false;
    if (lit_csize + lh > n) return false;
    if (streams == 4 && lit_size < 6) return false;
    const uint8_t* p = src + lh;
    int64_t left = lit_csize;
    if (type == 2) {
      int64_t hs = read_huffman(p, left, &fr.huf);
      if (hs < 0) {
        fr.huf.ok = false;
        return false;
      }
      p += hs;
      left -= hs;
    } else if (!fr.huf.ok) {
      return false;
    }
    lits.assign(lit_size, 0);
    if (streams == 1) {
      if (!huf_stream(fr.huf, p, left, lits.data(), lit_size)) return false;
    } else {
      if (left < 10) return false;
      int64_t l1 = p[0] | (p[1] << 8), l2 = p[2] | (p[3] << 8),
              l3 = p[4] | (p[5] << 8);
      int64_t l4 = left - 6 - l1 - l2 - l3;
      if (l4 < 0 || l4 > left) return false;
      int64_t seg = (lit_size + 3) / 4;
      if (3 * seg > lit_size) return false;
      const uint8_t* q = p + 6;
      int64_t lens[4] = {l1, l2, l3, l4};
      // libzstd's fast loop takes a table of at most 11 bits, streams of 8
      // bytes or more and a last segment that is not empty
      bool fast = fr.huf.log <= 11 && l1 >= 8 && l2 >= 8 && l3 >= 8 &&
                  l4 >= 8 && 3 * seg < lit_size;
      if (fast) {
        int64_t start[4], stop[4];
        for (int s = 0; s < 4; ++s) {
          start[s] = q - p;
          stop[s] = start[s] + lens[s];
          q += lens[s];
        }
        if (!huf_4streams_fast(fr.huf, p, start, stop, lits.data(), seg,
                               lit_size))
          return false;
      } else {
        for (int s = 0; s < 4; ++s) {
          int64_t cnt = s < 3 ? seg : lit_size - 3 * seg;
          if (!huf_stream(fr.huf, q, lens[s], lits.data() + s * seg, cnt))
            return false;
          q += lens[s];
        }
      }
    }
    lh += lit_csize;
  }
  // sequences header
  const uint8_t* p = src + lh;
  const uint8_t* end = src + n;
  if (p >= end) return false;
  int64_t nseq = *p++;
  if (nseq == 0) {
    if (p != end) return false;
  } else if (nseq < 128) {
  } else if (nseq < 255) {
    if (p >= end) return false;
    nseq = ((nseq - 128) << 8) + *p++;
  } else {
    if (p + 2 > end) return false;
    nseq = p[0] + (p[1] << 8) + 0x7F00;
    p += 2;
  }
  const int64_t start = static_cast<int64_t>(fr.out.size());
  if (nseq == 0) {
    if (static_cast<int64_t>(lits.size()) > fr.block_max) return false;
    fr.out.insert(fr.out.end(), lits.begin(), lits.end());
    return true;
  }
  if (p + 1 > end) return false;
  int modes = *p++;
  if (modes & 3) return false;
  int64_t u = seq_table(modes >> 6, p, end - p, 35, 9, kLLDefault, 36, 6,
                        &fr.ll, &fr.have_ll);
  if (u < 0) return false;
  p += u;
  u = seq_table((modes >> 4) & 3, p, end - p, 31, 8, kOFDefault, 29, 5,
                &fr.of, &fr.have_of);
  if (u < 0) return false;
  p += u;
  u = seq_table((modes >> 2) & 3, p, end - p, 52, 9, kMLDefault, 53, 6,
                &fr.ml, &fr.have_ml);
  if (u < 0) return false;
  p += u;
  BackBits b;
  if (!b.init(p, end - p)) return false;
  uint32_t sll = b.read(fr.ll.log), sof = b.read(fr.of.log),
           sml = b.read(fr.ml.log);
  size_t lit_at = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    int ofc = fr.of.t[sof].symbol, llc = fr.ll.t[sll].symbol,
        mlc = fr.ml.t[sml].symbol;
    if (llc > 35 || mlc > 52 || ofc > 31) return false;
    uint64_t ofv = (1ULL << ofc) + b.read(ofc);
    uint64_t ml = ml_base(mlc) + b.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      fr.rep[2] = fr.rep[1];
      fr.rep[1] = fr.rep[0];
      fr.rep[0] = off;
    } else {
      int idx = static_cast<int>(ofv) - (ll == 0 ? 0 : 1);
      if (idx == 0) {
        off = fr.rep[0];
      } else {
        off = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
        if (off == 0) off = static_cast<uint64_t>(-1);
        if (idx != 1) fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = fr.ll.t[sll].base + b.read(fr.ll.t[sll].nbits);
      sml = fr.ml.t[sml].base + b.read(fr.ml.t[sml].nbits);
      sof = fr.of.t[sof].base + b.read(fr.of.t[sof].nbits);
    }
    if (ll > lits.size() - lit_at) return false;
    fr.out.insert(fr.out.end(), lits.begin() + lit_at,
                  lits.begin() + lit_at + ll);
    lit_at += ll;
    int64_t have = static_cast<int64_t>(fr.out.size());
    if (off > static_cast<uint64_t>(have) || off > fr.window) return false;
    if (have - start + static_cast<int64_t>(ml) > fr.block_max) return false;
    size_t from = fr.out.size() - off;
    for (uint64_t k = 0; k < ml; ++k) fr.out.push_back(fr.out[from + k]);
  }
  if (!b.exact_end()) return false;
  fr.out.insert(fr.out.end(), lits.begin() + lit_at, lits.end());
  return static_cast<int64_t>(fr.out.size()) - start <= fr.block_max;
}

}  // namespace

extern "C" {

// Decode one Zstandard frame into out[0 .. need). Returns the bytes
// written (less than `need` where the frame ends early or its data is
// cut), or kErr/kDict/kWindow/kMagic where libzstd reports an error.
int64_t zstd_decode(const uint8_t* src, int64_t n, uint8_t* out,
                    int64_t need) {
  if (n < 4) return 0;
  uint32_t magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return 0;  // skippable: no data
  if (magic != 0xFD2FB528u) return kMagic;
  if (n < 5) return 0;
  int fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) return kErr;
  static const int kDidSize[4] = {0, 1, 2, 4};
  int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
  int64_t hsize = 5 + !single + kDidSize[did_flag] + fcs_size;
  if (n < hsize) return 0;
  const uint8_t* p = src + 5;
  uint64_t window = 0;
  if (!single) {
    int exp = *p >> 3, mant = *p & 7;
    uint64_t base = 1ULL << (10 + exp);
    window = base + (base / 8) * mant;
    ++p;
  }
  uint32_t did = 0;
  for (int i = 0; i < kDidSize[did_flag]; ++i) did |= p[i] << (8 * i);
  p += kDidSize[did_flag];
  int64_t fcs = -1;
  if (fcs_size) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
    if (fcs_size == 2) v += 256;
    fcs = static_cast<int64_t>(v);
    p += fcs_size;
  }
  if (single) window = static_cast<uint64_t>(fcs);
  if (did) return kDict;
  if (window < 1024) window = 1024;
  if (window > (1ULL << 27)) return kWindow;

  Frame fr;
  fr.window = window;
  fr.block_max = static_cast<int64_t>(window < kBlockMax ? window : kBlockMax);
  const uint8_t* end = src + n;

  // libzstd decodes a frame whose size it knows, and that fits the output
  // and the input, in one call, checks included
  bool whole = false;
  if (fcs >= 0 && fcs <= need) {
    const uint8_t* q = p;
    bool ok = true;
    for (;;) {
      if (end - q < 3) {
        ok = false;
        break;
      }
      uint32_t bh = q[0] | (q[1] << 8) | (q[2] << 16);
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 3) {
        ok = false;
        break;
      }
      q += 3 + (type == 1 ? 1 : size);
      if (q > end) {
        ok = false;
        break;
      }
      if (bh & 1) break;
    }
    if (ok && checksum) ok = end - q >= 4;
    whole = ok;
  }

  bool full_exact = false;   // the output filled at a block's end
  bool one_more = false;     // the block decoded after the output filled
  for (;;) {
    if (end - p < 3) break;
    uint32_t bh = p[0] | (p[1] << 8) | (p[2] << 16);
    int last = bh & 1, type = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    if (type == 3) return kErr;
    if (size > fr.block_max) return kErr;
    int64_t csize = type == 1 ? 1 : size;
    if (end - p - 3 < csize) break;          // the rest of the block is cut
    const uint8_t* body = p + 3;
    p = body + csize;
    if (type == 0) {
      fr.out.insert(fr.out.end(), body, body + size);
    } else if (type == 1) {
      fr.out.insert(fr.out.end(), size, body[0]);
    } else if (!compressed_block(fr, body, csize)) {
      return kErr;
    }
    int64_t got = static_cast<int64_t>(fr.out.size());
    if (fcs >= 0 && got > fcs) return kErr;
    if (last) {
      if (fcs >= 0 && got != fcs) return kErr;
      if (checksum && (whole || got <= need) && end - p >= 4) {
        uint32_t want = rd32(p);
        if (static_cast<uint32_t>(xxh64(fr.out.data(), fr.out.size())) != want)
          return kErr;
      }
      break;
    }
    if (whole) continue;
    if (one_more) break;
    if (got > need) break;
    if (got == need) {
      full_exact = true;
      one_more = true;
    }
  }
  (void)full_exact;
  int64_t got = static_cast<int64_t>(fr.out.size());
  int64_t k = got < need ? got : need;
  if (k > 0) memcpy(out, fr.out.data(), static_cast<size_t>(k));
  return k;
}

}  // extern "C"
