// JPEG 2000 (ISO 15444-1) tile decoder, bit for bit as OpenJPEG 2.5 decodes
// a tile: tier 2 (packet headers with their tag trees, the five progression
// orders with POC changes), tier 1 (EBCOT's MQ and raw passes with every
// code-block style bit, ROI max-shift), the reconstruction of code-blocks
// cut short (OpenJPEG's half-step), dequantization, the inverse 5/3 and
// float32 9/7 wavelets in OpenJPEG's operation order, the inverse RCT/ICT
// and the DC level shift with its clamp.
//
// The Python side (utils/j2k.py) parses the marker segments and hands one
// tile at a time: its coding parameters as an int32 array, its data (the
// tile-parts' bodies concatenated) and, with PPM/PPT, its packet headers.
// Build: g++ -O3 -std=c++17 -ffp-contract=off (no -ffast-math: the 9/7 path
// rounds every float32 operation as OpenJPEG does).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- helpers
inline int32_t ceildiv(int32_t a, int32_t b) {
  return (int32_t)(((int64_t)a + b - 1) / b);
}
inline uint32_t uceildiv(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline int32_t ceildivpow2(int64_t a, int b) {
  return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }
inline uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) { a >>= 1; ++l; }
  return l;
}

enum { E_BROKEN = -1, E_BITNUMBER = -2, E_SEGLONG = -3, E_BPNO = -4,
       E_PI = -5, E_MCT = -6, E_SIZE = -7, E_MARKER = -8 };

// ---------------------------------------------------------------- bio
struct Bio {
  const uint8_t *start, *end, *bp;
  uint32_t buf, ct;
  void init(const uint8_t* p, uint32_t len) {
    start = bp = p; end = p + len; buf = 0; ct = 0;
  }
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t getbit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= getbit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  uint32_t numbytes() const { return (uint32_t)(bp - start); }
};

// ---------------------------------------------------------------- tag tree
struct TagTree {
  struct Node { int parent; int32_t value, low; };
  std::vector<Node> nodes;
  void create(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    int32_t nplh[32], nplv[32];
    uint32_t numlvls = 0, numnodes = 0;
    nplh[0] = (int32_t)w; nplv[0] = (int32_t)h;
    uint32_t n;
    do {
      n = (uint32_t)(nplh[numlvls] * nplv[numlvls]);
      nplh[numlvls + 1] = (nplh[numlvls] + 1) / 2;
      nplv[numlvls + 1] = (nplv[numlvls] + 1) / 2;
      numnodes += n;
      ++numlvls;
    } while (n > 1);
    nodes.assign(numnodes, Node{-1, 999, 0});
    int node = 0;
    int parent = (int)(w * h), parent0 = parent;
    for (uint32_t i = 0; i < numlvls - 1; ++i) {
      for (int32_t j = 0; j < nplv[i]; ++j) {
        int32_t k = nplh[i];
        while (--k >= 0) {
          nodes[node++].parent = parent;
          if (--k >= 0) nodes[node++].parent = parent;
          ++parent;
        }
        if ((j & 1) || j == nplv[i] - 1) {
          parent0 = parent;
        } else {
          parent = parent0;
          parent0 += nplh[i];
        }
      }
    }
    nodes[node].parent = -1;
  }
  void reset() {
    for (auto& n : nodes) { n.value = 999; n.low = 0; }
  }
  uint32_t decode(Bio& bio, uint32_t leafno, int32_t threshold) {
    int stk[64];
    int sp = 0;
    int node = (int)leafno;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low; else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.read(1)) nd.value = low; else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

// ---------------------------------------------------------------- structures
struct Seg {
  uint32_t len, numpasses, real_num_passes, maxpasses, numnewpasses, newlen;
};
struct Chunk { const uint8_t* data; uint32_t len; };
struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps, numlenbits, numnewpasses, numsegs, real_num_segs;
  std::vector<Seg> segs;
  std::vector<Chunk> chunks;
};
struct Prec {
  int32_t x0, y0, x1, y1;
  uint32_t cw, ch;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};
struct Band {
  uint32_t bandno;
  int32_t x0, y0, x1, y1;
  float stepsize;
  int32_t numbps;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, pdx, pdy, numbands;
  Band bands[3];
};
struct CompParams {
  int32_t dx, dy, prec, sgnd, numres, cblkw, cblkh, cblksty, qmfbid, roishift,
      numgbits, qntsty;
  int32_t prcw[33], prch[33], expn[97], mant[97];
};
const int COMP_BLOCK = 12 + 33 + 33 + 97 + 97;

union Sample { int32_t i; float f; };

struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres;
  std::vector<Res> res;
  std::vector<Sample> data;
  uint32_t resno_decoded;
};

struct Poc {
  uint32_t resno0, compno0, layno0, resno1, compno1, layno1, precno0, precno1,
      prg;
  int32_t tx0, ty0, tx1, ty1;
};

// ---------------------------------------------------------------- T2 segs
const uint32_t CBLKSTY_LAZY = 0x01, CBLKSTY_RESET = 0x02,
               CBLKSTY_TERMALL = 0x04, CBLKSTY_VSC = 0x08,
               CBLKSTY_SEGSYM = 0x20;

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  std::memset(&s, 0, sizeof(Seg));
  if (cblksty & CBLKSTY_TERMALL) {
    s.maxpasses = 1;
  } else if (cblksty & CBLKSTY_LAZY) {
    if (first) {
      s.maxpasses = 10;
    } else {
      uint32_t prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

uint32_t getnumpasses(Bio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t getcommacode(Bio& bio) {
  uint32_t n = 0;
  while (bio.read(1)) ++n;
  return n;
}

// ---------------------------------------------------------------- decoder
struct Decoder {
  // tile parameters
  int32_t tx0, ty0, tx1, ty1;
  uint32_t numcomps, numlayers, prg, csty, mct;
  bool use_hdr;
  std::vector<Poc> pocs;  // the POC marker's entries, or the default order
  std::vector<CompParams> cp;
  std::vector<TileComp> comps;
  // packet iteration
  uint32_t step_l, step_c, step_r, step_p, max_prec, max_res;
  std::vector<uint8_t> include;
  // data
  const uint8_t* hdr;
  uint32_t hdrlen;

  int init_tile();
  int decode_packets(const uint8_t* src, uint32_t len);
  int read_packet_header(uint32_t compno, uint32_t resno, uint32_t precno,
                         uint32_t layno, const uint8_t* src, uint32_t maxlen,
                         bool& present, uint32_t& read);
  int read_packet_data(uint32_t compno, uint32_t resno, uint32_t precno,
                       const uint8_t* src, uint32_t maxlen, uint32_t& read);
  int t1_decode();
  void dwt_decode();
  int mct_decode();
  void dc_shift();
};

int Decoder::init_tile() {
  comps.resize(numcomps);
  for (uint32_t c = 0; c < numcomps; ++c) {
    const CompParams& p = cp[c];
    TileComp& tc = comps[c];
    tc.x0 = ceildiv(tx0, p.dx);
    tc.y0 = ceildiv(ty0, p.dy);
    tc.x1 = ceildiv(tx1, p.dx);
    tc.y1 = ceildiv(ty1, p.dy);
    tc.numres = (uint32_t)p.numres;
    tc.res.assign(tc.numres, Res());
    tc.resno_decoded = 0;
    uint32_t levelno = tc.numres;
    for (uint32_t r = 0; r < tc.numres; ++r) {
      Res& res = tc.res[r];
      --levelno;
      res.x0 = ceildivpow2(tc.x0, levelno);
      res.y0 = ceildivpow2(tc.y0, levelno);
      res.x1 = ceildivpow2(tc.x1, levelno);
      res.y1 = ceildivpow2(tc.y1, levelno);
      uint32_t pdx = (uint32_t)p.prcw[r], pdy = (uint32_t)p.prch[r];
      res.pdx = pdx; res.pdy = pdy;
      int32_t tlprcx = floordivpow2(res.x0, pdx) << pdx;
      int32_t tlprcy = floordivpow2(res.y0, pdy) << pdy;
      int64_t brx = (int64_t)ceildivpow2(res.x1, pdx) << pdx;
      int64_t bry = (int64_t)ceildivpow2(res.y1, pdy) << pdy;
      if (brx > INT32_MAX || bry > INT32_MAX) return E_SIZE;
      res.pw = res.x0 == res.x1 ? 0 : (uint32_t)((brx - tlprcx) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : (uint32_t)((bry - tlprcy) >> pdy);
      if ((uint64_t)res.pw * res.ph > (1u << 24)) return E_SIZE;
      uint32_t nprec = res.pw * res.ph;
      int32_t tlcbgx, tlcbgy;
      uint32_t cbgw, cbgh;
      if (r == 0) {
        tlcbgx = tlprcx; tlcbgy = tlprcy; cbgw = pdx; cbgh = pdy;
        res.numbands = 1;
      } else {
        tlcbgx = ceildivpow2(tlprcx, 1); tlcbgy = ceildivpow2(tlprcy, 1);
        cbgw = pdx - 1; cbgh = pdy - 1;
        res.numbands = 3;
      }
      uint32_t cbw = std::min((uint32_t)p.cblkw, cbgw);
      uint32_t cbh = std::min((uint32_t)p.cblkh, cbgh);
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        uint32_t ss = r ? 3 * (r - 1) + b + 1 : 0;
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, levelno);
          band.y0 = ceildivpow2(tc.y0, levelno);
          band.x1 = ceildivpow2(tc.x1, levelno);
          band.y1 = ceildivpow2(tc.y1, levelno);
        } else {
          band.bandno = b + 1;
          int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - (x0b << levelno), levelno + 1);
          band.y0 = ceildivpow2(tc.y0 - (y0b << levelno), levelno + 1);
          band.x1 = ceildivpow2(tc.x1 - (x0b << levelno), levelno + 1);
          band.y1 = ceildivpow2(tc.y1 - (y0b << levelno), levelno + 1);
        }
        int32_t log2_gain = p.qmfbid == 0 ? 0
                            : band.bandno == 0 ? 0
                            : band.bandno == 3 ? 2 : 1;
        int32_t rb = p.prec + log2_gain;
        band.stepsize = (float)((1.0 + p.mant[ss] / 2048.0) *
                                std::pow(2.0, (int32_t)(rb - p.expn[ss])));
        band.numbps = p.expn[ss] + p.numgbits - 1;
        band.precs.assign(nprec, Prec());
        for (uint32_t pn = 0; pn < nprec; ++pn) {
          Prec& pr = band.precs[pn];
          int32_t cbgx0 = tlcbgx + (int32_t)(pn % res.pw) * (1 << cbgw);
          int32_t cbgy0 = tlcbgy + (int32_t)(pn / res.pw) * (1 << cbgh);
          int32_t cbgx1 = cbgx0 + (1 << cbgw), cbgy1 = cbgy0 + (1 << cbgh);
          pr.x0 = std::max(cbgx0, band.x0);
          pr.y0 = std::max(cbgy0, band.y0);
          pr.x1 = std::min(cbgx1, band.x1);
          pr.y1 = std::min(cbgy1, band.y1);
          int32_t tlcbx = floordivpow2(pr.x0, cbw) << cbw;
          int32_t tlcby = floordivpow2(pr.y0, cbh) << cbh;
          int32_t brcbx = ceildivpow2(pr.x1, cbw) << cbw;
          int32_t brcby = ceildivpow2(pr.y1, cbh) << cbh;
          pr.cw = (uint32_t)((brcbx - tlcbx) >> cbw);
          pr.ch = (uint32_t)((brcby - tlcby) >> cbh);
          if ((uint64_t)pr.cw * pr.ch > (1u << 24)) return E_SIZE;
          uint32_t ncb = pr.cw * pr.ch;
          pr.cblks.assign(ncb, Cblk());
          for (uint32_t k = 0; k < ncb; ++k) {
            Cblk& cb = pr.cblks[k];
            int32_t cx0 = tlcbx + (int32_t)(k % pr.cw) * (1 << cbw);
            int32_t cy0 = tlcby + (int32_t)(k / pr.cw) * (1 << cbh);
            cb.x0 = std::max(cx0, pr.x0);
            cb.y0 = std::max(cy0, pr.y0);
            cb.x1 = std::min(cx0 + (1 << cbw), pr.x1);
            cb.y1 = std::min(cy0 + (1 << cbh), pr.y1);
            cb.numbps = cb.numlenbits = cb.numnewpasses = 0;
            cb.numsegs = cb.real_num_segs = 0;
          }
          pr.incl.create(pr.cw, pr.ch);
          pr.imsb.create(pr.cw, pr.ch);
        }
      }
    }
    const Res& top = tc.res[tc.numres - 1];
    size_t n = (size_t)(top.x1 - top.x0) * (size_t)(top.y1 - top.y0);
    tc.data.assign(n, Sample{0});
  }
  return 0;
}

// ---------------------------------------------------------------- packets
int Decoder::read_packet_header(uint32_t compno, uint32_t resno,
                                uint32_t precno, uint32_t layno,
                                const uint8_t* src, uint32_t maxlen,
                                bool& present_out, uint32_t& read) {
  Res& res = comps[compno].res[resno];
  const CompParams& p = cp[compno];
  if (layno == 0) {
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (precno >= band.precs.size()) return E_BROKEN;
      Prec& pr = band.precs[precno];
      pr.incl.reset();
      pr.imsb.reset();
      for (auto& cb : pr.cblks) { cb.numsegs = 0; cb.real_num_segs = 0; }
    }
  }
  const uint8_t* cur = src;
  if (csty & 0x02) {  // SOP (where one is missing, OpenJPEG warns)
    if (maxlen >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
  }
  const uint8_t* hstart;
  uint32_t* lenp;
  uint32_t remaining;
  if (use_hdr) {
    hstart = hdr;
    lenp = &hdrlen;
  } else {
    hstart = cur;
    remaining = (uint32_t)(src + maxlen - cur);
    lenp = &remaining;
  }
  Bio bio;
  bio.init(hstart, *lenp);
  const uint8_t* hd = hstart;
  uint32_t present = bio.read(1);
  if (present) {
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[precno];
      uint32_t ncb = pr.cw * pr.ch;
      for (uint32_t k = 0; k < ncb; ++k) {
        Cblk& cb = pr.cblks[k];
        uint32_t included;
        if (!cb.numsegs)
          included = pr.incl.decode(bio, k, (int32_t)(layno + 1));
        else
          included = bio.read(1);
        if (!included) { cb.numnewpasses = 0; continue; }
        if (!cb.numsegs) {
          uint32_t i = 0;
          while (!pr.imsb.decode(bio, k, (int32_t)i)) ++i;
          cb.numbps = (uint32_t)band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = getnumpasses(bio);
        cb.numlenbits += getcommacode(bio);
        uint32_t segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, (uint32_t)p.cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, (uint32_t)p.cblksty, false);
          }
        }
        int32_t n = (int32_t)cb.numnewpasses;
        do {
          Seg& s = cb.segs[segno];
          s.numnewpasses = (uint32_t)std::min(
              (int32_t)(s.maxpasses - s.numpasses), n);
          uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
          if (bits > 32) return E_BITNUMBER;
          s.newlen = bio.read(bits);
          n -= (int32_t)s.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, (uint32_t)p.cblksty, false);
          }
        } while (n > 0);
      }
    }
  }
  bio.inalign();
  hd += bio.numbytes();
  if (csty & 0x04) {  // EPH: OpenJPEG 2.5 fails a packet without one
    if (*lenp - (uint32_t)(hd - hstart) < 2 || hd[0] != 0xff ||
        hd[1] != 0x92)
      return E_MARKER;
    hd += 2;
  }
  uint32_t hlen = (uint32_t)(hd - hstart);
  *lenp -= hlen;
  if (use_hdr) {
    hdr += hlen;
  } else {
    cur += hlen;
  }
  present_out = present != 0;
  read = (uint32_t)(cur - src);
  return 0;
}

int Decoder::read_packet_data(uint32_t compno, uint32_t resno,
                              uint32_t precno, const uint8_t* src,
                              uint32_t maxlen, uint32_t& read) {
  Res& res = comps[compno].res[resno];
  const uint8_t* cur = src;
  for (uint32_t b = 0; b < res.numbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& pr = band.precs[precno];
    uint32_t ncb = pr.cw * pr.ch;
    for (uint32_t k = 0; k < ncb; ++k) {
      Cblk& cb = pr.cblks[k];
      if (!cb.numnewpasses) continue;
      uint32_t si;
      if (!cb.numsegs) {
        si = 0;
        ++cb.numsegs;
      } else {
        si = cb.numsegs - 1;
        if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
          ++si;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[si];
        if ((uint64_t)(cur - src) + s.newlen > maxlen) return E_SEGLONG;
        cb.chunks.push_back(Chunk{cur, s.newlen});
        cur += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        s.real_num_passes = s.numpasses;
        if (cb.numnewpasses > 0) {
          ++si;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
      cb.real_num_segs = cb.numsegs;
    }
  }
  read = (uint32_t)(cur - src);
  return 0;
}

// The packet iterator of OpenJPEG's pi.c (opj_pi_next_*), with the include
// array shared by every progression of the tile.
struct Iter {
  Decoder* d;
  Poc poc;
  bool first;
  uint32_t layno, resno, compno, precno, x, y, dx, dy;
  int err;
  bool next();
  bool lrcp(); bool rlcp(); bool rpcl(); bool pcrl(); bool cprl();
  bool take() {
    uint64_t index = (uint64_t)layno * d->step_l + (uint64_t)resno * d->step_r +
                     (uint64_t)compno * d->step_c + (uint64_t)precno * d->step_p;
    if (index >= d->include.size()) { err = E_PI; return false; }
    if (!d->include[index]) { d->include[index] = 1; return true; }
    return false;
  }
  bool prec_at(uint32_t& out);
  void minsteps(uint32_t c0, uint32_t c1) {
    dx = dy = 0;
    for (uint32_t c = c0; c < c1; ++c) {
      const CompParams& p = d->cp[c];
      const TileComp& tc = d->comps[c];
      for (uint32_t r = 0; r < tc.numres; ++r) {
        const Res& res = tc.res[r];
        uint32_t sx = res.pdx + tc.numres - 1 - r;
        uint32_t sy = res.pdy + tc.numres - 1 - r;
        if (sx < 32 && (uint32_t)p.dx <= UINT32_MAX / (1u << sx)) {
          uint32_t v = (uint32_t)p.dx * (1u << sx);
          dx = !dx ? v : std::min(dx, v);
        }
        if (sy < 32 && (uint32_t)p.dy <= UINT32_MAX / (1u << sy)) {
          uint32_t v = (uint32_t)p.dy * (1u << sy);
          dy = !dy ? v : std::min(dy, v);
        }
      }
    }
  }
};

// the precinct of (compno, resno) that starts at (x, y), or false
bool Iter::prec_at(uint32_t& out) {
  const CompParams& p = d->cp[compno];
  const TileComp& tc = d->comps[compno];
  const Res& res = tc.res[resno];
  uint32_t levelno = tc.numres - 1 - resno;
  uint32_t cdx = (uint32_t)p.dx, cdy = (uint32_t)p.dy;
  if (levelno >= 32 || ((cdx << levelno) >> levelno) != cdx ||
      ((cdy << levelno) >> levelno) != cdy)
    return false;
  if ((uint64_t)(cdx << levelno) > INT32_MAX ||
      (uint64_t)(cdy << levelno) > INT32_MAX)
    return false;
  uint32_t trx0 = uceildiv((uint32_t)d->tx0, cdx << levelno);
  uint32_t try0 = uceildiv((uint32_t)d->ty0, cdy << levelno);
  uint32_t trx1 = uceildiv((uint32_t)d->tx1, cdx << levelno);
  uint32_t try1 = uceildiv((uint32_t)d->ty1, cdy << levelno);
  uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
  if (rpx >= 31 || ((cdx << rpx) >> rpx) != cdx || rpy >= 31 ||
      ((cdy << rpy) >> rpy) != cdy)
    return false;
  if (!(((uint64_t)y % ((uint64_t)cdy << rpy) == 0) ||
        ((y == (uint32_t)d->ty0) &&
         (((uint64_t)try0 << levelno) % ((uint64_t)1u << rpy)))))
    return false;
  if (!(((uint64_t)x % ((uint64_t)cdx << rpx) == 0) ||
        ((x == (uint32_t)d->tx0) &&
         (((uint64_t)trx0 << levelno) % ((uint64_t)1u << rpx)))))
    return false;
  if (res.pw == 0 || res.ph == 0) return false;
  if (trx0 == trx1 || try0 == try1) return false;
  uint32_t prci = (uceildiv(x, (uint32_t)((uint64_t)cdx << levelno)) >> res.pdx) -
                  (trx0 >> res.pdx);
  uint32_t prcj = (uceildiv(y, (uint32_t)((uint64_t)cdy << levelno)) >> res.pdy) -
                  (try0 >> res.pdy);
  out = prci + prcj * res.pw;
  return true;
}

// Each ordering is written as OpenJPEG's resumable loop: `first` enters it,
// later calls resume after the packet last returned.
#define PI_RESUME_CHECK                                                   \
  if (poc.compno0 >= d->numcomps || poc.compno1 >= d->numcomps + 1) {     \
    err = E_PI;                                                           \
    return false;                                                         \
  }

bool Iter::lrcp() {
  PI_RESUME_CHECK
  bool resume = !first;
  first = false;
  if (resume) goto skip;
  for (layno = poc.layno0; layno < poc.layno1; layno++) {
    for (resno = poc.resno0; resno < poc.resno1; resno++) {
      for (compno = poc.compno0; compno < poc.compno1; compno++) {
        {
          const TileComp& tc = d->comps[compno];
          if (resno >= tc.numres) continue;
          poc.precno1 = tc.res[resno].pw * tc.res[resno].ph;
        }
        for (precno = poc.precno0; precno < poc.precno1; precno++) {
          if (take()) return true;
          if (err) return false;
        skip:;
        }
      }
    }
  }
  return false;
}

bool Iter::rlcp() {
  PI_RESUME_CHECK
  bool resume = !first;
  first = false;
  if (resume) goto skip;
  for (resno = poc.resno0; resno < poc.resno1; resno++) {
    for (layno = poc.layno0; layno < poc.layno1; layno++) {
      for (compno = poc.compno0; compno < poc.compno1; compno++) {
        {
          const TileComp& tc = d->comps[compno];
          if (resno >= tc.numres) continue;
          poc.precno1 = tc.res[resno].pw * tc.res[resno].ph;
        }
        for (precno = poc.precno0; precno < poc.precno1; precno++) {
          if (take()) return true;
          if (err) return false;
        skip:;
        }
      }
    }
  }
  return false;
}

bool Iter::rpcl() {
  PI_RESUME_CHECK
  bool resume = !first;
  if (first) {
    first = false;
    minsteps(0, d->numcomps);
    if (dx == 0 || dy == 0) return false;
  }
  if (resume) goto skip;
  poc.tx0 = d->tx0; poc.ty0 = d->ty0; poc.tx1 = d->tx1; poc.ty1 = d->ty1;
  for (resno = poc.resno0; resno < poc.resno1; resno++) {
    for (y = (uint32_t)poc.ty0; y < (uint32_t)poc.ty1; y += dy - (y % dy)) {
      for (x = (uint32_t)poc.tx0; x < (uint32_t)poc.tx1; x += dx - (x % dx)) {
        for (compno = poc.compno0; compno < poc.compno1; compno++) {
          if (resno >= d->comps[compno].numres) continue;
          if (!prec_at(precno)) continue;
          for (layno = poc.layno0; layno < poc.layno1; layno++) {
            if (take()) return true;
            if (err) return false;
          skip:;
          }
        }
      }
    }
  }
  return false;
}

bool Iter::pcrl() {
  PI_RESUME_CHECK
  bool resume = !first;
  if (first) {
    first = false;
    minsteps(0, d->numcomps);
    if (dx == 0 || dy == 0) return false;
  }
  if (resume) goto skip;
  poc.tx0 = d->tx0; poc.ty0 = d->ty0; poc.tx1 = d->tx1; poc.ty1 = d->ty1;
  for (y = (uint32_t)poc.ty0; y < (uint32_t)poc.ty1; y += dy - (y % dy)) {
    for (x = (uint32_t)poc.tx0; x < (uint32_t)poc.tx1; x += dx - (x % dx)) {
      for (compno = poc.compno0; compno < poc.compno1; compno++) {
        for (resno = poc.resno0;
             resno < std::min(poc.resno1, d->comps[compno].numres); resno++) {
          if (!prec_at(precno)) continue;
          for (layno = poc.layno0; layno < poc.layno1; layno++) {
            if (take()) return true;
            if (err) return false;
          skip:;
          }
        }
      }
    }
  }
  return false;
}

bool Iter::cprl() {
  PI_RESUME_CHECK
  bool resume = !first;
  first = false;
  if (resume) goto skip;
  for (compno = poc.compno0; compno < poc.compno1; compno++) {
    minsteps(compno, compno + 1);
    if (dx == 0 || dy == 0) return false;
    poc.tx0 = d->tx0; poc.ty0 = d->ty0; poc.tx1 = d->tx1; poc.ty1 = d->ty1;
    for (y = (uint32_t)poc.ty0; y < (uint32_t)poc.ty1; y += dy - (y % dy)) {
      for (x = (uint32_t)poc.tx0; x < (uint32_t)poc.tx1; x += dx - (x % dx)) {
        for (resno = poc.resno0;
             resno < std::min(poc.resno1, d->comps[compno].numres); resno++) {
          if (!prec_at(precno)) continue;
          for (layno = poc.layno0; layno < poc.layno1; layno++) {
            if (take()) return true;
            if (err) return false;
          skip:;
          }
        }
      }
    }
  }
  return false;
}

bool Iter::next() {
  switch (poc.prg) {
    case 0: return lrcp();
    case 1: return rlcp();
    case 2: return rpcl();
    case 3: return pcrl();
    case 4: return cprl();
  }
  return false;
}

int Decoder::decode_packets(const uint8_t* src, uint32_t len) {
  // opj_get_all_encoding_parameters: the packet index steps
  max_prec = 0; max_res = 0;
  for (uint32_t c = 0; c < numcomps; ++c) {
    max_res = std::max(max_res, comps[c].numres);
    for (auto& r : comps[c].res) max_prec = std::max(max_prec, r.pw * r.ph);
  }
  step_p = 1;
  step_c = max_prec * step_p;
  step_r = numcomps * step_c;
  step_l = max_res * step_r;
  if (step_l > UINT32_MAX / (numlayers + 1u)) return E_PI;
  include.assign((size_t)(numlayers + 1) * step_l, 0);
  const uint8_t* cur = src;
  uint32_t maxlen = len;
  for (size_t pino = 0; pino < pocs.size(); ++pino) {
    Iter it{};
    it.d = this;
    it.poc = pocs[pino];
    it.first = true;
    it.err = 0;
    if (it.poc.prg == UINT32_MAX) return E_PI;  // COD's unknown order
    std::vector<bool> first_pass_failed(numcomps, true);
    while (it.next()) {
      bool present;
      uint32_t nread = 0, dread = 0;
      first_pass_failed[it.compno] = false;
      int rc = read_packet_header(it.compno, it.resno, it.precno, it.layno,
                                  cur, maxlen, present, nread);
      if (rc) return rc;
      if (present) {
        rc = read_packet_data(it.compno, it.resno, it.precno, cur + nread,
                              maxlen - nread, dread);
        if (rc) return rc;
      }
      TileComp& tc = comps[it.compno];
      tc.resno_decoded = std::max(it.resno, tc.resno_decoded);
      cur += nread + dread;
      maxlen -= nread + dread;
    }
    if (it.err) return it.err;
  }
  return 0;
}

// ---------------------------------------------------------------- MQ coder
struct MqState { uint16_t qeval; uint8_t nmps, nlps, sw; };
const MqState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Mqc {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t st[NUM_CTX], mps[NUM_CTX];
  void resetstates() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[CTX_ZC] = 4;
  }
  // data is followed by two 0xFF bytes (the decoder's artificial marker)
  void bytein() {
    uint32_t l = bp[1];
    if (bp[0] == 0xff) {
      if (l > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += l << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += l << 8;
      ct = 8;
    }
  }
  void init_dec(const uint8_t* p, uint32_t len) {
    bp = p;
    c = len == 0 ? 0xffu << 16 : (uint32_t)(*bp << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init_dec(const uint8_t* p) { bp = p; c = 0; ct = 0; }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    const MqState& s = MQ_TABLE[st[cx]];
    uint32_t q = s.qeval, d;
    a -= q;
    if ((c >> 16) < q) {
      // LPS exchange
      if (a < q) {
        a = q;
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        a = q;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
        st[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= q << 16;
      if ((a & 0x8000) == 0) {
        // MPS exchange
        if (a < q) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  uint32_t raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1u;
  }
};

// ---------------------------------------------------------------- tier 1
enum { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8 };

struct T1 {
  uint32_t w, h;
  bool vsc;
  uint32_t orient;  // band number: 0 LL, 1 HL, 2 LH, 3 HH
  std::vector<uint8_t> flags;  // (h + 2) x (w + 2), zero border
  std::vector<int32_t> data;   // h x w
  Mqc mqc;

  uint8_t& F(int y, int x) { return flags[(size_t)(y + 1) * (w + 2) + x + 1]; }
  bool south_hidden(int y) const { return vsc && (y & 3) == 3; }
  bool sig(int y, int x) { return F(y, x) & F_SIG; }

  void neighbours(int y, int x, int& h, int& v, int& dgn) {
    bool sh = south_hidden(y);
    h = sig(y, x - 1) + sig(y, x + 1);
    v = sig(y - 1, x) + (sh ? 0 : sig(y + 1, x));
    dgn = sig(y - 1, x - 1) + sig(y - 1, x + 1) +
          (sh ? 0 : sig(y + 1, x - 1) + sig(y + 1, x + 1));
  }
  bool any_neighbour(int y, int x) {
    int h, v, dg;
    neighbours(y, x, h, v, dg);
    return h + v + dg > 0;
  }
  int ctx_zc(int y, int x) {
    int h, v, d;
    neighbours(y, x, h, v, d);
    int n = 0;
    if (orient == 1) std::swap(h, v);
    if (orient != 3) {
      if (!h) {
        if (!v) n = !d ? 0 : d == 1 ? 1 : 2;
        else n = v == 1 ? 3 : 4;
      } else if (h == 1) {
        n = !v ? (!d ? 5 : 6) : 7;
      } else {
        n = 8;
      }
    } else {
      int hv = h + v;
      if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
      else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
      else if (d == 2) n = !hv ? 6 : 7;
      else n = 8;
    }
    return CTX_ZC + n;
  }
  int contrib(int y, int x) {
    uint8_t f = F(y, x);
    if (!(f & F_SIG)) return 0;
    return (f & F_NEG) ? -1 : 1;
  }
  void ctx_sc(int y, int x, int& ctx, uint32_t& spb) {
    bool sh = south_hidden(y);
    int e = contrib(y, x + 1), wv = contrib(y, x - 1);
    int n = contrib(y - 1, x), s = sh ? 0 : contrib(y + 1, x);
    int hc = std::min((e > 0) + (wv > 0), 1) - std::min((e < 0) + (wv < 0), 1);
    int vc = std::min((n > 0) + (s > 0), 1) - std::min((n < 0) + (s < 0), 1);
    spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) { hc = -hc; vc = -vc; }
    int k;
    if (!hc) k = vc == 0 ? 0 : 1;
    else k = vc == -1 ? 2 : vc == 0 ? 3 : 4;
    ctx = CTX_SC + k;
  }
  void set_sig(int y, int x, uint32_t neg, int32_t oneplushalf) {
    data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
    F(y, x) |= F_SIG | (neg ? F_NEG : 0);
  }
  void decode_sign(int y, int x, int32_t oneplushalf) {
    int cx;
    uint32_t spb;
    ctx_sc(y, x, cx, spb);
    set_sig(y, x, mqc.decode(cx) ^ spb, oneplushalf);
  }

  template <class Visit>
  void scan(Visit visit) {
    for (uint32_t k = 0; k < h; k += 4)
      for (uint32_t i = 0; i < w; ++i)
        for (uint32_t j = k; j < std::min(k + 4, h); ++j) visit((int)j, (int)i);
  }

  void sigpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    scan([&](int y, int x) {
      uint8_t f = F(y, x);
      if ((f & (F_SIG | F_VISIT)) || !any_neighbour(y, x)) return;
      if (raw) {
        if (mqc.raw_decode()) set_sig(y, x, mqc.raw_decode(), oph);
      } else if (mqc.decode(ctx_zc(y, x))) {
        decode_sign(y, x, oph);
      }
      F(y, x) |= F_VISIT;
    });
  }
  void refpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, poshalf = one >> 1;
    scan([&](int y, int x) {
      uint8_t f = F(y, x);
      if ((f & (F_SIG | F_VISIT)) != F_SIG) return;
      uint32_t v;
      if (raw) {
        v = mqc.raw_decode();
      } else {
        int cx = (f & F_REFINED) ? CTX_MAG + 2
                 : any_neighbour(y, x) ? CTX_MAG + 1 : CTX_MAG;
        v = mqc.decode(cx);
      }
      int32_t& d = data[(size_t)y * w + x];
      d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
      F(y, x) |= F_REFINED;
    });
  }
  void clnpass(int bpno, bool segsym) {
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    auto step = [&](int y, int x) {
      if (F(y, x) & (F_SIG | F_VISIT)) return;
      if (mqc.decode(ctx_zc(y, x))) decode_sign(y, x, oph);
    };
    uint32_t full = h & ~3u;
    for (uint32_t k = 0; k < full; k += 4) {
      for (uint32_t i = 0; i < w; ++i) {
        int x = (int)i, y0 = (int)k;
        bool agg = true;
        for (int j = 0; j < 4 && agg; ++j) {
          uint8_t f = F(y0 + j, x);
          if ((f & (F_SIG | F_VISIT)) || any_neighbour(y0 + j, x)) agg = false;
        }
        if (agg) {
          if (!mqc.decode(CTX_AGG)) continue;
          uint32_t runlen = mqc.decode(CTX_UNI);
          runlen = (runlen << 1) | mqc.decode(CTX_UNI);
          decode_sign(y0 + (int)runlen, x, oph);
          for (int j = (int)runlen + 1; j < 4; ++j) step(y0 + j, x);
        } else {
          for (int j = 0; j < 4; ++j) step(y0 + j, x);
        }
      }
    }
    for (uint32_t i = 0; full < h && i < w; ++i)
      for (uint32_t j = full; j < h; ++j) step((int)j, (int)i);
    for (uint32_t y = 0; y < h; ++y)
      for (uint32_t x = 0; x < w; ++x) F((int)y, (int)x) &= ~F_VISIT;
    if (segsym) {
      for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
    }
  }

  // opj_t1_decode_cblk: false where OpenJPEG fails the code-block
  bool decode_cblk(const Cblk& cb, uint32_t band_orient, uint32_t roishift,
                   uint32_t cblksty) {
    w = (uint32_t)(cb.x1 - cb.x0);
    h = (uint32_t)(cb.y1 - cb.y0);
    orient = band_orient;
    vsc = (cblksty & CBLKSTY_VSC) != 0;
    flags.assign((size_t)(h + 2) * (w + 2), 0);
    data.assign((size_t)h * w, 0);
    int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    if (cb.chunks.empty()) return true;
    std::vector<uint8_t> buf;
    for (const Chunk& ch : cb.chunks) buf.insert(buf.end(), ch.data, ch.data + ch.len);
    uint32_t passtype = 2;
    mqc.resetstates();
    size_t index = 0;
    std::vector<uint8_t> seg;
    for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
      const Seg& s = cb.segs[segno];
      bool raw = bpno_plus_one <= (int32_t)cb.numbps - 4 && passtype < 2 &&
                 (cblksty & CBLKSTY_LAZY);
      seg.assign(buf.begin() + (std::ptrdiff_t)std::min(index, buf.size()),
                 buf.begin() + (std::ptrdiff_t)std::min(index + s.len, buf.size()));
      seg.push_back(0xff);
      seg.push_back(0xff);
      if (raw) mqc.raw_init_dec(seg.data());
      else mqc.init_dec(seg.data(), s.len);
      index += s.len;
      for (uint32_t passno = 0;
           passno < s.real_num_passes && bpno_plus_one >= 1; ++passno) {
        switch (passtype) {
          case 0: sigpass(bpno_plus_one, raw); break;
          case 1: refpass(bpno_plus_one, raw); break;
          case 2: clnpass(bpno_plus_one, (cblksty & CBLKSTY_SEGSYM) != 0);
                  break;
        }
        if ((cblksty & CBLKSTY_RESET) && !raw) mqc.resetstates();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
    return true;
  }
};

int Decoder::t1_decode() {
  T1 t1;
  for (uint32_t c = 0; c < numcomps; ++c) {
    TileComp& tc = comps[c];
    const CompParams& p = cp[c];
    const Res& top = tc.res[tc.numres - 1];
    size_t tile_w = (size_t)(top.x1 - top.x0);
    for (uint32_t r = 0; r < tc.numres; ++r) {
      Res& res = tc.res[r];
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        for (Prec& pr : band.precs) {
          for (Cblk& cb : pr.cblks) {
            if (!t1.decode_cblk(cb, band.bandno, (uint32_t)p.roishift,
                                (uint32_t)p.cblksty))
              return E_BPNO;
            uint32_t w = t1.w, h = t1.h;
            if (p.roishift) {
              if (p.roishift >= 31) {
                std::fill(t1.data.begin(), t1.data.end(), 0);
              } else {
                int32_t thresh = 1 << p.roishift;
                for (auto& v : t1.data) {
                  int32_t mag = std::abs(v);
                  if (mag >= thresh) {
                    mag >>= p.roishift;
                    v = v < 0 ? -mag : mag;
                  }
                }
              }
            }
            size_t x = (size_t)(cb.x0 - band.x0), y = (size_t)(cb.y0 - band.y0);
            if (band.bandno & 1) x += (size_t)(tc.res[r - 1].x1 - tc.res[r - 1].x0);
            if (band.bandno & 2) y += (size_t)(tc.res[r - 1].y1 - tc.res[r - 1].y0);
            Sample* dst = tc.data.data() + y * tile_w + x;
            if (p.qmfbid == 1) {
              for (uint32_t j = 0; j < h; ++j)
                for (uint32_t i = 0; i < w; ++i)
                  dst[j * tile_w + i].i = t1.data[(size_t)j * w + i] / 2;
            } else {
              const float stepsize = 0.5f * band.stepsize;
              for (uint32_t j = 0; j < h; ++j)
                for (uint32_t i = 0; i < w; ++i)
                  dst[j * tile_w + i].f =
                      (float)t1.data[(size_t)j * w + i] * stepsize;
            }
          }
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------- DWT
void idwt53_1d(int32_t* X, const int32_t* L, int32_t sn, const int32_t* H,
               int32_t dn, int cas) {
  int32_t n = sn + dn;
  if (cas == 0) {
    if (n == 1) { X[0] = L[0]; return; }
    for (int32_t i = 0; i < sn; ++i) {
      int32_t hl = i - 1 >= 0 ? H[i - 1] : H[0];
      int32_t hr = i < dn ? H[i] : H[dn - 1];
      X[2 * i] = L[i] - ((hl + hr + 2) >> 2);
    }
    for (int32_t i = 0; i < dn; ++i) {
      int32_t xl = X[2 * i], xr = 2 * i + 2 < n ? X[2 * i + 2] : X[2 * i];
      X[2 * i + 1] = H[i] + ((xl + xr) >> 1);
    }
  } else {
    if (n == 1) { X[0] = H[0] / 2; return; }
    for (int32_t i = 0; i < sn; ++i) {
      int32_t hl = H[i], hr = i + 1 < dn ? H[i + 1] : H[i];
      X[2 * i + 1] = L[i] - ((hl + hr + 2) >> 2);
    }
    for (int32_t i = 0; i < dn; ++i) {
      int32_t xl = 2 * i - 1 >= 0 ? X[2 * i - 1] : X[1];
      int32_t xr = 2 * i + 1 < n ? X[2 * i + 1] : X[2 * i - 1];
      X[2 * i] = H[i] + ((xl + xr) >> 1);
    }
  }
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f,
            DWT_GAMMA = 0.882911075f, DWT_DELTA = 0.443506852f,
            DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

// opj_v8dwt_decode_step2 on one lane: X[t + 2i] += (left + right) * c
void step2(float* X, int32_t t, int32_t o, uint32_t end, uint32_t m, float c) {
  uint32_t imax = std::min(end, m);
  for (uint32_t i = 0; i < imax; ++i) {
    float left = i == 0 ? X[o] : X[t + 2 * i - 1];
    X[t + 2 * i] = X[t + 2 * i] + ((left + X[t + 2 * i + 1]) * c);
  }
  if (m < end) {
    float left = m == 0 ? X[o] : X[t + 2 * m - 1];
    float c2 = c + c;
    X[t + 2 * m] = X[t + 2 * m] + (c2 * left);
  }
}

// X holds the interleaved samples: L[i] at 2i + cas, H[i] at 2i + 1 - cas
void idwt97_1d(float* X, int32_t sn, int32_t dn, int cas) {
  int32_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0; b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1; b = 0;
  }
  for (int32_t i = 0; i < sn; ++i) X[a + 2 * i] = X[a + 2 * i] * DWT_K;
  for (int32_t i = 0; i < dn; ++i) X[b + 2 * i] = X[b + 2 * i] * DWT_TWO_INVK;
  auto mn = [](int32_t u, int32_t v) { return (uint32_t)std::max(0, std::min(u, v)); };
  step2(X, a, b, (uint32_t)sn, mn(sn, dn - a), -DWT_DELTA);
  step2(X, b, a, (uint32_t)dn, mn(dn, sn - b), -DWT_GAMMA);
  step2(X, a, b, (uint32_t)sn, mn(sn, dn - a), -DWT_BETA);
  step2(X, b, a, (uint32_t)dn, mn(dn, sn - b), -DWT_ALPHA);
}

void Decoder::dwt_decode() {
  for (uint32_t c = 0; c < numcomps; ++c) {
    TileComp& tc = comps[c];
    uint32_t numres = tc.resno_decoded + 1;
    if (numres <= 1) continue;
    const Res& top = tc.res[tc.numres - 1];
    size_t w = (size_t)(top.x1 - top.x0);
    bool rev = cp[c].qmfbid == 1;
    uint32_t rw = (uint32_t)(tc.res[0].x1 - tc.res[0].x0);
    uint32_t rh = (uint32_t)(tc.res[0].y1 - tc.res[0].y0);
    std::vector<int32_t> li, xi;
    std::vector<float> xf;
    for (uint32_t r = 1; r < numres; ++r) {
      const Res& res = tc.res[r];
      int32_t hsn = (int32_t)rw, vsn = (int32_t)rh;
      rw = (uint32_t)(res.x1 - res.x0);
      rh = (uint32_t)(res.y1 - res.y0);
      int32_t hdn = (int32_t)rw - hsn, vdn = (int32_t)rh - vsn;
      int hcas = res.x0 % 2, vcas = res.y0 % 2;
      size_t mx = std::max(rw, rh);
      li.resize(mx); xi.resize(mx); xf.resize(mx);
      // rows
      for (uint32_t j = 0; j < rh && rw > 0; ++j) {
        Sample* row = tc.data.data() + j * w;
        if (rev) {
          for (uint32_t k = 0; k < rw; ++k) li[k] = row[k].i;
          idwt53_1d(xi.data(), li.data(), hsn, li.data() + hsn, hdn, hcas);
          for (uint32_t k = 0; k < rw; ++k) row[k].i = xi[k];
        } else {
          for (int32_t i = 0; i < hsn; ++i) xf[2 * i + hcas] = row[i].f;
          for (int32_t i = 0; i < hdn; ++i) xf[2 * i + 1 - hcas] = row[hsn + i].f;
          idwt97_1d(xf.data(), hsn, hdn, hcas);
          for (uint32_t k = 0; k < rw; ++k) row[k].f = xf[k];
        }
      }
      // columns
      for (uint32_t i = 0; i < rw && rh > 0; ++i) {
        Sample* col = tc.data.data() + i;
        if (rev) {
          for (uint32_t k = 0; k < rh; ++k) li[k] = col[k * w].i;
          idwt53_1d(xi.data(), li.data(), vsn, li.data() + vsn, vdn, vcas);
          for (uint32_t k = 0; k < rh; ++k) col[k * w].i = xi[k];
        } else {
          for (int32_t k = 0; k < vsn; ++k) xf[2 * k + vcas] = col[k * w].f;
          for (int32_t k = 0; k < vdn; ++k) xf[2 * k + 1 - vcas] = col[(vsn + k) * w].f;
          idwt97_1d(xf.data(), vsn, vdn, vcas);
          for (uint32_t k = 0; k < rh; ++k) col[k * w].f = xf[k];
        }
      }
    }
  }
}

int Decoder::mct_decode() {
  if (mct == 0) return 0;
  if (numcomps < 3) return 0;
  TileComp& c0 = comps[0];
  const Res& r0 = c0.res[c0.numres - 1];
  size_t n = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
  if (comps[1].numres != c0.numres || comps[2].numres != c0.numres)
    return E_MCT;
  for (int k = 1; k < 3; ++k) {
    const Res& r = comps[k].res[c0.numres - 1];
    if (comps[k].resno_decoded != c0.resno_decoded ||
        (size_t)(r.x1 - r.x0) * (size_t)(r.y1 - r.y0) != n)
      return E_MCT;
  }
  Sample *a = c0.data.data(), *b = comps[1].data.data(), *c = comps[2].data.data();
  if (cp[0].qmfbid == 1) {
    for (size_t i = 0; i < n; ++i) {
      int32_t y = a[i].i, u = b[i].i, v = c[i].i;
      int32_t g = y - ((u + v) >> 2);
      a[i].i = v + g;
      b[i].i = g;
      c[i].i = u + g;
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      float y = a[i].f, u = b[i].f, v = c[i].f;
      float r = y + (v * 1.402f);
      float g = (y - (u * 0.34413f)) - (v * 0.71414f);
      float bb = y + (u * 1.772f);
      a[i].f = r;
      b[i].f = g;
      c[i].f = bb;
    }
  }
  return 0;
}

void Decoder::dc_shift() {
  for (uint32_t c = 0; c < numcomps; ++c) {
    TileComp& tc = comps[c];
    const CompParams& p = cp[c];
    const Res& res = tc.res[tc.resno_decoded];
    const Res& top = tc.res[tc.numres - 1];
    size_t w = (size_t)(res.x1 - res.x0), h = (size_t)(res.y1 - res.y0);
    size_t stride = (size_t)(top.x1 - top.x0);
    int32_t mn, mx, shift = p.sgnd ? 0 : 1 << (p.prec - 1);
    if (p.sgnd) {
      mn = -(1 << (p.prec - 1));
      mx = (1 << (p.prec - 1)) - 1;
    } else {
      mn = 0;
      mx = (int32_t)((1u << p.prec) - 1);
    }
    for (size_t j = 0; j < h; ++j) {
      Sample* row = tc.data.data() + j * stride;
      for (size_t i = 0; i < w; ++i) {
        if (p.qmfbid == 1) {
          int32_t v = row[i].i + shift;
          row[i].i = v < mn ? mn : v > mx ? mx : v;
        } else {
          float f = row[i].f;
          if (f > (float)INT32_MAX) {
            row[i].i = mx;
          } else if (f < (float)INT32_MIN) {
            row[i].i = mn;
          } else {
            int64_t v = (int64_t)lrintf(f) + shift;
            row[i].i = (int32_t)(v < mn ? mn : v > mx ? mx : v);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Decodes one tile. P: the tile's parameters (utils/j2k.py: _tile_params);
// data/len: the tile's packet data; hdr/hdrlen: its packet headers where
// PPM or PPT holds them (hdr_used returns how many bytes were read); out:
// each component's decoded region, one after another (int32), sized by the
// caller from the tile's geometry; info (5 per component): resno_decoded
// (the highest resolution a packet of this tile reached), the region's
// width and height and its origin in that resolution's coordinates.
// Returns 0, or a negative code where OpenJPEG fails the tile.
int j2k_decode_tile(const int32_t* P, const uint8_t* data, int64_t len,
                    const uint8_t* hdr, int64_t hdrlen, int64_t* hdr_used,
                    int32_t* out, int64_t out_cap, int32_t* info) {
  Decoder d;
  d.tx0 = P[0]; d.ty0 = P[1]; d.tx1 = P[2]; d.ty1 = P[3];
  d.numcomps = (uint32_t)P[4];
  d.numlayers = (uint32_t)P[5];
  d.prg = (uint32_t)P[6];
  d.csty = (uint32_t)P[7];
  d.mct = (uint32_t)P[8];
  d.use_hdr = P[9] != 0;
  int32_t npocs = P[10];
  const int32_t* q = P + 11;
  d.cp.resize(d.numcomps);
  std::vector<int32_t> poc_raw(q, q + 6 * std::max(npocs, 0));
  q += 6 * std::max(npocs, 0);
  for (uint32_t c = 0; c < d.numcomps; ++c) {
    CompParams& p = d.cp[c];
    std::memcpy(&p, q, sizeof(int32_t) * COMP_BLOCK);
    q += COMP_BLOCK;
  }
  int rc = d.init_tile();
  if (rc) return rc;
  uint32_t max_res = 0;
  for (auto& tc : d.comps) max_res = std::max(max_res, tc.numres);
  if (npocs > 0) {
    for (int32_t k = 0; k < npocs; ++k) {
      Poc poc{};
      poc.resno0 = (uint32_t)poc_raw[6 * k];
      poc.compno0 = (uint32_t)poc_raw[6 * k + 1];
      poc.layno1 = std::min((uint32_t)poc_raw[6 * k + 2], d.numlayers);
      poc.resno1 = (uint32_t)poc_raw[6 * k + 3];
      poc.compno1 = (uint32_t)poc_raw[6 * k + 4];
      poc.prg = (uint32_t)poc_raw[6 * k + 5];
      d.pocs.push_back(poc);
    }
  } else {
    Poc poc{};
    poc.prg = d.prg;
    poc.resno1 = max_res;
    poc.compno1 = d.numcomps;
    poc.layno1 = d.numlayers;
    d.pocs.push_back(poc);
  }
  d.hdr = hdr;
  d.hdrlen = (uint32_t)hdrlen;
  rc = d.decode_packets(data, (uint32_t)len);
  if (rc) return rc;
  if (hdr_used) *hdr_used = (int64_t)(d.hdr - hdr);
  rc = d.t1_decode();
  if (rc) return rc;
  d.dwt_decode();
  rc = d.mct_decode();
  if (rc) return rc;
  d.dc_shift();
  int64_t pos = 0;
  for (uint32_t c = 0; c < d.numcomps; ++c) {
    TileComp& tc = d.comps[c];
    const Res& res = tc.res[tc.resno_decoded];
    const Res& top = tc.res[tc.numres - 1];
    int32_t w = res.x1 - res.x0, h = res.y1 - res.y0;
    int32_t stride = top.x1 - top.x0;
    info[5 * c] = (int32_t)tc.resno_decoded;
    info[5 * c + 1] = w;
    info[5 * c + 2] = h;
    info[5 * c + 3] = res.x0;
    info[5 * c + 4] = res.y0;
    if (pos + (int64_t)w * h > out_cap) return E_SIZE;
    for (int32_t j = 0; j < h; ++j)
      for (int32_t i = 0; i < w; ++i)
        out[pos++] = tc.data[(size_t)j * stride + i].i;
  }
  return 0;
}

}  // extern "C"
