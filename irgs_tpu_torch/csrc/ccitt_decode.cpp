// CCITT bilevel decoding for TIFF strips and tiles (compressions 2, 3 and
// 4), for irgs_tpu_torch/utils/tiff.py, as libtiff's tif_fax3.c (which PIL
// calls) decodes them, damaged data included:
//   mode 0  modified Huffman, rows byte-aligned (Fax3DecodeRLE);
//   mode 1  T.4 one-dimensional, an EOL before each row (Fax3Decode1D);
//   mode 2  T.4 two-dimensional, EOL + tag bit (Fax3Decode2D);
//   mode 3  T.6 (Fax4Decode);
//   mode 4  modified Huffman, rows word-aligned (CCITT RLEW, 32771: the
//           same Fax3DecodeRLE with FAXMODE_WORDALIGN; the alignment
//           counts from the strip's first byte).
// The bit reader, the code tables (indexed LSB-first, as mkg3states builds
// them) and the row expansion follow libtiff's macros: NeedBits pads with
// zeros at the end of the data while any bits are left, a code that no
// table knows ends the row, CLEANUP_RUNS whitens what a bad row left, and
// _TIFFFax3fillruns writes the runs (white 0 bits, black 1 bits). A row
// that libtiff leaves unwritten (a T.6 strip that ends early) is reported
// through `written` and left as the caller's buffer had it. Built with g++
// at first use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

enum State : uint8_t {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct Ent {
  uint8_t state;
  uint8_t width;
  int32_t param;
};

struct Code {
  const char* bits;
  int32_t param;
};

// ITU-T T.4 tables 2 and 3: terminating and make-up codes
const Code kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},   {"0111", 2},     {"1000", 3},
    {"1011", 4},      {"1100", 5},     {"1110", 6},     {"1111", 7},
    {"10011", 8},     {"10100", 9},    {"00111", 10},   {"01000", 11},
    {"001000", 12},   {"000011", 13},  {"110100", 14},  {"110101", 15},
    {"101010", 16},   {"101011", 17},  {"0100111", 18}, {"0001100", 19},
    {"0001000", 20},  {"0010111", 21}, {"0000011", 22}, {"0000100", 23},
    {"0101000", 24},  {"0101011", 25}, {"0010011", 26}, {"0100100", 27},
    {"0011000", 28},  {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43},
    {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55},
    {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64},      {"10010", 128},     {"010111", 192},
    {"0110111", 256},   {"00110110", 320},  {"00110111", 384},
    {"01100100", 448},  {"01100101", 512},  {"01101000", 576},
    {"01100111", 640},  {"011001100", 704}, {"011001101", 768},
    {"011010010", 832}, {"011010011", 896}, {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},   {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},
    {"10", 3},           {"011", 4},          {"0011", 5},
    {"0010", 6},         {"00011", 7},        {"000101", 8},
    {"000100", 9},       {"0000100", 10},     {"0000101", 11},
    {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},
    {"0000001000", 18},  {"00001100111", 19}, {"00001101000", 20},
    {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kExtMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

// every index of a `wid`-bit LSB-first table whose low bits are the code
void fill(Ent* tab, int wid, const char* bits, State s, int32_t param) {
  int len = static_cast<int>(strlen(bits));
  uint32_t code = 0;
  for (int i = 0; i < len; ++i) code |= (bits[i] == '1' ? 1u : 0u) << i;
  for (uint32_t hi = 0; hi < (1u << (wid - len)); ++hi) {
    Ent& e = tab[code | (hi << len)];
    e.state = s;
    e.width = static_cast<uint8_t>(len);
    e.param = param;
  }
}

struct Tables {
  Ent white[1 << 12];
  Ent black[1 << 13];
  Ent main[1 << 7];
  Tables() {
    memset(white, 0, sizeof(white));
    memset(black, 0, sizeof(black));
    memset(main, 0, sizeof(main));
    for (const Code& c : kWhiteTerm) fill(white, 12, c.bits, S_TermW, c.param);
    for (const Code& c : kWhiteMakeUp)
      fill(white, 12, c.bits, S_MakeUpW, c.param);
    for (const Code& c : kBlackTerm) fill(black, 13, c.bits, S_TermB, c.param);
    for (const Code& c : kBlackMakeUp)
      fill(black, 13, c.bits, S_MakeUpB, c.param);
    for (const Code& c : kExtMakeUp) {
      fill(white, 12, c.bits, S_MakeUp, c.param);
      fill(black, 13, c.bits, S_MakeUp, c.param);
    }
    fill(white, 12, "00000000000", S_EOL, 0);
    fill(black, 13, "00000000000", S_EOL, 0);
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t kRev[256];
struct RevInit {
  RevInit() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      kRev[i] = static_cast<uint8_t>(r);
    }
  }
} rev_init;

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run past
// lastx is cut there
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, int64_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  int64_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      int64_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = (uint32_t)(lastx - x);
      for (int64_t i = x; i < x + run; ++i) {
        if (k) buf[i >> 3] |= 0x80 >> (i & 7);
        else buf[i >> 3] &= ~(0x80 >> (i & 7));
      }
      x += runs[k];
    }
  }
}

struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;
  bool noeol = false;

  bool end() const { return cp >= ep; }
  // NeedBits8/NeedBits16: false where no valid bit is left
  bool need(int n) {
    if (avail < n) {
      if (end()) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(kRev[*cp++]) << avail;
        avail += 8;
        if (avail < n) {
          if (end()) {
            avail = n;
          } else {
            acc |= static_cast<uint32_t>(kRev[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
};

}  // namespace

extern "C" {

// The run arrays' size (uint32 entries): two rows of libtiff's nruns,
// which the 2D decoders swap row by row and keep from strip to strip.
uint32_t ccitt_runs(int64_t width, int mode) {
  uint32_t nruns = (uint32_t)((width + 1 + 31) / 32 * 32);
  if (mode == 2 || mode == 3) nruns *= 2;
  return 2 * nruns;
}

// Decode one strip or tile of `rows` rows of `width` pixels into `out`
// (rows * ceil(width / 8) bytes, as the caller's buffer holds them).
// written[r] is set for each row libtiff writes. What libtiff's decoder
// keeps from strip to strip the caller keeps too: state[0], T.4's "no
// EOL" mode (libtiff sets it, for the rest of the image, at the first row
// whose EOL's zeros run to the end of the data, and decodes the strip
// again from its start into that row and those after it); state[1], which
// half of `runs` (ccitt_runs entries) holds the current row; and the runs
// themselves, of which a new strip resets only the reference row's first
// two (a damaged row may read on into what the last strip left). Returns
// 1, or -1 where libtiff's decoder fails (and PIL raises).
int ccitt_decode(const uint8_t* data, int64_t len, int mode, int64_t width,
                 int64_t rows, uint8_t* out, uint8_t* written, int* state,
                 uint32_t* runs) {
  int* noeol = state;
  const Tables& T = tables();
  Decoder d;
  d.cp = data;
  d.ep = data + len;
  d.noeol = *noeol != 0;
  struct Keep {
    Decoder* d;
    int* flag;
    ~Keep() { *flag = d->noeol; }
  } keep{&d, noeol};
  const int64_t rowbytes = (width + 7) / 8;
  const bool two_d = mode == 2 || mode == 3;
  uint32_t nruns = ccitt_runs(width, mode) / 2;
  uint32_t* curruns = runs + (state[1] ? nruns : 0);
  uint32_t* refruns = two_d ? runs + (state[1] ? 0 : nruns) : nullptr;
  if (refruns) {
    refruns[0] = (uint32_t)width;
    refruns[1] = 0;
  }
  struct KeepRuns {
    uint32_t** cur;
    uint32_t* base;
    int* flag;
    ~KeepRuns() { *flag = *cur != base; }
  } keep_runs{&curruns, runs, state + 1};
  const int64_t lastx = width;
  int EOLcnt = 0;
  int64_t line = 0;
  uint8_t* buf = out;

  for (int64_t row = 0; row < rows; ++row) {
    int64_t a0 = 0, RunLength = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    uint32_t* pb = refruns;
    int64_t b1 = 0;
    bool eof = false;
    bool overflow = false;

    auto setvalue = [&](int64_t x) -> bool {
      if (pa >= thisrun + nruns) {
        overflow = true;
        return false;
      }
      *pa++ = (uint32_t)(RunLength + x);
      a0 += x;
      RunLength = 0;
      return true;
    };
    auto cleanup = [&]() -> bool {
      if (RunLength && !setvalue(0)) return false;
      if (a0 != lastx) {
        while (a0 > lastx && pa > thisrun) a0 -= *--pa;
        if (a0 < lastx) {
          if (a0 < 0) a0 = 0;
          if ((pa - thisrun) & 1)
            if (!setvalue(0)) return false;
          if (!setvalue(lastx - a0)) return false;
        } else if (a0 > lastx) {
          if (!setvalue(lastx)) return false;
          if (!setvalue(0)) return false;
        }
      }
      return true;
    };
    // one run of a colour: make-up codes then a terminating code; false
    // at the end of the data (eof set), at an EOL (hit_eol set where one
    // may end the row) or at a code the table lacks
    auto run_of = [&](bool white, bool allow_eol, bool* hit_eol) -> bool {
      for (;;) {
        int wid = white ? 12 : 13;
        if (!d.need(wid)) {
          eof = true;
          return false;
        }
        const Ent& e = white ? T.white[d.get(12)] : T.black[d.get(13)];
        d.clr(e.width);
        switch (e.state) {
          case S_EOL:
            if (allow_eol) *hit_eol = true;
            return false;
          case S_TermW:
          case S_TermB:
            if ((e.state == S_TermW) != white) return false;
            return setvalue(e.param);
          case S_MakeUpW:
          case S_MakeUpB:
          case S_MakeUp:
            if ((e.state == S_MakeUpW && !white) ||
                (e.state == S_MakeUpB && white))
              return false;
            a0 += e.param;
            RunLength += e.param;
            break;
          default:
            return false;
        }
      }
    };
    // EXPAND1D: false at the end of the data
    auto expand1d = [&]() -> bool {
      for (;;) {
        bool eol = false;
        if (!run_of(true, true, &eol)) {
          if (overflow) return true;
          if (eof) {
            cleanup();
            return false;
          }
          if (eol) EOLcnt = 1;
          break;
        }
        if (a0 >= lastx) break;
        if (!run_of(false, true, &eol)) {
          if (overflow) return true;
          if (eof) {
            cleanup();
            return false;
          }
          if (eol) EOLcnt = 1;
          break;
        }
        if (a0 >= lastx) break;
        if (pa - thisrun >= 2 && *(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
      cleanup();
      return true;
    };
    auto check_b1 = [&]() -> bool {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= refruns + nruns) {
            overflow = true;
            return false;
          }
          b1 += pb[0] + pb[1];
          pb += 2;
        }
      return true;
    };
    // EXPAND2D: false at the end of the data
    auto expand2d = [&]() -> bool {
      while (a0 < lastx) {
        if (pa >= thisrun + nruns) {
          overflow = true;
          return true;
        }
        if (!d.need(7)) {
          eof = true;
          cleanup();
          return false;
        }
        const Ent& e = T.main[d.get(7)];
        d.clr(e.width);
        switch (e.state) {
          case S_Pass:
            if (!check_b1()) return true;
            if (pb >= refruns + nruns) {
              overflow = true;
              return true;
            }
            b1 += *pb++;
            RunLength += b1 - a0;
            a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz: {
            bool eol = false;
            bool first_white = ((pa - thisrun) & 1) == 0;
            if (!run_of(first_white, false, &eol) ||
                !run_of(!first_white, false, &eol)) {
              if (overflow) return true;
              if (eof) {
                cleanup();
                return false;
              }
              cleanup();  // bad code: eol2d
              return true;
            }
            if (!check_b1()) return true;
            break;
          }
          case S_V0:
            if (!check_b1()) return true;
            if (!setvalue(b1 - a0)) return true;
            if (pb >= refruns + nruns) {
              overflow = true;
              return true;
            }
            b1 += *pb++;
            break;
          case S_VR:
            if (!check_b1()) return true;
            if (!setvalue(b1 - a0 + e.param)) return true;
            if (pb >= refruns + nruns) {
              overflow = true;
              return true;
            }
            b1 += *pb++;
            break;
          case S_VL:
            if (!check_b1()) return true;
            if (b1 < a0 + e.param) {
              cleanup();
              return true;
            }
            if (!setvalue(b1 - a0 - e.param)) return true;
            b1 -= *--pb;
            break;
          case S_Ext:
            *pa++ = (uint32_t)(lastx - a0);
            cleanup();
            return true;
          case S_EOL:
            *pa++ = (uint32_t)(lastx - a0);
            if (!d.need(4)) {
              eof = true;
              cleanup();
              return false;
            }
            d.clr(4);
            EOLcnt = 1;
            cleanup();
            return true;
          default:
            cleanup();
            return true;
        }
      }
      if (RunLength) {
        if (RunLength + a0 < lastx) {
          if (!d.need(1)) {
            eof = true;
            cleanup();
            return false;
          }
          if (!d.get(1)) {
            cleanup();
            return true;
          }
          d.clr(1);
        }
        if (!setvalue(0)) return true;
      }
      cleanup();
      return true;
    };
    // SYNC_EOL: false at the end of the data
    // 0: the end of the data before an EOL's zeros; -1: zeros that run to
    // the end (libtiff then switches to T.4's "no EOL" mode and decodes
    // the strip again from its first bit, into this row and the next)
    auto sync_eol = [&]() -> int {
      if (EOLcnt == 0) {
        for (;;) {
          if (!d.need(11)) return 0;
          if (d.get(11) == 0) break;
          d.clr(1);
        }
      }
      for (;;) {
        if (!d.need(8)) {
          d.noeol = true;
          d.cp = data;
          d.acc = 0;
          d.avail = 0;
          EOLcnt = 0;
          return -1;
        }
        if (d.get(8)) break;
        d.clr(8);
      }
      while (d.get(1) == 0) d.clr(1);
      d.clr(1);
      EOLcnt = 0;
      return 1;
    };

    bool ok = true;
    if (mode == 0 || mode == 4) {          // Fax3DecodeRLE
      ok = expand1d();
      if (overflow) return -1;
      if (!ok) {
        fill_runs(buf, thisrun, pa, lastx);
        written[row] = 1;
        return -1;
      }
      fill_runs(buf, thisrun, pa, lastx);
      written[row] = 1;
      if (mode == 0) {                     // byte-align each row
        d.clr(d.avail - (d.avail & ~7));
      } else {                             // RLEW: word-align each row
        d.clr(d.avail - (d.avail & ~15));
        if (d.avail == 0 && ((d.cp - data) & 1)) ++d.cp;
      }
    } else if (mode == 1) {                // Fax3Decode1D
      if (!d.noeol && sync_eol() == 0) {
        cleanup();
        fill_runs(buf, thisrun, pa, lastx);
        written[row] = 1;
        return -1;
      }
      ok = expand1d();
      if (overflow) return -1;
      fill_runs(buf, thisrun, pa, lastx);
      written[row] = 1;
      if (!ok) return -1;
    } else if (mode == 2) {                // Fax3Decode2D
      if ((!d.noeol && sync_eol() == 0) || !d.need(1)) {
        cleanup();
        fill_runs(buf, thisrun, pa, lastx);
        written[row] = 1;
        return -1;
      }
      int is1d = (int)d.get(1);
      d.clr(1);
      pb = refruns;
      b1 = *pb++;
      ok = is1d ? expand1d() : expand2d();
      if (overflow) return -1;
      fill_runs(buf, thisrun, pa, lastx);
      written[row] = 1;
      if (!ok) return -1;
      if (pa < thisrun + nruns) {
        if (!setvalue(0)) return -1;
      }
      uint32_t* t = curruns;
      curruns = refruns;
      refruns = t;
    } else {                               // Fax4Decode
      pb = refruns;
      b1 = *pb++;
      ok = expand2d();
      if (overflow) return -1;
      if (ok && !EOLcnt) {
        fill_runs(buf, thisrun, pa, lastx);
        written[row] = 1;
        if (!setvalue(0)) return -1;
        uint32_t* t = curruns;
        curruns = refruns;
        refruns = t;
      } else {
        // EOFB or the end of the data: the row so far, then stop
        if (d.need(13)) {}
        d.clr(13);
        fill_runs(buf, thisrun, pa, lastx);
        written[row] = 1;
        return line ? 1 : -1;
      }
    }
    buf += rowbytes;
    ++line;
  }
  return 1;
}

}  // extern "C"
