// S3TC/BCn block decoders, for irgs_tpu_torch/utils/bcn.py: BC1-BC7 as
// libImaging's BcnDecode.c decodes them behind Pillow's "bcn" tile (DDS,
// FTEX), and, with the BLP flag, the DXT1/3/5 colours as
// BlpImagePlugin's own Python decoders compute them (5:6:5 widened by a
// shift, without replicating the top bits).
//
//   BC1  two 5:6:5 colours and 2-bit indices; c0 <= c1 gives three
//        colours and transparent black;
//   BC2  BC1's colours in their four-colour mode, 4-bit alpha (x17);
//   BC3  BC2's colours, interpolated alpha of 6 or 8 values;
//   BC4  one BC3 alpha block as grey;
//   BC5  two of them as red and green; signed (BC5S) each endpoint + 128,
//        blue and alpha filled with 128 (0 unsigned);
//   BC6H the 14 modes (2 or 5 mode bits), endpoints unpacked bit by bit
//        from each mode's layout, sign-extended, delta-decoded (the sums
//        masked to the endpoint's bits, and signed ones not extended again),
//        unquantized, interpolated with BC7's weights, scaled by 31/64
//        (31/32 signed) to a half float, and that float times 255,
//        truncated after clamping to [0, 1];
//   BC7  the 8 modes with their partitions (2 and 3 subsets), anchor
//        indices, p-bits, rotation and index selection; a first byte of 0
//        (no mode bit) decodes as black, alpha 255.
//
// A block that crosses the image's right or bottom edge is clipped. Built
// with g++ at first use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

inline int load16(const uint8_t* p) { return p[0] | (p[1] << 8); }

inline uint32_t load32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

Rgba decode_565(int x, bool blp) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  if (!blp) {
    r |= r >> 5;
    g |= g >> 6;
    b |= b >> 5;
  }
  return Rgba{uint8_t(r), uint8_t(g), uint8_t(b), 0xff};
}

void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha, bool blp) {
  int c0 = load16(src), c1 = load16(src + 2);
  uint32_t lut = load32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0, blp);
  p[1] = decode_565(c1, blp);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
                uint8_t((2 * b0 + b1) / 3), 0xff};
    p[3] = Rgba{uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
                uint8_t((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = Rgba{uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2),
                uint8_t((b0 + b1) / 2), 0xff};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// one BC3 alpha block into byte `o` of each of 16 elements `stride` apart
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o,
               bool sign) {
  int a0 = sign ? int(int8_t(src[0])) + 128 : src[0];
  int a1 = sign ? int(int8_t(src[1])) + 128 : src[1];
  int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++)
    dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

void bc2_block(Rgba* col, const uint8_t* src, bool blp) {
  bc1_color(col, src + 8, true, blp);
  for (int n = 0; n < 16; n++) {
    int bit = n * 4;
    int av = 0xf & (src[bit >> 3] >> (bit & 7));
    col[n].a = uint8_t((av << 4) | av);
  }
}

void bc3_block(Rgba* col, const uint8_t* src, bool blp) {
  bc1_color(col, src + 8, true, blp);
  bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 3, false);
}

// ------------------------------------------------------------------ BC7
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// subset of each pixel: 2 subsets, one bit a pixel
const uint16_t kSi2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

// 3 subsets, two bits a pixel
const uint32_t kSi3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};

// anchor index of the second subset (2 subsets), of the second and third
// (3 subsets)
const uint8_t kAi0[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                          15, 15, 15, 15, 2,  8,  2,  2,  8,  8,  15, 2,  8,
                          2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15,
                          15, 2,  8,  2,  2,  2,  15, 15, 6,  6,  2,  6,  8,
                          15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAi1[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,
                          5,  3,  3,  3,  3,  8,  15, 3,  3,  6,  10, 5,  8,
                          8,  6,  8,  5,  15, 15, 8,  15, 3,  5,  6,  10, 8,
                          15, 15, 3,  15, 5,  15, 15, 15, 15, 3,  15, 5,  5,
                          5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAi2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15,
                          15, 15, 8,  15, 8,  15, 3,  15, 8,  15, 8,  3,  15,
                          6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,
                          10, 6,  15, 8,  15, 3,  6,  6,  8,  15, 3,  15, 15,
                          15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const int kW2[4] = {0, 21, 43, 64};
const int kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int n) { return n == 2 ? kW2 : n == 3 ? kW3 : kW4; }

int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kSi2[partition] >> n);
  if (ns == 3) return 3 & (kSi3[partition] >> (2 * n));
  return 0;
}

int get_bit(const uint8_t* src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

// `count` (<= 8) bits from bit `bit`, least significant first; a field
// ending at bit 127 reads no byte past the block
int get_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  int x = src[by] | (src[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

uint8_t expand_quantized(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | (v >> bits));
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) bit++;
  const Bc7Mode& info = kBc7Modes[bit];
  bit++;
  int cb = info.cb, ab = info.ab;
  const int* cw = weights(info.ib);
  const int* aw = weights((ab && info.ib2) ? info.ib2 : info.ib);
  auto load = [&](int n) {
    int v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  int partition = load(info.pb);
  int rotation = load(info.rb);
  int index_sel = load(info.isb);
  int numep = info.ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; i++) ep[i].r = uint8_t(load(cb));
  for (int i = 0; i < numep; i++) ep[i].g = uint8_t(load(cb));
  for (int i = 0; i < numep; i++) ep[i].b = uint8_t(load(cb));
  for (int i = 0; i < numep; i++) ep[i].a = ab ? uint8_t(load(ab)) : 255;
  auto assign_p = [&](Rgba& e, int v) {
    e.r = uint8_t((e.r << 1) | v);
    e.g = uint8_t((e.g << 1) | v);
    e.b = uint8_t((e.b << 1) | v);
    if (ab) e.a = uint8_t((e.a << 1) | v);
  };
  if (info.epb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) assign_p(ep[i], load(1));
  }
  if (info.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      int v = load(1);
      assign_p(ep[i], v);
      assign_p(ep[i + 1], v);
    }
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit, aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; i++) {
    int s = subset_of(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      ib--;
    } else if (info.ns == 2) {
      if (i == kAi0[partition]) ib--;
    } else if (info.ns == 3) {
      if (i == kAi1[partition] || i == kAi2[partition]) ib--;
    }
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2 - (i == 0);
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t t;
    if (rotation == 1) {
      t = col[i].r; col[i].r = col[i].a; col[i].a = t;
    } else if (rotation == 2) {
      t = col[i].g; col[i].g = col[i].a; col[i].a = t;
    } else if (rotation == 3) {
      t = col[i].b; col[i].b = col[i].a; col[i].a = t;
    }
  }
}

// ------------------------------------------------------------------ BC6H
struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};

const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// each mode's endpoint bits in stream order after its mode bits: 16 *
// field + bit, fields rw gw bw rx gx bx ry gy by rz gz bz (the four
// endpoints' red, green and blue)
const uint8_t kBc6Packing[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}
};

void sign_extend(uint16_t* v, int prec) {
  int x = *v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  *v = uint16_t(x);
}

int unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = int16_t(v);
  if (prec >= 16) return x;
  bool s = x < 0;
  if (s) x = -x;
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1)
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (prec - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | ((-v) * 31) / 32));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t clamp8(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return uint8_t(value * 255.0f);
}

void bc6_lerp(Rgba* col, const int* e0, const int* e1, int s, bool sign) {
  int t = 64 - s;
  col->r = clamp8(finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = clamp8(finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = clamp8(finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int bit = 5, epbits = 75, ib = 3;
  int mode = src[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const int* cw = weights(ib);
  int numep = info.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; i++) {
    int di = kBc6Packing[mode][i];
    ep[di >> 4] |= uint16_t(get_bit(src, bit + i) << (di & 15));
  }
  bit += epbits;
  int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  int mask = (1 << info.epb) - 1;
  if (sign)
    for (int k = 0; k < 3; k++) sign_extend(&ep[k], info.epb);
  if (sign || info.tr) {
    for (int i = 3; i < numep; i += 3) {
      sign_extend(&ep[i], info.rb);
      sign_extend(&ep[i + 1], info.gb);
      sign_extend(&ep[i + 2], info.bb);
    }
  }
  // the sums stay masked to the endpoint's bits, signed or not (no second
  // sign extension, as BcnDecode.c)
  if (info.tr)
    for (int i = 3; i < numep; i++)
      ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  int ueps[12];
  for (int i = 0; i < numep; i++) ueps[i] = unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; i++) {
    int s = subset_of(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0)
      ib2--;
    else if (info.ns == 2 && i == kAi0[partition])
      ib2--;
    int i0 = get_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

}  // namespace

extern "C" {

// `n` (1-7: BC1 ... BC7) blocks of `src` into `out`, an image of w x h
// pixels of 4 bytes (RGBA; 1 byte for BC4), the blocks in rows of
// ceil(w / 4) from the top left, each clipped at the right and bottom
// edges. flags: 1 signed (BC5S, BC6H SF16), 2 BlpImagePlugin's DXT
// colours. Returns the bytes taken, or -1 when `nbytes` holds fewer blocks
// than the image needs (PIL: "image file is truncated"; out is then
// partly written).
int64_t bcn_decode(const uint8_t* src, int64_t nbytes, int n, int flags,
                   int64_t w, int64_t h, uint8_t* out) {
  bool sign = flags & 1, blp = flags & 2;
  int size = (n == 1 || n == 4) ? 8 : 16;
  int px = n == 4 ? 1 : 4;
  int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (nbytes < bw * bh * size) return -1;
  Rgba col[16];
  uint8_t lum[16];
  const uint8_t* p = src;
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++, p += size) {
      const uint8_t* blk;
      switch (n) {
        case 1:
          memset(col, 0, sizeof(col));
          bc1_color(col, p, false, blp);
          break;
        case 2:
          memset(col, 0, sizeof(col));
          bc2_block(col, p, blp);
          break;
        case 3:
          memset(col, 0, sizeof(col));
          bc3_block(col, p, blp);
          break;
        case 4:
          memset(lum, 0, sizeof(lum));
          bc3_alpha(lum, p, 1, 0, false);
          break;
        case 5:
          memset(col, sign ? 128 : 0, sizeof(col));
          bc3_alpha(reinterpret_cast<uint8_t*>(col), p, 4, 0, sign);
          bc3_alpha(reinterpret_cast<uint8_t*>(col), p + 8, 4, 1, sign);
          break;
        case 6:
          memset(col, 0, sizeof(col));
          bc6_block(col, p, sign);
          break;
        default:
          memset(col, 0, sizeof(col));
          bc7_block(col, p);
      }
      blk = n == 4 ? lum : reinterpret_cast<const uint8_t*>(col);
      for (int j = 0; j < 4; j++) {
        int64_t y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; i++) {
          int64_t x = bx * 4 + i;
          if (x >= w) break;
          memcpy(out + (y * w + x) * px, blk + (j * 4 + i) * px, px);
        }
      }
    }
  }
  return p - src;
}

}  // extern "C"
