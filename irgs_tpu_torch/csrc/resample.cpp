// Lanczos resampling of 8-bit and 16-bit bands, for
// irgs_tpu_torch/utils/resize.py, as Pillow's Resample.c computes
// Image.resize(..., LANCZOS):
//   precompute_coeffs      the Lanczos-3 filter (sinc(x) sinc(x / 3) on
//                          [-3, 3)), its support scaled by the downscale
//                          factor, per output pixel the window
//                          [(int)(center - support + 0.5), (int)(center +
//                          support + 0.5)) clamped to the input, weights
//                          normalised to sum 1 in double;
//   8 bits per band        the weights rounded to fixed point with
//                          PRECISION_BITS = 22 (away from zero by sign),
//                          sums from 1 << 21, clip8 of >> 22;
//   16 bits (I;16)         double sums, ROUND_UP, and the low and high
//                          bytes each clipped as CLIP8 does;
//   32 bits (I)            double sums, ROUND_UP to int32 (a sum past
//                          int32's range gives INT_MIN, as x86's
//                          truncating conversion does);
//   the horizontal pass first over the rows the vertical pass reads, then
//   the vertical pass, each only when its size changes.
// Built with g++ at first use; plain C ABI.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const int PRECISION_BITS = 32 - 8 - 2;

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

int precompute_coeffs(int in_size, float in0, float in1, int out_size,
                      std::vector<int>& bounds, std::vector<double>& kk) {
  double scale, filterscale;
  filterscale = scale = static_cast<double>(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 3.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  kk.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = lanczos_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

std::vector<int32_t> normalize_8bpc(const std::vector<double>& pre) {
  std::vector<int32_t> kk(pre.size());
  for (size_t x = 0; x < pre.size(); ++x)
    kk[x] = pre[x] < 0 ? static_cast<int32_t>(-0.5 + pre[x] * (1 << PRECISION_BITS))
                       : static_cast<int32_t>(0.5 + pre[x] * (1 << PRECISION_BITS));
  return kk;
}

inline uint8_t clip8(int32_t in) {
  int32_t v = in >> PRECISION_BITS;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

inline uint8_t clip8_int(int v) {
  return static_cast<uint8_t>(v <= 0 ? 0 : v < 256 ? v : 255);
}

inline int round_up(double f) {
  return static_cast<int>(f >= 0.0 ? f + 0.5F : f - 0.5F);
}

inline int32_t round_up_32(double f) {
  const double t = f >= 0.0 ? f + 0.5F : f - 0.5F;
  if (!(t > -2147483649.0 && t < 2147483648.0)) return INT32_MIN;
  return static_cast<int32_t>(t);
}

// One pass over uint8 [rows, cols, bands] (kBits 16: bands = 1, samples
// uint16 read as two bytes; kBits 32: bands = 1, int32 samples):
// `horizontal` resamples along cols.
template <int kBits>
void pass(const uint8_t* in, uint8_t* out, int rows_out, int cols_out,
          int cols_in, int bands, int ksize, const std::vector<int>& bounds,
          const std::vector<double>& kd, const std::vector<int32_t>& ki,
          bool horizontal, int offset) {
  const int bpp = kBits == 8 ? bands : kBits / 8;
  for (int yy = 0; yy < rows_out; ++yy) {
    for (int xx = 0; xx < cols_out; ++xx) {
      const int idx = horizontal ? xx : yy;
      const int mn = bounds[idx * 2], n = bounds[idx * 2 + 1];
      const size_t kofs = static_cast<size_t>(idx) * ksize;
      auto src = [&](int t, int b) -> int {
        const int64_t r = horizontal ? yy + offset : mn + t;
        const int64_t c = horizontal ? mn + t : xx;
        return in[(r * cols_in + c) * bpp + b];
      };
      uint8_t* o = out + (static_cast<int64_t>(yy) * cols_out + xx) * bpp;
      if (kBits == 32) {
        auto src32 = [&](int t) -> int32_t {
          const int64_t r = horizontal ? yy + offset : mn + t;
          const int64_t c = horizontal ? mn + t : xx;
          return reinterpret_cast<const int32_t*>(in)[r * cols_in + c];
        };
        double ss = 0.0;
        for (int t = 0; t < n; ++t) ss += src32(t) * kd[kofs + t];
        *reinterpret_cast<int32_t*>(o) = round_up_32(ss);
      } else if (kBits == 16) {
        double ss = 0.0;
        for (int t = 0; t < n; ++t)
          ss += (src(t, 0) + (src(t, 1) << 8)) * kd[kofs + t];
        int s = round_up(ss);
        o[0] = clip8_int(s % 256);
        o[1] = clip8_int(s >> 8);
      } else {
        for (int b = 0; b < bands; ++b) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int t = 0; t < n; ++t) ss += src(t, b) * ki[kofs + t];
          o[b] = clip8(ss);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// in: [in_h, in_w, bands] uint8; bits 16: [in_h, in_w] uint16, little-
// endian, bands = 1; bits 32: [in_h, in_w] int32, bands = 1 -> out
// [out_h, out_w, bands] of the same type. Returns 0.
int resample_lanczos(const uint8_t* in, int in_w, int in_h, int bands,
                     int bits, uint8_t* out, int out_w, int out_h) {
  std::vector<int> bh, bv;
  std::vector<double> kh, kv;
  const int ksh = precompute_coeffs(in_w, 0.0f, static_cast<float>(in_w),
                                    out_w, bh, kh);
  const int ksv = precompute_coeffs(in_h, 0.0f, static_cast<float>(in_h),
                                    out_h, bv, kv);
  const bool need_h = out_w != in_w, need_v = out_h != in_h;
  const std::vector<int32_t> ih = normalize_8bpc(kh), iv = normalize_8bpc(kv);
  const int bpp = bits == 8 ? bands : bits / 8;
  auto pass_of = bits == 32 ? &pass<32> : bits == 16 ? &pass<16> : &pass<8>;
  const int ybox_first = bv[0];
  const int ybox_last = bv[out_h * 2 - 2] + bv[out_h * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* cur = in;
  int cur_h = in_h, cur_w = in_w;
  if (need_h) {
    for (int i = 0; i < out_h; ++i) bv[i * 2] -= ybox_first;
    const int rows = ybox_last - ybox_first;
    tmp.assign(static_cast<size_t>(rows) * out_w * bpp, 0);
    pass_of(in, tmp.data(), rows, out_w, in_w, bands, ksh, bh, kh, ih, true,
            ybox_first);
    cur = tmp.data();
    cur_h = rows;
    cur_w = out_w;
  }
  if (need_v) {
    pass_of(cur, out, out_h, cur_w, cur_w, bands, ksv, bv, kv, iv, false, 0);
  } else {
    const size_t n = static_cast<size_t>(cur_h) * cur_w * bpp;
    for (size_t i = 0; i < n; ++i) out[i] = cur[i];
  }
  return 0;
}

}  // extern "C"
