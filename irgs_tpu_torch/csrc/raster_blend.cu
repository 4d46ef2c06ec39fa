// Per-tile surfel blend, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels irgs_tpu/ops/raster_pallas.py:
//   _make_fwd_kernel (forward, launched by _blend_fwd_call) and
//   _make_bwd_kernel (backward, the custom VJP _blend_bwd).
// The semantics are the Pallas kernels', not renderCUDA's: weights past
// saturation are zeroed (not broken out of), the final T multiplies every
// splat's (1 - alpha) up to the chunk at which the tile stopped, med_ord is
// the position inside the tile's K-aligned range, and the backward writes
// whole dslab columns with no atomics.
//
// Layout (see ops/raster_blend.py): splat is [F, b_pad] f32, column-major per
// duplicate: rows 0:3 Tu | 3:6 Tv | 6:9 Tw | 9:11 center | 11 opacity |
// 12:12+NA attrs (rgb | S features | normal), NA = 6 + S, F = NA + 12 padded
// to 8. Tile t owns columns [starts[t], starts[t] + counts[t]), counts a
// multiple of K = 128. Per-pixel outputs [n_tiles, 256, CO], CO = NA + 9:
// attrs | D | D2 | A | M1 | M2 | dist | med_depth | med_ord | T.
//
// What bounds it on this card: per tile it reads counts[t]·F floats and does
// ~60 fp32 operations (one expf, one log1pf, one division) per pixel x
// splat pair, so at the bench workload (~600k duplicates, 256 pixels each)
// the work is ~1e10 operations against ~60 MB of slab: it is bound by fp32
// operations, not bytes. The design keeps the slab chunk in shared memory
// (F x 128 floats), every accumulator in registers, one thread per pixel,
// and leaves the chunk loop as soon as no pixel of the tile is transmissive.
// The backward adds the per-pair chain to the 12 geometric columns, derived
// by hand, and reduces the 12 + NA per-splat sums over the 256 pixels in a
// fixed order (warp butterflies, then per-warp partials in shared memory
// summed in warp order), so its result is the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int TILE_PIX = TILE * TILE;
constexpr int K = 128;
constexpr int KSUB = 32;  // splats per shared-memory reduction batch
constexpr int NWARP = TILE_PIX / 32;
constexpr unsigned FULL = 0xffffffffu;

// constants rounded from double once, as the reference's weakly typed
// Python floats are
constexpr float NEAR_N = 0.2f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float T_DONE = 1e-4f;
constexpr float M_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)

__host__ __device__ constexpr int slab_width(int na) {
  return ((12 + na + 7) / 8) * 8;
}

// per pixel x splat intermediates of irgs_tpu raster_pallas._alpha_depth
struct Geo {
  float kx, ky, kz, lx, ly, lz;
  float pz, pz_safe, sx, sy, rho3d, rho2d, ddx, ddy, e, a0;
  float alpha, depth, m;
  bool bad;
};

__device__ __forceinline__ void alpha_depth(const float* s, int k, float px,
                                            float py, Geo& g) {
  const float c0 = s[0 * K + k], c1 = s[1 * K + k], c2 = s[2 * K + k];
  const float c3 = s[3 * K + k], c4 = s[4 * K + k], c5 = s[5 * K + k];
  const float c6 = s[6 * K + k], c7 = s[7 * K + k], c8 = s[8 * K + k];
  g.kx = px * c6 - c0;
  g.ky = px * c7 - c1;
  g.kz = px * c8 - c2;
  g.lx = py * c6 - c3;
  g.ly = py * c7 - c4;
  g.lz = py * c8 - c5;
  const float p_x = g.ky * g.lz - g.kz * g.ly;
  const float p_y = g.kz * g.lx - g.kx * g.lz;
  g.pz = g.kx * g.ly - g.ky * g.lx;
  g.pz_safe = (g.pz == 0.0f) ? 1.0f : g.pz;
  g.sx = p_x / g.pz_safe;
  g.sy = p_y / g.pz_safe;
  g.rho3d = g.sx * g.sx + g.sy * g.sy;
  g.ddx = s[9 * K + k] - px;
  g.ddy = s[10 * K + k] - py;
  g.rho2d = FILTER_INV_SQUARE * (g.ddx * g.ddx + g.ddy * g.ddy);
  const float rho = fminf(g.rho3d, g.rho2d);
  g.depth = (g.rho3d <= g.rho2d) ? (g.sx * c6 + g.sy * c7 + c8) : c8;
  g.e = expf(-0.5f * rho);
  g.a0 = s[11 * K + k] * g.e;
  const float a = fminf(0.99f, g.a0);
  g.bad = (g.pz == 0.0f) || (g.depth < NEAR_N) || (a < ALPHA_EPS);
  g.alpha = g.bad ? 0.0f : a;
  g.m = M_SCALE * (1.0f - NEAR_N / fmaxf(g.depth, 1e-6f));
}

// d(min(x, y))/dx with JAX's tie rule (half to each side)
__device__ __forceinline__ float min_grad(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// hand-derived VJP of alpha_depth: cotangents on (alpha, depth, m) -> the
// 12 geometric slab columns
__device__ __forceinline__ void alpha_depth_vjp(const Geo& g, const float* s,
                                                int k, float px, float py,
                                                float dA, float dDep, float dM,
                                                float* d) {
  const float c6 = s[6 * K + k], c7 = s[7 * K + k];
#pragma unroll
  for (int j = 0; j < 12; ++j) d[j] = 0.0f;
  // m = M_SCALE * (1 - NEAR / max(depth, 1e-6))
  if (g.depth > 1e-6f) dDep += dM * M_SCALE * NEAR_N / (g.depth * g.depth);
  // alpha = bad ? 0 : min(0.99, o * exp(-rho / 2))
  const float da0 = g.bad ? 0.0f : dA * min_grad(g.a0, 0.99f);
  d[11] = da0 * g.e;
  const float drho = -0.5f * (da0 * s[11 * K + k]) * g.e;
  const float drho3 = drho * min_grad(g.rho3d, g.rho2d);
  const float drho2 = drho * min_grad(g.rho2d, g.rho3d);
  // depth = use3d ? sx*Tw0 + sy*Tw1 + Tw2 : Tw2
  float dsx = 2.0f * g.sx * drho3, dsy = 2.0f * g.sy * drho3;
  if (g.rho3d <= g.rho2d) {
    dsx += dDep * c6;
    dsy += dDep * c7;
    d[6] += dDep * g.sx;
    d[7] += dDep * g.sy;
  }
  d[8] += dDep;
  // rho2d = 2 * (dx^2 + dy^2), dx = center - pixel
  d[9] += 2.0f * FILTER_INV_SQUARE * g.ddx * drho2;
  d[10] += 2.0f * FILTER_INV_SQUARE * g.ddy * drho2;
  // (sx, sy) = (p_x, p_y) / pz_safe
  const float dpx = dsx / g.pz_safe;
  const float dpy = dsy / g.pz_safe;
  const float dpz = (g.pz == 0.0f) ? 0.0f
                                   : -(dsx * g.sx + dsy * g.sy) / g.pz_safe;
  // p = k x l
  float dkx = 0.0f, dky = 0.0f, dkz = 0.0f, dlx = 0.0f, dly = 0.0f,
        dlz = 0.0f;
  dky += dpx * g.lz; dlz += dpx * g.ky; dkz -= dpx * g.ly; dly -= dpx * g.kz;
  dkz += dpy * g.lx; dlx += dpy * g.kz; dkx -= dpy * g.lz; dlz -= dpy * g.kx;
  dkx += dpz * g.ly; dly += dpz * g.kx; dky -= dpz * g.lx; dlx -= dpz * g.ky;
  // k = px * Tw - Tu, l = py * Tw - Tv
  d[0] = -dkx; d[1] = -dky; d[2] = -dkz;
  d[3] = -dlx; d[4] = -dly; d[5] = -dlz;
  d[6] += px * dkx + py * dlx;
  d[7] += px * dky + py * dly;
  d[8] += px * dkz + py * dlz;
}

template <int F>
__device__ __forceinline__ void load_chunk(float* slab, const float* splat,
                                           long long b_pad, long long col0) {
  for (int e = threadIdx.x; e < F * K; e += TILE_PIX) {
    const int j = e / K, k = e % K;
    slab[e] = splat[(long long)j * b_pad + col0 + k];
  }
}

template <int NA>
__global__ void __launch_bounds__(TILE_PIX)
blend_fwd_kernel(const float* __restrict__ splat, const int* __restrict__ starts,
                 const int* __restrict__ counts, float* __restrict__ out,
                 int grid_x, long long b_pad) {
  constexpr int F = slab_width(NA);
  constexpr int CO = NA + 9;
  __shared__ float slab[F * K];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const long long start = starts[t];
  const int n_chunks = counts[t] / K;
  const float px = (float)((t % grid_x) * TILE + i % TILE);
  const float py = (float)((t / grid_x) * TILE + i / TILE);

  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
  float D = 0.0f, D2 = 0.0f, A = 0.0f, M1 = 0.0f, M2 = 0.0f, dist = 0.0f;
  float med_d = 0.0f, med_o = -1.0f, T = 1.0f;

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    load_chunk<F>(slab, splat, b_pad, start + (long long)c * K);
    __syncthreads();
    const float T_tile = T;
    float cum = 0.0f;  // sum of log1p(-alpha) over the chunk so far
    for (int k = 0; k < K; ++k) {
      Geo g;
      alpha_depth(slab, k, px, py, g);
      const float lg = log1pf(-g.alpha);
      const float T_in = T_tile * expf(cum);
      cum += lg;
      float w = g.alpha * T_in;
      if (T_in * (1.0f - g.alpha) < T_DONE) w = 0.0f;
      if (w == 0.0f) continue;
      // median depth: last contributing splat with incoming T > 0.5
      if (T_in > 0.5f) {
        med_o = (float)(c * K + k);
        med_d = g.depth;
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] += w * slab[(12 + a) * K + k];
      const float mw = g.m * w;
      const float m2w = g.m * mw;
      // distortion sum_{j<k} w_j w_k (m_k - m_j)^2 against the running
      // totals of every earlier splat of the tile
      dist += g.m * g.m * w * A + w * M2 - 2.0f * g.m * w * M1;
      D += w * g.depth;
      D2 += w * g.depth * g.depth;
      A += w;
      M1 += mw;
      M2 += m2w;
    }
    T = T_tile * expf(cum);
    if (!__syncthreads_or(T > T_DONE)) break;
  }

  float* o = out + ((long long)t * TILE_PIX + i) * CO;
#pragma unroll
  for (int a = 0; a < NA; ++a) o[a] = acc[a];
  o[NA] = D;
  o[NA + 1] = D2;
  o[NA + 2] = A;
  o[NA + 3] = M1;
  o[NA + 4] = M2;
  o[NA + 5] = dist;
  o[CO - 3] = med_d;
  o[CO - 2] = med_o;
  o[CO - 1] = T;
}

template <int NA>
__global__ void __launch_bounds__(TILE_PIX)
blend_bwd_kernel(const float* __restrict__ splat, const int* __restrict__ starts,
                 const int* __restrict__ counts, const float* __restrict__ fwd_out,
                 const float* __restrict__ cot, float* __restrict__ dslab,
                 int grid_x, long long b_pad) {
  constexpr int F = slab_width(NA);
  constexpr int CO = NA + 9;
  constexpr int NG = 12 + NA;  // dslab rows written: geometry + attrs
  __shared__ float slab[F * K];
  __shared__ float red[NWARP][NG][KSUB];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const long long start = starts[t];
  const int n_chunks = counts[t] / K;
  const float px = (float)((t % grid_x) * TILE + i % TILE);
  const float py = (float)((t / grid_x) * TILE + i / TILE);

  const float* fo = fwd_out + ((long long)t * TILE_PIX + i) * CO;
  const float* ct = cot + ((long long)t * TILE_PIX + i) * CO;
  const float A_tot = fo[NA + 2], M1_tot = fo[NA + 3], M2_tot = fo[NA + 4];
  const float med_ord = fo[CO - 2], T_final = fo[CO - 1];
  float g_attrs[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) g_attrs[a] = ct[a];
  const float g_D = ct[NA], g_D2 = ct[NA + 1], g_A = ct[NA + 2];
  const float g_M1 = ct[NA + 3], g_M2 = ct[NA + 4], g_dist = ct[NA + 5];
  const float g_med = ct[CO - 3], g_T = ct[CO - 1];
  // cot[CO - 2] (med_ord, an index) carries no gradient

  auto dLdw_of = [&](const Geo& g, int k) {
    float s = 0.0f;
#pragma unroll
    for (int a = 0; a < NA; ++a) s += g_attrs[a] * slab[(12 + a) * K + k];
    return s + g_D * g.depth + g_D2 * g.depth * g.depth + g_A + g_M1 * g.m +
           g_M2 * g.m * g.m +
           g_dist * (g.m * g.m * A_tot + M2_tot - 2.0f * g.m * M1_tot);
  };

  // pass A: S_tot = sum_k w_k dL/dw_k
  float T_carry = 1.0f, S_tot = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    load_chunk<F>(slab, splat, b_pad, start + (long long)c * K);
    __syncthreads();
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      Geo g;
      alpha_depth(slab, k, px, py, g);
      const float lg = log1pf(-g.alpha);
      const float T_in = T_carry * expf(cum);
      cum += lg;
      if (T_in * (1.0f - g.alpha) < T_DONE) continue;
      S_tot += g.alpha * T_in * dLdw_of(g, k);
    }
    T_carry = T_carry * expf(cum);
    // once no pixel is transmissive, no later splat is live: its weight,
    // dalpha and median term are all zero (its dslab column stays zero)
    if (!__syncthreads_or(T_carry > T_DONE)) break;
  }

  // pass B: per-duplicate gradients, dL/dalpha_k =
  //   T_k dL/dw_k - (sum_{j>k} w_j dL/dw_j + g_T T_final) / (1 - alpha_k)
  T_carry = 1.0f;
  float pref = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    load_chunk<F>(slab, splat, b_pad, start + (long long)c * K);
    __syncthreads();
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      Geo g;
      alpha_depth(slab, k, px, py, g);
      const float lg = log1pf(-g.alpha);
      const float T_in = T_carry * expf(cum);
      cum += lg;
      const bool live = T_in * (1.0f - g.alpha) >= T_DONE;
      const float w = live ? g.alpha * T_in : 0.0f;
      float grad[NG];
      float dalpha = 0.0f, ddepth = 0.0f, dm = 0.0f;
      if (live) {
        const float dLdw = dLdw_of(g, k);
        pref += w * dLdw;
        if (g.alpha > 0.0f) {
          const float one_m = fmaxf(1.0f - g.alpha, 1e-6f);
          dalpha = T_in * dLdw - (S_tot - pref) / one_m - g_T * T_final / one_m;
        }
        ddepth = w * (g_D + 2.0f * g.depth * g_D2);
        dm = w * (g_dist * (2.0f * g.m * A_tot - 2.0f * M1_tot) + g_M1 +
                  2.0f * g.m * g_M2);
      }
      // the median-depth gradient goes to the median contributor only
      if ((float)(c * K + k) == med_ord) ddepth += g_med;
      if (dalpha != 0.0f || ddepth != 0.0f || dm != 0.0f) {
        alpha_depth_vjp(g, slab, k, px, py, dalpha, ddepth, dm, grad);
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) grad[j] = 0.0f;
      }
      bool nz = false;
#pragma unroll
      for (int j = 0; j < 12; ++j) nz |= grad[j] != 0.0f;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        grad[12 + a] = g_attrs[a] * w;
        nz |= grad[12 + a] != 0.0f;
      }
      const int kk = k % KSUB;
      if (__any_sync(FULL, nz)) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          float v = grad[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
          if (lane == 0) red[warp][j][kk] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int j = 0; j < NG; ++j) red[warp][j][kk] = 0.0f;
      }
      if (kk == KSUB - 1) {
        __syncthreads();
        const long long col0 = start + (long long)c * K + (k - kk);
        for (int e = i; e < NG * KSUB; e += TILE_PIX) {
          const int j = e / KSUB, q = e % KSUB;
          float s = 0.0f;
#pragma unroll
          for (int w8 = 0; w8 < NWARP; ++w8) s += red[w8][j][q];
          dslab[(long long)j * b_pad + col0 + q] = s;
        }
        __syncthreads();
      }
    }
    T_carry = T_carry * expf(cum);
    if (!__syncthreads_or(T_carry > T_DONE)) break;
  }
}

template <int NA>
int launch_fwd(const float* splat, const int* starts, const int* counts,
               float* out, int n_tiles, int grid_x, long long b_pad,
               cudaStream_t stream) {
  blend_fwd_kernel<NA><<<n_tiles, TILE_PIX, 0, stream>>>(
      splat, starts, counts, out, grid_x, b_pad);
  return (int)cudaGetLastError();
}

template <int NA>
int launch_bwd(const float* splat, const int* starts, const int* counts,
               const float* fwd_out, const float* cot, float* dslab,
               int n_tiles, int grid_x, long long b_pad, cudaStream_t stream) {
  blend_bwd_kernel<NA><<<n_tiles, TILE_PIX, 0, stream>>>(
      splat, starts, counts, fwd_out, cot, dslab, grid_x, b_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or -1 for an unsupported S.
int irgs_blend_fwd(const float* splat, const int* starts, const int* counts,
                   float* out, int n_tiles, int grid_x, long long b_pad, int S,
                   void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 0: return launch_fwd<6>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 1: return launch_fwd<7>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 2: return launch_fwd<8>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 3: return launch_fwd<9>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 4: return launch_fwd<10>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 5: return launch_fwd<11>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 6: return launch_fwd<12>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 7: return launch_fwd<13>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    case 8: return launch_fwd<14>(splat, starts, counts, out, n_tiles, grid_x, b_pad, st);
    default: return -1;
  }
}

int irgs_blend_bwd(const float* splat, const int* starts, const int* counts,
                   const float* fwd_out, const float* cot, float* dslab,
                   int n_tiles, int grid_x, long long b_pad, int S,
                   void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 0: return launch_bwd<6>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 1: return launch_bwd<7>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 2: return launch_bwd<8>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 3: return launch_bwd<9>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 4: return launch_bwd<10>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 5: return launch_bwd<11>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 6: return launch_bwd<12>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 7: return launch_bwd<13>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 8: return launch_bwd<14>(splat, starts, counts, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    default: return -1;
  }
}

}  // extern "C"
