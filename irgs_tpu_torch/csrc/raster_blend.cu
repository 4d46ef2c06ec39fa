// Per-tile surfel blend, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels irgs_tpu/ops/raster_pallas.py:
//   _make_fwd_kernel (forward, launched by _blend_fwd_call) and
//   _make_bwd_kernel (backward, the custom VJP _blend_bwd).
// The semantics are the Pallas kernels', not renderCUDA's: weights past
// saturation are zeroed (not broken out of), the tile stops after the first
// whole chunk of K splats at which no pixel has T > 1e-4, the final T
// multiplies every splat's (1 - alpha) up to that chunk, med_ord is the
// position inside the tile's K-aligned range of the last contributor with
// incoming T > 0.5, and the backward writes whole dslab columns in a fixed
// order with no atomics (the same bits on every run).
//
// Layout (see ops/raster_blend.py): splat is [F, b_pad] f32, column-major per
// duplicate: rows 0:3 Tu | 3:6 Tv | 6:9 Tw | 9:11 center | 11 opacity |
// 12:12+NA attrs (rgb | S features | normal), NA = 6 + S, F = NA + 12 padded
// to 8. Tile t owns columns [starts[t], starts[t] + counts[t]), counts a
// multiple of K = 128. Per-pixel outputs [n_tiles, 256, CO], CO = NA + 9:
// attrs | D | D2 | A | M1 | M2 | dist | med_depth | med_ord | T.
//
// What bounds it on this card. Counted over every pixel x splat pair, the
// work (~100 fp32 operations a pair forward, ~300 backward) is far above
// the bytes (4·F per splat, shared by 256 pixels), so the yardstick is fp32
// operations. But the work is neither even nor dense. A tile's chunks run
// in order, one tile per block, and at the bench slab the heaviest tile
// blends 11 chunks, about the average SM's share of all 1317: the kernels
// are held to that tile's chain of steps, a latency the 8 warps of a
// one-thread-per-pixel block cannot hide. And most steps do nothing: ~11 %
// of the pairs have alpha > 0, and ~66 % of the (warp, splat) steps have
// none.
//
// What the design does about it:
// - An exact cull: alpha >= 1/255 needs rho <= 2 ln(255·o), so each splat
//   gets that bound as its chunk arrives (with a 1e-3 margin, far above the
//   rounding of either side), and a pair whose rho2d and rho3d (tested as
//   |p_xy|^2 > bound·pz^2, without the division) both exceed it has alpha =
//   0. A warp whose 32 pairs are all culled skips the step; a lane with
//   alpha == 0 skips the rest of it, which changes nothing (log1p(-0) = -0,
//   w = 0). The division, exp, log1p and moments run for live pairs only,
//   with one reciprocal shared by sx and sy.
// - More warps on a tile, forward: each chunk's splats are split into 4
//   sub-ranges, one group of 256 threads each. A first step sums each
//   sub-range's log-transmittance and marks its live steps; the sub-ranges
//   then blend with the right incoming T and are combined in order, as the
//   Pallas kernel combines chunks. (The same split of the backward, in two,
//   measured slower: its third step, the gradients, is the same work, and
//   the first two add to it; see PERF.md.)
// - Tiles start heaviest first (a permutation of the tiles by slab count,
//   made by the wrapper), so the longest chain does not start last.
// - Chunks are double-buffered in shared memory with cp.async, splat-major,
//   so a splat's 12 geometric values are three broadcast float4 loads.
// - The backward needs no replay for Σ_k w_k dL/dw_k: dL/dw is linear in
//   what the forward summed, so per pixel it is
//   S = Σ_a g_a·acc_a + g_D·D + g_D2·D2 + g_A·A + g_M1·M1 + g_M2·M2
//       + 2·g_dist·(A·M2 − M1²),
//   from fwd_out and the cotangent.
// - The backward reduces the 12 + NA per-splat sums over a warp's 32 pixels
//   with one reduce-scatter (31 shuffles: lane j ends with sum j) instead of
//   a butterfly per sum, for live steps only; the 8 warps' partials are
//   summed in warp order in shared memory every 32 splats. No atomics.

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

// backward reduction rows per (warp, splat): odd, so that both the warps'
// writes (one sum per lane) and the final column sums are free of bank
// conflicts
__host__ __device__ constexpr int red_stride(int na) { return (12 + na) | 1; }

// The forward splits each chunk's K splats into FWD_SPLIT sub-ranges, one
// group of 256 threads (a thread per pixel) each; see blend_fwd_kernel.
constexpr int FWD_SPLIT = 4;
constexpr int FWD_THREADS = FWD_SPLIT * TILE_PIX;
// partial sums a sub-range hands on: attrs | D D2 A M1 M2 dist | med_o med_d
__host__ __device__ constexpr int n_moments(int na) { return na + 8; }

// A chunk in shared memory is splat-major: splat k's F slab values at
// k·FS, then its cull bound at k·FS + F, with FS = F + 4 so that each splat
// starts on 16 bytes and its 12 geometric values are three float4 loads
// (all lanes of a warp read the same splat: one broadcast each).
__host__ __device__ constexpr int splat_stride(int na) {
  return slab_width(na) + 4;
}

// dynamic shared memory, in floats: two chunks; the forward's
// per-sub-range log-transmittance and moments, the backward's per-warp
// partial sums of a KSUB batch
__host__ __device__ constexpr int fwd_smem_floats(int na) {
  return 2 * K * splat_stride(na) + FWD_SPLIT * TILE_PIX +
         (FWD_SPLIT - 1) * n_moments(na) * TILE_PIX;
}
__host__ __device__ constexpr int bwd_smem_floats(int na) {
  return 2 * K * splat_stride(na) + NWARP * KSUB * red_stride(na);
}

// ---------------------------------------------------------------------------
// chunk copies: cp.async into the idle buffer while the other is blended

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the prefetch of the next chunk) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// issue the copy of chunk columns [col0, col0 + K) of all F rows into dst,
// splat-major (one commit group). Neighbouring threads read neighbouring
// columns of a row.
template <int F, int FS>
__device__ __forceinline__ void issue_chunk(float* dst, const float* splat,
                                            long long b_pad, long long col0) {
  for (int e = threadIdx.x; e < F * K; e += blockDim.x) {
    const int j = e / K, k = e % K;
    cp_async4(dst + k * FS + j, splat + (long long)j * b_pad + col0 + k);
  }
  cp_async_commit();
}

// per splat: the rho above which its alpha is certainly below 1/255
// (alpha >= 1/255 needs o·exp(-rho/2) >= 1/255, i.e. rho <= 2 ln(255·o)).
// The margin (1e-3, relative and absolute) is far above the few ulps by
// which the exact test and the cull test round apart. A NaN bound culls
// nothing; an opacity at or below zero culls everything but pz = 0.
__device__ __forceinline__ float cull_bound(float o) {
  const float r = 2.0f * logf(255.0f * o);
  if (r != r) return r;
  return r < -1.0f ? -1.0f : r + 1e-3f * fabsf(r) + 1e-3f;
}

// Make chunk c of the tile resident in its buffer, start the copy of chunk
// c + 1 into the other, and write each splat's cull bound beside it. Every
// thread of the block calls it; on return the chunk is visible to all. The
// buffer the prefetch overwrites was last read before the previous chunk's
// closing __syncthreads_or.
template <int F, int FS>
__device__ __forceinline__ const float* next_chunk(float* smem,
                                                   const float* splat,
                                                   long long b_pad,
                                                   long long start, int c,
                                                   int n_chunks) {
  if (c + 1 < n_chunks) {
    issue_chunk<F, FS>(smem + ((c + 1) & 1) * K * FS, splat, b_pad,
                       start + (long long)(c + 1) * K);
  } else {
    cp_async_commit();  // an empty group keeps the wait count uniform
  }
  cp_async_wait_one();
  __syncthreads();
  float* slab = smem + (c & 1) * K * FS;
  if (threadIdx.x < K) {
    float* sp = slab + threadIdx.x * FS;
    sp[F] = cull_bound(sp[11]);
  }
  __syncthreads();
  return slab;
}

// ---------------------------------------------------------------------------
// per pixel x splat geometry (irgs_tpu raster_pallas._alpha_depth), in two
// parts: the cull test, then the rest for warps with a possibly live pair

struct Geo {
  float tw0, tw1, tw2, o;  // slab rows 6:9 and 11 of the splat
  float kx, ky, kz, lx, ly, lz, p_x, p_y, pz;
  float ddx, ddy, rho2d;
  float inv_pz, sx, sy, rho3d, e, a0, alpha, depth;
  bool bad;
};

// k, l, their cross product and rho2d of splat sp (its chunk entry) at the
// pixel; returns false when alpha is certainly 0 (rho2d and rho3d both
// above the splat's bound, stored at sp[F])
template <int F>
__device__ __forceinline__ bool geo_cull(const float* sp, float px, float py,
                                         Geo& g) {
  const float4 u = reinterpret_cast<const float4*>(sp)[0];
  const float4 v = reinterpret_cast<const float4*>(sp)[1];
  const float4 w = reinterpret_cast<const float4*>(sp)[2];
  const float bound = sp[F];
  g.tw0 = v.z;
  g.tw1 = v.w;
  g.tw2 = w.x;
  g.o = w.w;
  g.kx = px * g.tw0 - u.x;
  g.ky = px * g.tw1 - u.y;
  g.kz = px * g.tw2 - u.z;
  g.lx = py * g.tw0 - u.w;
  g.ly = py * g.tw1 - v.x;
  g.lz = py * g.tw2 - v.y;
  g.p_x = g.ky * g.lz - g.kz * g.ly;
  g.p_y = g.kz * g.lx - g.kx * g.lz;
  g.pz = g.kx * g.ly - g.ky * g.lx;
  g.ddx = w.y - px;
  g.ddy = w.z - py;
  g.rho2d = FILTER_INV_SQUARE * (g.ddx * g.ddx + g.ddy * g.ddy);
  const bool far2d = g.rho2d > bound;
  const bool far3d = g.p_x * g.p_x + g.p_y * g.p_y > bound * (g.pz * g.pz);
  return !(far2d && far3d);
}

__device__ __forceinline__ void geo_finish(Geo& g) {
  const float pz_safe = (g.pz == 0.0f) ? 1.0f : g.pz;
  g.inv_pz = 1.0f / pz_safe;
  g.sx = g.p_x * g.inv_pz;
  g.sy = g.p_y * g.inv_pz;
  g.rho3d = g.sx * g.sx + g.sy * g.sy;
  const float rho = fminf(g.rho3d, g.rho2d);
  g.depth = (g.rho3d <= g.rho2d) ? (g.sx * g.tw0 + g.sy * g.tw1 + g.tw2)
                                 : g.tw2;
  g.e = expf(-0.5f * rho);
  g.a0 = g.o * g.e;
  const float a = fminf(0.99f, g.a0);
  g.bad = (g.pz == 0.0f) || (g.depth < NEAR_N) || (a < ALPHA_EPS);
  g.alpha = g.bad ? 0.0f : a;
}

__device__ __forceinline__ float m_of(float depth) {
  return M_SCALE * (1.0f - NEAR_N / fmaxf(depth, 1e-6f));
}

// d(min(x, y))/dx with JAX's tie rule (half to each side)
__device__ __forceinline__ float min_grad(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// hand-derived VJP of the geometry: cotangents on (alpha, depth, m) -> the
// 12 geometric slab columns, written to d[0:12]
__device__ __forceinline__ void alpha_depth_vjp(const Geo& g, float px,
                                                float py, float dA, float dDep,
                                                float dM, float* d) {
#pragma unroll
  for (int j = 0; j < 12; ++j) d[j] = 0.0f;
  // m = M_SCALE * (1 - NEAR / max(depth, 1e-6))
  if (g.depth > 1e-6f) dDep += dM * M_SCALE * NEAR_N / (g.depth * g.depth);
  // alpha = bad ? 0 : min(0.99, o * exp(-rho / 2))
  const float da0 = g.bad ? 0.0f : dA * min_grad(g.a0, 0.99f);
  d[11] = da0 * g.e;
  const float drho = -0.5f * (da0 * g.o) * g.e;
  const float drho3 = drho * min_grad(g.rho3d, g.rho2d);
  const float drho2 = drho * min_grad(g.rho2d, g.rho3d);
  // depth = use3d ? sx*Tw0 + sy*Tw1 + Tw2 : Tw2
  float dsx = 2.0f * g.sx * drho3, dsy = 2.0f * g.sy * drho3;
  if (g.rho3d <= g.rho2d) {
    dsx += dDep * g.tw0;
    dsy += dDep * g.tw1;
    d[6] += dDep * g.sx;
    d[7] += dDep * g.sy;
  }
  d[8] += dDep;
  // rho2d = 2 * (dx^2 + dy^2), dx = center - pixel
  d[9] += 2.0f * FILTER_INV_SQUARE * g.ddx * drho2;
  d[10] += 2.0f * FILTER_INV_SQUARE * g.ddy * drho2;
  // (sx, sy) = (p_x, p_y) / pz_safe
  const float dpx = dsx * g.inv_pz;
  const float dpy = dsy * g.inv_pz;
  const float dpz = (g.pz == 0.0f) ? 0.0f
                                   : -(dsx * g.sx + dsy * g.sy) * g.inv_pz;
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

// One halving round of the reduce-scatter below: lanes with bit H set keep
// the upper half of v[0:2H], the others the lower half, and each adds the
// half its partner sent.
template <int H>
__device__ __forceinline__ void reduce_scatter_round(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Reduce-scatter of 32 values over the warp: lane j returns the warp's sum
// of v[j]. Five rounds, 16 + 8 + 4 + 2 + 1 shuffles; the order of every
// addition is fixed, so the result is the same on every run.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_round<16>(v, lane);
  reduce_scatter_round<8>(v, lane);
  reduce_scatter_round<4>(v, lane);
  reduce_scatter_round<2>(v, lane);
  reduce_scatter_round<1>(v, lane);
  return v[0];
}

// ---------------------------------------------------------------------------

// One block per tile, FWD_SPLIT x 256 threads: thread (q, pixel) takes
// splats [q·KS, (q+1)·KS) of each chunk, KS = K / FWD_SPLIT, so the heaviest
// tile has FWD_SPLIT times the warps to hide its latency. A chunk runs in
// three steps, as the Pallas kernel combines chunks:
//  1. each thread sums log1p(-alpha) over its sub-range (the cull skips dead
//     warps) and marks the steps where its warp has a live pair;
//  2. with the incoming T from the earlier sub-ranges' sums, it blends the
//     marked steps into its own moments (group 0 into the tile's running
//     totals, the others from zero);
//  3. group 0 folds in the later sub-ranges in order: their moments, their
//     distortion with the cross term against the totals before them
//     (raster_pallas.py:202-203), and their median candidate, which wins.
template <int NA>
__global__ void __launch_bounds__(FWD_THREADS)
blend_fwd_kernel(const float* __restrict__ splat, const int* __restrict__ starts,
                 const int* __restrict__ counts,
                 const long long* __restrict__ order, float* __restrict__ out,
                 int grid_x, long long b_pad) {
  constexpr int F = slab_width(NA);
  constexpr int FS = splat_stride(NA);
  constexpr int CO = NA + 9;
  constexpr int KS = K / FWD_SPLIT;
  constexpr int NM = n_moments(NA);
  static_assert(KS <= 64, "one bit per sub-range step");
  extern __shared__ __align__(16) float smem[];
  float* part = smem + 2 * K * FS;           // [FWD_SPLIT][256]
  float* mom = part + FWD_SPLIT * TILE_PIX;  // [FWD_SPLIT - 1][NM][256]
  const int t = (int)order[blockIdx.x];  // heaviest tiles first
  const int pix = threadIdx.x % TILE_PIX, q = threadIdx.x / TILE_PIX;
  const long long start = starts[t];
  const int n_chunks = counts[t] / K;
  const float px = (float)((t % grid_x) * TILE + pix % TILE);
  const float py = (float)((t / grid_x) * TILE + pix / TILE);

  // group 0: the tile's running totals; the others: their sub-range's
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
  float D = 0.0f, D2 = 0.0f, A = 0.0f, M1 = 0.0f, M2 = 0.0f, dist = 0.0f;
  float med_d = 0.0f, med_o = -1.0f, T = 1.0f;

  if (n_chunks > 0) issue_chunk<F, FS>(smem, splat, b_pad, start);
  for (int c = 0; c < n_chunks; ++c) {
    const float* slab = next_chunk<F, FS>(smem, splat, b_pad, start, c,
                                          n_chunks);
    // 1. the sub-range's sum of log1p(-alpha); alpha == 0 adds -0
    float cum = 0.0f;
    unsigned long long live = 0;
    for (int j = 0; j < KS; ++j) {
      Geo g;
      if (!__any_sync(FULL, geo_cull<F>(slab + (q * KS + j) * FS, px, py, g)))
        continue;
      geo_finish(g);
      if (__any_sync(FULL, g.alpha != 0.0f)) live |= 1ull << j;
      if (g.alpha != 0.0f) cum += log1pf(-g.alpha);
    }
    part[q * TILE_PIX + pix] = cum;
    __syncthreads();
    float before = 0.0f, total = 0.0f;  // summed in sub-range order
#pragma unroll
    for (int r = 0; r < FWD_SPLIT; ++r) {
      if (r == q) before = total;
      total += part[r * TILE_PIX + pix];
    }

    // 2. blend the live steps of the sub-range
    if (q > 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
      D = D2 = A = M1 = M2 = dist = 0.0f;
      med_o = -1.0f;
    }
    const float T_tile = T;
    cum = before;  // sum of log1p(-alpha) over the chunk so far
    while (live) {
      const int k = q * KS + __ffsll((long long)live) - 1;
      live &= live - 1;
      const float* sp = slab + k * FS;
      Geo g;
      geo_cull<F>(sp, px, py, g);
      geo_finish(g);
      // alpha == 0 changes nothing: log1p(-0) = -0 and w = 0
      if (g.alpha == 0.0f) continue;
      const float T_in = T_tile * expf(cum);
      cum += log1pf(-g.alpha);
      if (T_in * (1.0f - g.alpha) < T_DONE) continue;
      const float w = g.alpha * T_in;
      // median depth: last contributing splat with incoming T > 0.5
      if (T_in > 0.5f) {
        med_o = (float)(c * K + k);
        med_d = g.depth;
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] += w * sp[12 + a];
      const float m = m_of(g.depth);
      const float mw = m * w;
      const float m2w = m * mw;
      // distortion sum_{j<k} w_j w_k (m_k - m_j)^2 against the running
      // totals of every earlier splat of the tile (of the sub-range, for
      // q > 0; step 3 adds the cross term)
      dist += m * m * w * A + w * M2 - 2.0f * m * w * M1;
      D += w * g.depth;
      D2 += w * g.depth * g.depth;
      A += w;
      M1 += mw;
      M2 += m2w;
    }

    // 3. group 0 folds in the later sub-ranges
    if (q > 0) {
      float* mq = mom + (q - 1) * NM * TILE_PIX + pix;
#pragma unroll
      for (int a = 0; a < NA; ++a) mq[a * TILE_PIX] = acc[a];
      mq[(NA + 0) * TILE_PIX] = D;
      mq[(NA + 1) * TILE_PIX] = D2;
      mq[(NA + 2) * TILE_PIX] = A;
      mq[(NA + 3) * TILE_PIX] = M1;
      mq[(NA + 4) * TILE_PIX] = M2;
      mq[(NA + 5) * TILE_PIX] = dist;
      mq[(NA + 6) * TILE_PIX] = med_o;
      mq[(NA + 7) * TILE_PIX] = med_d;
    }
    __syncthreads();
    if (q == 0) {
#pragma unroll
      for (int r = 1; r < FWD_SPLIT; ++r) {
        const float* mr = mom + (r - 1) * NM * TILE_PIX + pix;
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] += mr[a * TILE_PIX];
        const float A_r = mr[(NA + 2) * TILE_PIX];
        const float M1_r = mr[(NA + 3) * TILE_PIX];
        const float M2_r = mr[(NA + 4) * TILE_PIX];
        dist += mr[(NA + 5) * TILE_PIX] + M2_r * A + A_r * M2 -
                2.0f * M1_r * M1;
        D += mr[(NA + 0) * TILE_PIX];
        D2 += mr[(NA + 1) * TILE_PIX];
        A += A_r;
        M1 += M1_r;
        M2 += M2_r;
        const float o_r = mr[(NA + 6) * TILE_PIX];
        if (o_r >= 0.0f) {
          med_o = o_r;
          med_d = mr[(NA + 7) * TILE_PIX];
        }
      }
    }
    T = T_tile * expf(total);
    if (!__syncthreads_or(T > T_DONE)) break;
  }
  cp_async_wait_all();

  if (q > 0) return;
  float* o = out + ((long long)t * TILE_PIX + pix) * CO;
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

// One block per tile, 256 threads (a thread per pixel), one pass over the
// tile's chunks in order.
template <int NA>
__global__ void __launch_bounds__(TILE_PIX)
blend_bwd_kernel(const float* __restrict__ splat, const int* __restrict__ starts,
                 const int* __restrict__ counts,
                 const long long* __restrict__ order,
                 const float* __restrict__ fwd_out, const float* __restrict__ cot,
                 float* __restrict__ dslab, int grid_x, long long b_pad) {
  constexpr int F = slab_width(NA);
  constexpr int FS = splat_stride(NA);
  constexpr int CO = NA + 9;
  constexpr int NG = 12 + NA;  // dslab rows written: geometry + attrs
  constexpr int RS = red_stride(NA);
  static_assert(NG <= 32, "one reduce-scatter lane per dslab row");
  extern __shared__ __align__(16) float smem[];
  float* red = smem + 2 * K * FS;  // [NWARP][KSUB][RS]
  const int t = (int)order[blockIdx.x];  // heaviest tiles first
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

  // S_tot = sum_k w_k dL/dw_k, in closed form from the forward's totals
  float S_tot = g_D * fo[NA] + g_D2 * fo[NA + 1] + g_A * A_tot +
                g_M1 * M1_tot + g_M2 * M2_tot +
                2.0f * g_dist * (A_tot * M2_tot - M1_tot * M1_tot);
#pragma unroll
  for (int a = 0; a < NA; ++a) S_tot += g_attrs[a] * fo[a];
  const float gT_Tf = g_T * T_final;

  // per-duplicate gradients, dL/dalpha_k =
  //   T_k dL/dw_k - (sum_{j>k} w_j dL/dw_j + g_T T_final) / (1 - alpha_k)
  float T_carry = 1.0f, pref = 0.0f;
  if (n_chunks > 0) issue_chunk<F, FS>(smem, splat, b_pad, start);
  for (int c = 0; c < n_chunks; ++c) {
    const float* slab = next_chunk<F, FS>(smem, splat, b_pad, start, c,
                                          n_chunks);
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int kk = k % KSUB;
      // the median-depth gradient goes to the median contributor only
      const bool is_med = (float)(c * K + k) == med_ord;
      const float* sp = slab + k * FS;
      Geo g;
      bool any = __any_sync(FULL, geo_cull<F>(sp, px, py, g) || is_med);
      if (any) {
        geo_finish(g);
        any = __any_sync(FULL, g.alpha != 0.0f || is_med);
      }
      if (any) {
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = 0.0f;
        if (g.alpha != 0.0f || is_med) {
          float w = 0.0f, dalpha = 0.0f, ddepth = 0.0f, dm = 0.0f;
          if (g.alpha != 0.0f) {
            const float T_in = T_carry * expf(cum);
            cum += log1pf(-g.alpha);
            if (T_in * (1.0f - g.alpha) >= T_DONE) {
              w = g.alpha * T_in;
              const float m = m_of(g.depth);
              float dLdw = 0.0f;
#pragma unroll
              for (int a = 0; a < NA; ++a) dLdw += g_attrs[a] * sp[12 + a];
              dLdw += g_D * g.depth + g_D2 * g.depth * g.depth + g_A +
                      g_M1 * m + g_M2 * m * m +
                      g_dist * (m * m * A_tot + M2_tot - 2.0f * m * M1_tot);
              pref += w * dLdw;
              const float inv_one_m = 1.0f / fmaxf(1.0f - g.alpha, 1e-6f);
              dalpha = T_in * dLdw - (S_tot - pref + gT_Tf) * inv_one_m;
              ddepth = w * (g_D + 2.0f * g.depth * g_D2);
              dm = w * (g_dist * (2.0f * m * A_tot - 2.0f * M1_tot) + g_M1 +
                        2.0f * m * g_M2);
            }
          }
          if (is_med) ddepth += g_med;
          if (dalpha != 0.0f || ddepth != 0.0f || dm != 0.0f)
            alpha_depth_vjp(g, px, py, dalpha, ddepth, dm, v);
#pragma unroll
          for (int a = 0; a < NA; ++a) v[12 + a] = g_attrs[a] * w;
        }
        const float s = warp_reduce_scatter(v, lane);
        if (lane < NG) red[(warp * KSUB + kk) * RS + lane] = s;
      } else if (lane < NG) {
        red[(warp * KSUB + kk) * RS + lane] = 0.0f;
      }
      if (kk == KSUB - 1) {
        __syncthreads();
        const long long col0 = start + (long long)c * K + (k - kk);
        for (int e = i; e < NG * KSUB; e += TILE_PIX) {
          const int j = e / KSUB, q = e % KSUB;
          float s = 0.0f;
#pragma unroll
          for (int w8 = 0; w8 < NWARP; ++w8) s += red[(w8 * KSUB + q) * RS + j];
          dslab[(long long)j * b_pad + col0 + q] = s;
        }
        __syncthreads();
      }
    }
    T_carry = T_carry * expf(cum);
    // once no pixel is transmissive, no later splat is live: its weight,
    // dalpha and median term are all zero (its dslab column stays zero)
    if (!__syncthreads_or(T_carry > T_DONE)) break;
  }
  cp_async_wait_all();
}

template <int NA>
int launch_fwd(const float* splat, const int* starts, const int* counts,
               const long long* order, float* out, int n_tiles, int grid_x,
               long long b_pad, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(NA) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      blend_fwd_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  blend_fwd_kernel<NA><<<n_tiles, FWD_THREADS, smem, stream>>>(
      splat, starts, counts, order, out, grid_x, b_pad);
  return (int)cudaGetLastError();
}

template <int NA>
int launch_bwd(const float* splat, const int* starts, const int* counts,
               const long long* order, const float* fwd_out, const float* cot,
               float* dslab, int n_tiles, int grid_x, long long b_pad,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(NA) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      blend_bwd_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  blend_bwd_kernel<NA><<<n_tiles, TILE_PIX, smem, stream>>>(
      splat, starts, counts, order, fwd_out, cot, dslab, grid_x, b_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Block b blends tile order[b] (ops/raster_blend.py:tile_order, a permutation
// of the tiles, heaviest first). Returns cudaGetLastError() after the
// launch, or -1 for an unsupported S.
int irgs_blend_fwd(const float* splat, const int* starts, const int* counts,
                   const long long* order, float* out, int n_tiles, int grid_x,
                   long long b_pad, int S, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 0: return launch_fwd<6>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 1: return launch_fwd<7>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 2: return launch_fwd<8>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 3: return launch_fwd<9>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 4: return launch_fwd<10>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 5: return launch_fwd<11>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 6: return launch_fwd<12>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 7: return launch_fwd<13>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    case 8: return launch_fwd<14>(splat, starts, counts, order, out, n_tiles, grid_x, b_pad, st);
    default: return -1;
  }
}

int irgs_blend_bwd(const float* splat, const int* starts, const int* counts,
                   const long long* order, const float* fwd_out, const float* cot,
                   float* dslab, int n_tiles, int grid_x, long long b_pad,
                   int S, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 0: return launch_bwd<6>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 1: return launch_bwd<7>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 2: return launch_bwd<8>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 3: return launch_bwd<9>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 4: return launch_bwd<10>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 5: return launch_bwd<11>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 6: return launch_bwd<12>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 7: return launch_bwd<13>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    case 8: return launch_bwd<14>(splat, starts, counts, order, fwd_out, cot, dslab, n_tiles, grid_x, b_pad, st);
    default: return -1;
  }
}

}  // extern "C"
