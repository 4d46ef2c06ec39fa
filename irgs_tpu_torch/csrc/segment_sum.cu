// Reduce-by-key of sorted rows over fixed tiles, for NVIDIA Hopper (sm_90a):
// one level of the deterministic scatter-add out[i] = sum over j with
// idx[j] = i of src[j, :].
//
// The deterministic scatter-add of the port's row gathers
// (utils/math3d.gather_rows, gather_rows_many): the gradient of x[idx] is
// the sum, for each row of x, of the gradient rows whose index names it. The
// JAX package leaves this to XLA's scatter-add (the VJP of the gathers at
// irgs_tpu/ops/surfel_raster.py:547 and in the grid tracer's blend_hits),
// which gives the same bits on every run; torch's index_add_ on the card adds
// with atomics, in an order that changes from run to run. The wrapper
// (ops/segment_sum.py) sorts the indices once (a stable sort of int32 keys)
// and launches this kernel once per level. The number of levels and every
// grid size follow from the number of rows M and the tile C alone, so the
// host never reads a device value.
//
// One level. Tile t covers the sorted positions [t*C, (t+1)*C). A warp takes
// 32*VEC consecutive columns of the tile's rows, reads each row through perm
// (null: the identity) from the column blocks it is given in place (the
// gradients of several tables gathered by one index, so that nothing
// concatenates them first), keeps the running sum of the current run in
// registers, and finds run edges by comparing neighbouring keys. A run that
// lies wholly inside the tile is written straight to out[key] (its only
// writer; the wrapper zero-fills out). A run cut by the tile's edge leaves a
// partial in the tile's carry slots 2t (head: the run began before the tile)
// and 2t+1 (tail: it goes on past it), with its key beside it; when the whole
// tile lies inside one run, slot 2t takes the sum and slot 2t+1 a zero row
// of the same key, so that no sentinel splits the run at the next level. An
// unused slot gets the key -1 and a zero row. The next level runs the same
// kernel over the 2*ceil(M/C) slots, in order; a level of one tile cuts no
// run and ends the pipeline. So a million copies of one index finish in
// 1 + ceil(log_{C/2}(M/C)) levels, and the order of every addition depends on
// M, C and the sorted keys only. (No decoupled look-back: its sums would
// follow the order in which tiles publish their prefixes.)
//
// What bounds it on this card: bytes. One addition per word read; level 0
// reads each gradient row once (through the sort's permutation) and writes
// each output row once; the carry levels move 2/C of that. A warp loads a
// batch of 32 positions' keys and row numbers (one coalesced load each,
// then shuffles), issues the loads of 32 / VEC rows at once, then sums
// them. VEC = 4 (16-byte loads) when every block's width allows it.
// At width 32 a warp's 8 lanes of 16 bytes leave 24 idle, so level 0 moves
// fewer bytes a second there than at width 64 (PERF.md). C = 64 is
// the wrapper's TILE. chip_smoke.py sweeps C over 64-1024 (`tile_ms_queued`):
// at the stage-1 slab 64 takes the least time; at the stage-2 calls, whose
// queued calls wait on the host, 64, 128 and 256 trade places from run to
// run; 512 and 1024 take more. A run's partial sums are sequential over at
// most C rows, so a smaller C rounds a long run less; 64 costs a level or
// two more than 256 (4 launches a call at a million rows, 5 at the stage-1
// slab).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAX_BLOCKS = 8;
constexpr int BLOCK = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The rows' columns, as blocks side by side: block b holds columns
// [start[b], start[b] + width[b]) of each row, row-major with its own width
// (the gradients of the tables gathered by one index, read in place).
struct Blocks {
  const float* ptr[MAX_BLOCKS];
  int width[MAX_BLOCKS];
  int start[MAX_BLOCKS];
  int n;
};

template <int VEC>
__global__ void __launch_bounds__(BLOCK)
segment_sum_kernel(const Blocks blocks, const long long* __restrict__ perm,
                   const int* __restrict__ keys, long long m, int width,
                   int tile, long long n_tiles, int n_chunks,
                   float* __restrict__ out, long long n_out,
                   int* __restrict__ carry_keys,
                   float* __restrict__ carry_vals) {
  constexpr int U = 32 / VEC;  // rows loaded ahead of their sums
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= n_tiles * n_chunks) return;  // whole warps only
  const long long t = gw / n_chunks;
  const int col = ((int)(gw - t * n_chunks) * 32 + lane) * VEC;
  const bool active = col < width;
  // this lane's block: a block's width and start are multiples of VEC
  int b = 0;
  while (b + 1 < blocks.n && col >= blocks.start[b + 1]) ++b;
  const float* __restrict__ src = blocks.ptr[b] + (col - blocks.start[b]);
  const int src_width = blocks.width[b];
  const long long lo = t * tile;
  const long long hi = lo + tile < m ? lo + tile : m;
  const bool head_cut = lo > 0 && keys[lo - 1] == keys[lo];
  const bool tail_cut = hi < m && keys[hi] == keys[hi - 1];

  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  int cur = keys[lo];
  bool first = true;  // the current run began at lo

  // the current run ends: to its carry slot, or to out[cur]
  auto flush = [&](bool last) {
    if (!active) return;
    if (first && head_cut) {
      store_cols<VEC>(carry_vals + 2 * t * width + col, acc);
    } else if (last && tail_cut) {
      store_cols<VEC>(carry_vals + (2 * t + 1) * width + col, acc);
    } else if (cur >= 0 && cur < n_out) {
      store_cols<VEC>(out + (long long)cur * width + col, acc);
    }
  };

  for (long long base = lo; base < hi; base += 32) {
    const int n = hi - base < 32 ? (int)(hi - base) : 32;
    int my_key = 0;
    long long my_row = 0;
    if (lane < n) {
      my_key = keys[base + lane];
      my_row = perm != nullptr ? perm[base + lane] : base + lane;
    }
#pragma unroll
    for (int u0 = 0; u0 < 32; u0 += U) {
      if (u0 >= n) break;  // warp-uniform
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = __shfl_sync(FULL, my_row, u0 + u);
        if (active && u0 + u < n) {
          load_cols<VEC>(src + row * src_width, v[u]);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[u][c] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = __shfl_sync(FULL, my_key, u0 + u);
        if (u0 + u < n) {  // warp-uniform
          if (k != cur) {  // a run edge: warp-uniform too
            flush(false);
            first = false;
            cur = k;
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
          }
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] += v[u][c];
        }
      }
    }
  }
  flush(true);

  if (carry_vals == nullptr) return;  // one tile: no run was cut
  if (active) {
    float zero[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) zero[c] = 0.0f;
    if (!head_cut) store_cols<VEC>(carry_vals + 2 * t * width + col, zero);
    if (!tail_cut || (first && head_cut)) {
      store_cols<VEC>(carry_vals + (2 * t + 1) * width + col, zero);
    }
  }
  if (col == 0) {
    carry_keys[2 * t] = head_cut ? keys[lo] : -1;
    carry_keys[2 * t + 1] = tail_cut ? keys[hi - 1] : -1;
  }
}

}  // namespace

extern "C" {

// One level: the rows' columns as n_src blocks side by side (ptrs[b]: [rows,
// widths[b]] f32, each width a multiple of vec and each pointer aligned to
// 4 * vec bytes; at most MAX_BLOCKS), perm [m] int64 or null (the
// identity), keys [m] int32 sorted (-1: an unused slot), out [n_out, width]
// f32 with width the sum of the widths, carry_keys [2 * n_tiles] int32 and
// carry_vals [2 * n_tiles, width] f32 with n_tiles = ceil(m / tile), both
// null when n_tiles is 1. Returns cudaGetLastError() after the launch (0 when
// there is nothing to do, 1 on bad blocks or vec).
int irgs_segment_sum(const long long* ptrs, const int* widths, int n_src,
                     const long long* perm, const int* keys, long long m,
                     int tile, int vec, float* out, long long n_out,
                     int* carry_keys, float* carry_vals, void* stream) {
  if (vec != 1 && vec != 2 && vec != 4) return 1;
  if (n_src < 1 || n_src > MAX_BLOCKS) return 1;
  Blocks blocks;
  int width = 0;
  for (int b = 0; b < n_src; ++b) {
    if (widths[b] % vec != 0) return 1;
    blocks.ptr[b] = reinterpret_cast<const float*>(ptrs[b]);
    blocks.width[b] = widths[b];
    blocks.start[b] = width;
    width += widths[b];
  }
  blocks.n = n_src;
  if (m == 0 || width == 0) return 0;
  const long long n_tiles = (m + tile - 1) / tile;
  const int n_chunks = (width + 32 * vec - 1) / (32 * vec);
  const long long n_blocks = (n_tiles * n_chunks + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
#define IRGS_LAUNCH(V)                                                      \
  segment_sum_kernel<V><<<(unsigned)n_blocks, BLOCK, 0, s>>>(               \
      blocks, perm, keys, m, width, tile, n_tiles, n_chunks, out, n_out,   \
      carry_keys, carry_vals)
  if (vec == 4) {
    IRGS_LAUNCH(4);
  } else if (vec == 2) {
    IRGS_LAUNCH(2);
  } else {
    IRGS_LAUNCH(1);
  }
#undef IRGS_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
