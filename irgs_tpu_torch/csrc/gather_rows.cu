// Row gather out[i, :] = table[idx[i], :] of 32-bit words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel irgs_tpu/ops/gather_pallas.py:_gather_kernel
// (launched by gather_rows), which the grid tracer's tiled select uses to
// fetch rows of its pair-ordered candidate table. The same function is
// computed by the two probe kernels of tools/_prof_collect_parts.py (`kern`,
// a row gather from a VMEM-resident table, and `kern2`, a flat element
// gather, which is this gather with rows of one word).
//
// What bounds it on this card: bytes. It does no arithmetic; it reads each
// indexed row and writes it once. At the eval path's first-pass shape
// (393,216 rows of 352 words) it moves ~0.55 GB out and reads rows of a
// table small enough for L2, so the floor is the write stream.
//
// Design. Each row goes to a group of `tpr` threads (a power of two: a part
// of a warp for narrow rows, one warp, or a few warps for wide rows), chosen
// so that each thread moves a few words. The lane that leads the group reads
// the row's index once and broadcasts it with a shuffle; the group then
// copies the row with 16-byte loads and stores where the row width is a
// multiple of 4 words and both pointers are 16-byte aligned, and with 4-byte
// ones otherwise. Words are copied as integers, so f32 and int32 tables (and
// f32 tables that carry int32 bits, as the pair table's cell ids) come
// through bit for bit.
//
// No DMA window. The TPU kernel keeps a rolling window of `inflight` row DMAs
// in flight to hide HBM latency; here the latency is hidden by many resident
// warps, each with several independent loads outstanding, so the kernel has
// no counterpart to that window.
//
// Indices are int64, as the port holds them, and are clamped to [0, T), as a
// gather on the TPU clamps; callers pass indices already in range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_BLOCKS = 1 << 16;

template <typename V>
__global__ void __launch_bounds__(BLOCK)
gather_rows_kernel(const V* __restrict__ table, const long long* __restrict__ idx,
                   V* __restrict__ out, long long m, long long t, int wv,
                   int tpr) {
  const int rows_per_block = BLOCK / tpr;
  const int sub = threadIdx.x % tpr;  // thread within its row group
  const int lane = threadIdx.x & 31;
  const int leader = tpr >= 32 ? 0 : (lane & ~(tpr - 1));
  // the loop bound is the same for the whole block, so every lane reaches
  // the shuffle on every trip
  for (long long base = (long long)blockIdx.x * rows_per_block; base < m;
       base += (long long)gridDim.x * rows_per_block) {
    const long long r = base + threadIdx.x / tpr;
    long long row = 0;
    if (lane == leader && r < m) row = idx[r];
    row = __shfl_sync(FULL, row, leader);
    if (r >= m) continue;
    row = row < 0 ? 0 : (row >= t ? t - 1 : row);
    const V* src = table + row * wv;
    V* dst = out + r * wv;
#pragma unroll 4
    for (int j = sub; j < wv; j += tpr) dst[j] = __ldg(src + j);
  }
}

// threads per row: the power of two (1..BLOCK) that leaves each thread about
// four vectors of the row
int threads_per_row(int wv) {
  int want = (wv + 3) / 4;
  int tpr = 1;
  while (tpr < want && tpr < BLOCK) tpr *= 2;
  return tpr;
}

template <typename V>
int launch(const void* table, const long long* idx, void* out, long long m,
           long long t, int wv, cudaStream_t stream) {
  const int tpr = threads_per_row(wv);
  const long long rows_per_block = BLOCK / tpr;
  long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_rows_kernel<V><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      (const V*)table, idx, (V*)out, m, t, wv, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [t, w] 32-bit words, idx [m] int64, out [m, w]. Returns
// cudaGetLastError() after the launch (0 when m == 0: nothing is launched).
int irgs_gather_rows(const void* table, const long long* idx, void* out,
                     long long m, long long t, int w, void* stream) {
  if (m == 0 || w == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = (w % 4 == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) return launch<int4>(table, idx, out, m, t, w / 4, st);
  return launch<int>(table, idx, out, m, t, w, st);
}

}  // extern "C"
