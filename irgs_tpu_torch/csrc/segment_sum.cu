// Sums of runs of rows, out[q, :] = sum over r in [bounds[q], bounds[q+1])
// of src[perm[r], :], each in the order of r, for NVIDIA Hopper (sm_90a).
//
// The deterministic scatter-add of the port's row gather
// (utils/math3d.gather_rows): the gradient of x[idx] is the sum, for each
// row of x, of the gradient rows whose index names it. The JAX package
// leaves this to XLA's scatter-add (the VJP of the gathers at
// irgs_tpu/ops/surfel_raster.py:547 and in the grid tracer), which gives the
// same bits on every run; torch's index_add_ on the card adds with atomics,
// in an order that changes from run to run. The wrapper
// (ops/segment_sum.py) sorts the indices (a stable sort), cuts each run of
// one index into pieces of at most PIECE rows, and calls this kernel once
// per level until each index has one piece: the order of every addition is
// fixed by the sorted order, whatever the card schedules.
//
// What bounds it on this card: bytes. One addition per word read; it reads
// each gradient row once (through the sort's permutation) and writes each
// piece's row once.
//
// Design. One thread per (piece, column): consecutive threads take
// consecutive columns of a piece, so a warp reads a row's words together. A
// piece holds at most PIECE rows, so a run of a million copies of one index
// (the slab's padding) is spread over many threads, and the next level sums
// the pieces.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
segment_sum_kernel(const float* __restrict__ src,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ bounds, long long n_pieces,
                   int width, float* __restrict__ out) {
  const long long n = n_pieces * width;
  for (long long e = (long long)blockIdx.x * BLOCK + threadIdx.x; e < n;
       e += (long long)gridDim.x * BLOCK) {
    const long long q = e / width;
    const int c = (int)(e - q * width);
    const long long r1 = bounds[q + 1];
    float s = 0.0f;
    for (long long r = bounds[q]; r < r1; ++r) {
      const long long row = perm != nullptr ? perm[r] : r;
      s += src[row * width + c];
    }
    out[e] = s;
  }
}

}  // namespace

extern "C" {

// src [rows, width] f32, perm [total] int64 or null (the identity), bounds
// [n_pieces + 1] int64 ascending, out [n_pieces, width]. Returns
// cudaGetLastError() after the launch (0 when there is nothing to do).
int irgs_segment_sum(const float* src, const long long* perm,
                     const long long* bounds, long long n_pieces, int width,
                     float* out, void* stream) {
  if (n_pieces == 0 || width == 0) return 0;
  const long long n = n_pieces * width;
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > 65536) blocks = 65536;
  segment_sum_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      src, perm, bounds, n_pieces, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
