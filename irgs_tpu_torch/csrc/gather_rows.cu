// Row gather out[i, :] = table[clamp(idx[i], 0, T-1), :] of 32-bit words, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel irgs_tpu/ops/gather_pallas.py:_gather_kernel
// (launched by gather_rows), which the grid tracer's tiled select uses to
// fetch rows of its pair-ordered candidate table. The same function is
// computed by the two probe kernels of tools/_prof_collect_parts.py (`kern`,
// a row gather from a VMEM-resident table, and `kern2`, a flat element
// gather, which is this gather with rows of one word).
//
// What bounds it on this card: bytes, and of those the write stream plus
// the distinct rows read. It does no arithmetic; it writes every gathered
// row once and reads each distinct row of the table. At the eval path's
// first pass (393,216 rows of 352 words, from a 65,536-row pair table of
// which it reads ~13k distinct rows) it writes 0.55 GB and reads ~18 MB, so
// the floor is the output over the HBM rate. What keeps a gather from that
// floor: short blocks that each wait on two dependent reads (an index, then
// its row) before their first store, few loads in flight a thread, and an
// output stored with the default L2 policy, which sweeps the 50 MB L2 that
// holds the table's hot rows.
//
// The design here:
//   - A persistent grid: a few blocks per SM, sized from the SM count and
//     the kernel's occupancy. Each warp walks chunks of 32 rows; its 32 lanes
//     load the chunk's indices in one coalesced read, and the next chunk's
//     indices are read while the current chunk is copied, so a row never
//     waits on its index. Where there are fewer chunks than resident warps
//     (a few hundred rows), several warps share a chunk.
//   - Bytes in flight in registers: the warp copies its chunk's rows as one
//     run of 16-byte (or, for rows that are not a multiple of 16 bytes or
//     pointers that are not 16-byte aligned, 4-byte) units, kUnits a lane
//     loaded before any is stored; the output run is contiguous, so the
//     stores are coalesced and need no index. (A ring of shared-memory row
//     buffers filled and drained by TMA bulk copies, the counterpart of the
//     TPU kernel's DMA window, was measured beside it on the H100 and was
//     slower on the paths' inputs: PERF.md.)
//   - L2 policy: the output is stored evict-first (st.global.cs), so that it
//     streams past the table rows that later chunks read again. The table
//     rows are read plainly (read evict-last, they gained 1 % on the eval
//     frame's first pass, at the risk of holding lines that the kernels
//     between gathers need: PERF.md).
// Words are copied as integers, so f32 and int32 tables (and the bf16 pair
// table viewed as int32) come through bit for bit. Indices are int64, as the
// port holds them, and are clamped to [0, T), as a gather on the TPU clamps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;                 // rows per warp step: one per lane
constexpr int kUnits = 8;                  // units a lane holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_row(long long r, long long t) {
  return r < 0 ? 0 : (r >= t ? t - 1 : r);
}

// The warp's index of row `r` of chunk `c` (0 past the end).
__device__ __forceinline__ long long chunk_index(const long long* idx,
                                                 long long c, long long m,
                                                 int lane) {
  const long long r = c * kChunk + lane;
  return r < m ? __ldg(idx + r) : 0;
}

// `split` warps share each chunk (where there are fewer chunks than warps
// the grid holds), each taking every split-th run of 32 x kUnits units
template <typename V>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const V* __restrict__ table, const long long* __restrict__ idx,
              V* __restrict__ out, long long m, long long t, int wv,
              int split) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kBlock + threadIdx.x) >> 5;
  const long long groups = (((long long)gridDim.x * kBlock) >> 5) / split;
  const long long group = warp / split;
  if (group >= groups) return;             // the whole warp
  const int first = (int)(warp % split) * 32 * kUnits;
  const long long nchunks = (m + kChunk - 1) / kChunk;
  long long next = group < nchunks ? chunk_index(idx, group, m, lane) : 0;
  // the loop bounds are the same for the whole warp, so every lane reaches
  // each shuffle
  for (long long c = group; c < nchunks; c += groups) {
    const long long row = clamp_row(next, t);
    if (c + groups < nchunks) next = chunk_index(idx, c + groups, m, lane);
    const long long base = c * kChunk;
    const int rows = (int)(m - base < kChunk ? m - base : kChunk);
    const int units = rows * wv;
    V* dst = out + base * wv;               // the chunk's output, contiguous
    for (int u0 = first; u0 < units; u0 += split * 32 * kUnits) {
      V v[kUnits] = {};
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = u0 + k * 32 + lane;
        const int r = u / wv;
        const long long src = __shfl_sync(kFull, row, r & 31);
        if (u < units) v[k] = __ldg(table + src * wv + (u - r * wv));
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = u0 + k * 32 + lane;
        if (u < units) __stcs(dst + u, v[k]);
      }
    }
  }
}

int g_sms[64];                              // SMs of each device

template <typename V>
int launch(const void* table, const long long* idx, void* out, long long m,
           long long t, int wv, int dev, int sms, cudaStream_t st) {
  auto kern = gather_kernel<V>;
  static int per_sm[64];                    // resident blocks per SM
  if (per_sm[dev] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kern, kBlock,
                                                  0);
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  // a chunk's runs of 32 x kUnits units go to as many warps as the grid
  // holds beyond one a chunk, up to one a run
  const long long nchunks = (m + kChunk - 1) / kChunk;
  const long long resident = (long long)sms * per_sm[dev] * kWarps;
  const long long runs = (wv + kUnits - 1) / kUnits;
  long long split = resident / nchunks;
  split = split < 1 ? 1 : (split > runs ? runs : split);
  long long blocks = (nchunks * split + kWarps - 1) / kWarps;
  if (blocks > (long long)sms * per_sm[dev])
    blocks = (long long)sms * per_sm[dev];
  kern<<<(unsigned)blocks, kBlock, 0, st>>>((const V*)table, idx, (V*)out, m,
                                            t, wv, (int)split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// args: table [t, w] 32-bit words, idx [m] int64, out [m, w] (pointers), m,
// t, w, the stream and the table's device, made current for the launch
// where it is not. One array, so that the caller's foreign call converts one
// argument. Returns cudaGetLastError() after the launch (0 when m == 0 or
// w == 0: nothing is launched).
int irgs_gather_rows(const long long* args) {
  const void* table = (const void*)args[0];
  const long long* idx = (const long long*)args[1];
  void* out = (void*)args[2];
  const long long m = args[3], t = args[4];
  const int w = (int)args[5];
  cudaStream_t st = (cudaStream_t)args[6];
  const int dev = (int)args[7] & 63;
  if (m == 0 || w == 0) return 0;
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur != dev) cudaSetDevice(dev);
  if (g_sms[dev] == 0)
    cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const bool vec = (w % 4 == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int err =
      vec ? launch<int4>(table, idx, out, m, t, w / 4, dev, g_sms[dev], st)
          : launch<int>(table, idx, out, m, t, w, dev, g_sms[dev], st);
  if (cur != dev) cudaSetDevice(cur);
  return err;
}

}  // extern "C"
