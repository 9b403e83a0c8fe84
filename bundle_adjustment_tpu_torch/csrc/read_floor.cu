// K4: pure-read floor of the Schur matvec.  Streams the lean packed rows
// exactly as K1 reads them and folds them into an [8, 128] sum:
//   out[k, l] = 1e-30 * xin[k, l] + sum_{r % 8 == k, n % 128 == l} packed[r, n]
// over the 21 + 2G lean rows r and all N lanes n.
//
// Replaces the Pallas kernel `_floor_kernel` / `make_read_floor`
// (bundle_adjustment_tpu/parallel/kernels.py:516-568), which folds the lean
// prefix padded to 8 rows; the pad rows are zero (parallel/kernels.py
// `pack_fm`), so reading only the rows K1 reads gives the same output.  The
// TPU version chained `xin` from one call to the next so that its relay could
// not skip repeated identical executions; here `xin` only seeds the sum.
//
// Bound: device-memory bandwidth, 3.35 TB/s on an H100 SXM.  At G = 10 the
// rows are 41 x 4 B per observation, 197 MB at N = 1,204,224 (~59 us at that
// rate); the 50 MB L2 cannot hold them, so back-to-back runs read them from
// device memory each time.  Design:
//  * K1's grid, CTA shape and lane order: one CTA per view-major block of
//    pb x V lanes, thread tid holds lane blk * V * pb + tid, every row read is
//    coalesced and each value is read once; a thread keeps its 8 sublane sums
//    in registers;
//  * the fold to lane n % 128 goes through shared memory inside the CTA, in
//    thread order, into one [8, 128] partial per block (4 KB against the 63 KB
//    of rows a block reads at V = 12, pb = 32);
//  * the sum over blocks is deterministic (no atomics, as K1 and K2):
//    column_sum_kernel adds the partials in a fixed order in two passes,
//    kChunks chunks of blocks (1024 CTAs, each warp reading 128 B of
//    consecutive columns) and then the chunks, so the 12.8 MB of partials at
//    the full size cost a few microseconds beside the 197 MB of rows.
#include "common.cuh"

namespace {

constexpr int kFoldRows = 8;
constexpr int kFoldLanes = 128;
constexpr int kFold = kFoldRows * kFoldLanes;
constexpr int kColTile = 32;  // columns of a column_sum_kernel block
constexpr int kChunks = 32;   // chunks of blocks in the first column sum

// partial: [N / (V * pb), 8, 128] f32.
__global__ void __launch_bounds__(ba::kMaxBlockThreads)
read_floor_kernel(const float* __restrict__ pk, long long N, int rows,
                  float* __restrict__ partial) {
  __shared__ float sh[kFoldRows][ba::kMaxBlockThreads];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // V * pb
  const long long n0 = (long long)blockIdx.x * nthr;
  const float* col = pk + n0 + tid;  // row r of this lane at col[r * N]

  float acc[kFoldRows];
#pragma unroll
  for (int k = 0; k < kFoldRows; ++k) acc[k] = 0.f;
  for (int r0 = 0; r0 < rows; r0 += kFoldRows) {
#pragma unroll
    for (int k = 0; k < kFoldRows; ++k)
      if (r0 + k < rows) acc[k] += col[(long long)(r0 + k) * N];
  }
#pragma unroll
  for (int k = 0; k < kFoldRows; ++k) sh[k][tid] = acc[k];
  __syncthreads();

  // lane n0 + t folds into column (n0 + t) % 128
  const int base = (int)(n0 % kFoldLanes);
  for (int o = tid; o < kFold; o += nthr) {
    const int k = o / kFoldLanes, l = o % kFoldLanes;
    float s = 0.f;
    for (int t = (l - base + kFoldLanes) % kFoldLanes; t < nthr;
         t += kFoldLanes)
      s += sh[k][t];
    partial[(long long)blockIdx.x * kFold + o] = s;
  }
}

// out[y * K + k] = sum_{c in chunk y} part[c * K + k] (+ beta * xin[k] when
// xin is given) for k < K, chunk y = rows [y * chunk, (y + 1) * chunk) of
// C.  Grid (ceil(K / kColTile), chunks); block (kColTile,
// kReduceThreads / kColTile).  Thread (kx, j) sums the rows c0 + j,
// c0 + j + blockDim.y, ... in order (a warp reads 128 B of consecutive
// columns), then thread j == 0 adds the blockDim.y partial sums in order.
__global__ void column_sum_kernel(const float* __restrict__ part, int C,
                                  int K, int chunk,
                                  const float* __restrict__ xin, float beta,
                                  float* __restrict__ out) {
  __shared__ float sh[ba::kReduceThreads];
  const int kx = threadIdx.x, j = threadIdx.y;
  const int k = blockIdx.x * blockDim.x + kx;
  const int c0 = blockIdx.y * chunk;
  const int c1 = c0 + chunk < C ? c0 + chunk : C;
  float acc = 0.f;
  if (k < K)
    for (int c = c0 + j; c < c1; c += blockDim.y)
      acc += part[(long long)c * K + k];
  sh[j * blockDim.x + kx] = acc;
  __syncthreads();
  if (j == 0 && k < K) {
    float s = 0.f;
    for (int jj = 0; jj < (int)blockDim.y; ++jj) s += sh[jj * blockDim.x + kx];
    if (xin != nullptr) s += beta * xin[k];
    out[(long long)blockIdx.y * K + k] = s;
  }
}

}  // namespace

// rows: the lean rows read (21 + 2G); xin, out: [8, 128] f32; partial:
// [P / pb + kChunks, 8, 128] f32 (the per-block folds, then the chunk sums).
extern "C" int ba_read_floor(const float* packed, long long N, int P, int V,
                             int pb, int rows, const float* xin,
                             float* partial, float* out, cudaStream_t stream) {
  const int nthr = V * pb;
  if (pb <= 0 || pb % 32 != 0 || nthr > ba::kMaxBlockThreads || P % pb != 0 ||
      rows < 1 || (long long)P * V != N)
    return (int)cudaErrorInvalidValue;
  const int nblk = P / pb;
  read_floor_kernel<<<nblk, nthr, 0, stream>>>(packed, N, rows, partial);
  BA_CHECK_LAUNCH();
  const dim3 block(kColTile, ba::kReduceThreads / kColTile);
  float* chunk_sums = partial + (long long)nblk * kFold;
  column_sum_kernel<<<dim3(kFold / kColTile, kChunks), block, 0, stream>>>(
      partial, nblk, kFold, (nblk + kChunks - 1) / kChunks, nullptr, 0.f,
      chunk_sums);
  BA_CHECK_LAUNCH();
  column_sum_kernel<<<dim3(kFold / kColTile, 1), block, 0, stream>>>(
      chunk_sums, kChunks, kFold, kChunks, xin, 1e-30f, out);
  BA_CHECK_LAUNCH();
  return 0;
}
