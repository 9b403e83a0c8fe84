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
// rows are 41 x 4 B per observation, 197.5 MB at N = 1,204,224: 0.0590 ms at
// that rate (measure.k4_work); the 50 MB L2 cannot hold them, so back-to-back
// runs read them from device memory each time.  Design:
//  * K1's own pipeline (common.cuh): the same persistent grid, the same ring
//    of shared-memory stages filled by asynchronous bulk copies, one tile per
//    view-major block of pb x V lanes; the consumers do nothing but fold, so
//    this is what that pipeline costs when no arithmetic stands in its way;
//  * the fold reads the tile where it lies: output (k, l) adds the rows
//    r = k, k + 8, ... of a block and, of each, the lanes that fall on column
//    l, in that order; a consumer thread owns fixed outputs and keeps their
//    running sums in shared memory, so the consumers need no barrier and the
//    kernel writes one [8, 128] fold per CTA (0.5 MB in all), not one per
//    block (12.8 MB, 6% of the rows);
//  * the sum is deterministic without atomics: a CTA adds its blocks in the
//    fixed order blk = blockIdx.x, blockIdx.x + gridDim.x, ... (the grid is
//    one CTA per SM, so the order depends on the card's SM count and on
//    nothing that varies between runs), and column_sum_kernel (common.cuh)
//    adds the CTAs' folds in CTA order.  K1 and K2 index their partials by
//    block instead, because their bits must not depend on the card; a probe
//    that is only ever compared within a tolerance can take the cheaper way.
#include "common.cuh"

namespace {

constexpr int kFoldRows = 8;
constexpr int kFoldLanes = 128;
constexpr int kFold = kFoldRows * kFoldLanes;

// partial: [gridDim.x, 8, 128] f32.
__global__ void __launch_bounds__(ba::kMaxBlockThreads + ba::kProducerThreads)
read_floor_kernel(const ba::RingPlan plan, int nblk, int rows,
                  float* __restrict__ partial) {
  extern __shared__ __align__(128) char smem[];
  const int nthr = blockDim.x - ba::kProducerThreads;  // V * pb
  const int tid = threadIdx.x;
  if (tid == 0) ba::ring_init(smem, plan, nthr / 32);
  __syncthreads();
  if (tid >= nthr) {
    ba::ring_produce(plan, smem, nblk);
    return;
  }
  // thread tid owns the outputs tid, tid + nthr, ...
  float* acc = reinterpret_cast<float*>(ba::ring_user(plan, smem));
  for (int o = tid; o < kFold; o += nthr) acc[o] = 0.f;
  int it = 0;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
    const float* T =
        reinterpret_cast<const float*>(ba::ring_wait(plan, smem, it));
    // lane t of the tile is lane blk * nthr + t of the row: column
    // (base + t) % 128
    const int base = (int)(((long long)blk * nthr) % kFoldLanes);
    for (int o = tid; o < kFold; o += nthr) {
      const int k = o / kFoldLanes, l = o % kFoldLanes;
      const int t0 = (l - base + kFoldLanes) % kFoldLanes;
      float s = 0.f;
      for (int r = k; r < rows; r += kFoldRows) {
        const float* row = T + r * nthr;
        for (int t = t0; t < nthr; t += kFoldLanes) s += row[t];
      }
      acc[o] += s;
    }
    ba::ring_release(plan, smem, it);
  }
  for (int o = tid; o < kFold; o += nthr)
    partial[(long long)blockIdx.x * kFold + o] = acc[o];
}

}  // namespace

// rows: the lean rows read (21 + 2G); xin, out: [8, 128] f32; partial:
// [P / pb, 8, 128] f32 (one fold per CTA, at most one CTA per block).
extern "C" int ba_read_floor(const float* packed, long long N, int P, int V,
                             int pb, int rows, const float* xin,
                             float* partial, float* out, cudaStream_t stream) {
  const int nthr = V * pb;
  if (pb <= 0 || pb % 32 != 0 || nthr > ba::kMaxBlockThreads || P % pb != 0 ||
      rows < 1 || (long long)P * V != N)
    return (int)cudaErrorInvalidValue;
  const int nblk = P / pb;
  const long long f4 = sizeof(float);
  ba::DeviceLimits lim;
  cudaError_t e = ba::device_limits(&lim);
  if (e != cudaSuccess) return (int)e;
  ba::RingPlan plan = {};
  int smem = 0;
  if (!ba::ring_add(&plan, packed, N * f4, nthr * f4, rows, nthr * (int)f4) ||
      !ba::ring_fit(&plan, kFold * (int)f4, lim, &smem))
    return (int)cudaErrorInvalidValue;
  BA_ALLOW_SMEM(read_floor_kernel, lim.max_smem);
  const int grid = ba::ring_grid(lim, nblk);
  read_floor_kernel<<<grid, nthr + ba::kProducerThreads, smem, stream>>>(
      plan, nblk, rows, partial);
  BA_CHECK_LAUNCH();
  ba::column_sum_kernel<<<dim3(kFold / ba::kColTile, 1),
                          dim3(ba::kColTile, ba::kReduceThreads / ba::kColTile),
                          0, stream>>>(partial, grid, kFold, grid, xin, 1e-30f,
                                       out);
  BA_CHECK_LAUNCH();
  return 0;
}
