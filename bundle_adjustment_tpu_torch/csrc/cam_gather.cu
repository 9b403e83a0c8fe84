// K3: camera-row gather  out[c, n] = tbl[obs_img[n], c]  (c < 8).
//
// Replaces the Pallas kernel `_gather_kernel` / `make_cam_gather`
// (bundle_adjustment_tpu/parallel/kernels.py:279-335), which built each
// row with a two-level one-hot product on the TPU's matrix unit.  On
// Hopper it is a plain indexed load: one thread per observation reads its
// image index and up to 8 table columns, and writes 8 rows.
//
// Bound: device-memory bandwidth.  Per observation it reads 4 B of index
// and writes 32 B of rows; the table ([M, <=8] f32, 16 KB at M = 500)
// stays in L1/L2.  At the scale shape (N = 1,204,224) that is 4.8 MB read
// and 38.5 MB written, 43.4 MB: 0.0129 ms at the 3.35 TB/s of an H100 SXM
// (measure.k3_work).  The 43 MB fit the 50 MB L2, so back-to-back launches
// run faster than one that finds the L2 cold; the chip check times both.
// Design: consecutive threads take consecutive observations, so the index
// reads and each row's writes are fully coalesced; nothing is staged.
#include "common.cuh"

namespace {

__global__ void cam_gather_kernel(const float* __restrict__ tbl, int ncols,
                                  const int* __restrict__ obs_img, long long N,
                                  float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const int img = obs_img[n];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      out[(long long)c * N + n] = c < ncols ? tbl[img * ncols + c] : 0.f;
  }
}

}  // namespace

extern "C" int ba_cam_gather(const float* tbl, int M, int ncols,
                             const int* obs_img, long long N, float* out,
                             cudaStream_t stream) {
  if (M <= 0 || ncols < 1 || ncols > 8 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cam_gather_kernel<<<(int)blocks, threads, 0, stream>>>(tbl, ncols, obs_img,
                                                         N, out);
  BA_CHECK_LAUNCH();
  return 0;
}
