// K1: implicit Schur-complement matvec  S [xc; xg]  from the lean packed
// prefix [Jp(6) Jc(12) Jg(2G) wxx wxy wyy].
//
// Replaces the Pallas kernel `_matvec_kernel` / `_matvec_block` /
// `make_matvec` (bundle_adjustment_tpu/parallel/kernels.py:342-513).  The
// TPU version gathered xc and scattered the per-image sums through one-hot
// products on the matrix unit; here both are indexed memory accesses.
//
// Per observation n (point pt, image m):
//   s  = Jc xc[m] + Jg xg,  t = W2 s
//   y[pt] = sum_views Jp^T t,  z = Hpp^{-1} y        (sym 3x3, hppinv rows)
//   tv = t - W2 (Jp z)
//   out_c[m] += Jc^T tv,  out_g += Jg^T tv;  then + extra_c*xc, extra_g*xg.
//
// Bound: device-memory bandwidth.  Every observation's 21 + 2G lean rows
// (41 at G = 10, 164 B) are read once: ~70% of its ~240 B per
// observation (with the index, the scratch below and the image layout).
// Design:
//  * one CTA per view-major block of pb points: thread tid holds lane
//    blk*V*pb + tid (view tid / pb, point tid % pb), so every row read is
//    coalesced and each row value is read exactly once and kept in
//    registers for both halves of the computation;
//  * the point reduction (sum over the V views) goes through shared memory
//    inside the CTA, and the pb point threads apply Hpp^{-1};
//  * xc[m] is an indexed load; the [M, 6] table stays in L1/L2;
//  * per-image sums are deterministic (no atomics, see common.cuh): each
//    observation writes its 6 Jc^T tv terms to an obs-major scratch row
//    (32 B, one sector), and image_reduce_kernel sums them per image
//    through the image-sorted blocked layout (img_perm / img_block_starts);
//    the 32 B written + 32 B gathered per observation add ~40% to the
//    164 B of rows it reads;
//  * the G global terms: a fixed shuffle tree per warp, warps summed in
//    order per CTA into a partials buffer, then partial_reduce_kernel.
#include "common.cuh"

namespace {

using ba::kMaxBlockThreads;
using ba::kMaxG;

__global__ void __launch_bounds__(kMaxBlockThreads)
matvec_obs_kernel(const float* __restrict__ pk, long long N, int P, int pb,
                  int G, const int* __restrict__ obs_img,
                  const float* __restrict__ hppinv,
                  const float* __restrict__ xc, const float* __restrict__ xg,
                  float* __restrict__ scratch, float* __restrict__ partial_g) {
  __shared__ float sh_jt[3 * kMaxBlockThreads];
  __shared__ float sh_z[3 * kMaxBlockThreads];
  __shared__ float sh_g[kMaxBlockThreads / 32][kMaxG];
  const ba::Offsets off(G);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // V * pb
  const int V = nthr / pb;
  const int p = tid % pb;
  const long long n = (long long)blockIdx.x * nthr + tid;
  const float* col = pk + n;  // row r of this lane at col[r * N]

  float jp[6], jc[12], jg[2 * kMaxG];
#pragma unroll
  for (int a = 0; a < 6; ++a) jp[a] = col[(long long)(off.jp + a) * N];
#pragma unroll
  for (int a = 0; a < 12; ++a) jc[a] = col[(long long)(off.jc + a) * N];
  const float wxx = col[(long long)off.w * N];
  const float wxy = col[(long long)(off.w + 1) * N];
  const float wyy = col[(long long)(off.w + 2) * N];
  const int img = obs_img[n];

  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float x = xc[img * 6 + a];
    s0 += jc[a] * x;
    s1 += jc[6 + a] * x;
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      jg[g] = col[(long long)(off.jg + g) * N];
      jg[kMaxG + g] = col[(long long)(off.jg + G + g) * N];
      s0 += jg[g] * xg[g];
      s1 += jg[kMaxG + g] * xg[g];
    }
  }
  const float t0 = wxx * s0 + wxy * s1;
  const float t1 = wxy * s0 + wyy * s1;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    sh_jt[a * nthr + tid] = jp[a] * t0 + jp[3 + a] * t1;
  __syncthreads();

  if (tid < pb) {
    const long long pt = (long long)blockIdx.x * pb + tid;
    float y[3], h[6], z[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
      for (int v = 0; v < V; ++v) s += sh_jt[a * nthr + v * pb + tid];
      y[a] = s;
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) h[r] = hppinv[(long long)r * P + pt];
    ba::sym3_apply(h, y[0], y[1], y[2], z);
#pragma unroll
    for (int a = 0; a < 3; ++a) sh_z[a * pb + tid] = z[a];
  }
  __syncthreads();

  const float z0 = sh_z[p], z1 = sh_z[pb + p], z2 = sh_z[2 * pb + p];
  const float r0 = jp[0] * z0 + jp[1] * z1 + jp[2] * z2;
  const float r1 = jp[3] * z0 + jp[4] * z1 + jp[5] * z2;
  const float tv0 = t0 - (wxx * r0 + wxy * r1);
  const float tv1 = t1 - (wxy * r0 + wyy * r1);
  float4* out = reinterpret_cast<float4*>(scratch + n * 8);
  out[0] = make_float4(jc[0] * tv0 + jc[6] * tv1, jc[1] * tv0 + jc[7] * tv1,
                       jc[2] * tv0 + jc[8] * tv1, jc[3] * tv0 + jc[9] * tv1);
  out[1] = make_float4(jc[4] * tv0 + jc[10] * tv1,
                       jc[5] * tv0 + jc[11] * tv1, 0.f, 0.f);

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float q = jg[g] * tv0 + jg[kMaxG + g] * tv1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_down_sync(0xffffffffu, q, o);
      if (lane == 0) sh_g[warp][g] = q;
    }
  }
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int w = 0; w < nthr / 32; ++w) s += sh_g[w][tid];
    partial_g[(long long)blockIdx.x * G + tid] = s;
  }
}

}  // namespace

// scratch: [N, 8] f32 (16-byte aligned); partial_g: [P / pb, G] f32.
extern "C" int ba_schur_matvec(
    const float* packed, long long N, int P, int V, int pb, int G,
    const int* obs_img, const float* hppinv, const float* xc, const float* xg,
    const float* extra_c, const float* extra_g, int M, const int* img_perm,
    const int* img_block_starts, float* scratch, float* partial_g,
    float* out_c, float* out_g, cudaStream_t stream) {
  const int nthr = V * pb;
  if (pb <= 0 || pb % 32 != 0 || nthr > ba::kMaxBlockThreads || P % pb != 0 ||
      G < 1 || G > ba::kMaxG || (long long)P * V != N || M <= 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = P / pb;
  matvec_obs_kernel<<<nblk, nthr, 0, stream>>>(packed, N, P, pb, G, obs_img,
                                               hppinv, xc, xg, scratch,
                                               partial_g);
  BA_CHECK_LAUNCH();
  ba::image_reduce_kernel<<<dim3(M, 1), dim3(8, ba::kReduceThreads / 8), 0,
                            stream>>>(scratch, 8, 6, img_perm,
                                      img_block_starts, (int)N, extra_c, xc,
                                      out_c);
  BA_CHECK_LAUNCH();
  ba::partial_reduce_kernel<<<G, ba::kReduceThreads, 0, stream>>>(
      partial_g, nblk, G, extra_g, xg, out_g);
  BA_CHECK_LAUNCH();
  return 0;
}
