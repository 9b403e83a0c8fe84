// K2: fused assembly reduction of the reduced camera system, from the full
// packed rows (lean prefix + [PJp PJc PJg Pw] tail).
//
// Replaces the Pallas kernel `_prepare_kernel` / `_prepare_sub` /
// `make_prepare_reduction` (bundle_adjustment_tpu/parallel/kernels.py:
// 575-803).  Outputs, as there:
//   red [M, 39 + 6G]: per image bc(6), Hcc diag(6), Jc^T u0(6) with
//       u0 = PJp Hpp^{-1} bp, Scc upper triangle(21), Scg(6G) -- in the row
//       order of engine.reduce_blocks;
//   rg_corr [G] = sum_n Jg u0;
//   T2 [2G, 2G] = Jg PJg^T;
//   T3 [3G, 3G] = W Hpg^T with W = Hpp^{-1} Hpg per point.
//
// Bound: device-memory bandwidth.  Each observation reads its 78 used rows
// (312 B) once and writes 39 + 6G features (396 B at G = 10) to an
// obs-major scratch that the per-image pass reads back.
// Design (same block structure as K1, schur_matvec.cu):
//  * one CTA per view-major block; thread tid holds lane blk*V*pb + tid;
//  * pass 1 per observation: Jp^T Pw (3) and Jp^T PJg (3G) into shared
//    memory; the pb point threads sum the V views, apply Hpp^{-1} (z0 and
//    W = Hpp^{-1} Hpg) and publish z0, Hpp^{-1} and W in shared memory;
//    W and Hpg rows also go to a [6G, P] scratch for T3;
//  * pass 2 per observation: the 39 + 6G features, written to the
//    obs-major scratch; Jg u0 summed per CTA (fixed shuffle tree) into
//    partials;
//  * image_reduce_kernel sums the features per image through the
//    image-sorted blocked layout; gram_kernel computes the T2 and T3 chunk
//    partials (T2 straight from the packed Jg / PJg rows);
//    partial_reduce_kernel finishes rg_corr, T2 and T3.  Every sum is
//    deterministic (common.cuh).
#include "common.cuh"

namespace {

using ba::kMaxBlockThreads;
using ba::kMaxG;

__global__ void __launch_bounds__(kMaxBlockThreads)
prepare_obs_kernel(const float* __restrict__ pk, long long N, int P, int pb,
                   int G, const float* __restrict__ hppinv,
                   float* __restrict__ feat, int fs, float* __restrict__ pg,
                   float* __restrict__ partial_rg) {
  // [(3 + 3G) * nthr] view terms, then [(9 + 3G) * pb] point values
  extern __shared__ float sh[];
  const ba::Offsets off(G);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // V * pb
  const int V = nthr / pb;
  const int p = tid % pb;
  const long long n = (long long)blockIdx.x * nthr + tid;
  const float* col = pk + n;  // row r of this lane at col[r * N]
  float* sh_obs = sh;
  float* sh_pt = sh + (3 + 3 * G) * nthr;

  float jp[6], pjg[2 * kMaxG];
#pragma unroll
  for (int a = 0; a < 6; ++a) jp[a] = col[(long long)(off.jp + a) * N];
  const float pw0 = col[(long long)off.pw * N];
  const float pw1 = col[(long long)(off.pw + 1) * N];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    sh_obs[a * nthr + tid] = jp[a] * pw0 + jp[3 + a] * pw1;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      pjg[g] = col[(long long)(off.pjg + g) * N];
      pjg[kMaxG + g] = col[(long long)(off.pjg + G + g) * N];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        sh_obs[(3 + a * G + g) * nthr + tid] =
            jp[a] * pjg[g] + jp[3 + a] * pjg[kMaxG + g];
    }
  }
  __syncthreads();

  // point values in sh_pt: z0 at rows 0-2, Hpp^{-1} at 3-8, W at 9 + a*G + g
  if (tid < pb) {
    const long long pt = (long long)blockIdx.x * pb + tid;
    float h[6], s[3], z[3];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      h[r] = hppinv[(long long)r * P + pt];
      sh_pt[(3 + r) * pb + tid] = h[r];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = 0.f;
      for (int v = 0; v < V; ++v) acc += sh_obs[a * nthr + v * pb + tid];
      s[a] = acc;
    }
    ba::sym3_apply(h, s[0], s[1], s[2], z);
#pragma unroll
    for (int a = 0; a < 3; ++a) sh_pt[a * pb + tid] = z[a];
    for (int g = 0; g < G; ++g) {
      float hg[3], w[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float acc = 0.f;
        for (int v = 0; v < V; ++v)
          acc += sh_obs[(3 + a * G + g) * nthr + v * pb + tid];
        hg[a] = acc;
      }
      ba::sym3_apply(h, hg[0], hg[1], hg[2], w);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sh_pt[(9 + a * G + g) * pb + tid] = w[a];
        pg[(long long)(a * G + g) * P + pt] = w[a];
        pg[(long long)(3 * G + a * G + g) * P + pt] = hg[a];
      }
    }
  }
  __syncthreads();

  float h[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) h[r] = sh_pt[(3 + r) * pb + p];
  const float z0 = sh_pt[p], z1 = sh_pt[pb + p], z2 = sh_pt[2 * pb + p];
  const float u0 = col[(long long)(off.pjp + 0) * N] * z0 +
                   col[(long long)(off.pjp + 1) * N] * z1 +
                   col[(long long)(off.pjp + 2) * N] * z2;
  const float u1 = col[(long long)(off.pjp + 3) * N] * z0 +
                   col[(long long)(off.pjp + 4) * N] * z1 +
                   col[(long long)(off.pjp + 5) * N] * z2;
  float jc[12], pjc[12];
#pragma unroll
  for (int a = 0; a < 12; ++a) {
    jc[a] = col[(long long)(off.jc + a) * N];
    pjc[a] = col[(long long)(off.pjc + a) * N];
  }
  float* f = feat + n * fs;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) f[k++] = jc[a] * pw0 + jc[6 + a] * pw1;
#pragma unroll
  for (int a = 0; a < 6; ++a) f[k++] = jc[a] * pjc[a] + jc[6 + a] * pjc[6 + a];
#pragma unroll
  for (int a = 0; a < 6; ++a) f[k++] = jc[a] * u0 + jc[6 + a] * u1;
  // Hpc per observation: hp[a][e] = Jp_a^T P Jc_e
  float hp[3][6];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int e = 0; e < 6; ++e)
      hp[a][e] = jp[a] * pjc[e] + jp[3 + a] * pjc[6 + e];
  // Scc upper triangle: Hcc - Hcp Hpp^{-1} Hpc (21)
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    float he[3];
    ba::sym3_apply(h, hp[0][e], hp[1][e], hp[2][e], he);
#pragma unroll
    for (int f2 = e; f2 < 6; ++f2) {
      const float jpj = jc[e] * pjc[f2] + jc[6 + e] * pjc[6 + f2];
      f[k++] = jpj - (he[0] * hp[0][f2] + he[1] * hp[1][f2] +
                      he[2] * hp[2][f2]);
    }
  }
  // Scg: Hcg - Hcp Hpp^{-1} Hpg (6G)
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float hcg = jc[e] * pjg[g] + jc[6 + e] * pjg[kMaxG + g];
        const float corr = hp[0][e] * sh_pt[(9 + g) * pb + p] +
                           hp[1][e] * sh_pt[(9 + G + g) * pb + p] +
                           hp[2][e] * sh_pt[(9 + 2 * G + g) * pb + p];
        f[k++] = hcg - corr;
      }
    }
  }

  // rg correction: sum_n Jg u0, per CTA (the view terms in sh_obs are dead:
  // every read of them finished before the last barrier)
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float q = col[(long long)(off.jg + g) * N] * u0 +
                col[(long long)(off.jg + G + g) * N] * u1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_down_sync(0xffffffffu, q, o);
      if (lane == 0) sh_obs[warp * G + g] = q;
    }
  }
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int w = 0; w < nthr / 32; ++w) s += sh_obs[w * G + tid];
    partial_rg[(long long)blockIdx.x * G + tid] = s;
  }
}

}  // namespace

// Scratch (all f32): feat [N, fs] with fs >= 39 + 6G, pg [6G, P],
// partial_rg [P / pb, G], partial_t2 [n_chunks, 4G^2],
// partial_t3 [n_chunks, 9G^2].
extern "C" int ba_prepare_reduction(
    const float* packed, long long N, int P, int V, int pb, int G, int M,
    const float* hppinv, const int* img_perm, const int* img_block_starts,
    float* feat, int fs, float* pg, float* partial_rg, float* partial_t2,
    float* partial_t3, int n_chunks, float* red, float* rg_corr, float* t2,
    float* t3, cudaStream_t stream) {
  const int nthr = V * pb;
  const int F = 39 + 6 * G;
  if (pb <= 0 || pb % 32 != 0 || nthr > ba::kMaxBlockThreads || P % pb != 0 ||
      G < 1 || G > ba::kMaxG || (long long)P * V != N || M <= 0 || fs < F ||
      n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int nblk = P / pb;
  const ba::Offsets off(G);
  const size_t smem =
      (size_t)((3 + 3 * G) * nthr + (9 + 3 * G) * pb) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      prepare_obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  prepare_obs_kernel<<<nblk, nthr, smem, stream>>>(packed, N, P, pb, G, hppinv,
                                                   feat, fs, pg, partial_rg);
  BA_CHECK_LAUNCH();
  ba::image_reduce_kernel<<<dim3(M, (F + 31) / 32),
                            dim3(32, ba::kReduceThreads / 32), 0, stream>>>(
      feat, fs, F, img_perm, img_block_starts, (int)N, nullptr, nullptr, red);
  BA_CHECK_LAUNCH();
  const long long chunk_n = (N + n_chunks - 1) / n_chunks;
  const long long chunk_p = (P + n_chunks - 1) / n_chunks;
  ba::gram_kernel<<<n_chunks, ba::kGramThreads, 0, stream>>>(
      packed + (long long)off.jg * N, 2 * G, packed + (long long)off.pjg * N,
      2 * G, N, N, chunk_n, partial_t2);
  BA_CHECK_LAUNCH();
  ba::gram_kernel<<<n_chunks, ba::kGramThreads, 0, stream>>>(
      pg, 3 * G, pg + (long long)3 * G * P, 3 * G, P, P, chunk_p, partial_t3);
  BA_CHECK_LAUNCH();
  ba::partial_reduce_kernel<<<G, ba::kReduceThreads, 0, stream>>>(
      partial_rg, nblk, G, nullptr, nullptr, rg_corr);
  BA_CHECK_LAUNCH();
  ba::partial_reduce_kernel<<<4 * G * G, ba::kReduceThreads, 0, stream>>>(
      partial_t2, n_chunks, 4 * G * G, nullptr, nullptr, t2);
  BA_CHECK_LAUNCH();
  ba::partial_reduce_kernel<<<9 * G * G, ba::kReduceThreads, 0, stream>>>(
      partial_t3, n_chunks, 9 * G * G, nullptr, nullptr, t3);
  BA_CHECK_LAUNCH();
  return 0;
}
