// Shared pieces of the Hopper kernels of the scale solver: the packed-row
// contract (parallel/kernels.py `_offsets`) and the deterministic
// reduction passes that K1 and K2 end with.
//
// Determinism: every sum here is taken in a fixed order (per-thread
// sequential loops, fixed shuffle/shared-memory trees, partials reduced in
// block order).  No atomics: the CG stall rule (parallel/rcs.py `pcg`)
// reacts to residual noise, so the same inputs must give the same bits on
// every run.
#pragma once

#include <cuda_runtime.h>

namespace ba {

constexpr int kImgBlock = 512;         // rcs.IMG_BLOCK
constexpr int kMaxG = 16;              // global parameters the kernels take
constexpr int kMaxBlockThreads = 512;  // V * pb of one view-major block
constexpr int kReduceThreads = 256;

// Row offsets of the packed [F, N] layout: the lean prefix
// [Jp(6) Jc(12) Jg(2G) wxx wxy wyy] padded to a multiple of 8 rows, then the
// tail [PJp(6) PJc(12) PJg(2G) Pw(2)].
struct Offsets {
  int jp, jc, jg, w, lean_pad, pjp, pjc, pjg, pw;
  __host__ __device__ explicit Offsets(int G)
      : jp(0), jc(6), jg(18), w(18 + 2 * G),
        lean_pad(((21 + 2 * G + 7) / 8) * 8),
        pjp(lean_pad), pjc(lean_pad + 6), pjg(lean_pad + 18),
        pw(lean_pad + 18 + 2 * G) {}
};

// Symmetric 3x3 apply: h = (00, 01, 02, 11, 12, 22).
__device__ __forceinline__ void sym3_apply(const float* h, float a0, float a1,
                                           float a2, float* out) {
  out[0] = h[0] * a0 + h[1] * a1 + h[2] * a2;
  out[1] = h[1] * a0 + h[3] * a1 + h[4] * a2;
  out[2] = h[2] * a0 + h[4] * a1 + h[5] * a2;
}

// Per-image sums through the image-sorted blocked layout:
//   out[m, f] = sum_{e in image m's blocks, perm[e] < N} feat[perm[e], f]
//               (+ extra[m, f] * x[m, f] when extra is given).
// Grid (M, ceil(F / blockDim.x)); block (feature lanes, entry lanes) with
// blockDim.x * blockDim.y == kReduceThreads.  Thread (f, j) sums the
// entries j, j + blockDim.y, ... in order; thread j == 0 adds the entry
// lanes in order.  A warp reads whole 32-float feature rows of one
// observation (obs-major scratch), so the gather stays sector-efficient.
static __global__ void image_reduce_kernel(
    const float* __restrict__ feat, int fs, int F,
    const int* __restrict__ perm, const int* __restrict__ bstarts, int N,
    const float* __restrict__ extra, const float* __restrict__ x,
    float* __restrict__ out) {
  __shared__ float sh[kReduceThreads];
  const int m = blockIdx.x;
  const int fx = threadIdx.x, j = threadIdx.y;
  const int f = blockIdx.y * blockDim.x + fx;
  const long long e0 = (long long)bstarts[m] * kImgBlock;
  const long long e1 = (long long)bstarts[m + 1] * kImgBlock;
  float acc = 0.f;
  if (f < F) {
    for (long long e = e0 + j; e < e1; e += blockDim.y) {
      const int src = perm[e];
      if (src < N) acc += feat[(long long)src * fs + f];
    }
  }
  sh[j * blockDim.x + fx] = acc;
  __syncthreads();
  if (j == 0 && f < F) {
    float s = 0.f;
    for (int jj = 0; jj < (int)blockDim.y; ++jj) s += sh[jj * blockDim.x + fx];
    const long long o = (long long)m * F + f;
    if (extra != nullptr) s += extra[o] * x[o];
    out[o] = s;
  }
}

// out[k] = sum_c part[c, k] (+ extra[k] * x[k]): one block per k, strided
// partial sums then a fixed shared-memory tree.  blockDim.x ==
// kReduceThreads.
static __global__ void partial_reduce_kernel(
    const float* __restrict__ part, int C, int K,
    const float* __restrict__ extra, const float* __restrict__ x,
    float* __restrict__ out) {
  __shared__ float sh[kReduceThreads];
  const int k = blockIdx.x;
  float acc = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    acc += part[(long long)c * K + k];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float r = sh[0];
    if (extra != nullptr) r += extra[k] * x[k];
    out[k] = r;
  }
}

constexpr int kGramTile = 32;
constexpr int kGramMaxRows = 3 * kMaxG;
constexpr int kGramThreads = 256;
constexpr int kGramMaxOut =
    (kGramMaxRows * kGramMaxRows + kGramThreads - 1) / kGramThreads;

// Chunked small Gram product: part[c, i * rb + j] = sum over the lanes l of
// chunk c of A[i, l] * B[j, l], for row-major A [ra, L] and B [rb, L] with
// row stride ld.  Tiles of kGramTile lanes are staged in shared memory
// (row pitch kGramTile + 1: the j-varying reads of a warp hit distinct
// banks); each thread owns up to kGramMaxOut outputs and sums them in lane
// order.  blockDim.x == kGramThreads.
static __global__ void gram_kernel(const float* __restrict__ A, int ra,
                                   const float* __restrict__ B, int rb,
                                   long long ld, long long L, long long chunk,
                                   float* __restrict__ part) {
  __shared__ float sA[kGramMaxRows][kGramTile + 1];
  __shared__ float sB[kGramMaxRows][kGramTile + 1];
  const int tid = threadIdx.x;
  const int nout = ra * rb;
  float acc[kGramMaxOut];
#pragma unroll
  for (int k = 0; k < kGramMaxOut; ++k) acc[k] = 0.f;
  const long long l0 = (long long)blockIdx.x * chunk;
  const long long l1 = (l0 + chunk < L) ? l0 + chunk : L;
  for (long long t0 = l0; t0 < l1; t0 += kGramTile) {
    for (int q = tid; q < (ra + rb) * kGramTile; q += blockDim.x) {
      const int r = q / kGramTile, l = q % kGramTile;
      const long long lane = t0 + l;
      if (r < ra) {
        sA[r][l] = lane < l1 ? A[(long long)r * ld + lane] : 0.f;
      } else {
        sB[r - ra][l] = lane < l1 ? B[(long long)(r - ra) * ld + lane] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGramMaxOut; ++k) {
      const int o = tid + k * kGramThreads;
      if (o < nout) {
        const int i = o / rb, j = o % rb;
        float s = acc[k];
#pragma unroll 8
        for (int l = 0; l < kGramTile; ++l) s += sA[i][l] * sB[j][l];
        acc[k] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kGramMaxOut; ++k) {
    const int o = tid + k * kGramThreads;
    if (o < nout) part[(long long)blockIdx.x * nout + o] = acc[k];
  }
}

}  // namespace ba

#define BA_CHECK_LAUNCH()                      \
  do {                                         \
    cudaError_t _e = cudaGetLastError();       \
    if (_e != cudaSuccess) return (int)_e;     \
  } while (0)
