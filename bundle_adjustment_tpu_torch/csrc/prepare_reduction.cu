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
// Bound: device-memory bandwidth.  What the function must move at the scale
// shape (N = 1,204,224, P = 100,352, M = 500, G = 10) is its 78 rows (Jp, Jc,
// Jg, PJp, PJc, PJg, Pw: 375.7 MB) and the Hpp^{-1} rows (2.4 MB), each once,
// and 0.2 MB of outputs: 378.3 MB, 0.1129 ms at the 3.35 TB/s of an H100 SXM
// (measure.k2_work).  A deterministic per-image sum over view-major blocks
// needs the features of every observation once more in image order: its own
// scratch (104 floats per observation written and read, 1.0 GB) outweighs
// the input, so the design writes and reads it at full width.
// Design (the ring and the persistent grid of K1, common.cuh):
//  * a tile is the 78 rows of one view-major block, the six Hpp^{-1} row
//    segments of its points and its image-sorted positions, brought into
//    shared memory by asynchronous bulk copies; every value is read from
//    there where it is needed, so no register array depends on G.  The ring
//    takes as many stages as fit beside the kernel's own shared memory (one
//    at V * pb = 384, G = 10, where a tile is 119 KB: splitting the rows
//    into two groups with rings of their own, so that the group the point
//    stage needs is a tile ahead, was measured and was not faster, because
//    the second ring takes the room of the feature chunks);
//  * the point stage uses every warp: a unit of work is (point, column) for
//    the 1 + G columns Pw and PJg; its thread sums Jp^T column over the V
//    views in view order straight from the tile, applies Hpp^{-1} and
//    publishes z0, W and Hpg in shared memory;
//  * T3 and T2 are summed inside the tile pass: a thread owns fixed outputs
//    of W Hpg^T and adds the tile's points in order; a warp owns fixed
//    outputs of Jg PJg^T, its lanes add the tile's lanes in order and a
//    fixed shuffle tree joins them.  Both go to partials indexed by the
//    block, finished by the two-pass column sum, so the order of every sum
//    is a function of the block index alone;
//  * the 39 + 6G features of an observation leave at its image-sorted
//    position as asynchronous bulk copies too: a thread stages a chunk of its
//    observation's columns in its own row of shared memory and hands the row
//    to the copy engine (one contiguous run of whole 32-byte sectors), then
//    computes the next chunk while the row drains; the rows are private, so
//    this phase has no barrier, and the last chunk of a tile drains under
//    the next tile's loads and point stage.  A chunk pass computes only the
//    features of its columns; a chunk is as wide as the shared memory beside
//    the ring allows (56 columns at the scale shape);
//  * the per-image pass is K1's streaming two-level sum (block_sum_kernel,
//    finish_kernel) at 39 + 6G columns; Jg u0 is summed per warp (fixed
//    shuffle tree), per tile in warp order, then by finish_kernel.
#include "common.cuh"

namespace {

using ba::kMaxBlockThreads;
using ba::kMaxG;

constexpr int kMaxWarps = kMaxBlockThreads / 32;
constexpr int kChunkStep = 8;  // feature chunks are multiples of 8 columns

constexpr int kRowPad = 4;  // staged rows stay 16-byte aligned

// The kernel's own shared memory behind the ring, in floats: the staged
// features [nthr][cw + kRowPad], the point values [(3 + 6G)][pb + 1], the
// per-warp Jg u0 sums [kMaxWarps][kMaxG].
inline int prepare_user_bytes(int nthr, int pb, int G, int cw) {
  return (nthr * (cw + kRowPad) + (3 + 6 * G) * (pb + 1) + kMaxWarps * kMaxG) *
         (int)sizeof(float);
}

// Sources of a tile, in plan order: 0 the rows Jp Jc Jg, 1 the rows PJp PJc
// PJg Pw (together one [38 + 4G][nthr] array), 2 the Hpp^{-1} row segments,
// 3 img_pos.
// feat: [n_img_blocks * 512, fs] image-sorted feature rows; partial_rg:
// [nblk, G]; partial_t: [nblk, 13 G^2] (T2 then T3).
__global__ void __launch_bounds__(kMaxBlockThreads + ba::kProducerThreads)
prepare_kernel(const ba::RingPlan plan, int nblk, int pb, int G, int cw,
               float* __restrict__ feat, int fs,
               float* __restrict__ partial_rg, float* __restrict__ partial_t) {
  extern __shared__ __align__(128) char smem[];
  const int nthr = blockDim.x - ba::kProducerThreads;  // V * pb
  const int tid = threadIdx.x;
  if (tid == 0) ba::ring_init(smem, plan, nthr / 32);
  __syncthreads();
  if (tid >= nthr) {
    ba::ring_produce(plan, smem, nblk);
    return;
  }
  const int pitch = pb + 1, spitch = cw + kRowPad;
  float* stg = reinterpret_cast<float*>(ba::ring_user(plan, smem));
  float* sh_pt = stg + nthr * spitch;
  float* sh_rg = sh_pt + (3 + 6 * G) * pitch;

  // tile rows
  const int rJp = 0, rJc = 6, rJg = 18, rPJp = 18 + 2 * G, rPJc = rPJp + 6,
            rPJg = rPJp + 18, rPw = rPJg + 2 * G;
  // point rows of sh_pt: z0 at 0-2, W at 3 + a*G + g, Hpg at 3 + 3G + a*G + g
  const int pW = 3, pH = 3 + 3 * G;
  const int V = nthr / pb;
  const int p = tid % pb;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int F = 39 + 6 * G;
  const int n2 = 4 * G * G, n3 = 9 * G * G;

  int it = 0;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
    const char* st = ba::ring_wait(plan, smem, it);
    const float* T = reinterpret_cast<const float*>(st);  // [38 + 4G][nthr]
    const float* hp = reinterpret_cast<const float*>(st + plan.dst_off[2]);
    const int* pos = reinterpret_cast<const int*>(st + plan.dst_off[3]);

    // ---- point stage: unit (column j, point q) ---------------------------
    for (int u = tid; u < (1 + G) * pb; u += nthr) {
      const int q = u % pb, j = u / pb;
      const float* c0 = T + (j == 0 ? rPw : rPJg + j - 1) * nthr + q;
      const float* c1 = T + (j == 0 ? rPw + 1 : rPJg + G + j - 1) * nthr + q;
      const float* jp = T + rJp * nthr + q;
      float hg[3] = {0.f, 0.f, 0.f};
      for (int v = 0; v < V; ++v) {
        const int o = v * pb;
        const float a0 = c0[o], a1 = c1[o];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float term = jp[a * nthr + o] * a0 + jp[(3 + a) * nthr + o] * a1;
          hg[a] += term;
        }
      }
      float h[6], w[3];
#pragma unroll
      for (int r = 0; r < 6; ++r) h[r] = hp[r * pb + q];
      ba::sym3_apply(h, hg[0], hg[1], hg[2], w);
      if (j == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) sh_pt[a * pitch + q] = w[a];
      } else {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          sh_pt[(pW + a * G + j - 1) * pitch + q] = w[a];
          sh_pt[(pH + a * G + j - 1) * pitch + q] = hg[a];
        }
      }
    }
    ba::consumer_sync(nthr);

    // ---- T3 = W Hpg^T over the tile's points, one thread per output -------
    float* pt = partial_t + (long long)blk * (n2 + n3);
    for (int o = tid; o < n3; o += nthr) {
      const float* wr = sh_pt + (pW + o / (3 * G)) * pitch;
      const float* hr = sh_pt + (pH + o % (3 * G)) * pitch;
      float s = 0.f;
      for (int q = 0; q < pb; ++q) s += wr[q] * hr[q];
      pt[n2 + o] = s;
    }
    // ---- T2 = Jg PJg^T over the tile's lanes: a warp owns 4 x 4 blocks of
    // outputs (each row value it loads serves four products), its lanes add
    // the tile's lanes in order and a fixed shuffle tree joins them ---------
    const int nrow = 2 * G, nb4 = (nrow + 3) / 4;
    for (int bi = warp; bi < nb4 * nb4; bi += nwarps) {
      const int i0 = (bi / nb4) * 4, j0 = (bi % nb4) * 4;
      const float* ar[4];
      const float* br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // rows past the edge repeat the last row; their sums are dropped
        ar[a] = T + (rJg + (i0 + a < nrow ? i0 + a : nrow - 1)) * nthr;
        br[a] = T + (rPJg + (j0 + a < nrow ? j0 + a : nrow - 1)) * nthr;
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int l = lane; l < nthr; l += 32) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          av[a] = ar[a][l];
          bv[a] = br[a][l];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += av[a] * bv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[a][c];
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, d);
          if (lane == 0 && i0 + a < nrow && j0 + c < nrow)
            pt[(i0 + a) * nrow + j0 + c] = s;
        }
    }

    // ---- u0 = PJp z0 and the rg correction sum_n Jg u0 --------------------
    const float* R = T + tid;  // row r of this lane at R[r * nthr]
    const float z0 = sh_pt[p], z1 = sh_pt[pitch + p], z2 = sh_pt[2 * pitch + p];
    const float u0 = R[rPJp * nthr] * z0 + R[(rPJp + 1) * nthr] * z1 +
                     R[(rPJp + 2) * nthr] * z2;
    const float u1 = R[(rPJp + 3) * nthr] * z0 + R[(rPJp + 4) * nthr] * z1 +
                     R[(rPJp + 5) * nthr] * z2;
    for (int g = 0; g < G; ++g) {
      float q = R[(rJg + g) * nthr] * u0 + R[(rJg + G + g) * nthr] * u1;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) q += __shfl_down_sync(0xffffffffu, q, d);
      if (lane == 0) sh_rg[warp * kMaxG + g] = q;
    }

    // ---- features, a chunk of columns [k0, k0 + cw) at a time: staged in
    // this thread's own row, then one bulk copy to the observation's row ----
    float* srow = stg + tid * spitch;
    float* grow = feat + (long long)pos[tid] * fs;
    for (int k0 = 0; k0 < fs; k0 += cw) {
      const int k1 = k0 + cw;
      ba::bulk_wait_read();  // the row's earlier copy has left it
      auto emit = [&](int k, float v) {
        const unsigned d = (unsigned)(k - k0);
        if (d < (unsigned)cw) srow[d] = v;
      };
      float jc[12];
#pragma unroll
      for (int a = 0; a < 12; ++a) jc[a] = R[(rJc + a) * nthr];
      if (k0 < 18) {
        const float pw0 = R[rPw * nthr], pw1 = R[(rPw + 1) * nthr];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          emit(a, jc[a] * pw0 + jc[6 + a] * pw1);
          emit(6 + a, jc[a] * R[(rPJc + a) * nthr] +
                          jc[6 + a] * R[(rPJc + 6 + a) * nthr]);
          emit(12 + a, jc[a] * u0 + jc[6 + a] * u1);
        }
      }
      if (k1 > 18 && k0 < F) {
        // Hpc per observation: hpc[a][e] = Jp_a^T P Jc_e
        float jp[6], pjc[12], hpc[3][6];
#pragma unroll
        for (int a = 0; a < 6; ++a) jp[a] = R[(rJp + a) * nthr];
#pragma unroll
        for (int a = 0; a < 12; ++a) pjc[a] = R[(rPJc + a) * nthr];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int e = 0; e < 6; ++e)
            hpc[a][e] = jp[a] * pjc[e] + jp[3 + a] * pjc[6 + e];
        if (k0 < 39) {
          // Scc upper triangle: Hcc - Hcp Hpp^{-1} Hpc (21)
          float h[6];
#pragma unroll
          for (int r = 0; r < 6; ++r) h[r] = hp[r * pb + p];
          int k = 18;
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            float he[3];
            ba::sym3_apply(h, hpc[0][e], hpc[1][e], hpc[2][e], he);
#pragma unroll
            for (int f2 = e; f2 < 6; ++f2) {
              const float jpj = jc[e] * pjc[f2] + jc[6 + e] * pjc[6 + f2];
              emit(k++, jpj - (he[0] * hpc[0][f2] + he[1] * hpc[1][f2] +
                               he[2] * hpc[2][f2]));
            }
          }
        }
        if (k1 > 39) {
          // Scg: Hcg - Hcp Hpp^{-1} Hpg (6G), column 39 + e*G + g; only
          // the camera parameters e whose columns meet this chunk
          const int e_lo = k0 <= 39 ? 0 : (k0 - 39) / G;
          const int e_hi = (k1 - 40) / G;
          for (int g = 0; g < G; ++g) {
            const float pg0 = R[(rPJg + g) * nthr];
            const float pg1 = R[(rPJg + G + g) * nthr];
            const float w0 = sh_pt[(pW + g) * pitch + p];
            const float w1 = sh_pt[(pW + G + g) * pitch + p];
            const float w2 = sh_pt[(pW + 2 * G + g) * pitch + p];
#pragma unroll
            for (int e = 0; e < 6; ++e) {
              if (e >= e_lo && e <= e_hi) {
                const float hcg = jc[e] * pg0 + jc[6 + e] * pg1;
                const float corr =
                    hpc[0][e] * w0 + hpc[1][e] * w1 + hpc[2][e] * w2;
                emit(39 + e * G + g, hcg - corr);
              }
            }
          }
        }
      }
      // the pad columns [F, fs) are written as zeros
      for (int k = (F > k0 ? F : k0); k < fs && k < k1; ++k) srow[k - k0] = 0.f;
      const int wd = fs - k0 < cw ? fs - k0 : cw;
      ba::fence_proxy_async();
      ba::bulk_copy_s2g(grow + k0, srow, (uint32_t)wd * sizeof(float));
      ba::bulk_commit();
    }
    // One barrier closes the tile: the per-warp Jg u0 sums are visible, and
    // no thread still reads the point values the next tile overwrites.
    ba::consumer_sync(nthr);
    if (tid < G) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += sh_rg[w * kMaxG + tid];
      partial_rg[(long long)blk * G + tid] = s;
    }
    ba::ring_release(plan, smem, it);
  }
  ba::bulk_wait();
}

// K2's ring plan and launch size, shared by the launch and `ba_prepare_fits`:
// the tile's four sources, then the feature chunk: 32 columns if a stage fits
// beside them, else 8; then as wide as the shared memory left over allows
// (fewer, larger bulk copies).  False when not even one stage fits beside
// the narrowest chunk (or a source breaks the bulk copy's alignment rules).
bool prepare_plan(const float* packed, long long N, int P, int pb, int nthr,
                  int G, int fs, const float* hppinv, const int* img_pos,
                  const ba::DeviceLimits& lim, ba::RingPlan* plan, int* cw,
                  int* smem) {
  const long long f4 = sizeof(float);
  const ba::Offsets off(G);
  *plan = {};
  if (!ba::ring_add(plan, packed, N * f4, nthr * f4, 18 + 2 * G,
                    nthr * (int)f4) ||
      !ba::ring_add(plan, packed + (long long)off.pjp * N, N * f4, nthr * f4,
                    20 + 2 * G, nthr * (int)f4) ||
      !ba::ring_add(plan, hppinv, P * f4, pb * f4, 6, pb * (int)f4) ||
      !ba::ring_add(plan, img_pos, 0, nthr * f4, 1, nthr * (int)f4))
    return false;
  *cw = fs < 32 ? fs : 32;
  if (!ba::ring_fit(plan, prepare_user_bytes(nthr, pb, G, *cw), lim, smem)) {
    *cw = kChunkStep;
    if (!ba::ring_fit(plan, prepare_user_bytes(nthr, pb, G, *cw), lim, smem))
      return false;
  }
  while (*cw + kChunkStep <= fs &&
         *smem + nthr * kChunkStep * (int)f4 <= lim.max_smem) {
    *cw += kChunkStep;
    *smem += nthr * kChunkStep * (int)f4;
  }
  return true;
}

bool prepare_shape_ok(int P, int V, int pb, int G) {
  return pb > 0 && pb % 32 == 0 && V > 0 && V * pb <= ba::kMaxBlockThreads &&
         P % pb == 0 && G >= 1 && G <= ba::kMaxG;
}

}  // namespace

// Whether K2 launches at point block pb, V views and G global parameters:
// 1 if its tile fits the shared memory a block may opt in to (max_smem
// bytes, or the current card's own limit when max_smem <= 0), 0 if the
// launch would refuse it, a negative CUDA error if the card cannot be
// queried.  The same plan as the launch, on one block of aligned stand-in
// addresses (kernels.k2_tile_fits is held against it).
extern "C" int ba_prepare_fits(int pb, int V, int G, int max_smem) {
  if (!prepare_shape_ok(pb, V, pb, G)) return 0;
  ba::DeviceLimits lim = {1, max_smem};
  if (max_smem <= 0) {
    cudaError_t e = ba::device_limits(&lim);
    if (e != cudaSuccess) return -(int)e;
  }
  const int nthr = V * pb;
  const int fs = (39 + 6 * G + kChunkStep - 1) / kChunkStep * kChunkStep;
  const float* base = reinterpret_cast<const float*>(alignof(float4) * 64);
  ba::RingPlan plan;
  int cw = 0, smem = 0;
  return prepare_plan(base, nthr, pb, pb, nthr, G, fs, base,
                      reinterpret_cast<const int*>(base), lim, &plan, &cw,
                      &smem)
             ? 1
             : 0;
}

// Scratch (all f32): feat [n_img_blocks * 512 + n_img_blocks, fs] (the
// image-sorted feature rows, then the block sums) with fs >= 39 + 6G a
// multiple of 8; partial_rg [P / pb, G]; partial_t [P / pb + kColChunks,
// 13 G^2] (the per-block T2 and T3 sums, then the chunk sums).
// Outputs: red [M, 39 + 6G], rg_corr [G], t23 [13 G^2] (T2 then T3).
extern "C" int ba_prepare_reduction(
    const float* packed, long long N, int P, int V, int pb, int G, int M,
    const float* hppinv, const int* img_pos, const int* img_block_valid,
    const int* img_block_starts, int n_img_blocks, float* feat, int fs,
    float* partial_rg, float* partial_t, float* red, float* rg_corr,
    float* t23, cudaStream_t stream) {
  const int nthr = V * pb;
  const int F = 39 + 6 * G;
  if (!prepare_shape_ok(P, V, pb, G) || (long long)P * V != N || M <= 0 ||
      fs < F || fs % kChunkStep != 0 || n_img_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = P / pb;
  ba::DeviceLimits lim;
  cudaError_t e = ba::device_limits(&lim);
  if (e != cudaSuccess) return (int)e;
  ba::RingPlan plan;
  int cw = 0, smem = 0;
  if (!prepare_plan(packed, N, P, pb, nthr, G, fs, hppinv, img_pos, lim,
                    &plan, &cw, &smem))
    return (int)cudaErrorInvalidValue;
  BA_ALLOW_SMEM(prepare_kernel, lim.max_smem);
  prepare_kernel<<<ba::ring_grid(lim, nblk), nthr + ba::kProducerThreads, smem,
                   stream>>>(plan, nblk, pb, G, cw, feat, fs, partial_rg,
                             partial_t);
  BA_CHECK_LAUNCH();
  const int fs4 = fs / 4;
  float* bsum = feat + (long long)n_img_blocks * ba::kImgBlock * fs;
  ba::block_sum_kernel<<<n_img_blocks, dim3(fs4, ba::block_sum_lanes(fs4)), 0,
                         stream>>>(
      reinterpret_cast<const float4*>(feat), fs4, img_block_valid,
      reinterpret_cast<float4*>(bsum));
  BA_CHECK_LAUNCH();
  const int img_ctas = (M * F + ba::kReduceThreads - 1) / ba::kReduceThreads;
  ba::finish_kernel<<<img_ctas + G, ba::kReduceThreads, 0, stream>>>(
      bsum, fs, F, M, img_block_starts, nullptr, nullptr, red, img_ctas,
      partial_rg, nblk, G, nullptr, nullptr, rg_corr);
  BA_CHECK_LAUNCH();
  const int K = 13 * G * G;
  const dim3 block(ba::kColTile, ba::kReduceThreads / ba::kColTile);
  float* chunk_sums = partial_t + (long long)nblk * K;
  ba::column_sum_kernel<<<dim3((K + ba::kColTile - 1) / ba::kColTile,
                               ba::kColChunks),
                          block, 0, stream>>>(
      partial_t, nblk, K, (nblk + ba::kColChunks - 1) / ba::kColChunks,
      nullptr, 0.f, chunk_sums);
  BA_CHECK_LAUNCH();
  ba::column_sum_kernel<<<dim3((K + ba::kColTile - 1) / ba::kColTile, 1), block,
                          0, stream>>>(chunk_sums, ba::kColChunks, K,
                                       ba::kColChunks, nullptr, 0.f, t23);
  BA_CHECK_LAUNCH();
  return 0;
}
