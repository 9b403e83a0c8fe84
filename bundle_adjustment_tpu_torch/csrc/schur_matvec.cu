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
// Bound: device-memory bandwidth.  What the function must move at the scale
// shape (N = 1,204,224, P = 100,352, M = 500, G = 10) is the 41 lean rows
// (197.5 MB), the image index (4.8 MB) and the Hpp^{-1} rows (2.4 MB), each
// once: 204.7 MB, 0.0611 ms at the 3.35 TB/s of an H100 SXM
// (measure.k1_work).  Its own scratch (32 B written and 32 B read per
// observation, 4 B of image position read) adds 82 MB.
// Design:
//  * the rows arrive by asynchronous bulk copies into a ring of tiles in
//    shared memory (common.cuh): a tile is one view-major block, its lean
//    rows, image indices, image-sorted positions and the six Hpp^{-1} row
//    segments of its pb points (65 KB at V * pb = 384, three stages); a
//    persistent grid of one CTA per SM walks the blocks, and the loads in
//    flight are held by shared memory, not by registers;
//  * consumer thread tid holds lane tid of the tile (view tid / pb, point
//    tid % pb); it reads each row value from shared memory where it needs it
//    (Jg twice), so no register array depends on G;
//  * the point reduction takes one barrier per tile and every warp: each
//    lane writes its three Jp^T t terms to shared memory, and after the
//    barrier every lane sums its own point's V views in view order and
//    applies Hpp^{-1} (already in the tile) itself; the V lanes of a point
//    repeat the same sum in the same order, so they agree to the bit.  The
//    terms are double-buffered, so the next tile needs no second barrier;
//  * xc[m] is an indexed load; the [M, 6] table stays in L1/L2;
//  * per-image sums are deterministic (no atomics) and streamed: each
//    observation writes its 6 Jc^T tv terms as one 32-byte sector at its
//    image-sorted position (img_pos), then block_sum_kernel and
//    finish_kernel (common.cuh) sum each image's contiguous rows in a fixed
//    two-level order;
//  * the G global terms: a fixed shuffle tree per warp, the warps of a tile
//    added in order into partials indexed by the block (the hand-over uses
//    the next tile's barrier), then the tree of finish_kernel.
//
// Stage probes (`ba_matvec_stage`, parallel/kernels.py `matvec_stage`) replace
// the Pallas K1 ablations of the TPU measurement scripts: `make_variant`
// (tools/exp_tpu1.py:168), `make_matvec2` (tools/exp_tpu2.py:158),
// `make_floor` (tools/exp_tpu2.py:238) and `make_stage` (tools/exp_tpu3.py:137,
// tools/exp_tpu4.py:116).  The per-observation kernel below is a template on
// the stage; kFull is K1's production instantiation, and the cut ones add
// one piece of K1 at a time on K1's lean layout, grid and CTA shape:
//   kRowmath  reads every lean row, obs_img and hppinv and does all the
//             per-observation row math; lane-local stand-ins replace the
//             xc gather (x = xc[0] + obs_img), the point reduction (each lane
//             applies its point's Hpp^{-1} to its own Jp^T t) and the
//             per-image sum (a global sum of the six Jc^T tv rows, through
//             the same warp/partials path as the G global terms);
//   kPointred + the sum over views through shared memory (every lane sums
//             its point's views) before the Hpp^{-1} apply;
//   kGather   + the real xc[obs_img] load;
//   kFull     + the image-sorted scratch and the per-image pass: K1.
// The read floor (csrc/read_floor.cu) is the TPU scripts' `dma` stage: the
// same ring with consumers that only fold.  Each stand-in output depends on
// every value its stage reads, so no load can be dropped by the compiler.
// The TPU scripts' `onehot` stage and `bf16` / `bf16all` modes measured how
// the TPU gathered through its matrix unit and at what precision; here the
// gather is the indexed load of kGather, and K1 stays exact f32.
// `make_matvec2`'s pb/H sweep has one point on this card: at V = 12,
// kernels.choose_pb admits only pb = 32 (384 threads), which is K1's own
// block size.
#include "common.cuh"

namespace {

using ba::kMaxBlockThreads;
using ba::kMaxG;

enum Stage { kRowmath = 0, kPointred = 1, kGather = 2, kFull = 3 };

constexpr int kSlots = kMaxG + 6;  // G global terms (+ six Jc^T tv sums)
constexpr int kMaxWarps = kMaxBlockThreads / 32;

// The kernel's own shared memory behind the ring: the Jp^T t terms
// [2][3][nthr], the per-warp sums [2][kMaxWarps][kSlots], xg [kMaxG].
inline int matvec_user_bytes(int nthr) {
  return (6 * nthr + 2 * kMaxWarps * kSlots + kMaxG) * (int)sizeof(float);
}

// Sources of a tile, in plan order: 0 the lean rows, 1 obs_img, 2 the
// Hpp^{-1} row segments, 3 img_pos (kFull only).
// partial_g: [nblk, G] for kFull; [nblk, G + 6] (G global terms, then the
// six Jc^T tv sums) for the cut stages, which write no scratch.
template <int kStage>
__global__ void __launch_bounds__(kMaxBlockThreads + ba::kProducerThreads)
matvec_kernel(const ba::RingPlan plan, int nblk, int pb, int G,
              const float* __restrict__ xc, const float* __restrict__ xg,
              float* __restrict__ scratch, float* __restrict__ partial_g) {
  extern __shared__ __align__(128) char smem[];
  constexpr bool kImageSum = kStage == kFull;
  const int nthr = blockDim.x - ba::kProducerThreads;  // V * pb
  const int tid = threadIdx.x;
  if (tid == 0) ba::ring_init(smem, plan, nthr / 32);
  __syncthreads();
  if (tid >= nthr) {
    ba::ring_produce(plan, smem, nblk);
    return;
  }
  float* sh_jt = reinterpret_cast<float*>(ba::ring_user(plan, smem));
  float* sh_g = sh_jt + 6 * nthr;
  float* sh_xg = sh_g + 2 * kMaxWarps * kSlots;

  const ba::Offsets off(G);
  const int V = nthr / pb;
  const int p = tid % pb;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int nslots = kImageSum ? G : G + 6;
  if (tid < G) sh_xg[tid] = xg[tid];
  ba::consumer_sync(nthr);

  int it = 0, prev_blk = -1;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
    const char* st = ba::ring_wait(plan, smem, it);
    // row r of this lane at T[r * nthr]
    const float* T = reinterpret_cast<const float*>(st) + tid;
    const int img = reinterpret_cast<const int*>(st + plan.dst_off[1])[tid];
    // Hpp^{-1} row r of this lane's point at hp[r * pb]
    const float* hp = reinterpret_cast<const float*>(st + plan.dst_off[2]) + p;
    const int buf = it & 1;

    float jc[12];
#pragma unroll
    for (int a = 0; a < 12; ++a) jc[a] = T[(off.jc + a) * nthr];
    float x[6];
    if constexpr (kStage >= kGather) {
      const float2* x2 = reinterpret_cast<const float2*>(xc) + 3 * img;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float2 v = __ldg(x2 + a);
        x[2 * a] = v.x;
        x[2 * a + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 6; ++a) x[a] = __ldg(xc + a) + (float)img;
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      s0 += jc[a] * x[a];
      s1 += jc[6 + a] * x[a];
    }
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const float xgg = sh_xg[g];
      s0 += T[(off.jg + g) * nthr] * xgg;
      s1 += T[(off.jg + G + g) * nthr] * xgg;
    }
    const float wxx = T[off.w * nthr];
    const float wxy = T[(off.w + 1) * nthr];
    const float wyy = T[(off.w + 2) * nthr];
    const float t0 = wxx * s0 + wxy * s1;
    const float t1 = wxy * s0 + wyy * s1;
    float jp[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) jp[a] = T[(off.jp + a) * nthr];
    float y[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) y[a] = jp[a] * t0 + jp[3 + a] * t1;

    float* jt = sh_jt + buf * 3 * nthr;
    if constexpr (kStage >= kPointred) {
#pragma unroll
      for (int a = 0; a < 3; ++a) jt[a * nthr + tid] = y[a];
    }
    // One barrier per tile.  After it the Jp^T t terms of this tile are
    // visible, and so are the per-warp sums of the CTA's previous tile
    // (written before its threads came here): add those in warp order.
    ba::consumer_sync(nthr);
    if (prev_blk >= 0 && tid < nslots) {
      const float* g_prev = sh_g + (buf ^ 1) * kMaxWarps * kSlots + tid;
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += g_prev[w * kSlots];
      partial_g[(long long)prev_blk * nslots + tid] = s;
    }
    if constexpr (kStage >= kPointred) {
      // this lane's point, all V views, in view order
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float s = 0.f;
        for (int v = 0; v < V; ++v) s += jt[a * nthr + v * pb + p];
        y[a] = s;
      }
    }
    float h[6], z[3];
#pragma unroll
    for (int r = 0; r < 6; ++r) h[r] = hp[r * pb];
    ba::sym3_apply(h, y[0], y[1], y[2], z);
    const float r0 = jp[0] * z[0] + jp[1] * z[1] + jp[2] * z[2];
    const float r1 = jp[3] * z[0] + jp[4] * z[1] + jp[5] * z[2];
    const float tv0 = t0 - (wxx * r0 + wxy * r1);
    const float tv1 = t1 - (wxy * r0 + wyy * r1);
    if constexpr (kImageSum) {
      const int pos = reinterpret_cast<const int*>(st + plan.dst_off[3])[tid];
      float4* out = reinterpret_cast<float4*>(scratch + (long long)pos * 8);
      out[0] = make_float4(jc[0] * tv0 + jc[6] * tv1, jc[1] * tv0 + jc[7] * tv1,
                           jc[2] * tv0 + jc[8] * tv1, jc[3] * tv0 + jc[9] * tv1);
      out[1] = make_float4(jc[4] * tv0 + jc[10] * tv1,
                           jc[5] * tv0 + jc[11] * tv1, 0.f, 0.f);
    }

    float* g_cur = sh_g + (buf * kMaxWarps + warp) * kSlots;
    for (int g = 0; g < G; ++g) {
      float q = T[(off.jg + g) * nthr] * tv0 + T[(off.jg + G + g) * nthr] * tv1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_down_sync(0xffffffffu, q, o);
      if (lane == 0) g_cur[g] = q;
    }
    ba::ring_release(plan, smem, it);
    if constexpr (!kImageSum) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float q = jc[a] * tv0 + jc[6 + a] * tv1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          q += __shfl_down_sync(0xffffffffu, q, o);
        if (lane == 0) g_cur[G + a] = q;
      }
    }
    prev_blk = blk;
  }
  // the last tile's per-warp sums
  ba::consumer_sync(nthr);
  if (prev_blk >= 0 && tid < nslots) {
    const float* g_prev = sh_g + ((it - 1) & 1) * kMaxWarps * kSlots + tid;
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += g_prev[w * kSlots];
    partial_g[(long long)prev_blk * nslots + tid] = s;
  }
}

bool matvec_shape_ok(long long N, int P, int V, int pb, int G) {
  return pb > 0 && pb % 32 == 0 && V > 0 && V * pb <= kMaxBlockThreads &&
         P % pb == 0 && G >= 1 && G <= kMaxG && (long long)P * V == N;
}

// The ring plan of one K1 tile and the launch of one instantiation.
template <int kStage>
int launch_matvec(const float* packed, long long N, int P, int V, int pb,
                  int G, const int* obs_img, const float* hppinv,
                  const int* img_pos, const float* xc, const float* xg,
                  float* scratch, float* partial, cudaStream_t stream) {
  const int nthr = V * pb, nblk = P / pb;
  const long long f4 = sizeof(float);
  ba::DeviceLimits lim;
  cudaError_t e = ba::device_limits(&lim);
  if (e != cudaSuccess) return (int)e;
  ba::RingPlan plan = {};
  bool ok = ba::ring_add(&plan, packed, N * f4, nthr * f4, 21 + 2 * G,
                         nthr * (int)f4) &&
            ba::ring_add(&plan, obs_img, 0, nthr * f4, 1, nthr * (int)f4) &&
            ba::ring_add(&plan, hppinv, P * f4, pb * f4, 6, pb * (int)f4);
  if (kStage == kFull)
    ok = ok && ba::ring_add(&plan, img_pos, 0, nthr * f4, 1, nthr * (int)f4);
  int smem = 0;
  if (!ok || !ba::ring_fit(&plan, matvec_user_bytes(nthr), lim, &smem))
    return (int)cudaErrorInvalidValue;
  BA_ALLOW_SMEM(matvec_kernel<kStage>, lim.max_smem);
  matvec_kernel<kStage>
      <<<ba::ring_grid(lim, nblk), nthr + ba::kProducerThreads, smem, stream>>>(
          plan, nblk, pb, G, xc, xg, scratch, partial);
  BA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// scratch: [n_img_blocks * 512 + n_img_blocks, 8] f32 (16-byte aligned): the
// image-sorted rows, then the block sums; partial_g: [P / pb, G] f32.
extern "C" int ba_schur_matvec(
    const float* packed, long long N, int P, int V, int pb, int G,
    const int* obs_img, const float* hppinv, const float* xc, const float* xg,
    const float* extra_c, const float* extra_g, int M, const int* img_pos,
    const int* img_block_valid, const int* img_block_starts, int n_img_blocks,
    float* scratch, float* partial_g, float* out_c, float* out_g,
    cudaStream_t stream) {
  if (!matvec_shape_ok(N, P, V, pb, G) || M <= 0 || n_img_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int rc = launch_matvec<kFull>(packed, N, P, V, pb, G, obs_img, hppinv,
                                      img_pos, xc, xg, scratch, partial_g,
                                      stream);
  if (rc != 0) return rc;
  float* bsum = scratch + (long long)n_img_blocks * ba::kImgBlock * 8;
  ba::block_sum_kernel<<<n_img_blocks, dim3(2, ba::block_sum_lanes(2)), 0,
                         stream>>>(
      reinterpret_cast<const float4*>(scratch), 2, img_block_valid,
      reinterpret_cast<float4*>(bsum));
  BA_CHECK_LAUNCH();
  const int img_ctas = (M * 6 + ba::kReduceThreads - 1) / ba::kReduceThreads;
  ba::finish_kernel<<<img_ctas + G, ba::kReduceThreads, 0, stream>>>(
      bsum, 8, 6, M, img_block_starts, extra_c, xc, out_c, img_ctas, partial_g,
      P / pb, G, extra_g, xg, out_g);
  BA_CHECK_LAUNCH();
  return 0;
}

// One cut stage of K1 (stage 0 rowmath, 1 pointred, 2 gather; see the head
// of this file).  partial: [P / pb, G + 6] f32; out: [G + 6] f32, the G
// global sums of Jg^T tv, then the six sums of Jc^T tv.
extern "C" int ba_matvec_stage(int stage, const float* packed, long long N,
                               int P, int V, int pb, int G,
                               const int* obs_img, const float* hppinv,
                               const float* xc, const float* xg,
                               float* partial, float* out,
                               cudaStream_t stream) {
  if (!matvec_shape_ok(N, P, V, pb, G)) return (int)cudaErrorInvalidValue;
  int rc;
  switch (stage) {
    case kRowmath:
      rc = launch_matvec<kRowmath>(packed, N, P, V, pb, G, obs_img, hppinv,
                                   nullptr, xc, xg, nullptr, partial, stream);
      break;
    case kPointred:
      rc = launch_matvec<kPointred>(packed, N, P, V, pb, G, obs_img, hppinv,
                                    nullptr, xc, xg, nullptr, partial, stream);
      break;
    case kGather:
      rc = launch_matvec<kGather>(packed, N, P, V, pb, G, obs_img, hppinv,
                                  nullptr, xc, xg, nullptr, partial, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  ba::finish_kernel<<<G + 6, ba::kReduceThreads, 0, stream>>>(
      nullptr, 0, 0, 0, nullptr, nullptr, nullptr, nullptr, 0, partial, P / pb,
      G + 6, nullptr, nullptr, out);
  BA_CHECK_LAUNCH();
  return 0;
}
