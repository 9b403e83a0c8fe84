// Shared pieces of the Hopper kernels of the scale solver: the packed-row
// contract (parallel/kernels.py `_offsets`), the shared-memory ring that
// feeds K1, K2 and K4 by asynchronous bulk copies, and the deterministic
// reduction passes that they end with.
//
// Determinism: every sum here is taken in a fixed order (per-thread
// sequential loops, fixed shuffle/shared-memory trees, partials indexed by
// the view-major block they belong to and reduced in block order, never by
// the CTA that happened to compute them).  No atomics: the CG stall rule
// (parallel/rcs.py `pcg`) reacts to residual noise, so the same inputs must
// give the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ba {

constexpr int kImgBlock = 512;         // rcs.IMG_BLOCK
constexpr int kMaxG = 16;              // global parameters the kernels take
constexpr int kMaxBlockThreads = 512;  // V * pb of one view-major block
constexpr int kProducerThreads = 32;   // the warp that starts the bulk copies
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

// ---------------------------------------------------------------------------
// The ring: tiles of one view-major block arrive in shared memory by 1-D
// asynchronous bulk copies (cp.async.bulk, the TMA engine without a tensor
// map: every row segment of a tile is contiguous and 16-byte aligned).
//
// A persistent grid (one CTA per SM, see `ring_grid`) walks the blocks
// blk = blockIdx.x, blockIdx.x + gridDim.x, ...  The last warp of the CTA is
// the producer: for the it-th tile of the CTA it waits until the consumers
// have released stage it % stages (`empty` mbarrier, one arrival per consumer
// warp), posts the tile's byte count on the stage's `full` mbarrier
// (arrive.expect_tx) and starts the copies, one row segment per lane.  The
// consumers (the first V * pb threads) wait on `full`, read the tile with
// ordinary shared-memory loads and release the stage.  Loads in flight live
// in shared memory, not in registers: at V * pb = 384 and G = 10 a K1 tile
// is 65 KB and three of them are on their way or in use on every SM.
//
// Shared memory: [full[kMaxStages], empty[kMaxStages]] in the first
// kRingHeader bytes, then `stages` stages of `stage_bytes`, then the
// kernel's own scratch (`ring_user`).
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 4;
constexpr int kMaxSources = 4;
constexpr int kRingHeader = 128;

// `rows` row segments of `seg_bytes` each: segment r of block blk starts at
// base + r * row_stride + blk * blk_stride (bytes).
struct RingSource {
  const char* base;
  long long row_stride;
  long long blk_stride;
  int rows;
  int seg_bytes;
};

struct RingPlan {
  RingSource src[kMaxSources];
  int dst_off[kMaxSources];  // byte offset of each source inside a stage
  int nsrc;
  int stage_bytes;
  int stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase with parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// L2 policy for data that is read once: evict it first, so that what a
// kernel writes for its next pass (the image-sorted scratch) stays cached.
__device__ __forceinline__ uint64_t l2_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Global -> shared bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned); its bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Shared -> global bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned), tracked by the issuing thread's bulk async-groups.  The
// caller orders its own shared-memory writes before it with
// `fence_proxy_async`, closes a group with `bulk_commit`, and before it
// rewrites the source waits with `bulk_wait_read` (the copies have read
// their source) or, before the kernel ends, `bulk_wait` (they are done).
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier over the consumer threads only (the producer warp never joins).
__device__ __forceinline__ void consumer_sync(int consumers) {
  asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
}

// Called by thread 0 before the CTA's first __syncthreads(): the barriers of
// the ring.
__device__ __forceinline__ void ring_init(char* smem, const RingPlan& plan,
                                          int consumer_warps) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  for (int s = 0; s < plan.stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer warp's whole life.  expect_tx equals the bytes of the copies
// started for the stage at every shape: both come from the same plan.
__device__ __forceinline__ void ring_produce(const RingPlan& plan, char* smem,
                                             int nblk) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int lane = threadIdx.x & 31;
  const uint64_t policy = l2_evict_first_policy();
  int it = 0;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
    const int s = it % plan.stages;
    const int use = it / plan.stages;
    // the (use - 1)-th release of this stage: parity flips per ring turn
    if (use > 0) mbar_wait(&empty[s], (uint32_t)((use - 1) & 1));
    if (lane == 0) {
      // the consumers read the stage through the generic proxy; order those
      // reads before the async proxy overwrites it
      fence_proxy_async();
      mbar_arrive_expect_tx(&full[s], (uint32_t)plan.stage_bytes);
    }
    __syncwarp();
    char* dst = smem + kRingHeader + (size_t)s * plan.stage_bytes;
#pragma unroll
    for (int q = 0; q < kMaxSources; ++q) {
      if (q < plan.nsrc) {
        const RingSource sr = plan.src[q];
        const char* src0 = sr.base + (long long)blk * sr.blk_stride;
        for (int r = lane; r < sr.rows; r += 32)
          bulk_copy_g2s(dst + plan.dst_off[q] + (size_t)r * sr.seg_bytes,
                        src0 + (long long)r * sr.row_stride,
                        (uint32_t)sr.seg_bytes, &full[s], policy);
      }
    }
  }
}

// Consumer side: the stage that holds the CTA's it-th tile, once it is full.
__device__ __forceinline__ const char* ring_wait(const RingPlan& plan,
                                                 char* smem, int it) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int s = it % plan.stages;
  mbar_wait(&full[s], (uint32_t)((it / plan.stages) & 1));
  return smem + kRingHeader + (size_t)s * plan.stage_bytes;
}

// Called by every consumer thread after its last read of the it-th tile.
__device__ __forceinline__ void ring_release(const RingPlan& plan, char* smem,
                                             int it) {
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem) + kMaxStages;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % plan.stages]);
}

// The kernel's own shared memory, behind the ring.
__device__ __forceinline__ char* ring_user(const RingPlan& plan, char* smem) {
  return smem + kRingHeader + (size_t)plan.stages * plan.stage_bytes;
}

// ---- host side of the ring ------------------------------------------------

struct DeviceLimits {
  int sms;       // streaming multiprocessors
  int max_smem;  // dynamic shared memory a block may opt in to, bytes
};

inline cudaError_t device_limits(DeviceLimits* out) {
  static DeviceLimits cached = {0, 0};
  if (cached.sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&cached.max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached.sms = sms;
  }
  *out = cached;
  return cudaSuccess;
}

// Append a source to the plan; false when it breaks the 16-byte rules of
// the bulk copy or the plan is full.
inline bool ring_add(RingPlan* plan, const void* base, long long row_stride,
                     long long blk_stride, int rows, int seg_bytes) {
  if (plan->nsrc >= kMaxSources || rows < 1 || seg_bytes < 16 ||
      seg_bytes % 16 != 0 || row_stride % 16 != 0 || blk_stride % 16 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  RingSource& s = plan->src[plan->nsrc];
  s.base = static_cast<const char*>(base);
  s.row_stride = row_stride;
  s.blk_stride = blk_stride;
  s.rows = rows;
  s.seg_bytes = seg_bytes;
  plan->dst_off[plan->nsrc] = plan->stage_bytes;
  plan->stage_bytes += rows * seg_bytes;
  plan->nsrc += 1;
  return true;
}

// As many stages as fit beside `user_bytes` of the kernel's own shared
// memory; false when not even one does.  *smem_bytes: the launch's dynamic
// shared memory.
inline bool ring_fit(RingPlan* plan, int user_bytes, const DeviceLimits& lim,
                     int* smem_bytes) {
  const int room = lim.max_smem - kRingHeader - user_bytes;
  if (plan->stage_bytes <= 0 || room < plan->stage_bytes) return false;
  int stages = room / plan->stage_bytes;
  plan->stages = stages < kMaxStages ? stages : kMaxStages;
  *smem_bytes = kRingHeader + plan->stages * plan->stage_bytes + user_bytes;
  return true;
}

// The persistent grid: one CTA per SM (the ring takes most of an SM's shared
// memory), never more CTAs than blocks.
inline int ring_grid(const DeviceLimits& lim, int nblk) {
  return nblk < lim.sms ? nblk : lim.sms;
}

// ---------------------------------------------------------------------------
// The streaming per-image pass.  K1 and K2 write each observation's feature
// row at its image-sorted position (entry img_pos[n] of the blocked layout of
// rcs.build_image_block_layout: every image starts a new 512-entry block and
// fills a prefix of its last one), so an image's rows are contiguous and the
// pass needs no index load and no dependent address.  The order of the sums
// is fixed in two levels: `block_sum_kernel` sums each 512-entry block (entry
// lanes in sequence, then a fixed tree over the lanes), `finish_kernel` adds
// an image's blocks in ascending order.  Several CTAs work on one image,
// one per block, whatever its size.
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 512;
constexpr int kSumMaxLanes = 64;

// Entry lanes of block_sum_kernel for rows of fs4 float4: a power of two.
inline int block_sum_lanes(int fs4) {
  int e = 1;
  while (2 * e * fs4 <= kSumThreads && 2 * e <= kSumMaxLanes) e *= 2;
  return e;
}

// 16-byte columns of the pass: float4 for f32 rows, double2 for f64 rows
// (csrc/image_sum.cu takes both), added component by component.
__device__ __forceinline__ void vec_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vec_zero(double2& a) {
  a = make_double2(0.0, 0.0);
}
__device__ __forceinline__ void vec_add(float4& a, const float4& o) {
  a.x += o.x;
  a.y += o.y;
  a.z += o.z;
  a.w += o.w;
}
__device__ __forceinline__ void vec_add(double2& a, const double2& o) {
  a.x += o.x;
  a.y += o.y;
}

// The sum of one 512-entry block: *out = sum over the entries e < n of
// load(e) (one 16-byte column per thread).  Block (fsv, lanes), lanes a
// power of two with fsv * lanes <= kSumThreads; sh holds kSumThreads
// columns.  Thread (q, j) adds the entries j, j + lanes, ... in order, then
// a fixed tree over j; thread (q, 0) writes out[q].
template <typename V, typename Load>
__device__ __forceinline__ void block_sum(Load load, int n, V* __restrict__ out,
                                          V* sh) {
  const int q = threadIdx.x, j = threadIdx.y, fsv = blockDim.x;
  const int lanes = blockDim.y;
  V acc;
  vec_zero(acc);
#pragma unroll 4
  for (int e = j; e < n; e += lanes) vec_add(acc, load(e));
  sh[j * fsv + q] = acc;
  __syncthreads();
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (j < s) {
      V a = sh[j * fsv + q];
      vec_add(a, sh[(j + s) * fsv + q]);
      sh[j * fsv + q] = a;
    }
    __syncthreads();
  }
  if (j == 0) out[q] = sh[q];
}

// bsum[b, :] = sum of the first valid[b] rows of block b of feat
// [nb * 512, fs4] (float4 columns).  Grid nb; block (fs4, lanes) as
// `block_sum`: consecutive threads read consecutive float4 (the block is one
// contiguous run of memory).
static __global__ void __launch_bounds__(kSumThreads)
block_sum_kernel(const float4* __restrict__ feat, int fs4,
                 const int* __restrict__ valid, float4* __restrict__ bsum) {
  __shared__ float4 sh[kSumThreads];
  const int b = blockIdx.x;
  const float4* base = feat + (long long)b * kImgBlock * fs4 + threadIdx.x;
  block_sum([&](int e) { return base[(long long)e * fs4]; }, valid[b],
            bsum + (long long)b * fs4, sh);
}

// The last launch of K1 and K2, two jobs in one grid of kReduceThreads:
//  * CTAs [0, img_ctas): out[m, f] = sum over image m's blocks, in order, of
//    bsum[b, f] (+ extra[m, f] * x[m, f] when extra is given), one thread
//    per (m, f), f < F <= fs;
//  * CTAs img_ctas + k, k < K: outg[k] = sum_c part[c, k] (+ extrag[k] *
//    xg[k]): strided partial sums, then a fixed shared-memory tree.
static __global__ void __launch_bounds__(kReduceThreads)
finish_kernel(const float* __restrict__ bsum, int fs, int F, int M,
              const int* __restrict__ bstarts, const float* __restrict__ extra,
              const float* __restrict__ x, float* __restrict__ out,
              int img_ctas, const float* __restrict__ part, int C, int K,
              const float* __restrict__ extrag, const float* __restrict__ xg,
              float* __restrict__ outg) {
  __shared__ float sh[kReduceThreads];
  if ((int)blockIdx.x < img_ctas) {
    const int o = blockIdx.x * kReduceThreads + threadIdx.x;
    if (o >= M * F) return;
    const int m = o / F, f = o % F;
    float s = 0.f;
    for (int b = bstarts[m]; b < bstarts[m + 1]; ++b)
      s += bsum[(long long)b * fs + f];
    if (extra != nullptr) s += extra[o] * x[o];
    out[o] = s;
    return;
  }
  const int k = blockIdx.x - img_ctas;
  float acc = 0.f;
  for (int c = threadIdx.x; c < C; c += kReduceThreads)
    acc += part[(long long)c * K + k];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float r = sh[0];
    if (extrag != nullptr) r += extrag[k] * xg[k];
    outg[k] = r;
  }
}

// ---------------------------------------------------------------------------
// Two-pass column sum of per-block partials [C, K] (K4's folds, K2's T2 / T3
// partials): kColChunks chunks of blocks, then the chunks, both in a fixed
// order and with every warp reading 128 B of consecutive columns.
// ---------------------------------------------------------------------------

constexpr int kColTile = 32;    // columns of a column_sum_kernel block
constexpr int kColChunks = 32;  // chunks of blocks in the first column sum

// out[y * K + k] = sum_{c in chunk y} part[c * K + k] (+ beta * xin[k] when
// xin is given) for k < K, chunk y = rows [y * chunk, (y + 1) * chunk) of
// C.  Grid (ceil(K / kColTile), chunks); block (kColTile,
// kReduceThreads / kColTile).  Thread (kx, j) sums the rows c0 + j,
// c0 + j + blockDim.y, ... in order, then thread j == 0 adds the blockDim.y
// partial sums in order.
static __global__ void column_sum_kernel(const float* __restrict__ part, int C,
                                         int K, int chunk,
                                         const float* __restrict__ xin,
                                         float beta, float* __restrict__ out) {
  __shared__ float sh[kReduceThreads];
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

}  // namespace ba

#define BA_CHECK_LAUNCH()                      \
  do {                                         \
    cudaError_t _e = cudaGetLastError();       \
    if (_e != cudaSuccess) return (int)_e;     \
  } while (0)

// Raise `kernel`'s dynamic shared memory limit to `bytes` (needed above
// 48 KB, for every template instantiation on its own); remembered per call
// site, so a site names one kernel.
#define BA_ALLOW_SMEM(kernel, bytes)                                        \
  do {                                                                      \
    static int _allowed = 0;                                                \
    if ((bytes) > _allowed) {                                               \
      cudaError_t _e = cudaFuncSetAttribute(                                \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(bytes)); \
      if (_e != cudaSuccess) return (int)_e;                                \
      _allowed = (bytes);                                                   \
    }                                                                       \
  } while (0)
