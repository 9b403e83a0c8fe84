// Per-image sums of F feature rows:  out[l, m, f] = sum over the
// observations n of image m of rows[f][l, n],  f32 or f64 rows, l over the
// rows' leading slices (parallel/kernels.py `image_sum_rows`, the card's
// route of engine._image_sum_stack).
//
// Replaces no Pallas kernel: the JAX package leaves this sum to XLA (a
// gather into the image-sorted blocked layout, 512-entry block sums, a
// cumsum difference).  Written as PyTorch calls on the card, that route
// stacked the F rows, copied them once more behind a pad row, gathered the
// copy and scanned the block sums in f64: ~50 launches and five to six
// times the F x N values moved per call.  It held 4.2 of the 7.2 busy
// device-seconds of a 4-camera rig's adjustment, whose compact rows are
// summed per image in every product, linearisation and reduction.
//
// Bound: device-memory bandwidth.  The sum needs the rows read once (s F N
// bytes, s = 4 or 8), the image positions read once (4 N) and the output
// written once (s F M).  At the rig's product call (F = 16, f64, N =
// 1,204,224, M = 500) that is 159 MB, 0.047 ms at the 3.35 TB/s of an H100
// SXM (measure.image_sum_work).
//
// Design:
//  * the rows are read where they lie: a table of F row pointers (and the
//    stride between the leading slices of each row) is a kernel parameter,
//    passed by value (__grid_constant__), so nothing is stacked or copied
//    before the pass, the table needs no host-to-device copy and a CUDA graph
//    captures the launch as it is;
//  * the rows reach the image-sorted layout by one scatter (K1's
//    "observation-major scratch + image-sorted pass"): each observation's
//    columns go to entry img_pos[n] of one [Nip, fs] scratch, whole 32-byte
//    sectors at a time, and the block pass then streams each image's
//    entries as one contiguous run.  Reading and writing the F x N values
//    once more costs 2 s F N bytes over the bound; a gather of each block's
//    entries through img_perm needs no scratch but reads each value as a
//    whole sector of 32 bytes from a random place: at the rig's product call
//    0.48 ms against the scatter route's 0.19 ms (NVIDIA H100 80GB HBM3);
//  * at most three launches (scatter, block sums, finish) per kMaxRows
//    rows; nothing is allocated or read back, so a CUDA graph captures
//    them;
//  * the order of the sums is fixed in two levels, K1's and K2's (common.cuh
//    `block_sum`, then an image's blocks in ascending order): each 512-entry
//    block of the image-sorted layout sums its valid entries (entry lanes in
//    sequence, then a fixed tree), and `image_sum_finish` adds an image's
//    blocks in order.  No atomics: the same inputs give the same bits on
//    every call (kernels.image_sum_sorted_plain repeats the order);
//  * F, the dtype and the leading slices are arguments of one build: a
//    launch reads them, nothing is compiled or tuned per shape.
#include "common.cuh"

namespace {

constexpr int kMaxRows = 128;  // kernels.MAX_IMAGE_SUM_ROWS
constexpr int kScatterThreads = 256;
constexpr int kLine = 128;      // bytes a scatter thread stores at once
constexpr int kSector = 32;     // the columns of an entry fill whole sectors

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static __device__ __forceinline__ float4 pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<double> {
  using V = double2;
  static __device__ __forceinline__ double2 pack(const double* v) {
    return make_double2(v[0], v[1]);
  }
};

// The F rows of one call: row f of leading slice l starts at
// row[f] + l * lead[f] (elements); the last dimension has stride 1.
template <typename T>
struct RowTable {
  const T* row[kMaxRows];
  long long lead[kMaxRows];
};

// Columns [f0, f0 + W) of observation n of slice l; zero past F.
template <typename T>
__device__ __forceinline__ typename Vec<T>::V load_columns(
    const RowTable<T>& tbl, int F, int f0, int l, long long n) {
  constexpr int W = 16 / sizeof(T);
  T v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int f = f0 + w;
    v[w] = f < F ? tbl.row[f][l * tbl.lead[f] + n] : T(0);
  }
  return Vec<T>::pack(v);
}

// scratch[l, img_pos[n], :] = the fs columns of observation n of slice l
// (zero past F).  Grid (ceil(N / kScatterThreads), L).  Each warp takes 32
// consecutive observations and their columns kLine bytes at a time: lane i
// loads observation i's (every row read coalesced across the warp) into
// shared memory, then the warp stores them transposed, 8 lanes to an
// observation, so that each store instruction writes four whole runs of
// kLine bytes (fs spans whole 32-byte sectors) and the L2 never holds a
// partly written sector.
template <typename T>
__global__ void __launch_bounds__(kScatterThreads)
    image_sum_scatter(const __grid_constant__ RowTable<T> tbl, int F, int fs,
                      long long N, long long nip,
                      const int* __restrict__ img_pos,
                      typename Vec<T>::V* __restrict__ scratch) {
  using V = typename Vec<T>::V;
  constexpr int W = 16 / sizeof(T);
  constexpr int kVecs = kLine / 16;              // 16-byte columns per run
  constexpr int kObsPerStore = 32 / kVecs;       // observations per store
  __shared__ V sh[kScatterThreads / 32][32][kVecs + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  const int fsv = fs / W;
  const int pos = n < N ? img_pos[n] : -1;
  V* dst = scratch + (long long)l * nip * fsv;
  const int k = lane % kVecs;
  for (int c0 = 0; c0 < fsv; c0 += kVecs) {
    if (n < N) {
#pragma unroll
      for (int c = 0; c < kVecs; ++c)
        if (c0 + c < fsv)
          sh[warp][lane][c] = load_columns(tbl, F, (c0 + c) * W, l, n);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const int j = lane / kVecs + kObsPerStore * r;
      const int pj = __shfl_sync(0xffffffffu, pos, j);
      if (pj >= 0 && c0 + k < fsv)
        dst[(long long)pj * fsv + c0 + k] = sh[warp][j][k];
    }
    __syncwarp();
  }
}

// bsum[l, b, :] = the sum of the first valid[b] entries of block b of
// scratch[l] [nip, fsv] (16-byte columns).  Grid (nb, L); block (fsv,
// lanes) as `ba::block_sum`.
template <typename T>
__global__ void __launch_bounds__(ba::kSumThreads)
    image_sum_blocks(const typename Vec<T>::V* __restrict__ scratch,
                     long long nip, const int* __restrict__ valid,
                     typename Vec<T>::V* __restrict__ bsum) {
  using V = typename Vec<T>::V;
  __shared__ V sh[ba::kSumThreads];
  const int b = blockIdx.x, l = blockIdx.y, fsv = blockDim.x;
  const V* base = scratch + ((long long)l * nip + (long long)b * ba::kImgBlock)
                                * fsv + threadIdx.x;
  ba::block_sum([&](int e) { return base[(long long)e * fsv]; }, valid[b],
                bsum + ((long long)l * gridDim.x + b) * fsv, sh);
}

// out[(l M + m) ldo + f] = sum over image m's blocks, in order, of
// bsum[l, b, f] for f < F; one thread per output.
template <typename T>
__global__ void __launch_bounds__(ba::kReduceThreads)
    image_sum_finish(const T* __restrict__ bsum, int fs, int F, int M, int nb,
                     long long total, const int* __restrict__ bstarts,
                     T* __restrict__ out, int ldo) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int f = (int)(o % F);
  const long long lm = o / F;
  const int m = (int)(lm % M);
  const T* bs = bsum + (lm / M) * nb * fs + f;
  T s = T(0);
  for (int b = bstarts[m]; b < bstarts[m + 1]; ++b) s += bs[(long long)b * fs];
  out[lm * ldo + f] = s;
}

template <typename T>
int launch_image_sum(const void* const* rows,
                     const long long* lead, int F, int L, long long N, int M,
                     const int* img_pos, const int* img_block_valid,
                     const int* img_block_starts, int nb, void* scratch,
                     void* out, int ldo, cudaStream_t stream) {
  using V = typename Vec<T>::V;
  constexpr int W = 16 / sizeof(T);
  constexpr int S = kSector / sizeof(T);
  const int fs = (F + S - 1) / S * S, fsv = fs / W;
  const long long nip = (long long)nb * ba::kImgBlock;
  RowTable<T> tbl = {};
  for (int f = 0; f < F; ++f) {
    tbl.row[f] = static_cast<const T*>(rows[f]);
    tbl.lead[f] = lead[f];
  }
  V* sc = static_cast<V*>(scratch);
  V* bsum = sc + (long long)L * nip * fsv;
  image_sum_scatter<T>
      <<<dim3((unsigned)((N + kScatterThreads - 1) / kScatterThreads), L),
         kScatterThreads, 0, stream>>>(tbl, F, fs, N, nip, img_pos, sc);
  BA_CHECK_LAUNCH();
  image_sum_blocks<T>
      <<<dim3(nb, L), dim3(fsv, ba::block_sum_lanes(fsv)), 0, stream>>>(
          sc, nip, img_block_valid, bsum);
  BA_CHECK_LAUNCH();
  const long long total = (long long)L * M * F;
  image_sum_finish<T>
      <<<(unsigned)((total + ba::kReduceThreads - 1) / ba::kReduceThreads),
         ba::kReduceThreads, 0, stream>>>(reinterpret_cast<const T*>(bsum),
                                          fs, F, M, nb, total,
                                          img_block_starts,
                                          static_cast<T*>(out), ldo);
  BA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// rows, lead: host arrays of F row pointers and leading strides (copied into
// the launch); elem_bytes 4 (f32) or 8 (f64).  scratch (16-byte aligned):
// [L, nb * 512, fs], then [L, nb, fs], fs = F rounded up to 32 bytes.  out:
// [L, M, ldo], columns [0, F) written.
extern "C" int ba_image_sum(int elem_bytes, const void* const* rows,
                            const long long* lead, int F, int L, long long N,
                            int M, const int* img_pos,
                            const int* img_block_valid,
                            const int* img_block_starts, int n_img_blocks,
                            void* scratch, void* out, int ldo,
                            cudaStream_t stream) {
  if (F < 1 || F > kMaxRows || L < 1 || L > 65535 || N < 1 || M < 1 ||
      n_img_blocks < 1 || ldo < F)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch_image_sum<float>(rows, lead, F, L, N, M, img_pos,
                                   img_block_valid, img_block_starts,
                                   n_img_blocks, scratch, out, ldo, stream);
  if (elem_bytes == 8)
    return launch_image_sum<double>(rows, lead, F, L, N, M, img_pos,
                                    img_block_valid, img_block_starts,
                                    n_img_blocks, scratch, out, ldo, stream);
  return (int)cudaErrorInvalidValue;
}
