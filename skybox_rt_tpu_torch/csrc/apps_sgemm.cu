// C = A . B in float32: the sgemm2x app's blocked matrix product.
//
// Replaces the Pallas TPU kernel skybox_rt_tpu/apps/compute.py:56
// (_sgemm_kernel, launched by sgemm_pallas): there a (bm, bn) tile of C is
// zeroed at k-step 0 and adds its (bm, bk) . (bk, bn) products over ascending
// k-steps of a sequential grid axis.  Here one block owns one 128 x 128 tile
// of C for the whole k range (blocks run in no order, so nothing is carried
// between them); the caller's block=(bm, bn, bk) is only checked by the
// wrapper, the tiles below are this kernel's own.
//
// Arithmetic, pinned: for every C element, over k ascending, one fused
// multiply-add rounded once, acc = __fmaf_rn(a[i, k], b[k, j], acc), from
// acc = +0; no split of k.  __fmaf_rn is explicit, so -fmad=false (which
// holds for every source) does not touch it.  The plain version
// apps.cuda_sgemm.sgemm_reference repeats that arithmetic exactly (an
// emulation of fmaf in float64 with the TwoSum error term), so the two
// compare bit for bit.  The ragged edge: rows of A and columns of B past
// the matrix are loaded as zeros and land only in elements of C that are
// never stored; the k range is never padded, the last stage runs only its
// valid k (a padded step fma(0, 0, acc) would turn an acc of -0, which an
// fma can round to, into +0).
//
// Bound on an H100 SXM: operations.  2 m n k flop at 67 TFLOP/s fp32 (that
// peak counts a fused multiply-add as two operations) against
// (m k + k n + m n) * 4 bytes at 3.35 TB/s: at 4096^3, 2.05 ms against
// 0.06 ms.  One FFMA a multiply-add is what that peak assumes.
//
// Design: 256 threads on a 128 x 256 tile of C, each an 8 x 16 register
// tile, taken as two 4-row groups 64 apart and four 4-column groups 64
// apart, so that the float4 reads of a quarter-warp from shared memory touch
// 32 different banks.  A stage is a 32-deep slice of A (stored transposed,
// As[k][row], rows padded to 132) and of B, filled by cp.async into a ring
// of kStages = 3 stages of dynamic shared memory (148,992 bytes) while the
// stages before compute: one __syncthreads for 32 values of k.
// __launch_bounds__(256, 1): one block an SM, so ptxas may take up to 255
// registers (128 of them the accumulators) and load the shared-memory
// fragments of several k ahead of their FFMAs.  Blocks take the C tiles in
// row-major order.  B's slices move 16 bytes a copy when n is a multiple of
// 4 and B is 16-byte aligned, else 4.  Offsets into A, B and C are 64-bit:
// 4096^3 passes 2^31 elements of index arithmetic.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int kStages = 3;
constexpr int kCols = BN / 16;   // a thread's columns: 4 every 64
constexpr int AS_LD = BM + 4;
constexpr int kStageFloats = BK * AS_LD + BK * BN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 148,992

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Issues the copies of the slice k0 .. k0 + BK into one stage; elements
// past the matrix are zero-filled (src-size 0 reads nothing).
template <bool kVecB>
__device__ __forceinline__ void load_stage(
    float* stage, const float* __restrict__ a, const float* __restrict__ b,
    int m, int n, int k, int row0, int col0, int k0) {
  float* as = stage;                  // [BK][AS_LD]
  float* bs = stage + BK * AS_LD;     // [BK][BN]
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < BM * BK / THREADS; ++r) {
    const int e = tid + r * THREADS;
    const int row = row0 + e / BK;
    const int kk = k0 + e % BK;
    const bool ok = row < m && kk < k;
    cp_async4(as + (e % BK) * AS_LD + e / BK,
              ok ? a + static_cast<size_t>(row) * k + kk : a, ok);
  }
  if (kVecB) {
#pragma unroll
    for (int r = 0; r < BK * BN / 4 / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = k0 + e / (BN / 4);
      const int col = col0 + (e % (BN / 4)) * 4;
      const bool ok = kk < k && col < n;
      cp_async16(bs + (e / (BN / 4)) * BN + (e % (BN / 4)) * 4,
                 ok ? b + static_cast<size_t>(kk) * n + col : b, ok);
    }
  } else {
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = k0 + e / BN;
      const int col = col0 + e % BN;
      const bool ok = kk < k && col < n;
      cp_async4(bs + (e / BN) * BN + e % BN,
                ok ? b + static_cast<size_t>(kk) * n + col : b, ok);
    }
  }
}

// One k of a thread's tile, 8 rows x kCols columns: 8 * kCols fused
// multiply-adds.
__device__ __forceinline__ void fma_step(const float* as_k, const float* bs_k,
                                         int tx, int ty,
                                         float (&acc)[8][kCols]) {
  const float4 a0 = *reinterpret_cast<const float4*>(as_k + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(as_k + 64 + ty * 4);
  const float fa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  float fb[kCols];
#pragma unroll
  for (int g = 0; g < kCols / 4; ++g) {
    const float4 bg = *reinterpret_cast<const float4*>(bs_k + 64 * g
                                                       + tx * 4);
    fb[4 * g] = bg.x;
    fb[4 * g + 1] = bg.y;
    fb[4 * g + 2] = bg.z;
    fb[4 * g + 3] = bg.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[i][j] = __fmaf_rn(fa[i], fb[j], acc[i][j]);
}

template <bool kVecB>
__global__ void __launch_bounds__(THREADS, 1)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_n = (n + BN - 1) / BN;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  const int tx = threadIdx.x % 16;   // column group
  const int ty = threadIdx.x / 16;   // row group

  float acc[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int kt_count = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count)
      load_stage<kVecB>(smem + s * kStageFloats, a, b, m, n, k, row0, col0,
                        s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();     // stage kt landed; stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < kt_count)
      load_stage<kVecB>(smem + (next % kStages) * kStageFloats, a, b, m, n,
                        k, row0, col0, next * BK);
    cp_async_commit();
    const float* as = smem + (kt % kStages) * kStageFloats;
    const float* bs = as + BK * AS_LD;
    const int valid = min(BK, k - kt * BK);
    if (valid == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        fma_step(as + kk * AS_LD, bs + kk * BN, tx, ty, acc);
    } else {
      for (int kk = 0; kk < valid; ++kk)
        fma_step(as + kk * AS_LD, bs + kk * BN, tx, ty, acc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    float* crow = c + static_cast<size_t>(row) * n;
#pragma unroll
    for (int h = 0; h < kCols / 4; ++h) {
      const int col = col0 + h * 64 + tx * 4;
      if (kVecB) {
        if (col < n)
          *reinterpret_cast<float4*>(crow + col) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) crow[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <bool kVecB>
cudaError_t launch(const float* a, const float* b, float* c, int m, int n,
                   int k, cudaStream_t st) {
  // the attribute is the current device's: set it for every launch
  const cudaError_t err = cudaFuncSetAttribute(
      sgemm_kernel<kVecB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((m + BM - 1) / BM)
                          * ((n + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  sgemm_kernel<kVecB><<<static_cast<int>(tiles), THREADS, kSmemBytes, st>>>(
      a, b, c, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// a (m, k), b (k, n), c (m, n): contiguous float32 on the device.  Returns
// the launch's cudaError_t (0 = launched).
extern "C" int skybox_apps_sgemm(const float* a, const float* b, float* c,
                                 int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0
                   && reinterpret_cast<size_t>(b) % 16 == 0
                   && reinterpret_cast<size_t>(c) % 16 == 0;
  return static_cast<int>(vec ? launch<true>(a, b, c, m, n, k, st)
                              : launch<false>(a, b, c, m, n, k, st));
}
