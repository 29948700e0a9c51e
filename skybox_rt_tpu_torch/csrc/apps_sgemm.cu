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
// Sum order, pinned: for every C element, over k ascending, one product and
// one add, each rounded on its own (__fmul_rn, __fadd_rn; -fmad=false holds
// for every source).  The plain version apps.cuda_sgemm.sgemm_reference
// repeats that order, so the two compare bit for bit.  The ragged edge is
// loaded as zeros: an out-of-range k pairs a zero of A with a zero of B, and
// acc + 0 * 0 == acc (acc starts at +0 and a round-to-nearest sum is never
// -0), so padding changes no bit.
//
// Bound on an H100 SXM: operations.  2 m n k flop at 67 TFLOP/s fp32 (that
// peak counts a fused multiply-add as two operations) against
// (m k + k n + m n) * 4 bytes at 3.35 TB/s: at 4096^3, 2.05 ms against
// 0.06 ms.  Without FMA every multiply and every add is an instruction of its
// own, so this kernel can reach at most half of the operations bound.  A
// kernel that fuses (FFMA, or TF32 / 3xTF32 tensor-core products) would have
// to change the plain version or state a tolerance.
//
// Design: 256 threads, each an 8 x 8 register tile of C, taken as two 4-row
// and two 4-column groups 64 apart so that the float4 reads of a quarter-warp
// from shared memory touch 32 different banks.  A k-step stages an 8-deep
// slice of A (stored transposed, As[k][row], rows padded to 132 so the
// transposing stores do not collide on a bank) and of B in shared memory
// (8.3 KB, well under the 48 KB of static shared memory), while the next
// slice is read from device memory into registers.  Offsets into A, B and C
// are 64-bit: 4096^3 passes 2^31 elements of index arithmetic.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int AS_LD = BM + 4;
// elements of an A (BM x BK) or B (BK x BN) slice each thread stages
constexpr int A_PER_THREAD = BM * BK / THREADS;   // 4
constexpr int B_PER_THREAD = BK * BN / THREADS;   // 4

__device__ __forceinline__ void load_slice(
    const float* __restrict__ a, const float* __restrict__ b, int m, int n,
    int k, int row0, int col0, int k0, float (&ra)[A_PER_THREAD],
    float (&rb)[B_PER_THREAD]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < A_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    const int row = row0 + e / BK;
    const int kk = k0 + e % BK;
    ra[r] = (row < m && kk < k) ? a[(size_t)row * k + kk] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < B_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    const int kk = k0 + e / BN;
    const int col = col0 + e % BN;
    rb[r] = (kk < k && col < n) ? b[(size_t)kk * n + col] : 0.0f;
  }
}

__device__ __forceinline__ void store_slice(
    float (*as)[AS_LD], float (*bs)[BN], const float (&ra)[A_PER_THREAD],
    const float (&rb)[B_PER_THREAD]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < A_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    as[e % BK][e / BK] = ra[r];
  }
#pragma unroll
  for (int r = 0; r < B_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    bs[e / BN][e % BN] = rb[r];
  }
}

__global__ void __launch_bounds__(THREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[BK][AS_LD];
  __shared__ __align__(16) float bs[BK][BN];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;   // column group
  const int ty = threadIdx.x / 16;   // row group

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ra[A_PER_THREAD], rb[B_PER_THREAD];
  load_slice(a, b, m, n, k, row0, col0, 0, ra, rb);
  for (int k0 = 0; k0 < k; k0 += BK) {
    store_slice(as, bs, ra, rb);
    __syncthreads();
    if (k0 + BK < k) load_slice(a, b, m, n, k, row0, col0, k0 + BK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fa[8], fb[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      fa[0] = a0.x; fa[1] = a0.y; fa[2] = a0.z; fa[3] = a0.w;
      fa[4] = a1.x; fa[5] = a1.y; fa[6] = a1.z; fa[7] = a1.w;
      fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
      fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(fa[i], fb[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) c[(size_t)row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

// a (m, k), b (k, n), c (m, n): contiguous float32 on the device.  Returns
// the launch's cudaError_t (0 = launched).
extern "C" int skybox_apps_sgemm(const float* a, const float* b, float* c,
                                 int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  sgemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
