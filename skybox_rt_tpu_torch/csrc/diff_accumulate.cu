// Row accumulation, the transpose of a row gather, for Hopper (sm_90a):
//   out[r, :] = sum over n with idx[n] == r of val[n, :].
//
// Replaces the Pallas TPU kernel skybox_rt_tpu/diff/pallas_texgrad.py
// (_kernel, launched by accumulate_rows): the backward pass of the texel
// gather, of the per-tile record gather and of the vertex gathers of the
// differentiable pipeline.  The TPU kernel is a one-hot matrix product over
// a grid that runs in order, which is what makes its sum deterministic.
// Blocks on this card run in no order, so the design is this port's own.
//
// Contract: idx (N,) int32, val (N, C) float32 -> out (R, C) float32, any R
// and C.  An idx outside [0, R) is dropped, a negative one too.  float32
// additions only, and THE ORDER OF THE ADDITIONS INTO A ROW IS A FUNCTION OF
// (N, idx) ALONE, never of the schedule: two launches on the same inputs
// are equal bit for bit, and the plain torch version
// (diff/cuda_texgrad.accumulate_rows_reference) repeats the order exactly.
// No floating-point atomics anywhere.
//
// Order: n is cut into S segments of equal length L (both functions of N:
// see segments() in the wrapper).  partial[s, r, :] = 0 + the val[n, :] of
// segment s with idx[n] == r, added one by one in ascending n.  out[r, :] =
// 0 + partial[0, r, :] + partial[1, r, :] + ... in ascending s.
//
// Design, owner computes.  Pass 1: grid (ceil(R / 256), S, column groups); a
// thread owns one row of one segment's partial table and keeps its columns
// (at most kCols of them, a template parameter: 4, 16 or 32; wider tables
// take ceil(C / 32) column groups) in registers.  The block stages the
// segment's idx through shared memory, four values a load (every thread of a
// block reads the same idx[n]: a broadcast), and each thread compares them
// with its row; on a match it adds val[n, :] to its registers, in ascending
// n.  Pass 2: a thread per (r, c) adds the S partial tables in ascending s.
// Both passes are launched by one C call.
//
// What bounds it on the H100: the compares.  Pass 1 makes R * N of them
// (2.8e9 for the 4,096-row texel table of a 1024x1024 step) against
// N * (4 + 4C) + 4RC bytes that have to move; the operations term is this
// algorithm's, not the function's.  A row that many n share (a skewed idx)
// serializes on its one owner.  A counting sort (integer histogram, scan,
// owner sums its list in ascending n) would bring the operations down to the
// N * C additions and is left to a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 256;
constexpr int kStage = 2048;        // idx values staged per pass, 4 | kStage
constexpr int kMaxCols = 32;        // columns a thread keeps in registers

template <int kCols>
__global__ void __launch_bounds__(kRowsPerBlock)
accumulate_partial_kernel(const int* __restrict__ idx,    // (N,)
                          const float* __restrict__ val,  // (N, C)
                          float* __restrict__ partial,    // (S, R, C)
                          int N, int R, int C, int L) {
  __shared__ int4 s_idx[kStage / 4];
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const int seg = blockIdx.y;
  const int c0 = blockIdx.z * kCols;
  const bool owner = row < R;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  const int n0 = seg * L;
  const int n1 = min(N, n0 + L);
  for (int base = n0; base < n1; base += kStage) {
    const int n = min(kStage, n1 - base);
    const int n4 = (n + 3) / 4;
    __syncthreads();
    int* flat = reinterpret_cast<int*>(s_idx);
    for (int i = threadIdx.x; i < 4 * n4; i += kRowsPerBlock)
      flat[i] = i < n ? idx[base + i] : -1;     // -1 matches no row
    __syncthreads();
    if (!owner) continue;
    for (int j = 0; j < n4; ++j) {
      const int4 q = s_idx[j];
      if (q.x != row && q.y != row && q.z != row && q.w != row) continue;
      const int hit[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (hit[k] != row) continue;
        const float* v = val + static_cast<size_t>(base + 4 * j + k) * C + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c0 + c < C) acc[c] = __fadd_rn(acc[c], v[c]);
      }
    }
  }
  if (owner) {
    float* mine = partial + (static_cast<size_t>(seg) * R + row) * C + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < C) mine[c] = acc[c];
  }
}

__global__ void accumulate_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out,
                                         int S, int RC) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RC) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s)
    acc = __fadd_rn(acc, partial[static_cast<size_t>(s) * RC + i]);
  out[i] = acc;
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 =
// launched).  Device pointers: idx (N,) int32, val (N, C) float32, partial
// (S, R, C) float32 scratch, out (R, C) float32.  S segments of L values
// cover N (S * L >= N).  The caller validates shapes.
extern "C" int skybox_diff_accumulate_rows(
    const void* idx, const void* val, void* partial, void* out, int N, int R,
    int C, int S, int L, void* stream) {
  if (N < 0 || R <= 0 || C <= 0 || S <= 0 || L <= 0 || S > 65535
      || static_cast<long long>(S) * L < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = C <= 4 ? 4 : (C <= 16 ? 16 : kMaxCols);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, S,
                  (C + cols - 1) / cols);
  const int* idx_i = static_cast<const int*>(idx);
  const float* val_f = static_cast<const float*>(val);
  float* partial_f = static_cast<float*>(partial);
  if (cols == 4)
    accumulate_partial_kernel<4><<<grid, kRowsPerBlock, 0, st>>>(
        idx_i, val_f, partial_f, N, R, C, L);
  else if (cols == 16)
    accumulate_partial_kernel<16><<<grid, kRowsPerBlock, 0, st>>>(
        idx_i, val_f, partial_f, N, R, C, L);
  else
    accumulate_partial_kernel<kMaxCols><<<grid, kRowsPerBlock, 0, st>>>(
        idx_i, val_f, partial_f, N, R, C, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int RC = R * C;
  accumulate_reduce_kernel<<<(RC + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), S, RC);
  return static_cast<int>(cudaGetLastError());
}
