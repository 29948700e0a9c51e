// Triangle set-up of the differentiable pipeline, forward and backward, for
// sm_90a: diff/pipeline.prim_setup on CUDA float32 tensors as two kernels a
// step, launched by diff/cuda_prim.py for diff/pipeline._PrimSetup.
//
// Replaces no Pallas TPU kernel.  The JAX package sets its triangles up in
// plain jnp (skybox_rt_tpu/diff/pipeline.py prim_setup) and leaves the fusion
// of the corner gathers and the elementwise clip and edge arithmetic to XLA,
// and their transpose to XLA's transpose of the same graph.  Run as plain
// torch, the set-up is about 85 launches forward and 135 backward on 5,120
// rows: the host's launches, not the card, set the training step's pace.
//
// The function, for triangle p with corner vertices v_k = indices[p, k]
// (k = 0, 1, 2; a negative index reads row 0 and one past the table its last
// row, as a clamp would), (px, py, pz, pw) = pos[v_k]:
//   x_k = px hw + pw hw;  y_k = py hh + pw hh;  w_k = pw
//     (hw, hh = width / 2, height / 2: pipeline.clip_to_hdc)
//   z_k = (pz / pw) hd + zo  (hd = (far - near) / 2, zo = near + hd:
//     pipeline.screen_z)
//   with j = k + 1, l = k + 2 (mod 3), the cofactors
//     a_k = y_j w_l - y_l w_j;  b_k = x_l w_j - x_j w_l;  c_k = x_j y_l - x_l y_j
//   det = (c_0 w_0 + c_1 w_1) + c_2 w_2;  s = det < 0 ? -1 : 1 (0 and NaN: 1)
//   the record row (pipeline.edge_matrix, then shade_slots' packing):
//     [3k, 3k + 3): a_k s, b_k s, c_k s + 0.5 (a_k s + b_k s)  (the
//       half-pixel offset), [9, 21): the corners' colour rows, [21, 27): the
//       corners' uv rows when textured
//   corner[k P + p] = indices[p, k] unclamped: the corner-major index list
//     whose transpose the backward's row accumulation takes.
// Backward, from the record's gradient row G (z carries none): the chain
// rule in closed form through the same expressions (autograd's rules for
// mul, sub, add and the selects), recomputed from pos and indices:
//   h_k = 0.5 G[3k+2];  ga_k = (G[3k] + h_k) s;  gb_k = (G[3k+1] + h_k) s;
//   gc_k = G[3k+2] s
//   gx_k = ((gb_j w_l - gb_l w_j) - gc_j y_l) + gc_l y_j
//   gy_k = ((ga_l w_j - ga_j w_l) + gc_j x_l) - gc_l x_j
//   gw_k = ((ga_j y_l - ga_l y_j) - gb_j x_l) + gb_l x_j
//   pos row of corner k: (gx_k hw, gy_k hh, 0, (gx_k hw + gy_k hh) + gw_k)
//   colour and uv rows of corner k: G's columns of that corner.
// The rows are written corner-major, row k P + p, as the plain path's
// corner gathers (pipeline.gather_rows over the concatenated index columns)
// lay them out; the caller sums them into the vertex tables with the row
// accumulation (csrc/diff_accumulate.cu) over `corner`, in its pinned
// order.  A thread writes its triangle's rows alone: no floating-point
// atomics, and two launches on the same inputs give the same bits.
//
// Exactness: the plain path's float32 expressions in its order and
// association, each a single round-to-nearest intrinsic, under the build's
// -fmad=false -prec-div=true, and the constants rounded to float32 as
// torch rounds a Python scalar operand: the record and z equal the plain
// path's bit for bit.  Autograd adds a variable's gradient contributions in
// an order of its own, so the backward agrees with it to float rounding;
// diff/cuda_prim.prim_backward_reference repeats the kernel's order and
// equals it bit for bit.
//
// Design.  A thread a triangle, 64 a block (5,120 triangles fill 80 of the
// 132 SMs): the three indices, then the corners' rows as float4 / float2
// through the read-only path; the record row (84 or 108 bytes) written as
// scalars.  What bounds it on the H100: neither bytes (about 0.6 MB each way
// at P = 5,120, 0.2 us at 3.35 TB/s) nor operations (about 100 a triangle)
// but the launch and the chain of dependent loads (index, then row), a few
// microseconds: the step's gain is the ~220 launches it takes off the host.
#include <cuda_runtime.h>

namespace diff_prim {

constexpr int kThreads = 64;

struct Consts {
  float hw, hh, hd, zo;
};

__device__ __forceinline__ int row_of(int v, int V) {
  return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// x_k, y_k, w_k of the three corners (pipeline.clip_to_hdc); z_k too when
// `z` is not null
__device__ __forceinline__ void corners(const float4* __restrict__ pos,
                                        const int* v, const Consts& k,
                                        float* x, float* y, float* w,
                                        float* z) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float4 q = __ldg(pos + v[c]);
    x[c] = __fadd_rn(__fmul_rn(q.x, k.hw), __fmul_rn(q.w, k.hw));
    y[c] = __fadd_rn(__fmul_rn(q.y, k.hh), __fmul_rn(q.w, k.hh));
    w[c] = q.w;
    if (z != nullptr)
      z[c] = __fadd_rn(__fmul_rn(__fdiv_rn(q.z, q.w), k.hd), k.zo);
  }
}

// The edge sign s of pipeline.edge_matrix: -1 where det < 0, else 1
__device__ __forceinline__ float edge_sign(const float* x, const float* y,
                                           const float* w) {
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, l = (i + 2) % 3;
    c[i] = __fsub_rn(__fmul_rn(x[j], y[l]), __fmul_rn(x[l], y[j]));
  }
  const float det = __fadd_rn(
      __fadd_rn(__fmul_rn(c[0], w[0]), __fmul_rn(c[1], w[1])),
      __fmul_rn(c[2], w[2]));
  return det < 0.0f ? -1.0f : 1.0f;
}

template <bool kTextured>
__global__ void __launch_bounds__(kThreads)
diff_prim_forward_kernel(const float4* __restrict__ pos,
                         const float4* __restrict__ color,
                         const float2* __restrict__ uv,
                         const int* __restrict__ indices, int P, int V,
                         Consts k, float* __restrict__ rec,
                         float* __restrict__ z, int* __restrict__ corner) {
  constexpr int C = kTextured ? 27 : 21;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int i = __ldg(indices + 3 * p + c);
    corner[c * P + p] = i;
    v[c] = row_of(i, V);
  }
  float x[3], y[3], w[3], zs[3];
  corners(pos, v, k, x, y, w, zs);
  const float s = edge_sign(x, y, w);
  float* r = rec + static_cast<size_t>(p) * C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, l = (i + 2) % 3;
    const float a = __fmul_rn(
        __fsub_rn(__fmul_rn(y[j], w[l]), __fmul_rn(y[l], w[j])), s);
    const float b = __fmul_rn(
        __fsub_rn(__fmul_rn(x[l], w[j]), __fmul_rn(x[j], w[l])), s);
    const float c = __fmul_rn(
        __fsub_rn(__fmul_rn(x[j], y[l]), __fmul_rn(x[l], y[j])), s);
    r[3 * i] = a;
    r[3 * i + 1] = b;
    r[3 * i + 2] = __fadd_rn(c, __fmul_rn(__fadd_rn(a, b), 0.5f));
    z[3 * p + i] = zs[i];
    const float4 col = __ldg(color + v[i]);
    r[9 + 4 * i] = col.x;
    r[10 + 4 * i] = col.y;
    r[11 + 4 * i] = col.z;
    r[12 + 4 * i] = col.w;
    if constexpr (kTextured) {
      const float2 t = __ldg(uv + v[i]);
      r[21 + 2 * i] = t.x;
      r[22 + 2 * i] = t.y;
    }
  }
}

template <bool kTextured>
__global__ void __launch_bounds__(kThreads)
diff_prim_backward_kernel(const float4* __restrict__ pos,
                          const int* __restrict__ indices,
                          const float* __restrict__ grec, int P, int V,
                          Consts k, float4* __restrict__ dpos,
                          float4* __restrict__ dcol,
                          float2* __restrict__ duv) {
  constexpr int C = kTextured ? 27 : 21;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = row_of(__ldg(indices + 3 * p + c), V);
  float x[3], y[3], w[3];
  corners(pos, v, k, x, y, w, nullptr);
  const float s = edge_sign(x, y, w);
  const float* g = grec + static_cast<size_t>(p) * C;
  float ga[3], gb[3], gc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float gcoff = __ldg(g + 3 * i + 2);
    const float h = __fmul_rn(gcoff, 0.5f);
    ga[i] = __fmul_rn(__fadd_rn(__ldg(g + 3 * i), h), s);
    gb[i] = __fmul_rn(__fadd_rn(__ldg(g + 3 * i + 1), h), s);
    gc[i] = __fmul_rn(gcoff, s);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, l = (i + 2) % 3;
    const float gx = __fadd_rn(
        __fsub_rn(__fsub_rn(__fmul_rn(gb[j], w[l]), __fmul_rn(gb[l], w[j])),
                  __fmul_rn(gc[j], y[l])),
        __fmul_rn(gc[l], y[j]));
    const float gy = __fsub_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(ga[l], w[j]), __fmul_rn(ga[j], w[l])),
                  __fmul_rn(gc[j], x[l])),
        __fmul_rn(gc[l], x[j]));
    const float gw = __fadd_rn(
        __fsub_rn(__fsub_rn(__fmul_rn(ga[j], y[l]), __fmul_rn(ga[l], y[j])),
                  __fmul_rn(gb[j], x[l])),
        __fmul_rn(gb[l], x[j]));
    const float gpx = __fmul_rn(gx, k.hw);
    const float gpy = __fmul_rn(gy, k.hh);
    const size_t row = static_cast<size_t>(i) * P + p;
    dpos[row] = make_float4(gpx, gpy, 0.0f, __fadd_rn(__fadd_rn(gpx, gpy),
                                                      gw));
    dcol[row] = make_float4(__ldg(g + 9 + 4 * i), __ldg(g + 10 + 4 * i),
                            __ldg(g + 11 + 4 * i), __ldg(g + 12 + 4 * i));
    if constexpr (kTextured)
      duv[row] = make_float2(__ldg(g + 21 + 2 * i), __ldg(g + 22 + 2 * i));
  }
}

inline unsigned blocks(int P) {
  return static_cast<unsigned>((P + kThreads - 1) / kThreads);
}

}  // namespace diff_prim

// The forward: pos (V, 4), color (V, 4) and uv (V, 2) float32 (uv null
// untextured), indices (P, 3) int32 -> rec (P, 27 | 21) float32, z (P, 3)
// float32 and corner (3 P) int32.  hw hh hd zo as pipeline.clip_to_hdc and
// screen_z round them.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller validates shapes and alignment.
extern "C" int skybox_diff_prim_forward(
    const void* pos, const void* color, const void* uv, const void* indices,
    void* rec, void* z, void* corner, int P, int V, float hw, float hh,
    float hd, float zo, void* stream) {
  using namespace diff_prim;
  if (P < 0 || (P > 0 && V <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  const Consts k = {hw, hh, hd, zo};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (uv != nullptr)
    diff_prim_forward_kernel<true><<<blocks(P), kThreads, 0, st>>>(
        static_cast<const float4*>(pos), static_cast<const float4*>(color),
        static_cast<const float2*>(uv), static_cast<const int*>(indices), P,
        V, k, static_cast<float*>(rec), static_cast<float*>(z),
        static_cast<int*>(corner));
  else
    diff_prim_forward_kernel<false><<<blocks(P), kThreads, 0, st>>>(
        static_cast<const float4*>(pos), static_cast<const float4*>(color),
        nullptr, static_cast<const int*>(indices), P, V, k,
        static_cast<float*>(rec), static_cast<float*>(z),
        static_cast<int*>(corner));
  return static_cast<int>(cudaGetLastError());
}

// The backward: pos (V, 4) float32, indices (P, 3) int32 and grec (P, 27 |
// 21) float32 (27 when duv is not null) -> dpos and dcol (3 P, 4) float32,
// duv (3 P, 2) float32 or null, corner-major.
extern "C" int skybox_diff_prim_backward(
    const void* pos, const void* indices, const void* grec, void* dpos,
    void* dcol, void* duv, int P, int V, float hw, float hh, void* stream) {
  using namespace diff_prim;
  if (P < 0 || (P > 0 && V <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  const Consts k = {hw, hh, 0.0f, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (duv != nullptr)
    diff_prim_backward_kernel<true><<<blocks(P), kThreads, 0, st>>>(
        static_cast<const float4*>(pos), static_cast<const int*>(indices),
        static_cast<const float*>(grec), P, V, k,
        static_cast<float4*>(dpos), static_cast<float4*>(dcol),
        static_cast<float2*>(duv));
  else
    diff_prim_backward_kernel<false><<<blocks(P), kThreads, 0, st>>>(
        static_cast<const float4*>(pos), static_cast<const int*>(indices),
        static_cast<const float*>(grec), P, V, k,
        static_cast<float4*>(dpos), static_cast<float4*>(dcol), nullptr);
  return static_cast<int>(cudaGetLastError());
}
