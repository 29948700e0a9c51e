// Hard-mode slot shading of the differentiable pipeline, forward and
// backward, for sm_90a: diff/pipeline.shade_slots where visibility hands it
// one slot (no blend, no soft edge), as two kernels a step, launched by
// diff/cuda_shade.py for diff/pipeline._ShadeHard.
//
// Replaces no Pallas TPU kernel.  The JAX package shades the slots in plain
// jnp (skybox_rt_tpu/diff/pipeline.py shade_slots) and leaves the fusion of
// its elementwise operations to XLA, and its backward pass to XLA's
// transpose of the same graph.  Run as plain torch, the one-slot shade is
// about 80 launches forward and 140 backward, and the backward's per-tile
// slot reduction is a batched one-hot matrix product (T, pixels, M): the
// host's launches, not the card, set the training step's pace.
//
// The function, a pixel of tile t at integer coordinates (x, y) = origin +
// local, its winner step s = steps[t, pixel] (outside [0, M): background):
//   r = rec[max(tile_pids[t, s], 0)], the prim's packed record: edges (3 x
//     [a, b, c]) [0, 9), corner colours (3 x RGBA) [9, 21), corner uvs
//     (3 x [u, v]) [21, 27) when textured
//   e_k = (a_k x + b_k y) + c_k;  den = (e0 + e1) + e2;
//   denom = |den| > 1e-20 ? den : 1e-20;  b0 = e0 / denom;  b1 = e1 / denom;
//   b2 = (1 - b0) - b1;  interp(p) = (p0 b0 + p1 b1) + p2 b2
//   col = interp(colour);  textured: the bilinear quad sample of the rolled
//     quad table (diff/pipeline._quad_texture) at interp(uv), repeat wrap,
//     and col = modulate ? col * texel : texel
//   out = col * 1 + background * (1 - 1); a background pixel: background.
// Backward, from the upstream gradient g of out: the chain rule through the
// same expressions (autograd's rules for mul, div, where and the quad
// sampler's hand-written backward, diff/pipeline._SampleQuad), recomputed
// from the inputs; nothing a pixel is saved by the forward.  It writes
//   (a) grec (T, M, C): every pixel's record gradient summed into its
//       tile's slot s, in a PINNED order: 0 + the rows of the slot's pixels
//       in ascending pixel index, one float32 add each, no floating-point
//       atomics; a slot no pixel took gets +0.  Two launches on the same
//       inputs give the same bits; diff/cuda_shade.tile_rows_reference is
//       the plain twin of this reduction.  The caller sums grec's rows into
//       rec's with the row accumulation (the transpose of the tile_pids
//       gather, csrc/diff_accumulate.cu).
//   (b) textured: a pixel's texel-quad row (16 = 4 corners x RGBA, the
//       weights times the texel's gradient) and its anchor (the quad
//       table's row), -1 and zeros for a background pixel; the caller hands
//       them to the row accumulation (csrc/diff_accumulate.cu) as
//       _SampleQuad.backward hands on its rows.
//
// Exactness (forward): the plain loop's float32 expressions in its order
// and association, each a single round-to-nearest intrinsic, under the
// build's -fmad=false -prec-div=true: the image equals the plain path's bit
// for bit.  torch.remainder(x, 1.0) is ATen's fmodf and + 1 where the result
// is nonzero and negative; the texel anchor is the truncating float ->
// int64 conversion of the floor and Python's modulo (as csrc/rt_shade.cu).
// The backward follows the same rules term by term, but autograd adds a
// variable's gradient contributions in an order of its own and reduces the
// tile's slots through a matrix product: the gradients agree with the plain
// path's to float rounding, not bit for bit.
//
// Design.  Forward: a thread a pixel, 256 a block; the record row (84 or
// 108 bytes, not 16-byte aligned) read from rec through tile_pids as
// scalars through the read-only path (no (T, M, C) copy of the tiles'
// records is made), the quad row and the output as float4.  Backward: a
// block of 8 warps a tile.  Slots are taken in chunks of kSlotChunk (any M): the
// block counts the chunk's pixels a slot (integer shared atomics), scans
// the counts, and one warp places the pixels in ascending order into a
// shared list a slot (a stable counting sort: __match_any_sync ranks the
// lanes of a slot, the slot's cursor moves once a warp step).  Then a warp
// a slot walks its list 32 pixels at a time: lane j computes pixel j's row
// and writes it to the warp's shared buffer, and lane c adds column c of
// the 32 rows in order, so the sum's order is the list's.  Any tile size of
// kernel #4 (8 to 64 pixels square, 4,096 pixels at most) and any M.
//
// What bounds it on the H100: bytes.  Forward, a pixel reads its step (4
// B) and writes 16; the records (P * C floats), the tile lists (T * M
// ints) and the 64 KB quad table are read once from device memory and then
// hit in L1 / L2.
// Backward, a pixel reads its step and gradient (20 B) and, textured,
// writes its quad row and anchor (68 B); grec (T * M * C floats) is
// written once.  A few hundred float operations a pixel; the one warp's
// placement walk (a tile's pixels / 32 steps) and a slot's serial sum are
// latency the other blocks on the SM hide.
#include <cuda_runtime.h>

namespace diff_shade {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotChunk = 1024;     // slots a pass of the backward's sort
constexpr int kMaxPixels = 4096;     // a 64 x 64 tile
constexpr int kMaxWidth = 27;        // record floats, textured
constexpr int kRowStride = kMaxWidth + 2;   // odd: no shared bank conflicts
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Inputs {
  const float* rec;       // (P, C)
  const int* pids;        // (T, M), -1 padded
  const float* texq;      // (TH * TW, 16) or null
  const int* steps;       // (T, ts * ts)
  const int* origins;     // (T, 2)
  int M, C, tls, TH, TW;
};

// (a * x + b * y) + c
__device__ __forceinline__ float edge_eval(float a, float b, float c, float x,
                                           float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// (p0 * b0 + p1 * b1) + p2 * b2
__device__ __forceinline__ float interp(float p0, float p1, float p2,
                                        float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p0, b0), __fmul_rn(p1, b1)),
                   __fmul_rn(p2, b2));
}

// torch.remainder(a, b) on float32, as ATen's CUDA kernel computes it
__device__ __forceinline__ float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

// torch.remainder(a, b) on int64: Python's modulo
__device__ __forceinline__ long long remainder_i(long long a, long long b) {
  long long m = a % b;
  if (m != 0 && ((m < 0) != (b < 0))) m += b;
  return m;
}

// a + f * (b - a) (diff/pipeline._quad_lerp)
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// One axis of diff/pipeline._quad_sample_prep: the fraction and the cell
__device__ __forceinline__ void tap(float s, int size, float& f,
                                    long long& i0) {
  const float v = __fsub_rn(__fmul_rn(remainder_f(s, 1.0f), (float)size),
                            0.5f);
  const float v0 = floorf(v);
  f = __fsub_rn(v, v0);
  i0 = remainder_i((long long)v0, size);
}

// A live pixel's forward intermediates.
struct Pixel {
  float e[3], denom, b[3];
  bool big;                     // |den| > 1e-20
  float col[4];                 // interp(colour)
  float fx, fy;                 // textured
  long long anchor;
  float4 q[4];                  // the quad row: t00, t01, t10, t11
  float texel[4];
};

template <bool kTextured>
__device__ __forceinline__ void pixel_forward(const Inputs& in,
                                              const float* __restrict__ r,
                                              float x, float y, Pixel& p) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p.e[k] = edge_eval(__ldg(r + 3 * k), __ldg(r + 3 * k + 1),
                       __ldg(r + 3 * k + 2), x, y);
  const float den = __fadd_rn(__fadd_rn(p.e[0], p.e[1]), p.e[2]);
  p.big = fabsf(den) > 1e-20f;
  p.denom = p.big ? den : 1e-20f;
  p.b[0] = __fdiv_rn(p.e[0], p.denom);
  p.b[1] = __fdiv_rn(p.e[1], p.denom);
  p.b[2] = __fsub_rn(__fsub_rn(1.0f, p.b[0]), p.b[1]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    p.col[c] = interp(__ldg(r + 9 + c), __ldg(r + 13 + c), __ldg(r + 17 + c),
                      p.b[0], p.b[1], p.b[2]);
  if constexpr (kTextured) {
    float uv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      uv[j] = interp(__ldg(r + 21 + j), __ldg(r + 23 + j), __ldg(r + 25 + j),
                     p.b[0], p.b[1], p.b[2]);
    long long x0, y0;
    tap(uv[0], in.TW, p.fx, x0);
    tap(uv[1], in.TH, p.fy, y0);
    p.anchor = y0 * in.TW + x0;
    const float4* q = reinterpret_cast<const float4*>(in.texq) + 4 * p.anchor;
#pragma unroll
    for (int k = 0; k < 4; ++k) p.q[k] = __ldg(q + k);
    const float* t00 = &p.q[0].x;
    const float* t01 = &p.q[1].x;
    const float* t10 = &p.q[2].x;
    const float* t11 = &p.q[3].x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float cx0 = lerp(t00[c], t01[c], p.fx);
      const float cx1 = lerp(t10[c], t11[c], p.fx);
      p.texel[c] = lerp(cx0, cx1, p.fy);
    }
  }
}

// The pixel's step, and whether it is live (a step in [0, M))
__device__ __forceinline__ bool live_step(const Inputs& in, int s) {
  return s >= 0 && s < in.M;
}

// The record row of step s of tile t (a padding entry reads row 0, as the
// plain gather's clamp does)
__device__ __forceinline__ const float* record(const Inputs& in, int t,
                                               int s) {
  const int pid = __ldg(in.pids + static_cast<size_t>(t) * in.M + s);
  return in.rec + static_cast<size_t>(pid > 0 ? pid : 0) * in.C;
}

template <bool kTextured, bool kModulate>
__global__ void __launch_bounds__(kThreads)
diff_shade_forward_kernel(Inputs in, float4 bg, float4* __restrict__ out,
                          long long pixels) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= pixels) return;
  const int tls = in.tls;
  const int t = static_cast<int>(i >> (2 * tls));
  const int local = static_cast<int>(i & ((1 << (2 * tls)) - 1));
  const int s = __ldg(in.steps + i);
  if (!live_step(in, s)) {
    out[i] = bg;
    return;
  }
  const float x = __int2float_rn(__ldg(in.origins + 2 * t)
                                 + (local & ((1 << tls) - 1)));
  const float y = __int2float_rn(__ldg(in.origins + 2 * t + 1)
                                 + (local >> tls));
  const float* r = record(in, t, s);
  Pixel p;
  pixel_forward<kTextured>(in, r, x, y, p);
  float col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    col[c] = !kTextured ? p.col[c]
             : kModulate ? __fmul_rn(p.col[c], p.texel[c]) : p.texel[c];
  // the plain loop's composite at cov_w = 1: col * 1 + bg * (1 - 1)
  const float keep = __fsub_rn(1.0f, 1.0f);
  const float bgc[4] = {bg.x, bg.y, bg.z, bg.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    col[c] = __fadd_rn(__fmul_rn(col[c], 1.0f), __fmul_rn(bgc[c], keep));
  out[i] = make_float4(col[0], col[1], col[2], col[3]);
}

// A live pixel's record gradient (C floats, into `row`) and, textured, its
// quad row and anchor (into rows / anchor at index `pix`).
template <bool kTextured, bool kModulate>
__device__ __forceinline__ void pixel_backward(
    const Inputs& in, const float* __restrict__ r, float x, float y,
    float4 g4, float* row, float4* __restrict__ rows,
    int* __restrict__ anchor, long long pix) {
  Pixel p;
  pixel_forward<kTextured>(in, r, x, y, p);
  // where(live) and the composite: the colour's gradient is g * cov_w
  const float g[4] = {__fmul_rn(g4.x, 1.0f), __fmul_rn(g4.y, 1.0f),
                      __fmul_rn(g4.z, 1.0f), __fmul_rn(g4.w, 1.0f)};
  float gcol[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // of interp(colour)
  float gb[3] = {0.0f, 0.0f, 0.0f};
  float guv[2] = {0.0f, 0.0f};
  if constexpr (kTextured) {
    float gt[4];                                // of the texel
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      gt[c] = kModulate ? __fmul_rn(g[c], p.col[c]) : g[c];
      if (kModulate) gcol[c] = __fmul_rn(g[c], p.texel[c]);
    }
    // _SampleQuad.backward
    const float* t00 = &p.q[0].x;
    const float* t01 = &p.q[1].x;
    const float* t10 = &p.q[2].x;
    const float* t11 = &p.q[3].x;
    const float ofx = __fsub_rn(1.0f, p.fx);
    const float ofy = __fsub_rn(1.0f, p.fy);
    float dfx = 0.0f, dfy = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float ax = __fadd_rn(__fmul_rn(__fsub_rn(t01[c], t00[c]), ofy),
                                 __fmul_rn(__fsub_rn(t11[c], t10[c]), p.fy));
      const float ay = __fadd_rn(__fmul_rn(__fsub_rn(t10[c], t00[c]), ofx),
                                 __fmul_rn(__fsub_rn(t11[c], t01[c]), p.fx));
      const float tx = __fmul_rn(gt[c], ax);
      const float ty = __fmul_rn(gt[c], ay);
      dfx = c ? __fadd_rn(dfx, tx) : tx;
      dfy = c ? __fadd_rn(dfy, ty) : ty;
    }
    guv[0] = __fmul_rn(dfx, (float)in.TW);
    guv[1] = __fmul_rn(dfy, (float)in.TH);
    const float w[4] = {__fmul_rn(ofx, ofy), __fmul_rn(p.fx, ofy),
                        __fmul_rn(ofx, p.fy), __fmul_rn(p.fx, p.fy)};
    float4* out = rows + 4 * pix;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = make_float4(__fmul_rn(w[k], gt[0]), __fmul_rn(w[k], gt[1]),
                           __fmul_rn(w[k], gt[2]), __fmul_rn(w[k], gt[3]));
    anchor[pix] = static_cast<int>(p.anchor);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) gcol[c] = g[c];
  }
  // interp(colour) and interp(uv): the corners' rows and the barycentrics.
  // Textured without modulate, the colour is not in the graph: its columns
  // get 0 and the barycentrics nothing from it
  constexpr bool kColour = !kTextured || kModulate;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      row[9 + 4 * k + c] = kColour ? __fmul_rn(gcol[c], p.b[k]) : 0.0f;
      if constexpr (kColour) {
        const float v = __fmul_rn(gcol[c], __ldg(r + 9 + 4 * k + c));
        acc = c ? __fadd_rn(acc, v) : v;
      }
    }
    if constexpr (kTextured) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        row[21 + 2 * k + j] = __fmul_rn(guv[j], p.b[k]);
      const float v = __fadd_rn(__fmul_rn(guv[0], __ldg(r + 21 + 2 * k)),
                                __fmul_rn(guv[1], __ldg(r + 22 + 2 * k)));
      acc = kColour ? __fadd_rn(acc, v) : v;
    }
    gb[k] = acc;
  }
  // b2 = (1 - b0) - b1;  b_k = e_k / denom;  denom = where(big, den, 1e-20)
  const float gb0 = __fsub_rn(gb[0], gb[2]);
  const float gb1 = __fsub_rn(gb[1], gb[2]);
  const float dd = __fmul_rn(p.denom, p.denom);
  const float gden = __fadd_rn(__fdiv_rn(__fmul_rn(-gb0, p.e[0]), dd),
                               __fdiv_rn(__fmul_rn(-gb1, p.e[1]), dd));
  const float gs = p.big ? gden : 0.0f;
  const float ge[3] = {__fadd_rn(__fdiv_rn(gb0, p.denom), gs),
                       __fadd_rn(__fdiv_rn(gb1, p.denom), gs), gs};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    row[3 * k] = __fmul_rn(ge[k], x);
    row[3 * k + 1] = __fmul_rn(ge[k], y);
    row[3 * k + 2] = ge[k];
  }
}

// Exclusive scan of cnt[0, n) in place (n <= kSlotChunk), its total into
// cnt[n]; cursor gets the same offsets.  Called by the whole block.
__device__ __forceinline__ void block_scan(int* cnt, int* cursor, int n,
                                           int* warp_sums) {
  constexpr int kEach = kSlotChunk / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v[kEach];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const int i = threadIdx.x * kEach + k;
    v[k] = i < n ? cnt[i] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  int excl = before + incl - sum;
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const int i = threadIdx.x * kEach + k;
    if (i < n) {
      cnt[i] = excl;
      cursor[i] = excl;
    }
    excl += v[k];
  }
  if (threadIdx.x == kThreads - 1) cnt[n] = excl;
  __syncthreads();
}

template <bool kTextured, bool kModulate>
__global__ void __launch_bounds__(kThreads)
diff_shade_backward_kernel(Inputs in, const float4* __restrict__ grad,
                           float* __restrict__ grec, float4* __restrict__ rows,
                           int* __restrict__ anchor) {
  __shared__ int start[kSlotChunk + 1];
  __shared__ int cursor[kSlotChunk];
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned short order[kMaxPixels];
  __shared__ float buf[kWarps][32 * kRowStride];
  const int t = blockIdx.x;
  const int tls = in.tls;
  const int npx = 1 << (2 * tls);
  const long long base = static_cast<long long>(t) << (2 * tls);
  const int* steps = in.steps + base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = in.C;
  const int orx = __ldg(in.origins + 2 * t);
  const int ory = __ldg(in.origins + 2 * t + 1);

  if constexpr (kTextured) {
    // a background pixel gives the texture nothing: anchor -1, zero row
    for (int q = threadIdx.x; q < npx; q += kThreads) {
      if (!live_step(in, __ldg(steps + q))) {
        anchor[base + q] = -1;
        float4* out = rows + 4 * (base + q);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  for (int m0 = 0; m0 < in.M; m0 += kSlotChunk) {
    const int nm = in.M - m0 < kSlotChunk ? in.M - m0 : kSlotChunk;
    for (int i = threadIdx.x; i < nm; i += kThreads) start[i] = 0;
    __syncthreads();
    // 1. the chunk's pixels a slot (integer atomics: exact in any order)
    for (int q = threadIdx.x; q < npx; q += kThreads) {
      const int s = __ldg(steps + q) - m0;
      if (s >= 0 && s < nm) atomicAdd(&start[s], 1);
    }
    __syncthreads();
    // 2. offsets
    block_scan(start, cursor, nm, warp_sums);
    // 3. one warp places the pixels in ascending order: a slot's list is
    //    sorted by pixel index
    if (warp == 0) {
      for (int q0 = 0; q0 < npx; q0 += 32) {
        const int q = q0 + lane;
        const int s = __ldg(steps + q) - m0;
        const bool mine = s >= 0 && s < nm;
        const unsigned peers = __match_any_sync(kFull, mine ? s : -1);
        if (mine)
          order[cursor[s] + __popc(peers & ((1u << lane) - 1))] =
              static_cast<unsigned short>(q);
        __syncwarp();
        if (mine && lane == __ffs(peers) - 1) cursor[s] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // 4. a warp a slot: 0 + the slot's rows in list order, column by lane
    float* wbuf = buf[warp];
    for (int j = warp; j < nm; j += kWarps) {
      const int first = start[j];
      const int n = start[j + 1] - first;
      const float* r = record(in, t, m0 + j);
      float acc = 0.0f;
      for (int i0 = 0; i0 < n; i0 += 32) {
        if (i0 + lane < n) {
          const int q = order[first + i0 + lane];
          const float x = __int2float_rn(orx + (q & ((1 << tls) - 1)));
          const float y = __int2float_rn(ory + (q >> tls));
          float* row = wbuf + lane * kRowStride;
          pixel_backward<kTextured, kModulate>(
              in, r, x, y, __ldg(grad + base + q), row, rows, anchor,
              base + q);
        }
        __syncwarp();
        const int k = n - i0 < 32 ? n - i0 : 32;
        if (lane < C)
          for (int u = 0; u < k; ++u)
            acc = __fadd_rn(acc, wbuf[u * kRowStride + lane]);
        __syncwarp();
      }
      if (lane < C) grec[(static_cast<size_t>(t) * in.M + m0 + j) * C + lane] =
          acc;
    }
    __syncthreads();
  }
}

template <bool kTextured, bool kModulate>
int launch(const Inputs& in, int T, const float* bg, float* out,
           const float* grad, float* grec, float* rows, int* anchor,
           cudaStream_t st) {
  if (out != nullptr) {
    const long long pixels = static_cast<long long>(T) << (2 * in.tls);
    const long long blocks = (pixels + kThreads - 1) / kThreads;
    diff_shade_forward_kernel<kTextured, kModulate><<<
        static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        in, make_float4(bg[0], bg[1], bg[2], bg[3]),
        reinterpret_cast<float4*>(out), pixels);
  } else {
    diff_shade_backward_kernel<kTextured, kModulate><<<T, kThreads, 0, st>>>(
        in, reinterpret_cast<const float4*>(grad), grec,
        reinterpret_cast<float4*>(rows), anchor);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Inputs& in, int T, int modulate, const float* bg,
             float* out, const float* grad, float* grec, float* rows,
             int* anchor, cudaStream_t st) {
  const bool textured = in.texq != nullptr;
  if (in.tls < 3 || in.tls > 6 || T < 0 || in.M < 0
      || in.C != (textured ? 27 : 21) || (textured && (in.TH <= 0
                                                       || in.TW <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  if (!textured)
    return launch<false, false>(in, T, bg, out, grad, grec, rows, anchor, st);
  if (modulate)
    return launch<true, true>(in, T, bg, out, grad, grec, rows, anchor, st);
  return launch<true, false>(in, T, bg, out, grad, grec, rows, anchor, st);
}

}  // namespace diff_shade

// The forward: rec (P, C) float32, tile_pids (T, M) int32, texq (TH * TW,
// 16) float32 or null (untextured), steps (T, ts * ts) and origins (T, 2)
// int32 -> out (T, ts, ts, 4) float32.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller validates shapes.
extern "C" int skybox_diff_shade_forward(
    const void* rec, const void* tile_pids, const void* texq,
    const void* steps, const void* origins, void* out, int T, int M, int C,
    int tile_logsize, int TH, int TW, int modulate, float bg0, float bg1,
    float bg2, float bg3, void* stream) {
  using namespace diff_shade;
  const Inputs in = {static_cast<const float*>(rec),
                     static_cast<const int*>(tile_pids),
                     static_cast<const float*>(texq),
                     static_cast<const int*>(steps),
                     static_cast<const int*>(origins), M, C, tile_logsize, TH,
                     TW};
  const float bg[4] = {bg0, bg1, bg2, bg3};
  return dispatch(in, T, modulate, bg, static_cast<float*>(out), nullptr,
                  nullptr, nullptr, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// The backward: the forward's inputs and grad (T, ts, ts, 4) float32 ->
// grec (T, M, C) float32 and, textured, rows (T * ts * ts, 16) float32 and
// anchor (T * ts * ts) int32 (null untextured).
extern "C" int skybox_diff_shade_backward(
    const void* rec, const void* tile_pids, const void* texq,
    const void* steps, const void* origins, const void* grad, void* grec,
    void* rows, void* anchor, int T, int M, int C, int tile_logsize, int TH,
    int TW, int modulate, void* stream) {
  using namespace diff_shade;
  const Inputs in = {static_cast<const float*>(rec),
                     static_cast<const int*>(tile_pids),
                     static_cast<const float*>(texq),
                     static_cast<const int*>(steps),
                     static_cast<const int*>(origins), M, C, tile_logsize, TH,
                     TW};
  if ((texq != nullptr) != (rows != nullptr)
      || (rows != nullptr) != (anchor != nullptr) || grec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(in, T, modulate, nullptr, nullptr,
                  static_cast<const float*>(grad), static_cast<float*>(grec),
                  static_cast<float*>(rows), static_cast<int*>(anchor),
                  static_cast<cudaStream_t>(stream));
}
