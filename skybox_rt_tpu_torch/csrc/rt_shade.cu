// Shading of a hit batch, for sm_90a: rt/tracer.shade_hits (Lambert, an
// optional bilinear texture, the shadow ray) as one kernel a call, launched
// before the occlusion query.
//
// Replaces no Pallas TPU kernel.  The JAX package shades in plain jnp
// (skybox_rt_tpu/rt/tracer.py shade_hits) and leaves the fusion of its
// elementwise operations to XLA.  Run as plain torch, the same body is about
// 60 launches a call untextured and 100 textured, three calls a 2-bounce
// frame, and the host's launches, not the card, set the frame's pace.
//
// The function (ops/cuda_rt.py shade_hits_reference is the plain torch
// twin), a thread a ray r:
//   hit = prim >= 0;  pt = o + d * (hit ? t : 0)
//   the record row rec[max(prim, 0)] (rt/tracer.scene_shade_arrays):
//     corner normals n0 n1 n2 [0, 9), corner colours c0 c1 c2 (RGBA)
//     [9, 21), corner uvs [21, 27) when textured
//   n = interp(n0, n1, n2) / max(|interp|, 1e-20), negated where n . d > 0
//   albedo = interp(c0, c1, c2).rgb, times the bilinear texel at interp(uv)
//     (repeat wrapping) when textured
//   ndotl = max(n . l, 0), l = light_dir / |light_dir|
//   rgb = albedo * (ambient + ndotl * light_color)
//   and with shadows:
//   dark = albedo * (ambient + 0 * light_color), the colour of a blocked ray
//   need = hit & ndotl > 0;  sh_o = need ? pt + n * offset : park;  sh_d = l
// The caller runs the occlusion query on (sh_o, sh_d) and takes dark where
// it is blocked (one torch.where): the twin's where(blocked, 0, ndotl)
// before the same product.  interp(a, b, c) = a * (1 - u - v) + b * u + c * v.
//
// Exactness: every multiply, add, subtract, divide and square root is a
// round-to-nearest intrinsic in the twin's order, term by term (_interp3,
// _norm3, _dot3 left to right), and the build's -fmad=false -prec-div=true
// say the same for the rest.  The clamps keep a NaN as torch.clamp does
// (isnan first, then fmaxf).  torch.remainder(x, 1.0) is ATen's: fmodf, then
// + 1 where the result is nonzero and negative; the texel indices are the
// truncating float -> int64 conversion of the floor and Python's modulo.  So
// kernel and twin agree bit for bit, and the frame's image with them.
//
// Bound: bytes.  A ray reads 40 bytes (o, d, prim, t, u, v) and its 84- or
// 108-byte record row, and writes 37 (pt, n, rgb, hit), 73 with shadows
// (dark, sh_o, sh_d); some 60 flop.  The 16 KB texture and the rows of a
// scene's hit prims stay in L2.  A thread a ray, 256 threads a block: the
// record rows are not 16-byte aligned, so they are read as scalars through
// the read-only path; each output is written as floats at stride 3, which a
// warp's stores cover as whole lines.
#include <cuda_runtime.h>

#define SHADE_THREADS 256

struct ShadeConsts {
    float ambient;
    float lx, ly, lz;     // the light direction as given
    float lr, lg, lb;     // the light colour
    float px, py, pz;     // the parked shadow origin
    float offset;         // the shadow origin's step along n
};

struct ShadeOut {
    float* pt;
    float* n;
    unsigned char* hit;
    float* rgb;
    float* dark;          // the three shadow outputs: null without shadows
    float* sh_o;
    float* sh_d;
};

// a * w + b * u + c * v, summed left to right (tracer._interp3)
__device__ __forceinline__ float interp(float a, float b, float c, float w,
                                        float u, float v) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, w), __fmul_rn(b, u)),
                     __fmul_rn(c, v));
}

// x . y over three components, left to right (tracer._dot3)
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                     __fmul_rn(x2, y2));
}

// torch.clamp(x, min=lo): a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
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

// one component's lerp a + f * (b - a) (diff/pipeline.sample_texture_bilinear)
__device__ __forceinline__ float lerp(float a, float b, float f) {
    return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// The one row offset and the two fractions of a bilinear tap along an axis
// of `size` texels at coordinate s: (i0, i1, f)
__device__ __forceinline__ void tap(float s, int size, long long& i0,
                                    long long& i1, float& f) {
    float x = __fsub_rn(__fmul_rn(remainder_f(s, 1.0f), (float)size), 0.5f);
    float x0 = floorf(x);
    f = __fsub_rn(x, x0);
    i0 = remainder_i((long long)x0, size);
    i1 = remainder_i(i0 + 1, size);
}

template <bool kTextured>
__global__ void __launch_bounds__(SHADE_THREADS)
shade_hits_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ prim, const float* __restrict__ t,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ rec,
                  const float* __restrict__ tex, int TH, int TW,
                  ShadeConsts k, int R, ShadeOut out) {
    int r = blockIdx.x * SHADE_THREADS + threadIdx.x;
    if (r >= R) return;
    constexpr int W = kTextured ? 27 : 21;
    float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
    float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
    int p = prim[r];
    bool hit = p >= 0;
    float tt = hit ? t[r] : 0.0f;
    float ptx = __fadd_rn(ox, __fmul_rn(dx, tt));
    float pty = __fadd_rn(oy, __fmul_rn(dy, tt));
    float ptz = __fadd_rn(oz, __fmul_rn(dz, tt));

    const float* row = rec + (size_t)(hit ? p : 0) * W;
    float fu = u[r], fv = v[r];
    float w = __fsub_rn(__fsub_rn(1.0f, fu), fv);
    float nx = interp(__ldg(row + 0), __ldg(row + 3), __ldg(row + 6), w, fu, fv);
    float ny = interp(__ldg(row + 1), __ldg(row + 4), __ldg(row + 7), w, fu, fv);
    float nz = interp(__ldg(row + 2), __ldg(row + 5), __ldg(row + 8), w, fu, fv);
    float len = clamp_min(__fsqrt_rn(dot3(nx, ny, nz, nx, ny, nz)),
                          (float)1e-20);
    nx = __fdiv_rn(nx, len);
    ny = __fdiv_rn(ny, len);
    nz = __fdiv_rn(nz, len);
    // two-sided shading: the normal faces the incoming ray
    if (dot3(nx, ny, nz, dx, dy, dz) > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
    }

    float ar = interp(__ldg(row + 9), __ldg(row + 13), __ldg(row + 17), w,
                      fu, fv);
    float ag = interp(__ldg(row + 10), __ldg(row + 14), __ldg(row + 18), w,
                      fu, fv);
    float ab = interp(__ldg(row + 11), __ldg(row + 15), __ldg(row + 19), w,
                      fu, fv);
    if constexpr (kTextured) {
        float su = interp(__ldg(row + 21), __ldg(row + 23), __ldg(row + 25),
                          w, fu, fv);
        float sv = interp(__ldg(row + 22), __ldg(row + 24), __ldg(row + 26),
                          w, fu, fv);
        long long x0, x1, y0, y1;
        float fx, fy;
        tap(su, TW, x0, x1, fx);
        tap(sv, TH, y0, y1, fy);
        const float* t00 = tex + 4 * (y0 * TW + x0);
        const float* t01 = tex + 4 * (y0 * TW + x1);
        const float* t10 = tex + 4 * (y1 * TW + x0);
        const float* t11 = tex + 4 * (y1 * TW + x1);
        float texel[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float cx0 = lerp(__ldg(t00 + c), __ldg(t01 + c), fx);
            float cx1 = lerp(__ldg(t10 + c), __ldg(t11 + c), fx);
            texel[c] = lerp(cx0, cx1, fy);
        }
        ar = __fmul_rn(ar, texel[0]);
        ag = __fmul_rn(ag, texel[1]);
        ab = __fmul_rn(ab, texel[2]);
    }

    float llen = __fsqrt_rn(dot3(k.lx, k.ly, k.lz, k.lx, k.ly, k.lz));
    float lx = __fdiv_rn(k.lx, llen);
    float ly = __fdiv_rn(k.ly, llen);
    float lz = __fdiv_rn(k.lz, llen);
    float ndotl = clamp_min(dot3(nx, ny, nz, lx, ly, lz), 0.0f);

    out.pt[3 * r + 0] = ptx;
    out.pt[3 * r + 1] = pty;
    out.pt[3 * r + 2] = ptz;
    out.n[3 * r + 0] = nx;
    out.n[3 * r + 1] = ny;
    out.n[3 * r + 2] = nz;
    out.hit[r] = hit;
    out.rgb[3 * r + 0] =
        __fmul_rn(ar, __fadd_rn(__fmul_rn(ndotl, k.lr), k.ambient));
    out.rgb[3 * r + 1] =
        __fmul_rn(ag, __fadd_rn(__fmul_rn(ndotl, k.lg), k.ambient));
    out.rgb[3 * r + 2] =
        __fmul_rn(ab, __fadd_rn(__fmul_rn(ndotl, k.lb), k.ambient));
    if (out.dark == nullptr) return;
    out.dark[3 * r + 0] =
        __fmul_rn(ar, __fadd_rn(__fmul_rn(0.0f, k.lr), k.ambient));
    out.dark[3 * r + 1] =
        __fmul_rn(ag, __fadd_rn(__fmul_rn(0.0f, k.lg), k.ambient));
    out.dark[3 * r + 2] =
        __fmul_rn(ab, __fadd_rn(__fmul_rn(0.0f, k.lb), k.ambient));
    // park the shadow rays of misses and of terminator points (ndotl <= 0:
    // the clamp already zeroed their light)
    bool need = hit && ndotl > 0.0f;
    out.sh_o[3 * r + 0] = need ? __fadd_rn(ptx, __fmul_rn(nx, k.offset)) : k.px;
    out.sh_o[3 * r + 1] = need ? __fadd_rn(pty, __fmul_rn(ny, k.offset)) : k.py;
    out.sh_o[3 * r + 2] = need ? __fadd_rn(ptz, __fmul_rn(nz, k.offset)) : k.pz;
    out.sh_d[3 * r + 0] = lx;
    out.sh_d[3 * r + 1] = ly;
    out.sh_d[3 * r + 2] = lz;
}

extern "C" int skybox_rt_shade_hits(
        const void* o, const void* d, const void* prim, const void* t,
        const void* u, const void* v, const void* rec, const void* tex,
        int rec_width, int TH, int TW, float ambient, float lx, float ly,
        float lz, float lr, float lg, float lb, float px, float py, float pz,
        float offset, int R, void* out_pt, void* out_n, void* out_hit,
        void* out_rgb, void* out_dark, void* out_sh_o, void* out_sh_d,
        void* stream) {
    bool textured = tex != nullptr;
    bool shadows = out_dark != nullptr;
    if (rec_width != (textured ? 27 : 21)) return cudaErrorInvalidValue;
    if (textured && (TH <= 0 || TW <= 0)) return cudaErrorInvalidValue;
    if (shadows != (out_sh_o != nullptr) || shadows != (out_sh_d != nullptr))
        return cudaErrorInvalidValue;
    if (R == 0) return cudaSuccess;
    ShadeConsts k = {ambient, lx, ly, lz, lr, lg, lb, px, py, pz, offset};
    ShadeOut out = {(float*)out_pt, (float*)out_n, (unsigned char*)out_hit,
                    (float*)out_rgb, (float*)out_dark, (float*)out_sh_o,
                    (float*)out_sh_d};
    int grid = (R + SHADE_THREADS - 1) / SHADE_THREADS;
    if (textured) {
        shade_hits_kernel<true><<<grid, SHADE_THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const int*)prim,
            (const float*)t, (const float*)u, (const float*)v,
            (const float*)rec, (const float*)tex, TH, TW, k, R, out);
    } else {
        shade_hits_kernel<false><<<grid, SHADE_THREADS, 0,
                                   (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const int*)prim,
            (const float*)t, (const float*)u, (const float*)v,
            (const float*)rec, nullptr, 0, 0, k, R, out);
    }
    return (int)cudaGetLastError();
}
