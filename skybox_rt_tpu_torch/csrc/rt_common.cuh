// Device functions shared by the ray-query kernels (rt_bvh.cu,
// rt_clustered.cu, rt_streamed.cu): the ray, the slab test and one
// Möller–Trumbore test.
//
// Arithmetic: every multiply, add and subtract of the slab and triangle tests
// is a round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which the compiler never contracts into a fused multiply-add; the build's
// -fmad=false -prec-div=true say the same for the rest.  The order of
// operations is that of pallas_rt._mt_one / _slab, term by term, and of the
// plain torch versions in ops/cuda_rt.py, so kernel and plain version agree
// bit for bit.  fminf/fmaxf drop a NaN where torch.minimum keeps it: the
// functions agree for finite rays and boxes whose products stay below
// float32's range (parked rays at 3e7 and zero directions included: 1/d is
// replaced by 1e30, never inf, so no 0 * inf arises).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define MT_EPS 1e-9f

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float d) {
    return fabsf(d) > 1e-12f ? __fdiv_rn(1.0f, d) : 1e30f;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int r) {
    Ray ray;
    ray.ox = o[3 * r + 0];
    ray.oy = o[3 * r + 1];
    ray.oz = o[3 * r + 2];
    ray.dx = d[3 * r + 0];
    ray.dy = d[3 * r + 1];
    ray.dz = d[3 * r + 2];
    ray.ix = inv_dir(ray.dx);
    ray.iy = inv_dir(ray.dy);
    ray.iz = inv_dir(ray.dz);
    return ray;
}

// Slab test of the box [lo, hi]: enter when tn <= tf (<=, not <: a box the
// ray meets at exactly far must stay reachable).
__device__ __forceinline__ bool slab_box(float lox, float loy, float loz,
                                         float hix, float hiy, float hiz,
                                         const Ray& ray, float far) {
    float t0x = __fmul_rn(__fsub_rn(lox, ray.ox), ray.ix);
    float t1x = __fmul_rn(__fsub_rn(hix, ray.ox), ray.ix);
    float t0y = __fmul_rn(__fsub_rn(loy, ray.oy), ray.iy);
    float t1y = __fmul_rn(__fsub_rn(hiy, ray.oy), ray.iy);
    float t0z = __fmul_rn(__fsub_rn(loz, ray.oz), ray.iz);
    float t1z = __fmul_rn(__fsub_rn(hiz, ray.oz), ray.iz);
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), 0.0f));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fminf(fmaxf(t0z, t1z), far));
    return tn <= tf;
}

// Slab test of one (6,) AABB row [min.xyz max.xyz] in global memory.
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& ray, float far) {
    const float2* b2 = reinterpret_cast<const float2*>(box);
    float2 a = __ldg(b2), b = __ldg(b2 + 1), c = __ldg(b2 + 2);
    // a = (min.x, min.y), b = (min.z, max.x), c = (max.y, max.z)
    return slab_box(a.x, a.y, b.x, b.y, c.x, c.y, ray, far);
}

// a*b + c*d + e*f, left to right, each step rounded
__device__ __forceinline__ float dot3(float a, float b, float c, float d,
                                      float e, float f) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d)),
                     __fmul_rn(e, f));
}

// a*b - c*d, each step rounded
__device__ __forceinline__ float det2(float a, float b, float c, float d) {
    return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// One Möller–Trumbore test against the record (a, b, c): 12 floats, v0 e1 e2
// and 3 of padding.  Returns the hit test without the upper bound on t.
__device__ __forceinline__ bool mt_record(float4 a, float4 b, float4 c,
                                          const Ray& ray, float t_min,
                                          float& t, float& u, float& v) {
    float v0x = a.x, v0y = a.y, v0z = a.z;
    float e1x = a.w, e1y = b.x, e1z = b.y;
    float e2x = b.z, e2y = b.w, e2z = c.x;
    float pvx = det2(ray.dy, e2z, ray.dz, e2y);
    float pvy = det2(ray.dz, e2x, ray.dx, e2z);
    float pvz = det2(ray.dx, e2y, ray.dy, e2x);
    float det = dot3(e1x, pvx, e1y, pvy, e1z, pvz);
    bool valid = fabsf(det) > MT_EPS;
    float inv_det = valid ? __fdiv_rn(1.0f, det) : 0.0f;
    float tvx = __fsub_rn(ray.ox, v0x);
    float tvy = __fsub_rn(ray.oy, v0y);
    float tvz = __fsub_rn(ray.oz, v0z);
    u = __fmul_rn(dot3(tvx, pvx, tvy, pvy, tvz, pvz), inv_det);
    float qvx = det2(tvy, e1z, tvz, e1y);
    float qvy = det2(tvz, e1x, tvx, e1z);
    float qvz = det2(tvx, e1y, tvy, e1x);
    v = __fmul_rn(dot3(ray.dx, qvx, ray.dy, qvy, ray.dz, qvz), inv_det);
    t = __fmul_rn(dot3(e2x, qvx, e2y, qvy, e2z, qvz), inv_det);
    return valid && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f
        && t > t_min;
}

// The same against record row `slot` of a (rows, 3) float4 array in global
// memory.
__device__ __forceinline__ bool mt_one(const float4* __restrict__ tri,
                                       int slot, const Ray& ray, float t_min,
                                       float& t, float& u, float& v) {
    return mt_record(__ldg(tri + 3 * slot), __ldg(tri + 3 * slot + 1),
                     __ldg(tri + 3 * slot + 2), ray, t_min, t, u, v);
}
