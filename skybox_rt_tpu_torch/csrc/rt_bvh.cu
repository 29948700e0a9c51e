// Closest-hit and any-hit ray queries over BVH-treelet blocks, for sm_90a.
//
// Replace the Pallas TPU kernels skybox_rt_tpu/ops/pallas_rt.py
// `_make_bvh_worklist_kernel` (entry `closest_hit_bvh`) and
// `_make_bvh_anyhit_kernel` (entry `any_hit_bvh`).  Those stream every block a
// 2048-ray bundle might touch through VMEM, after a host-side conservative
// prepass has made the bundle's worklist.  Here a ray is one thread and walks
// the hierarchy itself: the pyramid of group AABBs that rt.bvh.build_block_set
// makes (level l+1 group g covers level-l entries 8g..8g+7) is an implicit
// 8-ary tree over the triangle blocks, so there is no prepass, no worklist and
// no ray packing.
//
// The function (ops/cuda_rt.py holds the plain torch version of each):
//   closest: over every triangle of every block whose AABB the ray's slab
//            test enters with far = the ray's running best t, the Möller–
//            Trumbore hit with the lexicographic minimum (t, slot); slot is
//            the triangle's record row (block * tri_block + j).
//   any:     whether any triangle hits with t_min < t < t_max[r]; far is the
//            fixed t_max[r], and the walk returns at the first hit.
//
// Order: children are pushed in descending and popped in ascending order, so
// level-0 blocks are met in ascending block id, the order in which the plain
// version loops over them.  A block the plain version's gate lets in is never
// culled by an ancestor here: the ancestor's box contains the block's, float
// subtraction and multiplication by one fixed factor are monotone, and the
// ancestor was tested against a far that was no smaller.  So kernel and plain
// version test the same triangles against the same running best, and agree
// bit for bit.
//
// Arithmetic: every multiply, add and subtract of the slab and triangle tests
// is a round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which the compiler never contracts into a fused multiply-add; the build's
// -fmad=false -prec-div=true say the same for the rest.  The order of
// operations is that of pallas_rt._mt_one / _slab_embedded, term by term.
// fminf/fmaxf drop a NaN where torch.minimum keeps it: the functions agree
// for finite rays and boxes whose products stay below float32's range (parked
// rays at 3e7 and zero directions included: 1/d is replaced by 1e30, never
// inf, so no 0 * inf arises).
//
// Bound: operations.  A 1024x1024 primary launch reads 24 bytes and writes 16
// a ray, but does hundreds of triangle tests of ~60 flop each a ray; records
// and AABBs (about 13 MB for 185k triangles) stay in the 50 MB L2.  The
// design is the simple one: one thread a ray, records read as three float4,
// AABB rows as three float2, a small stack in local memory.  Threads of a
// warp diverge where their rays do; rays arrive in 32x32 pixel tiles
// (primary) or sorted by octant and origin (bounces), which keeps a warp's
// walk together.

#include <cuda_runtime.h>
#include <math_constants.h>

#define MAX_LEVELS 8
// the top level is looped over, so at most 7 siblings wait per lower level,
// plus the 8 children pushed last
#define STACK_SIZE (7 * (MAX_LEVELS - 1) + 8)
#define LEVEL_SHIFT 24
#define INDEX_MASK 0xFFFFFF
#define MT_EPS 1e-9f
#define THREADS 128

struct Pyramid {
    int off[MAX_LEVELS];   // first row of level l in the concatenated AABBs
    int cnt[MAX_LEVELS];   // entries of level l
    int num_levels;
};

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

// Slab test of one (6,) AABB row [min.xyz max.xyz]: enter when tn <= tf
// (<=, not <: a box the ray meets at exactly far must stay reachable).
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& ray, float far) {
    const float2* b2 = reinterpret_cast<const float2*>(box);
    float2 a = __ldg(b2), b = __ldg(b2 + 1), c = __ldg(b2 + 2);
    // a = (min.x, min.y), b = (min.z, max.x), c = (max.y, max.z)
    float t0x = __fmul_rn(__fsub_rn(a.x, ray.ox), ray.ix);
    float t1x = __fmul_rn(__fsub_rn(b.y, ray.ox), ray.ix);
    float t0y = __fmul_rn(__fsub_rn(a.y, ray.oy), ray.iy);
    float t1y = __fmul_rn(__fsub_rn(c.x, ray.oy), ray.iy);
    float t0z = __fmul_rn(__fsub_rn(b.x, ray.oz), ray.iz);
    float t1z = __fmul_rn(__fsub_rn(c.y, ray.oz), ray.iz);
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), 0.0f));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fminf(fmaxf(t0z, t1z), far));
    return tn <= tf;
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

// One Möller–Trumbore test against record row `slot` (12 floats: v0 e1 e2
// and 3 of padding).  Returns the hit test without the upper bound on t.
__device__ __forceinline__ bool mt_one(const float4* __restrict__ tri,
                                       int slot, const Ray& ray, float t_min,
                                       float& t, float& u, float& v) {
    float4 a = __ldg(tri + 3 * slot);
    float4 b = __ldg(tri + 3 * slot + 1);
    float4 c = __ldg(tri + 3 * slot + 2);
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

// Walks the pyramid for one ray.  `leaf(block)` tests the block's triangles,
// may lower `far`, and returns true to end the walk.
template <typename Leaf>
__device__ __forceinline__ void walk(const float* __restrict__ aabb,
                                     const Pyramid& pyr, const Ray& ray,
                                     const float& far, Leaf leaf) {
    int stack[STACK_SIZE];
    int top = pyr.num_levels - 1;
    int top_cnt = pyr.cnt[top];
    for (int g = 0; g < top_cnt; ++g) {
        int sp = 0;
        stack[sp++] = (top << LEVEL_SHIFT) | g;
        while (sp > 0) {
            int e = stack[--sp];
            int lvl = e >> LEVEL_SHIFT;
            int idx = e & INDEX_MASK;
            if (!slab(aabb + 6 * (size_t)(pyr.off[lvl] + idx), ray, far))
                continue;
            if (lvl == 0) {
                if (leaf(idx)) return;
            } else {
                int c0 = idx * 8;
                int c1 = min(c0 + 8, pyr.cnt[lvl - 1]);
                for (int c = c1 - 1; c >= c0; --c)
                    stack[sp++] = ((lvl - 1) << LEVEL_SHIFT) | c;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
closest_hit_bvh_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmax,      // (R,) or null
                       const float4* __restrict__ tri,      // (C*TB, 3) float4
                       const int* __restrict__ bcnt,        // (C,)
                       const int* __restrict__ s2p,         // (C*TB,)
                       const float* __restrict__ aabb,      // (sum C_l, 6)
                       Pyramid pyr, int tri_block, float t_min, int R,
                       int* __restrict__ out_prim, float* __restrict__ out_t,
                       float* __restrict__ out_u, float* __restrict__ out_v) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Ray ray = load_ray(o, d, r);
    float tmax0 = tmax ? tmax[r] : CUDART_INF_F;
    float best_t = tmax0, best_u = 0.0f, best_v = 0.0f;
    int best_s = -1;
    walk(aabb, pyr, ray, best_t, [&](int b) {
        int base = b * tri_block;
        int n = __ldg(bcnt + b);
        for (int j = 0; j < n; ++j) {
            int slot = base + j;
            float t, u, v;
            bool hit = mt_one(tri, slot, ray, t_min, t, u, v) && t < tmax0;
            // lexicographic (t, slot) minimum: independent of the order in
            // which blocks are met
            if (hit && (t < best_t || (t == best_t && slot < best_s))) {
                best_t = t;
                best_s = slot;
                best_u = u;
                best_v = v;
            }
        }
        return false;
    });
    bool miss = best_s < 0;
    out_prim[r] = miss ? -1 : __ldg(s2p + best_s);
    out_t[r] = miss ? CUDART_INF_F : best_t;
    out_u[r] = miss ? 0.0f : best_u;
    out_v[r] = miss ? 0.0f : best_v;
}

__global__ void __launch_bounds__(THREADS)
any_hit_bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmax,          // (R,)
                   const float4* __restrict__ tri,
                   const int* __restrict__ bcnt,
                   const float* __restrict__ aabb, Pyramid pyr, int tri_block,
                   float t_min, int R,
                   unsigned char* __restrict__ out_occ) {   // (R,) bool
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Ray ray = load_ray(o, d, r);
    float far = tmax[r];
    bool occluded = false;
    walk(aabb, pyr, ray, far, [&](int b) {
        int base = b * tri_block;
        int n = __ldg(bcnt + b);
        for (int j = 0; j < n; ++j) {
            float t, u, v;
            if (mt_one(tri, base + j, ray, t_min, t, u, v) && t < far) {
                occluded = true;
                return true;
            }
        }
        return false;
    });
    out_occ[r] = occluded ? 1 : 0;
}

static int fill_pyramid(Pyramid& pyr, const int* level_off,
                        const int* level_cnt, int num_levels) {
    if (num_levels < 1 || num_levels > MAX_LEVELS)
        return cudaErrorInvalidValue;
    for (int l = 0; l < num_levels; ++l) {
        if (level_cnt[l] > INDEX_MASK + 1) return cudaErrorInvalidValue;
        pyr.off[l] = level_off[l];
        pyr.cnt[l] = level_cnt[l];
    }
    pyr.num_levels = num_levels;
    return cudaSuccess;
}

// level_off / level_cnt are host arrays of num_levels ints.  Returns the
// launch's cudaError_t (0 = launched); never synchronizes.
extern "C" int skybox_rt_closest_hit_bvh(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* bcnt, const void* s2p, const void* aabb,
        const int* level_off, const int* level_cnt, int num_levels,
        int tri_block, float t_min, int R, void* out_prim, void* out_t,
        void* out_u, void* out_v, void* stream) {
    Pyramid pyr;
    int rc = fill_pyramid(pyr, level_off, level_cnt, num_levels);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + THREADS - 1) / THREADS;
    closest_hit_bvh_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const int*)bcnt, (const int*)s2p,
        (const float*)aabb, pyr, tri_block, t_min, R, (int*)out_prim,
        (float*)out_t, (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_any_hit_bvh(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* bcnt, const void* aabb, const int* level_off,
        const int* level_cnt, int num_levels, int tri_block, float t_min,
        int R, void* out_occ, void* stream) {
    Pyramid pyr;
    int rc = fill_pyramid(pyr, level_off, level_cnt, num_levels);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + THREADS - 1) / THREADS;
    any_hit_bvh_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const int*)bcnt, (const float*)aabb, pyr,
        tri_block, t_min, R, (unsigned char*)out_occ);
    return (int)cudaGetLastError();
}
