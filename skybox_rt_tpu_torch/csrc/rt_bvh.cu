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
// Arithmetic: rt_common.cuh (round-to-nearest intrinsics, no fused
// multiply-add, 1/d never inf), shared with rt_clustered.cu.
//
// Bound: operations.  A 1024x1024 primary launch reads 24 bytes and writes 16
// a ray, but does hundreds of triangle tests of ~60 flop each a ray; records
// and AABBs (about 13 MB for 185k triangles) stay in the 50 MB L2.  The
// design is the simple one: one thread a ray, records read as three float4,
// AABB rows as three float2, a small stack in local memory.  Threads of a
// warp diverge where their rays do; rays arrive in 32x32 pixel tiles
// (primary) or sorted by octant and origin (bounces), which keeps a warp's
// walk together.

#include "rt_common.cuh"

#define MAX_LEVELS 8
// the top level is looped over, so at most 7 siblings wait per lower level,
// plus the 8 children pushed last
#define STACK_SIZE (7 * (MAX_LEVELS - 1) + 8)
#define LEVEL_SHIFT 24
#define INDEX_MASK 0xFFFFFF
#define THREADS 128

struct Pyramid {
    int off[MAX_LEVELS];   // first row of level l in the concatenated AABBs
    int cnt[MAX_LEVELS];   // entries of level l
    int num_levels;
};

// Slab test of one (6,) AABB row [min.xyz max.xyz].
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& ray, float far) {
    const float2* b2 = reinterpret_cast<const float2*>(box);
    float2 a = __ldg(b2), b = __ldg(b2 + 1), c = __ldg(b2 + 2);
    // a = (min.x, min.y), b = (min.z, max.x), c = (max.y, max.z)
    return slab_box(a.x, a.y, b.x, b.y, c.x, c.y, ray, far);
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
