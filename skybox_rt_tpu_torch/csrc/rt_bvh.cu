// Closest-hit, next-hit-after and any-hit ray queries over BVH-treelet blocks,
// for sm_90a.
//
// Replace the Pallas TPU kernels of skybox_rt_tpu/ops/pallas_rt.py:
//   #2 closest_hit_bvh        `_make_bvh_worklist_kernel` (pallas_rt.py:1102)
//   #6 closest_hit_bvh_after  `_make_bvh_after_kernel` (pallas_rt.py:1323,
//                             with the prepass `bvh_worklists`)
//   #3 any_hit_bvh            `_make_bvh_anyhit_kernel` (pallas_rt.py:1528)
// Those stream every block a 2048-ray bundle might touch through VMEM, after
// a host-side conservative prepass has made the bundle's worklist.  Here a
// ray is one thread and walks the hierarchy itself: the pyramid of group
// AABBs that rt.bvh.build_block_set makes (level l+1 group g covers level-l
// entries 8g..8g+7) is an implicit 8-ary tree over the triangle blocks, so
// there is no prepass, no worklist and no ray packing.
//
// The functions (ops/cuda_rt.py holds the plain torch version of each):
//   closest: over every triangle of every leaf whose AABB the ray's slab
//            test enters with far = the ray's running best t, the Möller–
//            Trumbore hit with the lexicographic minimum (t, slot); slot is
//            the triangle's record row (block * tri_block + j).  The leaves
//            are rt.bvh.build_block_leaves': each block's BVH subtree cut
//            into sub-treelets of at most rt.tracer.BVH_LEAF_TRIS triangles,
//            a contiguous ascending range of the block's slots with its BVH
//            node's box.
//   after:   the same minimum over the hits strictly after a per-ray carry,
//            (t_lo[r], slot_lo[r]) < (t, slot) in lexicographic order.  Walks
//            that feed (t, slot) back list every hit of a ray once, equal t
//            included; a miss returns t = +inf, which ends the list.  The
//            slab gate's far bound is still the running best t and admits
//            equality (a later leaf may hold a hit of equal t and lower
//            slot).  t_lo never tightens the gate: a box's rounded exit can
//            fall below a hit's t, so a near bound could drop a fragment.
//   any:     whether a triangle hits with t_min < t < t_max[r] inside a
//            leaf whose AABB the slab test enters with far = the fixed
//            t_max[r]; the walk ends at the first such hit.
//
// Order.  The walks visit the pyramid in preorder with the children in
// ascending order, so level-0 blocks are met in ascending block id and a
// block's leaves in ascending order: the order in which the plain versions
// loop over them.  A leaf the plain version's gate lets in is never culled
// by an ancestor here (its block or a group above it): the ancestor's box
// contains the leaf's (both are min / max over sets of the same vertex
// floats, the leaf's set a subset), float subtraction and multiplication by
// one fixed factor are monotone, and the ancestor was tested against a far
// that was no smaller (the running best only falls).  So kernel and plain
// version test the same triangles against the same running best, and agree
// bit for bit.  The any-hit query's far never changes, so its answer is the
// OR over the leaves its gate lets in and does not depend on the order at
// all; the order only decides where a ray stops.
//
// Arithmetic: rt_common.cuh (round-to-nearest intrinsics, no fused
// multiply-add, 1/d never inf), shared with rt_clustered.cu and
// rt_streamed.cu.
//
// Bound: operations.  A 1024x1024 primary launch reads 24 bytes and writes
// 16 a ray (the any hit 28 and 1), but does tens of triangle tests of ~53
// operations each a ray (one an IEEE division) and slab tests of ~25;
// records, leaves and AABBs (about 14 MB for 185k triangles) stay in the
// 50 MB L2.  What the design does about it:
//   * fewer tests: an entered block (256 triangles in the large scene's, 64
//     in a config-3 draw's) is not tested whole.  Its leaves are slab-tested
//     (against the running best, or the any hit's t_max), and only the
//     triangles of the leaves that pass are tested.  A reflected or shadow
//     ray starts 1e-3 off a surface, inside its own sphere's blocks, so the
//     bounce and shadow launches gain most.
//   * #6's exact early exit: a ray whose carry t_lo is +inf has ended its
//     list.  It admits no hit, because a hit has t < t_max <= +inf, so
//     (t_lo, slot_lo) < (t, slot) never holds.  It returns a miss without a
//     walk, where it used to walk with far = +inf through every block its
//     line crosses.  The plain version gives the same bits with or without
//     the exit.  A warp runs as long as its longest ray, so the CTA packs
//     its live rays, in ascending order, into its first threads: the warps
//     past them end at once.
//   * no such exit for #3: answering the rays that miss the union of the
//     top level's boxes (exact: it is an ancestor of every leaf) at once and
//     packing the rest as #6 does tied on the primary shadow launch and
//     lost about a fifth on the bounce-shadow launches (PERF.md §6), so
//     a parked shadow ray walks the top level and ends there.
//   * the pyramid in shared memory: a CTA of WALK_THREADS rays stages the
//     pyramid's rows once (every level whose rows fit STAGE_ROWS with those
//     above it: the whole pyramid of the scenes here) and reads its boxes
//     from there.  (Resident CTAs whose warps took 32 rays at a time from a
//     device counter were measured against this grid on the bounce launches
//     and lost: PERF.md, PR 8.)
//   * no stack: the pyramid is implicit, so the walk's next entry follows
//     from (level, index) alone (first child 8i; past the last sibling, up
//     to the parent), and nothing is kept in local memory.
// The walk order stays ascending: a near-to-far order would need a plain
// version that follows it, as rt_clustered.cu's octant visit table does.

#include "rt_common.cuh"

#define MAX_LEVELS 8
// most entries of one pyramid level: 8 times a level's index stays far
// inside an int (ops/cuda_rt.py MAX_LEVEL_ENTRIES)
#define MAX_LEVEL_ENTRIES (1 << 24)
// threads (and rays) of a CTA, and the pyramid rows a CTA stages in shared
// memory: 48 KB, the most a CTA takes without opting in, at 24 bytes a row
#define WALK_THREADS 256
#define STAGE_ROWS 2048

enum Query { kClosest, kAfter, kAny };

struct Pyramid {
    int off[MAX_LEVELS];   // first row of level l in the concatenated AABBs
    int cnt[MAX_LEVELS];   // entries of level l
    int num_levels;
};

// The walks' operands; tlo, slo and out_slot are the after query's, out_occ
// the any hit's (which writes none of out_prim .. out_v).
struct WalkArgs {
    const float* o;
    const float* d;
    const float* tmax;          // (R,) or null (the any hit: (R,))
    const float* tlo;           // (R,)
    const int* slo;             // (R,)
    const float4* tri;          // (C*TB, 3) float4
    const int* s2p;             // (C*TB,)
    const float* aabb;          // (sum C_l, 6)
    const int* leaf_range;      // (C + 1,)
    const float4* leaf_table;   // (L, 2) float4: box, first slot, count
    float t_min;
    int R;
    int* out_slot;
    int* out_prim;
    float* out_t;
    float* out_u;
    float* out_v;
    unsigned char* out_occ;     // (R,) bool
};

// Slab test of AABB row `row`: from shared memory where the row was staged
// (row >= row0: the levels are concatenated from level 0 up), else from L2.
__device__ __forceinline__ bool slab_row(const float2* s_rows,
                                         const float* __restrict__ aabb,
                                         int row, int row0, const Ray& ray,
                                         float far) {
    if (row >= row0) {
        const float2* b2 = s_rows + 3 * (row - row0);
        float2 a = b2[0], b = b2[1], c = b2[2];
        return slab_box(a.x, a.y, b.x, b.y, c.x, c.y, ray, far);
    }
    return slab(aabb + 6 * (size_t)row, ray, far);
}

// The after query's miss (slot, prim, t, u, v) = (-1, -1, +inf, 0, 0) of
// ray r.
__device__ __forceinline__ void write_miss(const WalkArgs& a, int r) {
    a.out_slot[r] = -1;
    a.out_prim[r] = -1;
    a.out_t[r] = CUDART_INF_F;
    a.out_u[r] = 0.0f;
    a.out_v[r] = 0.0f;
}

// One ray of the query kQ.
template <int kQ>
__device__ __forceinline__ void walk_ray(const WalkArgs& a, int r,
                                         const float2* s_rows, int row0,
                                         const int* s_off, const int* s_cnt,
                                         int top) {
    float t_lo = kQ == kAfter ? a.tlo[r] : 0.0f;
    int s_lo = kQ == kAfter ? a.slo[r] : 0;
    Ray ray = load_ray(a.o, a.d, r);
    float tmax0 = a.tmax ? a.tmax[r] : CUDART_INF_F;
    // the gates' far bound: the running best, which the any hit never lowers
    float best_t = tmax0, best_u = 0.0f, best_v = 0.0f;
    int best_s = -1;
    int l = top, i = 0;
    for (bool more = s_cnt[top] > 0; more;) {
        bool pass = slab_row(s_rows, a.aabb, s_off[l] + i, row0, ray, best_t);
        if (pass && l > 0) {            // first child
            --l;
            i <<= 3;
            continue;
        }
        if (pass) {                     // block i: its leaves, ascending
            int k1 = __ldg(a.leaf_range + i + 1);
            for (int k = __ldg(a.leaf_range + i); k < k1; ++k) {
                float4 lo = __ldg(a.leaf_table + 2 * k);
                float4 hi = __ldg(a.leaf_table + 2 * k + 1);
                // lo = (min.xyz, max.x), hi = (max.y, max.z, first, count)
                if (!slab_box(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, ray,
                              best_t))
                    continue;
                int s0 = __float_as_int(hi.z);
                int s1 = s0 + __float_as_int(hi.w);
                for (int s = s0; s < s1; ++s) {
                    float t, u, v;
                    bool hit = mt_one(a.tri, s, ray, a.t_min, t, u, v)
                        && t < tmax0;
                    if constexpr (kQ == kAny) {
                        if (hit) {              // the first hit ends the walk
                            a.out_occ[r] = 1;
                            return;
                        }
                        continue;
                    }
                    // (t_lo, s_lo) < (t, s), lexicographic
                    if (kQ == kAfter)
                        hit = hit && (t > t_lo || (t == t_lo && s > s_lo));
                    // lexicographic (t, slot) minimum: independent of the
                    // order in which leaves are met
                    if (hit && (t < best_t || (t == best_t && s < best_s))) {
                        best_t = t;
                        best_s = s;
                        best_u = u;
                        best_v = v;
                    }
                }
            }
        }
        // next in preorder: past a last sibling, up to the parent
        while (l < top && ((i & 7) == 7 || i == s_cnt[l] - 1)) {
            i >>= 3;
            ++l;
        }
        more = ++i < s_cnt[l];          // false only at the top level
    }
    if constexpr (kQ == kAny) {
        a.out_occ[r] = 0;
    } else {
        bool miss = best_s < 0;
        if (kQ == kAfter) a.out_slot[r] = best_s;
        a.out_prim[r] = miss ? -1 : __ldg(a.s2p + best_s);
        a.out_t[r] = miss ? CUDART_INF_F : best_t;
        a.out_u[r] = miss ? 0.0f : best_u;
        a.out_v[r] = miss ? 0.0f : best_v;
    }
}

// One CTA a WALK_THREADS consecutive rays.  Stages pyramid rows row0 ..
// row0 + rows - 1 (dynamic shared memory, 24 bytes a row); the after query
// answers its ended rays at once and packs the rest into its first threads.
template <int kQ>
__global__ void __launch_bounds__(WALK_THREADS)
bvh_walk_kernel(WalkArgs a, Pyramid pyr, int row0, int rows) {
    extern __shared__ float2 s_rows[];
    __shared__ int s_off[MAX_LEVELS], s_cnt[MAX_LEVELS];
    __shared__ int s_warp_live[WALK_THREADS / 32];
    __shared__ int s_live[WALK_THREADS];
    for (int k = threadIdx.x; k < 3 * rows; k += WALK_THREADS)
        s_rows[k] = reinterpret_cast<const float2*>(a.aabb)[3 * row0 + k];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int l = 0; l < MAX_LEVELS; ++l) {
            s_off[l] = pyr.off[l];
            s_cnt[l] = pyr.cnt[l];
        }
    }
    const int top = pyr.num_levels - 1;
    int r = blockIdx.x * WALK_THREADS + threadIdx.x;
    if (kQ != kAfter) {
        __syncthreads();
        if (r < a.R) walk_ray<kQ>(a, r, s_rows, row0, s_off, s_cnt, top);
        return;
    }
    bool live = r < a.R && a.tlo[r] != CUDART_INF_F;
    if (r < a.R && !live) write_miss(a, r);     // the list has ended: exact
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < WALK_THREADS / 32; ++w) {
        before += w < warp ? s_warp_live[w] : 0;
        n += s_warp_live[w];
    }
    if (live) s_live[before + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
    if (threadIdx.x < n)
        walk_ray<kAfter>(a, s_live[threadIdx.x], s_rows, row0, s_off, s_cnt,
                         top);
}

// level_off / level_cnt are host arrays of num_levels ints.  Every entry
// returns the launch's cudaError_t (0 = launched) and never synchronizes.
template <int kQ>
static int launch_walk(WalkArgs a, const int* level_off,
                       const int* level_cnt, int num_levels,
                       cudaStream_t stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS)
        return cudaErrorInvalidValue;
    Pyramid pyr = {};
    for (int l = 0; l < num_levels; ++l) {
        if (level_cnt[l] < 0 || level_cnt[l] > MAX_LEVEL_ENTRIES)
            return cudaErrorInvalidValue;
        pyr.off[l] = level_off[l];
        pyr.cnt[l] = level_cnt[l];
    }
    pyr.num_levels = num_levels;
    if (a.R == 0) return cudaSuccess;
    // stage the lowest level whose rows fit STAGE_ROWS with those above it
    int total = pyr.off[num_levels - 1] + pyr.cnt[num_levels - 1];
    int row0 = total;
    for (int l = num_levels - 1; l >= 0 && total - pyr.off[l] <= STAGE_ROWS;
         --l)
        row0 = pyr.off[l];
    size_t smem = (size_t)(total - row0) * 6 * sizeof(float);
    int grid = (a.R + WALK_THREADS - 1) / WALK_THREADS;
    bvh_walk_kernel<kQ><<<grid, WALK_THREADS, smem, stream>>>(
        a, pyr, row0, total - row0);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_closest_hit_bvh(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* s2p, const void* aabb, const void* leaf_range,
        const void* leaf_table, const int* level_off, const int* level_cnt,
        int num_levels, float t_min, int R, void* out_prim, void* out_t,
        void* out_u, void* out_v, void* stream) {
    WalkArgs a = {(const float*)o, (const float*)d, (const float*)tmax,
                  nullptr, nullptr, (const float4*)tri, (const int*)s2p,
                  (const float*)aabb, (const int*)leaf_range,
                  (const float4*)leaf_table, t_min, R, nullptr,
                  (int*)out_prim, (float*)out_t, (float*)out_u,
                  (float*)out_v, nullptr};
    return launch_walk<kClosest>(a, level_off, level_cnt, num_levels,
                                 (cudaStream_t)stream);
}

extern "C" int skybox_rt_closest_hit_bvh_after(
        const void* o, const void* d, const void* tmax, const void* tlo,
        const void* slo, const void* tri, const void* s2p, const void* aabb,
        const void* leaf_range, const void* leaf_table,
        const int* level_off, const int* level_cnt, int num_levels,
        float t_min, int R, void* out_slot, void* out_prim, void* out_t,
        void* out_u, void* out_v, void* stream) {
    WalkArgs a = {(const float*)o, (const float*)d, (const float*)tmax,
                  (const float*)tlo, (const int*)slo, (const float4*)tri,
                  (const int*)s2p, (const float*)aabb, (const int*)leaf_range,
                  (const float4*)leaf_table, t_min, R, (int*)out_slot,
                  (int*)out_prim, (float*)out_t, (float*)out_u,
                  (float*)out_v, nullptr};
    return launch_walk<kAfter>(a, level_off, level_cnt, num_levels,
                               (cudaStream_t)stream);
}

extern "C" int skybox_rt_any_hit_bvh(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* aabb, const void* leaf_range, const void* leaf_table,
        const int* level_off, const int* level_cnt, int num_levels,
        float t_min, int R, void* out_occ, void* stream) {
    if (tmax == nullptr) return cudaErrorInvalidValue;
    WalkArgs a = {(const float*)o, (const float*)d, (const float*)tmax,
                  nullptr, nullptr, (const float4*)tri, nullptr,
                  (const float*)aabb, (const int*)leaf_range,
                  (const float4*)leaf_table, t_min, R, nullptr, nullptr,
                  nullptr, nullptr, nullptr, (unsigned char*)out_occ};
    return launch_walk<kAny>(a, level_off, level_cnt, num_levels,
                             (cudaStream_t)stream);
}
