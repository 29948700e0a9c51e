// Ray queries for small scenes (at most a few ten thousand triangles), for
// sm_90a: closest hit and any hit over BVH-treelet clusters, and the flat
// closest hit over all triangles.
//
// Replace the Pallas TPU kernels of skybox_rt_tpu/ops/pallas_rt.py
//   `_make_clustered_kernel`        (entry `closest_hit_clustered`),
//   `_make_clustered_anyhit_kernel` (entry `any_hit_clustered`),
//   `_make_kernel`                  (entries `closest_hit_pallas`,
//                                    `any_hit_pallas`).
// Those hold 1,024 rays as one (8, 128) tile a grid program, splat one
// triangle a step against the tile, gate a cluster for the whole tile when any
// of its rays passes the slab test, and visit clusters in the order of the
// tile's dominant direction octant.  Here a ray is one thread: it gates each
// cluster for itself and takes the visit order of its own octant.
//
// The functions (ops/cuda_rt.py holds the plain torch version of each):
//   clustered closest: clusters are rt.bvh.build_clusters ranges
//            [first, first + count) of the records in treelet order, cut
//            into groups of CLUSTER_GROUP consecutive clusters (ops/cuda_rt.py
//            cluster_groups: a group's box is the float32 min / max of its
//            clusters' boxes).  A ray meets the groups in the order of row
//            `octant` of the (8, G) group visit table (near to far along its
//            octant's sign vector), and inside a group the group's clusters
//            in the same octant's near-to-far order: the row of the (8, C)
//            visit table, which lists the clusters group by group.  A group,
//            and then a cluster of it, is entered when the slab test passes
//            with far = the ray's running best t; over the triangles of the
//            entered clusters, the Möller–Trumbore hit with the lexicographic
//            minimum (t, slot), slot = the record's row; the prim returned is
//            order[slot].
//   clustered any: whether any triangle hits with t_min < t < t_max[r]: the
//            same two-level walk with far the fixed t_max[r], so the answer
//            does not depend on the visit order; the ray returns at its
//            first hit.
//   flat closest: every triangle in ascending prim id under strict t <
//            best t, so the lowest id wins equal t (the brute-force oracle).
//
// Exactness: the plain versions make the same per-ray decisions in the same
// per-ray order with the same far bound (ops/cuda_rt.py), and the arithmetic
// is rt_common.cuh's, so kernel and plain version agree bit for bit.  The
// group gate culls no cluster that the cluster's own gate lets in: the
// group's box contains the cluster's (min / max over the same floats),
// subtraction and multiplication by one factor are monotone, and the group
// was tested against a far no smaller than the cluster's (the running best
// only falls; the any hit's far is fixed).
//
// Bound: operations.  A 1024x1024 launch reads 24 bytes and writes 16 a ray
// (the any hit: 28 and 1); a clustered ray does slab tests of 25 flop and
// some ten triangle tests of 53, a flat ray P triangle tests.  The records
// of a 12,032-triangle scene are 578 KB and stay in L2.  The design:
//   * clustered closest and any: one walk, clustered_kernel<kAny>.  The
//     group level takes a ray's slab tests from C (302 on the small scene)
//     to G plus CLUSTER_GROUP for each group entered (the any hit's
//     primary shadow rays: 298 to about 32); the group table (G x 8
//     words), the cluster table (C x 8), and the (8, G) and (8, C) visit
//     tables are staged in shared memory while they fit in 48 KB (C + G <=
//     768) and read from global memory otherwise; threads of a warp with
//     one octant read the same table entries (a broadcast); records are
//     read as three float4 through the read-only cache.
//   * flat: a thread a ray; every thread of a block tests the same record
//     at each step, so a block stages records through shared memory 256 at
//     a time.  A test is issue-bound (53 flop and an IEEE reciprocal, no
//     FMA), so the kernel cuts the work whose outcome is already fixed and
//     keeps every operation that decides a result bit for bit mt_record's:
//       - when every ray of the block has the same origin, bit for bit
//         (__syncthreads_and; the camera's primary rays), tv = o - v0,
//         qv = tv x e1 and t_num = e2 . qv depend on the record alone: the
//         staging threads compute them once a record, with mt_record's
//         intrinsics in its order, and stage them beside e1 and e2 (a block
//         whose rays differ in origin, bounce rays, takes the general path,
//         which computes them a test);
//       - |det| <= MT_EPS cannot hit: the test stops after det;
//       - t = RN(t_num * RN(1 / det)).  For finite |det| > MT_EPS, 1 / det
//         lies within (2.9e-39, 1e9) in magnitude, so RN(1 / det) is
//         finite, nonzero (float32's subnormals go down to 1.4e-45, and
//         nothing is flushed) and of det's sign; the product of t_num with
//         it has the sign of t_num * det, and rounding keeps a sign (a
//         negative product rounds to a negative float or to -0); an
//         infinite det gives t = +-0 or NaN.  So when t_num is 0, NaN, or of
//         the sign opposite to det's, t <= 0 or t is NaN, and t > t_min
//         fails whenever t_min >= 0: the test stops before the reciprocal.
//         With t_min < 0 this cut is off;
//       - u is mt_record's u; u >= 0 failing decides the test, so v and t
//         are not computed then.  (No sign cut on u's numerator: a negative
//         product can round to -0, which passes u >= 0.)
//     Two rays a thread, each staged record read once for both, was
//     measured and lost (PERF.md): too few blocks on short launches.

#include "rt_common.cuh"

#define THREADS 128
#define FLAT_CHUNK 256
// bytes of shared memory a cluster (or a group) takes when staged: 8 table
// words and one entry in each of the 8 visit rows
#define STAGED_BYTES_PER_CLUSTER 64
#define MAX_STAGED_BYTES (48 * 1024)

__device__ __forceinline__ int octant_of(const Ray& ray) {
    return (ray.dx > 0.0f ? 1 : 0) | (ray.dy > 0.0f ? 2 : 0)
        | (ray.dz > 0.0f ? 4 : 0);
}

// The tables the clustered kernels read: staged into the block's shared
// memory when `staged`, else left in global memory.
struct ClusterTables {
    const float4* table;   // (C, 2): (min.xyz, max.x), (max.yz, first, count)
    const int* visit;      // (8, C)
    const float4* gtable;  // (G, 2): the same for a group of clusters
    const int* gvisit;     // (8, G)
};

// Every thread of the block calls this, before any returns.
__device__ __forceinline__ ClusterTables stage_tables(ClusterTables tabs,
                                                      int C, int G,
                                                      int staged,
                                                      float4* smem) {
    if (staged) {
        float4* gtable = smem + 2 * C;
        int* visit = reinterpret_cast<int*>(smem + 2 * (C + G));
        int* gvisit = visit + 8 * C;
        for (int i = threadIdx.x; i < 2 * C; i += blockDim.x)
            smem[i] = __ldg(tabs.table + i);
        for (int i = threadIdx.x; i < 2 * G; i += blockDim.x)
            gtable[i] = __ldg(tabs.gtable + i);
        for (int i = threadIdx.x; i < 8 * C; i += blockDim.x)
            visit[i] = __ldg(tabs.visit + i);
        for (int i = threadIdx.x; i < 8 * G; i += blockDim.x)
            gvisit[i] = __ldg(tabs.gvisit + i);
        __syncthreads();
        tabs = {smem, visit, gtable, gvisit};
    }
    return tabs;
}

// The clustered walk: the closest hit (kAny false: prim, t, u, v, far = the
// running best t) or the any hit (kAny true: one occlusion byte, far = the
// fixed t_max[r], the ray returns at its first hit).
template <bool kAny>
__global__ void __launch_bounds__(THREADS)
clustered_kernel(const float* __restrict__ o,
                 const float* __restrict__ d,
                 const float* __restrict__ tmax,   // (R,); closest: or null
                 const float4* __restrict__ tri,   // (P, 3) float4
                 ClusterTables tabs,
                 const int* __restrict__ order,    // (P,); any: null
                 int C, int G, int staged, float t_min, int R,
                 int* __restrict__ out_prim,
                 float* __restrict__ out_t,
                 float* __restrict__ out_u,
                 float* __restrict__ out_v,
                 unsigned char* __restrict__ out_occ) {  // (R,) bool
    extern __shared__ float4 smem[];
    tabs = stage_tables(tabs, C, G, staged, smem);
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Ray ray = load_ray(o, d, r);
    float tmax0 = tmax ? tmax[r] : CUDART_INF_F;
    // best_t is every slab test's far; the any hit never lowers it
    float best_t = tmax0, best_u = 0.0f, best_v = 0.0f;
    int best_s = -1;
    const int q = octant_of(ray);
    const int* grow = tabs.gvisit + q * G;
    const int* row = tabs.visit + q * C;
    // the group's clusters are row[pos .. pos + size): pos runs over the
    // sizes of the groups met so far, entered or not
    for (int k = 0, pos = 0; k < G; ++k) {
        int g = grow[k];
        float4 glo = tabs.gtable[2 * g], ghi = tabs.gtable[2 * g + 1];
        int end = pos + __float_as_int(ghi.w);
        if (!slab_box(glo.x, glo.y, glo.z, glo.w, ghi.x, ghi.y, ray,
                      best_t)) {
            pos = end;
            continue;
        }
        for (; pos < end; ++pos) {
            int c = row[pos];
            float4 lo = tabs.table[2 * c], hi = tabs.table[2 * c + 1];
            if (!slab_box(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, ray, best_t))
                continue;
            int first = __float_as_int(hi.z);
            int last = first + __float_as_int(hi.w);
            for (int slot = first; slot < last; ++slot) {
                float t, u, v;
                bool hit = mt_one(tri, slot, ray, t_min, t, u, v)
                    && t < tmax0;
                if constexpr (kAny) {
                    if (hit) {
                        out_occ[r] = 1;
                        return;
                    }
                } else if (hit && (t < best_t
                                   || (t == best_t && slot < best_s))) {
                    // lexicographic (t, slot) minimum
                    best_t = t;
                    best_s = slot;
                    best_u = u;
                    best_v = v;
                }
            }
        }
    }
    if constexpr (kAny) {
        out_occ[r] = 0;
    } else {
        bool miss = best_s < 0;
        out_prim[r] = miss ? -1 : __ldg(order + best_s);
        out_t[r] = miss ? CUDART_INF_F : best_t;
        out_u[r] = miss ? 0.0f : best_u;
        out_v[r] = miss ? 0.0f : best_v;
    }
}

// Whether a test whose |det| > MT_EPS can still hit, from the signs of
// t_num and det (the design note's t-sign cut; `cut` is t_min >= 0).
__device__ __forceinline__ bool t_may_pass(float t_num, float det, bool cut) {
    return !cut || (t_num > 0.0f && det > 0.0f)
        || (t_num < 0.0f && det < 0.0f);
}

// The rest of a flat test once det (|det| > MT_EPS) and t_num are known:
// mt_record's reciprocal, u, v and t, u's test first; a hit with t below the
// ray's best (strict: the lowest prim wins equal t) becomes its best.
__device__ __forceinline__ void flat_finish(
        float det, float t_num, float pvx, float pvy, float pvz, float tvx,
        float tvy, float tvz, float qvx, float qvy, float qvz,
        const Ray& ray, float t_min, int prim, float& best_t, int& best_p,
        float& best_u, float& best_v) {
    float inv_det = __fdiv_rn(1.0f, det);
    float u = __fmul_rn(dot3(tvx, pvx, tvy, pvy, tvz, pvz), inv_det);
    if (!(u >= 0.0f)) return;
    float v = __fmul_rn(dot3(ray.dx, qvx, ray.dy, qvy, ray.dz, qvz), inv_det);
    float t = __fmul_rn(t_num, inv_det);
    if (v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > t_min && t < best_t) {
        best_t = t;
        best_p = prim;
        best_u = u;
        best_v = v;
    }
}

__global__ void __launch_bounds__(THREADS)
closest_hit_flat_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmax,        // (R,) or null
                        const float4* __restrict__ tri,        // (P, 3) float4
                        int P, float t_min, int R,
                        int* __restrict__ out_prim, float* __restrict__ out_t,
                        float* __restrict__ out_u, float* __restrict__ out_v) {
    // general path: a record's three float4 (v0, e1, e2); shared origin:
    // (e1, t_num), (e2, -), (tv, qv.x), (qv.y, qv.z, -, -)
    __shared__ float4 chunk[4 * FLAT_CHUNK];
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    bool active = r < R;
    // a thread past the end helps to stage and writes nothing
    int rr = active ? r : R - 1;
    Ray ray = load_ray(o, d, rr);
    float best_t = tmax ? tmax[rr] : CUDART_INF_F;
    float best_u = 0.0f, best_v = 0.0f;
    int best_p = -1;
    bool cut = !(t_min < 0.0f);
    // every ray of the block from one origin, compared as bits (-0.0f and
    // 0.0f give tv of other signs)
    const float* o0 = o + 3 * (size_t)blockIdx.x * blockDim.x;
    bool shared = __syncthreads_and(
        __float_as_uint(ray.ox) == __float_as_uint(__ldg(o0))
        && __float_as_uint(ray.oy) == __float_as_uint(__ldg(o0 + 1))
        && __float_as_uint(ray.oz) == __float_as_uint(__ldg(o0 + 2)));
    for (int base = 0; base < P; base += FLAT_CHUNK) {
        int n = min(FLAT_CHUNK, P - base);
        __syncthreads();            // the previous chunk has been read
        if (shared) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const float4* rec = tri + 3 * (size_t)(base + i);
                float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
                // v0 = a.xyz, e1 = (a.w, b.x, b.y), e2 = (b.z, b.w, c.x)
                float tvx = __fsub_rn(ray.ox, a.x);
                float tvy = __fsub_rn(ray.oy, a.y);
                float tvz = __fsub_rn(ray.oz, a.z);
                float qvx = det2(tvy, b.y, tvz, b.x);
                float qvy = det2(tvz, a.w, tvx, b.y);
                float qvz = det2(tvx, b.x, tvy, a.w);
                float t_num = dot3(b.z, qvx, b.w, qvy, c.x, qvz);
                chunk[4 * i] = make_float4(a.w, b.x, b.y, t_num);
                chunk[4 * i + 1] = make_float4(b.z, b.w, c.x, 0.0f);
                chunk[4 * i + 2] = make_float4(tvx, tvy, tvz, qvx);
                chunk[4 * i + 3] = make_float4(qvy, qvz, 0.0f, 0.0f);
            }
        } else {
            for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
                chunk[i] = __ldg(tri + 3 * (size_t)base + i);
        }
        __syncthreads();
        if (shared) {
            for (int j = 0; j < n; ++j) {
                float4 e1 = chunk[4 * j], e2 = chunk[4 * j + 1];
                float pvx = det2(ray.dy, e2.z, ray.dz, e2.y);
                float pvy = det2(ray.dz, e2.x, ray.dx, e2.z);
                float pvz = det2(ray.dx, e2.y, ray.dy, e2.x);
                float det = dot3(e1.x, pvx, e1.y, pvy, e1.z, pvz);
                if (!(fabsf(det) > MT_EPS) || !t_may_pass(e1.w, det, cut))
                    continue;
                float4 tq = chunk[4 * j + 2], q = chunk[4 * j + 3];
                flat_finish(det, e1.w, pvx, pvy, pvz, tq.x, tq.y, tq.z, tq.w,
                            q.x, q.y, ray, t_min, base + j, best_t, best_p,
                            best_u, best_v);
            }
        } else {
            for (int j = 0; j < n; ++j) {
                float4 a = chunk[3 * j], b = chunk[3 * j + 1],
                       c = chunk[3 * j + 2];
                float pvx = det2(ray.dy, c.x, ray.dz, b.w);
                float pvy = det2(ray.dz, b.z, ray.dx, c.x);
                float pvz = det2(ray.dx, b.w, ray.dy, b.z);
                float det = dot3(a.w, pvx, b.x, pvy, b.y, pvz);
                if (!(fabsf(det) > MT_EPS)) continue;
                float tvx = __fsub_rn(ray.ox, a.x);
                float tvy = __fsub_rn(ray.oy, a.y);
                float tvz = __fsub_rn(ray.oz, a.z);
                float qvx = det2(tvy, b.y, tvz, b.x);
                float qvy = det2(tvz, a.w, tvx, b.y);
                float qvz = det2(tvx, b.x, tvy, a.w);
                float t_num = dot3(b.z, qvx, b.w, qvy, c.x, qvz);
                if (!t_may_pass(t_num, det, cut)) continue;
                flat_finish(det, t_num, pvx, pvy, pvz, tvx, tvy, tvz, qvx,
                            qvy, qvz, ray, t_min, base + j, best_t, best_p,
                            best_u, best_v);
            }
        }
    }
    if (!active) return;
    bool miss = best_p < 0;
    out_prim[r] = best_p;
    out_t[r] = miss ? CUDART_INF_F : best_t;
    out_u[r] = miss ? 0.0f : best_u;
    out_v[r] = miss ? 0.0f : best_v;
}

// Shared memory of a clustered launch: the staged tables' bytes for C
// clusters and G groups, or 0 when they do not fit and stay in global
// memory.
static size_t staged_bytes(int C, int G) {
    size_t bytes = ((size_t)C + G) * STAGED_BYTES_PER_CLUSTER;
    return bytes <= MAX_STAGED_BYTES ? bytes : 0;
}

// Each returns the launch's cudaError_t (0 = launched); none synchronizes.
extern "C" int skybox_rt_closest_hit_clustered(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* table, const void* visit, const void* group_table,
        const void* group_visit, const void* order, int C, int G,
        float t_min, int R, void* out_prim, void* out_t, void* out_u,
        void* out_v, void* stream) {
    if (C < 0 || G < 0 || (C > 0) != (G > 0)) return cudaErrorInvalidValue;
    if (R == 0) return cudaSuccess;
    int grid = (R + THREADS - 1) / THREADS;
    size_t smem = staged_bytes(C, G);
    ClusterTables tabs = {(const float4*)table, (const int*)visit,
                          (const float4*)group_table,
                          (const int*)group_visit};
    clustered_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, tabs, (const int*)order, C, G, smem > 0, t_min,
        R, (int*)out_prim, (float*)out_t, (float*)out_u, (float*)out_v,
        nullptr);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_any_hit_clustered(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* table, const void* visit, const void* group_table,
        const void* group_visit, int C, int G, float t_min, int R,
        void* out_occ, void* stream) {
    if (C < 0 || G < 0 || (C > 0) != (G > 0)) return cudaErrorInvalidValue;
    if (R == 0) return cudaSuccess;
    int grid = (R + THREADS - 1) / THREADS;
    size_t smem = staged_bytes(C, G);
    ClusterTables tabs = {(const float4*)table, (const int*)visit,
                          (const float4*)group_table,
                          (const int*)group_visit};
    clustered_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, tabs, nullptr, C, G, smem > 0, t_min, R,
        nullptr, nullptr, nullptr, nullptr, (unsigned char*)out_occ);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_closest_hit_flat(
        const void* o, const void* d, const void* tmax, const void* tri,
        int P, float t_min, int R, void* out_prim, void* out_t, void* out_u,
        void* out_v, void* stream) {
    if (P < 0) return cudaErrorInvalidValue;
    if (R == 0) return cudaSuccess;
    int grid = (R + THREADS - 1) / THREADS;
    closest_hit_flat_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, P, t_min, R, (int*)out_prim, (float*)out_t,
        (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}
