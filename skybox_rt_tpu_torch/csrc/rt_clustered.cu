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
//   * flat: every thread of a block tests the same record at each step, so a
//     block stages records through shared memory 256 at a time.

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

__global__ void __launch_bounds__(THREADS)
closest_hit_flat_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmax,        // (R,) or null
                        const float4* __restrict__ tri,        // (P, 3) float4
                        int P, float t_min, int R,
                        int* __restrict__ out_prim, float* __restrict__ out_t,
                        float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float4 chunk[3 * FLAT_CHUNK];
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    bool active = r < R;
    // a thread past the end helps to stage and writes nothing
    int rr = active ? r : R - 1;
    Ray ray = load_ray(o, d, rr);
    float best_t = tmax ? tmax[rr] : CUDART_INF_F;
    float best_u = 0.0f, best_v = 0.0f;
    int best_p = -1;
    for (int base = 0; base < P; base += FLAT_CHUNK) {
        int n = min(FLAT_CHUNK, P - base);
        __syncthreads();            // the previous chunk has been read
        for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
            chunk[i] = __ldg(tri + 3 * (size_t)base + i);
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            float t, u, v;
            bool hit = mt_record(chunk[3 * j], chunk[3 * j + 1],
                                 chunk[3 * j + 2], ray, t_min, t, u, v);
            // strict <, ascending prim id: the lowest id wins equal t
            if (hit && t < best_t) {
                best_t = t;
                best_p = base + j;
                best_u = u;
                best_v = v;
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
