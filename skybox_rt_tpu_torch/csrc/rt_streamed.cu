// Closest hit over triangle blocks gated by block AABBs, for sm_90a: the dense
// sweep and the worklist walk.
//
// Replace the Pallas TPU kernels of skybox_rt_tpu/ops/pallas_rt.py
//   `_make_streamed_kernel` (entry `closest_hit_streamed`),
//   `_make_worklist_kernel` (entry `closest_hit_worklist`, with the prepass
//                            `_active_block_lists`).
// Those hold 4,096 rays as a tile a grid program and bring 512-triangle blocks
// to it, the first over a dense (ray tile x block) grid whose blocks arrive by
// the pipeline's own copies, the second over the tile's compacted list of
// active blocks with copies it double-buffers itself.  What tells the two
// apart on any chip is kept: how a ray tile comes to its blocks.
//
// The function (ops/cuda_rt.py holds the plain torch version of each): the
// records are P rows in the caller's order, cut into blocks of tri_block rows
// (the last one shorter), each with its AABB.  A ray tile is RAY_TILE
// consecutive rays.
//   streamed: the tile meets every block in ascending id.
//   worklist: the tile meets the blocks of its row of `lists` (G, NB), the
//            first `counts[g]` entries, in that order; the plain-torch prepass
//            made them (the blocks some ray of the tile enters against its
//            fixed t_max, near to far).
// In both a ray enters a block when its slab test passes with far = its
// running best t; over the triangles so entered, the Möller–Trumbore hit with
// the lexicographic minimum (t, slot), slot = the record's row; the prim
// returned is order[slot] (or slot without an order).
//
// Exactness: the plain versions make the same per-ray decisions in the same
// per-ray order against the same running best (ops/cuda_rt.py), the arithmetic
// is rt_common.cuh's, so kernel and plain version agree bit for bit.
//
// Bound: operations.  A 1024x1024 launch reads 24 bytes and writes 16 a ray;
// a ray does one slab test of 25 flop a block it meets and 53 flop a triangle
// of a block it enters.  The records of a 12,032-triangle scene are 578 KB
// and stay in L2.  A ray enters few of the blocks it meets (3.5 of 188 on the
// small scene's primary launch), but a warp's neighbouring rays mostly enter
// the same ones: on the primary launch a block a warp enters holds 26.6 of
// its 32 rays on average, on the shadow and bounce launches fewer (a ray a
// lane keeps 43-83 % of the lanes busy, PERF.md).  What is left is issue:
// the tests' instructions, with no fused multiply-add.
//
// Design: a warp walks the blocks on its own, with no barrier; a CTA is
// RAY_TILE rays (4 warps), the worklist's tile, each warp with its own slice
// of shared memory.  For each block the lanes slab-test it against their
// running best t and __ballot_sync gives the k rays that enter.  With k >=
// lane_switch the warp copies the block's records into its slice (coalesced,
// 16 bytes a lane) and every entering lane tests them in order, as a thread
// a ray, each record a shared-memory broadcast.  With fewer, the warp takes
// the entering rays one at a time: the ray is shuffled to every lane, lane i
// tests triangles i, i + 32, ... of the block (read from L2, neighbouring
// lanes on neighbouring records), and a shuffle reduction gives the
// lexicographic (t, slot) minimum of the hits, which the ray's own lane
// folds into its best.  A test's arithmetic is rt_common.cuh's whichever
// lane runs it, and the lexicographic minimum does not depend on the order
// of its terms, so either mode returns the same bits.  The warp finishes
// block b, every ray's update, before it slab-tests block b + 1, so every
// entry decision is the plain version's.  The earlier design staged each
// entered block in shared memory for a CTA of 128 rays, two barriers a
// block met, and ran all 64 triangles on any warp with one entering lane.

#include <climits>

#include "rt_common.cuh"

#define RAY_TILE 128
#define MAX_TRI_BLOCK 256
#define FULL_MASK 0xffffffffu

// (t, s) < (bt, bs) in lexicographic order
__device__ __forceinline__ bool lex_less(float t, int s, float bt, int bs) {
    return t < bt || (t == bt && s < bs);
}

// LISTED: walk `lists` row blockIdx.x (worklist); else every block (streamed).
template <bool LISTED>
__global__ void __launch_bounds__(RAY_TILE)
closest_hit_blocks_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,     // (R,) or null
                          const float4* __restrict__ tri,     // (P, 3) float4
                          const float* __restrict__ aabb,     // (NB, 6)
                          const int* __restrict__ order,      // (P,) or null
                          const int* __restrict__ lists,      // (G, NB)
                          const int* __restrict__ counts,     // (G,)
                          int NB, int P, int tri_block, float t_min, int R,
                          int lane_switch,
                          int* __restrict__ out_prim,
                          float* __restrict__ out_t,
                          float* __restrict__ out_u,
                          float* __restrict__ out_v) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    int lane = threadIdx.x & 31;
    bool active = r < R;
    // a lane past the end takes part in the warp's shuffles, enters nothing
    // and writes nothing
    Ray ray = load_ray(o, d, active ? r : R - 1);
    float tmax0 = (tmax && active) ? tmax[r] : CUDART_INF_F;
    float best_t = tmax0, best_u = 0.0f, best_v = 0.0f;
    int best_s = -1;
    extern __shared__ float4 s_all[];   // (RAY_TILE / 32, 3 * tri_block)
    float4* rec = s_all + (threadIdx.x >> 5) * 3 * tri_block;
    int steps = LISTED ? counts[blockIdx.x] : NB;
    const int* row = LISTED ? lists + (size_t)blockIdx.x * NB : nullptr;
    for (int k = 0; k < steps; ++k) {
        int b = LISTED ? __ldg(row + k) : k;
        bool enter = active && slab(aabb + 6 * (size_t)b, ray, best_t);
        unsigned mask = __ballot_sync(FULL_MASK, enter);
        if (!mask) continue;
        int base = b * tri_block;
        int n = min(tri_block, P - base);
        if (__popc(mask) >= lane_switch) {
            __syncwarp();       // every lane is done with the slice
            for (int i = lane; i < 3 * n; i += 32)
                rec[i] = __ldg(tri + 3 * (size_t)base + i);
            __syncwarp();
            if (!enter) continue;
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                int slot = base + j;
                float t, u, v;
                bool hit = mt_record(rec[3 * j], rec[3 * j + 1],
                                     rec[3 * j + 2], ray, t_min, t, u, v)
                    && t < tmax0;
                if (hit && lex_less(t, slot, best_t, best_s)) {
                    best_t = t;
                    best_s = slot;
                    best_u = u;
                    best_v = v;
                }
            }
            continue;
        }
        for (unsigned m = mask; m; m &= m - 1) {
            int src = __ffs(m) - 1;
            Ray q;
            q.ox = __shfl_sync(FULL_MASK, ray.ox, src);
            q.oy = __shfl_sync(FULL_MASK, ray.oy, src);
            q.oz = __shfl_sync(FULL_MASK, ray.oz, src);
            q.dx = __shfl_sync(FULL_MASK, ray.dx, src);
            q.dy = __shfl_sync(FULL_MASK, ray.dy, src);
            q.dz = __shfl_sync(FULL_MASK, ray.dz, src);
            q.ix = __shfl_sync(FULL_MASK, ray.ix, src);
            q.iy = __shfl_sync(FULL_MASK, ray.iy, src);
            q.iz = __shfl_sync(FULL_MASK, ray.iz, src);
            float q_tmax = __shfl_sync(FULL_MASK, tmax0, src);
            // this lane's part: no hit is (+inf, INT_MAX), after every hit
            float c_t = CUDART_INF_F, c_u = 0.0f, c_v = 0.0f;
            int c_s = INT_MAX;
            for (int j = lane; j < n; j += 32) {
                int slot = base + j;
                float t, u, v;
                bool hit = mt_one(tri, slot, q, t_min, t, u, v)
                    && t < q_tmax;
                if (hit && lex_less(t, slot, c_t, c_s)) {
                    c_t = t;
                    c_s = slot;
                    c_u = u;
                    c_v = v;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                float x_t = __shfl_xor_sync(FULL_MASK, c_t, off);
                int x_s = __shfl_xor_sync(FULL_MASK, c_s, off);
                float x_u = __shfl_xor_sync(FULL_MASK, c_u, off);
                float x_v = __shfl_xor_sync(FULL_MASK, c_v, off);
                if (lex_less(x_t, x_s, c_t, c_s)) {
                    c_t = x_t;
                    c_s = x_s;
                    c_u = x_u;
                    c_v = x_v;
                }
            }
            if (lane == src && c_s != INT_MAX
                    && lex_less(c_t, c_s, best_t, best_s)) {
                best_t = c_t;
                best_s = c_s;
                best_u = c_u;
                best_v = c_v;
            }
        }
    }
    if (!active) return;
    bool miss = best_s < 0;
    out_prim[r] = miss ? -1 : (order ? __ldg(order + best_s) : best_s);
    out_t[r] = miss ? CUDART_INF_F : best_t;
    out_u[r] = miss ? 0.0f : best_u;
    out_v[r] = miss ? 0.0f : best_v;
}

// the warps' slices: 48 KB at MAX_TRI_BLOCK, the launch's default limit
static size_t stage_bytes(int tri_block) {
    return (size_t)(RAY_TILE / 32) * 3 * tri_block * sizeof(float4);
}

static int check_blocks(int NB, int P, int tri_block) {
    if (tri_block < 1 || tri_block > MAX_TRI_BLOCK || NB < 0 || P < 0
            || (long long)NB * tri_block < P
            || (NB > 0 && (long long)(NB - 1) * tri_block >= P))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// Each returns the launch's cudaError_t (0 = launched); none synchronizes.
extern "C" int skybox_rt_closest_hit_streamed(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* aabb, const void* order, int NB, int P, int tri_block,
        float t_min, int R, int lane_switch, void* out_prim, void* out_t,
        void* out_u, void* out_v, void* stream) {
    int rc = check_blocks(NB, P, tri_block);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + RAY_TILE - 1) / RAY_TILE;
    closest_hit_blocks_kernel<false><<<grid, RAY_TILE, stage_bytes(tri_block),
                                       (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const float*)aabb, (const int*)order, nullptr,
        nullptr, NB, P, tri_block, t_min, R, lane_switch, (int*)out_prim,
        (float*)out_t, (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_closest_hit_worklist(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* aabb, const void* order, const void* lists,
        const void* counts, int NB, int P, int tri_block, float t_min, int R,
        int lane_switch, void* out_prim, void* out_t, void* out_u,
        void* out_v, void* stream) {
    int rc = check_blocks(NB, P, tri_block);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + RAY_TILE - 1) / RAY_TILE;
    closest_hit_blocks_kernel<true><<<grid, RAY_TILE, stage_bytes(tri_block),
                                      (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const float*)aabb, (const int*)order,
        (const int*)lists, (const int*)counts, NB, P, tri_block, t_min, R,
        lane_switch, (int*)out_prim, (float*)out_t, (float*)out_u,
        (float*)out_v);
    return (int)cudaGetLastError();
}
