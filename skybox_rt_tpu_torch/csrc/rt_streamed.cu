// Closest hit over triangle blocks gated by block AABBs, for sm_90a: the dense
// sweep and the worklist walk, and the worklist's prepass.
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
//            first `counts[g]` entries, in that order; the prepass kernel at
//            the end of this file made them (the blocks some ray of the tile
//            enters against its fixed t_max, near to far).
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

// ---------------------------------------------------------------------------
// The worklist's prepass (pallas_rt._active_block_lists): for every tile g of
// RAY_TILE consecutive rays its row of `lists` (G, NB) and counts[g].  The
// plain version is ops/cuda_rt.py active_block_lists_reference: a block is
// active for a tile when some ray of the tile passes the slab test against
// the ray's fixed far (t_max, or +inf); counts[g] is the tile's active
// blocks and the row the stable argsort of the tile's keys: with
// front_to_back the least tn over the tile's passing rays (+inf for an
// inactive block), else 0 for an active block and 1 for an inactive one.
//
// Exactness.  The slab test is rt_common.cuh's slab_range, the walk's own
// arithmetic, so a ray passes where the plain version's passes and its tn is
// the plain tn (for the finite rays of rt_common.cuh's contract).  tn is a
// max with 0.0f and never NaN, so it is +0, -0, a positive float or +inf.
// Its bits with the sign bit cleared (which maps -0.0f to +0.0f, a key the
// plain float compare finds equal to it) order as the float does: finite
// keys below +inf's 0x7f800000, and 0xffffffff is free to mark a block no
// ray of the tile enters.  The least key of a tile is then an unsigned
// minimum, exact under __reduce_min_sync.  A stable argsort orders the
// (key, id) pairs lexicographically and the pairs are distinct, so any
// correct sort of them gives the same row: the blocks of finite key sorted
// by (key, id) (a rank sort, each rank counted over the others), then every
// other block in ascending id (the inactive ones, and an active one whose
// key is +inf, which the float compare ties with them).  In ascending-id
// mode the active blocks come first, in ascending id, then the others.
//
// Bound: operations, a slab test of 25 flop for every (ray, block) pair: the
// small scene's 1024x1024 primary launch (1,048,576 rays, 188 blocks)
// 4.93e9 flop, 0.074 ms; its bytes, 24 a ray and the lists (4 NB a tile),
// some 35 MB, 0.0105 ms.  The rays' lists are short (some 4.5 blocks a tile
// on that launch), so the sort costs little beside the slab tests.
//
// Design: a warp takes a tile, four tiles a block of 128 threads (fewer when
// NB is so large that four tiles' keys do not fit in shared memory).  Each
// lane holds RAY_TILE / 32 = 4 rays in registers and tests each block's box
// (read once, a broadcast) against all of them; the warp's least key comes
// from one __reduce_min_sync, and no barrier is needed.  The warp then
// finishes its tile from its keys in shared memory (8 bytes a block: the
// keys, and the ids of the sorted head): a ballot and popc compaction of the
// head and of the tail, which it writes in place, then the head's rank sort.
// Measured against a ray a thread with the four warps' minima met by a
// shared-memory atomicMin behind a barrier, which took 23 % longer on the
// small scene's primary launch (PERF.md).

#define PREPASS_NO_KEY 0xffffffffu
#define PREPASS_INF_KEY 0x7f800000u
#define PREPASS_RPL (RAY_TILE / 32)         // rays a lane
// a tile's keys and head ids, 8 bytes a block, held in one block's shared
// memory: at most 227 KB (ops/cuda_rt.py PREPASS_MAX_BLOCKS)
#define PREPASS_SMEM_MAX (227 * 1024)
#define PREPASS_MAX_BLOCKS (PREPASS_SMEM_MAX / 8)
#define DEFAULT_SMEM_MAX (48 * 1024)

__global__ void __launch_bounds__(RAY_TILE)
active_block_lists_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,     // (R,) or null
                          const float* __restrict__ aabb,     // (NB, 6)
                          int NB, int R, int G, int front_to_back,
                          int* __restrict__ lists,            // (G, NB)
                          int* __restrict__ counts) {         // (G,)
    extern __shared__ unsigned s_keys[];
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int g = blockIdx.x * (blockDim.x >> 5) + warp;
    if (g >= G) return;                            // no barrier follows
    unsigned* key = s_keys + (size_t)2 * NB * warp;
    int* head = reinterpret_cast<int*>(key + NB);
    const float2* box = reinterpret_cast<const float2*>(aabb);
    Ray ray[PREPASS_RPL];
    float far[PREPASS_RPL];
#pragma unroll
    for (int i = 0; i < PREPASS_RPL; ++i) {
        int r = g * RAY_TILE + i * 32 + lane;
        bool live = r < R;
        ray[i] = load_ray(o, d, live ? r : 0);
        // a ray past the end has far -inf: it enters nothing (tn >= 0)
        far[i] = !live ? -CUDART_INF_F : (tmax ? tmax[r] : CUDART_INF_F);
    }
    for (int b = 0; b < NB; ++b) {
        float2 p = __ldg(box + 3 * b), q = __ldg(box + 3 * b + 1),
               s = __ldg(box + 3 * b + 2);
        unsigned m = PREPASS_NO_KEY;
#pragma unroll
        for (int i = 0; i < PREPASS_RPL; ++i) {
            float tn, tf;
            slab_range(p.x, p.y, q.x, q.y, s.x, s.y, ray[i], far[i], tn, tf);
            if (tn <= tf) m = min(m, __float_as_uint(tn) & 0x7fffffffu);
        }
        m = __reduce_min_sync(FULL_MASK, m);
        if (lane == 0) key[b] = m;
    }
    __syncwarp();
    // the head: the blocks of finite key (front_to_back) or the active ones
    unsigned below = (1u << lane) - 1u;
    int n_act = 0, n_fin = 0;
    for (int b0 = 0; b0 < NB; b0 += 32) {
        unsigned k = b0 + lane < NB ? key[b0 + lane] : PREPASS_NO_KEY;
        n_act += __popc(__ballot_sync(FULL_MASK, k != PREPASS_NO_KEY));
        n_fin += __popc(__ballot_sync(FULL_MASK, k < PREPASS_INF_KEY));
    }
    int n_head = front_to_back ? n_fin : n_act;
    int* row = lists + (size_t)g * NB;
    int nh = 0, nt = 0;
    for (int b0 = 0; b0 < NB; b0 += 32) {
        int b = b0 + lane;
        bool in = b < NB;
        unsigned k = in ? key[b] : PREPASS_NO_KEY;
        bool h = in && (front_to_back ? k < PREPASS_INF_KEY
                                      : k != PREPASS_NO_KEY);
        unsigned hm = __ballot_sync(FULL_MASK, h);
        unsigned tm = __ballot_sync(FULL_MASK, in && !h);
        if (h) {
            int at = nh + __popc(hm & below);
            if (front_to_back) {
                // at <= b: every key at or below this chunk's end was read
                // before the ballot
                key[at] = k;
                head[at] = b;
            } else {
                row[at] = b;
            }
        } else if (in) {
            row[n_head + nt + __popc(tm & below)] = b;
        }
        nh += __popc(hm);
        nt += __popc(tm);
    }
    __syncwarp();
    if (front_to_back) {
        // head[] ascends in id, so (key, id) order is (key, position) order
        for (int j = lane; j < n_head; j += 32) {
            unsigned kj = key[j];
            int rank = 0;
            for (int i = 0; i < n_head; ++i) {
                unsigned ki = key[i];
                rank += ki < kj || (ki == kj && i < j);
            }
            row[rank] = head[j];
        }
    }
    if (lane == 0) counts[g] = n_act;
}

// Returns the launch's cudaError_t (0 = launched); does not synchronize.
extern "C" int skybox_rt_active_block_lists(
        const void* o, const void* d, const void* tmax, const void* aabb,
        int NB, int R, int front_to_back, void* lists, void* counts,
        void* stream) {
    if (NB < 0 || R < 0 || NB > PREPASS_MAX_BLOCKS)
        return cudaErrorInvalidValue;
    if (R == 0) return cudaSuccess;
    int G = (R + RAY_TILE - 1) / RAY_TILE;
    // as many tiles a block (up to RAY_TILE / 32) as shared memory holds
    int tiles = RAY_TILE / 32;
    if (NB > 0 && PREPASS_SMEM_MAX / (8 * NB) < tiles)
        tiles = PREPASS_SMEM_MAX / (8 * NB);
    size_t smem = (size_t)tiles * 8 * NB;
    if (smem > DEFAULT_SMEM_MAX) {
        cudaError_t rc = cudaFuncSetAttribute(
            active_block_lists_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    active_block_lists_kernel<<<(G + tiles - 1) / tiles, 32 * tiles, smem,
                                (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float*)aabb, NB, R, G, front_to_back, (int*)lists,
        (int*)counts);
    return (int)cudaGetLastError();
}
