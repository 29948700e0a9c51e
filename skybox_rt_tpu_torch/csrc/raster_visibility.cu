// Pass 1 (visibility) of the deferred draw3d renderer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel skybox_rt_tpu/ops/pallas_raster.py
// (_make_kernel, launched by _visibility_call / visibility_tiles).  It
// computes the same function, not the TPU layout: no pre-gathered
// (T, M, 16) records, no (ns, 128) lane tiling, no ts*ts % 128 restriction.
//
// Design: a warp owns a patch of kPatchW x kPatchH = 32 pixels of one
// binned tile, one pixel a lane, and a block holds kWarps warps of one tile;
// the grid covers T x (patches of a tile / warps a block).  The block walks
// tile_pids[t, 0:M] in order, staging chunks of (edges[pid], zattr[pid])
// records in shared memory.  For each run of 32 staged prims, lane j tests
// prim j against its warp's patch (edge_negative_on below); __ballot_sync
// gives the prims that may cover the patch, and the warp walks those bits
// in ascending order, so every pixel still meets its prims in submission
// order.  Each lane carries its pixel's state in registers — (dsw, win,
// dx, dy) for opaque draws, (dsw, cnt) for blended ones, whose first K
// passing pids go straight to slots[t, cnt, pixel] — and the kernel writes
// global pids, with no atomics.  A culled prim covers no pixel of the
// patch, and an uncovered pixel neither updates its ds word nor wins, so
// the cull changes no output bit.  A patch with no pixel inside the
// scissor skips every prim and writes what it read.
//
// The cull is exact under the wrapping arithmetic: an edge's value at a
// pixel is a*x + b*y + c (mod 2^32) read as int32.  In int64 the unwrapped
// value is affine over the patch, so its least and largest values lo, hi
// lie at corners, and every int64 of [lo, hi] wraps to a negative int32
// when lo >> 31 == hi >> 31 (floor division) and that quotient is odd.  A
// prim is culled when one of its edges is so; a bounding-box cull could cut
// a fragment that lies beyond its prim's box (edge values that wrap), so
// none is used.  ops/cuda_raster.patch_culled is the plain twin.
//
// Exactness (bit-equal to the JAX package and to the plain torch version):
//   * edge sums a*x + b*y + c wrap mod 2^32: computed in uint32_t;
//   * barycentrics use IEEE float32: __int2float_rn, __fadd_rn in the
//     reference's order, __fdiv_rn for 1/((f0+f1)+f2), __fmul_rn; the
//     build also passes -prec-div=true -fmad=false and never fast math;
//   * the x86 float->int cast (NaN / out of range -> INT_MIN) is tested
//     explicitly, since cvt.rzi saturates and sends NaN to 0;
//   * imadd24 is the low 32 bits of the arithmetic shift of the 64-bit
//     product, the add wrapping too;
//   * depth-stencil words are uint32_t throughout (stencil INVERT is a
//     32-bit ~val shifted left by 24).
//
// What bounds it on the H100: memory traffic is small (a block reads one
// 52-byte record a prim of its tile, from L2); the work is one cull test a
// (patch, prim) and the pixel steps of the prims a patch keeps (8.8 % of all
// pixel-prim steps on the synthetic trace's sphere draws at 256x256 with
// 32x32 tiles).  A warp runs a kept prim's covered-pixel work (the divide,
// the ds test) for all its lanes when one lane is covered, and a 256x256
// draw has 768 warps, a few a scheduler, so the walk's dependent chain sets
// the time (PERF.md).  The earlier design ran one block per tile (24 for a
// sphere draw at 256x256) through every prim of the tile; the patches give
// 8 blocks a 32x32 tile.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;         // prim records staged per chunk
constexpr int kRun = 32;            // prims culled together: one a lane
constexpr int kRecWords = 12;       // 9 edge coefficients + 3 z-plane terms
constexpr int kRecStride = 13;      // odd: lane j's record in its own bank
constexpr int kPatchW = 8;          // a warp's patch of pixels
constexpr int kPatchH = 4;
constexpr int kWarps = 4;           // warps (patches) a block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDepthMask = 0xFFFFFFu;
constexpr int kDepthBits = 24;

// OM_DEPTH_FUNC_* (core/constants.py)
enum { kAlways = 0, kNever = 1, kLess = 2, kLequal = 3, kEqual = 4,
       kGequal = 5, kGreater = 6, kNotequal = 7 };
// OM_STENCIL_OP_*
enum { kKeep = 0, kZero = 1, kReplace = 2, kIncr = 3, kDecr = 4,
       kInvert = 5, kIncrWrap = 6, kDecrWrap = 7 };

struct VisParams {
  const int* edges;      // (P, 3, 3)
  const int* zattr;      // (P, 3)
  const int* tile_pids;  // (T, M), -1 padded
  const int* tile_xy;    // (T, 2)
  const int* fb_ds;      // (T, ts, ts) u32 bit patterns
  int* dsw;              // (T, ts, ts)
  int* win;              // (T, ts, ts) or null
  int* dx;               // (T, ts, ts) or null
  int* dy;
  int* slots;            // (T, K, ts, ts) or null
  int* cnt;              // (T, ts, ts) or null
  int M, tls;
  int sc_left, sc_top, sc_right, sc_bottom;
  int ds_active, shade_z, need_grad, fused, K;
  int depth_func, depth_write;
  int stencil_en, s_func, s_ref, s_mask, s_zpass, s_zfail, s_fail,
      s_writemask;
};

__device__ __forceinline__ bool compare(int func, uint32_t a, uint32_t b) {
  switch (func) {
    case kNever: return false;
    case kLess: return a < b;
    case kEqual: return a == b;
    case kLequal: return a <= b;
    case kGreater: return a > b;
    case kNotequal: return a != b;
    case kGequal: return a >= b;
    default: return true;           // kAlways
  }
}

__device__ __forceinline__ uint32_t stencil_op(int op, uint32_t ref,
                                               uint32_t val) {
  switch (op) {
    case kZero: return 0u;
    case kReplace: return ref;
    case kIncr: return val < 0xFFu ? val + 1u : val;
    case kDecr: return val > 0u ? val - 1u : val;
    case kInvert: return ~val;
    case kIncrWrap: return (val + 1u) & 0xFFu;
    case kDecrWrap: return (val - 1u) & 0xFFu;
    default: return val;            // kKeep
  }
}

// float32 -> fixed24 with x86 cvttss2si semantics (core/fixed.to_fixed_x86)
__device__ __forceinline__ int to_fixed24_x86(float x) {
  const float tr = truncf(__fmul_rn(x, 16777216.0f));
  if (isnan(tr) || tr >= 2147483648.0f || tr < -2147483648.0f) return INT_MIN;
  return static_cast<int>(tr);
}

__device__ __forceinline__ float fixed24_to_float(int v) {
  return __fmul_rn(__int2float_rn(v), 5.9604644775390625e-08f);  // 2^-24
}

// ((int64)a * b >> 24) + c, low 32 bits (core/fixed.imadd24)
__device__ __forceinline__ int imadd24(int a, int b, int c) {
  const long long p = static_cast<long long>(a) * static_cast<long long>(b);
  const uint32_t lo = static_cast<uint32_t>(
      static_cast<unsigned long long>(p >> 24));
  return static_cast<int>(lo + static_cast<uint32_t>(c));
}

__device__ __forceinline__ int edge_eval(const int* r, uint32_t x,
                                         uint32_t y) {
  return static_cast<int>(static_cast<uint32_t>(r[0]) * x
                          + static_cast<uint32_t>(r[1]) * y
                          + static_cast<uint32_t>(r[2]));
}

// om/merger.ds_carry_update (front face) for a covered pixel:
// DepthTencil::test plus the masked ds write; returns whether it passed.
__device__ __forceinline__ bool ds_step(const VisParams& p, uint32_t z,
                                        uint32_t& dsw) {
  const uint32_t depth_val = dsw & kDepthMask;
  const uint32_t stencil_val = dsw >> kDepthBits;
  const uint32_t depth_ref = z & kDepthMask;
  const uint32_t sref_m = static_cast<uint32_t>(p.s_ref & p.s_mask);
  const uint32_t sval_m = stencil_val & static_cast<uint32_t>(p.s_mask);
  const bool s_pass = compare(p.s_func, sref_m, sval_m);
  const bool d_pass = compare(p.depth_func, depth_ref, depth_val);
  const bool passed = s_pass && d_pass;
  const int op = s_pass ? (d_pass ? p.s_zpass : p.s_zfail) : p.s_fail;
  const uint32_t sres =
      stencil_op(op, static_cast<uint32_t>(p.s_ref), stencil_val);
  const uint32_t result = (sres << kDepthBits) | depth_ref;
  uint32_t wm = (p.depth_write && passed) ? kDepthMask : 0u;
  if (p.stencil_en) wm |= static_cast<uint32_t>(p.s_writemask & 0xFF)
                          << kDepthBits;
  if (wm != 0u) dsw = (dsw & ~wm) | (result & wm);
  return passed;
}

// Whether edge e = (a, b, c) is negative on every pixel of [x0, x1] x
// [y0, y1] (the header's cull).
__device__ __forceinline__ bool edge_negative_on(const int* e, long long x0,
                                                 long long x1, long long y0,
                                                 long long y1) {
  const long long a = e[0], b = e[1], c = e[2];
  const long long lo = c + (a >= 0 ? a * x0 : a * x1)
                       + (b >= 0 ? b * y0 : b * y1);
  const long long hi = c + (a >= 0 ? a * x1 : a * x0)
                       + (b >= 0 ? b * y1 : b * y0);
  const long long q = lo >> 31;
  return q == (hi >> 31) && (q & 1);
}

__global__ void __launch_bounds__(kWarps * 32)
visibility_kernel(const VisParams p) {
  __shared__ int s_rec[kChunk][kRecStride];
  __shared__ int s_pid[kChunk];

  const int t = blockIdx.x;
  const int ts = 1 << p.tls;
  const int npix = ts * ts;
  const int nthr = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int patch = blockIdx.y * (nthr >> 5) + (threadIdx.x >> 5);
  const int pw = ts / kPatchW;                  // patches a row of the tile
  const int lx0 = (patch % pw) * kPatchW;
  const int ly0 = (patch / pw) * kPatchH;
  const int q = (ly0 + (lane >> 3)) * ts + lx0 + (lane & 7);
  const int ox = p.tile_xy[2 * t] * ts;
  const int oy = p.tile_xy[2 * t + 1] * ts;
  const size_t tile_base = static_cast<size_t>(t) * npix;

  const int x = ox + (q & (ts - 1));
  const int y = oy + (q >> p.tls);
  const uint32_t px = static_cast<uint32_t>(x);
  const uint32_t py = static_cast<uint32_t>(y);
  const bool inside = x >= p.sc_left && x < p.sc_right && y >= p.sc_top
                      && y < p.sc_bottom;
  const bool live = __any_sync(kFull, inside);
  const long long cx0 = ox + lx0, cx1 = cx0 + kPatchW - 1;
  const long long cy0 = oy + ly0, cy1 = cy0 + kPatchH - 1;

  uint32_t dsw = static_cast<uint32_t>(p.fb_ds[tile_base + q]);
  int win = -1, gdx = 0, gdy = 0, cnt = 0;
  for (int j = 0; j < p.K; ++j)
    p.slots[(static_cast<size_t>(t) * p.K + j) * npix + q] = -1;

  for (int base = 0; base < p.M; base += kChunk) {
    const int n = min(kChunk, p.M - base);
    __syncthreads();
    // word k of record i: one load a thread, neighbours on neighbouring
    // words
    for (int w = threadIdx.x; w < n * kRecWords; w += nthr) {
      const int i = w / kRecWords;
      const int k = w - i * kRecWords;
      const int pid = p.tile_pids[static_cast<size_t>(t) * p.M + base + i];
      if (k == 0) s_pid[i] = pid;
      if (pid >= 0)
        s_rec[i][k] = k < 9 ? p.edges[static_cast<size_t>(pid) * 9 + k]
                            : p.zattr[static_cast<size_t>(pid) * 3 + k - 9];
    }
    __syncthreads();
    if (live) {               // else the patch skips every prim
      for (int run = 0; run < n; run += kRun) {
        // lane j culls prim run + j for the warp's patch; padding (pid -1)
        // never covers
        const int i = run + lane;
        bool keep = false;
        if (i < n && s_pid[i] >= 0) {
          const int* e = s_rec[i];
          keep = !(edge_negative_on(e + 0, cx0, cx1, cy0, cy1)
                   || edge_negative_on(e + 3, cx0, cx1, cy0, cy1)
                   || edge_negative_on(e + 6, cx0, cx1, cy0, cy1));
        }
        // the kept prims in ascending order: submission order
        for (unsigned bits = __ballot_sync(kFull, keep); bits;
             bits &= bits - 1) {
          const int j = run + __ffs(bits) - 1;
          const int pid = s_pid[j];
          const int* r = s_rec[j];
          const int e0 = edge_eval(r + 0, px, py);
          const int e1 = edge_eval(r + 3, px, py);
          const int e2 = edge_eval(r + 6, px, py);
          // an uncovered pixel neither updates its ds word nor wins
          if (!(e0 >= 0 && e1 >= 0 && e2 >= 0 && inside)) continue;

          int ddx = 0, ddy = 0;
          if (p.need_grad) {
            const float f0 = fixed24_to_float(e0);
            const float f1 = fixed24_to_float(e1);
            const float f2 = fixed24_to_float(e2);
            const float rcp =
                __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(f0, f1), f2));
            ddx = to_fixed24_x86(__fmul_rn(rcp, f0));
            ddy = to_fixed24_x86(__fmul_rn(rcp, f1));
          }
          bool upd = true;
          if (p.ds_active) {
            const uint32_t z = p.shade_z
                ? static_cast<uint32_t>(imadd24(r[10], ddy,
                                                imadd24(r[9], ddx, r[11])))
                : 0u;                 // shader DEFAULTS z = 0
            upd = ds_step(p, z, dsw);
          }
          if (!upd) continue;
          if (p.K > 0) {
            if (cnt < p.K)
              p.slots[(static_cast<size_t>(t) * p.K + cnt) * npix + q] = pid;
            ++cnt;
          } else {
            win = pid;
            gdx = ddx;
            gdy = ddy;
          }
        }
      }
    }
  }

  const size_t o = tile_base + q;
  p.dsw[o] = static_cast<int>(dsw);
  if (p.K > 0) {
    p.cnt[o] = cnt;
  } else {
    p.win[o] = win;
    if (p.fused) {
      p.dx[o] = gdx;
      p.dy[o] = gdy;
    }
  }
}

}  // namespace

// Launches pass 1 on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to int32 tensors laid out as documented on
// VisParams; unused outputs may be null.  The caller validates shapes.
extern "C" int skybox_visibility_tiles(
    const void* edges, const void* zattr, const void* tile_pids,
    const void* tile_xy, const void* fb_ds, void* dsw, void* win, void* dx,
    void* dy, void* slots, void* cnt, int T, int M, int tile_logsize,
    int sc_left, int sc_top, int sc_right, int sc_bottom, int shade_z,
    int depth_en, int depth_func, int depth_write, int stencil_en,
    int s_func, int s_ref, int s_mask, int s_zpass, int s_zfail, int s_fail,
    int s_writemask, int fused, int blend_slots, void* stream) {
  if (tile_logsize < 3 || tile_logsize > 6 || T <= 0 || M < 0
      || blend_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  VisParams p;
  p.edges = static_cast<const int*>(edges);
  p.zattr = static_cast<const int*>(zattr);
  p.tile_pids = static_cast<const int*>(tile_pids);
  p.tile_xy = static_cast<const int*>(tile_xy);
  p.fb_ds = static_cast<const int*>(fb_ds);
  p.dsw = static_cast<int*>(dsw);
  p.win = static_cast<int*>(win);
  p.dx = static_cast<int*>(dx);
  p.dy = static_cast<int*>(dy);
  p.slots = static_cast<int*>(slots);
  p.cnt = static_cast<int*>(cnt);
  p.M = M;
  p.tls = tile_logsize;
  p.sc_left = sc_left;
  p.sc_top = sc_top;
  p.sc_right = sc_right;
  p.sc_bottom = sc_bottom;
  p.ds_active = (depth_en || stencil_en) ? 1 : 0;
  p.shade_z = shade_z;
  p.fused = (fused && blend_slots == 0) ? 1 : 0;
  p.need_grad = (p.fused || (p.ds_active && shade_z)) ? 1 : 0;
  p.K = blend_slots;
  p.depth_func = depth_func;
  p.depth_write = depth_write;
  p.stencil_en = stencil_en;
  p.s_func = s_func;
  p.s_ref = s_ref;
  p.s_mask = s_mask;
  p.s_zpass = s_zpass;
  p.s_zfail = s_zfail;
  p.s_fail = s_fail;
  p.s_writemask = s_writemask;

  const int patches = 1 << (2 * tile_logsize - 5);   // 32 pixels each
  const int warps = patches < kWarps ? patches : kWarps;
  const dim3 grid(T, patches / warps);
  visibility_kernel<<<grid, warps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
