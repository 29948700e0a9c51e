// Hard-mode visibility of the differentiable float pipeline, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel skybox_rt_tpu/diff/pallas_vis.py
// (_make_kernel, launched by _vis_call / visibility_hard).  It computes the
// same function, not the TPU layout: no pre-gathered (T, M, 16) records, no
// (ns, 128) lane shape and so no ts*ts % 128 restriction, no group of eight
// tiles a grid step, no scalar prefetch of the origins.
//
// Function: for every pixel of every binned tile, the step (index into the
// tile's pid list) of the fragment that writes the pixel last under the
// sequential rule of diff.pipeline.render_tile_set.  With the depth test
// that is the lexicographic (z, step) minimum under strict `<` (the earliest
// step wins a z tie); without it the last covered step.  -1 = background.
//
// Design: a warp owns a patch of kPatchW x kPatchH = 32 pixels of one tile,
// one pixel a lane, and carries (best_z, best_step) of its pixel in
// registers; a block is kWarps warps of one tile, the grid T x (patches of a
// tile / kWarps).  Warps share nothing, so there is no barrier: a warp walks
// tile_pids[t, 0:M] in runs of 32, lane j loading prim j's record (9 edge
// coefficients, 3 depths) into its registers and testing it against the
// whole patch (edge_max_on below).  __ballot_sync gives the prims that may
// cover a pixel of the patch; the warp walks those bits in ascending order,
// each lane taking the record from lane j by shuffles, so every pixel still
// meets its prims in list order (the tie rule and the last-covered rule are
// unchanged).  The cull only decides whether a step's per-pixel work runs:
// a culled prim covers no pixel of the patch, so skipping it changes no bit.
//
// The cull is exact under float rounding.  A pixel's edge value is the
// rounded expression e = fl(fl(fl(a*x) + fl(b*y)) + c).  Every rounded
// operation is monotone in each input (non-decreasing for an add, for a
// product in x when a >= 0 and non-increasing when a < 0), so the same
// expression evaluated at the patch corner (xc, yc) with xc = a >= 0 ? x1 :
// x0 and yc = b >= 0 ? y1 : y0 bounds every pixel's rounded value from
// above.  That holds over the extended reals as long as neither chain meets
// a NaN (inf * 0, inf - inf); a NaN propagates to the end.  So: a prim is
// culled when the corner value of one of its edges is < 0 (a NaN corner
// never culls), and a pixel of a culled prim has either a NaN edge value,
// which fails `>= 0`, or one <= the corner's < 0: it is not covered either
// way.  diff/cuda_vis.patch_culled is the plain twin.
//
// Exactness (equal to the plain torch version on every pixel): the float32
// expressions of the plain version in its order and association, each a
// single IEEE operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the
// build also passes -prec-div=true -fmad=false and never fast math):
//   e = (a*x + b*y) + c;  den = (e0 + e1) + e2;
//   denom = |den| > 1e-20 ? den : 1e-20;  b0 = e0/denom;  b1 = e1/denom;
//   b2 = (1 - b0) - b1;  zp = (z0*b0 + z1*b1) + z2*b2;
//   update iff e0 >= 0 && e1 >= 0 && e2 >= 0 && zp < best_z.
// Pixel coordinates are float(origin + local): integers first.  A NaN edge
// value fails `>= 0`, a NaN or +inf z fails `<`, so neither ever wins.
//
// What bounds it on the H100: memory traffic is small (a warp reads each
// 48-byte record of its tile once, from L2, and writes 4 bytes a pixel);
// the work is one cull test a (patch, prim) and the pixel steps of the
// prims a patch keeps (counted by diff/cuda_vis.cull_counts), a covered
// pixel adding two IEEE divides and the z plane.  The earlier design ran
// one block a tile, every pixel through every one of the tile's M steps.
#include <cuda_runtime.h>

namespace {

constexpr int kRecWords = 12;       // 9 edge coefficients + 3 vertex depths
constexpr int kPatchW = 8;          // a warp's patch of pixels
constexpr int kPatchH = 4;
constexpr int kWarps = 4;           // warps (patches) a block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float edge_eval(float a, float b, float c, float x,
                                           float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// The largest rounded value of edge (a, b, c) over the pixels
// [x0, x1] x [y0, y1] (the header's cull); NaN where a chain meets one.
__device__ __forceinline__ float edge_max_on(float a, float b, float c,
                                             float x0, float x1, float y0,
                                             float y1) {
  return edge_eval(a, b, c, a >= 0.0f ? x1 : x0, b >= 0.0f ? y1 : y0);
}

__global__ void __launch_bounds__(kWarps * 32)
diff_visibility_kernel(const float* __restrict__ edges,   // (P, 3, 3)
                       const float* __restrict__ z,       // (P, 3)
                       const int* __restrict__ tile_pids, // (T, M), -1 padded
                       const int* __restrict__ origins,   // (T, 2) pixels
                       int* __restrict__ out,             // (T, ts, ts)
                       int M, int tls, int depth_test) {
  const int t = blockIdx.x;
  const int ts = 1 << tls;
  const int lane = threadIdx.x & 31;
  const int patch = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int pw = ts / kPatchW;                  // patches a row of the tile
  const int lx0 = (patch % pw) * kPatchW;
  const int ly0 = (patch / pw) * kPatchH;
  const int ox = origins[2 * t];
  const int oy = origins[2 * t + 1];
  const float px = __int2float_rn(ox + lx0 + (lane & (kPatchW - 1)));
  const float py = __int2float_rn(oy + ly0 + (lane >> 3));
  const float cx0 = __int2float_rn(ox + lx0);
  const float cx1 = __int2float_rn(ox + lx0 + kPatchW - 1);
  const float cy0 = __int2float_rn(oy + ly0);
  const float cy1 = __int2float_rn(oy + ly0 + kPatchH - 1);
  const int* pids = tile_pids + static_cast<size_t>(t) * M;

  float best_z = __int_as_float(0x7f800000);    // +inf
  int best_s = -1;
  for (int run = 0; run < M; run += 32) {
    // lane j holds the record of step run + j; padding (pid -1) never
    // covers and is never kept
    const int pid = run + lane < M ? __ldg(pids + run + lane) : -1;
    float rec[kRecWords] = {};
    bool keep = false;
    if (pid >= 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        rec[k] = __ldg(edges + static_cast<size_t>(pid) * 9 + k);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rec[9 + k] = __ldg(z + static_cast<size_t>(pid) * 3 + k);
      keep = true;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        keep = keep && !(edge_max_on(rec[3 * k], rec[3 * k + 1],
                                     rec[3 * k + 2], cx0, cx1, cy0, cy1)
                         < 0.0f);
    }
    // the kept steps in ascending order: list order
    for (unsigned bits = __ballot_sync(kFull, keep); bits;
         bits &= bits - 1) {
      const int j = __ffs(bits) - 1;
      float r[kRecWords];
#pragma unroll
      for (int k = 0; k < kRecWords; ++k)
        r[k] = __shfl_sync(kFull, rec[k], j);
      const float e0 = edge_eval(r[0], r[1], r[2], px, py);
      const float e1 = edge_eval(r[3], r[4], r[5], px, py);
      const float e2 = edge_eval(r[6], r[7], r[8], px, py);
      if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
      const int step = run + j;
      if (depth_test) {
        const float den = __fadd_rn(__fadd_rn(e0, e1), e2);
        const float denom = fabsf(den) > 1e-20f ? den : 1e-20f;
        const float b0 = __fdiv_rn(e0, denom);
        const float b1 = __fdiv_rn(e1, denom);
        const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
        const float zp = __fadd_rn(
            __fadd_rn(__fmul_rn(r[9], b0), __fmul_rn(r[10], b1)),
            __fmul_rn(r[11], b2));
        if (zp < best_z) {
          best_z = zp;
          best_s = step;
        }
      } else {
        best_s = step;              // the last covered step wins
      }
    }
  }
  const int q = (ly0 + (lane >> 3)) * ts + lx0 + (lane & (kPatchW - 1));
  out[(static_cast<size_t>(t) << (2 * tls)) + q] = best_s;
}

}  // namespace

// Launches the winner search on `stream` and returns cudaGetLastError()
// (0 = launched).  Pointers are device pointers: edges (P, 3, 3) and z
// (P, 3) float32, tile_pids (T, M) and origins (T, 2) int32, out
// (T, ts, ts) int32.  The caller validates shapes.
extern "C" int skybox_diff_visibility_hard(
    const void* edges, const void* z, const void* tile_pids,
    const void* origins, void* out, int T, int M, int tile_logsize,
    int depth_test, void* stream) {
  if (tile_logsize < 3 || tile_logsize > 6 || T <= 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int patches = 1 << (2 * tile_logsize - 5);   // 32 pixels each
  const int warps = patches < kWarps ? patches : kWarps;
  const dim3 grid(T, patches / warps);
  diff_visibility_kernel<<<grid, warps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(edges), static_cast<const float*>(z),
      static_cast<const int*>(tile_pids), static_cast<const int*>(origins),
      static_cast<int*>(out), M, tile_logsize, depth_test);
  return static_cast<int>(cudaGetLastError());
}
