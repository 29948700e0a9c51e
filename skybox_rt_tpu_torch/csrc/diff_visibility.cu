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
// Design: one thread block per tile, one thread per pixel (a thread owns 4
// pixels at ts = 64).  The block walks tile_pids[t, 0:M] in order, staging
// chunks of (edges[pid], z[pid]) records in shared memory; each thread
// carries (best_z, best_step) of its pixels in registers.  The sequential
// loop is the tie rule: no atomics, no reduction across threads.
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
// What bounds it on the H100: per step a block reads one 48-byte record, so
// memory traffic is small (records once a tile, 4 bytes a pixel out); the
// bound is the serial M loop times the per-pixel float work (3 edge
// functions, 2 IEEE divides, the z plane).  Only T blocks run (T <= 1,024 at
// 1024x1024 with 32x32 tiles), each for M steps whatever its own count, so
// the longest pid list sets the time.  Splitting a tile's list across blocks
// is left to a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;          // prim records staged per chunk
constexpr int kRecWords = 12;       // 9 edge coefficients + 3 vertex depths
constexpr int kMaxThreads = 1024;
constexpr int kMaxPixPerThread = 4; // 64 * 64 pixels / 1024 threads

__device__ __forceinline__ float edge_eval(const float* r, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)), r[2]);
}

__global__ void __launch_bounds__(kMaxThreads)
diff_visibility_kernel(const float* __restrict__ edges,   // (P, 3, 3)
                       const float* __restrict__ z,       // (P, 3)
                       const int* __restrict__ tile_pids, // (T, M), -1 padded
                       const int* __restrict__ origins,   // (T, 2) pixels
                       int* __restrict__ out,             // (T, ts, ts)
                       int M, int tls, int depth_test) {
  __shared__ float s_rec[kChunk][kRecWords];
  __shared__ int s_pid[kChunk];

  const int t = blockIdx.x;
  const int ts = 1 << tls;
  const int npix = ts * ts;
  const int nthr = blockDim.x;
  const int ppt = npix / nthr;
  const int ox = origins[2 * t];
  const int oy = origins[2 * t + 1];

  float px[kMaxPixPerThread], py[kMaxPixPerThread];
  float best_z[kMaxPixPerThread];
  int best_s[kMaxPixPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPixPerThread; ++k) {
    const int q = threadIdx.x + k * nthr;
    px[k] = __int2float_rn(ox + (q & (ts - 1)));
    py[k] = __int2float_rn(oy + (q >> tls));
    best_z[k] = __int_as_float(0x7f800000);     // +inf
    best_s[k] = -1;
  }

  for (int base = 0; base < M; base += kChunk) {
    const int n = min(kChunk, M - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += nthr) {
      const int pid = tile_pids[static_cast<size_t>(t) * M + base + i];
      s_pid[i] = pid;
      if (pid >= 0) {
        for (int j = 0; j < 9; ++j)
          s_rec[i][j] = edges[static_cast<size_t>(pid) * 9 + j];
        for (int j = 0; j < 3; ++j)
          s_rec[i][9 + j] = z[static_cast<size_t>(pid) * 3 + j];
      }
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      if (s_pid[i] < 0) continue;   // padding: never covers, never writes
      const float* r = s_rec[i];
      const int step = base + i;
#pragma unroll
      for (int k = 0; k < kMaxPixPerThread; ++k) {
        if (k >= ppt) continue;
        const float e0 = edge_eval(r + 0, px[k], py[k]);
        const float e1 = edge_eval(r + 3, px[k], py[k]);
        const float e2 = edge_eval(r + 6, px[k], py[k]);
        if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
        if (depth_test) {
          const float den = __fadd_rn(__fadd_rn(e0, e1), e2);
          const float denom = fabsf(den) > 1e-20f ? den : 1e-20f;
          const float b0 = __fdiv_rn(e0, denom);
          const float b1 = __fdiv_rn(e1, denom);
          const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
          const float zp = __fadd_rn(
              __fadd_rn(__fmul_rn(r[9], b0), __fmul_rn(r[10], b1)),
              __fmul_rn(r[11], b2));
          if (zp < best_z[k]) {
            best_z[k] = zp;
            best_s[k] = step;
          }
        } else {
          best_s[k] = step;         // the last covered step wins
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxPixPerThread; ++k) {
    if (k < ppt)
      out[static_cast<size_t>(t) * npix + threadIdx.x + k * nthr] = best_s[k];
  }
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
  const int npix = 1 << (2 * tile_logsize);
  const int nthr = npix < kMaxThreads ? npix : kMaxThreads;
  diff_visibility_kernel<<<T, nthr, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(edges), static_cast<const float*>(z),
      static_cast<const int*>(tile_pids), static_cast<const int*>(origins),
      static_cast<int*>(out), M, tile_logsize, depth_test);
  return static_cast<int>(cudaGetLastError());
}
