// Native host binning engine — the C++ fast path for the per-frame
// host hot loop (the analog of the reference's host-side
// graphics::Binning, sim/common/gfxutil.cpp:35-276, which runs as native
// C++ inside the draw3d host).
//
// The port's own copy of the JAX package's native/binning.cpp, built by
// skybox_rt_tpu_torch/geom/native.py with g++ (-O3 -ffp-contract=off
// -fno-fast-math) into the port's build directory.
//
// Semantics are bit-identical to skybox_rt_tpu_torch/geom/binning.py's
// bin_drawcall_py: all float math is strict IEEE float32 (no FMA
// contraction changes results), float->fixed conversions truncate toward
// zero with int32 wraparound, and tile keys iterate in (tx, ty)
// lexicographic order exactly like std::map<pair> / Python sorted().
//
// C ABI (consumed by skybox_rt_tpu_torch/geom/native.py via ctypes):
//   sb_bin_drawcall(...) -> sb_binned*   (NULL when nothing survives)
//   sb_free_binned(sb_binned*)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

namespace {

inline int32_t to_fixed(float x, int frac) {
  // trunc toward zero, then wrap to int32 (matches numpy
  // trunc->int64->int32 in core/fixed.py to_fixed_np)
  float scaled = x * (float)(1u << frac);
  long long v = (long long)truncf(scaled);
  return (int32_t)(uint32_t)(uint64_t)v;
}

struct Vec4 {
  float x, y, z, w;
};

inline Vec4 clip_to_hdc(const float* p, float left, float top, float near_,
                        float half_w, float half_h, float half_d) {
  Vec4 o;
  o.x = p[0] * half_w + p[3] * (left + half_w);
  o.y = p[1] * half_h + p[3] * (top + half_h);
  o.z = p[2] * half_d + p[3] * (near_ + half_d);
  o.w = p[3];
  return o;
}

inline Vec4 clip_to_screen(const float* p, float left, float top, float near_,
                           float half_w, float half_h, float half_d) {
  float rhw = 1.0f / p[3];
  Vec4 o;
  o.x = p[0] * rhw * half_w + (left + half_w);
  o.y = p[1] * rhw * half_h + (top + half_h);
  o.z = p[2] * rhw * half_d + (near_ + half_d);
  o.w = rhw;
  return o;
}

}  // namespace

extern "C" {

struct sb_binned {
  int32_t num_prims;
  int32_t num_tiles;
  int32_t max_ppt;       // padded prims-per-tile (M)
  int32_t* edges;        // (P, 3, 3) fixed16
  int32_t* attribs;      // (P, 7, 3) fixed24
  int32_t* tile_xy;      // (T, 2)
  int32_t* tile_pids;    // (T, M), -1 padded
  int32_t* tile_counts;  // (T,)
};

void sb_free_binned(sb_binned* b) {
  if (!b) return;
  free(b->edges);
  free(b->attribs);
  free(b->tile_xy);
  free(b->tile_pids);
  free(b->tile_counts);
  free(b);
}

sb_binned* sb_bin_drawcall(const float* pos, int32_t /*num_verts*/,
                           const int32_t* indices, int32_t num_prims,
                           const float* colors, const float* texcoords,
                           int32_t width, int32_t height, float near_,
                           float far_, int32_t tile_logsize,
                           int32_t pad_multiple) {
  if (num_prims <= 0) return nullptr;

  const float left = 0.0f, top = 0.0f;
  const float half_w = 0.5f * ((float)width - left);
  const float half_h = 0.5f * ((float)height - top);
  const float half_d = 0.5f * (far_ - near_);

  std::vector<int32_t> edges_out;   // kept * 9
  std::vector<int32_t> attribs_out; // kept * 21
  std::vector<int64_t> bb;          // kept * 4: l, r, t, b

  edges_out.reserve((size_t)num_prims * 9);
  attribs_out.reserve((size_t)num_prims * 21);

  for (int32_t p = 0; p < num_prims; ++p) {
    const int32_t i0 = indices[p * 3 + 0];
    const int32_t i1 = indices[p * 3 + 1];
    const int32_t i2 = indices[p * 3 + 2];
    const float* v0 = pos + (size_t)i0 * 4;
    const float* v1 = pos + (size_t)i1 * 4;
    const float* v2 = pos + (size_t)i2 * 4;

    Vec4 h0 = clip_to_hdc(v0, left, top, near_, half_w, half_h, half_d);
    Vec4 h1 = clip_to_hdc(v1, left, top, near_, half_w, half_h, half_d);
    Vec4 h2 = clip_to_hdc(v2, left, top, near_, half_w, half_h, half_d);

    // edge-equation matrix (gfxutil.cpp:35-75)
    float a0 = (h1.y * h2.w) - (h2.y * h1.w);
    float a1 = (h2.y * h0.w) - (h0.y * h2.w);
    float a2 = (h0.y * h1.w) - (h1.y * h0.w);
    float b0 = (h2.x * h1.w) - (h1.x * h2.w);
    float b1 = (h0.x * h2.w) - (h2.x * h0.w);
    float b2 = (h1.x * h0.w) - (h0.x * h1.w);
    float c0 = (h1.x * h2.y) - (h2.x * h1.y);
    float c1 = (h2.x * h0.y) - (h0.x * h2.y);
    float c2 = (h0.x * h1.y) - (h1.x * h0.y);
    float det = (c0 * h0.w + c1 * h1.w) + c2 * h2.w;
    if (det == 0.0f) continue;
    float e[3][3] = {{a0, b0, c0}, {a1, b1, c1}, {a2, b2, c2}};
    if (det < 0.0f) {
      for (auto& row : e)
        for (float& v : row) v *= -1.0f;
    }

    Vec4 s0 = clip_to_screen(v0, left, top, near_, half_w, half_h, half_d);
    Vec4 s1 = clip_to_screen(v1, left, top, near_, half_w, half_h, half_d);
    Vec4 s2 = clip_to_screen(v2, left, top, near_, half_w, half_h, half_d);

    float xmin = fminf(fminf(s0.x, s1.x), s2.x);
    float xmax = fmaxf(fmaxf(s0.x, s1.x), s2.x);
    float ymin = fminf(fminf(s0.y, s1.y), s2.y);
    float ymax = fmaxf(fmaxf(s0.y, s1.y), s2.y);
    int64_t bl = (int64_t)floorf(xmin); if (bl < 0) bl = 0;
    int64_t br = (int64_t)ceilf(xmax);  if (br > width) br = width;
    int64_t bt = (int64_t)floorf(ymin); if (bt < 0) bt = 0;
    int64_t bo = (int64_t)ceilf(ymax);  if (bo > height) bo = height;
    if (!(br > bl && bo > bt)) continue;

    // half-pixel offset (gfxutil.cpp:211-214)
    for (auto& row : e) row[2] = row[2] + (row[0] * 0.5f + row[1] * 0.5f);

    // normalize + fixed16 (gfxutil.cpp:79-96)
    float max_ab = 0.0f;
    for (auto& row : e) {
      max_ab = fmaxf(max_ab, fabsf(row[0]));
      max_ab = fmaxf(max_ab, fabsf(row[1]));
    }
    float scale = 1.0f / max_ab;
    for (auto& row : e)
      for (float v : {row[0] * scale, row[1] * scale, row[2] * scale})
        edges_out.push_back(to_fixed(v, 16));

    // attribute planes (gfxutil.cpp:204-230): z, r, g, b, a, u, v
    const float* c0p = colors + (size_t)i0 * 4;
    const float* c1p = colors + (size_t)i1 * 4;
    const float* c2p = colors + (size_t)i2 * 4;
    const float* t0p = texcoords + (size_t)i0 * 2;
    const float* t1p = texcoords + (size_t)i1 * 2;
    const float* t2p = texcoords + (size_t)i2 * 2;
    const float av0[7] = {s0.z, c0p[0], c0p[1], c0p[2], c0p[3], t0p[0], t0p[1]};
    const float av1[7] = {s1.z, c1p[0], c1p[1], c1p[2], c1p[3], t1p[0], t1p[1]};
    const float av2[7] = {s2.z, c2p[0], c2p[1], c2p[2], c2p[3], t2p[0], t2p[1]};
    for (int k = 0; k < 7; ++k) {
      attribs_out.push_back(to_fixed(av0[k] - av2[k], 24));
      attribs_out.push_back(to_fixed(av1[k] - av2[k], 24));
      attribs_out.push_back(to_fixed(av2[k], 24));
    }

    bb.push_back(bl);
    bb.push_back(br);
    bb.push_back(bt);
    bb.push_back(bo);
  }

  const int32_t kept = (int32_t)(bb.size() / 4);
  if (kept == 0) return nullptr;

  // tile coverage (gfxutil.cpp:236-250); (tx, ty)-ordered map, pid lists
  // keep submission order
  const int64_t ts = 1 << tile_logsize;
  std::map<std::pair<int32_t, int32_t>, std::vector<int32_t>> tiles;
  for (int32_t p = 0; p < kept; ++p) {
    int64_t tmin_x = bb[p * 4 + 0] >> tile_logsize;
    int64_t tmax_x = (bb[p * 4 + 1] + ts - 1) >> tile_logsize;
    int64_t tmin_y = bb[p * 4 + 2] >> tile_logsize;
    int64_t tmax_y = (bb[p * 4 + 3] + ts - 1) >> tile_logsize;
    for (int64_t ty = tmin_y; ty < tmax_y; ++ty)
      for (int64_t tx = tmin_x; tx < tmax_x; ++tx)
        tiles[{(int32_t)tx, (int32_t)ty}].push_back(p);
  }

  const int32_t T = (int32_t)tiles.size();
  size_t max_ppt = 0;
  for (auto& kv : tiles) max_ppt = std::max(max_ppt, kv.second.size());
  const int32_t M =
      (int32_t)((max_ppt + pad_multiple - 1) / pad_multiple) * pad_multiple;

  sb_binned* out = (sb_binned*)calloc(1, sizeof(sb_binned));
  out->num_prims = kept;
  out->num_tiles = T;
  out->max_ppt = M;
  out->edges = (int32_t*)malloc((size_t)kept * 9 * 4);
  out->attribs = (int32_t*)malloc((size_t)kept * 21 * 4);
  out->tile_xy = (int32_t*)malloc((size_t)T * 2 * 4);
  out->tile_pids = (int32_t*)malloc((size_t)T * M * 4);
  out->tile_counts = (int32_t*)malloc((size_t)T * 4);
  memcpy(out->edges, edges_out.data(), (size_t)kept * 9 * 4);
  memcpy(out->attribs, attribs_out.data(), (size_t)kept * 21 * 4);

  int32_t t = 0;
  for (auto& kv : tiles) {
    out->tile_xy[t * 2 + 0] = kv.first.first;
    out->tile_xy[t * 2 + 1] = kv.first.second;
    out->tile_counts[t] = (int32_t)kv.second.size();
    int32_t* row = out->tile_pids + (size_t)t * M;
    size_t i = 0;
    for (; i < kv.second.size(); ++i) row[i] = kv.second[i];
    for (; i < (size_t)M; ++i) row[i] = -1;
    ++t;
  }
  return out;
}

}  // extern "C"
