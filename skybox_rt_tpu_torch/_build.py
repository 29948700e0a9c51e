"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds.  Each source is compiled by an ``nvcc`` of its own, all
started together, and the objects are linked into one library.  It lands in
``skybox_rt_tpu_torch/_build/`` and is keyed by a hash of the sources and
flags, so an edited source rebuilds.  Flags keep IEEE float32 division and no
FMA contraction, which the exact-int raster path (csrc/raster_visibility.cu),
the ray queries' agreement with their plain versions (csrc/rt_bvh.cu,
csrc/rt_clustered.cu, csrc/rt_streamed.cu) and the hit shading's
(csrc/rt_shade.cu), the float visibility's
(csrc/diff_visibility.cu), slot shading's (csrc/diff_shade.cu) and
triangle set-up's (csrc/diff_prim.cu), the row accumulation's pinned sum
order
(csrc/diff_accumulate.cu) and the matrix product's pinned arithmetic
(csrc/apps_sgemm.cu, whose fused multiply-adds are explicit __fmaf_rn)
need; fast math is never used.  The host binning
engine (csrc/binning.cpp) is built by g++, not here: geom/native.py.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libskybox_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-prec-div=true", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # 11 tensor pointers, 21 ints, the stream
    "skybox_visibility_tiles": [_P] * 11 + [_I] * 21 + [_P],
    # o d tmax tri s2p aabb leaf_range leaf_table, host level_off
    # level_cnt, num_levels, t_min, R, prim t u v, the stream
    "skybox_rt_closest_hit_bvh": [_P] * 10 + [_I, _F, _I] + [_P] * 5,
    # o d tmax tlo slo tri s2p aabb leaf_range leaf_table, host level_off
    # level_cnt, num_levels, t_min, R, slot prim t u v, the stream
    "skybox_rt_closest_hit_bvh_after": [_P] * 12 + [_I, _F, _I] + [_P] * 6,
    # o d tmax tri aabb leaf_range leaf_table, host level_off level_cnt,
    # num_levels, t_min, R, occ, the stream
    "skybox_rt_any_hit_bvh": [_P] * 9 + [_I, _F, _I] + [_P] * 2,
    # o d tmax tri table visit group_table group_visit order, C, G, t_min,
    # R, prim t u v, the stream
    "skybox_rt_closest_hit_clustered": [_P] * 9 + [_I, _I, _F, _I]
                                       + [_P] * 5,
    # o d tmax tri table visit group_table group_visit, C, G, t_min, R,
    # occ, the stream
    "skybox_rt_any_hit_clustered": [_P] * 8 + [_I, _I, _F, _I] + [_P] * 2,
    # o d tmax tri, P, t_min, R, prim t u v, the stream
    "skybox_rt_closest_hit_flat": [_P] * 4 + [_I, _F, _I] + [_P] * 5,
    # o d tmax tri aabb order, NB P tri_block, t_min, R, lane_switch,
    # prim t u v, the stream
    "skybox_rt_closest_hit_streamed": [_P] * 6 + [_I, _I, _I, _F, _I, _I]
                                      + [_P] * 5,
    # o d tmax tri aabb order lists counts, NB P tri_block, t_min, R,
    # lane_switch, prim t u v, the stream
    "skybox_rt_closest_hit_worklist": [_P] * 8 + [_I, _I, _I, _F, _I, _I]
                                      + [_P] * 5,
    # o d tmax aabb, NB R front_to_back, lists counts, the stream
    "skybox_rt_active_block_lists": [_P] * 4 + [_I] * 3 + [_P] * 3,
    # o d prim t u v rec tex, rec_width TH TW, ambient, light_dir (3),
    # light_color (3), park (3), offset, R, pt n hit rgb dark sh_o sh_d, the
    # stream
    "skybox_rt_shade_hits": [_P] * 8 + [_I] * 3 + [_F] * 11 + [_I]
                            + [_P] * 8,
    # edges z tile_pids origins out, T M tile_logsize depth_test, the stream
    "skybox_diff_visibility_hard": [_P] * 5 + [_I] * 4 + [_P],
    # idx val scratch out, N R C S L max_long, the scratch's words, the
    # stream
    "skybox_diff_accumulate_rows": [_P] * 4 + [_I] * 7 + [_P],
    # rec tile_pids texq steps origins out, T M C tile_logsize TH TW
    # modulate, the background (4), the stream
    "skybox_diff_shade_forward": [_P] * 6 + [_I] * 7 + [_F] * 4 + [_P],
    # rec tile_pids texq steps origins grad grec rows anchor, T M C
    # tile_logsize TH TW modulate, the stream
    "skybox_diff_shade_backward": [_P] * 9 + [_I] * 7 + [_P],
    # pos color uv indices rec z corner, P V, hw hh hd zo, the stream
    "skybox_diff_prim_forward": [_P] * 7 + [_I] * 2 + [_F] * 4 + [_P],
    # pos indices grec dpos dcol duv, P V, hw hh, the stream
    "skybox_diff_prim_backward": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_P],
    # a b c, m n k, the stream
    "skybox_apps_sgemm": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{LIB_NAME}_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME:
        return os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> str:
    """Compile ``csrc/*.cu`` unless the hashed library exists; returns its
    path.  One nvcc per source runs at the same time, then one links the
    objects.  nvcc's reports (registers, stack frame, spills from
    -Xptxas -v) are kept beside the library as ``<lib>.log``, the link
    command on the first line.  Raises with nvcc's stderr on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, stderr)
    link = [nvcc, "-shared", "-o", f"{tmp}.so", *(obj for _, obj, _ in jobs)]
    if failed is None:
        res = subprocess.run(link, capture_output=True, text=True)
        log.insert(0, " ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed = (res.returncode, link, res.stderr)
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        rc, cmd, stderr = failed
        sys.stderr.write(stderr)
        raise RuntimeError(f"nvcc failed (rc {rc}): {' '.join(cmd)}\n"
                           f"{stderr}")
    with open(out + ".log", "w") as f:
        f.write("".join(log))
    os.replace(f"{tmp}.so", out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
