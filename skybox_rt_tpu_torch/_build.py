"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds.  The library lands in ``skybox_rt_tpu_torch/_build/`` and is
keyed by a hash of the sources and flags, so an edited source rebuilds.
Flags keep IEEE float32 division and no FMA contraction, which the exact-int
raster path needs (csrc/raster_visibility.cu); fast math is never used.
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
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# skybox_visibility_tiles: 11 tensor pointers, 21 ints, the stream
_SIGNATURES = {
    "skybox_visibility_tiles": [_P] * 11 + [_I] * 21 + [_P],
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
    path.  nvcc's report (registers, shared memory, spills from -Xptxas -v)
    is kept beside it as ``<lib>.log``.  Raises with nvcc's stderr on
    failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.stderr.write(res.stderr)
        raise RuntimeError(f"nvcc failed (rc {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}")
    with open(out + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
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
