"""ctypes bindings for the port's native C++ binning engine
(``csrc/binning.cpp``).

Counterpart of skybox_rt_tpu.geom.native.  The reference's host pipeline is
native C++ (graphics::Binning runs inside the draw3d host process); this
module keeps that tier, with the numpy ``geom.binning.bin_drawcall_py`` as
the oracle it is held to bit for bit.  The library is built at first use
with g++ and the JAX package's flags (``-O3 -ffp-contract=off
-fno-fast-math``, so float32 results stay those of numpy) into
``skybox_rt_tpu_torch/_build/``, keyed by a hash of the source and flags:
an edited source rebuilds.  It is compiled under a temporary name and moved
into place, so processes that build at once do not see half a library.

Departures from the JAX module: a failed build or load raises with g++'s
error (the JAX module falls back to numpy without a word); the only way to
numpy is the explicit ``SKYBOX_NATIVE=0`` that ``geom.binning.bin_drawcall``
reads.  :func:`bin_drawcall_native` returns None when no primitive survives
(JAX: the string ``"empty"``), and rejects vertex indices outside the vertex
arrays instead of reading past them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .. import _build

SRC = os.path.join(_build.SRC_DIR, "binning.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-fno-fast-math")
LIB_NAME = "libskybox_torch_native"

_lock = threading.Lock()
_lib = None


class _SbBinned(ctypes.Structure):
    _fields_ = [
        ("num_prims", ctypes.c_int32),
        ("num_tiles", ctypes.c_int32),
        ("max_ppt", ctypes.c_int32),
        ("edges", ctypes.POINTER(ctypes.c_int32)),
        ("attribs", ctypes.POINTER(ctypes.c_int32)),
        ("tile_xy", ctypes.POINTER(ctypes.c_int32)),
        ("tile_pids", ctypes.POINTER(ctypes.c_int32)),
        ("tile_counts", ctypes.POINTER(ctypes.c_int32)),
    ]


def library_path(src: str | None = None) -> str:
    """Where the library of ``src`` (default: csrc/binning.cpp) lands: a
    name keyed by the hash of the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src or SRC, "rb") as f:
        h.update(f.read())
    name = f"{LIB_NAME}_{h.hexdigest()[:16]}.so"
    return os.path.join(_build.BUILD_DIR, name)


def build(src: str | None = None) -> str:
    """Compile ``src`` (default: csrc/binning.cpp) unless the hashed library
    exists; returns its path.  Raises RuntimeError with g++'s stderr."""
    src = src or SRC
    out = library_path(src)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed (rc {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed and load the binning library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.sb_bin_drawcall.restype = ctypes.POINTER(_SbBinned)
            lib.sb_bin_drawcall.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
            ]
            lib.sb_free_binned.argtypes = [ctypes.POINTER(_SbBinned)]
            lib.sb_free_binned.restype = None
            _lib = lib
    return _lib


def _as_array(ptr, shape):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(shape).copy()


def bin_drawcall_native(pos, indices, colors, texcoords, width, height,
                        near, far, tile_logsize, pad_multiple):
    """Native-path binning: (edges (P,3,3), attribs (P,7,3), tile_xy (T,2),
    tile_pids (T,M), tile_counts (T,)) as int32 arrays, the fields
    ``bin_drawcall_py`` assembles, or None when no primitive survives."""
    pos = np.ascontiguousarray(pos, np.float32)
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1, 3)
    colors = np.ascontiguousarray(colors, np.float32)
    texcoords = np.ascontiguousarray(texcoords, np.float32)
    if indices.size == 0:
        return None
    nv = min(pos.shape[0], colors.shape[0], texcoords.shape[0])
    if indices.min() < 0 or indices.max() >= nv:
        raise IndexError(f"vertex index out of [0, {nv})")
    lib = load_library()
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    res = lib.sb_bin_drawcall(
        pos.ctypes.data_as(fp), pos.shape[0],
        indices.ctypes.data_as(ip), indices.shape[0],
        colors.ctypes.data_as(fp), texcoords.ctypes.data_as(fp),
        int(width), int(height), float(np.float32(near)),
        float(np.float32(far)), int(tile_logsize), int(pad_multiple))
    if not res:
        return None
    try:
        b = res.contents
        P, T, M = b.num_prims, b.num_tiles, b.max_ppt
        return (
            _as_array(b.edges, (P, 3, 3)),
            _as_array(b.attribs, (P, 7, 3)),
            _as_array(b.tile_xy, (T, 2)),
            _as_array(b.tile_pids, (T, M)),
            _as_array(b.tile_counts, (T,)),
        )
    finally:
        lib.sb_free_binned(res)
