"""Drive the PyTorch port's draw3d frame on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line; any mismatch raises, so the script
exits non-zero, and only a run where every phase passed prints the final
``{"ok": true, ...}`` line:

  1. device  — needs torch.cuda; prints nvidia-smi's name and power limit
  2. build   — compiles skybox_rt_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  3. kernel  — the CUDA visibility kernel against its plain torch version,
               bit for bit: every draw of the synthetic trace at 256x256,
               fused and K-slot, tile_logsize 3..6, stencil/depth OM
               variants over seeded ds words, and the textured draw at
               1024x1024
  4. frame   — the 256x256 frame through render_trace and compile_frame,
               bit-equal to the JAX package's committed framebuffer and to
               the port's immediate oracle on the card; the kernel's launch
               count on that run is checked
  5. draw1024 — the textured draw alone at 1024x1024 against its
               committed sha256
  6. timing  — CUDA events, median of 20 after warm-up: kernel vs plain
               pass 1 at 256x256 and 1024x1024, and the whole 256x256 frame

The script imports no JAX: the references it checks against are committed
files (skybox_rt_tpu_torch/data/).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, REPS = 3, 20
SIZE = 256
TEXTURED_DRAW = 1


def phase(name, **fields):
    torch.cuda.synchronize()        # a fault in the phase surfaces here
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median over `reps` of one call of fn, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all outputs (u32 words compared as
    their 32-bit patterns); raises unless the outputs are bit-equal."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"kernel != plain version, max |diff| {err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    dev = torch.device("cuda")
    card = nvidia_smi()
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)

    sys.path.insert(0, REPO)
    from skybox_rt_tpu_torch import _build
    from skybox_rt_tpu_torch.core import fixed
    from skybox_rt_tpu_torch.core.state import RenderState
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.om.depth_stencil import DepthStencilState
    from skybox_rt_tpu_torch.om.merger import OMState
    from skybox_rt_tpu_torch.ops import cuda_raster, deferred
    from skybox_rt_tpu_torch.ref import driver

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    with open(lib_path + ".log") as f:
        log = f.read().splitlines()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=os.path.relpath(lib_path, REPO), nvcc=log[0],
          ptxas=[ln.strip() for ln in log
                 if "registers" in ln or "spill" in ln])

    trace_file = cgltrace.trace_path("synth_draw3d")

    def draw_inputs(width, height, tls, d):
        trace = cgltrace.load_trace(trace_file)
        rs, texels, b = driver.prepare_drawcalls(trace, width, height, tls,
                                                 device=dev)[d]
        edges, attribs, zattr, tile_pids, tile_xy = \
            deferred.device_arrays(b, dev)
        T = tile_pids.shape[0]
        ts = 1 << tls
        fbd = torch.full((T, ts, ts), -1, dtype=torch.int32, device=dev)
        return rs, (edges, zattr, tile_pids, tile_xy, fbd), b

    def compare(rs, args, tls, K):
        got = cuda_raster.visibility_tiles(rs, *args, tls, fused=K == 0,
                                           blend_slots=K)
        want = cuda_raster.visibility_tiles_reference(
            rs, *args, tls, fused=K == 0, blend_slots=K)
        torch.cuda.synchronize()
        return max_abs_err(got, want)

    # 3. kernel vs plain version
    err, cases = 0, 0
    for d in range(4):
        for tls in cuda_raster.TILE_LOGSIZES:
            rs, args, b = draw_inputs(SIZE, SIZE, tls, d)
            for K in (0, 4, 16):
                err = max(err, compare(rs, args, tls, K))
                cases += 1
    # OM variants over the stencil draw's geometry and seeded ds words:
    # every compare func and stencil op reaches the kernel's ds test
    rs3, args3, _ = draw_inputs(SIZE, SIZE, 5, 3)
    rng = np.random.default_rng(0)
    fbd = rng.integers(0, 2**32, size=tuple(args3[4].shape), dtype=np.uint64)
    args3 = args3[:4] + (fixed.from_numpy_u32(fbd, device=dev),)
    for f in range(8):
        ds = DepthStencilState(
            depth_func=(f + 3) % 8, depth_writemask=f % 2 == 0,
            stencil_front_func=f, stencil_front_zpass=f,
            stencil_front_zfail=(f + 3) % 8, stencil_front_fail=(f + 5) % 8,
            stencil_front_ref=0x2A + f, stencil_front_mask=0xF0 >> (f % 4),
            stencil_back_func=0, stencil_back_zpass=0, stencil_back_zfail=0,
            stencil_back_fail=0, stencil_back_ref=0, stencil_back_mask=0xFF)
        om = OMState(ds=ds, blend=rs3.om.blend, depth_writemask=f % 3 != 0,
                     stencil_front_writemask=(0xFF, 0x3C, 0)[f % 3],
                     stencil_back_writemask=0, cbuf_writemask4=0xF)
        rs = RenderState(flags=rs3.flags, om=om, tex=None,
                         scissor=(3, 5, SIZE - 7, SIZE - 2))
        for K in (0, 4):
            err = max(err, compare(rs, args3, 5, K))
            cases += 1
    rs1k, args1k, b1k = draw_inputs(1024, 1024, 5, TEXTURED_DRAW)
    for K in (0, 4):
        err = max(err, compare(rs1k, args1k, 5, K))
        cases += 1
    phase("kernel_vs_plain", cases=cases, max_abs_err=err, equal=True)

    # 4. the frame through the port's entry points
    with np.load(os.path.join(cgltrace.DATA_DIR,
                              "synth_draw3d_256.npz")) as z:
        golden = z["color"]
    trace = cgltrace.load_trace(trace_file)
    cuda_raster.reset_launch_count()
    fb = driver.render_trace(trace, SIZE, SIZE, mode="deferred", device=dev)
    launches = cuda_raster.launch_count
    ks = trace._blend_k_cache[(SIZE, SIZE, 5)]
    draws = len(ks)
    retries = sum(1 for k in ks.values()
                  if k > deferred.DEFAULT_BLEND_SLOTS)
    if not np.array_equal(fb, golden):
        raise AssertionError(f"render_trace != JAX framebuffer: "
                             f"{int((fb != golden).sum())} pixels differ")
    if launches != draws + retries or launches == 0:
        raise AssertionError(f"kernel launches {launches} != draws {draws} "
                             f"+ blend retries {retries}")
    cuda_raster.reset_launch_count()
    cached = driver.render_trace(trace, SIZE, SIZE, mode="deferred",
                                 device=dev)
    cached_launches = cuda_raster.launch_count
    frame, arrays = driver.compile_frame(trace, SIZE, SIZE, mode="deferred",
                                         device=dev)
    cuda_raster.reset_launch_count()
    framed = fixed.to_numpy_u32(frame(arrays))
    frame_launches = cuda_raster.launch_count
    immediate = driver.render_trace(trace, SIZE, SIZE, mode="immediate",
                                    device=dev)
    for name, img in (("cached", cached), ("compile_frame", framed),
                      ("immediate", immediate)):
        if not np.array_equal(img, golden):
            raise AssertionError(f"{name} frame != JAX framebuffer")
    if cached_launches != draws or frame_launches != draws:
        raise AssertionError(f"cached/compiled frames launched "
                             f"{cached_launches}/{frame_launches}, "
                             f"expected {draws}")
    phase("frame", size=SIZE, draws=draws, blend_k=ks, launches=launches,
          cached_launches=cached_launches, compile_frame_launches=
          frame_launches, equal_to_jax_golden=True, equal_to_immediate=True,
          non_clear_pixels=int((fb != driver.CLEAR_COLOR).sum()))

    # 5. the textured draw alone at 1024x1024
    with open(os.path.join(cgltrace.DATA_DIR, "synth_draw1024.json")) as f:
        want1k = json.load(f)
    rs, texels, b = driver.prepare_drawcalls(
        cgltrace.load_trace(trace_file), 1024, 1024, device=dev)[TEXTURED_DRAW]
    fbc, fbd = driver.clear_framebuffers(1024, 1024, 5, dev)
    c, dsb = deferred.render_drawcall(rs, texels, b, fbc, fbd)
    c, dsb = fixed.to_numpy_u32(c), fixed.to_numpy_u32(dsb)
    got1k = {"color_sha256": hashlib.sha256(c.tobytes()).hexdigest(),
             "ds_sha256": hashlib.sha256(dsb.tobytes()).hexdigest(),
             "non_clear_pixels": int((c != driver.CLEAR_COLOR).sum())}
    for k, v in got1k.items():
        if want1k[k] != v:
            raise AssertionError(f"draw1024 {k}: {v} != {want1k[k]}")
    phase("draw1024", **got1k, equal=True)

    # 6. timing (printed, not judged)
    timings = {}
    for label, (rs, args, b, tls) in {
            "pass1_256": draw_inputs(SIZE, SIZE, 5, TEXTURED_DRAW) + (5,),
            "pass1_1024": (rs1k, args1k, b1k, 5)}.items():
        k_ms = median_ms(lambda: cuda_raster.visibility_tiles(
            rs, *args, tls, fused=True))
        p_ms = median_ms(lambda: cuda_raster.visibility_tiles_reference(
            rs, *args, tls, fused=True), reps=5, warmup=1)
        T, M = b.tile_pids.shape
        timings[label] = {"kernel_ms": k_ms, "plain_ms": p_ms, "T": T,
                          "M": M, "pixels": T << (2 * tls),
                          "kernel_mpix_per_s": (T << (2 * tls)) / k_ms / 1e3}
    frame_ms = median_ms(lambda: frame(arrays))
    timings["frame_256"] = {
        "ms": frame_ms, "draws": draws,
        "mpix_per_s": SIZE * SIZE * draws / frame_ms / 1e3}
    phase("timing", card=card, reps=REPS, **timings)

    print(card)
    p256 = timings["pass1_256"]
    print(json.dumps({"kernels": [{
        "name": "raster_visibility", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/raster_visibility.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_raster.py:63",
        "launches": launches, "max_abs_err": err,
        "ms": p256["kernel_ms"], "plain_ms": p256["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
