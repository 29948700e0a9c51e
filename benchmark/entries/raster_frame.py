"""Iteration entry of the exact-integer raster configurations: one call of
the frame closure that ``skybox_rt_tpu_torch.ref.driver.compile_frame``
returns, in the traffic's mode (``deferred``: pass 1 is kernel #1 on the
card, pass 2 plain torch).

The configuration file names the captured trace (``trace``, under the
checkout's root); the traffic file the frame's size, the tile size, the
mode and the number of draws, which the trace must have.  The seed redraws
the trace's data alone (:func:`make_inputs`): every vertex colour and the
texture's texels.  Positions, triangles, states and the draws' order are
the capture's, so binning, coverage and the blended draw's slot count K
are the same for every seed.  Set-up runs compile_frame once (binning,
uploads and the one deferred frame that measures K), and fails at once on
a program whose frame functions open no ``raster.*`` stage, which the
cell's per-layer metrics read.  On the card it then renders frames for
CARD_WARMUP_S seconds: for a random 0 to 35 s after a process starts
rendering, an H100 adds about 0.34 us to each small kernel's launch (a
graph of 1,000 small adds 1.62 ms against 1.28 ms, large copies and a
matmul alike in both states), and this frame is some 6,400 small kernels,
12.3 ms a frame in that state against 10.1 ms after it.

A step's output is the frame's (H, W) int32 ARGB words on the device.  The
check renders the same frame with the plain reference
(benchmark/reference/raster_reference.py) from the same inputs and holds
the window's first and last output to it word for word: the path is exact.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import compare, harness
from ..reference import raster_reference

#: output words kernel #1 writes a pixel of an opaque draw: winner, dx, dy
#: (a blended draw's: K slots and the count)
OPAQUE_WORDS = 3
#: seconds of frames rendered at set-up on the card, past the slow launches
#: that start a process there (module docstring)
CARD_WARMUP_S = 20.0


def trace_path(config) -> str:
    return os.path.join(harness.ROOT, config["trace"])


def make_inputs(config, seed):
    """The data the seed redraws, numpy on the host: ``colors``, each draw's
    (V, 4) float32 vertex colours, uniform in [0, 1), the blended draws'
    alpha uniform in ``config["blend_alpha"]``; ``texels``, each texture's
    level-0 bytes, uniform.  The rest is the trace's."""
    draws, textures = raster_reference.load(trace_path(config))
    rng = np.random.default_rng([seed % 2 ** 64, 26])
    colors = []
    for d in draws:
        c = rng.uniform(0.0, 1.0, d.color.shape).astype(np.float32)
        if d.states["blend_enabled"]:
            lo, hi = config["blend_alpha"]
            c[:, 3] = rng.uniform(lo, hi, len(c)).astype(np.float32)
        colors.append(c)
    texels = {tid: rng.integers(0, 256, t.pixels.shape, dtype=np.uint8)
              for tid, t in sorted(textures.items())}
    return {"colors": colors, "texels": texels}


def reference_scene(config, inputs):
    """(draws, textures) of the reference's own reading of the trace, with
    the seed's data in place."""
    draws, textures = raster_reference.load(trace_path(config))
    draws = [dataclasses.replace(d, color=c)
             for d, c in zip(draws, inputs["colors"])]
    textures = {tid: dataclasses.replace(t, pixels=inputs["texels"][tid])
                for tid, t in textures.items()}
    return draws, textures


def program_trace(config, inputs):
    """The program's CGLTrace of the trace, with the seed's data in place."""
    from skybox_rt_tpu_torch.geom import cgltrace

    trace = cgltrace.load_trace(trace_path(config))
    trace.drawcalls = [dataclasses.replace(d, color=c) for d, c in
                       zip(trace.drawcalls, inputs["colors"])]
    for tid, t in trace.textures.items():
        trace.textures[tid] = dataclasses.replace(t,
                                                  pixels=inputs["texels"][tid])
    return trace


def reference(config, traffic, inputs, device, control=False):
    """The plain reference's (H, W) int32 frame (``control``: its float32
    control)."""
    draws, textures = reference_scene(config, inputs)
    return raster_reference.render(draws, textures, traffic["width"],
                                   traffic["height"], device, control)


def frame_numbers(got, want) -> dict:
    """``bad_px_pct``: 100 x the share of pixels whose 32-bit word differs;
    ``mean_abs_err``: the mean absolute channel difference, in units of
    1/255, over every pixel and its four channels."""
    if got.shape != want.shape:
        return {"bad_px_pct": 100.0, "mean_abs_err": float("inf")}
    g = got.to(torch.int64).reshape(-1) & 0xFFFFFFFF
    w = want.to(device=g.device, dtype=torch.int64).reshape(-1) & 0xFFFFFFFF
    diff = sum((((g >> s) & 0xFF) - ((w >> s) & 0xFF)).abs()
               for s in (0, 8, 16, 24))
    return {"bad_px_pct": float((g != w).double().mean()) * 100.0,
            "mean_abs_err": float(diff.double().mean()) / 4 / 255}


class Cell:
    def __init__(self, config, traffic, seed, device):
        from skybox_rt_tpu_torch.ref import driver
        from skybox_rt_tpu_torch.utils import tracing

        self.config, self.traffic, self.device = config, traffic, device
        self.inputs = make_inputs(config, seed)
        trace = program_trace(config, self.inputs)
        if len(trace.drawcalls) != traffic["draws"]:
            raise ValueError(f"the trace has {len(trace.drawcalls)} draws, "
                             f"the traffic {traffic['draws']}")
        self.tracing = tracing
        prepared = self.prepare_calls()
        t0 = time.perf_counter()
        self.frame, self.arrays = driver.compile_frame(
            trace, traffic["width"], traffic["height"],
            tile_logsize=traffic["tile_logsize"], mode=traffic["mode"],
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        #: host seconds of the compile_frame call (binning, uploads, the
        #: frame that measures the blend slots), ending in a synchronize
        self.prepare_s = time.perf_counter() - t0
        if self.prepare_calls() == prepared:
            raise RuntimeError(
                "the program's compile_frame opens no raster.prepare stage: "
                "it predates the raster stages that this cell's per-layer "
                "metrics read")
        if len(self.arrays) != len(trace.drawcalls):
            raise ValueError("a draw of the trace bins no triangle")
        if device.type == "cuda":
            end = time.perf_counter() + CARD_WARMUP_S
            while time.perf_counter() < end:
                self.frame(self.arrays)
                torch.cuda.synchronize(device)
        #: what the per-layer readers may use besides the trace; the check
        #: adds the blend slots to ``visibility``
        self.info = {"draws": draw_work(self.arrays, trace,
                                        traffic["tile_logsize"])}
        #: the blend slots a frame, from the program's counter
        #: ``raster.blend_slots`` around the first step
        self.frame_slots = None

    def prepare_calls(self):
        return self.tracing.stage_report().get("raster.prepare",
                                               {}).get("calls", 0)

    def blend_slots(self):
        return self.tracing.counter_report().get("raster.blend_slots", 0)

    def step(self):
        if self.frame_slots is None:
            before = self.blend_slots()
            out = self.frame(self.arrays)
            self.frame_slots = self.blend_slots() - before
            return out
        return self.frame(self.arrays)

    def release(self):
        self.frame = self.arrays = None

    def check(self, outputs):
        """The worst of frame_numbers over ``outputs``; kernel #1's work
        goes to ``info`` for the roofline."""
        k = self.info["blend_slots"] = self.frame_slots
        self.info["visibility"] = [
            [live, px, k + 1 if blended else OPAQUE_WORDS]
            for live, px, blended in self.info["draws"]]
        want = reference(self.config, self.traffic, self.inputs, self.device)
        return compare.worst([frame_numbers(o, want) for o in outputs])


def draw_work(arrays, trace, tile_logsize) -> list:
    """[live tile-list entries, pixels of the binned tiles, blended] of each
    draw, from the program's uploaded lists (one read-back at set-up)."""
    out = []
    for (_, dev_arrays), dc in zip(arrays, trace.drawcalls):
        pids = dev_arrays[3]
        out.append([int((pids >= 0).sum()),
                    pids.shape[0] << (2 * tile_logsize),
                    bool(dc.states.blend_enabled)])
    return out


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
