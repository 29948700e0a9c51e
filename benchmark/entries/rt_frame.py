"""Iteration entry of the ray-traced configurations: one call of the frame
closure that ``skybox_rt_tpu_torch.rt.tracer.make_frame_fn`` returns.

The configuration file gives the scene (``sphere_field``, ``texture``,
``reflectivity``), the camera, the shading constants and the engine; the
traffic file the image size, the bounces and whether shadows are traced.
The image stays on the device.  The check renders the same frame with the
plain reference (benchmark/reference/rt_reference.py) from the same inputs.
"""
from __future__ import annotations

import time

import torch

from .. import compare, scenes
from ..reference import rt_reference


class Cell:
    def __init__(self, config, traffic, seed, device):
        from skybox_rt_tpu_torch.rt import tracer

        self.config, self.traffic, self.device = config, traffic, device
        self.inputs = make_inputs(config, seed)
        cam, shade = config["camera"], config["shading"]
        textured = config.get("texture") is not None
        scene = tracer.RTScene(
            verts=self.inputs["verts"], faces=self.inputs["faces"],
            colors=self.inputs["colors"], uvs=self.inputs["uvs"],
            texture=self.inputs["texture"],
            reflectivity=config["reflectivity"])
        camera = tracer.Camera(eye=tuple(cam["eye"]),
                               look_at=tuple(cam["look_at"]),
                               up=tuple(cam["up"]),
                               fov_y_deg=cam["fov_y_deg"])
        cfg = tracer.RTConfig(
            width=traffic["width"], height=traffic["height"],
            bounces=traffic["bounces"], shadows=traffic["shadows"],
            textured=textured, engine=config["engine"],
            background=tuple(shade["background"]), ambient=shade["ambient"],
            light_dir=tuple(shade["light_dir"]),
            light_color=tuple(shade["light_color"]))
        t0 = time.perf_counter()
        self.frame, (self.o, self.d) = tracer.make_frame_fn(
            scene, camera, cfg, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        #: host seconds of the make_frame_fn call, ending in a synchronize
        self.prepare_s = time.perf_counter() - t0
        #: what the per-layer readers may use besides the trace
        self.info = {"triangles": int(self.inputs["faces"].shape[0])}

    def step(self):
        return self.frame(self.o, self.d)

    def release(self):
        self.frame = self.o = self.d = None

    def check(self, outputs):
        """The worst of compare.image_numbers over ``outputs``; the
        reference's queries go to ``info`` for the roofline."""
        want, queries = reference(self.config, self.traffic, self.inputs,
                                  self.device)
        self.info["queries"] = queries
        return compare.worst([compare.image_numbers(o, want)
                              for o in outputs])


def make_inputs(config, seed):
    """The scene both sides get (benchmark/scenes.py)."""
    return scenes.make_scene(config, seed)


def reference(config, traffic, inputs, device, dtype=rt_reference.F64):
    """(image, queries) of the plain reference in ``dtype``."""
    return rt_reference.render(inputs, config, traffic, dtype, device)


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
