"""skybox_rt_tpu_torch — the PyTorch / CUDA port of skybox_rt_tpu.

Slice 1: the exact-int draw3d frame.  Slice 2: the ray-traced frame
(rt/tracer.make_frame_fn).  The package mirrors the JAX package's tree
(core/, geom/, texture/, om/, raster/, ops/, ref/, rt/, diff/, models/),
imports torch and numpy and never jax.  Pass 1 of the deferred renderer
(csrc/raster_visibility.cu) and the closest-hit and any-hit queries over
BVH-treelet blocks (csrc/rt_bvh.cu) run in hand-written CUDA kernels, built
at first use by _build.py; everything else is plain torch.  The JAX package
stays the reference: tests/test_torch_*.py hold this package to it (bit for
bit on the integer paths, within stated tolerances on the float ones), and
chip_smoke.py runs both frames on a card.  Entry points run on the CUDA
card unless given ``device=`` (core/device.py).

Importing the package builds nothing and touches no device.
"""
