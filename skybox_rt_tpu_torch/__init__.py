"""skybox_rt_tpu_torch — the PyTorch / CUDA port of skybox_rt_tpu.

Slice 1: the exact-int draw3d frame.  The package mirrors the JAX
package's tree (core/, geom/, texture/, om/, raster/, ops/, ref/, models/),
imports torch and numpy and never jax.  Pass 1 of the deferred renderer
runs in a hand-written CUDA kernel (csrc/raster_visibility.cu, built at
first use by _build.py); everything else is plain torch.  The JAX package
stays the reference: tests/test_torch_*.py hold this package to it bit for
bit, and chip_smoke.py runs the frame on a card.

Importing the package builds nothing and touches no device.
"""
