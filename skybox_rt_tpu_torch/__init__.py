"""skybox_rt_tpu_torch — the PyTorch / CUDA port of skybox_rt_tpu.

The package mirrors the JAX package's tree (core/, geom/, texture/, om/,
raster/, ops/, ref/, rt/, diff/, apps/, models/, runtime/, utils/, cli.py;
parallel/ is not ported yet), imports torch and numpy and never jax.  Every
Pallas kernel of the JAX package has a hand-written CUDA counterpart in
csrc/, built at first use by _build.py; everything else is plain torch.
The JAX package stays the reference: tests/test_torch_*.py hold this
package to it (bit for bit on the integer paths, within stated tolerances on
the float ones), chip_smoke.py runs every path on a card and bench_torch.py
measures them.  Entry points run on the CUDA card unless given ``device=``
(core/device.py); ``python -m skybox_rt_tpu_torch`` is the command line.

Importing the package builds nothing and touches no device.
"""
