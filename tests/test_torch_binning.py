"""Host binning of the port against the JAX package's two engines.

The port's numpy ``bin_drawcall_py`` must equal both the JAX package's
``bin_drawcall`` (its native C++ engine where built) and its numpy
``bin_drawcall_py``, field for field, on every draw of the synthetic trace
at 256x256 and at 100x75.
"""
import numpy as np
import pytest

from skybox_rt_tpu.geom import binning as jbinning
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.geom import binning, cgltrace

FIELDS = ("edges", "attribs", "tile_xy", "tile_pids", "tile_pid_count")


@pytest.fixture(scope="module")
def trace():
    return cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))


@pytest.mark.parametrize("size", [(256, 256), (100, 75)], ids=str)
@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_binning_matches_jax_engines(trace, d, size):
    W, H = size
    dc = trace.drawcalls[d]
    args = (dc.pos, dc.indices, dc.color, dc.texcoord, W, H, dc.near, dc.far,
            5)
    got = binning.bin_drawcall_py(*args)
    assert got is not None and got.num_prims > 0
    for engine in (jbinning.bin_drawcall, jbinning.bin_drawcall_py):
        want = interop.binned_from_reference(engine(*args))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{engine.__name__}.{f}")
        assert (got.tile_logsize, got.num_prims) == (want.tile_logsize,
                                                     want.num_prims)


def test_empty_draw_bins_to_none(trace):
    dc = trace.drawcalls[0]
    off = dc.pos.copy()
    off[:, 0] = off[:, 3] * 5.0          # every vertex right of the screen
    assert binning.bin_drawcall_py(off, dc.indices, dc.color, dc.texcoord,
                                   64, 64, 0.0, 1.0) is None
    assert jbinning.bin_drawcall_py(off, dc.indices, dc.color, dc.texcoord,
                                    64, 64, 0.0, 1.0) is None
