"""Output merger of the port against skybox_rt_tpu.om, exactly.

Every depth/stencil compare func, stencil op, blend func, blend mode and
logic op, the full depth-stencil test, the ds carry of the visibility pass
and the masked OM writes, on random u32 words from numpy seeds.  The JAX
states are carried into the port with interop, so both packages see the
same state objects' fields.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.core import constants as C
from skybox_rt_tpu.om import blend as jblend
from skybox_rt_tpu.om import depth_stencil as jds
from skybox_rt_tpu.om import merger as jmerger
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.core.state import RenderState, ShaderFlags
from skybox_rt_tpu_torch.om import blend, depth_stencil, merger

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

N = 2048
FUNCS = list(range(8))
STENCIL_OPS = list(range(8))
BLEND_FUNCS = list(range(15))
BLEND_MODES = list(range(6))
LOGIC_OPS = list(range(16))


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return fixed.from_numpy_u32(a)


def _np(t):
    return fixed.to_numpy_u32(t)


def _ds(depth_func=C.OM_DEPTH_FUNC_LESS, depth_write=True, func=0, zpass=0,
        zfail=0, fail=0, ref=0, mask=0xFF):
    return jds.DepthStencilState(
        depth_func=depth_func, depth_writemask=depth_write,
        stencil_front_func=func, stencil_front_zpass=zpass,
        stencil_front_zfail=zfail, stencil_front_fail=fail,
        stencil_front_ref=ref, stencil_front_mask=mask,
        stencil_back_func=0, stencil_back_zpass=0, stencil_back_zfail=0,
        stencil_back_fail=0, stencil_back_ref=0, stencil_back_mask=0xFF)


def _blend_state(src, dst, mode=C.OM_BLEND_MODE_ADD, logic=0,
                 const=0x80FF4020):
    return jblend.BlendState(mode_rgb=mode, mode_a=mode, src_rgb=src,
                             src_a=src, dst_rgb=dst, dst_a=dst,
                             const_color=const, logic_op=logic)


def _om(ds, bl, depth_write=True, swm=0xFF, cmask=0xF):
    return jmerger.OMState(ds=ds, blend=bl, depth_writemask=depth_write,
                           stencil_front_writemask=swm,
                           stencil_back_writemask=0, cbuf_writemask4=cmask)


def _port_om(om):
    flags = ShaderFlags(True, True, False, False)
    js = type("RS", (), {"flags": flags, "om": om, "tex": None,
                         "scissor": (0, 0, 1, 1)})
    return interop.render_state_from_reference(js).om


@pytest.mark.parametrize("func", FUNCS)
def test_compare(func):
    a, b = _u32(N, func), _u32(N, func + 50)
    b[::3] = a[::3]                                 # equal pairs decide too
    want = np.asarray(jds.compare(func, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        depth_stencil.compare(func, _t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("op", STENCIL_OPS)
def test_stencil_op(op):
    val = np.concatenate([np.arange(256, dtype=np.uint32), _u32(256, op)])
    for ref in (0, 0x2A, 0xFF, 0x1234):
        want = np.asarray(jds.stencil_op(op, ref, jnp.asarray(val)))
        np.testing.assert_array_equal(
            _np(depth_stencil.stencil_op(op, ref, _t(val))), want)


DS_CASES = {
    "less_write": _ds(),
    "always_nowrite": _ds(C.OM_DEPTH_FUNC_ALWAYS, False),
    "stencil_incr_invert": _ds(C.OM_DEPTH_FUNC_LESS, True,
                               func=C.OM_DEPTH_FUNC_NOTEQUAL,
                               zpass=C.OM_STENCIL_OP_INCR,
                               zfail=C.OM_STENCIL_OP_DECR,
                               fail=C.OM_STENCIL_OP_INVERT, ref=0x2A,
                               mask=0x0F),
    "stencil_wrap_replace": _ds(C.OM_DEPTH_FUNC_GREATER, True,
                                func=C.OM_DEPTH_FUNC_GEQUAL,
                                zpass=C.OM_STENCIL_OP_INCR_WRAP,
                                zfail=C.OM_STENCIL_OP_DECR_WRAP,
                                fail=C.OM_STENCIL_OP_REPLACE, ref=0x13,
                                mask=0xF0),
    "stencil_zero_never": _ds(C.OM_DEPTH_FUNC_NEVER, False,
                              func=C.OM_DEPTH_FUNC_LEQUAL,
                              zpass=C.OM_STENCIL_OP_ZERO,
                              fail=C.OM_STENCIL_OP_INCR, ref=0x80),
}


def _ds_inputs(seed):
    depth, dst = _u32(N, seed), _u32(N, seed + 1)
    dst[::4] = (dst[::4] & 0xFF000000) | (depth[::4] & 0xFFFFFF)   # ties
    return depth, dst


@pytest.mark.parametrize("case", sorted(DS_CASES))
def test_depth_stencil_test(case):
    ds = DS_CASES[case]
    depth, dst = _ds_inputs(3)
    want_p, want_r = jds.test(ds, False, jnp.asarray(depth), jnp.asarray(dst))
    got_p, got_r = depth_stencil.test(_port_om(_om(ds, _blend_state(1, 0))).ds,
                                      False, _t(depth), _t(dst))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(_np(got_r), np.asarray(want_r))


@pytest.mark.parametrize("swm", [0x00, 0xFF, 0x3C])
@pytest.mark.parametrize("case", sorted(DS_CASES))
def test_ds_carry_update(case, swm):
    om = _om(DS_CASES[case], _blend_state(1, 0), depth_write=True, swm=swm)
    depth, dst = _ds_inputs(4)
    cov = np.random.default_rng(5).random(N) < 0.7
    want_d, want_c = jmerger.ds_carry_update(om, jnp.asarray(depth),
                                             jnp.asarray(cov),
                                             jnp.asarray(dst))
    got_d, got_c = merger.ds_carry_update(_port_om(om), _t(depth),
                                          torch.from_numpy(cov),
                                          _t(dst))
    np.testing.assert_array_equal(_np(got_d), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _channels(seed):
    return tuple(_u32(N, seed + k) & 0xFF for k in range(4))


@pytest.mark.parametrize("func", BLEND_FUNCS)
def test_blend_func(func):
    src, dst, cst = _channels(10), _channels(20), _channels(30)
    want = jblend.blend_func(func, *(tuple(jnp.asarray(c) for c in x)
                                     for x in (src, dst, cst)))
    got = blend.blend_func(func, *(tuple(torch.from_numpy(c.astype(np.int64))
                                         for c in x)
                                   for x in (src, dst, cst)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.broadcast_to(np.asarray(w), (N,)))


@pytest.mark.parametrize("mode", BLEND_MODES)
@pytest.mark.parametrize("funcs", [(6, 7), (1, 1), (8, 5), (14, 10), (3, 13)])
def test_blend_modes(mode, funcs):
    st = _blend_state(*funcs, mode=mode, logic=C.OM_LOGIC_OP_XOR)
    src, dst = _u32(N, mode), _u32(N, mode + 7)
    want = np.asarray(jblend.blend(st, jnp.asarray(src), jnp.asarray(dst)))
    got = blend.blend(_port_om(_om(_ds(), st)).blend, _t(src), _t(dst))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("op", LOGIC_OPS)
def test_logic_op(op):
    src, dst = _u32(N, op), _u32(N, op + 99)
    want = np.asarray(jblend.logic_op(op, jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_array_equal(_np(blend.logic_op(op, _t(src), _t(dst))),
                                  want)
    st = _blend_state(1, 1, mode=C.OM_BLEND_MODE_LOGICOP, logic=op)
    want = np.asarray(jblend.blend(st, jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_array_equal(
        _np(blend.blend(_port_om(_om(_ds(), st)).blend, _t(src), _t(dst))),
        want)


WRITE_CASES = {
    "opaque_less": _om(_ds(), _blend_state(1, 0)),
    "alpha_less_mask_rb": _om(_ds(), _blend_state(6, 7), cmask=0x5),
    "additive_nodepth": _om(_ds(C.OM_DEPTH_FUNC_ALWAYS, False),
                            _blend_state(1, 1), depth_write=False),
    "stencil_blend": _om(DS_CASES["stencil_wrap_replace"],
                         _blend_state(6, 7), swm=0x3C),
    "no_color_write": _om(DS_CASES["stencil_incr_invert"],
                          _blend_state(1, 0), cmask=0),
}


@pytest.mark.parametrize("backface", [False, True])
@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_merger_write(case, backface):
    om = WRITE_CASES[case]
    color, fbc = _u32(N, 40), _u32(N, 41)
    depth, fbd = _ds_inputs(42)
    cov = np.random.default_rng(43).random(N) < 0.6
    want_c, want_d = jmerger.write(om, jnp.asarray(cov), jnp.asarray(color),
                                   jnp.asarray(depth), jnp.asarray(fbc),
                                   jnp.asarray(fbd), is_backface=backface)
    got_c, got_d = merger.write(_port_om(om), torch.from_numpy(cov),
                                _t(color), _t(depth), _t(fbc), _t(fbd),
                                is_backface=backface)
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    np.testing.assert_array_equal(_np(got_d), np.asarray(want_d))


def test_render_state_carries_across():
    om = WRITE_CASES["stencil_blend"]
    port = _port_om(om)
    assert port.cbuf_writemask == om.cbuf_writemask
    assert port.color_write == om.color_write
    assert port.blend.enabled == om.blend.enabled
    assert port.ds.depth_enabled == om.ds.depth_enabled
    assert port.ds.stencil_enabled(False) == om.ds.stencil_enabled(False)
    rs = RenderState(ShaderFlags(True, True, False, False), port, None,
                     (0, 0, 8, 8))
    assert hash(rs) == hash(RenderState(ShaderFlags(True, True, False, False),
                                        _port_om(om), None, (0, 0, 8, 8)))
