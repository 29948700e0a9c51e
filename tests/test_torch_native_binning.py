"""The port's native C++ binning engine (geom.native, csrc/binning.cpp)
against the numpy engine and the JAX package, on the CPU.

Exact equality on every field, every draw of both committed traces, at
tile_logsize 3..6 and two sizes: the native engine, ``bin_drawcall_py`` and
the JAX package's ``bin_drawcall`` (its own native engine, or its numpy
engine where that cannot be built).  With them: the binning invariants,
``load_cached`` and ``render_scene`` on the native tier, the
``SKYBOX_NATIVE=0`` opt-out, and a build that fails and says why.
"""
import os

import numpy as np
import pytest
import torch

from skybox_rt_tpu.geom import binning as jbinning
from skybox_rt_tpu.geom import cgltrace as jcgltrace
from skybox_rt_tpu.ref import driver as jdriver
from skybox_rt_tpu_torch.geom import binning, cgltrace, native, validate
from skybox_rt_tpu_torch.ref import driver

torch.set_num_threads(1)

FIELDS = ("edges", "attribs", "tile_xy", "tile_pids", "tile_pid_count")
TRACES = {name: cgltrace.load_trace(cgltrace.trace_path(name))
          for name in ("synth_draw3d", "synth_config3")}


def _args(dc, size, tls):
    return (dc.pos, dc.indices, dc.color, dc.texcoord, size, size, dc.near,
            dc.far, tls)


@pytest.mark.parametrize("tls", [3, 4, 5, 6])
@pytest.mark.parametrize("size", [64, 200])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_native_matches_numpy_and_jax(name, size, tls):
    checked = 0
    for dc in TRACES[name].drawcalls:
        args = _args(dc, size, tls)
        nat = binning.bin_drawcall(*args)
        py = binning.bin_drawcall_py(*args)
        jx = jbinning.bin_drawcall(*args)
        if py is None:
            assert nat is None and jx is None
            continue
        for f in FIELDS:
            got = getattr(nat, f)
            assert got.dtype == np.int32, f
            np.testing.assert_array_equal(got, getattr(py, f), err_msg=f)
            np.testing.assert_array_equal(got, np.asarray(getattr(jx, f)),
                                          err_msg=f)
        assert nat.num_prims == py.num_prims == jx.num_prims
        assert nat.tile_logsize == tls
        checked += 1
    assert checked >= 4


def test_empty_and_culled_draws():
    dc = TRACES["synth_draw3d"].drawcalls[0]
    empty = np.zeros((0, 3), np.int32)
    assert binning.bin_drawcall(dc.pos, empty, dc.color, dc.texcoord, 64, 64,
                                dc.near, dc.far) is None
    # every vertex behind the camera's far side of the screen: nothing kept
    off = dc.pos.copy()
    off[:, 0] = 10.0 * off[:, 3]
    assert binning.bin_drawcall(off, dc.indices, dc.color, dc.texcoord, 64,
                                64, dc.near, dc.far) is None
    assert binning.bin_drawcall_py(off, dc.indices, dc.color, dc.texcoord, 64,
                                   64, dc.near, dc.far) is None


def test_out_of_range_index_raises():
    dc = TRACES["synth_draw3d"].drawcalls[0]
    bad = dc.indices.copy()
    bad[0, 0] = dc.pos.shape[0]
    with pytest.raises(IndexError):
        binning.bin_drawcall(dc.pos, bad, dc.color, dc.texcoord, 64, 64,
                             dc.near, dc.far)


def _verdict(mod, b, size):
    try:
        mod.validate_binning(b, size, size)
        mod.coverage_conservation(b, size, size)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(TRACES))
def test_binning_invariants_and_coverage_conservation(name):
    """The port's checks give the JAX package's verdict on every draw.  They
    hold on every draw but one a trace: at 64x64, tile_logsize 4 a
    5,120-triangle sphere (synth_draw3d draw 0, synth_config3 draw 2) loses
    one pixel in both packages, a fragment beyond its primitive's bounding
    box."""
    from skybox_rt_tpu.geom import validate as jvalidate
    failed = []
    for size, tls in ((32, 3), (64, 4)):
        for d, dc in enumerate(TRACES[name].drawcalls):
            b = binning.bin_drawcall(*_args(dc, size, tls))
            if b is None:
                continue
            got = _verdict(validate, b, size)
            assert got == _verdict(jvalidate, b, size), (size, d)
            if got is not None:
                failed.append((size, tls, d, got))
    lost = {"synth_draw3d": 0, "synth_config3": 2}[name]
    assert [f[:3] for f in failed] == [(64, 4, lost)]
    assert "coverage not conserved at 1 pixels" in failed[0][3]


def test_validate_catches_a_lost_tile():
    from skybox_rt_tpu.geom import validate as jvalidate
    dc = TRACES["synth_draw3d"].drawcalls[2]
    b = binning.bin_drawcall(*_args(dc, 64, 4))
    b.tile_pids = np.where(np.arange(b.tile_pids.shape[0])[:, None] == 0, -1,
                           b.tile_pids)
    for mod in (validate, jvalidate):
        with pytest.raises(AssertionError):
            mod.validate_binning(b, 64, 64)
        with pytest.raises(AssertionError):
            mod.coverage_conservation(b, 64, 64)


def test_skybox_native_0_takes_numpy(monkeypatch):
    dc = TRACES["synth_draw3d"].drawcalls[1]
    calls = []
    monkeypatch.setattr(native, "bin_drawcall_native",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("SKYBOX_NATIVE", "0")
    b = binning.bin_drawcall(*_args(dc, 64, 5))
    assert calls == [] and b is not None
    monkeypatch.setenv("SKYBOX_NATIVE", "1")
    assert binning.bin_drawcall(*_args(dc, 64, 5)) is None   # the stub
    assert len(calls) == 1


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "binning.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native._build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(str(broken))
    assert "error" in str(err.value)
    assert not os.listdir(tmp_path / "build")     # no half-written library


def test_library_is_keyed_by_source(tmp_path):
    other = tmp_path / "binning.cpp"
    with open(native.SRC) as f:
        other.write_text(f.read() + "\n// edited\n")
    assert native.library_path(str(other)) != native.library_path()
    assert os.path.dirname(native.library_path()) == native._build.BUILD_DIR


def test_load_cached_round_trips(tmp_path):
    """An XML archive parses once into the cache and is read from it after;
    an npz trace is read as it is."""
    src = TRACES["synth_draw3d"]
    small = cgltrace.CGLTrace(drawcalls=src.drawcalls[2:4],
                              textures=src.textures)
    xml = tmp_path / "scene.cgltrace"
    xml.write_text(_to_xml(small))
    cache = tmp_path / "cache"
    first = cgltrace.load_cached(str(xml), cache_dir=str(cache))
    assert len(os.listdir(cache)) == 1
    second = cgltrace.load_cached(str(xml), cache_dir=str(cache))
    for t in (first, second):
        _assert_same_trace(t, cgltrace.load(str(xml)))
    npz = cgltrace.trace_path("synth_draw3d")
    _assert_same_trace(cgltrace.load_cached(npz, cache_dir=str(cache)), src)
    assert len(os.listdir(cache)) == 1
    # an unreadable cache file is parsed and written again
    (cache / os.listdir(cache)[0]).write_bytes(b"not an npz")
    _assert_same_trace(cgltrace.load_cached(str(xml), cache_dir=str(cache)),
                       first)


def _assert_same_trace(a, b):
    assert len(a.drawcalls) == len(b.drawcalls)
    for x, y in zip(a.drawcalls, b.drawcalls):
        assert x.states == y.states and x.texture_id == y.texture_id
        assert (x.near, x.far) == (y.near, y.far)
        for f in ("pos", "color", "texcoord", "indices"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert sorted(a.textures) == sorted(b.textures)


def _to_xml(trace) -> str:
    """A Boost-XML-shaped archive of the trace (drawcalls only; every
    float printed with repr, so the parse gives back the same float32)."""
    import dataclasses

    def states(s):
        return "".join(f"<{f.name}>{int(getattr(s, f.name))}</{f.name}>"
                       for f in dataclasses.fields(s))
    items = []
    for dc in trace.drawcalls:
        verts = "".join(
            "<item><first>{}</first><second><pos>{}</pos><color>{}</color>"
            "<texcoord>{}</texcoord></second></item>".format(
                i,
                "".join(f"<{c}>{float(v)!r}</{c}>"
                        for c, v in zip("xyzw", dc.pos[i])),
                "".join(f"<{c}>{float(v)!r}</{c}>"
                        for c, v in zip("rgba", dc.color[i])),
                "".join(f"<{c}>{float(v)!r}</{c}>"
                        for c, v in zip("uv", dc.texcoord[i])))
            for i in range(dc.pos.shape[0]))
        prims = "".join(
            f"<item><i0>{p[0]}</i0><i1>{p[1]}</i1><i2>{p[2]}</i2></item>"
            for p in dc.indices)
        items.append(
            f"<item><states>{states(dc.states)}</states>"
            f"<texture_id>{dc.texture_id}</texture_id>"
            f"<vertices>{verts}</vertices><primitives>{prims}</primitives>"
            f"<viewport><near>{dc.near!r}</near><far>{dc.far!r}</far>"
            f"</viewport></item>")
    return (f"<cgltrace><drawcalls><count>{len(items)}</count>"
            f"{''.join(items)}</drawcalls><textures><count>0</count>"
            f"</textures></cgltrace>")


def test_render_scene_equals_jax(monkeypatch):
    """render_scene by name, on the native tier, equals the JAX package's
    render_scene of the same trace (its default mode, "immediate"; the
    port's "pallas", three times quicker here than its immediate oracle)."""
    path = cgltrace.trace_path("synth_draw3d")

    def jax_load(p, cache_dir=None):
        with np.load(p) as z:
            return jcgltrace._from_npz(z)

    monkeypatch.setattr(jcgltrace, "load_cached", jax_load)
    monkeypatch.setattr(jcgltrace, "trace_path", lambda name: path)
    got = driver.render_scene("synth_draw3d", 64, 64, mode="pallas",
                              device="cpu")
    want = np.asarray(jdriver.render_scene("synth_draw3d", 64, 64))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (got != driver.CLEAR_COLOR).sum() > 100
