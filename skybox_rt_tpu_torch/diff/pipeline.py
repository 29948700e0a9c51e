"""The float texture sampler that the ray tracer's shading shares with the
differentiable pipeline.

Counterpart of skybox_rt_tpu.diff.pipeline, this one function only: the
rest of that module (prim setup, slots, visibility, gradients) belongs to
the differentiable slice and is not ported yet.
"""
from __future__ import annotations

import torch


def sample_texture_bilinear(tex, u, v):
    """Bilinear sample.  tex: (TH, TW, 4) float; u, v in [0, 1] with repeat
    wrapping (``%`` with the sign of the divisor, as in Python and jnp)."""
    th, tw = tex.shape[0], tex.shape[1]
    uu = torch.remainder(u, 1.0) * tw - 0.5
    vv = torch.remainder(v, 1.0) * th - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder(x0i + 1, tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder(y0i + 1, th)
    t00 = tex[y0i, x0i]
    t01 = tex[y0i, x1i]
    t10 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    # fma-form lerps (a + f*(b-a)), the order of the JAX sampler
    cx0 = t00 + fx * (t01 - t00)
    cx1 = t10 + fx * (t11 - t10)
    return cx0 + fy * (cx1 - cx0)
