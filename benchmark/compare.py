"""The numbers by which a rendered image is judged against its reference.

``bad_px_pct``: the share of pixels, in %, whose largest channel differs
from the reference by more than ``PX_TOL`` (a pixel that is not finite
counts); rounding moves a pixel by some 1e-5, a hit that flips to another
object or a shadow that flips moves it by tenths.  ``mean_abs_err``: the
mean absolute difference over every pixel and channel.
"""
from __future__ import annotations

import torch

#: one step of an 8-bit channel
PX_TOL = 1.0 / 256


def image_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    g = got.to(torch.float64)
    w = want.to(device=g.device, dtype=torch.float64)
    if g.shape != w.shape:
        return {"bad_px_pct": 100.0, "mean_abs_err": float("inf")}
    diff = torch.nan_to_num((g - w).abs(), nan=float("inf"))
    worst = diff.amax(-1)
    return {"bad_px_pct": float((worst > PX_TOL).double().mean()) * 100.0,
            "mean_abs_err": float(diff.mean())}


def worst(readings: list) -> dict:
    """The largest of each number over several readings."""
    return {k: max(r[k] for r in readings) for k in readings[0]}
