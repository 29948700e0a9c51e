"""Where an entry point runs.

The port's entry points (ref.driver.render_trace / prepare_drawcalls /
compile_frame, rt.tracer.make_frame_fn / render) run on the CUDA card unless
the caller names another device.  Without a card ``device=None`` raises: it
never carries on on the CPU, so a run cannot mistake a CPU result for the
card's.  The CPU tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and raises
    RuntimeError where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (CPU work is done on return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
