"""Inverse-rendering optimization loop: failure detection and checkpoint /
resume.

Counterpart of skybox_rt_tpu.diff.optim: the minimal production loop around
a differentiable render: NaN / inf detection on loss and gradients, roll-back
to the last good parameters with a halved learning rate, and checkpoints a
later call resumes from.  ``torch.optim`` stands where optax stood and
``torch.save`` where orbax did; ``torch.optim.Adam``'s defaults (betas 0.9 /
0.999, eps 1e-8 added outside the root) are those of ``optax.adam``, so loss
curves compare with the JAX package's step by step.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil

import torch

from ..utils import tracing

_log = logging.getLogger(__name__)

KEEP_CHECKPOINTS = 3
STATE_FILE = "state.pt"


@dataclasses.dataclass
class FitResult:
    params: dict
    losses: list
    bad_steps: int            # steps rejected by the NaN/inf guard
    resumed_from: int         # step index restored from checkpoint (0 = fresh)


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def make_step(loss_fn, params, optimizer):
    """step(*args) -> (loss, grads): one update of ``params`` (a dict of
    leaf tensors that require grad, which ``optimizer`` was built over) in
    place.  ``loss`` is a detached 0-d tensor and ``grads`` the gradients
    the update used, by parameter name.  A loss sharded over devices sums
    its gradients inside loss_fn; this wrapper only owns the update."""
    def step(*args):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, *args)
        loss.backward()
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        optimizer.step()
        return loss.detach(), grads

    return step


def _checkpoint_steps(directory) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.exists(
                      os.path.join(directory, name, STATE_FILE)))


def _save_checkpoint(directory, step, params) -> None:
    """<directory>/<step>/state.pt, written whole before it gets its name;
    the newest KEEP_CHECKPOINTS stay."""
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": step,
                "params": {k: v.detach().cpu() for k, v in params.items()}},
               os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _checkpoint_steps(directory)[:-KEEP_CHECKPOINTS]:
        shutil.rmtree(os.path.join(directory, str(old)))


def fit(loss_fn, params, *args, steps: int = 100, lr: float = 1e-2,
        checkpoint_dir: str | None = None, checkpoint_every: int = 25,
        optimizer=None) -> FitResult:
    """Optimize params to minimize loss_fn(params, *args).

    ``params`` is a dict of tensors, all on one device; they are copied, so
    the caller's stay as they were, and the result's ``params`` are the
    optimized leaves on the same device.  ``optimizer`` is a callable from a
    list of tensors to a ``torch.optim.Optimizer`` (default: Adam at ``lr``).

    Failure handling:
      * non-finite loss or gradients -> the step is rejected: the parameters
        roll back to the last good copy, the optimizer is built anew (fresh
        state) and the learning rate of every one of its groups is
        multiplied by the running ``lr_scale``, halved at each rejection.
        For Adam and SGD that is what chaining a scale onto the optimizer's
        updates does (the update is linear in the learning rate).
      * ``checkpoint_dir`` writes ``<dir>/<step>/state.pt`` (step and the
        parameters as CPU tensors) every ``checkpoint_every`` steps and after
        the last, keeps the newest three, and a later fit() with the same
        directory resumes from the newest one.
    """
    make_optimizer = optimizer or (lambda ps: torch.optim.Adam(ps, lr=lr))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}

    start_step = 0
    if checkpoint_dir:
        checkpoint_dir = os.path.abspath(checkpoint_dir)
        saved = _checkpoint_steps(checkpoint_dir)
        if saved:
            state = torch.load(os.path.join(checkpoint_dir, str(saved[-1]),
                                            STATE_FILE), weights_only=True)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
            start_step = int(state["step"])
            _log.info("resumed from checkpoint step %d", start_step)
            tracing.trace_log(1, f"resumed from checkpoint step {start_step}")

    def scaled_optimizer(scale):
        opt = make_optimizer(list(params.values()))
        for group in opt.param_groups:
            group["lr"] *= scale
        return opt

    step = make_step(loss_fn, params, scaled_optimizer(1.0))
    losses = []
    bad_steps = 0
    lr_scale = 1.0
    good = {k: p.detach().clone() for k, p in params.items()}
    for i in range(start_step, steps):
        with tracing.stage("optim_step"):
            loss, grads = step(*args)
        loss_val = float(loss)
        if not math.isfinite(loss_val) or not _all_finite(grads.values()):
            bad_steps += 1
            lr_scale *= 0.5
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(good[k])
            _log.info("step %d: non-finite loss/grads, rolled back "
                      "(lr_scale=%s)", i, lr_scale)
            tracing.trace_log(
                1, f"step {i}: non-finite loss/grads, rolled back "
                   f"(lr_scale={lr_scale})")
            step = make_step(loss_fn, params, scaled_optimizer(lr_scale))
            continue
        with torch.no_grad():
            for k, p in params.items():
                good[k].copy_(p)
        losses.append(loss_val)

        if checkpoint_dir and ((i + 1) % checkpoint_every == 0
                               or i + 1 == steps):
            _save_checkpoint(checkpoint_dir, i + 1, params)

    for p in params.values():
        p.grad = None
    return FitResult(params=params, losses=losses, bad_steps=bad_steps,
                     resumed_from=start_step)
