"""Inverse-rendering optimization loop: failure detection and checkpoint /
resume.

Counterpart of skybox_rt_tpu.diff.optim: the minimal production loop around
a differentiable render: NaN / inf detection on loss and gradients, roll-back
to the last good parameters with a halved learning rate, and checkpoints a
later call resumes from.  :class:`FitLoop` is the loop's body, one step a
call, for a caller that drives the steps itself (the benchmark's training
cell times it).  ``torch.optim`` stands where optax stood and
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


def _forward_backward(loss_fn, params, optimizer, args):
    """The loss and the gradients, by parameter name, of one step; the
    backward pass runs in the stage ``diff.backward``, on the calling
    thread.  Autograd would hand a CUDA graph's backward to a device thread
    of its own and wait for it: on an H100 that hop made a 1024x1024 step
    slower by a twelfth and its time wander between and within processes
    (PERF.md §6); the gradients are the same either way."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, *args)
    with tracing.stage("diff.backward", stream=True), \
            torch.autograd.set_multithreading_enabled(False):
        loss.backward()
    return loss, {k: p.grad for k, p in params.items() if p.grad is not None}


def make_step(loss_fn, params, optimizer):
    """step(*args) -> (loss, grads): one update of ``params`` (a dict of
    leaf tensors that require grad, which ``optimizer`` was built over) in
    place.  ``loss`` is a detached 0-d tensor and ``grads`` the gradients
    the update used, by parameter name.  A loss sharded over devices sums
    its gradients inside loss_fn; this wrapper only owns the update."""
    def step(*args):
        loss, grads = _forward_backward(loss_fn, params, optimizer, args)
        optimizer.step()
        return loss.detach(), grads

    return step


class FitLoop:
    """The body of :func:`fit`'s loop, one step a call: the update, the
    finite check and, on failure, the roll-back.

    ``params`` is a dict of leaf tensors that require grad; the loop updates
    them in place.  ``optimizer`` is a callable from a list of tensors to a
    ``torch.optim.Optimizer`` (default: Adam at ``lr``).  A step is the stage
    ``optim_step`` (a frame of the span buffer) around the update of
    :func:`make_step`, with the backward pass in ``diff.backward`` and the
    optimizer's step and the finite check in ``diff.optim``; the check's
    read-back of the loss and the gradients is ``diff.sync``, and a
    roll-back's or a caller's reset is ``diff.reset``.  Each row
    accumulation of the backward pass is a ``diff.accumulate`` inside
    ``diff.backward``.

    Attributes: ``bad_steps`` (steps the check rejected), ``lr_scale`` (the
    learning rates' factor, halved at each rejection), ``loss`` (the last
    step's loss as a float, None where the check rejected it) and ``good``
    (the parameters after the last accepted step, or as last reset)."""

    def __init__(self, loss_fn, params, optimizer=None, lr: float = 1e-2):
        self.loss_fn, self.params = loss_fn, params
        self.make_optimizer = optimizer or (
            lambda ps: torch.optim.Adam(ps, lr=lr))
        self.bad_steps, self.lr_scale, self.loss = 0, 1.0, None
        self.good = {k: p.detach().clone() for k, p in params.items()}
        self.optimizer = self._new_optimizer()

    def _new_optimizer(self):
        opt = self.make_optimizer(list(self.params.values()))
        for group in opt.param_groups:
            group["lr"] *= self.lr_scale
        return opt

    def reset(self, params):
        """The parameters set to ``params`` (a dict of tensors of the same
        names and shapes) and to the good copy, and a fresh optimizer at the
        current ``lr_scale``."""
        with tracing.stage("diff.reset"), torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])
                if self.good[k] is not params[k]:
                    self.good[k].copy_(params[k])
        self.optimizer = self._new_optimizer()

    def step(self, *args):
        """One step of ``loss_fn(params, *args)``: (loss, grads), the
        detached loss and the gradients the update used, by name.  A loss
        or a gradient that is not finite rejects the step: the parameters
        roll back to ``good`` and the optimizer is built anew at half the
        learning rate."""
        with tracing.stage("optim_step", frame=True):
            loss, grads = _forward_backward(self.loss_fn, self.params,
                                            self.optimizer, args)
            loss = loss.detach()
            with tracing.stage("diff.optim"):
                self.optimizer.step()
                with tracing.stage("diff.sync"):
                    value = float(loss)
                    ok = math.isfinite(value) and _all_finite(grads.values())
                if ok:
                    self.loss = value
                    with torch.no_grad():
                        for k, p in self.params.items():
                            self.good[k].copy_(p)
                else:
                    self.loss = None
                    self.bad_steps += 1
                    self.lr_scale *= 0.5
                    self.reset(self.good)
        return loss, grads


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

    loop = FitLoop(loss_fn, params, optimizer, lr)
    losses = []
    for i in range(start_step, steps):
        loop.step(*args)
        if loop.loss is None:
            _log.info("step %d: non-finite loss/grads, rolled back "
                      "(lr_scale=%s)", i, loop.lr_scale)
            tracing.trace_log(
                1, f"step {i}: non-finite loss/grads, rolled back "
                   f"(lr_scale={loop.lr_scale})")
            continue
        losses.append(loop.loss)

        if checkpoint_dir and ((i + 1) % checkpoint_every == 0
                               or i + 1 == steps):
            _save_checkpoint(checkpoint_dir, i + 1, params)

    for p in params.values():
        p.grad = None
    return FitResult(params=params, losses=losses, bad_steps=loop.bad_steps,
                     resumed_from=start_step)
