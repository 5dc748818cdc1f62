"""Training loop: gradient accumulation, straggler watchdog, checkpoint
and profiler hooks.

Port of :mod:`repro.train.loop`.  PyTorch runs eagerly, so the step is a
plain function (the reference jits it).  It updates the model's
parameters and the optimizer state in place, tensor by tensor; the
reference returns new trees.  So the Trainer retries only the forward and
backward pass, which change nothing, and runs the update once: an update
that fails partway raises, since running it again would apply the step
twice to the tensors it had already written.

With a ``mesh`` and ``rules`` the step runs under
:func:`~repro_torch.sharding.specs.set_rules` on the model's DTensor
parameters: the model's constraints resolve against that mesh, each
gradient is reduced to its parameter's placements once, and AdamW updates
the DTensor parameters and moments in place.  The same step runs on one
device, on a real process group and in the dry-run's fake one.  A
Trainer's checkpoint holds whole arrays, whatever its mesh, so it resumes
on another mesh or none (:meth:`Trainer.load_checkpoint`).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models import params as P
from repro_torch.sharding.specs import distribute, set_rules
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


@dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    deadline_s: float = 0.0      # 0 = watchdog off
    max_retries: int = 1


def value_and_grad(model, batch: dict) -> tuple[torch.Tensor, dict]:
    """The loss of ``batch`` and its gradient for each named parameter; a
    parameter the loss does not use gets zeros, as under ``jax.grad``."""
    named = dict(model.named_parameters())
    loss = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else
                           _as_param(g, p)
                           for (n, p), g in zip(named.items(), grads)}


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient reduced to its parameter's placements (a
    partial sum becomes an all-reduce or a reduce-scatter), once."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rules(mesh, rules):
    """``set_rules(mesh, rules)``, or nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return set_rules(mesh, rules)


def make_grad_fn(model, *, microbatches: int = 1,
                 accum_dtype=torch.float32):
    """``grad_fn(batch) -> (loss, grads)``, changing nothing.

    With ``microbatches > 1`` the batch is split along its first axis into
    equal parts and the gradients accumulate in ``accum_dtype``, then are
    divided by the count, as the reference's scan does.  A batch that
    ``microbatches`` does not divide raises ``ValueError``, as the
    reference's reshape refuses it.
    """

    def grad_fn(batch: dict) -> tuple[torch.Tensor, dict]:
        if microbatches == 1:
            return value_and_grad(model, batch)
        for k, v in batch.items():
            if v.shape[0] % microbatches:
                raise ValueError(
                    f"microbatches={microbatches} does not divide the "
                    f"batch: {k!r} has {v.shape[0]} rows")
        parts = {k: v.chunk(microbatches) for k, v in batch.items()}
        loss = torch.zeros((), device=batch["tokens"].device)
        acc = None
        for i in range(microbatches):
            l, g = value_and_grad(model, {k: v[i] for k, v in parts.items()})
            loss = loss + l
            if acc is None:
                acc = {n: t.to(accum_dtype) for n, t in g.items()}
            else:
                for n, t in g.items():
                    acc[n] += t
        return loss / microbatches, {n: t / microbatches
                                     for n, t in acc.items()}

    return grad_fn


def apply_update(model, opt_state: dict, loss: torch.Tensor, grads: dict,
                 opt_cfg: AdamWConfig) -> dict:
    """AdamW on ``model``'s parameters and ``opt_state``, in place; returns
    the step's metrics."""
    metrics = adamw_update(dict(model.named_parameters()), grads, opt_state,
                           opt_cfg)
    metrics["loss"] = loss
    return metrics


def make_train_step(model, opt_cfg: AdamWConfig, *, mesh=None, rules=None,
                    microbatches: int = 1, accum_dtype=torch.float32):
    """``train_step(opt_state, batch) -> metrics``: loss -> grads -> AdamW,
    on ``model``'s parameters in place (:func:`make_grad_fn`, then
    :func:`apply_update`), under ``set_rules(mesh, rules)`` when a mesh
    is given (the reference's ``loop.py:32-43``)."""
    grad_fn = make_grad_fn(model, microbatches=microbatches,
                           accum_dtype=accum_dtype)

    def train_step(opt_state: dict, batch: dict) -> dict:
        with _rules(mesh, rules):
            loss, grads = grad_fn(batch)
            return apply_update(model, opt_state, loss, grads, opt_cfg)

    return train_step


class Trainer:
    """Drives the step over a pipeline with fault-tolerance hooks."""

    def __init__(self, model, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 pipeline, *, ckpt=None, profiler=None, mesh=None,
                 rules=None):
        self.model = model
        self.mesh, self.rules = mesh, rules
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.profiler = profiler
        self.device = next(model.parameters()).device
        self.grad_fn = make_grad_fn(model, microbatches=tcfg.microbatches)
        self.straggler_events: list[dict] = []
        self.history: list[dict] = []

    def init_state(self, generator: torch.Generator, dtype=None) -> dict:
        """Initialise the model's parameters from ``generator`` (in
        ``dtype``, default the model's) and return fresh optimizer state."""
        dtype = dtype or next(self.model.parameters()).dtype
        P.from_reference(self.model, P.init_params(
            self.model.param_defs(), generator, dtype, self.device))
        return init_opt_state(dict(self.model.named_parameters()))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, opt_state: dict, *, start_step: int = 0,
            steps: int | None = None) -> dict:
        steps = steps if steps is not None else self.tcfg.steps
        for step in range(start_step, start_step + steps):
            t_data = time.perf_counter()
            batch = {"tokens": torch.from_numpy(
                self.pipeline.batch_at(step)).to(self.device)}
            if self.mesh is not None:
                batch = {"tokens": distribute(batch["tokens"],
                                              ("batch", "seq"), self.mesh,
                                              self.rules)}
            data_wait = time.perf_counter() - t_data

            self._sync()
            t0 = time.perf_counter()
            tries = 0
            with _rules(self.mesh, self.rules):
                while True:
                    try:
                        loss, grads = self.grad_fn(batch)
                        self._sync()
                        break
                    except Exception:
                        tries += 1
                        if tries > self.tcfg.max_retries:
                            raise
                # writes in place: once, never retried
                metrics = apply_update(self.model, opt_state, loss, grads,
                                       self.opt_cfg)
            del grads
            self._sync()
            dt = time.perf_counter() - t0

            if self.tcfg.deadline_s and dt > self.tcfg.deadline_s:
                # straggler mitigation: record, ask the pipeline to rebalance
                self.straggler_events.append({"step": step, "dt": dt})
                if hasattr(self.pipeline, "delay_s"):
                    self.pipeline.delay_s = 0.0  # drop the slow path

            # on a mesh the loss is a DTensor (a partial sum over the
            # batch axes): its whole value, not this rank's part
            rec = {"step": step, "loss": float(P.whole(metrics["loss"])),
                   "grad_norm": float(P.whole(metrics["grad_norm"])),
                   "step_time": dt, "data_wait": data_wait}
            self.history.append(rec)
            if self.profiler is not None:
                self.profiler.on_step(rec)
            if self.ckpt is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1,
                               self.checkpoint_state(opt_state, step + 1))
        if self.ckpt is not None:
            self.ckpt.wait()
        return opt_state

    def checkpoint_state(self, opt_state: dict, data_step: int) -> dict:
        """The reference's checkpoint tree: stacked parameters and moments,
        the optimizer step as an int32 scalar, the data cursor.  On a mesh
        each DTensor is gathered whole (every rank calls this)."""
        return {"params": P.to_reference(self.model),
                "opt": {"m": P.stack(opt_state["m"]),
                        "v": P.stack(opt_state["v"]),
                        "step": np.int32(opt_state["step"])},
                "data": {"step": np.int64(data_step)}}

    def load_checkpoint(self, state: dict) -> dict:
        """Load a restored checkpoint tree (either package's, written on
        any mesh or none) into the model and return its optimizer state.
        On a mesh each parameter and its moments are distributed with the
        parameter's placements, as ``init_opt_state`` lays them."""
        P.from_reference(self.model, state["params"])
        names = dict(self.model.named_parameters())

        def moment(t, p):
            t = P.whole(t).to(self.device, torch.float32, copy=True)
            if isinstance(p, DTensor):
                return distribute_tensor(t, p.device_mesh, p.placements)
            return t

        def moments(tree):
            flat = P.unstack(tree)
            return {n: moment(flat[n], p) for n, p in names.items()}

        return {"m": moments(state["opt"]["m"]),
                "v": moments(state["opt"]["v"]),
                "step": int(np.asarray(state["opt"]["step"]))}
