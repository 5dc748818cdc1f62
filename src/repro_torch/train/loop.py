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
on another mesh or none (:meth:`Trainer.load_checkpoint`); it is gathered
one leaf at a time, and only rank 0 keeps a host copy.

Under a process group every rank of :meth:`Trainer.run` agrees on each
try of the forward and backward pass (one ``all_reduce`` of a failure
flag): if any rank failed, every rank retries, and past ``max_retries``
every rank raises.  A rank that fails inside a collective leaves the
others waiting in it until the process group's timeout, as in any SPMD
job; the Trainer does not handle that.

Each step of :meth:`Trainer.run` records its phases as spans in the
process flight recorder (``obs.recorder()``; :data:`TRAIN_SPANS`, op
``"train"``, the step as trace id), timed on :func:`~repro_torch.obs.
monotime`.  ``train.grad`` and ``train.update`` are recorded inside
:func:`make_grad_fn`'s ``grad_fn`` and :func:`apply_update`: the host's
time to issue the work, whatever wraps the calls.  ``train.step`` carries
the step's increase in the caching allocator's retries and ``cudaMalloc``
calls: one read of the statistics at each step's end, less the read that
ended the step before (or began the run).  A disabled recorder
(``REPRO_TRACE_RING=0``) records nothing and reads no allocator
statistics.  docs/torch_training_spans.md lists the spans and lays them
over a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import obs
from repro_torch.models import params as P
from repro_torch.sharding.specs import distribute, set_rules
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


#: the spans a Trainer step records (docs/torch_training_spans.md)
TRAIN_SPANS = ("train.step", "train.data", "train.grad", "train.grad.sync",
               "train.update", "train.update.sync", "train.readback",
               "train.hook", "train.checkpoint")


class _StepSpans:
    """The spans of one Trainer step: ``record`` puts one in the flight
    recorder under the step and returns its seconds; ``issue`` sums the
    seconds of ``train.grad`` and ``train.update``."""

    def __init__(self, step: int):
        self.step, self.rec, self.issue = step, obs.recorder(), 0.0

    def record(self, name: str, t0: float, t1: float | None = None,
               parent: str | None = "train.step", **attrs) -> float:
        t1 = obs.monotime() if t1 is None else t1
        if self.rec.enabled:
            self.rec.record(name, "train", t0, t1 - t0,
                            trace_id=str(self.step),
                            attrs={"step": self.step, "parent": parent,
                                   **attrs})
        return t1 - t0


#: the step that :meth:`Trainer.run` is in, for the spans recorded inside
#: the functions it calls (none outside a Trainer step)
_STEP: ContextVar[_StepSpans | None] = ContextVar("train_step", default=None)


@contextlib.contextmanager
def _issue(name: str):
    """Span ``name`` around the host's issue of a step's work, when a
    Trainer step is running."""
    spans = _STEP.get()
    t0 = obs.monotime()
    try:
        yield
    finally:
        if spans is not None:
            spans.issue += spans.record(name, t0)


def _alloc_counts(device) -> tuple[int, int] | None:
    """The caching allocator's retries and ``cudaMalloc`` calls so far on
    ``device``, or None off the card."""
    if device.type != "cuda":
        return None
    # the nested form: a seventh of ``memory_stats``' cost, the same counts
    s = torch.cuda.memory_stats_as_nested_dict(device)
    return s["num_alloc_retries"], s["num_device_alloc"]


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


def _failed_anywhere(failed: bool) -> bool:
    """Whether a try failed on any rank of the default process group (an
    ``all_reduce`` MAX of the flag, which every rank calls), or here when
    there is no group."""
    if not dist.is_initialized():
        return failed
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


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
        with _issue("train.grad"):
            return _grad(batch)

    def _grad(batch: dict) -> tuple[torch.Tensor, dict]:
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
    with _issue("train.update"):
        metrics = adamw_update(dict(model.named_parameters()), grads,
                               opt_state, opt_cfg)
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
        stop = start_step + steps
        allocs = (_alloc_counts(self.device) if obs.recorder().enabled
                  else None)
        for step in range(start_step, stop):
            spans = _StepSpans(step)
            token = _STEP.set(spans)
            try:
                allocs = self._step(opt_state, spans, allocs,
                                    last=step + 1 == stop)
            finally:
                _STEP.reset(token)
        return opt_state

    def _step(self, opt_state: dict, spans: _StepSpans, allocs, last: bool):
        """One step of :meth:`run`, its spans in ``spans``; the last step
        of a run joins the checkpoint in flight.  ``allocs`` is the
        allocator's counts as the step begins (None: not read); returns
        them as it ends."""
        step = spans.step
        t_step = obs.monotime()
        batch = {"tokens": torch.from_numpy(
            self.pipeline.batch_at(step)).to(self.device)}
        if self.mesh is not None:
            batch = {"tokens": distribute(batch["tokens"],
                                          ("batch", "seq"), self.mesh,
                                          self.rules)}
        data_wait = obs.monotime() - t_step

        self._sync()
        t0 = obs.monotime()
        spans.record("train.data", t_step, t0)
        tries = 0
        with _rules(self.mesh, self.rules):
            while True:
                err = None
                try:
                    loss, grads = self.grad_fn(batch)
                    t = obs.monotime()
                    self._sync()
                    spans.record("train.grad.sync", t)
                except Exception as e:
                    err = e
                # every rank retries, or none does
                if not _failed_anywhere(err is not None):
                    break
                loss = grads = None
                tries += 1
                if tries > self.tcfg.max_retries:
                    if err is not None:
                        raise err
                    raise RuntimeError(
                        f"step {step}: the forward and backward pass "
                        f"failed on another rank, {tries} tries")
            # writes in place: once, never retried
            metrics = apply_update(self.model, opt_state, loss, grads,
                                   self.opt_cfg)
        del grads
        t = obs.monotime()
        self._sync()
        t1 = obs.monotime()
        spans.record("train.update.sync", t, t1)
        dt = t1 - t0

        if self.tcfg.deadline_s and dt > self.tcfg.deadline_s:
            # straggler mitigation: record, ask the pipeline to rebalance
            self.straggler_events.append({"step": step, "dt": dt})
            if hasattr(self.pipeline, "delay_s"):
                self.pipeline.delay_s = 0.0  # drop the slow path

        t = obs.monotime()
        # on a mesh the loss is a DTensor (a partial sum over the
        # batch axes): its whole value, not this rank's part
        rec = {"step": step, "loss": float(P.whole(metrics["loss"])),
               "grad_norm": float(P.whole(metrics["grad_norm"])),
               "step_time": dt, "data_wait": data_wait,
               "dispatch": spans.issue, "checkpoint": 0.0}
        spans.record("train.readback", t)
        self.history.append(rec)
        if self.ckpt is not None:
            t = obs.monotime()
            saving = (step + 1) % self.tcfg.ckpt_every == 0
            if saving:
                self.ckpt.save(step + 1,
                               self.checkpoint_state(opt_state, step + 1))
            if last:
                self.ckpt.wait()
            if saving or last:
                rec["checkpoint"] = spans.record("train.checkpoint", t)
        if self.profiler is not None:
            t = obs.monotime()
            self.profiler.on_step(rec)
            spans.record("train.hook", t)
        counters = {}
        if allocs is not None:
            now = _alloc_counts(self.device)
            counters = {"num_alloc_retries": now[0] - allocs[0],
                        "num_device_alloc": now[1] - allocs[1]}
            allocs = now
        spans.record("train.step", t_step, parent=None, **counters)
        return allocs

    def checkpoint_state(self, opt_state: dict, data_step: int) -> dict:
        """The reference's checkpoint tree, its leaves named but not built:
        the parameters and moments as :func:`~repro_torch.models.params.
        stack` ``(lazy=True)`` gives them, the optimizer step as an int32
        scalar, the data cursor.  :meth:`CheckpointManager.save
        <repro_torch.checkpoint.CheckpointManager.save>` gathers and
        copies one leaf at a time (every rank calls it on a mesh)."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        return {"params": P.stack(params, lazy=True),
                "opt": {"m": P.stack(opt_state["m"], lazy=True),
                        "v": P.stack(opt_state["v"], lazy=True),
                        "step": np.int32(opt_state["step"])},
                "data": {"step": np.int64(data_step)}}

    def load_checkpoint(self, state: dict) -> dict:
        """Load a restored checkpoint tree (either package's, written on
        any mesh or none) into the model and return its optimizer state.
        On a mesh each parameter and its moments are distributed with the
        parameter's placements, as ``init_opt_state`` lays them; a leaf
        that arrives so placed (``restore(shardings=...)``) is copied as
        it is, not gathered whole again."""
        P.from_reference(self.model, state["params"])
        names = dict(self.model.named_parameters())

        def moment(t, p):
            if (isinstance(p, DTensor) and isinstance(t, DTensor)
                    and t.device_mesh == p.device_mesh
                    and tuple(t.placements) == tuple(p.placements)):
                return t.detach().to(torch.float32, copy=True)  # placed
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
