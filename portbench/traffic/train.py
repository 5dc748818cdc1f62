"""Training traffic: the port's profiled Trainer, as its train launcher
builds it, over token batches drawn from the seed.

Workload parameters: ``batch``, ``seq`` (the batch's rows and tokens a
row), ``trace_steps`` (the steps a traced run profiles once its window
has closed) and ``limits`` (each compared number's limit).

A run:

1. set-up (``setup_s``, from process start): the model in the
   configuration's dtype on the card, the weights drawn there from the
   seed, fresh AdamW state, the port's ``Profiler`` as the Trainer's hook;
   the first ``FOLLOWED`` steps through ``Trainer.run``, the same call and
   feed as the window's, after the first of which the first gradient's
   norms are read from the optimizer's moments, and after the last the
   parameters' change;
2. the window: whole steps through ``Trainer.run`` until ``seconds`` have
   passed, the step in progress finished (``train_tokens_per_s``);
3. with ``trace``, the per-layer spans were taken around the window's
   calls; then ``trace_steps`` more steps under ``torch.profiler``, the
   peak memory, and each metric's probe;
4. the profile written into ``TMPDIR``, the program freed, and the
   reference's ``FOLLOWED`` steps; then the comparison.
"""
from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from collections import defaultdict

import torch

from portbench import inputs, judge, profile_file, timing
from portbench.reference import train as ref_train

FOLLOWED = 3
HP = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
      "grad_clip": 1.0, "warmup_steps": 10}
SPANS = ("data", "grad", "update", "measure")


class Live:
    """The running program, as the metrics' probes see it: its model, the
    model's ``ModelConfig``, the cell's workload, the seed and the
    device."""

    def __init__(self, trainer, workload: dict, seed: int):
        self.model, self.cfg = trainer.model, trainer.model.cfg
        self.workload, self.seed, self.device = workload, seed, trainer.device


def build(ctx, device):
    """The Trainer as ``repro_torch.launch.train`` builds it (with
    ``--profile-dir``), its fresh optimizer state, and the weights drawn
    from the seed."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.api import build_model
    from repro_torch.profiling import Profiler
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    run, wl = ctx.config["run"], ctx.workload
    model = build_model(ModelConfig(**run), device=device)
    specs = ref_train.family(run).param_specs(run)
    inputs.load_into(model, specs, ctx.seed)
    feed = inputs.TokenBatches(run["vocab_size"], wl["batch"], wl["seq"],
                               ctx.seed)
    profiler = Profiler({"rank": 0, "stream": 0, "kind": "host"})
    opt_cfg = AdamWConfig(lr=HP["lr"], b1=HP["b1"], b2=HP["b2"],
                          eps=HP["eps"], weight_decay=HP["weight_decay"],
                          grad_clip=HP["grad_clip"],
                          warmup_steps=HP["warmup_steps"])
    tr = Trainer(model, opt_cfg, TrainerConfig(steps=FOLLOWED, deadline_s=30.0),
                 feed, profiler=profiler)
    return tr, init_opt_state(dict(model.named_parameters())), specs


def first_steps(tr, opt, specs, seed: int) -> dict:
    """Run the first ``FOLLOWED`` steps and take the program's readings."""
    tr.run(opt, start_step=0, steps=1)
    first = ref_train.first_gradient(opt["m"], HP["b1"])
    tr.run(opt, start_step=1, steps=FOLLOWED - 1)
    params = {n: p.detach() for n, p in tr.model.named_parameters()}
    return {"loss": [h["loss"] for h in tr.history[:FOLLOWED]], **first,
            **ref_train.change_readings(params, specs, seed)}


class Spans:
    """Host spans around the window's calls into each layer, from the
    benchmark's side: ``record_function`` ranges for the profiler and
    their host seconds, those of ``grad`` and ``update`` to a
    synchronise."""

    def __init__(self, device):
        self.seconds = defaultdict(list)
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def wrap(self, name: str, fn, sync: bool = False):
        from torch.profiler import record_function

        def wrapped(*a, **kw):
            t = time.perf_counter()
            with record_function(name):
                out = fn(*a, **kw)
                if sync:
                    self.sync()
            self.seconds[name].append(time.perf_counter() - t)
            return out
        return wrapped


def instrument(tr, spans: Spans):
    """Wrap the Trainer's data, gradient, update and measurement calls;
    returns a function that undoes it."""
    import repro_torch.train.loop as loop
    feed, grad_fn, on_step = tr.pipeline.batch_at, tr.grad_fn, tr.profiler.on_step
    apply_update = loop.apply_update
    tr.pipeline.batch_at = spans.wrap("data", feed)
    tr.grad_fn = spans.wrap("grad", grad_fn, sync=True)
    tr.profiler.on_step = spans.wrap("measure", on_step)
    loop.apply_update = spans.wrap("update", apply_update, sync=True)

    def undo():
        tr.pipeline.batch_at, tr.grad_fn = feed, grad_fn
        tr.profiler.on_step = on_step
        loop.apply_update = apply_update
    return undo


def window(tr, opt, start: int, seconds: float):
    """Whole steps through ``Trainer.run`` until ``seconds`` have passed;
    returns ``(steps, seconds)``."""
    step = start
    t = time.perf_counter()
    while True:
        tr.run(opt, start_step=step, steps=1)
        step += 1
        if time.perf_counter() - t >= seconds:
            return step - start, time.perf_counter() - t


def _device_info(device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def free() -> None:
    """Return what the dropped program held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program(ctx, device, fault=None):
    """Set-up, window, traced steps and probes of the program; returns
    plain data only, so that the program's state is freed on return."""
    wl, run_cfg = ctx.workload, ctx.config["run"]
    tr, opt, specs = build(ctx, device)
    if fault is not None:
        fault(tr)
    prog = first_steps(tr, opt, specs, ctx.seed)
    setup_s = time.perf_counter() - ctx.t0

    spans = Spans(device)
    undo = instrument(tr, spans) if ctx.trace else (lambda: None)
    steps, window_s = window(tr, opt, FOLLOWED, ctx.seconds)
    done = FOLLOWED + steps
    hist = tr.history[FOLLOWED:done]
    record = {"run": run_cfg, "workload": wl, "steps": steps,
              "window_s": window_s, "tokens": steps * wl["batch"] * wl["seq"],
              "step_time_s": [h["step_time"] for h in hist],
              "spans": {k: list(v) for k, v in spans.seconds.items()},
              "trace": None, "probes": {}, "setup_s": setup_s}
    if ctx.trace and device.type == "cuda":
        def one():
            tr.run(opt, start_step=len(tr.history), steps=1)
        record["trace"] = timing.traced(one, wl["trace_steps"], SPANS)
    undo()
    record["peak"] = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
    if ctx.trace:
        live = Live(tr, wl, ctx.seed)
        for name, mod in ctx.metrics.items():
            if hasattr(mod, "probe"):
                record["probes"][name] = mod.probe(live)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "worker0.rprf")
        tr.profiler.finish(path)
        profile = profile_file.read(path)
    numbers = judge.profile_gaps(profile, len(tr.history),
                                 [h["step_time"] for h in tr.history])
    numbers["window_nonfinite"] = sum(not math.isfinite(h["loss"]) for h in hist)
    return prog, record, numbers


def run(ctx, device: str | None = None, fault=None) -> dict:
    """One run of a training cell (module docstring).  ``fault``, for the
    check's own tests, breaks the Trainer before set-up (``fault(tr)``)."""
    device = torch.device(device or ctx.device)
    wl, run_cfg = ctx.workload, ctx.config["run"]
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    prog, record, numbers = program(ctx, device, fault)
    free()

    ref = ref_train.follow(run_cfg, ctx.seed,
                           inputs.TokenBatches(run_cfg["vocab_size"], wl["batch"],
                                               wl["seq"], ctx.seed).batch_at,
                           HP, FOLLOWED, device)
    found = judge.gaps(prog, ref)
    numbers.update({k: found[k] for k in judge.TRAINING})
    correct, compared = judge.verdict(numbers, wl["limits"])

    if ctx.trace:
        metrics = {}
        for name, mod in ctx.metrics.items():
            value = mod.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {"train_tokens_per_s": {"value": record["tokens"] / record["window_s"],
                                          "unit": "tokens/s"},
                   "setup_s": {"value": record["setup_s"], "unit": "s"}}
    out = {"correct": correct, "attempted": record["steps"],
           "failed": numbers["window_nonfinite"], "metrics": metrics,
           "device": _device_info(device, record["peak"])}
    if record["trace"]:
        out["device"].update(busy_s=record["trace"]["busy_s"],
                             window_s=record["trace"]["window_s"])
        out["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    out["readings"] = {"losses": prog["loss"], "ref_losses": ref["loss"],
                       **{k: found[k] for k in judge.TRAINING if k not in wl["limits"]},
                       **{k: found[k] for k in judge.LEAVES}}
    out["compared"] = compared
    return out
