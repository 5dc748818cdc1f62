"""The reference's training: the first steps of a run, followed in float32
from the same weights and batches the benchmark handed to the program,
and the readings that the comparison takes from them.

Readings (each a dict of plain numbers):

* ``loss``: each step's loss;
* ``grad``: each leaf's norm of the first gradient as the optimizer gets
  it (clipped to the global norm), and ``grad_sample`` a fixed sample of
  its elements;
* ``change``: each leaf's norm of its change over the steps, as the
  parameters are stored after the last one, and ``change_sample``.

Imports torch, numpy and this benchmark's own files alone.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import torch

from portbench import inputs
from portbench.judge import sample
from portbench.reference.common import adamw_step, mm_f32, mm_fp8, no_tf32

PRECISIONS = {"float32": mm_f32, "float8": mm_fp8}


# the families whose module bears the name of the configuration it was written for
MODULES = {"moe": "qwen3_moe", "hybrid": "zamba2"}


def family(run: dict):
    """The reference module of a configuration's family:
    ``portbench/reference/<name>.py``, ``<name>`` the family's entry in
    ``MODULES`` or else the family itself, so that a new family is a new
    file.  It gives ``param_specs(run)``, ``loss(params, tokens, run, mm)``
    and, where the family has a count, ``step_flops(run, B, S)``."""
    name = MODULES.get(run["family"], run["family"])
    module = f"portbench.reference.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise SystemExit(f"portbench: no reference for family {run['family']!r} "
                         f"({Path(__file__).parent / f'{name}.py'})") from None


@torch.no_grad()
def change_readings(params: dict, specs, seed: int) -> dict:
    """Each leaf's change, ``params[name]`` less its weights as drawn from
    ``seed`` (one draw group at a time): ``{"change": norms,
    "change_sample": samples}``."""
    norms, samples = {}, {}
    p0 = next(iter(params.values()))
    for g in inputs.groups(specs):
        for name, w0 in inputs.draw_group(specs, g, seed, p0.device,
                                          p0.dtype).items():
            d = params[name].float() - w0.float()
            norms[name] = float(torch.linalg.vector_norm(d))
            samples[name] = sample(d)
            del w0, d
    return {"change": norms, "change_sample": samples}


@torch.no_grad()
def first_gradient(m: dict, b1: float) -> dict:
    """The first gradient as AdamW got it, from its first moment after one
    step (``(1 - b1) * g``): ``{"grad": norms, "grad_sample": samples}``."""
    names = list(m)
    norms = torch.stack(torch._foreach_norm([m[n] for n in names]))
    return {"grad": {n: g / (1 - b1) for n, g in zip(names, norms.tolist())},
            "grad_sample": {n: sample(m[n]) / (1 - b1) for n in names}}


def follow(run: dict, seed: int, batch_at, hp: dict, steps: int, device,
           precision: str = "float32", rows: int | None = None) -> dict:
    """Train the reference ``steps`` steps from the weights of ``seed`` on
    ``batch_at(0..steps-1)`` (the first ``rows`` rows of each, where
    given: a fault the check must catch) and return its readings."""
    no_tf32()
    mm = PRECISIONS[precision]
    mod = family(run)
    specs = mod.param_specs(run)
    dtype = getattr(torch, run["dtype"])
    params: dict = {}
    for g in inputs.groups(specs):
        params.update(inputs.draw_group(specs, g, seed, device, dtype))
    names = list(params)
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
         for n, p in params.items()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    losses, first = [], {}
    for step in range(steps):
        tokens = torch.from_numpy(batch_at(step)).to(device)
        if rows is not None:
            tokens = tokens[:rows]
        leaves = {n: params[n].float().requires_grad_() for n in names}
        loss = mod.loss(leaves, tokens, run, mm)
        grads = dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))
        del leaves
        with torch.no_grad():
            adamw_step(params, grads, m, v, step + 1, hp)
            if step == 0:
                first = first_gradient(m, hp["b1"])
        losses.append(float(loss.detach()))
        del grads, loss
    del m, v
    return {"loss": losses, **first, **change_readings(params, specs, seed)}
