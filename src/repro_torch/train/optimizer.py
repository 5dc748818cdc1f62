"""AdamW over a model's parameter dict, with the reference's exact math.

Port of :mod:`repro.train.optimizer` (``torch.optim.AdamW`` differs:
it decays weights outside the update, uses no warmup and no global-norm
clip).  Here, as in the reference:

* moments are f32 whatever the parameter dtype;
* the global gradient norm is taken in f32 and clips to ``grad_clip``;
* the learning rate warms up linearly on ``step + 1``;
* weight decay sits inside ``delta`` and is multiplied by ``lr``;
* the update is computed in f32 and cast back to the parameter dtype.

The reference returns new trees; this version updates the parameters and
the moments in place, which keeps one copy of the ~7 GB training state of
a 0.6B model on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: dict[str, torch.Tensor],
                   moment_dtype=torch.float32) -> dict:
    """``{"m": {name: zeros}, "v": {name: zeros}, "step": 0}``."""
    return {"m": {n: torch.zeros_like(p, dtype=moment_dtype)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=moment_dtype)
                  for n, p in params.items()},
            "step": 0}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig) -> dict:
    """Apply one step to ``params`` and ``state`` in place; returns the
    metrics ``{"grad_norm": 0-d tensor, "lr": float}``.  The schedule and
    bias corrections are f32 scalars, as the reference's are."""
    step = state["step"] + 1
    names = list(params)
    gnorm = global_norm(grads[n] for n in names)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    warm = torch.clamp(_f32(step) / max(cfg.warmup_steps, 1), max=1.0)
    lr = float(cfg.lr * warm)
    b1c = float(1.0 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1.0 - _f32(cfg.b2) ** _f32(step))
    for n in names:
        p, m, v = params[n], state["m"][n], state["v"][n]
        g = grads[n].float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
