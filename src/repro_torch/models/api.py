"""Model API: build an architecture and count its parameters and FLOPs.

Port of :mod:`repro.models.api` (``build_model``, ``n_params``,
``n_active_params``, ``model_flops``).  The sharding-rule selection and the
input ShapeDtypeStructs of the dry-run belong to the mesh slice
(``ROADMAP.md`` §1) and are not here.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import params as P
from repro_torch.models.lm import TransformerLM


def build_model(cfg: ModelConfig, *, device="cpu", dtype=None):
    """The model for ``cfg``, its parameters allocated uninitialised on
    ``device`` (``device="meta"`` allocates nothing).  Only the dense
    family is ported; the others raise ``NotImplementedError``."""
    return TransformerLM(cfg, device=device, dtype=dtype)


def n_params(cfg: ModelConfig) -> int:
    return P.count(build_model(cfg, device="meta").param_defs())


def n_active_params(cfg: ModelConfig) -> int:
    """Parameters active per token: all of them in the dense family (the
    MoE top-k share comes with that family)."""
    return n_params(cfg)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D tokens (train) / 2*N*D (inference step)."""
    n = n_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one decoded token per sequence
