"""Parameter definitions, initialisation, and the weights-across functions.

Port of :mod:`repro.models.params`.  Models declare their parameters as a
nested dict of :class:`ParamDef` in the reference's layout: each layer
stack is one ``(L, ...)`` array per name under its group (:data:`STACKED`:
``layers``, the VLM's ``cross``, whisper's ``enc`` and ``dec``, xLSTM's
``mlstm`` and ``slstm``).  The port's modules hold one parameter per layer
instead (``<group>.<i>.<name>``), so this module also converts between the
two:

* :func:`unstack` / :func:`stack` — a reference tree and a flat dict keyed
  by module parameter name;
* :func:`from_reference` loads a reference tree (numpy arrays, as
  ``np.asarray`` of the JAX tree gives, or tensors) into a model;
* :func:`to_reference` turns a model's parameters back into that tree.

On a mesh (:func:`distribute_params`) the parameters are DTensors: the
two directions gather each one whole (a collective: every rank calls them
in the same order) and distribute each array onto its parameter's own
mesh and placements, so a tree written on one mesh loads onto another.
:func:`shardings` gives the reference-layout tree of
:class:`~repro_torch.sharding.specs.NamedSharding` that
:meth:`~repro_torch.checkpoint.CheckpointManager.restore` takes.

:func:`shapedtypes` and :func:`specs` give the dry-run each module
parameter's shape and sharding: the def of ``<group>/<name>`` with its
leading (layer) axis dropped, under ``unstack``'s name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple              # logical axis name (or None) per dim
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 0.0          # 0 -> 1/sqrt(fan_in)

    def fan_in(self) -> int:
        return (int(np.prod(self.shape[:-1])) if len(self.shape) > 1
                else int(self.shape[0]))


def flatten(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict in sorted key order (the
    order ``jax.tree_util`` flattens a dict in), paths joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def count(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in flatten(defs)))


def init_params(defs, generator: torch.Generator, dtype, device) -> dict:
    """A reference-layout tree of tensors on ``device`` in ``dtype``.

    Normal draws are f32 from ``generator`` (which must live on
    ``device``'s type), scaled, then cast, as the reference does with its
    PRNG key; the values differ from ``jax.random``'s."""
    dtype = torch_dtype(dtype)

    def mk(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        scale = d.scale or 1.0 / math.sqrt(max(d.fan_in(), 1))
        if d.init == "embed":
            scale = 0.02  # safe for tied input/output embeddings
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)

    return _nest((path, mk(d)) for path, d in flatten(defs))


def _nest(pairs) -> dict:
    """``(path, leaf)`` pairs, paths joined by ``/``, as a nested dict."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def unstacked_defs(defs) -> dict[str, ParamDef]:
    """ParamDef tree -> ``{module parameter name: ParamDef}``, each stacked
    ``<group>/<name>`` def becoming ``<group>.<i>.<name>`` without its
    leading axis (:func:`unstack`'s naming)."""
    flat = {}
    for path, d in flatten(defs):
        parts = path.split("/")
        if parts[0] in STACKED:
            one = ParamDef(d.shape[1:], d.logical[1:], d.init, d.scale)
            for i in range(d.shape[0]):
                flat[".".join([parts[0], str(i), *parts[1:]])] = one
        else:
            flat[".".join(parts)] = d
    return flat


def shapedtypes(defs, dtype) -> dict[str, torch.Tensor]:
    """``{module parameter name: meta tensor}`` in ``dtype``: the shapes
    of :func:`unstacked_defs`, nothing allocated."""
    dtype = torch_dtype(dtype)
    return {n: torch.empty(d.shape, dtype=dtype, device="meta")
            for n, d in unstacked_defs(defs).items()}


def specs(defs, rules) -> dict[str, tuple]:
    """``{module parameter name: spec}``, each the
    :func:`~repro_torch.sharding.specs.logical_to_spec` of its unstacked
    def's logical axes under ``rules``."""
    from repro_torch.sharding.specs import logical_to_spec
    return {n: logical_to_spec(d.logical, rules)
            for n, d in unstacked_defs(defs).items()}


def shardings(defs, rules, mesh) -> dict:
    """The reference-layout tree of
    :class:`~repro_torch.sharding.specs.NamedSharding` of ``defs`` under
    ``rules`` on ``mesh``: each leaf the placements of its whole (stacked)
    def, as the reference's ``NamedSharding(mesh, spec)`` of ``specs``."""
    from repro_torch.sharding.specs import NamedSharding, logical_to_spec
    return _nest((path, NamedSharding.of(logical_to_spec(d.logical, rules),
                                         mesh))
                 for path, d in flatten(defs))


def distribute_params(model: torch.nn.Module, mesh, rules) -> torch.nn.Module:
    """Lay ``model``'s parameters onto ``mesh`` under ``rules``, in place:
    each becomes a DTensor parameter placed by its def's spec
    (:func:`specs`), holding its current values (rank 0's, scattered)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.specs import placements
    spec = specs(model.param_defs(), rules)
    for name, p in list(model.named_parameters()):
        _set_param(model, name, distribute_tensor(
            p.detach(), mesh, placements(spec[name], mesh)), p.requires_grad)
    return model


def _set_param(model, name: str, t: torch.Tensor, requires_grad: bool):
    *path, leaf = name.split(".")
    setattr(model.get_submodule(".".join(path)), leaf,
            torch.nn.Parameter(t, requires_grad=requires_grad))


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto each rank (``full_tensor``, a
    collective); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config's name for it (``"bfloat16"``) or
    itself."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


# the reference's stacked groups: one (L, ...) array per name, scanned
STACKED = frozenset({"layers", "cross", "enc", "dec", "mlstm", "slstm"})


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def unstack(tree: dict) -> dict[str, torch.Tensor]:
    """Reference tree -> ``{module parameter name: tensor}``: each stacked
    ``<group>/<name>`` array becomes ``<group>.<i>.<name>``."""
    flat = {}
    for path, leaf in flatten(tree):
        parts = path.split("/")
        t = _tensor(leaf)
        if parts[0] in STACKED:
            for i in range(t.shape[0]):
                flat[".".join([parts[0], str(i), *parts[1:]])] = t[i]
        else:
            flat[".".join(parts)] = t
    return flat


def stack(named: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`unstack`: ``{name: tensor}`` -> reference tree,
    the per-layer tensors stacked along a new axis 0; DTensors gathered
    whole first (:func:`whole`)."""
    tree: dict = {}
    per_layer: dict[tuple[str, str], dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        t = whole(t)
        parts = name.split(".")
        if parts[0] in STACKED:
            key = (parts[0], ".".join(parts[2:]))
            per_layer.setdefault(key, {})[int(parts[1])] = t
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    for (group, name), by_index in per_layer.items():
        tree.setdefault(group, {})[name] = torch.stack(
            [by_index[i] for i in sorted(by_index)])
    return tree


@torch.no_grad()
def from_reference(model: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Load a reference-layout tree into ``model``'s parameters, in place.

    Each parameter takes the tree's values and dtype and stays on the
    model's device; a DTensor parameter stays on its mesh with its
    placements (a DTensor leaf already so placed is taken as it is, any
    other leaf gathered whole and distributed).  Raises unless the tree's
    names and shapes are exactly the model's."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    flat = unstack(tree)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"reference tree and model differ: missing "
                         f"{sorted(set(params) - set(flat))[:5]}, extra "
                         f"{sorted(set(flat) - set(params))[:5]}")
    for name, p in params.items():
        src = flat[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"model shape {tuple(p.shape)}")
        if not isinstance(p, DTensor):
            p.data = whole(src).to(device=p.device).clone()
        elif (isinstance(src, DTensor) and src.device_mesh == p.device_mesh
              and tuple(src.placements) == tuple(p.placements)):
            _set_param(model, name, src.detach().clone(), p.requires_grad)
        else:
            _set_param(model, name, distribute_tensor(
                whole(src).to(p.device), p.device_mesh, p.placements),
                p.requires_grad)
    return model


@torch.no_grad()
def to_reference(model: torch.nn.Module) -> dict:
    """The model's parameters as a reference-layout tree of CPU tensors
    (DTensors gathered whole)."""
    return stack({n: whole(p.detach()).cpu()
                  for n, p in model.named_parameters()})
