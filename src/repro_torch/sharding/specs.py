"""Logical-axis sharding rules (DP / TP / EP / SP / FSDP / pod) as DTensor
placements.

Port of :mod:`repro.sharding.specs`.  Model code annotates tensors with
*logical* axis names; a :class:`ShardingRules` table maps logical names to
mesh axes.  Changing the parallelism strategy means swapping rule tables,
never touching model code.

Mesh axes (see ``repro_torch.launch.mesh``):

* ``data`` — data parallel (batch), and the FSDP/ZeRO shard axis
* ``model`` — tensor parallel (heads / ff / vocab / experts)
* ``pod``  — second-level data parallel across pods (hierarchical DP);
             optionally an extra FSDP axis for the largest models

:func:`logical_to_spec` gives, per tensor dim, the mesh axis (or tuple of
axes, or None) that shards it: the content of the reference's
``PartitionSpec``.  :func:`placements` turns that into one DTensor
placement per mesh dim.  Under :func:`set_rules` a plain tensor that meets
a DTensor (a position ``arange``, a mask) is taken as replicated, as XLA
takes a constant; a DTensor is only resharded where a :func:`constrain`
or an op's sharding strategy says so, and an op without a strategy raises.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (str | tuple | None)."""

    rules: dict = field(default_factory=dict)
    mesh_axis_sizes: dict = field(default_factory=dict)

    def axis(self, name: str):
        return self.rules.get(name)

    def size(self, name: str) -> int:
        ax = self.rules.get(name)
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            s = 1
            for a in ax:
                s *= self.mesh_axis_sizes.get(a, 1)
            return s
        return self.mesh_axis_sizes.get(ax, 1)

    def with_overrides(self, **kv) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kv)
        return replace(self, rules=d)


def train_rules(mesh_axis_sizes: dict, *, fsdp: bool = False,
                pod_in_batch: bool = True, seq_shard: bool = False) -> ShardingRules:
    """Default DP+TP rules; ``fsdp`` adds ZeRO-3 param sharding over data;
    ``seq_shard`` puts sequence over `model` between blocks (SP)."""
    batch_axes = ("pod", "data") if (pod_in_batch and "pod" in mesh_axis_sizes) else ("data",)
    return ShardingRules(rules={
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "tokens": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "seq": "model" if seq_shard else None,
        "kv_seq": None,
        "embed": None,           # activation d_model: replicated
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "expert_ff": None,
        "moe_cap": None,
        "layers": None,
        # FSDP/ZeRO shards params over ALL batch axes (data, and pod when
        # present) — a 314B model only fits when both axes participate
        "fsdp": (batch_axes if len(batch_axes) > 1 else batch_axes[0]) if fsdp else None,
        "ssm_inner": "model",
        "ssm_state": None,
        "conv_k": None,
    }, mesh_axis_sizes=dict(mesh_axis_sizes))


def decode_rules(mesh_axis_sizes: dict, *, kv_seq_shard: bool = False,
                 fsdp: bool = False) -> ShardingRules:
    """Decode/serving rules: batch over data; long-context KV over data (SP).

    With ``kv_seq_shard`` (batch too small for the data axis, e.g.
    long_500k's batch=1) the *sequence* of the KV cache takes the data
    axis and batch/tokens go unsharded.
    """
    r = train_rules(mesh_axis_sizes, fsdp=fsdp, pod_in_batch=True)
    if kv_seq_shard:
        return r.with_overrides(kv_seq="data", seq=None, batch=None,
                                tokens=None)
    return r.with_overrides(kv_seq=None, seq=None)


# -- the active (mesh, rules), process-wide --------------------------------

class _Ctx:
    mesh = None
    rules: ShardingRules | None = None


# process-wide, not thread-local: on a card the autograd engine runs the
# backward, and so a checkpointed block's recomputation, on a thread of
# its own, which must see the rules the forward ran under
_ctx = _Ctx()


@contextlib.contextmanager
def set_rules(mesh, rules: ShardingRules):
    """Make ``(mesh, rules)`` the active pair for the process (the
    backward's threads too); plain tensors meeting DTensors count as
    replicated meanwhile."""
    from torch.distributed.tensor.experimental import implicit_replication
    old = (_ctx.mesh, _ctx.rules)
    _ctx.mesh, _ctx.rules = mesh, rules
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.mesh, _ctx.rules = old


def current_rules() -> ShardingRules | None:
    return _ctx.rules


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def logical_to_spec(logical_axes: tuple, rules: ShardingRules | None = None
                    ) -> tuple:
    """Per tensor dim, the mesh axis (str), axes (tuple, major first) or
    None that shards it: a ``PartitionSpec``'s entries.  A mesh axis is
    used at most once; a compound logical name such as ``("fsdp", "ff")``
    takes every name's axis that is still free."""
    rules = rules or _ctx.rules
    if rules is None:
        return ()
    parts = []
    used: set = set()

    def _take(ax):
        # a mesh axis may appear at most once in a PartitionSpec
        if ax is None:
            return None
        if isinstance(ax, tuple):
            ax2 = tuple(a for a in ax if a not in used)
            used.update(ax2)
            return ax2 if ax2 else None
        if ax in used:
            return None
        used.add(ax)
        return ax

    for name in logical_axes:
        if name is None:
            parts.append(None)
            continue
        if isinstance(name, tuple):  # compound, e.g. ("fsdp", "ff")
            axes = tuple(a for a in (_take(rules.axis(n)) for n in name) if a)
            flat = tuple(x for a in axes for x in ((a,) if isinstance(a, str) else a))
            parts.append(flat if flat else None)
            continue
        parts.append(_take(rules.axis(name)))
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(d)`` where
    tensor dim ``d`` takes that mesh axis in ``spec``, else
    ``Replicate()``.

    A dim split over several axes is split major-first, as XLA splits it
    for a ``PartitionSpec`` entry ``("pod", "data")``.  DTensor splits a
    dim in mesh-dim order, so that is the same shard when the axes follow
    the mesh's order; another order would need ``_StridedShard`` and
    raises, since no rule table of the repo asks for one."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"tensor dim {d} is split over mesh axes {axes} against the "
                f"mesh's order {names}: that shard is a _StridedShard")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, mesh_axis_sizes: dict) -> tuple:
    """The largest device's shard of ``shape`` under ``spec``: each split
    dim ceil-divided by the product of its axes' sizes (XLA pads uneven
    shards; DTensor gives rank 0 the ceil)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in axes:
            n *= mesh_axis_sizes[a]
        out[d] = -(-out[d] // n)
    return tuple(out)


def constrain(x, *logical_axes):
    """Reshard a DTensor ``x`` to the logical axes' placements under the
    active rules, and its gradient to the same placements in the backward
    pass: the reference's ``with_sharding_constraint``, whose transpose
    constrains the cotangent alike.  A no-op on a plain tensor or without
    rules."""
    mesh, rules = _ctx.mesh, _ctx.rules
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, mesh, placements(
        logical_to_spec(tuple(logical_axes), rules), mesh))


def _constrain_fn():
    import torch

    from torch.distributed.tensor import Replicate

    class Constrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh, placement):
            ctx.mesh, ctx.placement = mesh, placement
            # the gradient goes back placed as x was, a partial sum as a
            # replicated value (the gradient of a sum is a broadcast)
            ctx.source = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
            return x.redistribute(mesh, placement)

        @staticmethod
        def backward(ctx, grad):
            # a partial-sum gradient is summed here, as XLA sums it where
            # the constraint stands, not carried on to the next op
            grad = grad.redistribute(ctx.mesh, ctx.placement)
            return grad.redistribute(ctx.mesh, ctx.source), None, None

    return Constrain


_Constrain = _constrain_fn()


def zeros(shape: tuple, logical: tuple, dtype, device):
    """A zero buffer of ``shape``: plain, or under active rules a DTensor
    placed by ``logical`` whose shards alone are allocated (a cache the
    model fills in place)."""
    import torch
    mesh, rules = _ctx.mesh, _ctx.rules
    if mesh is None or rules is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    spec = logical_to_spec(tuple(logical), rules)
    local = torch.zeros(local_shape(tuple(shape), spec,
                                    rules.mesh_axis_sizes),
                        dtype=dtype, device=device)
    return from_local(local, mesh, placements(spec, mesh), shape)


def from_local(local, mesh, placement: tuple, shape: tuple):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (contiguous strides; no collective checks it)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placement, run_check=False,
                              shape=tuple(shape), stride=tuple(reversed(stride)))


def local_offset(shape: tuple, mesh, placement: tuple) -> tuple:
    """``(local shape, global offset)`` of this rank's shard of a tensor
    of global ``shape`` placed by ``placement`` (DTensor's chunking)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape_l, off = compute_local_shape_and_global_offset(
        tuple(shape), mesh, tuple(placement))
    return tuple(shape_l), tuple(off)


def _sum_partials_fn():
    import torch

    from torch.distributed.tensor import Replicate

    class SumPartials(torch.autograd.Function):
        @staticmethod
        def forward(ctx, local, mesh, source, target, shape):
            ctx.mesh, ctx.source = mesh, source
            return from_local(local, mesh, source, shape).redistribute(
                mesh, target)

        @staticmethod
        def backward(ctx, grad):
            # each rank's contribution to a sum gets the whole gradient
            grad = grad.redistribute(ctx.mesh, [
                Replicate() if p.is_partial() else p for p in ctx.source])
            return grad.to_local(), None, None, None, None

    return SumPartials


_SumPartials = _sum_partials_fn()


def sum_partials(local, mesh, source: tuple, target: tuple, shape: tuple):
    """The DTensor of global ``shape`` placed by ``target`` whose value is
    the sum, over each ``Partial`` mesh dim of ``source``, of every rank's
    ``local``: a reduce-scatter or all-reduce.  The gradient of ``local``
    is the whole gradient on each ``Partial`` dim, as ``from_local``'s is
    in newer torch (older ones divide it by the dim's size)."""
    return _SumPartials.apply(local, mesh, tuple(source), tuple(target),
                              tuple(shape))


def shardwise(fn, t):
    """An elementwise ``fn`` of a DTensor ``t`` computed on each shard and
    placed as ``t`` (a partial sum made whole first), for ops DTensor has
    no strategy for (``log_sigmoid``'s backward); on a plain tensor,
    ``fn(t)``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return fn(t)
    mesh = t.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    t = t.redistribute(mesh, pl)
    return from_local(fn(t.to_local()), mesh, pl, tuple(t.shape))


def distribute(t, logical: tuple, mesh, rules: ShardingRules):
    """``t``, the same on every rank, as a DTensor placed by ``logical``
    under ``rules`` (each rank keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(
        logical_to_spec(tuple(logical), rules), mesh))


def is_sharded(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor split along tensor dim ``dim``."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return False
    dim = dim % x.ndim
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)
