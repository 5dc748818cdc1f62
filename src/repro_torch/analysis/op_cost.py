"""Per-device cost of a step, counted over the aten ops it runs.

The counterpart of :mod:`repro.analysis.hlo_cost`, which re-derives costs
from compiled HLO.  This module counts the aten ops that eager PyTorch
dispatches, not HLO: :class:`OpCostMode` is a ``TorchDispatchMode`` that
lets DTensor unwrap each op and counts the local (per-rank) ops it then
runs on rank 0's shards, ``meta`` tensors in the dry-run:

* **flops** — a dot (``mm``, ``bmm``, ``addmm``, convolutions, ...) is
  ``2 x result elements x K``, from ``torch.utils.flop_counter``'s
  registry, and is also summed apart as ``dot_flops``; any other op is
  its result elements (a reduction: its input's), the reference's rule.
* **bytes** — each op moves its operands plus its result.  Eager PyTorch
  fuses nothing, so this is the HBM traffic of the port's own step, with
  every intermediate written and read back; views move nothing.
* **collective bytes** — the operand bytes of each ``_c10d_functional``
  all-reduce, all-gather, reduce-scatter and all-to-all, under the
  reference's kind names; they also count as HBM bytes.
* **peak** — the most bytes of local storage alive at once: the tensors
  passed to :meth:`OpCostMode.track` (the step's arguments) and every
  storage an op touched or made, each until it is freed.

Ops that DTensor runs at global shapes to derive an output's metadata
(``_sharding_prop.py``) are run and not counted.  :meth:`OpCostMode.repeat`
scales what is counted inside it, as ``hlo_cost`` scales a ``while`` body
by its trip count.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# ops that move no data: views, metadata, allocation without a write
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "select", "slice", "narrow", "squeeze", "unsqueeze", "as_strided",
    "alias", "detach", "split", "split_with_sizes", "chunk", "unbind",
    "unflatten", "diagonal", "lift_fresh", "empty", "empty_strided",
    "empty_like", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "device", "layout", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_to_copy_meta", "wait_tensor",
    "_has_compatible_shallow_copy_type", "view_as_real", "view_as_complex",
    "_reshape_alias", "expand_as", "view_as", "resize_",
    "_wrap_tensor_autograd",
}
# reductions: one op per input element
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "any", "all",
    "argmax", "argmin", "cumsum", "_softmax", "_log_softmax",
}
# c10d_functional collectives under the reference's kind names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class Cost:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    peak_bytes: int = 0
    ops: int = 0


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)) and all(
            not isinstance(x, (list, tuple, dict)) for x in tree):
        return [t for t in tree if isinstance(t, torch.Tensor)]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_prop() -> bool:
    """Whether DTensor's sharding propagation is running this op."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class OpCostMode(TorchDispatchMode):
    """Counts the local ops run while it is active; on ``meta`` tensors
    nothing is allocated.  The result is :attr:`cost`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._scale = 1
        self._alive: dict[int, int] = {}
        self._live = 0
        self._read: set[int] = set()

    # -- memory ---------------------------------------------------------------
    def track(self, tensors) -> None:
        """Count these tensors' storages as alive from now on."""
        for t in _tensors(tensors):
            from torch.distributed.tensor import DTensor
            self._see(t.to_local() if isinstance(t, DTensor) else t)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def read(self, t: torch.Tensor) -> bool:
        """Whether an op read ``t``'s storage (``t`` alive throughout)."""
        return id(t.untyped_storage()) in self._read

    def _see(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._alive:
            return
        n = s.nbytes()
        self._alive[key] = n
        self._live += n
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._alive.pop(key, 0)

    # -- counting -------------------------------------------------------------
    @contextlib.contextmanager
    def repeat(self, k: int):
        """Scale what is counted inside by ``k`` (the peak is not)."""
        old = self._scale
        self._scale = old * k
        try:
            yield
        finally:
            self._scale = old

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor unwraps; its local ops come back
        if _in_sharding_prop():
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry and \
                func._can_decompose():
            # a composite op (seen whole under inference mode) counts as
            # the ops it decomposes into, as under autograd
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c, k = self.cost, self._scale
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        for t in ins + outs:
            self._see(t)
        self._read.update(id(t.untyped_storage()) for t in ins)
        c.peak_bytes = max(c.peak_bytes, self._live)
        name = func._overloadpacket.__name__
        if name in _FREE:
            return
        c.ops += k
        op_bytes = sum(_nbytes(t) for t in ins)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            c.coll_bytes += k * op_bytes
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + k * op_bytes
            c.bytes += k * op_bytes
            return
        c.bytes += k * (op_bytes + sum(_nbytes(t) for t in outs))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            c.dot_flops += k * f
            c.flops += k * f
        elif name in _REDUCTIONS and ins:
            c.flops += k * max(t.numel() for t in ins)
        else:
            c.flops += k * sum(t.numel() for t in outs)
