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

**Loops counted by their trip count.**  A model loop written under
:func:`~repro_torch.models.layers.counted_loop` (the sLSTM's loop over
time, one step a position) runs one iteration while an
:class:`OpCostMode` is active and no gradient is taken, counted ``n``
times (FLOPs, bytes, collectives), as the reference's ``lax.scan`` body
is.  The peak is reckoned for what the loop keeps alive: every storage
the one iteration made that is still alive at its end stands for ``n``
of them (the stacked outputs) until it is freed, but for the carries the
loop names, which the next step replaces; and the peak is at least the
iteration's own peak plus the other ``n - 1`` iterations' kept storages,
as at the last step of the whole loop.  A loop that takes a gradient
runs whole, since its backward runs outside the loop.

**Collectives counted apart.**  The collectives run inside a
:func:`~repro_torch.models.layers.cost_scope`, and those that the
backward of the autograd nodes made there runs, are also summed under
its name in ``Cost.coll_by_scope``: the sorted MoE dispatch's
whole-buffer sums, the port's way of crossing tokens to experts.
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

from repro_torch.models.layers import COST_COUNTERS, Loop

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
    coll_by_scope: dict = field(default_factory=dict)  # cost_scope()s
    peak_bytes: int = 0
    ops: int = 0
    loops_repeated: int = 0  # counted_loop()s traced once


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
        self._scopes: list[str] = []               # open in the forward
        self._scope_seqs: list[tuple] = []         # (first, end, name)
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

    def __enter__(self):
        COST_COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        COST_COUNTERS.pop()
        return super().__exit__(*exc)

    # -- marks (models.layers) ------------------------------------------------
    @contextlib.contextmanager
    def loop(self, n: int):
        """:func:`~repro_torch.models.layers.counted_loop` under this
        counter (module docstring)."""
        if n <= 1 or torch.is_grad_enabled():
            yield Loop(n)
            return
        loop = Loop(1)
        self.cost.loops_repeated += 1
        before = set(self._alive)
        outer_peak, self.cost.peak_bytes = self.cost.peak_bytes, self._live
        with self.repeat(n):
            yield loop
        carried = {id(t.untyped_storage()) for t in loop.carried}
        kept = [k for k in self._alive if k not in before and k not in carried]
        extra = (n - 1) * sum(self._alive[k] for k in kept)
        for k in kept:
            self._alive[k] *= n
        self.cost.peak_bytes = max(outer_peak, self.cost.peak_bytes + extra)
        self._live += extra

    @contextlib.contextmanager
    def scope(self, name: str):
        """:func:`~repro_torch.models.layers.cost_scope` under this counter:
        the autograd nodes made inside are those whose sequence numbers
        fall in ``[first, end)``."""
        first = torch.autograd._get_sequence_nr()
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()
            self._scope_seqs.append(
                (first, torch.autograd._get_sequence_nr(), name))

    def _scope(self) -> str | None:
        """The scope of the op being run: an open one in the forward, or
        the one that made the autograd node whose backward runs it."""
        if self._scopes:
            return self._scopes[-1]
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        seq = node._sequence_nr()
        for first, end, name in self._scope_seqs:
            if first <= seq < end:
                return name
        return None

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
            scope = self._scope()
            if scope is not None:
                c.coll_by_scope[scope] = (c.coll_by_scope.get(scope, 0.0)
                                          + k * op_bytes)
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
