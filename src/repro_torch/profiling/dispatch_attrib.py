"""Attribution of a train step's work to module scopes: the port's
counterpart of ``repro.profiling.hlo_attrib``.

The reference parses the compiled XLA module's HLO text, whose op
metadata names each instruction's scope.  Eager PyTorch has no such text,
so the step itself is run once under a dispatch mode of this module, with
:class:`torch.utils.module_tracker.ModuleTracker` saying which module
(forward, or its backward) is running.  Every aten op is recorded with:

* its scope: ``train_step`` / ``forward`` | ``backward`` | ``update``
  (ops outside any module's forward and backward: the gradient norm and
  the AdamW update) / the module path, a ``ModuleList`` becoming a loop
  and its layer index dropped, as the reference's ``lax.scan`` body is one
  scope for every layer;
* its output bytes, and its class: ``dot`` (mm/bmm/addmm/baddbmm),
  ``collective`` (``c10d`` ops) or ``other``.  View ops move no bytes and
  are not recorded.

:class:`torch.utils.flop_counter.FlopCounterMode` counts the step's FLOPs,
in the role of XLA's ``cost_analysis``.  Run the step on ``meta`` tensors
(:func:`trace_step`'s caller builds a ``device="meta"`` twin of the model)
and nothing is computed or allocated, as lowering computes nothing.

Metric names and context kinds are the reference's; the values are not,
since aten ops are not HLO ops (eager code has no fusions, so each op has
one route in the structure file).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.module_tracker import ModuleTracker

from repro_torch.core.cct import KIND_LOOP, KIND_MODULE
from repro_torch.core.lexical import StructureInfo

ROOT = "train_step"
_DOT = frozenset({"mm", "bmm", "addmm", "baddbmm"})
_COLLECTIVE_NS = frozenset({"c10d", "_c10d_functional"})


@dataclass(frozen=True)
class OpRecord:
    name: str                         # unique: "<opcode>#<call index>"
    opcode: str                       # aten overload packet, e.g. "mm"
    path: tuple[tuple[int, str], ...]  # lexical scope above the op
    out_bytes: int
    cls: str                          # dot | collective | other


def module_path(fqn: str) -> list[tuple[int, str]]:
    """``"TransformerLM.layers.3"`` -> ``[(MODULE, "TransformerLM"),
    (LOOP, "layers")]``: a component followed by an index is a loop."""
    parts = fqn.split(".")
    out = []
    for i, p in enumerate(parts):
        if p.isdigit():
            continue
        loop = i + 1 < len(parts) and parts[i + 1].isdigit()
        out.append((KIND_LOOP if loop else KIND_MODULE, p))
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self, tracker: ModuleTracker):
        super().__init__()
        self.tracker = tracker
        self.records: list[OpRecord] = []

    def _path(self) -> tuple[tuple[int, str], ...]:
        mods = [m for m in self.tracker.parents if m != "Global"]
        bw = self.tracker.is_bw
        phase = "backward" if bw else ("forward" if mods else "update")
        path = [(KIND_MODULE, ROOT), (KIND_MODULE, phase)]
        if mods:  # the innermost module running
            path += module_path(max(mods, key=lambda m: (m.count("."),
                                                         len(m))))
        return tuple(path)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            opcode = func.overloadpacket.__name__
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            cls = ("collective" if func.namespace in _COLLECTIVE_NS
                   else "dot" if opcode in _DOT else "other")
            self.records.append(OpRecord(
                f"{opcode}#{len(self.records)}", opcode, self._path(),
                int(nbytes), cls))
        return out


def trace_step(step_fn, *args, **kwargs) -> tuple[list[OpRecord], float]:
    """Run ``step_fn(*args, **kwargs)`` once under the recorder; returns the
    op records and the total FLOPs."""
    with ModuleTracker() as tracker, \
            FlopCounterMode(display=False) as flops, \
            _Recorder(tracker) as rec:
        step_fn(*args, **kwargs)
    return rec.records, float(flops.get_total_flops())


def attribute(records: list[OpRecord]) -> dict[tuple, dict]:
    """Per-(scope, opcode) costs: output bytes, op count, bytes by class."""
    agg: dict[tuple, dict] = defaultdict(lambda: defaultdict(float))
    for r in records:
        a = agg[(r.path, r.opcode)]
        a["bytes"] += r.out_bytes
        a["count"] += 1
        a[r.cls] += r.out_bytes
    return dict(agg)


def build_structure(records: list[OpRecord], binary_name: str
                    ) -> StructureInfo:
    """Structure file: one route per recorded op, to its scope."""
    s = StructureInfo(binary_name)
    for r in records:
        s.add_op(r.name, list(r.path))
    return s
