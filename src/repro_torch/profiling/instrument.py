"""The in-job measurement subsystem (the paper's altered HPCToolkit side).

Port of :mod:`repro.profiling.instrument`.  One :class:`Profiler` per
worker accumulates *exclusive* sparse metrics onto a program-structure
CCT:

* host contexts carry host-side step metrics: ``train`` the step's time,
  ``data`` its wait for the batch, ``dispatch`` the host's time issuing
  the gradient and the update, ``checkpoint`` the checkpoint's stall;
* op contexts under ``train/`` carry device-side metrics (bytes moved, op
  counts, collective bytes, FLOPs) from the attribution of one train step
  (:mod:`repro_torch.profiling.dispatch_attrib`, where the reference
  parses HLO).

``finish()`` writes the per-worker profile in the paper's sparse
measurement format plus a sample trace, readable by both packages'
``MeasurementProfile.load`` and ``analyze``.  The trace's times are
seconds of :func:`~repro_torch.obs.monotime` from the Profiler's start;
the environment's ``clock`` places them on ``torch.profiler``'s clock
(:func:`~repro_torch.obs.clock.to_trace_ns` of ``t0`` plus the time), as
the Trainer's spans are.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.cct import KIND_MODULE, KIND_OP, KIND_PHASE, ContextTree
from repro_torch.core.metrics import default_registry
from repro_torch.core.sparse import MeasurementProfile, SparseMetrics, Trace
from repro_torch.obs import clock
from repro_torch.profiling import dispatch_attrib


class Profiler:
    def __init__(self, identity: dict, *, families=("attention", "dense"),
                 trace: bool = True):
        self.identity = dict(identity)
        self.registry = default_registry(families=families)
        self.tree = ContextTree()
        self._acc: dict[tuple[int, int], float] = {}
        self._trace_t: list[float] = []
        self._trace_c: list[int] = []
        self._trace_on = trace
        self._t0 = clock.monotime()
        self._structures: list[str] = []
        # host phase contexts
        self._phase = {
            name: self.tree.child(0, KIND_PHASE, name)
            for name in ("train", "data", "dispatch", "checkpoint")
        }

    # -- accumulation -----------------------------------------------------------
    def add(self, ctx: int, metric: str, value: float) -> None:
        if value == 0.0:
            return
        mid = self.registry[metric].mid if metric in self.registry else \
            self.registry.register(metric).mid
        key = (ctx, mid)
        self._acc[key] = self._acc.get(key, 0.0) + float(value)

    def sample(self, ctx: int) -> None:
        if self._trace_on:
            self._trace_t.append(clock.monotime() - self._t0)
            self._trace_c.append(ctx)

    # -- hooks --------------------------------------------------------------------
    def on_step(self, rec: dict) -> None:
        """Trainer hook: host-side metrics on host contexts, one trace
        sample."""
        t = self._phase["train"]
        self.add(t, "host.step_time", rec.get("step_time", 0.0))
        self.add(self._phase["data"], "host.data_wait",
                 rec.get("data_wait", 0.0))
        self.add(self._phase["dispatch"], "host.dispatch",
                 rec.get("dispatch", 0.0))
        self.add(self._phase["checkpoint"], "host.checkpoint_io",
                 rec.get("checkpoint", 0.0))
        self.sample(t)

    def attribute_step(self, records, *, binary: str = "step",
                       measured: dict | None = None,
                       struct_dir: str | None = None) -> None:
        """Attribute one traced step's costs to op contexts under train/
        (``records`` from :func:`dispatch_attrib.trace_step`).

        ``measured`` may carry the step's total ``flops``, distributed over
        the ops by output bytes as the reference distributes
        ``cost_analysis``' total.
        """
        agg = dispatch_attrib.attribute(records)
        total_bytes = sum(v["bytes"] for v in agg.values()) or 1.0
        flops_total = (measured or {}).get("flops", 0.0)
        parent = self._phase["train"]
        for (path, opcode), vals in agg.items():
            node = self.tree.path(list(path) + [(KIND_OP, opcode)], parent)
            self.add(node, "dev.bytes_hbm", vals["bytes"])
            self.add(node, "dev.occupancy", vals["count"])
            self.add(node, "dev.bytes_ici", vals.get("collective", 0.0))
            if flops_total:
                self.add(node, "dev.flops",
                         flops_total * vals["bytes"] / total_bytes)
        if struct_dir is not None:
            os.makedirs(struct_dir, exist_ok=True)
            s = dispatch_attrib.build_structure(records, binary)
            path = os.path.join(struct_dir, f"{binary}.struct.json")
            s.save(path)
            self._structures.append(path)

    def module_metric(self, module_path: list[str], metric: str,
                      value: float) -> None:
        """Attribute a value to an explicit module path under train/."""
        parts = [(KIND_MODULE, p) for p in module_path]
        node = self.tree.path(parts, self._phase["train"])
        self.add(node, metric, value)
        self.sample(node)

    # -- completion ------------------------------------------------------------
    def finish(self, path) -> MeasurementProfile:
        ctxs = np.array([k[0] for k in self._acc], dtype=np.int64)
        mids = np.array([k[1] for k in self._acc], dtype=np.int64)
        vals = np.array(list(self._acc.values()), dtype=np.float64)
        prof = MeasurementProfile(
            environment={"app": "repro_torch",
                         "registry": self.registry.to_json(),
                         "clock": {"t0": self._t0,
                                   "trace_anchor_ns": clock.TRACE_ANCHOR_NS}},
            identity=self.identity,
            file_paths=list(self._structures),
            tree=self.tree,
            trace=Trace(np.asarray(self._trace_t, np.float64),
                        np.asarray(self._trace_c, np.uint32)),
            metrics=SparseMetrics.from_triplets(ctxs, mids, vals),
        )
        prof.save(path)
        return prof
