"""The paper's primary contribution: sparse formats + streaming aggregation.

Public surface:

* :mod:`repro_torch.core.sparse`   — sparse measurement format (paper Fig. 1)
* :mod:`repro_torch.core.cct`      — calling-context trees + preorder linearization
* :mod:`repro_torch.core.pms`      — Profile-Major Sparse analysis DB
* :mod:`repro_torch.core.cms`      — Context-Major Sparse analysis DB
* :mod:`repro_torch.core.propagate`— inclusive propagation + placeholder redistribution
* :mod:`repro_torch.core.pipeline` — the phase-2 transform (fused, or the legacy chain)
* :mod:`repro_torch.core.stats`    — cross-profile summary statistics
* :mod:`repro_torch.core.aggregate`— the streaming aggregation engine (paper §4)
* :mod:`repro_torch.core.dense_baseline` — the HPCToolkit-style dense baseline
"""
from repro_torch.core.cct import ContextTree
from repro_torch.core.metrics import INCLUSIVE_BIT, MetricRegistry, default_registry
from repro_torch.core.sparse import MeasurementProfile, SparseMetrics, Trace

__all__ = [
    "ContextTree", "MetricRegistry", "default_registry", "INCLUSIVE_BIT",
    "MeasurementProfile", "SparseMetrics", "Trace",
]
