"""Continuous diagnosis: analyzers, baselines, and the regression watch.

The analysis tier's product layer — instead of leaving humans to run
ad-hoc diffs and timeline queries, this package turns the read stack's
primitives into typed :class:`Finding` records, continuously, against
the live epoch stream.  See docs/diagnosis.md.
"""
from repro_torch.diagnose.analyzers import (DEFAULT_ANALYZERS, DEFAULT_THRESHOLDS,
                                            compute_findings, imbalance_findings,
                                            occupancy_gap_findings,
                                            regression_findings,
                                            straggler_findings)
from repro_torch.diagnose.baseline import BaselineFleet, PathBand
from repro_torch.diagnose.findings import (SEVERITIES, Finding, severity_for,
                                           sort_findings)
from repro_torch.diagnose.watch import EpochReport, RegressionWatch, WatchTarget

__all__ = [
    "SEVERITIES",
    "DEFAULT_ANALYZERS",
    "DEFAULT_THRESHOLDS",
    "BaselineFleet",
    "EpochReport",
    "Finding",
    "PathBand",
    "RegressionWatch",
    "WatchTarget",
    "compute_findings",
    "imbalance_findings",
    "occupancy_gap_findings",
    "regression_findings",
    "severity_for",
    "sort_findings",
    "straggler_findings",
]
