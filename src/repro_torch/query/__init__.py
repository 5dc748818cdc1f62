"""Postmortem query engine over the PMS/CMS/trace analysis databases.

The read path the sparse formats were designed for (paper §3, §4.3):

* :class:`Database` — one handle over a completed run's databases; meta
  parsed once, planes mmap-read on demand, decoded planes LRU-cached, every
  query routed to the cheaper store;
* :mod:`repro_torch.query.select` — call-path predicates, threshold selects,
  top-k hot paths, per-profile / per-context aggregations (never densify);
* :mod:`repro_torch.query.diff` — cross-run regression diffs aligned on the
  unified CCT by call path;
* :mod:`repro_torch.query.timeline` — trace-window and occupancy queries.

Quick start::

    from repro_torch.query import Database, topk_hot_paths, diff

    with Database("runs/db") as db:
        for hp in topk_hot_paths(db, metric=3, k=10):
            print(f"{hp.value:12.3f}  {hp.path}")
"""
from repro_torch.query.cache import LRUCache
from repro_torch.query.database import Database
from repro_torch.query.diff import (DiffEntry, diff, metric_stats_by_path,
                                    total_delta)
from repro_torch.query.epoch import EpochSwitcher, wait_for_epoch
from repro_torch.query.export import to_dataframe
from repro_torch.query.select import (HotPath, StripeRow, context_aggregate,
                                      profile_aggregate, select_contexts,
                                      stripe_select, threshold_contexts,
                                      topk_hot_paths)
from repro_torch.query.timeline import activity, occupancy, samples_in_window

__all__ = [
    "Database", "LRUCache", "EpochSwitcher", "wait_for_epoch",
    "HotPath", "StripeRow", "select_contexts", "stripe_select",
    "threshold_contexts", "topk_hot_paths",
    "profile_aggregate", "context_aggregate",
    "DiffEntry", "diff", "metric_stats_by_path", "total_delta",
    "samples_in_window", "occupancy", "activity",
    "to_dataframe",
]
