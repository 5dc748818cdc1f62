"""Pluggable execution backends for the aggregation engine.

See :mod:`repro_torch.runtime.base` for the interface contract.  Importing
this package registers the four built-in backends: ``serial``,
``threads``, ``processes``, and the whole-run ``ranks`` driver.
"""
from repro_torch.runtime.base import (Executor, available_executors,
                                      executor_for, get_executor,
                                      register_executor)
from repro_torch.runtime.ordered import OrderedSink
from repro_torch.runtime.reduce import (TreeWithMaps, merge_tree_with_maps,
                                        tree_reduce)
from repro_torch.runtime.serial import SerialExecutor
from repro_torch.runtime.shm import SlabArena
from repro_torch.runtime.threads import ThreadsExecutor, parallel_for
from repro_torch.runtime.processes import ProcessesExecutor
from repro_torch.runtime.ranks import RanksExecutor

__all__ = [
    "Executor", "available_executors", "executor_for", "get_executor",
    "register_executor", "OrderedSink", "SlabArena", "TreeWithMaps",
    "merge_tree_with_maps", "tree_reduce", "SerialExecutor",
    "ThreadsExecutor", "ProcessesExecutor", "RanksExecutor", "parallel_for",
]
