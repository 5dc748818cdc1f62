"""The multi-rank reduction driver as a registered executor backend.

``AggregationConfig(executor="ranks")`` selects the paper's §4.4 MPI-analog
driver (``repro_torch.core.reduction.aggregate_multiprocess``) through the same
registry as the streaming backends: ``n_workers`` becomes the rank count
and the legacy ``n_threads`` knob the threads-per-rank.  The engine
recognizes the backend via ``driver == "ranks"`` and hands the whole run to
the rank driver instead of the streaming loop, so CLI/config surfaces need
no special-casing.

The rank driver writes its PMS planes in per-rank segments (strided profile
interleave), so its databases are byte-*layout* different from the
streaming backends' — but semantically identical: every query result
(plane contents, stripes, statistics, top-k, diffs) matches, which is the
contract ``tests/test_torch_processes.py`` pins down.  The driver runs
the numpy path only: ``compute="device"`` under it raises.

``parallel_for``/``map_unordered`` are inherited from the ``processes``
pool so the backend is still usable as a generic executor (e.g. by
``build_cms``), not only as a whole-run driver.
"""
from __future__ import annotations

from repro_torch.runtime.base import register_executor
from repro_torch.runtime.processes import ProcessesExecutor


@register_executor
class RanksExecutor(ProcessesExecutor):
    name = "ranks"
    in_process = False
    driver = "ranks"
