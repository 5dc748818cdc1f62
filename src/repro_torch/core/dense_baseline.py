"""HPCToolkit-style *dense* measurement & analysis baseline (paper §2, §5).

The paper evaluates against HPCToolkit's pre-existing workflow:

* measurement: each CCT node carries a **dense vector of metric values**
  (``n_ctx x n_metrics`` float64 per profile);
* analysis (hpcprof-mpi): profiles are merged into a **fully dense tensor**
  indexed by (profile, context, metric), one thread per MPI rank.

We reimplement that baseline honestly: it uses the same numpy primitives as
the streaming path (so the comparison isolates *dense-vs-sparse* and
*serial-vs-streaming-parallel*, not Python-vs-C++), writes its results as a
dense memory-mapped tensor, and computes the same inclusive metrics and
summary statistics.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.cct import ContextTree
from repro_torch.core.metrics import INCLUSIVE_BIT
from repro_torch.core.sparse import MeasurementProfile


# -- dense measurement format ------------------------------------------------

def dense_measurement_nbytes(n_ctx: int, n_metrics: int) -> int:
    """Per-profile dense CCT-vector size (the paper's 'Ratio' denominators)."""
    return n_ctx * n_metrics * 8


def write_dense_measurement(path, profile: MeasurementProfile, n_metrics: int) -> int:
    n_ctx = len(profile.tree.parent)
    mat = profile.metrics.to_dense(n_ctx, n_metrics)
    with open(path, "wb") as f:
        f.write(json.dumps({"n_ctx": n_ctx, "n_metrics": n_metrics}).encode() + b"\n")
        f.write(mat.tobytes())
    return os.path.getsize(path)


# -- dense analysis (hpcprof-analog) ------------------------------------------

class DenseAnalysis:
    """Serial dense merge -> propagate -> stats -> dense on-disk tensor."""

    def __init__(self, out_path):
        self.out_path = str(out_path)

    def run(self, profile_paths: list[str]) -> dict:
        # Phase 1 (serial): unify trees.
        profiles = [MeasurementProfile.load(p) for p in profile_paths]
        unified = ContextTree()
        remaps = [unified.merge(p.tree) for p in profiles]
        n_ctx = len(unified.parent)
        n_metrics_in = max(
            (int(p.metrics.mid.max()) + 1 for p in profiles if p.metrics.n_values), default=0
        )
        # dense result tensor: (P, C, 2*M) — exclusive + inclusive planes
        n_out = 2 * max(n_metrics_in, 1)
        parent = unified.parent_array()
        P = len(profiles)
        tensor = np.lib.format.open_memmap(
            self.out_path, mode="w+", dtype=np.float64, shape=(P, n_ctx, n_out)
        )
        # Phase 2 (serial over profiles): dense propagation + write.
        pos, order, end = unified.preorder()
        for i, (p, remap) in enumerate(zip(profiles, remaps)):
            sm = p.metrics.remap_contexts(remap)
            dense = sm.to_dense(n_ctx, n_metrics_in) if n_metrics_in else np.zeros((n_ctx, 1))
            pre = dense[order]  # preorder layout
            ps = np.zeros((n_ctx + 1, pre.shape[1]))
            np.cumsum(pre, axis=0, out=ps[1:])
            # inclusive value of preorder slot i is ps[end[i]] - ps[i];
            # scatter back from preorder slots to context ids via `order`
            incl_ctx = np.empty_like(pre)
            incl_ctx[order] = ps[end] - ps[np.arange(n_ctx)]
            tensor[i, :, :n_metrics_in] = dense
            tensor[i, :, max(n_metrics_in, 1):max(n_metrics_in, 1) + dense.shape[1]] = incl_ctx
        tensor.flush()
        # Phase 3: dense summary statistics over the full tensor.
        nz = tensor != 0.0
        cnt = nz.sum(axis=0)
        tot = tensor.sum(axis=0)
        stats = {"count": cnt, "sum": tot}
        result_bytes = os.path.getsize(self.out_path)
        return {
            "n_ctx": n_ctx,
            "n_profiles": P,
            "n_metrics_out": n_out,
            "result_bytes": result_bytes,
            "stats": stats,
            "tree": unified,
        }

    def query(self, pid: int, ctx: int, mid: int, *, inclusive: bool = False) -> float:
        tensor = np.load(self.out_path, mmap_mode="r")
        m_half = tensor.shape[2] // 2
        col = (mid & ~INCLUSIVE_BIT) + (m_half if (inclusive or mid & INCLUSIVE_BIT) else 0)
        return float(tensor[pid, ctx, col])
