"""Versioned database snapshots: epoch directories, an atomic ``CURRENT``
pointer and retention GC (:mod:`repro_torch.ingest.snapshot`), which the
query engine's epoch switching reads.

The reference's live ingest tier (the resident aggregation state, the
upload server and its client) is not ported yet.
"""
from repro_torch.ingest.snapshot import (SnapshotGone, SnapshotStore,
                                         epoch_dirname, read_current,
                                         read_manifest)

__all__ = [
    "SnapshotStore", "SnapshotGone", "epoch_dirname", "read_current",
    "read_manifest",
]
