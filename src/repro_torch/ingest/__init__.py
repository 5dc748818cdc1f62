"""Live ingest tier: continuous profile uploads -> incremental aggregation
-> versioned database snapshots (ROADMAP item 1; paper §4's streaming
premise taken online).

* :class:`~repro_torch.ingest.state.IngestState` — resident aggregation whose
  phase boundary is an *append*;
* :class:`~repro_torch.ingest.snapshot.SnapshotStore` — epoch directories,
  atomic ``CURRENT`` pointer, retention GC;
* :class:`~repro_torch.ingest.server.IngestHTTPServer` — the upload endpoint;
* :class:`~repro_torch.ingest.client.IngestClient` — typed client with retries.
"""
from repro_torch.ingest.client import IngestClient
from repro_torch.ingest.server import IngestHTTPServer
from repro_torch.ingest.snapshot import (SnapshotGone, SnapshotStore,
                                         epoch_dirname, read_current,
                                         read_manifest)
from repro_torch.ingest.state import IngestState, relabel_plane

__all__ = [
    "IngestState", "relabel_plane",
    "IngestHTTPServer", "IngestClient",
    "SnapshotStore", "SnapshotGone", "epoch_dirname", "read_current",
    "read_manifest",
]
