"""Typed stdlib client for the ingest endpoint.

Rides the same transport/retry machinery as the query-side
:class:`~repro_torch.serve.client.QueryClient` — one keep-alive connection,
429 -> :class:`~repro_torch.serve.client.ServerOverloaded`, other failures ->
:class:`~repro_torch.serve.client.TransportError` — so one
:class:`~repro_torch.serve.client.RetryPolicy` drives upload loops the same way
it drives query loops: backpressure bursts (the merger falling behind)
are ridden out with jittered backoff honoring the server's ``Retry-After``
hint, structural failures (a non-RPRF blob -> 400, an oversize body ->
413) fail fast.
"""
from __future__ import annotations

import base64
import time

from repro_torch.serve.client import JSONClient, RetryPolicy


class IngestClient(JSONClient):
    """Client for :class:`~repro_torch.ingest.server.IngestHTTPServer`."""

    # -- uploads --------------------------------------------------------------
    def upload(self, blob: bytes) -> dict:
        """Upload one serialized profile (the ``RPRF`` bytes that
        ``MeasurementProfile.save`` writes)."""
        return self._roundtrip("POST", "/v1/ingest", raw=bytes(blob),
                               content_type="application/octet-stream")

    def upload_many(self, blobs: list[bytes]) -> dict:
        """Upload a batch of profiles in one call (JSON + base64 envelope;
        all-or-nothing admission, so a 429 rejects the whole batch)."""
        body = {"profiles": [base64.b64encode(bytes(b)).decode("ascii")
                             for b in blobs]}
        return self._roundtrip("POST", "/v1/ingest", body)

    def upload_files(self, paths: list) -> dict:
        """Upload profile *files* (reads them; does not delete them)."""
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        return self.upload_many(blobs)

    def upload_with_retry(self, blobs: list[bytes], *,
                          policy: RetryPolicy | None = None,
                          sleep=time.sleep) -> dict:
        """:meth:`upload_many` under a :class:`RetryPolicy`: rides out
        429 backpressure, fails fast on 400/413."""
        policy = policy or RetryPolicy()
        return policy.call(lambda: self.upload_many(blobs), sleep=sleep)

    # -- control --------------------------------------------------------------
    def publish(self) -> dict:
        """Drain the spool and publish the next snapshot epoch."""
        return self._roundtrip("POST", "/v1/publish", {})

    def epochs(self) -> dict:
        return self._roundtrip("GET", "/v1/epochs")

    # -- service introspection -------------------------------------------------
    def health(self) -> dict:
        return self._roundtrip("GET", "/healthz")

    def metrics(self) -> dict:
        return self._roundtrip("GET", "/metrics")
