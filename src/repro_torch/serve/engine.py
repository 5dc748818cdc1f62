"""Batched serving engines: generation and postmortem queries.

Two request classes share the coalescing philosophy — group work so the
expensive unit (a forward pass; a decoded database plane) is paid once per
group:

* :class:`ServeEngine` — LLM generation: requests are coalesced into
  fixed-size batch slots (padded prompts with a left-aligned layout and
  per-slot length masks are avoided by grouping same-length prompts); the
  decode loop is one ``decode_step`` per token over the whole batch, the
  tokens kept on the model's device until the end;
* :class:`QueryServer` — postmortem analysis queries served from one
  shared :class:`repro_torch.query.Database`: a batch is sorted by target
  plane so every plane is decoded once and the LRU (with coalesced
  concurrent misses) serves the rest — "the cache does the batching".

The module imports no torch: the query service runs with no card, and its
shard workers fork only while torch is not loaded.  :class:`ServeEngine`
imports torch when it runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import monotime, recorder


@dataclass
class Request:
    tokens: np.ndarray          # (S,) prompt
    n_new: int


class ServeEngine:
    """Greedy generation with ``model`` (its parameters live in the
    module, on the device generation runs on); every cache holds
    ``max_len`` positions."""

    def __init__(self, model, *, max_len: int, max_batch: int = 8):
        self.model = model
        self.max_len = max_len
        self.max_batch = max_batch

    # -- core batched generation ----------------------------------------------
    def generate(self, prompts: np.ndarray, n_new: int, *, greedy: bool = True,
                 extras: dict | None = None) -> np.ndarray:
        """prompts (B, S) int32 -> (B, n_new) int32 generated tokens: a
        prefill, then ``n_new`` decode steps of argmax, the reference's
        loop (its last step's logits are unused).  ``extras`` adds batch
        entries (the VLM's ``vision_embed``, whisper's ``frames``)."""
        import torch
        dev = next(self.model.parameters()).device
        with torch.inference_mode():
            batch = {"tokens": torch.from_numpy(
                np.asarray(prompts, np.int32)).to(dev)}
            for k, v in (extras or {}).items():
                batch[k] = torch.as_tensor(np.asarray(v)).to(dev)
            logits, cache = self.model.prefill(batch, max_len=self.max_len)
            out = torch.empty((len(prompts), n_new), dtype=torch.int32,
                              device=dev)
            tok = logits.argmax(-1).to(torch.int32)
            for t in range(n_new):
                out[:, t] = tok
                logits, cache = self.model.decode_step(
                    cache, {"tokens": tok[:, None]})
                tok = logits.argmax(-1).to(torch.int32)
            return out.cpu().numpy()

    # -- request coalescing -----------------------------------------------------
    def serve(self, requests: list[Request]) -> list[np.ndarray]:
        """Group same-shape requests into batches of up to max_batch."""
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, r in enumerate(requests):
            buckets.setdefault((len(r.tokens), r.n_new), []).append(i)
        results: list[np.ndarray | None] = [None] * len(requests)
        for (S, n_new), idxs in buckets.items():
            for lo in range(0, len(idxs), self.max_batch):
                group = idxs[lo : lo + self.max_batch]
                prompts = np.stack([requests[i].tokens for i in group])
                gen = self.generate(prompts, n_new)
                for row, i in enumerate(group):
                    results[i] = gen[row]
        return results


# ---------------------------------------------------------------------------
# postmortem query serving
# ---------------------------------------------------------------------------

@dataclass
class QueryRequest:
    """One analysis query against a served database.

    ``op`` selects the shape: ``"profile"`` (all metrics of profile
    ``pid``), ``"stripe"`` (metric across profiles of context ``ctx``),
    ``"value"`` (point lookup), ``"topk"`` (hot paths), ``"threshold"``
    (contexts whose summary stat clears ``params["min_value"]``), ``"window"``
    (trace samples of ``pid`` in ``[t0, t1)``).
    """

    op: str
    pid: int | None = None
    ctx: int | None = None
    metric: object = None
    inclusive: bool = False
    k: int = 10
    t0: float = 0.0
    t1: float = float("inf")
    params: dict = field(default_factory=dict)
    # distributed tracing: minted at the HTTP edge (or accepted from
    # X-Trace-Id), rides the wire into shard workers and through replay
    # so every recorded span of this request's life shares one id
    trace_id: str | None = None


@dataclass(frozen=True)
class QueryError:
    """Structured per-request failure: one bad request in a batch resolves
    to this instead of raising out of the batch and poisoning its peers."""

    op: str
    error: str            # exception class name, e.g. "ValueError"
    message: str

    def as_dict(self) -> dict:
        return {"op": self.op, "error": self.error, "message": self.message}


class QueryServer:
    """Serves :class:`QueryRequest` batches from one shared ``Database``.

    The server holds a single :class:`repro_torch.query.Database`; its LRU cache
    is the batching mechanism: :meth:`serve` orders a batch by the plane
    each request touches, so a burst hitting the same profile plane or
    context stripe decodes it once and the rest are cache hits — and
    concurrent misses on one key are coalesced inside the cache itself, so
    multi-threaded callers get the same property without this sort.
    """

    def __init__(self, db):
        self.db = db

    # -- single-request dispatch -------------------------------------------
    def submit(self, req: QueryRequest, db=None):
        """Serve one request.  ``db`` overrides the server's database for
        this call — the epoch-pinning hook: a follower serving a batch
        passes the batch's pinned snapshot so a concurrent epoch switch
        cannot make one reply straddle two databases."""
        from repro_torch.query import (samples_in_window, threshold_contexts,
                                       topk_hot_paths)
        db = self.db if db is None else db
        if req.op == "profile":
            return db.profile_metrics(req.pid)
        if req.op == "stripe":
            return db.stripe(req.ctx, req.metric, inclusive=req.inclusive)
        if req.op == "value":
            return db.value(req.pid, req.ctx, req.metric,
                            inclusive=req.inclusive)
        if req.op == "topk":
            return topk_hot_paths(db, req.metric, k=req.k,
                                  inclusive=req.inclusive, **req.params)
        if req.op == "threshold":
            params = dict(req.params)
            return threshold_contexts(
                db, req.metric, min_value=float(params.pop("min_value", 0.0)),
                inclusive=req.inclusive, **params)
        if req.op == "window":
            return samples_in_window(db, req.pid, req.t0, req.t1)
        if req.op == "findings":
            return self._findings(req, db)
        raise ValueError(f"unknown query op {req.op!r}")

    @staticmethod
    def _findings(req: QueryRequest, db, within_ctx=None, within_pid=None):
        """The ``findings`` op body: run the scatter-clean analyzers.

        ``params`` carries the analyzer selection and threshold overrides
        (``analyzers``, ``thresholds``, ``limit``); ``metric``/``inclusive``
        pick the metric the imbalance analyzer reads.  The ownership masks
        are supplied by shard workers — a single-process server passes
        None and diagnoses everything.
        """
        from repro_torch.diagnose import compute_findings
        params = dict(req.params)
        analyzers = params.pop("analyzers", None)
        thresholds = params.pop("thresholds", None)
        limit = int(params.pop("limit", 0) or 0)
        if params:
            raise ValueError(f"unknown findings params {sorted(params)}; "
                             f"known: analyzers, thresholds, limit")
        return compute_findings(
            db, analyzers=analyzers, metric=req.metric,
            inclusive=req.inclusive, limit=limit, thresholds=thresholds,
            within_ctx=within_ctx, within_pid=within_pid)

    # -- batched serving ----------------------------------------------------
    @staticmethod
    def _locality_key(req: QueryRequest):
        """The plane a request will pull through the cache."""
        try:
            if req.op == "profile" or req.op == "window":
                return (0, int(req.pid or 0))
            if req.op == "stripe":
                return (1, int(req.ctx or 0))
            if req.op == "value":
                return (1, int(req.ctx or 0))  # point lookups route ctx-major
        except (TypeError, ValueError):
            pass  # malformed ids sort with the plane-less ops; submit reports
        return (2, 0)  # summary-only ops: no plane at all

    def serve_one(self, req: QueryRequest, db=None):
        """:meth:`submit` that never raises: failures (unknown op, bad ids,
        missing stores) come back as a :class:`QueryError` result.
        ``db`` is only forwarded when pinned, so ``submit`` overrides that
        predate the epoch hook keep working.

        This is the one place request *execution* happens — in-process
        scheduler windows and shard workers both come through here — so
        it is where the ``decode`` span is recorded (the store/plane
        work the request paid for, whichever process paid it).
        """
        rec = recorder()
        t0 = monotime() if rec.enabled else 0.0
        try:
            res = (self.submit(req) if db is None
                   else self.submit(req, db=db))
        except Exception as e:                          # noqa: BLE001
            res = QueryError(op=str(getattr(req, "op", "?")),
                             error=type(e).__name__, message=str(e))
        if rec.enabled:
            rec.record("decode", str(getattr(req, "op", "?")), t0,
                       monotime() - t0,
                       trace_id=getattr(req, "trace_id", None) or "")
        return res

    def serve(self, requests: list[QueryRequest], db=None) -> list:
        """Serve a batch in plane-locality order.

        Failures are isolated per request: one malformed request yields a
        :class:`QueryError` in its slot and the rest of the batch is served
        normally (a poisoned request must not kill its batch peers).
        ``db`` pins the whole batch to one database handle (epoch
        consistency for followers).
        """
        order = sorted(range(len(requests)),
                       key=lambda i: self._locality_key(requests[i]))
        results: list = [None] * len(requests)
        for i in order:
            results[i] = self.serve_one(requests[i], db=db)
        return results
