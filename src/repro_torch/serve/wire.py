"""Wire protocol for the query service: JSON envelope, binary payloads.

The transport is JSON (debuggable with curl, stdlib-only on both sides),
but the *data* stays binary: numpy arrays and whole profile planes travel
as base64 of the exact on-disk :mod:`repro_torch.utils.binio` array blocks /
:meth:`SparseMetrics.encode` layout — the same bytes the stores hold, so
serialization costs one base64 pass, never a float->decimal->float trip
(which would be both slow and lossy for f64 metric values).

Shapes on the wire (``result_to_wire`` / ``result_from_wire``):

===========  =============================================================
kind         payload
===========  =============================================================
``profile``  ``data``: b64(SparseMetrics.encode()) — one binary plane
``stripe``   ``profiles``/``values``: binary arrays
``value``    ``value``: JSON float (scalars are fine as text)
``topk``     ``rows``: list of HotPath dicts
``window``   ``time``/``ctx``: binary arrays
``findings`` ``rows``: list of Finding dicts (diagnosis records)
``error``    ``op``/``error``/``message`` — structured per-request failure
===========  =============================================================

An *empty* findings list encodes as ``topk`` (the all-HotPath check is
vacuously true first); both decode to ``[]``, so the ambiguity is
value-preserving.
"""
from __future__ import annotations

import base64
from dataclasses import MISSING, fields

import numpy as np

from repro_torch.core.sparse import SparseMetrics, Trace
from repro_torch.diagnose.findings import Finding
from repro_torch.query.select import HotPath
from repro_torch.serve.engine import QueryError, QueryRequest
from repro_torch.utils import binio

_REQUEST_FIELDS = {f.name for f in fields(QueryRequest)}


# -- binary array payloads ---------------------------------------------------

def nd_to_wire(arr: np.ndarray) -> dict:
    raw = binio.pack_array(np.ascontiguousarray(arr))
    return {"__nd__": base64.b64encode(raw).decode("ascii")}


def wire_to_nd(obj: dict) -> np.ndarray:
    arr, _ = binio.unpack_array(base64.b64decode(obj["__nd__"]))
    return arr


# -- requests ----------------------------------------------------------------

def request_to_wire(req: QueryRequest) -> dict:
    """Encode a request sparsely: ``op`` plus every non-default field (the
    decoder fills defaults back in, so unknown future ops keep working).

    ``trace_id`` rides this envelope like any other field: clients that
    set it (or the HTTP edge, which mints one per request) get the same id
    stamped on every span the request produces — in-process, in shard
    workers, and through replay-after-death — with zero wire cost for
    untraced requests (default ``None`` is elided like every default)."""
    out: dict = {"op": req.op}
    for f in fields(QueryRequest):
        if f.name == "op":
            continue
        v = getattr(req, f.name)
        default = f.default_factory() if f.default_factory is not MISSING \
            else f.default
        if v != default:
            out[f.name] = v
    return out


def request_from_wire(obj: dict) -> QueryRequest:
    """Build a :class:`QueryRequest` from an untrusted wire dict.

    Raises ``ValueError`` on structural problems (not a dict, missing
    ``op``, unknown fields) — the server maps that to a per-request error
    entry, never a dropped batch.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"request must be a JSON object, got {type(obj).__name__}")
    unknown = set(obj) - _REQUEST_FIELDS
    if unknown:
        raise ValueError(f"unknown request fields {sorted(unknown)}")
    if not isinstance(obj.get("op"), str):
        raise ValueError("request needs a string 'op'")
    return QueryRequest(**obj)


# -- results -----------------------------------------------------------------

def result_to_wire(res) -> dict:
    if isinstance(res, QueryError):
        return {"kind": "error", **res.as_dict()}
    if isinstance(res, SparseMetrics):
        return {"kind": "profile",
                "data": base64.b64encode(res.encode()).decode("ascii")}
    if isinstance(res, Trace):
        return {"kind": "window", "time": nd_to_wire(res.time),
                "ctx": nd_to_wire(res.ctx)}
    if isinstance(res, list) and res and \
            all(isinstance(f, Finding) for f in res):
        return {"kind": "findings", "rows": [f.as_dict() for f in res]}
    if isinstance(res, list) and all(isinstance(h, HotPath) for h in res):
        return {"kind": "topk", "rows": [h.as_dict() for h in res]}
    if isinstance(res, tuple) and len(res) == 2:
        prof, vals = res
        return {"kind": "stripe", "profiles": nd_to_wire(np.asarray(prof)),
                "values": nd_to_wire(np.asarray(vals))}
    if isinstance(res, (int, float, np.floating, np.integer)):
        return {"kind": "value", "value": float(res)}
    raise TypeError(f"unserializable result type {type(res).__name__}")


def result_from_wire(obj: dict):
    kind = obj.get("kind")
    if kind == "error":
        return QueryError(op=obj.get("op", "?"), error=obj.get("error", "?"),
                          message=obj.get("message", ""))
    if kind == "profile":
        sm, _ = SparseMetrics.decode(base64.b64decode(obj["data"]))
        return sm
    if kind == "window":
        return Trace(wire_to_nd(obj["time"]), wire_to_nd(obj["ctx"]))
    if kind == "topk":
        return [HotPath(**row) for row in obj["rows"]]
    if kind == "findings":
        return [Finding.from_dict(row) for row in obj["rows"]]
    if kind == "stripe":
        return wire_to_nd(obj["profiles"]), wire_to_nd(obj["values"])
    if kind == "value":
        return float(obj["value"])
    raise ValueError(f"unknown result kind {kind!r}")
