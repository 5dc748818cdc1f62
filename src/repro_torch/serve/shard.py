"""Sharded multi-process query service: escape the GIL for decode-heavy load.

The in-process :class:`~repro_torch.serve.engine.QueryServer` serves every plane
decode inside one Python process; past a few concurrent decode-heavy
clients the GIL is the ceiling (the ROADMAP limiter this module removes).
:class:`ShardedQueryServer` spawns ``n_shards`` worker *processes*, each
owning a full :class:`repro_torch.query.Database` handle (its own mmap + decoded
-plane LRU), and routes every request with a consistent-hash ring keyed by
:meth:`QueryServer._locality_key` — with ``replicas`` (default 2)
successor-distinct owners per key, so each plane is decoded and cached by
a small owner set: the primary serves it in steady state, replicas absorb
hot-plane spill, hedged reads, and failover.

Topology::

    clients -> BatchScheduler (per-shard admission queues)
                 |  serve_window(reqs): one batch message per shard
                 v
             ShardedQueryServer (parent)
               ring: locality_key -> R owners       supervisor: health,
               transport: shm slabs | framed TCP    failover, respawn,
                 |             |             |      replay, hedges
               worker 0      worker 1      worker N-1   (processes)
               Database      Database      Database
               own LRU       own LRU       own LRU

* **routing** — ``profile``/``window`` requests hash on ``(0, pid)``,
  ``stripe``/``value`` on ``(1, ctx)``; the ring is stable under shard-count
  changes (only ~1/N of keys move their primary, and every moved key moves
  to the *new* shard — the classic consistent-hashing property,
  property-tested in ``tests/test_shard.py``).  Among an owner set the
  router prefers health (alive > rejoining > suspect, never dead), then
  least backlog in ``spill_pending`` quanta (hot planes spread over their
  replicas, cold planes stay put), then replica rank.
* **scatter–gather** — summary-space queries (``topk``, ``threshold``,
  ``findings``) fan out over the *live* shard set; each member answers
  the slice of contexts (and, for findings, profiles) the ring assigns
  it under that live set (``within=`` on the select functions, ownership
  masks on the analyzers) and the parent merges partials in the same
  deterministic order the single-process path uses, so results are
  identical to single-process serving for any live set.
* **payloads** — with the same-host ``shm`` transport, plane-sized results
  return through a parent-owned :class:`~repro_torch.runtime.shm.SlabArena`
  (the aggregation path's slab transport): the worker serializes
  straight into the slab and ships a tiny descriptor; only results that
  outgrow their slab fall back to the pickled reply path.  Workers never *create* segments, so a
  SIGKILL'd worker cannot leak ``/dev/shm``.  With the ``tcp`` transport
  (:mod:`repro_torch.serve.transport`) payloads ride inline in length-prefixed
  frames — shard groups can live in separate process trees or hosts.
* **fault tolerance** — a per-shard pump thread doubles as supervisor,
  feeding a per-owner health state machine (alive -> suspect -> dead ->
  rejoining).  When a worker dies, in-flight requests with another live
  owner *fail over* immediately (any worker holds the full database, so
  answers stay byte-identical); the rest replay on the respawned
  replacement.  A hung worker (stalled transport, wedged syscall) is
  detected by reply-stall age and killed into the same recovery path.
  Optional **hedged reads** (``hedge_ms``) duplicate a slow primary read
  to the next live replica after a p99-derived delay and take the first
  reply.  A request that outlives ``replay_limit`` respawns (it is
  probably what keeps killing workers) resolves to a structured
  ``QueryError("WorkerLost")`` instead of looping forever.
"""
from __future__ import annotations

import hashlib
import itertools
import multiprocessing as mp
import os
import signal as signal_mod
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.sparse import SparseMetrics, Trace
from repro_torch.obs import MetricsRegistry, configure, monotime, recorder
from repro_torch.runtime.shm import (SlabArena, read_section, sections_layout,
                                     worker_slab, write_section)
from repro_torch.serve.engine import QueryError, QueryRequest, QueryServer
from repro_torch.serve.transport import (ChaosState, PeerClosed, PeerError,
                                         PeerHealth, PeerTimeout, QueuePeer,
                                         TcpListener, connect_peer)

#: summary-space ops served by every shard over its owned contexts and
#: merged in the parent (all other ops route to exactly one shard);
#: "findings" additionally partitions per-rank analyzers by profile
#: ownership
SCATTER_OPS = ("topk", "threshold", "findings")

#: worker replies per response-queue message (latency/throughput balance)
_REPLY_CHUNK = 16

#: ops whose results are plane/array-sized and worth a shm slab; the rest
#: (point values, top-k rows, errors) ride the pickled response queue and
#: must not starve the slab pool
_SLAB_OPS = ("profile", "stripe", "window", "threshold")


def _slab_eligible(req: QueryRequest, scatter: bool) -> bool:
    return not scatter and getattr(req, "op", None) in _SLAB_OPS


# ---------------------------------------------------------------------------
# epoch transitions: many dispatch windows XOR one reopen
# ---------------------------------------------------------------------------

class _RWLock:
    """Reader/writer lock with writer preference.

    Dispatch windows are readers (arbitrarily many in flight); an epoch
    :meth:`ShardedQueryServer.reopen` is the writer.  Writer preference —
    a waiting reopen blocks *new* windows — so a steady query stream can
    never starve an epoch switch, and every window that does run is
    entirely before or entirely after the switch: no batched reply ever
    mixes epochs.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

def _hash64(data: bytes) -> int:
    """Stable 64-bit point on the ring (blake2b: no PYTHONHASHSEED drift,
    identical in parent and every worker)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


class ConsistentHashRing:
    """Classic vnode hash ring over locality keys, with R-way ownership.

    Each shard owns ``vnodes`` pseudo-random points; a key's **primary**
    owner is the first point clockwise from its own hash, and its
    ``replicas``-way owner set is the first R *distinct* shards met
    walking clockwise (the successor list).  Growing the ring from N to
    N+1 shards only adds points, so the *only* keys that change primary
    owner are the ones the new shard's points capture — an expected
    1/(N+1) of the key space, and every moved key moves to the new
    shard.  The same stability holds per replica rank.
    """

    def __init__(self, n_shards: int, *, vnodes: int = 96,
                 salt: bytes = b"repro-serve-shard", replicas: int = 1):
        self.n_shards = max(1, int(n_shards))
        self.vnodes = max(1, int(vnodes))
        self.salt = bytes(salt)
        self.replicas = max(1, min(int(replicas), self.n_shards))
        pts = sorted(
            (_hash64(b"%s|vnode|%d:%d" % (self.salt, s, v)), s)
            for s in range(self.n_shards) for v in range(self.vnodes))
        self._points = np.array([h for h, _ in pts], dtype=np.uint64)
        self._owner = np.array([s for _, s in pts], dtype=np.int64)

    def _walk_key(self, key: tuple[int, int], need: int) -> list[int]:
        """First ``need`` *distinct* shards clockwise from the key's
        hash point — the successor list that defines replica ownership
        (rank 0 is the classic single owner)."""
        h = _hash64(b"%s|key|%d:%d" % (self.salt, int(key[0]), int(key[1])))
        i = int(np.searchsorted(self._points, np.uint64(h), side="left"))
        n = self._points.size
        need = min(max(1, int(need)), self.n_shards)
        out: list[int] = []
        for j in range(n):
            s = int(self._owner[(i + j) % n])
            if s not in out:
                out.append(s)
                if len(out) == need:
                    break
        return out

    def owners_key(self, key: tuple[int, int]) -> tuple[int, ...]:
        """Locality key -> the R successor-distinct owning shards,
        primary first."""
        return tuple(self._walk_key(key, self.replicas))

    def route_key(self, key: tuple[int, int]) -> int:
        """Locality key ``(group, id)`` -> primary owning shard."""
        h = _hash64(b"%s|key|%d:%d" % (self.salt, int(key[0]), int(key[1])))
        i = int(np.searchsorted(self._points, np.uint64(h), side="left"))
        return int(self._owner[i % self._points.size])

    def route(self, req: QueryRequest) -> int:
        return self.route_key(QueryServer._locality_key(req))

    def owners(self, req: QueryRequest) -> tuple[int, ...]:
        return self.owners_key(QueryServer._locality_key(req))

    def assigned_shard(self, key: tuple[int, int],
                       live=None) -> int:
        """The shard responsible for ``key`` given the ``live`` set: the
        first live shard in successor order (not capped at R — with every
        owner down, responsibility keeps walking, so any non-empty live
        set always yields a total assignment)."""
        if live is None:
            return self.route_key(key)
        live = frozenset(int(s) for s in live)
        for s in self._walk_key(key, self.n_shards):
            if s in live:
                return s
        return self.route_key(key)  # nothing live: degenerate fallback

    def owned_contexts(self, n_contexts: int, shard: int,
                       live=None) -> np.ndarray:
        """Context ids whose ``(1, ctx)`` key is *assigned* to ``shard``
        under the ``live`` set — the ``within=`` set for scatter queries.
        With ``live=None`` this is plain primary ownership; the
        assignment partitions contexts across any live set."""
        return np.array([c for c in range(int(n_contexts))
                         if self.assigned_shard((1, c), live) == int(shard)],
                        dtype=np.int64)

    def owned_context_mask(self, n_contexts: int, shard: int,
                           live=None) -> np.ndarray:
        """Boolean ownership over context ids — the O(1)-lookup ``within=``
        form the worker hands to the select functions per scatter query."""
        mask = np.zeros(int(n_contexts), dtype=bool)
        mask[self.owned_contexts(n_contexts, shard, live)] = True
        return mask

    def owned_profile_mask(self, n_profiles: int, shard: int,
                           live=None) -> np.ndarray:
        """Boolean ownership over profile ids (``(0, pid)`` keys) — the
        per-rank partition the findings analyzers scatter over.  Like
        :meth:`owned_context_mask`, any live set partitions the id space:
        disjoint across members, complete in union."""
        mask = np.zeros(int(n_profiles), dtype=bool)
        owned = [p for p in range(int(n_profiles))
                 if self.assigned_shard((0, p), live) == int(shard)]
        mask[owned] = True
        return mask

    def plane_role(self, store: str, oid: int, shard: int) -> int | None:
        """Replica rank of ``shard`` for a plane (0 = primary, 1.. =
        replica), or None when the shard does not own it.  PMS/trace
        planes follow the profile key, CMS planes the context key."""
        group = 1 if store == "cms" else 0
        owners = self.owners_key((group, int(oid)))
        try:
            return owners.index(int(shard))
        except ValueError:
            return None

    def owns_plane(self, store: str, oid: int, shard: int) -> bool:
        """Warm-plan ownership: any replica rank counts (primaries warm
        hot, replicas warm — see ``warm_priority``)."""
        return self.plane_role(store, oid, shard) is not None

    def warm_priority(self, store: str, oid: int, shard: int, *,
                      replica_scale: float = 0.5) -> float:
        """Warm-plan weight: 1.0 for primary-owned planes, a reduced
        weight for replica-owned ones (they warm after every primary
        plane of equal density), 0.0 for planes the shard never serves
        outside failover."""
        role = self.plane_role(store, oid, shard)
        if role is None:
            return 0.0
        return 1.0 if role == 0 else float(replica_scale)


# ---------------------------------------------------------------------------
# result payload codec (worker -> parent)
# ---------------------------------------------------------------------------
# payload = (mode, kind, data):
#   ("obj",    None,    result)  - small results (floats, topk rows, errors)
#                                  pickled through the response queue
#   ("slab",   "sm",    nbytes)  - SparseMetrics.encode_into the slab
#   ("inline", "sm",    bytes)   - ... that outgrew the slab
#   ("slab",   kind,    meta)    - array sections in the slab; meta is
#                                  ((dtype, count, nbytes), ...) and offsets
#                                  re-derive via sections_layout
#   ("inline", kind,    arrays)  - ... that outgrew the slab
# kind "pair" reassembles a (profiles, values)-style tuple, "trace" a Trace.

def _encode_result(res, slab_buf, slab_bytes: int):
    """Serialize one query result, preferring the shard's shm slab."""
    if isinstance(res, SparseMetrics):
        n = res.encoded_nbytes()
        if slab_buf is not None and n <= slab_bytes:
            res.encode_into(slab_buf, 0)
            return ("slab", "sm", n)
        return ("inline", "sm", res.encode())
    if isinstance(res, Trace):
        kind, arrays = "trace", (res.time, res.ctx)
    elif (isinstance(res, tuple) and len(res) == 2
          and all(isinstance(a, np.ndarray) for a in res)):
        kind, arrays = "pair", res
    else:
        return ("obj", None, res)
    arrays = tuple(np.ascontiguousarray(a) for a in arrays)
    meta = tuple((a.dtype.str, int(a.size), int(a.nbytes)) for a in arrays)
    offs, total = sections_layout([m[2] for m in meta])
    if slab_buf is not None and total <= slab_bytes:
        for a, off in zip(arrays, offs):
            write_section(slab_buf, off, a)
        return ("slab", kind, meta)
    return ("inline", kind, arrays)


def _decode_payload(payload, slab_view):
    """Parent-side inverse of :func:`_encode_result`; always copies out of
    the slab so it can be recycled immediately."""
    mode, kind, data = payload
    if mode == "obj":
        return data
    if kind == "sm":
        buf = bytes(slab_view[:data]) if mode == "slab" else data
        return SparseMetrics.decode(buf)[0]
    if mode == "inline":
        arrays = tuple(data)
    else:
        offs, _ = sections_layout([nb for _, _, nb in data])
        arrays = tuple(read_section(slab_view, off, dt, n, copy=True)
                       for (dt, n, _), off in zip(data, offs))
    return Trace(*arrays) if kind == "trace" else arrays


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _serve_scatter(db, owned_ctx: np.ndarray, req: QueryRequest,
                   owned_pid: np.ndarray | None = None):
    """One shard's partial answer to a scatter query, restricted to the
    contexts (and profiles, for findings) it owns; failures mirror
    ``QueryServer.serve_one`` exactly so error results stay byte-identical
    to single-process serving."""
    from repro_torch.query import threshold_contexts, topk_hot_paths
    try:
        params = dict(req.params)
        if req.op == "topk":
            return topk_hot_paths(db, req.metric, k=req.k,
                                  inclusive=req.inclusive, within=owned_ctx,
                                  **params)
        if req.op == "findings":
            # ctx-keyed analyzers take the context mask, pid-keyed ones
            # the profile mask; global aggregates inside each analyzer
            # are shard-invariant, so the partials concat cleanly
            return QueryServer._findings(req, db, within_ctx=owned_ctx,
                                         within_pid=owned_pid)
        return threshold_contexts(
            db, req.metric, min_value=float(params.pop("min_value", 0.0)),
            inclusive=req.inclusive, within=owned_ctx, **params)
    except Exception as e:                                  # noqa: BLE001
        return QueryError(op=str(getattr(req, "op", "?")),
                          error=type(e).__name__, message=str(e))


def _merge_scatter(req: QueryRequest, parts: list):
    """Parent-side merge of per-shard partials, in the exact deterministic
    order the single-process select functions use."""
    for p in parts:
        if isinstance(p, QueryError):
            return p
    if req.op == "topk":
        rows = [h for part in parts for h in part]
        rows.sort(key=lambda h: (-h.value, h.ctx))
        return rows[:max(int(req.k), 0)]
    if req.op == "findings":
        from repro_torch.diagnose.findings import sort_findings
        rows = [f for part in parts for f in part]
        limit = int(dict(req.params).get("limit", 0) or 0)
        return sort_findings(rows, limit or None)
    ctx = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    order = np.lexsort((ctx, -vals))  # value desc, ctx asc tiebreak
    return ctx[order], vals[order]


def _worker_peer(link, shard: int):
    """Build the worker's side of the parent link from its spec:
    ``("queue", req_q, resp_q)`` or ``("tcp", host, port, token_hex)``."""
    if link[0] == "queue":
        _, req_q, resp_q = link
        return QueuePeer(resp_q, req_q)  # worker sends replies, recvs reqs
    _, host, port, token = link
    return connect_peer((host, int(port)), shard, bytes.fromhex(token))


def _shard_worker_main(shard: int, n_shards: int, vnodes: int, salt: bytes,
                       replicas: int, db_dir: str, cache_bytes: int,
                       warm_bytes, server_factory, slab_bytes: int,
                       trace_ring: int, link):
    """Worker loop: own Database, own LRU, serve batches in locality order.

    Module-level (and all-args-picklable) so it runs under any
    multiprocessing start method.  The worker never creates shm segments —
    oversize results fall back to the pickled reply path — so abrupt
    death cannot leak ``/dev/shm``.

    ``link`` picks the parent transport: the same-host queue/shm pair,
    or framed TCP (connect + hello handshake with bounded backoff; see
    :mod:`repro_torch.serve.transport`).  The loop itself is transport-blind.

    The worker runs its own flight recorder (sized by ``trace_ring`` —
    passed explicitly so spawn-start workers match the parent's config)
    and piggybacks freshly recorded spans on every reply chunk, so span
    shipping costs no extra queue round trips and a SIGKILL loses at
    most the spans of the unanswered batch (which the parent's replay
    re-records on the replacement worker anyway).
    """
    import signal

    from repro_torch.query import Database
    from repro_torch.serve.warm import warm_cache

    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent owns shutdown
    rec = configure(trace_ring)
    rec.default_shard = shard
    try:
        peer = _worker_peer(link, shard)
    except PeerClosed:
        return  # could not reach the parent: let the supervisor respawn
    ring = ConsistentHashRing(n_shards, vnodes=vnodes, salt=salt,
                              replicas=replicas)
    owned = ((lambda store, oid: ring.warm_priority(store, oid, shard))
             if n_shards > 1 else None)
    # scatter assignment masks are a function of (member, live-set) and
    # the open epoch's context/profile counts — tiny dicts, rebuilt per
    # epoch
    masks: dict[tuple, np.ndarray] = {}

    def _mask(d, member: int, live: tuple):
        key = (member, live)
        m = masks.get(key)
        if m is None:
            m = ring.owned_context_mask(d.n_contexts, member, live or None)
            masks[key] = m
        return m

    def _pmask(d, member: int, live: tuple):
        key = ("pid", member, live)
        m = masks.get(key)
        if m is None:
            m = ring.owned_profile_mask(d.n_profiles, member, live or None)
            masks[key] = m
        return m

    def _open(path):
        d = Database(path, cache_bytes=cache_bytes)
        srv = (server_factory or QueryServer)(d)
        masks.clear()
        report = None
        if warm_bytes is None or warm_bytes > 0:
            report = warm_cache(d, warm_bytes, owned=owned)
        return d, srv, report

    db, server, warm_report = _open(db_dir)
    peer.send(("ready", {"shard": shard, "pid": os.getpid(),
                         "warm": warm_report}))
    while True:
        try:
            msg = peer.recv()
        except PeerTimeout:
            continue
        except PeerClosed:
            if link[0] != "tcp":
                break
            # transport loss, not shutdown: reconnect with bounded
            # backoff and re-handshake; exhausting the budget exits the
            # worker and hands recovery to the supervisor's respawn
            try:
                peer = _worker_peer(link, shard)
            except PeerClosed:
                break
            continue
        if msg is None:
            break
        if isinstance(msg, tuple) and msg and msg[0] == "reopen":
            # epoch switch: messages are processed serially, so every
            # batch queued before this one was answered from the old
            # epoch — closing here is safe because every result path
            # copies out of the mmap before replying.  A fresh Database
            # means a fresh (empty) plane LRU: cache invalidation is
            # structural, not key-by-key.
            new_dir = msg[1]
            db.close()
            db, server, warm_report = _open(new_dir)
            peer.send(("reopened", {"shard": shard, "pid": os.getpid(),
                                    "dir": new_dir, "warm": warm_report}))
            continue
        items = msg  # [(key, QueryRequest, slab | None, scatter), ...]
        # plane-less ops (group 2: top-k/threshold partials) first — they
        # are barrier legs of scatter-gather merges, so answering them
        # early keeps sibling shards' merges from waiting out this
        # shard's plane work; then plane ops in locality order
        order = sorted(range(len(items)),
                       key=lambda i: (lambda k: (k[0] != 2, k))(
                           QueryServer._locality_key(items[i][1])))
        replies = []
        for i in order:  # every hot plane decodes once per batch
            key, req, slab_name, scatter = items[i]
            tid = getattr(req, "trace_id", None) or ""
            try:
                if scatter and req.op in SCATTER_OPS and n_shards > 1:
                    # scatter partials carry (member, live-set): answer
                    # for the member's slice of the live assignment (the
                    # member is this shard unless the partial failed
                    # over here).  They bypass serve_one (and its decode
                    # span), so time them here.
                    member, live = scatter
                    t0 = monotime()
                    pmask = (_pmask(db, member, live)
                             if req.op == "findings" else None)
                    res = _serve_scatter(db, _mask(db, member, live), req,
                                         owned_pid=pmask)
                    if rec.enabled:
                        rec.record("decode", str(req.op), t0, monotime() - t0,
                                   trace_id=tid)
                else:
                    res = server.serve_one(req)
                slab_buf = (worker_slab(slab_name).buf
                            if slab_name is not None else None)
                t0 = monotime()
                payload = _encode_result(res, slab_buf, slab_bytes)
                if rec.enabled:
                    rec.record("encode", str(getattr(req, "op", "?")), t0,
                               monotime() - t0, trace_id=tid)
            except Exception as e:                          # noqa: BLE001
                payload = ("obj", None, QueryError(
                    op=str(getattr(req, "op", "?")),
                    error=type(e).__name__, message=str(e)))
            replies.append((key, payload))
            # chunked responses: the transport round trip amortizes over
            # a chunk instead of being paid per request, while early
            # results still stream back before the batch finishes (a
            # whole-batch reply would stall closed-loop clients and
            # drain the pipeline).  Spans recorded since the last chunk
            # ride the same message.
            if len(replies) >= _REPLY_CHUNK:
                peer.send(("res", replies, rec.drain_outbox()))
                replies = []
        tail = rec.drain_outbox()
        if replies or tail:
            peer.send(("res", replies, tail))
    db.close()


# ---------------------------------------------------------------------------
# parent: shard records, supervisor, scatter-gather
# ---------------------------------------------------------------------------

@dataclass
class _Pending:
    req: QueryRequest
    future: Future
    slab: str | None
    scatter: object  # False, or (member, live-set tuple) for partials
    replays: int = 0
    t0: float = 0.0  # monotime() at (re-)dispatch, drives stall detection


@dataclass
class _Shard:
    index: int
    arena: SlabArena | None
    free_slabs: list[str]
    chaos: ChaosState = field(default_factory=ChaosState)
    health: PeerHealth = field(default_factory=PeerHealth)
    lock: threading.Lock = field(default_factory=threading.Lock)
    pending: dict[int, _Pending] = field(default_factory=dict)
    proc: mp.process.BaseProcess | None = None
    peer: object = None          # parent side of the worker link
    backlog: list = field(default_factory=list)  # msgs awaiting a peer
    slab_ok: bool = True
    ready: threading.Event = field(default_factory=threading.Event)
    reopen_ack: threading.Event = field(default_factory=threading.Event)
    warm: dict | None = None
    deaths: int = 0
    last_reply_t: float = 0.0
    last_miss_t: float = 0.0


class ShardedQueryServer:
    """Multi-process drop-in for :class:`QueryServer` over one database.

    Exposes the same serving surface the scheduler and HTTP layer consume
    (``serve_one`` / ``serve`` / ``_locality_key``) plus the shard-aware
    hooks the :class:`~repro_torch.serve.scheduler.BatchScheduler` uses when
    present (``n_shards``, ``shard_of``, ``serve_window``).

    ``cache_bytes``/``warm_bytes`` are *per worker*: sharding scales cache
    capacity with compute; with ``replicas`` > 1 each plane has R owners
    (primary warmed hot, replicas warm), so a hot plane's decode load can
    spread across its owner set and any single owner's death leaves live
    replicas to fail over to.

    Replication/failover knobs:

    * ``replicas`` — R-way successor-distinct ownership (default 2;
      capped at ``n_shards``).
    * ``transport`` — ``"shm"`` (mp.Queue control + shm slab payloads,
      same host) or ``"tcp"`` (length-prefixed frames, workers connect
      back with a per-spawn token; payloads ride inline).
    * ``hedge_ms`` — when set, single-owner reads fire a *hedge* to the
      next live replica after ``max(hedge_ms, observed p99)`` and the
      first reply wins (replicas serve byte-identical answers within an
      epoch).  ``None`` disables hedging.
    * ``spill_pending`` — backlog quantum for replica read-scaling: the
      router prefers the primary until its pending depth exceeds a live
      replica's by a full quantum, then spills (0 pins reads to the
      primary unless it is unhealthy).
    * ``suspect_after_s`` / ``hang_kill_s`` — stall thresholds driving
      the per-owner health machine: a shard with dispatched-but-
      unanswered work older than ``suspect_after_s`` takes health
      *misses* (alive -> suspect -> dead for routing); older than
      ``hang_kill_s`` it is presumed hung and SIGKILLed so the
      respawn/replay/failover path recovers its in-flight work.
    """

    def __init__(self, db_dir: str, n_shards: int, *,
                 cache_bytes: int = 64 << 20, warm_bytes: int | None = 0,
                 n_slabs: int = 32, slab_bytes: int = 4 << 20,
                 vnodes: int = 96, server_factory=None,
                 replay_limit: int = 3, dispatch_timeout_s: float = 60.0,
                 start_timeout_s: float = 120.0, mp_context: str | None = None,
                 trace_ring: int | None = None, replicas: int = 2,
                 transport: str = "shm", hedge_ms: float | None = None,
                 spill_pending: int = 4, suspect_after_s: float = 1.0,
                 hang_kill_s: float = 30.0):
        if db_dir is None:
            raise ValueError("sharded serving needs a database directory "
                             "(explicit pms_path handles cannot be re-opened "
                             "by workers)")
        self.db_dir = str(db_dir)
        self.n_shards = max(1, int(n_shards))
        self.cache_bytes = int(cache_bytes)
        self.warm_bytes = warm_bytes
        self.n_slabs = max(1, int(n_slabs))
        self.slab_bytes = max(1 << 12, int(slab_bytes))
        self.ring = ConsistentHashRing(self.n_shards, vnodes=vnodes,
                                       replicas=replicas)
        self.replicas = self.ring.replicas
        if transport not in ("shm", "tcp"):
            raise ValueError(f"unknown transport {transport!r} "
                             f"(expected 'shm' or 'tcp')")
        self.transport = transport
        self.hedge_ms = None if hedge_ms is None else max(0.0,
                                                          float(hedge_ms))
        self.spill_pending = max(0, int(spill_pending))
        self.suspect_after_s = max(0.05, float(suspect_after_s))
        self.hang_kill_s = max(0.0, float(hang_kill_s))
        self.server_factory = server_factory
        self.replay_limit = int(replay_limit)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.start_timeout_s = float(start_timeout_s)

        # value lookups are served from a CMS stripe when that store
        # exists, so they route context-major like stripes; a PMS-only
        # database answers them from the *profile* plane instead — route
        # them profile-major there, or every shard would decode (and
        # warm) the same PMS planes the ring assigned to one owner
        from repro_torch.query.database import CMS_NAME
        self._has_cms = os.path.exists(os.path.join(self.db_dir, CMS_NAME))

        if mp_context is None:
            mp_context = os.environ.get("REPRO_MP_CONTEXT") or None
        if mp_context is None:
            # same tradeoff as runtime.processes: fork on Linux (spawn
            # re-imports __main__), REPRO_MP_CONTEXT=forkserver opts out;
            # but a parent that has imported torch spawns, since forking a
            # process whose torch thread pools or CUDA context have run is
            # unsafe (the workers themselves import no torch)
            methods = mp.get_all_start_methods()
            mp_context = ("fork" if sys.platform == "linux"
                          and "fork" in methods
                          and "torch" not in sys.modules else "spawn")
        self._ctx = mp.get_context(mp_context)

        # flight-recorder ring size for the worker processes; None
        # inherits this (parent) process's configured capacity, so one
        # `configure()` at the front covers the fleet under any mp start
        # method (spawn workers don't inherit parent globals)
        self.trace_ring = (recorder().capacity if trace_ring is None
                           else max(0, int(trace_ring)))

        self._shards: list[_Shard] = []
        self._pumps: list[threading.Thread] = []
        self._listener: TcpListener | None = None
        self._seq = itertools.count()
        self._started = False
        self._closed = False
        self._stats_lock = threading.Lock()
        # recent dispatch->reply latencies (seconds) feeding the
        # p99-derived hedge delay; GIL-atomic appends, no lock needed
        self._lat: "deque[float]" = deque(maxlen=512)
        self.obs = MetricsRegistry()
        self._stats = self.obs.group(
            "shard", {"dispatched": 0, "completed": 0, "respawns": 0,
                      "worker_lost": 0, "replayed": 0, "scatter_queries": 0,
                      "deduped": 0, "slab_payloads": 0,
                      "inline_payloads": 0, "reopens": 0,
                      "reopen_last_s": 0.0, "failovers": 0, "hedges": 0,
                      "hedge_wins": 0, "health_misses": 0, "hung_kills": 0},
            gauges=("reopen_last_s",))
        self._rw = _RWLock()  # windows are readers, reopen() the writer
        # epoch generation guards late hedges: a hedge armed before a
        # reopen must not dispatch after it (its primary answered — or
        # will replay — on the old epoch)
        self._epoch_gen = 0
        self._reopening = False
        self._reopen_dir: str | None = None

    # make the scheduler's locality sort work unchanged
    _locality_key = staticmethod(QueryServer._locality_key)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ShardedQueryServer":
        if self._started:
            return self
        self._started = True
        try:
            if self.transport == "tcp":
                self._listener = TcpListener(self._on_peer)
            for s in range(self.n_shards):
                if self.transport == "tcp":
                    # no shm slabs across TCP: payloads ride inline in
                    # the frame, so no arena is allocated at all
                    arena, free, slab_ok = None, [], False
                else:
                    arena = SlabArena(self.n_slabs, self.slab_bytes)
                    free, slab_ok = list(arena._free), True
                shard = _Shard(index=s, arena=arena, free_slabs=free,
                               slab_ok=slab_ok)
                self._shards.append(shard)
                self._spawn_locked(shard)
            for shard in self._shards:
                pump = threading.Thread(target=self._pump_loop,
                                        args=(shard.index,), daemon=True,
                                        name=f"shard-pump-{shard.index}")
                pump.start()
                self._pumps.append(pump)
            deadline = monotime() + self.start_timeout_s
            for shard in self._shards:
                # re-read shard.ready each poll: a worker that crashes
                # during startup is respawned by the supervisor with a
                # FRESH Event, and waiting on the original object would
                # miss the replacement's ready signal
                while not shard.ready.wait(0.1):
                    if monotime() > deadline:
                        raise RuntimeError(
                            f"shard {shard.index} worker failed to become "
                            f"ready within {self.start_timeout_s:.0f}s")
        except BaseException:
            self.close()
            raise
        return self

    def _spawn_locked(self, shard: _Shard) -> None:
        """(Re)create one worker; caller holds ``shard.lock`` on respawn."""
        if self.transport == "tcp":
            # per-spawn token: the worker (and only it) can present it,
            # and a stale pre-respawn connection can never be re-adopted
            token = os.urandom(16)
            self._listener.expect(shard.index, token, shard.chaos)
            shard.peer = None  # installed by the accept loop on hello
            host, port = self._listener.address
            link = ("tcp", host, port, token.hex())
        else:
            req_q, resp_q = self._ctx.Queue(), self._ctx.Queue()
            shard.peer = QueuePeer(req_q, resp_q, chaos=shard.chaos)
            link = ("queue", req_q, resp_q)
        shard.ready = threading.Event()
        shard.proc = self._ctx.Process(
            target=_shard_worker_main,
            args=(shard.index, self.n_shards, self.ring.vnodes,
                  self.ring.salt, self.replicas, self.db_dir,
                  self.cache_bytes, self.warm_bytes, self.server_factory,
                  self.slab_bytes, self.trace_ring, link),
            daemon=True, name=f"repro-shard-{shard.index}")
        shard.proc.start()

    def _on_peer(self, shard_idx: int, peer) -> None:
        """TCP accept path: install (or replace, on worker reconnect) a
        shard's authenticated peer and flush anything queued while the
        link was down."""
        if not (0 <= shard_idx < len(self._shards)):
            peer.close()
            return
        shard = self._shards[shard_idx]
        with shard.lock:
            old, shard.peer = shard.peer, peer
            backlog, shard.backlog = shard.backlog, []
            for n, msg in enumerate(backlog):
                try:
                    peer.send(msg)
                except PeerClosed:
                    # link died again already: keep the unsent tail for
                    # the next reconnect
                    shard.backlog = backlog[n:] + shard.backlog
                    break
        if old is not None:
            old.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for shard in self._shards:
            with shard.lock:
                if shard.peer is not None:
                    try:
                        shard.peer.send(None)
                    except PeerClosed:
                        pass
        for pump in self._pumps:
            pump.join(timeout=10.0)
        leftovers: list[_Pending] = []
        for shard in self._shards:
            with shard.lock:
                leftovers.extend(shard.pending.values())
                shard.pending.clear()
            if shard.proc is not None:
                shard.proc.join(timeout=5.0)
                if shard.proc.is_alive():
                    shard.proc.terminate()
                    shard.proc.join(timeout=2.0)
                if shard.proc.is_alive():
                    shard.proc.kill()
                    shard.proc.join(timeout=2.0)
            if shard.peer is not None:
                shard.peer.close()
            if shard.arena is not None:
                shard.arena.close()
        if self._listener is not None:
            self._listener.close()
        for p in leftovers:
            if not p.future.done():
                try:
                    p.future.set_exception(
                        RuntimeError("sharded query server closed"))
                except Exception:
                    pass

    def __enter__(self) -> "ShardedQueryServer":
        return self.start()

    def __exit__(self, *a) -> None:
        self.close()

    # -- epoch transitions ----------------------------------------------------
    def reopen(self, db_dir: str) -> dict:
        """Move every worker to a new database directory without restart.

        Takes the window lock exclusively (writer preference — a query
        stream cannot starve the switch), sends each worker a ``reopen``
        control message, and waits for all acks.  Worker queues are FIFO
        and processed serially, so every batch dispatched before this
        call is answered from the *old* epoch and every batch after it
        from the new one — the window lock makes that boundary cover
        whole dispatch windows, so no batched reply mixes epochs.

        A worker that dies mid-switch is respawned by the supervisor on
        the previous directory (replays land on the old epoch — the
        documented recovery limit) and the reopen message is re-sent, so
        the switch still converges.  While the switch is in flight the
        supervisor also suppresses cross-replica failover (death
        recovery replays to the same ring position instead): a partial
        failed over to a shard that already acked would be answered
        from the *new* epoch while its sibling partials came from the
        old one.  The epoch generation bump at the end retires any
        armed-but-unfired hedges for the same reason.
        """
        if not self._started:
            raise RuntimeError("sharded query server is not started")
        if self._closed:
            raise RuntimeError("sharded query server is closed")
        from repro_torch.query.database import CMS_NAME
        new_dir = str(db_dir)
        t0 = monotime()
        self._rw.acquire_write()
        self._reopen_dir = new_dir
        self._reopening = True
        try:
            for shard in self._shards:
                with shard.lock:
                    shard.reopen_ack = threading.Event()
                    self._send_locked(shard, ("reopen", new_dir))
            deadline = monotime() + self.start_timeout_s
            for shard in self._shards:
                seen = shard.deaths
                while not shard.reopen_ack.wait(0.1):
                    if self._closed:
                        raise RuntimeError("sharded query server closed "
                                           "during reopen")
                    with shard.lock:
                        if shard.deaths != seen:
                            # the worker died mid-switch; its replacement
                            # came up on the old directory — re-send
                            seen = shard.deaths
                            self._send_locked(shard, ("reopen", new_dir))
                    if monotime() > deadline:
                        raise RuntimeError(
                            f"shard {shard.index} did not ack reopen "
                            f"within {self.start_timeout_s:.0f}s")
            # respawns-after-death from here on land on the new epoch
            self.db_dir = new_dir
            self._has_cms = os.path.exists(os.path.join(new_dir, CMS_NAME))
            self._epoch_gen += 1
            dt = monotime() - t0
            with self._stats_lock:
                self._stats["reopens"] += 1
                self._stats["reopen_last_s"] = dt
            return {"dir": new_dir, "seconds": dt}
        finally:
            self._reopening = False
            self._reopen_dir = None
            self._rw.release_write()

    @staticmethod
    def _send_locked(shard: _Shard, msg) -> None:
        """Send on a shard's peer (caller holds ``shard.lock``); with the
        link down (TCP reconnect window) the message queues in the
        backlog and flushes, in order, when the peer is re-installed."""
        if shard.peer is None:
            shard.backlog.append(msg)
            return
        try:
            shard.peer.send(msg)
        except PeerClosed:
            shard.backlog.append(msg)

    # -- routing -------------------------------------------------------------
    def _owners_of(self, req: QueryRequest) -> tuple[int, ...]:
        """R-way owner set for a request, primary first."""
        if getattr(req, "op", None) == "value" and not self._has_cms:
            # PMS-only database: the plane a value lookup touches is the
            # profile plane, so route to its owners
            try:
                return self.ring.owners_key((0, int(req.pid or 0)))
            except (TypeError, ValueError):
                pass
        return self.ring.owners(req)

    def _pick_owner(self, owners: tuple[int, ...]) -> int:
        """Route among an owner set: healthiest state first, then least
        backlog (quantized by ``spill_pending`` so small depth noise
        never breaks cache locality), then replica rank.  A fully-dead
        owner set degenerates to the primary — its pendings replay
        through the supervisor anyway."""
        best, best_key = owners[0], None
        for rank, o in enumerate(owners):
            health = self._shards[o].health.rank()
            if health >= 3:  # dead: never route
                continue
            bucket = (len(self._shards[o].pending) // self.spill_pending
                      if self.spill_pending else 0)
            key = (health, bucket, rank)
            if best_key is None or key < best_key:
                best, best_key = o, key
        return best

    def shard_of(self, req: QueryRequest) -> int | None:
        """Target shard for a request; ``None`` means scatter."""
        op = getattr(req, "op", None)
        if self.n_shards > 1 and op in SCATTER_OPS:
            return None
        owners = self._owners_of(req)
        if len(owners) == 1 or not self._shards:
            return owners[0]
        return self._pick_owner(owners)

    def _live_set(self) -> tuple[int, ...]:
        """Shards a scatter query fans out over (every non-dead shard;
        the assignment mask partitions contexts across exactly this
        set).  All-dead degenerates to everyone — the supervisor is
        about to respawn them regardless."""
        live = tuple(s.index for s in self._shards
                     if s.health.rank() < 3)
        return live or tuple(range(self.n_shards))

    def worker_pids(self) -> list[int]:
        return [s.proc.pid for s in self._shards if s.proc is not None]

    # -- chaos hooks (tests + benchmarks/serve_load.py --chaos) ---------------
    def kill_worker(self, shard_idx: int) -> int | None:
        """SIGKILL one shard's worker process (fault injection)."""
        shard = self._shards[shard_idx]
        proc = shard.proc
        if proc is None or proc.pid is None:
            return None
        try:
            os.kill(proc.pid, signal_mod.SIGKILL)
        except (OSError, ProcessLookupError):
            return None
        return proc.pid

    def inject_fault(self, shard_idx: int, kind: str, seconds: float, *,
                     delay_s: float = 0.02) -> None:
        """Arm a transport fault window on one peer: ``drop`` (requests
        vanish), ``delay`` (each send sleeps ``delay_s``), or ``stall``
        (replies stop being delivered — a hung peer)."""
        chaos = self._shards[shard_idx].chaos
        if kind == "drop":
            chaos.drop_for(seconds)
        elif kind == "delay":
            chaos.delay(delay_s, for_s=seconds)
        elif kind == "stall":
            chaos.stall_for(seconds)
        else:
            raise ValueError(f"unknown fault kind {kind!r}")

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, shard_idx: int,
                  reqs: list[tuple[QueryRequest, object]]) -> list[Future]:
        """Send ``[(request, scatter), ...]`` to one worker as a single
        batch message; returns one Future per entry."""
        shard = self._shards[shard_idx]
        items, futs = [], []
        now = monotime()
        with shard.lock:
            if self._closed:
                raise RuntimeError("sharded query server is closed")
            for req, scatter in reqs:
                key = next(self._seq)
                slab = (shard.free_slabs.pop()
                        if shard.free_slabs and shard.slab_ok
                        and _slab_eligible(req, scatter)
                        else None)
                p = _Pending(req, Future(), slab, scatter, t0=now)
                shard.pending[key] = p
                items.append((key, req, slab, scatter))
                futs.append(p.future)
            self._send_locked(shard, items)
        with self._stats_lock:
            self._stats["dispatched"] += len(items)
        return futs

    # -- hedged reads ---------------------------------------------------------
    def _hedge_delay_s(self) -> float:
        """p99 of recent dispatch latencies, floored at ``hedge_ms``: a
        hedge should fire only when the primary is off its own tail."""
        base = (self.hedge_ms or 0.0) / 1e3
        lat = sorted(self._lat)
        if lat:
            base = max(base, lat[int(0.99 * (len(lat) - 1))])
        return max(base, 1e-3)

    def _maybe_hedge(self, req: QueryRequest, primary: int,
                     fut: Future) -> Future:
        """Wrap a single-owner dispatch with an optional hedge: if the
        primary has not answered after a p99-derived delay, the same
        request is dispatched to the next live replica and the first
        reply wins (within an epoch every replica serves byte-identical
        answers, so the winner's identity is unobservable).  The loser's
        reply is still drained normally — it just finds the output
        future already resolved."""
        if self.hedge_ms is None or self.replicas < 2:
            return fut
        owners = self._owners_of(req)
        alts = [o for o in owners
                if o != primary and self._shards[o].health.rank() < 2]
        if not alts:
            return fut
        alt = alts[0]
        out: Future = Future()

        def relay(f: Future, hedged: bool) -> None:
            if out.done():
                return
            exc = f.exception()
            try:
                if exc is not None:
                    out.set_exception(exc)
                else:
                    out.set_result(f.result())
            except Exception:
                return  # lost the race to the other leg
            if hedged:
                with self._stats_lock:
                    self._stats["hedge_wins"] += 1

        fut.add_done_callback(lambda f: relay(f, False))
        gen = self._epoch_gen

        def fire() -> None:
            if out.done() or self._closed:
                return
            # take the window lock as a reader: if a reopen is waiting
            # or running, this blocks until it finishes and the epoch
            # generation check below retires the hedge (the primary
            # answers — or replays — entirely on the old epoch)
            self._rw.acquire_read()
            try:
                if self._epoch_gen != gen or out.done():
                    return
                try:
                    [hfut] = self._dispatch(alt, [(req, False)])
                except RuntimeError:
                    return
                with self._stats_lock:
                    self._stats["hedges"] += 1
                rec = recorder()
                if rec.enabled:
                    rec.record("hedge", str(getattr(req, "op", "?")),
                               monotime(), 0.0,
                               trace_id=getattr(req, "trace_id", None) or "",
                               attrs={"primary": primary, "hedge": alt})
                hfut.add_done_callback(lambda f: relay(f, True))
            finally:
                self._rw.release_read()

        timer = threading.Timer(self._hedge_delay_s(), fire)
        timer.daemon = True
        timer.start()
        out.add_done_callback(lambda _f: timer.cancel())
        return out

    def _await(self, fut: Future, req: QueryRequest):
        try:
            return fut.result(timeout=self.dispatch_timeout_s)
        except FutureTimeout:
            return QueryError(op=str(getattr(req, "op", "?")),
                              error="ShardTimeout",
                              message=f"no shard response within "
                                      f"{self.dispatch_timeout_s:.0f}s")
        except Exception as e:                              # noqa: BLE001
            return QueryError(op=str(getattr(req, "op", "?")),
                              error=type(e).__name__, message=str(e))

    # -- serving surface ------------------------------------------------------
    @staticmethod
    def _dedupe_key(req: QueryRequest):
        """Hashable identity of a request, or None if it has one-off
        unhashable params (then it just doesn't coalesce)."""
        try:
            key = (req.op, req.pid, req.ctx, req.metric, req.inclusive,
                   req.k, req.t0, req.t1,
                   tuple(sorted(req.params.items())))
            hash(key)  # params values may be unhashable (JSON lists)
            return key
        except TypeError:
            return None

    @staticmethod
    def _merged_future(req: QueryRequest, parts: list[Future]) -> Future:
        """A Future that resolves to the scatter-gather merge once every
        per-shard partial has resolved (merge runs on the last pump
        thread to deliver — never blocks a caller)."""
        merged: Future = Future()
        remaining = [len(parts)]
        lock = threading.Lock()

        def on_done(_f: Future) -> None:
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            t0 = monotime()
            try:
                vals = []
                for f in parts:
                    exc = f.exception()
                    if exc is not None:
                        vals.append(QueryError(
                            op=str(getattr(req, "op", "?")),
                            error=type(exc).__name__, message=str(exc)))
                    else:
                        vals.append(f.result())
                res = _merge_scatter(req, vals)
            except Exception as e:                          # noqa: BLE001
                res = QueryError(op=str(getattr(req, "op", "?")),
                                 error=type(e).__name__, message=str(e))
            rec = recorder()
            if rec.enabled:
                rec.record("merge", str(getattr(req, "op", "?")), t0,
                           monotime() - t0,
                           trace_id=getattr(req, "trace_id", None) or "",
                           attrs={"parts": len(parts)})
            if not merged.done():
                merged.set_result(res)

        for f in parts:
            f.add_done_callback(on_done)
        return merged

    def serve_window_async(self, reqs: list[QueryRequest]) -> list[Future]:
        """Dispatch a batch and return one Future per request slot.

        One message per shard per window (the worker re-sorts its slice
        in plane-locality order and streams replies back in chunks);
        scatter ops ride along in every shard's message and resolve
        through a merge future.  Identical requests in a window are
        *coalesced* before dispatch — the cross-process analog of "the
        cache does the batching": a burst of clients asking for the same
        hot plane costs one worker response (and one shm payload), and
        every duplicate slot shares the same Future, exactly like LRU
        hits share a decoded plane in-process.
        """
        if not self._started:
            raise RuntimeError("sharded query server is not started")
        self._rw.acquire_read()
        try:
            return self._serve_window_async_locked(reqs)
        finally:
            self._rw.release_read()

    def _serve_window_async_locked(self,
                                   reqs: list[QueryRequest]) -> list[Future]:
        alias = list(range(len(reqs)))
        reps: dict[object, int] = {}
        for i, req in enumerate(reqs):
            k = self._dedupe_key(req)
            if k is not None:
                alias[i] = reps.setdefault(k, i)
        n_unique = len(set(alias))
        per_shard: list[list[tuple[int, QueryRequest, object]]] = \
            [[] for _ in range(self.n_shards)]
        n_scatter = 0
        live = None
        for i, req in enumerate(reqs):
            if alias[i] != i:
                continue  # a duplicate slot shares its representative
            s = self.shard_of(req)
            if s is None:
                # scatter over the current live set: each member answers
                # its own slice of the (member, live) assignment, which
                # partitions contexts across exactly the live shards
                if live is None:
                    live = self._live_set()
                n_scatter += 1
                for t in live:
                    per_shard[t].append((i, req, (t, live)))
            else:
                per_shard[s].append((i, req, False))
        with self._stats_lock:
            self._stats["scatter_queries"] += n_scatter
            self._stats["deduped"] += len(reqs) - n_unique
        futs: list[Future | None] = [None] * len(reqs)
        scatter_parts: dict[int, list[Future]] = {}
        for s, items in enumerate(per_shard):
            if not items:
                continue
            for (i, req, scatter), fut in zip(
                    items, self._dispatch(s, [(r, sc)
                                              for _, r, sc in items])):
                if scatter:
                    scatter_parts.setdefault(i, []).append(fut)
                else:
                    futs[i] = self._maybe_hedge(req, s, fut)
        for i, parts in scatter_parts.items():
            futs[i] = self._merged_future(reqs[i], parts)
        for i, j in enumerate(alias):
            if j != i:
                futs[i] = futs[j]
        return futs

    def serve_window(self, reqs: list[QueryRequest]) -> list:
        """Blocking :meth:`serve_window_async`: results in request order,
        failures as inline :class:`QueryError` values."""
        futs = self.serve_window_async(reqs)
        return [self._await(f, r) for f, r in zip(futs, reqs)]

    def serve(self, reqs: list[QueryRequest]) -> list:
        return self.serve_window(reqs)

    def serve_one(self, req: QueryRequest):
        return self.serve_window([req])[0]

    def submit(self, req: QueryRequest):
        """Single-request convenience mirroring ``QueryServer.submit``:
        raises structured failures instead of returning them."""
        res = self.serve_one(req)
        if isinstance(res, QueryError):
            raise RuntimeError(f"{res.error}: {res.message} (op={res.op})")
        return res

    # -- supervisor -----------------------------------------------------------
    def _pump_loop(self, shard_idx: int) -> None:
        shard = self._shards[shard_idx]
        while not self._closed:
            peer, proc = shard.peer, shard.proc
            if peer is None:
                # TCP worker (re)connecting; the accept loop installs
                # the peer when the hello lands
                time.sleep(0.02)
                if proc is not None and not proc.is_alive() \
                        and not self._closed:
                    self._handle_death(shard)
                continue
            try:
                msg = peer.recv(timeout=0.1)
            except PeerTimeout:
                if self._closed:
                    continue
                if proc is not None and not proc.is_alive():
                    self._handle_death(shard)
                else:
                    self._check_stall(shard)
                continue
            except PeerClosed:
                if self._closed:
                    continue
                if proc is not None and not proc.is_alive():
                    self._handle_death(shard)
                else:
                    # link lost but the worker lives: a TCP reconnect is
                    # in flight (the accept loop will replace the peer)
                    time.sleep(0.02)
                continue
            self._handle_msg(shard, msg)

    def _check_stall(self, shard: _Shard) -> None:
        """Idle-tick health: dispatched work with no reply for
        ``suspect_after_s`` accumulates misses (alive -> suspect ->
        dead for routing); past ``hang_kill_s`` the worker is presumed
        hung (stalled transport, wedged syscall) and killed so the
        death path can replay/fail over its in-flight requests."""
        now = monotime()
        with shard.lock:
            if not shard.pending:
                return
            oldest = min(p.t0 for p in shard.pending.values())
        stalled_since = max(oldest, shard.last_reply_t)
        age = now - stalled_since
        if age < self.suspect_after_s:
            return
        if now - shard.last_miss_t >= self.suspect_after_s:
            shard.last_miss_t = now
            shard.health.miss()
            with self._stats_lock:
                self._stats["health_misses"] += 1
        if self.hang_kill_s and age >= self.hang_kill_s:
            proc = shard.proc
            if proc is not None and proc.is_alive() and proc.pid:
                with self._stats_lock:
                    self._stats["hung_kills"] += 1
                try:
                    os.kill(proc.pid, signal_mod.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass

    def _handle_msg_locked(self, shard: _Shard, msg
                           ) -> list[tuple[Future, object]]:
        """Decode one worker message; caller holds ``shard.lock`` and
        resolves the returned futures *after* releasing it."""
        shard.last_reply_t = monotime()
        shard.health.ok()
        if msg[0] == "ready":
            shard.warm = msg[1]
            shard.ready.set()
            return []
        if msg[0] == "reopened":
            shard.warm = msg[1].get("warm")
            shard.reopen_ack.set()
            return []
        if len(msg) > 2 and msg[2]:
            # spans the worker piggybacked on this reply chunk
            recorder().extend(msg[2])
        resolved: list[tuple[Future, object]] = []
        slab_n = inline_n = 0
        now = monotime()
        for key, payload in msg[1]:
            p = shard.pending.pop(key, None)
            if p is None:
                continue  # already replayed or failed over
            view = (shard.arena.view(p.slab) if p.slab is not None
                    else None)
            try:
                res = _decode_payload(payload, view)
            except Exception as e:                          # noqa: BLE001
                res = QueryError(op=str(getattr(p.req, "op", "?")),
                                 error=type(e).__name__,
                                 message=f"payload decode failed: {e}")
            if p.slab is not None:
                shard.free_slabs.append(p.slab)
            if payload[0] == "slab":
                slab_n += 1
            else:
                inline_n += 1
            self._lat.append(now - p.t0)
            resolved.append((p.future, res))
        with self._stats_lock:
            self._stats["completed"] += len(resolved)
            self._stats["slab_payloads"] += slab_n
            self._stats["inline_payloads"] += inline_n
        return resolved

    def _handle_msg(self, shard: _Shard, msg) -> None:
        with shard.lock:
            resolved = self._handle_msg_locked(shard, msg)
        for fut, res in resolved:
            if not fut.done():
                fut.set_result(res)

    def _failover_target(self, dead_idx: int, p: _Pending) -> int | None:
        """Where a dead shard's in-flight request should go *now*:
        the healthiest other owner (any shard can answer — every worker
        holds the full database — but owners have the plane warm), or
        any live shard as a last resort; ``None`` keeps it on the
        respawning ring position."""
        if p.scatter:
            # any live shard can compute the original member's slice of
            # the (member, live) assignment — the mask is a pure function
            # of the ring, so the merge stays byte-identical
            cands = [s.index for s in self._shards
                     if s.index != dead_idx and s.health.rank() < 2]
        else:
            owners = self._owners_of(p.req)
            cands = [o for o in owners if o != dead_idx
                     and self._shards[o].health.rank() < 2]
            if not cands:
                cands = [s.index for s in self._shards
                         if s.index != dead_idx and s.health.rank() < 3]
        if not cands:
            return None
        return min(cands, key=lambda s: (self._shards[s].health.rank(),
                                         len(self._shards[s].pending)))

    def _redispatch(self, target_idx: int, pendings: list[_Pending]) -> None:
        """Failover: move in-flight pendings (same futures) onto a live
        shard's queue."""
        shard = self._shards[target_idx]
        rec = recorder()
        now = monotime()
        with shard.lock:
            if self._closed:
                return
            items = []
            for p in pendings:
                key = next(self._seq)
                p.slab = (shard.free_slabs.pop()
                          if shard.free_slabs and shard.slab_ok
                          and _slab_eligible(p.req, p.scatter) else None)
                p.t0 = now
                shard.pending[key] = p
                items.append((key, p.req, p.slab, p.scatter))
                if rec.enabled:
                    # zero-duration marker: this request crossed a worker
                    # death and failed over to a live replica
                    rec.record("failover", str(getattr(p.req, "op", "?")),
                               now, 0.0,
                               trace_id=getattr(p.req, "trace_id", None)
                               or "",
                               attrs={"to": target_idx,
                                      "replays": p.replays})
            self._send_locked(shard, items)
        with self._stats_lock:
            # a failover is still a replay (re-sent after loss) — the
            # failovers counter tracks the cross-replica subset
            self._stats["failovers"] += len(pendings)
            self._stats["replayed"] += len(pendings)

    def _handle_death(self, shard: _Shard) -> None:
        """The supervisor path: drain, fail over, back off, respawn,
        replay.

        The dead worker's link stays installed until the replacement is
        (both swaps happen under ``shard.lock``), so a concurrent
        :meth:`_dispatch` never touches a closed transport — at worst
        its message lands in the orphaned link and its pending entries
        are picked up by the recovery snapshot below.

        With replicas, in-flight requests that have another live owner
        are **failed over immediately** — re-dispatched to that owner
        before the respawn backoff, so a killed worker costs one
        failover hop, not a respawn wait.  During an epoch switch
        failover is suppressed (replays stay on this ring position) so
        sibling scatter partials can never straddle epochs.
        """
        resolved: list[tuple[Future, object]] = []
        with shard.lock:
            if self._closed or shard.proc is None or shard.proc.is_alive():
                return
            # responses the worker got out before dying still count
            peer = shard.peer
            while peer is not None:
                try:
                    msg = peer.recv(timeout=0.0, bypass_chaos=True)
                except PeerError:
                    break
                resolved.extend(self._handle_msg_locked(shard, msg))
            shard.proc.join(timeout=1.0)
            shard.deaths += 1
            deaths = shard.deaths
            shard.health.dead()
            # snapshot survivors now: failover must not wait out the
            # respawn backoff below
            survivors = sorted(shard.pending.items())  # dispatch order
            shard.pending.clear()
            replay: list[_Pending] = []
            doomed: list[_Pending] = []
            for _, p in survivors:
                if p.slab is not None:  # slab content is garbage now
                    shard.free_slabs.append(p.slab)
                    p.slab = None
                p.replays += 1
                (doomed if p.replays > self.replay_limit else replay).append(p)
        for fut, res in resolved:
            if not fut.done():
                fut.set_result(res)
        # freeze the recent span history: the last moments before this
        # death are exactly what a postmortem needs
        recorder().dump(f"worker_death shard={shard.index} deaths={deaths}")
        # cross-replica failover first (never during an epoch switch:
        # the target may already serve the new epoch)
        requeue: list[_Pending] = []
        by_target: dict[int, list[_Pending]] = {}
        if self._reopening or self.n_shards == 1:
            requeue = replay
        else:
            for p in replay:
                t = self._failover_target(shard.index, p)
                if t is None:
                    requeue.append(p)
                else:
                    by_target.setdefault(t, []).append(p)
            for t, ps in by_target.items():
                self._redispatch(t, ps)
        # exponential backoff so a worker that dies deterministically at
        # startup (corrupt database, OOM loop) cannot pin a CPU with a
        # fork-per-100ms respawn storm; requests arriving meanwhile queue
        # against the admission bound and are replayed below
        time.sleep(min(0.05 * (2 ** min(deaths - 1, 6)), 2.0))
        with shard.lock:
            if self._closed:
                return
            old_peer = shard.peer
            # dispatches that raced the failover snapshot above landed
            # in the dead worker's orphaned link: move them onto the
            # replacement with the same-position replays (they never
            # reached a worker, so their replay budget is untouched)
            for _, p in sorted(shard.pending.items()):
                if p.slab is not None:
                    shard.free_slabs.append(p.slab)
                    p.slab = None
                requeue.append(p)
            shard.pending.clear()
            self._spawn_locked(shard)
            shard.health.rejoining()
            if old_peer is not None and old_peer is not shard.peer:
                old_peer.close()
            items = []
            rec = recorder()
            now = monotime()
            for p in requeue:
                key = next(self._seq)
                p.slab = (shard.free_slabs.pop()
                          if shard.free_slabs and shard.slab_ok
                          and _slab_eligible(p.req, p.scatter) else None)
                p.t0 = now
                shard.pending[key] = p
                items.append((key, p.req, p.slab, p.scatter))
                if rec.enabled:
                    # zero-duration marker: this request crossed a worker
                    # death and was re-dispatched (its trace shows a
                    # second decode on the replacement worker)
                    rec.record("replay", str(getattr(p.req, "op", "?")),
                               now, 0.0,
                               trace_id=getattr(p.req, "trace_id", None)
                               or "",
                               attrs={"shard": shard.index,
                                      "replays": p.replays})
            if items:
                self._send_locked(shard, items)
            if self._reopening and self._reopen_dir is not None:
                # an epoch switch is in flight and the dead worker may
                # have swallowed — or already acked — its reopen message;
                # the replacement just came up on the pre-switch
                # directory, so re-send here or the switch wedges (the
                # ack loop's deaths check misses deaths that land before
                # it snapshots, and a send into the orphaned link is
                # silently lost).  Replays were queued first, so they
                # answer from the old epoch — the documented limit.
                self._send_locked(shard, ("reopen", self._reopen_dir))
        with self._stats_lock:
            self._stats["respawns"] += 1
            self._stats["replayed"] += len(requeue)
            self._stats["worker_lost"] += len(doomed)
        for p in doomed:
            if not p.future.done():
                p.future.set_result(QueryError(
                    op=str(getattr(p.req, "op", "?")), error="WorkerLost",
                    message=f"request killed its worker "
                            f"{p.replays - 1} time(s); giving up after "
                            f"{self.replay_limit} replays"))

    # -- observability --------------------------------------------------------
    def warm_reports(self) -> list[dict | None]:
        return [s.warm for s in self._shards]

    def metrics(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["n_shards"] = self.n_shards
        out["replicas"] = self.replicas
        out["transport"] = self.transport
        out["hedge_ms"] = self.hedge_ms
        out["slab_bytes"] = self.slab_bytes
        per = []
        for s in self._shards:
            with s.lock:
                entry = {"shard": s.index,
                         "pid": s.proc.pid if s.proc is not None else None,
                         "alive": bool(s.proc is not None
                                       and s.proc.is_alive()),
                         "pending": len(s.pending),
                         "deaths": s.deaths,
                         "free_slabs": len(s.free_slabs),
                         "health": s.health.snapshot(),
                         "warm": s.warm}
                chaos = s.chaos.active()
                if any(chaos[k] for k in ("drop", "delay_s", "stall")):
                    entry["chaos"] = chaos
                per.append(entry)
        out["shards"] = per
        return out
