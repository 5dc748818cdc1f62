"""The port's query service on the CPU, against the reference's.

A database the port wrote is served by the port's
:class:`repro_torch.serve.engine.QueryServer` and by the reference's
``repro.serve.engine.QueryServer`` (which imports jax; tests may), and every
op's reply is the same on the wire; the two packages' HTTP servers answer
``/v1/query`` and ``/v1/findings`` with the same bytes; the port's sharded
server equals its in-process engine over shm and over tcp; a follower picks
up each epoch the port's ingest tier publishes; the consistent-hash ring
gives the reference's owners; and the ``query-server`` and ``watch`` CLIs
run with no card and load no torch.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.query import Database as RefDatabase
from repro.serve.engine import QueryRequest as RefRequest
from repro.serve.engine import QueryServer as RefServer
from repro.serve.http import QueryHTTPServer as RefHTTPServer
from repro.serve.shard import ConsistentHashRing as RefRing
from repro.serve.wire import result_to_wire as ref_result_to_wire
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.ingest import (IngestClient, IngestHTTPServer, IngestState,
                                SnapshotStore, epoch_dirname)
from repro_torch.query import Database
from repro_torch.serve import (ConsistentHashRing, QueryClient,
                               QueryHTTPServer, QueryRequest, QueryServer,
                               ShardedQueryServer)
from repro_torch.serve.wire import request_to_wire, result_to_wire
from tests.conftest import make_profile

ROOT = Path(__file__).resolve().parents[1]
N_PROFILES = 6
TRACE_ID = "0123456789abcdef"
OPS = ("profile", "stripe", "value", "topk", "threshold", "window",
       "findings")
# lowered so that the analyzers find something in this small workload
FINDINGS_THRESHOLDS = {"imbalance": 1.1, "straggler": 1.1, "gap_frac": 0.05}


def _write_profiles(dirpath, n, *, seed=11, start=0, scale=1.0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        prof = make_profile(rng, n_nodes=80, n_metrics=6, density=0.3,
                            n_trace=24, identity={"rank": start + i})
        prof.metrics.val[:] = prof.metrics.val * scale
        p = os.path.join(str(dirpath), f"prof{start + i:03d}.rprf")
        prof.save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    """A database the port wrote through the launch funnel (the kernels'
    plain versions)."""
    td = tmp_path_factory.mktemp("pservedb")
    paths = _write_profiles(td, N_PROFILES)
    StreamingAggregator(td / "db", AggregationConfig(
        executor="threads", n_workers=3, compute="device",
        device="cpu")).run(paths)
    return str(td / "db")


def _op_request(cls, op: str, db):
    """One request of ``op`` in either package's ``QueryRequest`` class,
    aimed at the database's hottest (context, metric) pair."""
    ctx, mid = int(db.stats["ctx"][0]), int(db.stats["mid"][0])
    return {
        "profile": lambda: cls(op="profile", pid=1),
        "stripe": lambda: cls(op="stripe", ctx=ctx, metric=mid),
        "value": lambda: cls(op="value", pid=0, ctx=ctx, metric=mid),
        "topk": lambda: cls(op="topk", metric=0, inclusive=True, k=5),
        "threshold": lambda: cls(op="threshold", metric=0, inclusive=True,
                                 params={"min_value": 1.0}),
        "window": lambda: cls(op="window", pid=2, t0=0.0, t1=0.7),
        "findings": lambda: cls(op="findings", metric=0, params={
            "limit": 10, "thresholds": FINDINGS_THRESHOLDS}),
    }[op]()


def _wire(to_wire, res) -> str:
    return json.dumps(to_wire(res), sort_keys=True)


# ---------------------------------------------------------------------------
# the engine: the port's replies equal the reference's, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_query_server_equals_reference(db_dir, op):
    with Database(db_dir) as db, RefDatabase(db_dir) as rdb:
        got = QueryServer(db).serve([_op_request(QueryRequest, op, db)])
        ref = RefServer(rdb).serve([_op_request(RefRequest, op, rdb)])
    assert _wire(result_to_wire, got[0]) == _wire(ref_result_to_wire, ref[0])
    assert type(got[0]).__name__ != "QueryError", got[0]
    if op == "findings":
        assert len(got[0]) > 0


def test_query_server_batch_with_failures_equals_reference(db_dir):
    """A batch of every op plus malformed requests: the same replies in
    the same slots, failures isolated the same way."""
    bad = [dict(op="nope"), dict(op="profile", pid=10**6),
           dict(op="stripe", ctx=0, metric="no_such_name"),
           dict(op="findings", params={"bogus": 1})]
    with Database(db_dir) as db, RefDatabase(db_dir) as rdb:
        got = QueryServer(db).serve(
            [_op_request(QueryRequest, op, db) for op in OPS]
            + [QueryRequest(**b) for b in bad])
        ref = RefServer(rdb).serve(
            [_op_request(RefRequest, op, rdb) for op in OPS]
            + [RefRequest(**b) for b in bad])
    assert [_wire(result_to_wire, g) for g in got] == \
        [_wire(ref_result_to_wire, r) for r in ref]
    assert [type(g).__name__ for g in got[len(OPS):]] == ["QueryError"] * 4


# ---------------------------------------------------------------------------
# HTTP: the two packages' servers answer with the same bytes
# ---------------------------------------------------------------------------

def _raw(address, method, path, body=None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        payload = None if body is None else json.dumps(body).encode()
        hdrs = {"X-Trace-Id": TRACE_ID}
        if payload is not None:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=payload, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("endpoint", ["query", "findings"])
def test_http_bodies_equal_reference(db_dir, endpoint):
    with Database(db_dir) as db:
        reqs = [_op_request(QueryRequest, op, db) for op in OPS]
    body = {"requests": [request_to_wire(r) for r in reqs]}
    call = (("POST", "/v1/query", body) if endpoint == "query"
            else ("GET", "/v1/findings?metric=0&limit=10", None))
    bodies = []
    for db_cls, srv_cls in ((Database, QueryHTTPServer),
                            (RefDatabase, RefHTTPServer)):
        with db_cls(db_dir) as handle, srv_cls(handle, port=0,
                                               warm_bytes=0) as srv:
            status, raw = _raw(srv.address, *call)
            assert status == 200, raw[:500]
            bodies.append(raw)
    assert bodies[0] == bodies[1]
    doc = json.loads(bodies[0])
    assert doc["trace_id"] == TRACE_ID
    if endpoint == "query":
        assert len(doc["results"]) == len(OPS)
    else:
        assert doc["count"] == len(doc["findings"]) > 0


def test_http_health_metrics_spans_and_drain(db_dir):
    with Database(db_dir) as db, QueryHTTPServer(db, port=0, warm_bytes=0,
                                                 trace_ring=256) as srv:
        with QueryClient(*srv.address) as cl:
            assert cl.health()["status"] == "ok"
            cl.batch([_op_request(QueryRequest, "profile", db)],
                     trace_id=TRACE_ID)
            m = cl.metrics()
            assert m["scheduler"]["completed"] >= 1
        status, prom = _raw(srv.address, "GET", "/metrics?format=prom")
        assert status == 200 and b"# TYPE" in prom
        status, spans = _raw(srv.address, "GET", "/debug/spans")
        assert status == 200
        assert TRACE_ID in {s["trace_id"] for s in
                            json.loads(spans)["spans"]}
        assert srv.drain(timeout_s=5)["drained"] is True
        status, raw = _raw(srv.address, "POST", "/v1/query",
                           {"requests": [{"op": "profile", "pid": 0}]})
        assert status == 503 and json.loads(raw)["error"] == "Draining"


# ---------------------------------------------------------------------------
# sharded serving equals the in-process engine
# ---------------------------------------------------------------------------

def _shm_prefix() -> str:
    return f"rtorch_{os.getpid()}_"


def _own_segments() -> set[str]:
    """This process's shared memory segments: only the port's prefix with
    this pid, never the global listing other processes write to."""
    return {n for n in os.listdir("/dev/shm") if n.startswith(_shm_prefix())}


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_sharded_equals_inprocess(db_dir, transport):
    with Database(db_dir) as db:
        reqs = [_op_request(QueryRequest, op, db) for op in OPS]
        reqs += [QueryRequest(op="profile", pid=p) for p in range(N_PROFILES)]
        reqs += [QueryRequest(op="nope")]
        ref = [_wire(result_to_wire, QueryServer(db).serve_one(r))
               for r in reqs]
    before = _own_segments()
    with ShardedQueryServer(db_dir, 2, transport=transport, n_slabs=4,
                            slab_bytes=1 << 20) as srv:
        if transport == "shm":
            assert len(_own_segments() - before) == 8  # 2 shards x 4 slabs
        got = [_wire(result_to_wire, r) for r in srv.serve(reqs)]
        m = srv.metrics()
    assert got == ref
    assert m["completed"] == m["dispatched"] and m["respawns"] == 0
    time.sleep(0.1)
    assert not (_own_segments() - before), "close() left shm segments"


# ---------------------------------------------------------------------------
# the consistent-hash ring
# ---------------------------------------------------------------------------

KEYS = [(g, i) for g in (0, 1, 2) for i in range(1500)]


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_ring_owners_equal_reference(n_shards, replicas):
    ring = ConsistentHashRing(n_shards, replicas=replicas)
    ref = RefRing(n_shards, replicas=replicas)
    assert ring.replicas == ref.replicas
    assert [ring.owners_key(k) for k in KEYS] == \
        [ref.owners_key(k) for k in KEYS]
    assert [ring.route_key(k) for k in KEYS] == \
        [ref.route_key(k) for k in KEYS]


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_ring_growth_keeps_old_owners_as_a_prefix(n_shards, replicas):
    """Growing N -> N+1 only adds ring points: drop the newcomer from a
    key's grown owner list and what remains is a prefix of its old list
    (owners are not stable per rank: the newcomer may take rank 0)."""
    old = ConsistentHashRing(n_shards, replicas=replicas)
    new = ConsistentHashRing(n_shards + 1, replicas=replicas)
    for k in KEYS:
        before, after = old.owners_key(k), new.owners_key(k)
        rest = tuple(s for s in after if s != n_shards)
        assert before[:len(rest)] == rest, (k, before, after)


# ---------------------------------------------------------------------------
# following a live snapshot root
# ---------------------------------------------------------------------------

def _cpu_ingest(root, **kw):
    return IngestHTTPServer(root, config=AggregationConfig(
        executor="serial", compute="cpu"), **kw)


def _epoch_answers(root, epoch, reqs):
    with Database(os.path.join(root, epoch_dirname(epoch))) as db:
        server = QueryServer(db)
        return [result_to_wire(server.serve_one(r)) for r in reqs]


def _await_epoch(qc, epoch, limit_s=20.0):
    deadline = time.monotonic() + limit_s
    while qc.health().get("epoch") != epoch:
        assert time.monotonic() < deadline, "follower never saw the epoch"
        time.sleep(0.02)


def test_follow_single_process(tmp_path):
    blobs = [open(p, "rb").read() for p in _write_profiles(tmp_path, 6)]
    root = str(tmp_path / "live")
    reqs = [QueryRequest(op="topk", metric=1, k=64, inclusive=True),
            QueryRequest(op="profile", pid=0)]
    with _cpu_ingest(root) as ing, IngestClient(*ing.address) as ic:
        ic.upload_many(blobs[:3])
        e1 = ic.publish()["epoch"]
        with QueryHTTPServer(root, follow=True, poll_ms=20,
                             warm_bytes=0) as srv, \
                QueryClient(*srv.address) as qc:
            assert qc.health()["epoch"] == e1
            got = [result_to_wire(r) for r in qc.batch(reqs)]
            assert got == _epoch_answers(root, e1, reqs)
            ic.upload_many(blobs[3:])
            e2 = ic.publish()["epoch"]
            _await_epoch(qc, e2)
            got = [result_to_wire(r) for r in qc.batch(reqs)]
            assert got == _epoch_answers(root, e2, reqs)
            m = qc.metrics()
            assert m["epoch"]["transitions"] == 2
            assert m["epoch"]["follow_errors"] == 0


def test_follow_sharded_no_mixed_epoch_replies(tmp_path):
    """A sharded follower crosses two epoch transitions under continuous
    fire of scatter ops; every batched reply equals exactly one epoch's
    answers."""
    blobs = [open(p, "rb").read() for p in _write_profiles(tmp_path, 9)]
    root = str(tmp_path / "live")
    reqs = [QueryRequest(op="topk", metric=1, k=256, inclusive=True),
            QueryRequest(op="threshold", metric=1, inclusive=True,
                         params={"min_value": 0.0})]
    expected: dict[int, list] = {}
    with _cpu_ingest(root, merge_batch=4) as ing, \
            IngestClient(*ing.address) as ic:
        ic.upload_many(blobs[:3])
        e1 = ic.publish()["epoch"]
        expected[e1] = _epoch_answers(root, e1, reqs)
        with QueryHTTPServer(root, follow=True, poll_ms=20, shards=2,
                             warm_bytes=0) as srv:
            stop = threading.Event()
            batches: list[list] = []
            errors: list[Exception] = []

            def fire():
                with QueryClient(*srv.address) as qc2:
                    while not stop.is_set():
                        try:
                            res = qc2.batch(reqs)
                        except Exception as e:           # noqa: BLE001
                            errors.append(e)
                            return
                        batches.append([result_to_wire(r) for r in res])

            thread = threading.Thread(target=fire, daemon=True)
            thread.start()
            with QueryClient(*srv.address) as qc:
                for lo, hi in ((3, 6), (6, 9)):
                    ic.upload_many(blobs[lo:hi])
                    epoch = ic.publish()["epoch"]
                    expected[epoch] = _epoch_answers(root, epoch, reqs)
                    _await_epoch(qc, epoch)
                    time.sleep(0.1)  # observe post-switch replies
                stop.set()
                thread.join(timeout=15)
                metrics = qc.metrics()
    assert not errors, errors[:1]
    assert metrics["epoch"]["transitions"] == 3  # open + 2
    assert metrics["shards"]["reopens"] == 2
    assert metrics["shards"]["respawns"] == 0
    assert batches, "the query thread never completed a batch"
    seen = set()
    for got in batches:
        owners = [e for e, ans in expected.items() if got == ans]
        assert owners, "a reply mixes epochs (or matches none)"
        seen.add(owners[0])
    assert len(seen) >= 2


# ---------------------------------------------------------------------------
# the CLIs: no card, no torch; ready line; SIGTERM drains
# ---------------------------------------------------------------------------

def _cli(*argv, importtime=False):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "HOME": os.environ.get("HOME", "/")}
    flags = ["-X", "importtime"] if importtime else []
    return subprocess.Popen(
        [sys.executable, *flags, "-m", "repro_torch.launch.serve", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
        text=True)


def _stop(proc, timeout=60) -> tuple[str, str]:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.communicate(timeout=timeout)
    except BaseException:
        proc.kill()
        raise


def _imported(err: str) -> set[str]:
    """Top-level package names from ``-X importtime``'s stderr lines."""
    return {ln.rsplit("|", 1)[-1].strip().split(".")[0]
            for ln in err.splitlines() if ln.startswith("import time:")}


@pytest.mark.parametrize("shards", [0, 2])
def test_query_server_cli_ready_line_sigterm_drain_no_torch(db_dir, shards):
    proc = _cli("query-server", db_dir, "--port", "0", "--no-warm",
                "--shards", str(shards), "--drain-timeout-s", "5",
                importtime=True)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["url"].startswith("http://") and info["shards"] == shards
        host, port = info["url"].removeprefix("http://").split(":")
        with Database(db_dir) as db:
            reqs = [_op_request(QueryRequest, op, db) for op in OPS]
            ref = [result_to_wire(QueryServer(db).serve_one(r))
                   for r in reqs]
        with QueryClient(host, int(port)) as cl:
            got = [result_to_wire(r) for r in cl.batch(reqs)]
    finally:
        out, err = _stop(proc)
    assert got == ref
    assert proc.returncode == 0, err[-2000:]
    drains = [json.loads(ln)["drain"] for ln in err.splitlines()
              if ln.startswith("{") and "drain" in ln]
    assert drains and drains[0]["drained"] is True
    mods = _imported(err)
    assert "repro_torch" in mods
    assert not mods & {"torch", "jax", "repro"}, mods & {"torch", "jax",
                                                         "repro"}


def test_watch_cli_reports_each_epoch_and_loads_no_torch(tmp_path, db_dir):
    """``watch`` follows a root the port's ingest state publishes into:
    one JSON report per epoch it saw, none regressed against a baseline
    of the same profiles."""
    paths = _write_profiles(tmp_path, N_PROFILES)
    root = str(tmp_path / "live")
    store = SnapshotStore(root)
    state = IngestState(AggregationConfig(executor="serial", compute="cpu"))
    state.append(paths[:3])
    store.publish(state.write_database)
    proc = _cli("watch", f"live={root}", "--baseline", db_dir,
                "--poll-ms", "50", importtime=True)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["target"] == "live" and first["epoch"] == 1
        state.append(paths[3:])
        store.publish(state.write_database)
        second = json.loads(proc.stdout.readline())
    finally:
        out, err = _stop(proc)
    assert proc.returncode == 0, err[-2000:]
    assert second["epoch"] == 2
    assert not [f for f in second["findings"] if f["kind"] == "regression"]
    status = [json.loads(ln)["status"] for ln in err.splitlines()
              if ln.startswith('{"status"')]
    assert status and status[0]["counters"]["epochs"] == 2
    assert not _imported(err) & {"torch", "jax", "repro"}


def test_obs_export_database_read_by_analyze_query(tmp_path, db_dir):
    """``--obs-export``: the spans a query server recorded become a
    database (aggregated on numpy) that the port's ``analyze query``
    reads."""
    out_dir = str(tmp_path / "obs")
    proc = _cli("query-server", db_dir, "--port", "0", "--no-warm",
                "--obs-export", out_dir, "--trace-ring", "512")
    try:
        info = json.loads(proc.stdout.readline())
        host, port = info["url"].removeprefix("http://").split(":")
        with QueryClient(host, int(port)) as cl:
            for pid in range(3):
                cl.profile(pid)
    finally:
        _, err = _stop(proc)
    assert proc.returncode == 0, err[-2000:]
    summary = [json.loads(ln)["obs_export"] for ln in err.splitlines()
               if ln.startswith('{"obs_export"')]
    assert summary and summary[0]["spans"] > 0
    q = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", "query",
         summary[0]["db_dir"], "topk", "--metric", "obs.time", "-k", "3"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert q.returncode == 0, q.stderr[-2000:]
    rows = json.loads(q.stdout)["rows"]
    assert rows and any("/serve/" in r["path"] for r in rows)
