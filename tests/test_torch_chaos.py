"""The port's chaos schedule against the reference's, and its replica-failure
drills: the counterparts of ``tests/test_replication.py``'s failover and
schedule tests and of the ``-m chaos`` suite in ``tests/test_chaos.py``.

A database the port wrote (six profiles) is served by the port's
``ShardedQueryServer`` (three shards, two replicas) while workers are
killed, singly and as a whole owner group, or the transport drops and
stalls: no request fails, and every reply is byte-equal on the wire to
the reference's in-process ``QueryServer`` on the same database.  The
long drills are marked ``chaos``, as the reference's are, so the default
``-m 'not chaos'`` keeps them out of tier-1.  Every wait is bounded here
(``join`` with a timeout, polling with a deadline); a shared-memory leak
check lists only this process's ``/dev/shm/rtorch_<pid>_*`` segments.
"""
import dataclasses
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from repro.query import Database as RefDatabase
from repro.serve import chaos as ref_chaos
from repro.serve.engine import QueryRequest as RefRequest
from repro.serve.engine import QueryServer as RefServer
from repro.serve.wire import result_to_wire as ref_result_to_wire
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.query import Database
from repro_torch.serve import chaos
from repro_torch.serve.chaos import (AppliedEvent, ChaosEvent, ChaosSchedule,
                                     default_schedule)
from repro_torch.serve.engine import QueryError, QueryRequest, QueryServer
from repro_torch.serve.shard import ShardedQueryServer
from repro_torch.serve.wire import result_to_wire
from tests.conftest import make_profile

N_PROFILES = 6
JOIN_S = 60.0
# workers start by spawn: a worker forked (or respawned) from this
# process, which runs JAX's threads and the server's pump threads, can
# deadlock before it serves
MP = "spawn"


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    """Six profiles aggregated by the port (numpy compute: the serving
    path under test imports no torch)."""
    td = tmp_path_factory.mktemp("pchaosdb")
    rng = np.random.default_rng(31)
    paths = []
    for i in range(N_PROFILES):
        prof = make_profile(rng, n_nodes=80, n_metrics=6, density=0.3,
                            n_trace=20, identity={"rank": i})
        p = td / f"prof{i:03d}.rprf"
        prof.save(p)
        paths.append(str(p))
    StreamingAggregator(td / "db", AggregationConfig(
        executor="threads", n_workers=3, compute="cpu")).run(paths)
    return str(td / "db")


def _mixed(db, n, seed, cls):
    """The reference tests' mixed stream, as requests of ``cls``."""
    rng = np.random.default_rng(seed)
    ctxs, mids = db.stats["ctx"], db.stats["mid"]
    reqs = []
    for _ in range(n):
        i = int(rng.integers(len(ctxs)))
        p = rng.random()
        if p < 0.35:
            reqs.append(cls(op="stripe", ctx=int(ctxs[i]),
                            metric=int(mids[i])))
        elif p < 0.55:
            reqs.append(cls(op="profile",
                            pid=int(rng.integers(db.n_profiles))))
        elif p < 0.75:
            reqs.append(cls(op="topk", metric=0, inclusive=True,
                            k=int(rng.integers(3, 10))))
        else:
            reqs.append(cls(op="window", pid=int(rng.integers(db.n_profiles)),
                            t0=0.0, t1=0.7))
    return reqs


def _enc(results):
    return [json.dumps(result_to_wire(r), sort_keys=True) for r in results]


def _batches_and_refs(db_dir, n_batches, per_batch, seed0):
    """The port's request batches and the reference engine's encoded
    replies to the same requests."""
    with Database(db_dir) as db:
        batches = [_mixed(db, per_batch, seed0 + s, QueryRequest)
                   for s in range(n_batches)]
    with RefDatabase(db_dir) as rdb:
        refs = [[json.dumps(ref_result_to_wire(r), sort_keys=True)
                 for r in RefServer(rdb).serve(
                     _mixed(rdb, per_batch, seed0 + s, RefRequest))]
                for s in range(n_batches)]
    return batches, refs


def _wait_metric(srv, key, minimum, timeout_s=25.0):
    """Failover answers before the respawn finishes: poll the counter."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and srv.metrics()[key] < minimum:
        time.sleep(0.05)
    return srv.metrics()[key]


def _leaked():
    prefix = f"rtorch_{os.getpid()}_"
    if not os.path.isdir("/dev/shm"):
        return set()
    return {f for f in os.listdir("/dev/shm") if f.startswith(prefix)}


class _SleepServer(QueryServer):
    """Worker-side double: ``sleep`` stalls for ``t0`` seconds (module
    level, so any start method can ship it to the workers)."""

    def submit(self, req):
        if req.op == "sleep":
            time.sleep(req.t0)
            return 0.0
        return super().submit(req)


# ---------------------------------------------------------------------------
# schedule mechanics (test_replication.py's)
# ---------------------------------------------------------------------------

class _StubServer:
    def __init__(self):
        self.calls = []

    def kill_worker(self, shard):
        self.calls.append(("kill", shard))
        return 4242

    def inject_fault(self, shard, kind, seconds, *, delay_s=0.02):
        self.calls.append((kind, shard, seconds))


def test_chaos_schedule_applies_events_in_order():
    srv = _StubServer()
    sched = ChaosSchedule(srv, [
        ChaosEvent(at_s=0.10, kind="drop", shard=1, duration_s=0.2),
        ChaosEvent(at_s=0.02, kind="kill", shard=0),
        ChaosEvent(at_s=0.15, kind="kill_group", shards=(0, 2)),
    ])
    with sched:
        time.sleep(0.4)
    assert srv.calls == [("kill", 0), ("drop", 1, 0.2),
                         ("kill", 0), ("kill", 2)]
    rep = sched.report()
    assert [r["kind"] for r in rep] == ["kill", "drop", "kill_group"]
    assert rep[0]["pid"] == 4242
    assert rep[2]["targets"] == [0, 2]
    assert isinstance(sched.applied[0], AppliedEvent)


def test_chaos_schedule_stop_cancels_pending_events():
    srv = _StubServer()
    sched = ChaosSchedule(srv, [ChaosEvent(at_s=5.0, kind="kill")])
    sched.start()
    sched.stop()
    sched.join(2.0)
    assert not sched._thread.is_alive()
    assert srv.calls == []


def test_chaos_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        ChaosEvent(at_s=0.0, kind="meteor")
    assert chaos.KINDS == ref_chaos.KINDS


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_default_schedule_equals_reference(n_shards):
    for kw in ({}, {"span_s": 0.7}, {"span_s": 3.0,
                                     "kinds": ("stall", "kill_group",
                                               "delay", "meteor")},
               {"kinds": ("meteor",)}):
        got = [dataclasses.astuple(e) for e in default_schedule(n_shards,
                                                                **kw)]
        want = [dataclasses.astuple(e)
                for e in ref_chaos.default_schedule(n_shards, **kw)]
        assert got == want, kw


# ---------------------------------------------------------------------------
# failover drills (test_replication.py's): kills cost latency, no answers
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not hasattr(signal, "SIGKILL"), reason="POSIX only")
def test_single_replica_kill_mid_load_zero_failures(db_dir):
    """R=2: SIGKILL one worker while its batch is in flight: every reply
    is the reference's, no QueryError, by failover to the replica."""
    (reqs,), (ref,) = _batches_and_refs(db_dir, 1, 60, 1)
    with ShardedQueryServer(db_dir, 3, slab_bytes=1 << 20, replicas=2,
                            server_factory=_SleepServer,
                            mp_context=MP) as srv:
        sleeper = QueryRequest(op="sleep", t0=0.6)
        victim = srv.shard_of(sleeper)
        out: list = [None]
        t = threading.Thread(
            target=lambda: out.__setitem__(0, srv.serve([sleeper] + reqs)))
        t.start()
        time.sleep(0.2)  # the victim is inside the sleep, its batch in flight
        os.kill(srv.worker_pids()[victim], signal.SIGKILL)
        t.join(JOIN_S)
        assert not t.is_alive(), "serve() wedged after replica death"
        got = out[0]
        assert not any(isinstance(r, QueryError) for r in got), got
        assert got[0] == 0.0
        assert _enc(got[1:]) == ref
        assert _wait_metric(srv, "respawns", 1) >= 1
        assert srv.metrics()["failovers"] >= 1


@pytest.mark.skipif(not hasattr(signal, "SIGKILL"), reason="POSIX only")
def test_whole_group_kill_mid_load_zero_failures(db_dir):
    """Kill an owner group (2 of 3 shards) at once mid-load: the survivor
    answers everything, the dead rejoin, and no segment of this process
    is left in /dev/shm."""
    batches, refs = _batches_and_refs(db_dir, 4, 30, 0)
    with ShardedQueryServer(db_dir, 3, slab_bytes=1 << 20, replicas=2,
                            mp_context=MP) as srv:
        results: list = []
        t = threading.Thread(
            target=lambda: results.extend(_enc(srv.serve(b))
                                          for b in batches))
        t.start()
        time.sleep(0.05)
        pids = srv.worker_pids()
        os.kill(pids[0], signal.SIGKILL)
        os.kill(pids[1], signal.SIGKILL)
        t.join(2 * JOIN_S)
        assert not t.is_alive(), "serve() wedged after group death"
        assert results == refs
        assert _wait_metric(srv, "respawns", 1) >= 1
        _assert_recovered(srv, batches[0])
    assert _leaked() == set()


def _assert_recovered(srv, probe):
    """After the faults: one more round trip until every shard is
    routable again (respawned workers rejoin as alive)."""
    deadline = time.monotonic() + 25.0
    while time.monotonic() < deadline:
        srv.serve(probe)
        if all(s["health"]["state"] != "dead"
               for s in srv.metrics()["shards"]):
            return
        time.sleep(0.1)
    pytest.fail(f"shards never rejoined: {srv.metrics()['shards']}")


# ---------------------------------------------------------------------------
# the chaos suite (tests/test_chaos.py's), -m chaos
# ---------------------------------------------------------------------------

def _sustained_load(srv, batches, refs, span_s):
    """Serve the batches round-robin until ``span_s`` passes (at least
    one full cycle): ``(served, mismatched batches, errors)``."""
    deadline = time.monotonic() + span_s
    served, mismatches, errors = 0, [], []
    while time.monotonic() < deadline or served < len(batches):
        b = served % len(batches)
        got = srv.serve(batches[b])
        errors.extend(r for r in got if isinstance(r, QueryError))
        if _enc(got) != refs[b]:
            mismatches.append(b)
        served += 1
    return served, mismatches, errors


def _drill(db_dir, events, span_s, n_batches=4, **server_kw):
    """``events`` under sustained load on a 3-shard, 2-replica server:
    the server's final metrics and the schedule's report, after checking
    zero failures, byte parity and recovery."""
    batches, refs = _batches_and_refs(db_dir, n_batches, 25, 100)
    with ShardedQueryServer(db_dir, 3, slab_bytes=1 << 20, replicas=2,
                            mp_context=MP, **server_kw) as srv:
        with ChaosSchedule(srv, events) as sched:
            served, mismatches, errors = _sustained_load(
                srv, batches, refs, span_s)
        assert not sched._thread.is_alive()
        assert errors == [], f"{len(errors)} failed requests: {errors[:3]}"
        assert mismatches == [], f"byte divergence in batches {mismatches}"
        assert served >= len(batches)
        landed = [r for r in sched.report() if r.get("pid") is not None
                  or r.get("pids")]
        assert _wait_metric(srv, "respawns", len(landed)) >= len(landed)
        _assert_recovered(srv, batches[0])
        return srv.metrics(), sched.report()


@pytest.mark.chaos
def test_full_schedule_zero_failures_byte_parity(db_dir):
    """Kill, stall, drop, then a whole-group kill in one load window,
    with hedged reads armed."""
    m, report = _drill(db_dir, [
        ChaosEvent(at_s=0.4, kind="kill", shard=0),
        ChaosEvent(at_s=1.2, kind="stall", shard=1, duration_s=0.6),
        ChaosEvent(at_s=2.0, kind="drop", shard=2, duration_s=0.4),
        ChaosEvent(at_s=2.8, kind="kill_group", shards=(1, 2)),
    ], 4.5, n_batches=6, hedge_ms=40.0)
    assert [r["kind"] for r in report] == ["kill", "stall", "drop",
                                           "kill_group"]
    assert m["respawns"] >= 2 and m["failovers"] >= 1


@pytest.mark.chaos
def test_default_schedule_holds_the_bar(db_dir):
    events = default_schedule(3, span_s=2.0)
    _, report = _drill(db_dir, events, 3.0)
    assert len(report) == len(events)


@pytest.mark.chaos
def test_repeated_kills_same_shard(db_dir):
    """One ring position crash-looping: its replica absorbs every loss."""
    _, report = _drill(db_dir, [ChaosEvent(at_s=0.3 + 0.9 * i, kind="kill",
                                           shard=1) for i in range(3)], 3.5)
    assert any(r.get("pid") is not None for r in report), report


@pytest.mark.chaos
def test_tcp_transport_survives_schedule(db_dir):
    m, _ = _drill(db_dir, [ChaosEvent(at_s=0.4, kind="kill", shard=0),
                           ChaosEvent(at_s=1.3, kind="stall", shard=2,
                                      duration_s=0.5)],
                  3.0, transport="tcp")
    assert m["inline_payloads"] > 0 and m["slab_payloads"] == 0


@pytest.mark.chaos
def test_chaos_during_epoch_switch(db_dir):
    """Kills landing while ``reopen`` switches epochs (the same directory:
    parity is the no-mixing check)."""
    batches, refs = _batches_and_refs(db_dir, 4, 25, 100)
    with ShardedQueryServer(db_dir, 3, slab_bytes=1 << 20, replicas=2,
                            mp_context=MP) as srv:
        stop = threading.Event()
        reopens = []

        def flipper():
            while not stop.is_set():
                reopens.append(srv.reopen(db_dir))
                time.sleep(0.25)

        t = threading.Thread(target=flipper)
        t.start()
        try:
            with ChaosSchedule(srv, [ChaosEvent(at_s=0.5, kind="kill",
                                                shard=0),
                                     ChaosEvent(at_s=1.5, kind="kill",
                                                shard=2)]):
                _, mismatches, errors = _sustained_load(srv, batches, refs,
                                                        3.0)
        finally:
            stop.set()
            t.join(JOIN_S)
        assert not t.is_alive()
        assert errors == [] and mismatches == []
        assert len(reopens) >= 2
        assert srv.metrics()["reopens"] == len(reopens)
        _assert_recovered(srv, batches[0])
