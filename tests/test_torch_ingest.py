"""The port's live ingest tier on the CPU, against the reference's.

The port's :class:`repro_torch.ingest.IngestState` appends profiles in
uneven increments and publishes databases that are byte-identical to the
reference's one-shot ``repro.core.aggregate.StreamingAggregator`` on the
same profiles, under every executor (``compute="cpu"``).  With
``compute="device", device="cpu"`` (the kernels' plain versions, through
the launch funnel) the integer-valued planes are still byte-identical, and
the float planes agree with the port's own one-shot run within the
on-card smoke test's tolerance.  The snapshot store, the HTTP endpoint and
its spool behave as the reference's, and a spool either package's server
filled is recovered by the other's.
"""
import filecmp
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

from repro.core.aggregate import AggregationConfig as RefConfig
from repro.core.aggregate import StreamingAggregator as RefAggregator
from repro.ingest import IngestClient as RefIngestClient
from repro.ingest import IngestHTTPServer as RefIngestServer
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.core.pms import PMSReader
from repro_torch.ingest import (IngestClient, IngestHTTPServer, IngestState,
                                SnapshotStore, read_current, read_manifest)
from repro_torch.query import Database, EpochSwitcher
from repro_torch.serve.client import ServerOverloaded, TransportError
from repro_torch.serve.engine import QueryError, QueryRequest, QueryServer
from tests.conftest import make_profile

ROOT = Path(__file__).resolve().parents[1]
DB_FILES = ("db.pms", "db.cms", "db.trc")
INCREMENTS = ((0, 5), (5, 6), (6, 12))
ATOL, RTOL = 1e-3, 1e-4  # the on-card smoke test's float-plane tolerance


def _write_profiles(dirpath, n, *, seed=7, start=0, integer=False):
    """The reference ingest tests' workload: 40 nodes, 6 metrics;
    ``integer`` rounds every value (the exact-class planes)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        prof = make_profile(rng, n_nodes=40, n_metrics=6, density=0.3,
                            n_trace=10,
                            identity={"rank": start + i,
                                      "host": f"h{(start + i) % 3}"})
        if integer:
            prof.metrics.val[:] = np.rint(prof.metrics.val)
        path = os.path.join(str(dirpath), f"p{start + i:03d}.rprf")
        prof.save(path)
        paths.append(path)
    return paths


def _cpu_cfg(executor="serial", **kw):
    return AggregationConfig(executor=executor, compute="cpu", **kw)


def _same_files(a, b) -> dict:
    return {name: filecmp.cmp(os.path.join(str(a), name),
                              os.path.join(str(b), name), shallow=False)
            for name in DB_FILES}


def _append_increments(state, paths):
    for lo, hi in INCREMENTS:
        state.append(paths[lo:hi])


# ---------------------------------------------------------------------------
# incremental append == the reference's one-shot run, to the byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["serial", "threads", "processes"])
def test_incremental_append_matches_reference_oneshot(tmp_path, executor):
    """The reference's one-shot run is on ``threads`` for every executor
    (its databases are byte-identical across executors), so that these
    tests create no reference shared memory segments: other files' leak
    checks list the reference's ``psm_`` segments system-wide."""
    paths = _write_profiles(tmp_path, 12)
    state = IngestState(_cpu_cfg(executor, n_workers=3))
    _append_increments(state, paths)
    assert state.n_profiles == 12
    stats = state.write_database(tmp_path / "inc")
    assert stats["n_profiles"] == 12
    RefAggregator(tmp_path / "ref", RefConfig(executor="threads",
                                              n_workers=3)).run(paths)
    same = _same_files(tmp_path / "inc", tmp_path / "ref")
    assert all(same.values()), f"{executor}: {same}"


def test_plain_kernels_integer_planes_byte_equal(tmp_path):
    """``compute="device", device="cpu"``: every append's phase 2 and the
    publish's CMS go through the launch funnel on the kernels' plain
    versions; integer-valued planes are the numpy bytes."""
    paths = _write_profiles(tmp_path, 12, integer=True)
    state = IngestState(AggregationConfig(executor="threads", n_workers=3,
                                          compute="device", device="cpu"))
    _append_increments(state, paths)
    state.write_database(tmp_path / "inc")
    assert state.timings["funnel_launches"] > 0
    assert state.timings["publish_cms"] > 0
    RefAggregator(tmp_path / "ref", RefConfig(executor="threads",
                                              n_workers=3)).run(paths)
    same = _same_files(tmp_path / "inc", tmp_path / "ref")
    assert all(same.values()), same


def test_plain_kernels_float_planes_within_tolerance(tmp_path):
    paths = _write_profiles(tmp_path, 12)
    cfg = AggregationConfig(executor="threads", n_workers=3,
                            compute="device", device="cpu")
    state = IngestState(cfg)
    _append_increments(state, paths)
    state.write_database(tmp_path / "inc")
    StreamingAggregator(tmp_path / "one", cfg).run(paths)
    with PMSReader(str(tmp_path / "inc" / "db.pms")) as a, \
            PMSReader(str(tmp_path / "one" / "db.pms")) as b:
        assert a.n_profiles == b.n_profiles == 12
        for pid in range(12):
            pa, pb = a.plane(pid), b.plane(pid)
            np.testing.assert_array_equal(pa.ctx, pb.ctx)
            np.testing.assert_array_equal(pa.mid, pb.mid)
            np.testing.assert_allclose(pa.val, pb.val, atol=ATOL, rtol=RTOL)
    assert _same_files(tmp_path / "inc", tmp_path / "one")["db.trc"]


def test_append_is_all_or_nothing(tmp_path):
    paths = _write_profiles(tmp_path, 4)
    bad = os.path.join(str(tmp_path), "bad.rprf")
    with open(bad, "wb") as f:
        f.write(b"RPRF but not really a profile")
    state = IngestState(_cpu_cfg())
    state.append(paths[:2])
    n_ctx = state.n_contexts
    with pytest.raises(Exception):
        state.append([paths[2], bad])  # fails mid-batch
    assert state.n_profiles == 2 and state.n_contexts == n_ctx
    state.append(paths[2:])  # and the state is still usable
    state.write_database(tmp_path / "inc")
    RefAggregator(tmp_path / "ref", RefConfig(executor="serial")).run(paths)
    assert all(_same_files(tmp_path / "inc", tmp_path / "ref").values())


def test_ingest_state_on_a_host_without_a_card_raises(tmp_path, monkeypatch):
    """The port's default config runs on the card; without one the state
    refuses at construction instead of falling back to numpy."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        IngestState(AggregationConfig())
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        IngestHTTPServer(str(tmp_path / "live"))


@pytest.mark.parametrize("kw, match", [
    ({"executor": "ranks", "compute": "cpu"}, "ingest supports"),
    ({"pipeline": "legacy", "device": "cpu"}, "requires pipeline='fused'"),
    ({"compute": "gpu"}, "unknown compute"),
])
def test_ingest_state_refuses_configs_the_engine_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        IngestState(AggregationConfig(**kw))


# ---------------------------------------------------------------------------
# snapshot store: atomic publish, crash safety, retention + pins
# ---------------------------------------------------------------------------

def test_publish_crash_leaves_current_valid(tmp_path):
    root = str(tmp_path / "live")
    store = SnapshotStore(root)
    state = IngestState(_cpu_cfg())
    state.append(_write_profiles(tmp_path, 3))
    epoch1, dir1 = store.publish(state.write_database)
    assert read_current(root) == (epoch1, dir1)
    manifest = read_manifest(dir1)
    for name, nbytes in manifest["files"].items():
        assert os.path.getsize(os.path.join(dir1, name)) == nbytes

    class Boom(RuntimeError):
        pass

    def bad_write(stage):
        state.write_database(stage)
        raise Boom("crash between write and rename")

    with pytest.raises(Boom):
        store.publish(bad_write)
    assert read_current(root) == (epoch1, dir1)
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    with Database(dir1) as db:
        assert db.n_profiles == 3
    epoch2, dir2 = store.publish(state.write_database)
    assert epoch2 == epoch1 + 1 and read_current(root) == (epoch2, dir2)


def test_gc_keeps_current_and_pinned(tmp_path):
    root = str(tmp_path / "live")
    store = SnapshotStore(root)
    state = IngestState(_cpu_cfg())
    state.append(_write_profiles(tmp_path, 2))
    e1, d1 = store.publish(state.write_database)
    e2, d2 = store.publish(state.write_database)
    pin = store.pin(e1)
    e3, d3 = store.publish(state.write_database)
    e4, d4 = store.publish(state.write_database)
    assert sorted(store.gc(retain=1)) == [e2, e3]
    assert os.path.isdir(d1) and os.path.isdir(d4)
    assert not os.path.isdir(d2) and not os.path.isdir(d3)
    pin.release()
    store.gc(retain=1)
    assert not os.path.isdir(d1)
    assert read_current(root) == (e4, d4) and store.epochs() == [e4]


def test_epoch_pin_outlives_gc(tmp_path):
    root = str(tmp_path / "live")
    store = SnapshotStore(root)
    state = IngestState(_cpu_cfg())
    state.append(_write_profiles(tmp_path, 3))
    e1, d1 = store.publish(state.write_database)
    switcher = EpochSwitcher(root)
    assert switcher.epoch == e1
    pin = switcher.acquire()
    state.append(_write_profiles(tmp_path, 2, start=3))
    e2, _ = store.publish(state.write_database)
    store.gc(retain=1)
    assert not os.path.isdir(d1)
    assert switcher.poll() is True and switcher.epoch == e2
    res = QueryServer(pin.db).serve_one(QueryRequest(op="profile", pid=1),
                                        db=pin.db)
    assert not isinstance(res, QueryError)
    assert pin.db.n_profiles == 3 and switcher.db.n_profiles == 5
    pin.release()
    switcher.close()


# ---------------------------------------------------------------------------
# the HTTP endpoint and its spool
# ---------------------------------------------------------------------------

def test_ingest_http_error_paths(tmp_path):
    blob = open(_write_profiles(tmp_path, 1)[0], "rb").read()
    root = str(tmp_path / "live")
    with IngestHTTPServer(root, config=_cpu_cfg(), max_pending=2,
                          max_body_bytes=1 << 16) as ing:
        host, port = ing.address
        with IngestClient(host, port) as c:
            with pytest.raises(TransportError) as ei:
                c.publish()  # nothing ingested yet
            assert ei.value.status == 400
            with pytest.raises(TransportError) as ei:
                c.upload(b"not an rprf blob")
            assert ei.value.status == 400
            with pytest.raises(TransportError) as ei:
                c._roundtrip("POST", "/v1/ingest", {"profiles": []})
            assert ei.value.status == 400
            with pytest.raises(TransportError) as ei:
                c.upload(b"RPRF" + b"\0" * (1 << 16))
            assert ei.value.status == 413
            with pytest.raises(TransportError) as ei:
                c._roundtrip("GET", "/v1/nothing")
            assert ei.value.status == 404

            ing.pause()  # backpressure: fill the spool bound
            c.upload(blob)
            c.upload(blob)
            with pytest.raises(ServerOverloaded) as oi:
                c.upload(blob)
            assert oi.value.retry_after_s > 0
            timer = threading.Timer(0.2, ing.resume)
            timer.start()
            try:
                res = c.upload_with_retry([blob])
            finally:
                timer.cancel()
            assert res["accepted"] == 1

            pub = c.publish()
            assert pub["epoch"] == 1 and pub["stats"]["n_profiles"] == 3
            m = c.metrics()
            assert m["rejected_overload"] >= 1
            assert m["profiles_merged"] == 3 and m["epochs_published"] == 1
            assert c.epochs()["current"] == 1
            with Database(os.path.join(root, pub["dir"])) as db:
                assert db.n_profiles == 3
        report = ing.drain(timeout_s=5)
        assert report["drained"] is True
        with IngestClient(host, port) as c:
            with pytest.raises(TransportError) as ei:
                c.upload(blob)  # a draining endpoint sheds uploads
            assert ei.value.status == 503


def _fill_spool(server_cls, client_cls, root, blobs, cfg):
    """Upload ``blobs`` to a paused server of either package, so they stay
    in its spool, and stop it."""
    srv = server_cls(root, config=cfg)
    srv.start()
    srv.pause()
    host, port = srv.address
    with client_cls(host, port) as c:
        c.upload_many(blobs)
    srv.stop()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spool_recovered_across_packages(tmp_path, writer):
    """A spool one package's paused server filled is recovered, in order,
    by the other package's server; the epoch equals the reference's
    one-shot run over the same profiles."""
    paths = _write_profiles(tmp_path, 3)
    blobs = [open(p, "rb").read() for p in paths]
    root = str(tmp_path / "live")
    if writer == "reference":
        _fill_spool(RefIngestServer, RefIngestClient, root, blobs,
                    RefConfig(executor="serial"))
        reader, client, cfg = IngestHTTPServer, IngestClient, _cpu_cfg()
    else:
        _fill_spool(IngestHTTPServer, IngestClient, root, blobs, _cpu_cfg())
        reader, client, cfg = (RefIngestServer, RefIngestClient,
                               RefConfig(executor="serial"))
    with reader(root, config=cfg) as srv2:
        host, port = srv2.address
        with client(host, port) as c:
            pub = c.publish()
    RefAggregator(tmp_path / "ref", RefConfig(executor="serial")).run(paths)
    same = _same_files(os.path.join(root, pub["dir"]), tmp_path / "ref")
    assert all(same.values()), same


def test_spool_checksum_quarantines_corrupt_entries(tmp_path):
    """Entries whose crc no longer matches (or legacy names that are not
    RPRF) go to quarantine on restart; the survivors merge in seq order.
    The merger may start on the recovered entries before the first
    metrics call, so what holds is ``pending + profiles_merged == 3``."""
    import glob

    from repro_torch.ingest.server import (QUARANTINE_DIR, SPOOL_DIR,
                                           spool_entry_name, spool_entry_ok)
    paths = _write_profiles(tmp_path, 4)
    blobs = [open(p, "rb").read() for p in paths]
    root = str(tmp_path / "live")
    _fill_spool(IngestHTTPServer, IngestClient, root, blobs[:3], _cpu_cfg())

    spool = os.path.join(root, SPOOL_DIR)
    entries = sorted(os.listdir(spool))
    assert len(entries) == 3
    assert all(spool_entry_ok(os.path.join(spool, n), n) for n in entries)
    assert entries[1] == spool_entry_name(1, blobs[1])
    mid = os.path.join(spool, entries[1])
    data = bytearray(open(mid, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(mid, "wb").write(bytes(data))
    open(os.path.join(spool, "000000000098.rprf"), "wb").write(blobs[3])
    open(os.path.join(spool, "000000000099.rprf"), "wb").write(b"not rprf")

    with IngestHTTPServer(root, config=_cpu_cfg()) as srv2:
        host, port = srv2.address
        with IngestClient(host, port) as c:
            m = c.metrics()
            assert m["spool_quarantined"] == 2
            assert m["pending"] + m["profiles_merged"] == 3
            pub = c.publish()
    qdir = os.path.join(spool, QUARANTINE_DIR)
    assert sorted(os.listdir(qdir)) == [entries[1], "000000000099.rprf"]
    RefAggregator(tmp_path / "ref", RefConfig(executor="serial")).run(
        [paths[0], paths[2], paths[3]])
    same = _same_files(os.path.join(root, pub["dir"]), tmp_path / "ref")
    assert all(same.values()), same
    assert not glob.glob(os.path.join(spool, "*.rprf"))


def test_auto_publish_every_n_profiles(tmp_path):
    """``publish_every=2``: a snapshot publishes on its own once two new
    profiles have merged (how many merges that takes depends on how the
    merger batched the arrivals, so only the lower bound is fixed)."""
    blobs = [open(p, "rb").read() for p in _write_profiles(tmp_path, 4)]
    root = str(tmp_path / "live")
    with IngestHTTPServer(root, config=_cpu_cfg(), publish_every=2,
                          merge_batch=2) as ing:
        host, port = ing.address
        with IngestClient(host, port) as c:
            c.upload_many(blobs)
            deadline = time.monotonic() + 20
            while c.metrics()["profiles_merged"] < 4:
                assert time.monotonic() < deadline, "spool never merged"
                time.sleep(0.02)
            m = c.metrics()
            assert m["epochs_published"] >= 1, m["last_merge_error"]
            first = read_current(root)
            with Database(first[1]) as db:
                assert db.n_profiles >= 2
            pub = c.publish()
            assert pub["epoch"] == c.metrics()["epochs_published"]
    with Database(os.path.join(root, pub["dir"])) as db:
        assert db.n_profiles == 4


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _serve_cli(*argv, env_extra=None, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
        **kw)


def test_serve_ingest_cli_without_a_card_exits_nonzero(tmp_path):
    proc = _serve_cli("ingest", str(tmp_path / "live"), "--port", "0",
                      "--device", "cuda",
                      env_extra={"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert out == b""  # no ready line
    assert b"needs an NVIDIA card" in err


def test_serve_without_a_mode_names_what_is_missing():
    """With no mode word the launcher generates, on the card by default:
    a host without one exits non-zero, naming the missing card (no
    fallback to the CPU)."""
    proc = _serve_cli("--arch", "qwen3-0.6b",
                      env_extra={"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and out == b""
    assert b"needs an NVIDIA card" in err and b"--device cpu" in err


def test_serve_ingest_cli_round_trip_and_sigterm_drain(tmp_path):
    """The port's ingest CLI on the kernels' plain versions: ready line,
    uploads over HTTP, a publish byte-equal to the reference's one-shot
    run on integer profiles, then SIGTERM drains and exits 0."""
    paths = _write_profiles(tmp_path, 4, integer=True)
    root = str(tmp_path / "live")
    proc = _serve_cli("ingest", root, "--port", "0", "--device", "cpu",
                      "--executor", "serial", "--drain-timeout-s", "5")
    try:
        info = json.loads(proc.stdout.readline())
        assert info["root"] == root and info["epoch"] is None
        host, port = info["url"].removeprefix("http://").split(":")
        with IngestClient(host, int(port)) as c:
            c.upload_many([open(p, "rb").read() for p in paths])
            pub = c.publish()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    except BaseException:
        proc.kill()
        raise
    assert proc.returncode == 0, err.decode()
    drains = [json.loads(ln)["drain"] for ln in err.decode().splitlines()
              if ln.startswith("{") and "drain" in ln]
    assert drains and drains[0]["drained"] is True
    RefAggregator(tmp_path / "ref", RefConfig(executor="serial")).run(paths)
    same = _same_files(os.path.join(root, pub["dir"]), tmp_path / "ref")
    assert all(same.values()), same
