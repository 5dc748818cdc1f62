"""The port's query engine on the CPU, against the reference's.

Databases are written by the port, once with ``compute="cpu"`` and once
with ``compute="device", device="cpu"`` (the kernels' plain versions), and
each is opened with both ``repro.query.Database`` and
``repro_torch.query.Database``: every public query function gives equal
results (arrays bit-equal), the cache and plane-load counters are equal,
the snapshot store written by the port's ``ingest.snapshot`` resolves the
same way through both, and the ``analyze query`` CLI prints the same
bytes."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import query as rq
from repro.launch import analyze as ranalyze
from repro_torch import query as pq
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.ingest import snapshot as psnap
from repro_torch.launch import analyze as panalyze
from tests.conftest import make_profile

ROOT = Path(__file__).resolve().parents[1]
N_PROFILES = 8
BUILDS = {"cpu": {"compute": "cpu"},
          "device": {"compute": "device", "device": "cpu"}}


def _workload(d, seed, scale=1.0):
    """The reference query tests' workload: 8 profiles of 60 nodes."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(N_PROFILES):
        prof = make_profile(rng, n_nodes=60, n_metrics=6, density=0.3,
                            n_trace=16, identity={"rank": i, "stream": i % 2})
        if scale != 1.0:
            prof.metrics.val[:] = prof.metrics.val * scale
        p = d / f"prof{i:03d}.rprf"
        prof.save(p)
        paths.append(str(p))
    return paths


def _build(out, paths, **kw):
    StreamingAggregator(out, AggregationConfig(executor="threads",
                                               n_workers=3, **kw)).run(paths)
    return str(out)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """``{build: (db_dir, other_db_dir)}``: the workload and a second run
    (another seed, costs scaled by 1.5) for diffs, both by the port."""
    td = tmp_path_factory.mktemp("pqdb")
    for d in ("a_in", "b_in"):
        (td / d).mkdir()
    a = _workload(td / "a_in", 7)
    b = _workload(td / "b_in", 8, scale=1.5)
    return {name: (_build(td / f"{name}_a", a, **kw),
                   _build(td / f"{name}_b", b, **kw))
            for name, kw in BUILDS.items()}


def _plain(x):
    """A comparable form of a query result from either package: dataclasses
    by name and fields, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes() if x.dtype != object
                else tuple(x.ravel().tolist()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    if hasattr(x, "time") and hasattr(x, "ctx"):  # a Trace
        return ("Trace", _plain(x.time), _plain(x.ctx))
    if isinstance(x, np.generic):
        return (x.dtype.str, x.item())
    return x


# each case: the same call through either package's namespace ``q`` on
# the workload's database ``db`` and the second run's ``db_b``
CASES = {
    "topk_inclusive": lambda q, db, db_b: q.topk_hot_paths(db, 3, k=10),
    "topk_exclusive_mean": lambda q, db, db_b: q.topk_hot_paths(
        db, 3, k=7, inclusive=False, stat="mean"),
    "topk_leaves": lambda q, db, db_b: q.topk_hot_paths(
        db, 1, k=5, leaves_only=True),
    "topk_within": lambda q, db, db_b: q.topk_hot_paths(
        db, 2, k=5, within=q.select_contexts(db, path_regex="n[12]")),
    "select_contexts": lambda q, db, db_b: (
        q.select_contexts(db, path_regex="n3"), q.select_contexts(db, kind=2),
        q.select_contexts(db, name="n1"),
        q.select_contexts(db, predicate=lambda c, p: c % 3 == 0)),
    "threshold_contexts": lambda q, db, db_b: (
        q.threshold_contexts(db, 3, min_value=0.5),
        q.threshold_contexts(db, 0, min_value=0.0, stat="max",
                             inclusive=True)),
    "stripe_select": lambda q, db, db_b: q.stripe_select(
        db, 3, min_value=0.5, path_regex="n", limit=6),
    "profile_aggregate": lambda q, db, db_b: [
        q.profile_aggregate(db, pid, agg=agg, include_inclusive=inc)
        for pid in (0, 5) for agg in ("sum", "max", "min")
        for inc in (False, True)],
    "context_aggregate": lambda q, db, db_b: [
        q.context_aggregate(db, ctx, agg=agg)
        for ctx in (0, 3, db.n_contexts - 1)
        for agg in ("sum", "max", "min", "mean")],
    "diff": lambda q, db, db_b: (
        q.diff(db, db_b, 3), q.diff(db, db_b, 2, inclusive=False, top=5),
        q.diff(db, db_b, 1, stat="max", min_abs_delta=0.1)),
    "metric_stats_by_path": lambda q, db, db_b: (
        q.metric_stats_by_path(db, 3, "sum", True),
        q.metric_stats_by_path(db, 9999, "sum", False)),
    "total_delta": lambda q, db, db_b: q.total_delta(db, db_b, 4),
    "samples_in_window": lambda q, db, db_b: [
        q.samples_in_window(db, pid, 0.2, 0.7) for pid in range(3)],
    "occupancy": lambda q, db, db_b: (
        q.occupancy(db, 0.1, 0.9), q.occupancy(db, 0.0, 1.0, pids=[1, 4])),
    "activity": lambda q, db, db_b: q.activity(db, 2, 0.0, 1.0, n_bins=20),
    "database_reads": lambda q, db, db_b: (
        db.n_profiles, db.n_contexts, db.has_cms, db.has_traces,
        db.trace_lengths(), db.identity(3), db.path_of(7),
        db.stripe(11, 3), db.stripe(0, 3, inclusive=True), db.stripe(5, 3),
        [db.value(p, c, 2) for p in range(N_PROFILES) for c in (0, 9, 21)],
        db.summary(5, 3, "mean"), db.metric_entries(3),
        db.profile_metrics(2).triplets(), db.context_plane(4), db.trace(6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_query_functions_equal_reference(dbs, build, case):
    a, b = dbs[build]
    fn = CASES[case]
    with rq.Database(a) as ra, rq.Database(b) as rb, \
            pq.Database(a) as pa, pq.Database(b) as pb:
        want = fn(rq, ra, rb)
        got = fn(pq, pa, pb)
        assert _plain(got) == _plain(want)
        # the same reads through the same routing: equal counters
        assert pa.cache_stats() == ra.cache_stats()
        assert dict(pa.counters) == dict(ra.counters)


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_to_dataframe_equals_reference(dbs, build):
    pd = pytest.importorskip("pandas")
    a, _ = dbs[build]
    with rq.Database(a) as ra, pq.Database(a) as pa:
        for inc in (True, False):
            pd.testing.assert_frame_equal(
                pq.to_dataframe(pa, include_inclusive=inc),
                rq.to_dataframe(ra, include_inclusive=inc), check_exact=True)
        assert pa.cache_stats() == ra.cache_stats()


def test_public_surface_and_lru_cache_match_reference():
    assert pq.__all__ == rq.__all__
    caches = (pq.LRUCache(100), rq.LRUCache(100))
    for c in caches:
        c.put("a", 1, 40)
        c.put("b", 2, 40)
        c.get("a")
        c.put("c", 3, 40)       # evicts b, the least recently used
        c.get_or_load("d", lambda: (4, 30))
        c.get_or_load("a", lambda: (9, 1))
        c.get("b")
    (p, r) = caches
    assert p.stats() == r.stats()
    assert (len(p), p.nbytes) == (len(r), r.nbytes)
    assert [k in p for k in "abcd"] == [k in r for k in "abcd"]


def test_database_metric_registry_and_obs_equal_reference(dbs):
    a, _ = dbs["cpu"]
    with rq.Database(a) as ra, pq.Database(a) as pa:
        for m in (0, 3):
            assert pa.resolve_metric(m, inclusive=True) == \
                ra.resolve_metric(m, inclusive=True)
        pa.profile_metrics(0)
        ra.profile_metrics(0)
        assert pa.obs.prometheus() == ra.obs.prometheus()
        assert pa.obs.prometheus('db="a"') == ra.obs.prometheus('db="a"')


# ---------------------------------------------------------------------------
# snapshot roots written by the port's SnapshotStore
# ---------------------------------------------------------------------------

def _publish(store, paths):
    return store.publish(lambda d: StreamingAggregator(d, AggregationConfig(
        executor="serial", compute="cpu")).run(paths))


def test_snapshot_epochs_resolve_like_reference(tmp_path):
    from repro.ingest import snapshot as rsnap
    (tmp_path / "in").mkdir()
    paths = _workload(tmp_path / "in", 3)
    root = tmp_path / "snap"
    store = psnap.SnapshotStore(root)
    assert store.current() is None
    with pytest.raises(FileNotFoundError):
        pq.Database.open_current(root)
    with pytest.raises(FileNotFoundError):
        pq.EpochSwitcher(root)
    e1, d1 = _publish(store, paths)
    assert pq.wait_for_epoch(root, timeout_s=5) == \
        rq.wait_for_epoch(root, timeout_s=5) == e1
    sw_p, sw_r = pq.EpochSwitcher(root), rq.EpochSwitcher(root)
    try:
        e2, d2 = _publish(store, paths[:5])
        assert psnap.read_current(root) == rsnap.read_current(root) == (e2,
                                                                        d2)
        assert psnap.read_manifest(d2) == rsnap.read_manifest(d2)
        assert (sw_p.poll(), sw_r.poll()) == (True, True)
        assert (sw_p.poll(), sw_r.poll()) == (False, False)
        assert (sw_p.epoch, sw_p.transitions) == (sw_r.epoch,
                                                  sw_r.transitions) == (e2, 2)
        with pq.Database.open_current(root) as pa, \
                rq.Database.open_current(root) as ra:
            assert (pa.epoch, pa.n_profiles) == (ra.epoch, ra.n_profiles) \
                == (e2, 5)
            h = sw_p.acquire()
            assert h.db.n_profiles == pa.n_profiles
            h.release()
        with pytest.raises(TimeoutError):
            pq.wait_for_epoch(root, timeout_s=0.05, min_epoch=e2 + 1)
        e3, _ = _publish(store, paths[:2])
        with store.pin(e2):
            assert store.gc(retain=1) == [e1]  # e2 pinned, e3 current
        assert store.epochs() == [e2, e3]
        assert store.gc(retain=1) == [e2]
        with pytest.raises(psnap.SnapshotGone):
            psnap.read_manifest(str(Path(d1)))
    finally:
        sw_p.close()
        sw_r.close()


# ---------------------------------------------------------------------------
# the CLI: stdout byte-equal to the reference's
# ---------------------------------------------------------------------------

def _ops(other):
    return {
        "topk": ["topk", "--metric", "3", "-k", "8"],
        "topk_exclusive": ["topk", "--metric", "2", "-k", "4", "--exclusive",
                           "--stat", "max"],
        "select": ["select", "--metric", "3", "--path-regex", "n[0-4]",
                   "--min", "0.5"],
        "stripe": ["stripe", "--ctx", "0", "--metric", "3", "--inclusive"],
        "stripe_exclusive": ["stripe", "--ctx", "11", "--metric", "3"],
        "diff": ["diff", other, "--metric", "3", "--top", "12"],
        "window": ["window", "--t0", "0.1", "--t1", "0.8", "--top", "6"],
        "window_pid": ["window", "--pid", "2", "--t0", "0.0", "--t1", "0.6"],
    }


@pytest.mark.parametrize("op", sorted(_ops("")))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_query_cli_stdout_equals_reference(dbs, capsys, build, op):
    a, b = dbs[build]
    argv = ["query", a, *_ops(b)[op]]
    ranalyze.main(argv)
    want = capsys.readouterr().out
    panalyze.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["op"] == op.split("_")[0]


def test_query_cli_needs_no_card_and_loads_no_torch(dbs):
    """``analyze query`` reads files: it runs with no card visible, and
    imports neither jax, the reference package nor torch."""
    code = ("import json, sys\n"
            "from repro_torch.launch import analyze\n"
            f"analyze.main(['query', {dbs['device'][0]!r}, 'topk', "
            "'--metric', '3'])\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'repro', 'torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert json.loads(out.stdout.splitlines()[-1]) == []
    assert '"op": "topk"' in out.stdout
