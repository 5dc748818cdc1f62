"""The port's diagnosis tier and observability substrate on the CPU,
against the reference's.

Fleets of structurally identical profiles are aggregated by the port
(``compute="cpu"``, and ``compute="device", device="cpu"`` for the target
runs), then diagnosed by both packages: trace-derived findings,
noise-banded regressions against a ``BaselineFleet``, the findings table,
the ``analyze diagnose`` CLI (stdout byte-equal, JSON and ``--markdown``)
and a ``RegressionWatch`` over epochs published by the port's
``SnapshotStore``.  The port's ``obs`` copy is held to the reference's
registry, histogram, counter-group and flight-recorder behaviour."""
import dataclasses
import importlib.util
import os
import time
from pathlib import Path

import numpy as np
import pytest

from repro import diagnose as rdiag
from repro import obs as robs
from repro.analysis import report as rreport
from repro.launch import analyze as ranalyze
from repro.query import Database as RDatabase
from repro_torch import diagnose as pdiag
from repro_torch import obs as pobs
from repro_torch.analysis import report as preport
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.ingest import SnapshotStore
from repro_torch.launch import analyze as panalyze
from repro_torch.query import Database as PDatabase
from tests.conftest import make_profile

N_RANKS = 8
STRUCT_SEED = 1234  # same tree in every rank: contexts align fleet-wide
BUILDS = {"cpu": {"compute": "cpu"},
          "device": {"compute": "device", "device": "cpu"}}

_spec = importlib.util.spec_from_file_location(
    "check_prom", Path(__file__).resolve().parents[1] / "tools"
    / "check_prom.py")
check_prom = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_prom)


def _profiles(*, scale=1.0, skew=False):
    """One fleet.  ``scale`` multiplies the metric values of the context
    with the most metric-0 mass on every rank (the synthetic slowdown);
    ``skew`` gives rank 0 12x its values and 150 more trace samples (the
    synthetic imbalance and straggler)."""
    profs = [make_profile(np.random.default_rng(STRUCT_SEED), n_nodes=40,
                          n_metrics=4, density=0.6, n_trace=30,
                          identity={"rank": i}) for i in range(N_RANKS)]
    sm = profs[0].metrics
    mass = [float(sm.val[sm.start[j]:sm.start[j + 1]][
        sm.mid[sm.start[j]:sm.start[j + 1]] == 0].sum())
        for j in range(len(sm.ctx))]
    j = int(np.argmax(mass))
    for prof in profs:
        prof.metrics.val[prof.metrics.start[j]:prof.metrics.start[j + 1]] \
            *= scale
    if skew:
        profs[0].metrics.val *= 12.0
        t = np.sort(np.concatenate([profs[0].trace.time,
                                    np.linspace(0.01, 0.99, 150)]))
        c = np.resize(profs[0].trace.ctx, t.size).astype(np.uint32)
        profs[0].trace = type(profs[0].trace)(t, c)
    return profs


def _save(d, profs):
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, prof in enumerate(profs):
        p = d / f"p{i:03d}.rprf"
        prof.save(p)
        paths.append(str(p))
    return paths


def _build(out, profs, compute="cpu", **kw):
    paths = _save(Path(str(out) + "_in"), profs)
    StreamingAggregator(out, AggregationConfig(
        executor="serial", compute=compute, **kw)).run(paths)
    return str(out)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Baselines (three equal runs, and three noisy ones scaled 1x/2x/3x)
    and the target runs, each under both builds."""
    td = tmp_path_factory.mktemp("pdiag")
    base, noisy = td / "base", td / "noisy"
    for j in range(3):
        _build(base / f"run{j}", _profiles())
        _build(noisy / f"run{j}", _profiles(scale=1.0 + j))
    out = {"base": str(base), "noisy": str(noisy)}
    for name, kw in BUILDS.items():
        out[name] = {
            "slow": _build(td / name / "slow", _profiles(scale=2.0), **kw),
            "slower": _build(td / name / "slower", _profiles(scale=3.5),
                             **kw),
            "control": _build(td / name / "control", _profiles(), **kw),
            "skewed": _build(td / name / "skewed", _profiles(skew=True),
                             **kw)}
    return out


def _dicts(findings):
    return [f.as_dict() for f in findings]


# ---------------------------------------------------------------------------
# analyzers and regressions, port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("analyzers", [None, ("imbalance",), ("straggler",),
                                       ("occupancy_gap",)])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_compute_findings_equal_reference(fleet, build, analyzers):
    db_dir = fleet[build]["skewed"]
    with PDatabase(db_dir) as p, RDatabase(db_dir) as r:
        got = pdiag.compute_findings(p, analyzers=analyzers, metric=0)
        want = rdiag.compute_findings(r, analyzers=analyzers, metric=0)
    assert _dicts(got) == _dicts(want)
    if analyzers is None:
        assert {"load_imbalance", "straggler"} <= {f.kind for f in got}
    assert _dicts(pdiag.sort_findings(got[::-1])) == _dicts(got)


@pytest.mark.parametrize("target,baseline,z", [
    ("slow", "base", 3.0), ("control", "base", 3.0),
    ("slower", "noisy", 3.0), ("slower", "noisy", 0.5)])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_regression_findings_equal_reference(fleet, build, target, baseline,
                                             z):
    db_dir = fleet[build][target]
    with pdiag.BaselineFleet.from_dir(fleet[baseline]) as pf, \
            rdiag.BaselineFleet.from_dir(fleet[baseline]) as rf, \
            PDatabase(db_dir) as p, RDatabase(db_dir) as r:
        assert pf.n_runs == rf.n_runs == 3
        pb = pf.bands(0, stat="sum", inclusive=False)
        rb = rf.bands(0, stat="sum", inclusive=False)
        assert {k: (v.mean, v.std, v.n) for k, v in pb.items()} == \
            {k: (v.mean, v.std, v.n) for k, v in rb.items()}
        got = pdiag.regression_findings(p, pf, 0, inclusive=False, z=z)
        want = rdiag.regression_findings(r, rf, 0, inclusive=False, z=z)
    assert _dicts(got) == _dicts(want)
    assert bool(got) == (target == "slow" or z < 1.0)
    assert preport.findings_table(got) == rreport.findings_table(want)


def test_findings_table_and_severities_equal_reference(fleet):
    with PDatabase(fleet["cpu"]["skewed"]) as p:
        found = pdiag.compute_findings(p, metric=0)
    assert found
    ref = [rdiag.Finding(**{k.name: getattr(f, k.name)
                         for k in dataclasses.fields(f)}) for f in found]
    assert preport.findings_table(found) == rreport.findings_table(ref)
    assert preport.findings_table([]) == rreport.findings_table([])
    assert pdiag.SEVERITIES == rdiag.SEVERITIES
    for s in (0.0, 0.5, 1.0, 2.0, 5.0, 50.0):
        assert pdiag.severity_for(s) == rdiag.severity_for(s)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    [], ["--markdown"], ["--baseline", "base"],
    ["--baseline", "base", "--markdown"],
    ["--baseline", "noisy", "--z", "0.5", "--analyzers", "",
     "--limit", "3"],
    ["--analyzers", "straggler", "--inclusive", "--metric", "1"]],
    ids=["json", "markdown", "baseline", "baseline_markdown",
         "regression_only", "straggler"])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_diagnose_cli_stdout_equals_reference(fleet, capsys, build, extra):
    target = "skewed" if "--baseline" not in extra else (
        "slower" if "noisy" in extra else "slow")
    argv = ["diagnose", fleet[build][target],
            *[fleet.get(a, a) if isinstance(fleet.get(a, a), str) else a
              for a in extra]]
    ranalyze.main(argv)
    want = capsys.readouterr().out
    panalyze.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert ("| severity" in got) if "--markdown" in extra \
        else '"op": "diagnose"' in got


# ---------------------------------------------------------------------------
# the regression watch over epochs the port published
# ---------------------------------------------------------------------------

def _publish(store, profs, compute):
    paths = _save(Path(store.root + f"_in{time.monotonic_ns()}"), profs)
    kw = {"device": "cpu"} if compute == "device" else {}
    return store.publish(lambda d: StreamingAggregator(d, AggregationConfig(
        executor="serial", compute=compute, **kw)).run(paths))[0]


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_regression_watch_equals_reference(tmp_path, fleet, build):
    store = SnapshotStore(tmp_path / "live")
    e1 = _publish(store, _profiles(), build)
    reports = {"p": [], "r": []}

    def target(mod):
        return mod.WatchTarget(name="t", root=store.root,
                               baseline=fleet["base"], metric=0,
                               inclusive=False, analyzers=("imbalance",))

    with pdiag.RegressionWatch(target(pdiag), poll_ms=10_000.0,
                            on_report=reports["p"].append) as pw, \
            rdiag.RegressionWatch(target(rdiag), poll_ms=10_000.0,
                               on_report=reports["r"].append) as rw:
        e2 = _publish(store, _profiles(scale=2.0), build)
        assert pw.poll_once() == rw.poll_once() == 1
        e3 = _publish(store, _profiles(), build)
        assert pw.poll_once() == rw.poll_once() == 1
        assert pw.poll_once() == rw.poll_once() == 0
        ps, rs = pw.status(), rw.status()
    assert [r.epoch for r in reports["p"]] == [e1, e2, e3]

    def strip(rep):
        d = rep.as_dict()
        del d["eval_s"]
        return d

    assert [strip(r) for r in reports["p"]] == [strip(r) for r in
                                                reports["r"]]
    assert [r.worst for r in reports["p"]] == ["none", "critical", "none"]
    assert ps["counters"] == rs["counters"]
    assert ps["counters"]["epochs"] == 3 and ps["counters"]["polls"] == 3
    assert ps["eval_latency"]["n"] == rs["eval_latency"]["n"] == 3


# ---------------------------------------------------------------------------
# the obs copy: registry, histogram, counter group, flight recorder
# ---------------------------------------------------------------------------

def _fill_registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("demo.requests").inc(3)
    reg.gauge("demo.depth", lambda: 7)
    reg.histogram("demo.latency").observe(0.002)
    fam = reg.histogram_family("demo.by_op", "op")
    fam.labels("stripe").observe(0.1)
    fam.labels("topk").observe(0.2)
    grp = reg.group("demo", {"hits": 4, "last_s": 1.5}, gauges=("last_s",))
    grp.inc("hits")
    return reg


def test_registry_renders_the_reference_prometheus_text():
    text = _fill_registry(pobs).prometheus()
    assert text == _fill_registry(robs).prometheus()
    errors, stats = check_prom.check_exposition(text)
    assert not errors, errors
    assert stats["histograms"] >= 2
    assert "repro_demo_hits_total 5" in text
    reg = pobs.MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(ValueError):
        reg.gauge("x")


def test_histogram_and_counter_group_equal_reference():
    hists = (pobs.Histogram(), robs.Histogram())
    for h in hists:
        for s in (50e-6, 100e-6, 2.5e-3, 10.0, 0.3):
            h.observe(s)
    assert hists[0].as_dict() == hists[1].as_dict()
    assert pobs.HIST_EDGES_US == robs.HIST_EDGES_US
    assert pobs.Histogram().as_dict() == robs.Histogram().as_dict()
    from repro.obs.registry import CounterGroup as RGroup
    from repro_torch.obs.registry import CounterGroup as PGroup
    groups = (PGroup({"a": 0, "b": 0}), RGroup({"a": 0, "b": 0}))
    for g in groups:
        g["a"] += 2
        g.inc("b", 3)
        g.set("c", 1.5)
    assert dict(groups[0]) == dict(groups[1]) == {"a": 2, "b": 3, "c": 1.5}


def test_flight_recorder_equals_reference():
    recs = (pobs.FlightRecorder(64), robs.FlightRecorder(64))
    for rec in recs:
        for i in range(1000):
            rec.record("decode", "stripe", float(i), 1e-4, trace_id="t",
                       attrs={"i": i})
        assert len(rec.drain_outbox()) == 64
        assert rec.dump("first") and not rec.dump("storm")
    p, r = (rec.as_dict(limit=16) for rec in recs)
    for d in (p, r):
        for dump in d["dumps"]:
            dump.pop("t")
    assert p == r
    assert (p["n"], p["capacity"], p["recorded"]) == (16, 64, 1000)
    assert recs[0].dropped_outbox == recs[1].dropped_outbox == 1000 - 64
    off = pobs.FlightRecorder(0)
    off.record("decode", "stripe", 0.0, 1.0)
    assert not off.enabled and off.snapshot() == [] and not off.dump("x")
    assert pobs.SPAN_PHASES == robs.SPAN_PHASES


def test_trace_ids_and_process_recorder_match_reference():
    tid = pobs.mint_trace_id()
    assert pobs.valid_trace_id(tid) and robs.valid_trace_id(tid)
    assert len(tid) == 16
    for v in ("client-req.42:a", "", None, 17, "a" * 65, "has space",
              'quote"'):
        assert pobs.valid_trace_id(v) == robs.valid_trace_id(v)
    before = pobs.recorder()
    try:
        rec = pobs.configure(8)
        assert pobs.recorder() is rec and rec.capacity == 8
    finally:
        pobs.configure(before.capacity)
    assert pobs.recorder().capacity == int(
        os.environ.get("REPRO_TRACE_RING", "2048") or 2048)
    t0 = pobs.monotime()
    assert robs.monotime() >= t0
