"""The whole slice on the CPU: the port's StreamingAggregator and CLI
against the reference's compute="cpu" run (bytes on exact-class data,
tolerance on f32-class data), the port's bit-determinism across executors
and worker counts, the on-disk formats in both directions, the config
errors, and the import boundary."""
import contextlib
import hashlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.aggregate import AggregationConfig as RConfig
from repro.core.aggregate import StreamingAggregator as RAggregator
from repro.core.pms import PMSReader as RPMSReader
from repro.query import Database
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.core.pms import PMSReader
from repro_torch.core.sparse import MeasurementProfile
from repro_torch.data import synth
from repro_torch.launch import analyze

ROOT = Path(__file__).resolve().parents[1]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _digests(res):
    return tuple(_digest(p) for p in (res.pms_path, res.cms_path,
                                      res.trace_path))


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    """SMOKE-shaped profiles (10 profiles, 8 host + 40 device metrics), one
    float-valued and one integer-valued, with the combine threshold within
    reach of their planes."""
    d = tmp_path_factory.mktemp("wl")
    fpaths, _, _ = synth.generate(synth.SMOKE, str(d / "float"), seed=1)
    ipaths, _, _ = synth.generate(synth.SMOKE, str(d / "int"), seed=2,
                                  integer_values=True)
    ref = {}
    for name, paths in (("float", fpaths), ("int", ipaths)):
        ref[name] = RAggregator(d / f"ref_{name}", RConfig(
            executor="serial", compute="cpu")).run(paths)
    return {"float": fpaths, "int": ipaths, "ref": ref}


def _port(tmp_path, paths, name, **kw):
    kw.setdefault("device", "cpu")
    return StreamingAggregator(tmp_path / name,
                               AggregationConfig(**kw)).run(paths)


@pytest.mark.parametrize("executor,workers,compute", [
    ("serial", 1, "device"), ("threads", 4, "device"), ("threads", 2, "cpu"),
])
def test_exact_workload_bytes_equal_reference(tmp_path, workloads, executor,
                                              workers, compute):
    """Integer values: db.pms, db.cms and db.trc byte-identical to the
    reference's numpy run, on the funnel and on the port's numpy path."""
    res = _port(tmp_path, workloads["int"], "db", executor=executor,
                n_workers=workers, compute=compute)
    assert _digests(res) == _digests(workloads["ref"]["int"])
    assert res.n_contexts == workloads["ref"]["int"].n_contexts


def test_exact_workload_runs_segstats_combine(tmp_path, workloads,
                                              monkeypatch):
    """With the combine threshold lowered, every plane's combine goes
    through segstats, and the bytes still match the reference."""
    from repro_torch.kernels import batch
    monkeypatch.setitem(batch.DeviceAggregator.__init__.__kwdefaults__,
                        "combine_min", 1)
    calls = []
    real = batch._ss.segstats
    monkeypatch.setattr(batch._ss, "segstats",
                        lambda *a: calls.append(1) or real(*a))
    res = _port(tmp_path, workloads["int"], "db", executor="threads",
                n_workers=3)
    assert len(calls) == len(workloads["int"])
    assert _digests(res) == _digests(workloads["ref"]["int"])


def test_float_workload_within_tolerance_of_reference(tmp_path, workloads):
    """f32-class data: every plane agrees with the reference's numpy plane
    within atol=1e-3, rtol=1e-4; traces are byte-identical."""
    res = _port(tmp_path, workloads["float"], "db", executor="threads",
                n_workers=2)
    ref = workloads["ref"]["float"]
    assert _digest(res.trace_path) == _digest(ref.trace_path)
    with PMSReader(res.pms_path) as a, RPMSReader(ref.pms_path) as b:
        assert a.n_profiles == b.n_profiles == len(workloads["float"])
        for pid in range(a.n_profiles):
            ra, ma, va = a.plane(pid).triplets()
            rb, mb, vb = b.plane(pid).triplets()
            ka = (ra.astype(np.int64) << 16) | ma
            kb = (rb.astype(np.int64) << 16) | mb
            _, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                       return_indices=True)
            np.testing.assert_allclose(va[ia], vb[ib], rtol=1e-4, atol=1e-3)
            lone = np.concatenate([np.delete(va, ia), np.delete(vb, ib)])
            assert np.all(np.abs(lone) < 1e-3)


@pytest.mark.parametrize("name", ["float", "int"])
def test_port_bit_deterministic_across_executors_and_workers(tmp_path,
                                                             workloads, name):
    """serial, threads at 1, 2 and 4 workers and processes at 2 and 4: one
    set of database bytes, f32-class data included."""
    digests = {_digests(_port(tmp_path, workloads[name], f"{ex}{w}",
                              executor=ex, n_workers=w))
               for ex, w in [("serial", 1), ("threads", 1), ("threads", 2),
                             ("threads", 4), ("processes", 2),
                             ("processes", 4)]}
    assert len(digests) == 1


def test_cli_matches_reference_and_reports_launches(tmp_path, workloads):
    out = tmp_path / "cli"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze.main([*workloads["int"], "--out", str(out), "--device", "cpu",
                      "--executor", "serial"])
    summary = json.loads(buf.getvalue())
    assert summary["compute"] == "device" and summary["device"] == "cpu"
    assert summary["profiles"] == len(workloads["int"])
    # plain versions on the CPU launch no kernel
    assert set(summary["timings"]["device_launches"].values()) <= {0}
    assert summary["timings"]["funnel_launches"] > 0
    ref = workloads["ref"]["int"]
    assert (_digest(summary["pms"]), _digest(summary["cms"]),
            _digest(summary["traces"])) == _digests(ref)


def test_cli_defaults_to_the_card(monkeypatch, workloads, tmp_path):
    """The CLI's defaults are --compute device --device cuda: on a host
    without a card that raises, naming the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        analyze.main([*workloads["int"], "--out", str(tmp_path / "x")])


def test_config_defaults_and_missing_card(monkeypatch, tmp_path):
    cfg = AggregationConfig()
    assert (cfg.compute, cfg.device, cfg.executor) == ("device", "cuda",
                                                       "threads")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        StreamingAggregator(tmp_path / "x", cfg).run([])


@pytest.mark.parametrize("kw,match", [
    ({"executor": "ranks", "compute": "device"},
     "not supported under the ranks driver"),
    ({"executor": "gpu-rdma"}, "unknown executor"),
    ({"pipeline": "legacy"}, "not ported"),
    ({"compute": "quantum"}, "compute"),
    ({"stats_merge": "eventually"}, "stats_merge"),
])
def test_unported_and_unknown_options_raise(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        _port(tmp_path, [], "x", **kw)


def test_rprf_written_by_port_is_byte_equal_to_reference(tmp_path):
    """The port's generator and profile writer give the reference's bytes:
    the same seed through benchmarks/workloads.py writes the same files."""
    from benchmarks.workloads import generate as rgenerate
    ppaths, pn, pm = synth.generate(synth.SMOKE, str(tmp_path / "p"), seed=3)
    rpaths, rn, rm = rgenerate(synth.SMOKE, str(tmp_path / "r"), seed=3)
    assert (pn, pm) == (rn, rm)
    assert [_digest(p) for p in ppaths] == [_digest(p) for p in rpaths]
    prof = MeasurementProfile.load(rpaths[0])  # the port reads repro's file
    again = tmp_path / "again.rprf"
    prof.save(again)
    assert _digest(again) == _digest(rpaths[0])


def test_reference_database_opens_port_output(tmp_path, workloads):
    """repro.query.Database reads the port's db.pms/db.cms/db.trc and
    answers like it does on the reference's database."""
    res = _port(tmp_path, workloads["int"], "db", executor="threads",
                n_workers=2)
    ref = workloads["ref"]["int"]
    with Database(Path(res.pms_path).parent) as a, \
            Database(Path(ref.pms_path).parent) as b:
        assert a.n_profiles == b.n_profiles
        for ctx in (0, 1, res.n_contexts // 2, res.n_contexts - 1):
            for mid in (0, 9, 40):
                pa, va = a.stripe(ctx, mid)
                pb, vb = b.stripe(ctx, mid)
                np.testing.assert_array_equal(pa, pb)
                np.testing.assert_array_equal(va, vb)


def test_import_loads_neither_jax_nor_repro():
    code = ("import json, sys\n"
            "import repro_torch.launch.analyze, repro_torch.launch.train\n"
            "import repro_torch.data.synth, repro_torch.kernels.batch\n"
            "import repro_torch.train.compression\n"
            "import repro_torch.core.reduction, repro_torch.runtime\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.')))\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, cwd=ROOT)
    assert json.loads(out.stdout) == []


_FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\bfrom repro\b"
                        r"|\bimport repro\b")


def test_no_source_file_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    for f in [*files, ROOT / "chip_smoke.py"]:
        hits = [ln for ln in f.read_text().splitlines()
                if _FORBIDDEN.search(ln)]
        assert not hits, (f, hits)
