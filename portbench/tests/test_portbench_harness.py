"""The harness: cells, configurations, traffic kinds and metrics found by
file name; a run without a card exits non-zero and prints no result; the
import boundary."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_config_traffic_and_metric_is_found_by_name():
    metrics = harness.metric_modules()
    for cell in BENCH["workloads"]:
        wl = harness.load_json("workloads", cell["name"])
        assert wl["config"] == cell["config"] and wl["traffic"] == cell["traffic"]
        assert wl["chips"] == cell["chips"]
        cfg = harness.load_json("configs", wl["config"])
        assert cfg["run"]["name"] == wl["config"]
        assert (ROOT / "portbench" / "traffic" / f"{wl['traffic']}.py").is_file()
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for m in BENCH["per_layer"]:
        assert m["name"] in metrics and metrics[m["name"]].UNIT == m["unit"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_json("workloads", "no-such-cell")


def _run(*args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    cell = BENCH["workloads"][0]["name"]
    p = _run("--workload", cell, "--seed", "2147483659", "--seconds", "1",
             "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no run on the CPU" in p.stderr


_PROBE = """
import json, sys
sys.path[:1] = [{root!r}, {src!r}]
import {modules}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(*modules):
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                         modules=", ".join(modules))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = _loaded("portbench.harness", "portbench.traffic.train",
                  "portbench.calibrate", "repro_torch.models.api",
                  "repro_torch.models.moe", "repro_torch.models.ssm",
                  "repro_torch.train.loop", "repro_torch.profiling",
                  *(f"portbench.metrics.{m}" for m in harness.metric_modules()))
    assert not top & set(harness.FOREIGN)
    assert "repro_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    refs = pkgutil.iter_modules([str(ROOT / "portbench" / "reference")])
    top = _loaded(*(f"portbench.reference.{m.name}" for m in refs),
                  "portbench.judge", "portbench.profile_file", "portbench.roofline")
    assert not top & {"repro_torch", *harness.FOREIGN}


def test_the_sources_under_reference_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in {"repro_torch", *harness.FOREIGN}, \
                    f"{path.name}: {line}"
