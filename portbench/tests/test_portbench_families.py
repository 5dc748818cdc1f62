"""A model family is found by its name: its reference module, its step's
count and its probes, so that a new family arrives as new files only.
A toy family stands in for the next one, with no card."""
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, roofline  # noqa: E402
from portbench.metrics import (attn_roofline, moe_roofline,  # noqa: E402
                               scan_roofline, train_mfu)
from portbench.reference.train import family  # noqa: E402

TOY = "toy_family"


def _toy(monkeypatch, **attrs) -> types.ModuleType:
    """A reference module of the toy family, as if it were
    ``portbench/reference/toy_family.py``."""
    mod = types.ModuleType(f"portbench.reference.{TOY}")
    for name, value in attrs.items():
        setattr(mod, name, value)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _record(run: dict) -> dict:
    return {"run": run, "workload": {"batch": 2, "seq": 8}, "steps": 3,
            "window_s": 1.5}


def test_a_new_family_is_its_module_and_its_count(monkeypatch):
    seen = []

    def step_flops(run, B, S):
        seen.append((run["family"], B, S))
        return 1e12
    mod = _toy(monkeypatch, step_flops=step_flops)
    run = {"family": TOY}
    assert family(run) is mod
    assert roofline.step_flops(run, 2, 8) == 1e12
    assert train_mfu.read(_record(run)) == 1e12 * 3 / (1.5 * roofline.PEAK_BF16) * 100
    assert seen == [(TOY, 2, 8)] * 2


def test_a_family_without_a_count_leaves_train_mfu_out(monkeypatch):
    _toy(monkeypatch)
    run = {"family": TOY}
    assert roofline.step_flops(run, 2, 8) is None
    assert train_mfu.read(_record(run)) is None


def test_an_unknown_family_names_the_file_it_looked_for():
    with pytest.raises(SystemExit, match=r"portbench/reference/no_such_family\.py"):
        family({"family": "no_such_family"})


@pytest.mark.parametrize("metric", [moe_roofline, scan_roofline, attn_roofline],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_each_probe_stays_out_of_another_family(metric):
    """A toy family with experts and a state: each probe written for one
    family returns None, touching neither the model nor the card."""
    cfg = types.SimpleNamespace(family=TOY, n_experts=8, top_k=2, ssm_state=16,
                                d_model=64, n_heads=4, n_kv_heads=2, hd=16,
                                d_inner=128, n_ssm_heads=2, ssm_chunk=8)
    live = types.SimpleNamespace(cfg=cfg, model=None, device=None, seed=1,
                                 workload={"batch": 2, "seq": 8})
    assert metric.probe(live) is None


@pytest.mark.parametrize("cell, flops", [("qwen3moe.train-2k", 56255481643008.0),
                                         ("zamba2.train-1k", 188882192695296.0)])
def test_the_cells_step_counts_are_frozen(cell, flops):
    wl = harness.load_json("workloads", cell)
    run = harness.load_json("configs", wl["config"])["run"]
    assert roofline.step_flops(run, wl["batch"], wl["seq"]) == flops
