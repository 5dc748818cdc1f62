"""The check that decides ``correct``: a whole run of each cell, on the
CPU at a tiny size (the card's look skipped), comes out correct when
sound and not correct with its timed path broken underneath; on the card,
the control and the faults at the cell's own size."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, inputs, judge  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
from portbench.traffic import train  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


def tiny_ctx(cell: str, seed: int, trace: bool = False) -> harness.Context:
    wl = harness.load_json("workloads", cell)
    wl.update(batch=4, seq=32, trace_steps=1)
    cfg = harness.load_json("configs", wl["config"])
    cfg["run"].update(cfg["tiny"])
    return harness.Context(wl, cfg, seed, 0.3, trace, "cpu", time.perf_counter(),
                           harness.metric_modules())


def _unchanged(model, opt_state, loss, grads, opt_cfg):
    """A step that returns its state unchanged."""
    return {"loss": loss, "grad_norm": torch.zeros(())}


def _half_batch(tr):
    """Half of the batch left out, the mean taken over the rest."""
    grad_fn = tr.grad_fn
    tr.grad_fn = lambda batch: grad_fn(
        {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    out = train.run(tiny_ctx(cell, 2**31 + 11, trace))
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    if trace:
        assert "grad_ms" in out["metrics"] and "update_ms" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    import repro_torch.train.loop as loop
    ctx = tiny_ctx(cell, 2**31 + 12)
    if fault == "unchanged":
        monkeypatch.setattr(loop, "apply_update", _unchanged)
        out = train.run(ctx)
    else:
        out = train.run(ctx, fault=_half_batch)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_profile_that_misses_steps_is_not_correct(cell, monkeypatch):
    from repro_torch.profiling import Profiler
    real = Profiler.on_step
    calls = []

    def every_other(self, rec):
        calls.append(1)
        if len(calls) % 2:
            real(self, rec)
    monkeypatch.setattr(Profiler, "on_step", every_other)
    out = train.run(tiny_ctx(cell, 2**31 + 13))
    assert not out["correct"]
    assert out["compared"]["profile_steps_gap"]["value"] > 0



@pytest.mark.parametrize("times", [[0.1] * 10, [2.2] * 7 + [1e-14] * 3 + [2.2] * 14],
                         ids=["tenths", "mixed_scale"])
def test_the_profile_time_gap_is_exact_for_the_profilers_sum(times, tmp_path):
    """The Profiler adds step times one after another; ``sum()`` is
    compensated and differs from that on these times, which a sound run
    can meet.  The check's own sum has to be the Profiler's."""
    from portbench import profile_file
    from repro_torch.profiling import Profiler
    seq = 0.0
    for t in times:
        seq += t
    assert sum(times) != seq
    prof = Profiler({"rank": 0})
    for t in times:
        prof.on_step({"step_time": t})
    prof.finish(tmp_path / "worker0.rprf")
    profile = profile_file.read(tmp_path / "worker0.rprf")
    assert judge.profile_gaps(profile, len(times), times) == {
        "profile_steps_gap": 0, "profile_time_gap": 0.0}
    assert judge.profile_gaps(profile, len(times), times + [0.1])[
        "profile_time_gap"] > 0


def _readings(cell: str, seed: int, device, **kw) -> tuple[dict, dict]:
    wl = harness.load_json("workloads", cell)
    run = harness.load_json("configs", wl["config"])["run"]
    feed = inputs.TokenBatches(run["vocab_size"], wl["batch"], wl["seq"], seed)
    ref = ref_train.follow(run, seed, feed.batch_at, train.HP, train.FOLLOWED, device)
    low = ref_train.follow(run, seed, feed.batch_at, train.HP, train.FOLLOWED, device, **kw)
    return wl, judge.gaps(low, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("case", ["control_float8", "fault_half_batch"])
def test_the_control_and_the_faults_fail_at_the_cells_size(cell, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    kw = ({"precision": "float8"} if case == "control_float8"
          else {"rows": harness.load_json("workloads", cell)["batch"] // 2})
    wl, gaps = _readings(cell, 2**31 + 21, torch.device("cuda"), **kw)
    limits = {k: v for k, v in wl["limits"].items() if k in judge.TRAINING}
    correct, compared = judge.verdict({k: gaps[k] for k in limits}, limits)
    assert not correct, compared
