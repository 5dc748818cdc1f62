"""The readers of the Trainer's own spans (``portbench/spans.py`` and the
metrics on it): on synthetic records, the window's steps only, None
without spans or with part of the window gone from the recorder; and the
probe's snapshot of a reduced Trainer's spans on the CPU."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import spans as bench_spans  # noqa: E402
from portbench.metrics import (alloc_retries, device_mallocs,  # noqa: E402
                               grad_issue_ms, update_issue_ms)
from portbench.traffic.train import FOLLOWED  # noqa: E402

READERS = (grad_issue_ms, update_issue_ms, alloc_retries, device_mallocs)


def _step_spans(n, t0, grad=0.010, update=0.002, attrs=None):
    """The spans of step ``n`` from ``t0``, as ``spans.snapshot`` gives
    them: data 1 ms, grad, update, readback and hook 0.5 ms each."""
    out, t = [], t0
    for name, dur in (("train.data", 0.001), ("train.grad", grad),
                      ("train.grad.sync", 0.1), ("train.update", update),
                      ("train.update.sync", 0.02), ("train.readback", 0.0005),
                      ("train.hook", 0.0005)):
        out.append({"name": name, "step": n, "t0": t, "dur": dur,
                    "attrs": {"step": n, "parent": "train.step"}})
        t += dur
    out.append({"name": "train.step", "step": n, "t0": t0, "dur": t - t0,
                "attrs": {"step": n, "parent": None, **(attrs or {})}})
    return out


def _record(snap, steps):
    return {"steps": steps,
            "probes": {m.__name__.rsplit(".", 1)[1]: snap for m in READERS}}


def test_the_readers_keep_the_window_steps_only():
    snap = []
    # an earlier Trainer's step of the same number, then set-up, the
    # window of 2 steps and a traced step after it
    snap += _step_spans(FOLLOWED, 0.0, grad=9.0, attrs={
        "num_alloc_retries": 50, "num_device_alloc": 50})
    for n in range(FOLLOWED + 3):
        snap += _step_spans(n, 100.0 + n, grad=0.010 * (n + 1),
                            attrs={"num_alloc_retries": n,
                                   "num_device_alloc": 2 * n})
    rec = _record(snap, 2)
    a, b = FOLLOWED, FOLLOWED + 1
    assert grad_issue_ms.read(rec) == pytest.approx(
        (0.010 * (a + 1) + 0.010 * (b + 1)) / 2 * 1e3)
    assert update_issue_ms.read(rec) == pytest.approx(2.0)
    assert alloc_retries.read(rec) == pytest.approx((a + b) / 2)
    assert device_mallocs.read(rec) == pytest.approx(a + b)


def test_the_readers_read_none_without_spans():
    for m in READERS:
        assert m.read(_record(None, 3)) is None
        assert m.read(_record(_step_spans(0, 0.0), 3)) is None
    # steps with no counters (off the card): the counters read None
    rec = _record(_step_spans(FOLLOWED, 0.0), 1)
    assert alloc_retries.read(rec) is None and device_mallocs.read(rec) is None
    assert grad_issue_ms.read(rec) == pytest.approx(10.0)


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_a_window_the_ring_no_longer_holds_whole_reads_none(lost):
    """The recorder is a ring: a window step it has dropped takes the
    whole window's reading with it."""
    attrs = {"num_alloc_retries": 0, "num_device_alloc": 0}
    snap = [s for n in range(FOLLOWED, FOLLOWED + 3)
            for s in _step_spans(n, float(n), attrs=attrs)]
    assert all(m.read(_record(snap, 3)) is not None for m in READERS)
    gone = [s for s in snap if not (s["name"] == "train.step"
                                    and s["step"] == FOLLOWED + lost)]
    assert all(m.read(_record(gone, 3)) is None for m in READERS)


def test_the_probe_snapshots_the_trainers_spans(monkeypatch):
    from repro_torch import obs
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamWConfig

    monkeypatch.setattr(obs_trace, "_recorder", obs_trace._recorder)
    ring = obs.configure(4096)
    assert bench_spans.snapshot(None) is None
    ring.record("dispatch", "stripe", 0.0, 0.1)
    assert bench_spans.snapshot(None) is None
    cfg = reduced(get_arch("qwen3-0.6b"))
    tr = loop.Trainer(build_model(cfg), AdamWConfig(),
                      loop.TrainerConfig(steps=1),
                      TokenPipeline(cfg.vocab_size, 32, 4))
    opt = tr.init_state(torch.Generator().manual_seed(0))
    tr.run(opt, steps=FOLLOWED + 1)
    snap = bench_spans.snapshot(None)
    # no checkpoint, no hook: those two spans are not recorded
    assert len(snap) == (FOLLOWED + 1) * (len(loop.TRAIN_SPANS) - 2)
    rec = _record(snap, 1)
    want = [s.dur for s in ring.snapshot() if s.name == "train.grad"
            and s.attrs["step"] == FOLLOWED]
    assert grad_issue_ms.read(rec) == pytest.approx(want[0] * 1e3)
