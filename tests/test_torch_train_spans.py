"""The Trainer's own spans and allocator counters, on the CPU at the
reduced qwen3-0.6b (2 layers, width 128, f32), a few steps: every span
of ``loop.TRAIN_SPANS`` once a step, the issue spans inside their step
and unmoved by a synchronising wrapper, the allocator counters over the
whole step, nothing recorded and no allocator statistics read with the
recorder off, the Profiler's ``host.dispatch`` and
``host.checkpoint_io``, and the spans on ``torch.profiler``'s clock."""
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.metrics import MetricRegistry
from repro_torch.core.sparse import MeasurementProfile
from repro_torch.data import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.obs import clock
from repro_torch.obs import trace as obs_trace
from repro_torch.profiling import Profiler
from repro_torch.train import loop
from repro_torch.train.optimizer import AdamWConfig

ARCH = "qwen3-0.6b"


@pytest.fixture
def ring(monkeypatch):
    """A fresh process recorder for the test, the old one put back after."""
    monkeypatch.setattr(obs_trace, "_recorder", obs_trace._recorder)
    return obs.configure(4096)


def _trainer(ckpt_dir=None, profiler=True):
    cfg = reduced(get_arch(ARCH))
    tr = loop.Trainer(
        build_model(cfg), AdamWConfig(), loop.TrainerConfig(steps=3,
                                                            ckpt_every=1),
        TokenPipeline(cfg.vocab_size, 32, 4),
        ckpt=None if ckpt_dir is None else CheckpointManager(ckpt_dir),
        profiler=Profiler({"rank": 0, "stream": 0, "kind": "host"})
        if profiler else None)
    return tr, tr.init_state(torch.Generator().manual_seed(0))


def _by_step(rec):
    out = {}
    for s in rec.snapshot():
        assert s.op == "train" and s.trace_id == str(s.attrs["step"])
        out.setdefault(s.attrs["step"], []).append(s)
    return out


def test_every_span_is_recorded_once_a_step(ring, tmp_path):
    tr, opt = _trainer(tmp_path / "ckpt")
    tr.run(opt)
    steps = _by_step(ring)
    assert sorted(steps) == [0, 1, 2]
    for n, got in steps.items():
        assert sorted(s.name for s in got) == sorted(loop.TRAIN_SPANS), n
        for s in got:
            want = None if s.name == "train.step" else "train.step"
            assert s.attrs["parent"] == want and s.dur >= 0


def test_the_issue_spans_lie_inside_the_step_before_their_syncs(ring):
    tr, opt = _trainer()
    tr.run(opt)
    for n, got in _by_step(ring).items():
        s = {x.name: x for x in got}
        step = s["train.step"]
        for x in got:
            assert step.t0 <= x.t0 and x.t0 + x.dur <= step.t0 + step.dur, x
        order = ["train.data", "train.grad", "train.grad.sync",
                 "train.update", "train.update.sync", "train.readback",
                 "train.hook"]
        for a, b in zip(order, order[1:]):
            assert s[a].t0 + s[a].dur <= s[b].t0, (n, a, b)
        assert tr.history[n]["dispatch"] == pytest.approx(
            s["train.grad"].dur + s["train.update"].dur, rel=1e-12)


def test_a_synchronising_wrapper_leaves_the_grad_span_unchanged(ring):
    """The benchmark wraps ``grad_fn`` with a synchronise; the span stays
    inside the wrapped call, the wrapper's wait outside it."""
    tr, opt = _trainer()
    inner, calls = tr.grad_fn, []

    def wrapped(batch):
        a = obs.monotime()
        out = inner(batch)
        b = obs.monotime()
        time.sleep(0.05)  # the wrapper's synchronise
        calls.append((a, b))
        return out

    tr.grad_fn = wrapped
    tr.run(opt, steps=2)
    for n, (a, b) in enumerate(calls):
        (g,) = [s for s in _by_step(ring)[n] if s.name == "train.grad"]
        assert a <= g.t0 and g.t0 + g.dur <= b  # the wait comes after b


def _as_if_on_the_card(monkeypatch):
    """The Trainer's allocator reads go to ``torch.cuda``'s statistics as
    on the card (which the test replaces)."""
    real = loop._alloc_counts
    monkeypatch.setattr(loop, "_alloc_counts",
                        lambda device: real(torch.device("cuda", 0)))


def test_the_allocator_counters_are_a_steps_increase(ring, monkeypatch):
    seen = iter(range(0, 1000, 7))

    def stats(device):
        n = next(seen)
        return {"num_alloc_retries": n, "num_device_alloc": 3 * n}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    assert loop._alloc_counts(torch.device("cuda", 0)) == (0, 0)
    assert loop._alloc_counts(torch.device("cpu")) is None
    _as_if_on_the_card(monkeypatch)
    tr, opt = _trainer()
    tr.run(opt, steps=2)
    for got in _by_step(ring).values():
        (step,) = [s for s in got if s.name == "train.step"]
        assert step.attrs["num_alloc_retries"] == 7
        assert step.attrs["num_device_alloc"] == 21


def test_a_missing_allocator_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device: {"num_alloc_retries": 0})
    with pytest.raises(KeyError):
        loop._alloc_counts(torch.device("cuda", 0))


def test_the_counters_cover_the_whole_step_and_no_phase(ring, monkeypatch,
                                                        tmp_path):
    """One read at each step's end (and one as the run begins): what the
    checkpoint and the hook allocate is counted, and no read lies inside
    a phase's span."""
    count, reads = [0], []

    def stats(device):
        reads.append(obs.monotime())
        return {"num_alloc_retries": 0, "num_device_alloc": count[0]}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    _as_if_on_the_card(monkeypatch)
    tr, opt = _trainer(tmp_path / "ckpt")
    on_step, save = tr.profiler.on_step, tr.ckpt.save

    def hook(rec):
        count[0] += 1
        on_step(rec)

    def saving(*a, **kw):
        count[0] += 10
        return save(*a, **kw)

    tr.profiler.on_step, tr.ckpt.save = hook, saving
    tr.run(opt)
    assert len(reads) == 1 + 3
    for n, got in _by_step(ring).items():
        (step,) = [s for s in got if s.name == "train.step"]
        assert step.attrs["num_device_alloc"] == 11, n
        for s in got:
            if s is not step:
                assert not any(s.t0 <= r <= s.t0 + s.dur for r in reads), s


def test_a_disabled_recorder_records_nothing_and_reads_no_stats(ring,
                                                               monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device: calls.append(device) or {
                            "num_alloc_retries": 0, "num_device_alloc": 0})
    _as_if_on_the_card(monkeypatch)
    off = obs.configure(0)
    tr, opt = _trainer()
    tr.run(opt, steps=2)
    assert off.snapshot() == [] and off.recorded == 0 and calls == []
    assert len(tr.history) == 2 and tr.history[1]["dispatch"] > 0
    on = obs.configure(64)
    tr.run(opt, start_step=2, steps=1)
    assert on.recorded == len(loop.TRAIN_SPANS) - 1 and len(calls) == 2


def _host_metrics(path) -> dict:
    prof = MeasurementProfile.load(str(path))
    reg = MetricRegistry.from_json(prof.environment["registry"])
    ctx, mid, val = prof.metrics.triplets()
    return prof, {(prof.tree.name_of(c), reg.name_of(m)): v
                  for c, m, v in zip(ctx.tolist(), mid.tolist(), val.tolist())}


def test_dispatch_and_checkpoint_io_land_on_their_contexts(ring, tmp_path):
    tr, opt = _trainer(tmp_path / "ckpt")
    tr.run(opt)
    tr.profiler.finish(tmp_path / "w.rprf")
    _, got = _host_metrics(tmp_path / "w.rprf")
    h = tr.history
    assert got[("dispatch", "host.dispatch")] == pytest.approx(
        sum(r["dispatch"] for r in h), rel=1e-12)
    assert got[("checkpoint", "host.checkpoint_io")] == pytest.approx(
        sum(r["checkpoint"] for r in h), rel=1e-12)
    assert all(r["checkpoint"] > 0 for r in h)
    ckpt = [s for s in ring.snapshot() if s.name == "train.checkpoint"]
    assert [s.dur for s in ckpt] == [r["checkpoint"] for r in h]


def test_the_profile_has_a_sample_a_step_and_the_exact_step_time(ring,
                                                                 tmp_path):
    tr, opt = _trainer()
    tr.run(opt)
    tr.run(opt, start_step=3, steps=2)
    tr.profiler.finish(tmp_path / "w.rprf")
    prof, got = _host_metrics(tmp_path / "w.rprf")
    assert len(prof.trace.time) == len(tr.history) == 5
    assert got[("train", "host.step_time")] == sum(
        r["step_time"] for r in tr.history)
    c = prof.environment["clock"]
    assert c["trace_anchor_ns"] == clock.TRACE_ANCHOR_NS
    # each sample is taken in its step's hook, inside the step's span
    steps = sorted((s for s in ring.snapshot() if s.name == "train.step"),
                   key=lambda s: s.attrs["step"])
    for s, t in zip(steps, prof.trace.time.tolist()):
        assert s.t0 <= c["t0"] + t <= s.t0 + s.dur


def test_to_trace_ns_puts_the_step_on_the_profilers_clock(ring):
    from torch.profiler import ProfilerActivity, profile, record_function
    tr, opt = _trainer(profiler=False)
    tr.run(opt, steps=1)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # a profile's first range enters late
            pass
        with record_function("around.run"):
            tr.run(opt, start_step=1, steps=1)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "around.run"]
    (step,) = [s for s in ring.snapshot()
               if s.name == "train.step" and s.attrs["step"] == 1]
    assert abs(clock.to_trace_ns(step.t0) - ev.start_ns()) < 1_000_000
    assert ev.start_ns() <= clock.to_trace_ns(step.t0 + step.dur) \
        <= ev.end_ns() + 1_000_000
