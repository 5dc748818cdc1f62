"""The port's out-of-process executors on the CPU: the ``processes``
backend with the kernels' plain versions in every worker (spawn pools),
on both plane transports, against the reference's bytes and the port's
``threads`` bits; the ``ranks`` driver against the reference's ``ranks``
run; failures in workers and initializers; the slab arena and the
throttled fan-out; and the start-method rule.

Spawn pools cost a torch import in each worker, so every configuration
runs once per module (``_runs``) and the tests read its result."""
import contextlib
import hashlib
import io
import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from repro.core.aggregate import AggregationConfig as RConfig
from repro.core.aggregate import StreamingAggregator as RAggregator
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.core.pms import PMSReader
from repro_torch.data import synth
from repro_torch.kernels import _build
from repro_torch.launch import analyze
from repro_torch.runtime import (available_executors, executor_for,
                                 get_executor, tree_reduce)
from repro_torch.runtime.shm import (SlabArena, attach, create_segment,
                                     destroy_segment, sections_layout,
                                     segment_prefix)

# (workers, plane transport) of the processes runs: each worker count and
# each transport once; on float data 2 and 4 workers on shm are held to
# threads in test_torch_analyze.py's determinism test
PROCESS_RUNS = [(1, "shm"), (2, "pickle"), (4, "shm")]
FLOAT_RUNS = PROCESS_RUNS[:2]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _digests(res):
    return tuple(_digest(p) for p in (res.pms_path, res.cms_path,
                                      res.trace_path))


def _own_segments() -> set[str]:
    """This process's shared-memory segments: the port's prefix only."""
    if not os.path.isdir("/dev/shm"):
        return set()
    return {f for f in os.listdir("/dev/shm")
            if f.startswith(segment_prefix())}


@pytest.fixture(scope="module")
def wl(tmp_path_factory):
    """The SMOKE twins (10 profiles, 8 host + 40 device metrics), the
    reference's serial numpy databases and the port's threads databases."""
    d = tmp_path_factory.mktemp("proc")
    fpaths, _, _ = synth.generate(synth.SMOKE, str(d / "float"), seed=1)
    ipaths, _, _ = synth.generate(synth.SMOKE, str(d / "int"), seed=2,
                                  integer_values=True)
    out = {"dir": d, "paths": {"float": fpaths, "int": ipaths}, "ref": {},
           "threads": {}, "runs": {}}
    for name, paths in out["paths"].items():
        out["ref"][name] = RAggregator(d / f"ref_{name}", RConfig(
            executor="serial", compute="cpu")).run(paths)
        out["threads"][name] = StreamingAggregator(
            d / f"threads_{name}", AggregationConfig(
                executor="threads", n_workers=4, device="cpu")).run(paths)
    return out


def _runs(wl, name, workers, transport):
    """The processes run of ``name`` at one setting, made once per module."""
    key = (name, workers, transport)
    if key not in wl["runs"]:
        wl["runs"][key] = StreamingAggregator(
            wl["dir"] / f"proc_{name}_{workers}_{transport}",
            AggregationConfig(executor="processes", n_workers=workers,
                              plane_transport=transport, compute="device",
                              device="cpu")).run(wl["paths"][name])
    return wl["runs"][key]


@pytest.mark.parametrize("workers,transport", PROCESS_RUNS)
def test_processes_exact_bytes_equal_reference(wl, workers, transport):
    """Integer values: db.pms, db.cms and db.trc byte-identical to the
    reference's numpy run, with the funnel's launches counted in the
    workers."""
    res = _runs(wl, "int", workers, transport)
    assert _digests(res) == _digests(wl["ref"]["int"])
    assert res.timings["funnel_launches"] > 0
    assert res.timings["funnel_requests"] > 0
    # plain versions on the CPU launch no kernel, in any process
    assert res.timings["device_launches_workers"] == {}
    assert set(res.timings["device_launches"].values()) <= {0}


@pytest.mark.parametrize("workers,transport", FLOAT_RUNS)
def test_processes_float_bits_equal_threads(wl, workers, transport):
    """f32-class data: the port's processes databases are bit-identical to
    its threads databases."""
    res = _runs(wl, "float", workers, transport)
    assert _digests(res) == _digests(wl["threads"]["float"])
    # one request a profile, whichever process makes it
    assert res.timings["funnel_requests"] == \
        wl["threads"]["float"].timings["funnel_requests"]


def test_processes_leave_no_segments(wl):
    assert _runs(wl, "int", 4, "shm").n_profiles == len(wl["paths"]["int"])
    assert not _own_segments()


def test_oversize_planes_take_one_shot_segments(wl, tmp_path):
    """Slabs smaller than any plane: every plane travels in a one-shot
    segment a worker creates under the parent's prefix, and the parent
    unlinks each one."""
    res = StreamingAggregator(tmp_path / "tiny", AggregationConfig(
        executor="processes", n_workers=2, compute="cpu",
        shm_slab_bytes=64)).run(wl["paths"]["int"])
    assert _digests(res) == _digests(wl["ref"]["int"])
    assert not _own_segments()


def test_ranks_bytes_equal_reference_ranks(wl, tmp_path):
    """2 ranks x 2 threads: the reference's ranks databases, byte for byte,
    and every PMS plane equal to the port's streaming run."""
    paths = wl["paths"]["int"]
    res = StreamingAggregator(tmp_path / "ranks", AggregationConfig(
        executor="ranks", n_workers=2, n_threads=2,
        compute="cpu")).run(paths)
    ref = RAggregator(tmp_path / "ref_ranks", RConfig(
        executor="ranks", n_workers=2, n_threads=2)).run(paths)
    assert _digests(res) == _digests(ref)
    base = wl["ref"]["int"]
    assert (res.n_contexts, res.n_values) == (base.n_contexts, base.n_values)
    with PMSReader(res.pms_path) as a, PMSReader(base.pms_path) as b:
        for pid in range(b.n_profiles):
            assert a.plane(pid).encode() == b.plane(pid).encode()


def test_ranks_with_device_compute_raises(wl, tmp_path):
    with pytest.raises(ValueError, match="not supported under the ranks"):
        StreamingAggregator(tmp_path / "x", AggregationConfig(
            executor="ranks", n_workers=2, compute="device",
            device="cpu")).run(wl["paths"]["int"])


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze.main(argv)
    return json.loads(buf.getvalue())


def test_cli_processes_and_ranks(wl, tmp_path):
    """``--executor processes --workers 2 --device cpu`` gives the
    reference's compute="cpu" bytes; ``--ranks 2 --compute cpu`` the
    reference's ranks bytes; the summary names the runtime."""
    paths = wl["paths"]["int"]
    out = _cli([*paths, "--out", str(tmp_path / "p"), "--executor",
                "processes", "--workers", "2", "--device", "cpu"])
    assert (out["executor"], out["workers"]) == ("processes", 2)
    assert (_digest(out["pms"]), _digest(out["cms"]),
            _digest(out["traces"])) == _digests(wl["ref"]["int"])
    assert out["timings"]["funnel_launches"] > 0
    out = _cli([*paths, "--out", str(tmp_path / "r"), "--ranks", "2",
                "--threads", "2", "--compute", "cpu"])
    assert out["executor"] == "ranks=2x2t"
    ref = RAggregator(tmp_path / "ref_ranks", RConfig(
        executor="ranks", n_workers=2, n_threads=2)).run(paths)
    assert (_digest(out["pms"]), _digest(out["cms"]),
            _digest(out["traces"])) == _digests(ref)


def test_cli_ranks_needs_cpu_compute(wl, tmp_path):
    with pytest.raises(ValueError, match="not supported under the ranks"):
        _cli([*wl["paths"]["int"], "--out", str(tmp_path / "x"),
              "--executor", "ranks", "--workers", "2"])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            _cli([*wl["paths"]["int"], "--out", str(tmp_path / "y"),
                  "--ranks", "2", "--executor", "threads"])


# ---------------------------------------------------------------------------
# failures surface in the parent, nothing hangs, nothing leaks
# ---------------------------------------------------------------------------

def test_worker_error_surfaces(wl, tmp_path):
    bad = tmp_path / "bad.rprf"
    bad.write_bytes(b"this is not a profile")
    cfg = AggregationConfig(executor="processes", n_workers=2,
                            compute="cpu")
    t0 = time.monotonic()
    with pytest.raises(Exception, match="not a profile file"):
        StreamingAggregator(tmp_path / "crash", cfg).run(
            wl["paths"]["int"] + [str(bad)])
    assert time.monotonic() - t0 < 60
    assert not _own_segments()


def test_spawned_worker_without_a_card_raises(wl, tmp_path, monkeypatch):
    """device="cuda" with a card in the parent only (patched) and none in
    the spawned workers: each worker's initializer raises, and the parent
    gets that error itself, not a broken pool and not a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: 0.0)
    cfg = AggregationConfig(executor="processes", n_workers=2,
                            compute="device", device="cuda")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        StreamingAggregator(tmp_path / "nocard", cfg).run(wl["paths"]["int"])
    assert time.monotonic() - t0 < 60
    assert not _own_segments()


def test_killed_worker_mid_slab_raises_and_cleans_up(wl, tmp_path,
                                                     monkeypatch):
    """A spawned phase-2 worker SIGKILLed while it owns a slab (the chaos
    marker reaches spawn children through the environment): the parent
    raises instead of waiting on the lost plane, and unlinks the arena."""
    monkeypatch.setenv("REPRO_CHAOS_KILL_MARKER", "agg-bench.0003")
    cfg = AggregationConfig(executor="processes", n_workers=2,
                            compute="device", device="cpu")
    t0 = time.monotonic()
    with pytest.raises(Exception):
        StreamingAggregator(tmp_path / "killed", cfg).run(wl["paths"]["int"])
    assert time.monotonic() - t0 < 60
    assert not _own_segments()


def _one_over(x):  # module-level: must pickle into process workers
    return 1 / x


def _boom_init():
    raise RuntimeError("init boom")


def _kill_self(task):
    os.kill(os.getpid(), signal.SIGKILL)


def _echo(x):
    return x


@pytest.mark.parametrize("name", ["processes", "ranks"])
def test_map_unordered_complete_and_raises(name):
    ex = get_executor(name, 3)
    got = dict(ex.map_unordered(_one_over, [1, 2, 4, 8, 16]))
    assert got == {0: 1.0, 1: 0.5, 2: 0.25, 3: 0.125, 4: 0.0625}
    with pytest.raises(ZeroDivisionError):
        list(ex.map_unordered(_one_over, [4, 2, 0, 1]))


def test_initializer_crash_propagates():
    """A raising initializer surfaces as itself, not a hang."""
    ex = get_executor("processes", 2)
    with pytest.raises(RuntimeError, match="init boom"):
        list(ex.map_unordered(_one_over, [1, 2], initializer=_boom_init))


def test_killed_worker_raises_not_hangs():
    ex = get_executor("processes", 2)
    t0 = time.monotonic()
    with pytest.raises(Exception):
        list(ex.map_unordered(_kill_self, [0, 1, 2]))
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# throttled fan-out and the slab arena (as the reference's tests)
# ---------------------------------------------------------------------------

def test_map_throttled_respects_credits():
    ex = get_executor("processes", 2)
    pulled = []

    def tasks():
        for i in range(6):
            pulled.append(i)
            yield i

    credit = {"n": 2}
    out = []
    for i, r in ex.map_throttled(_echo, tasks(),
                                 credits=lambda: credit["n"]):
        # at any point, no more tasks were pulled than credits granted
        assert len(pulled) <= credit["n"]
        out.append((i, r))
        credit["n"] += 1   # consuming grants another credit
    assert sorted(out) == [(i, i) for i in range(6)]


def test_map_throttled_zero_credit_stall_is_an_error():
    ex = get_executor("processes", 2)
    with pytest.raises(RuntimeError, match="stalled"):
        list(ex.map_throttled(_echo, [1, 2], credits=lambda: 0))


def test_map_throttled_discards_unyielded_results():
    """Whatever finished but was never yielded to an aborting caller goes
    through on_discard."""
    ex = get_executor("processes", 2)
    discarded = []
    gen = ex.map_throttled(_echo, range(4), credits=lambda: 10,
                           on_discard=discarded.append)
    first = next(gen)
    time.sleep(0.5)          # let the remaining instant tasks complete
    gen.close()              # caller aborts mid-iteration
    assert first not in discarded
    assert discarded
    assert all(isinstance(d, tuple) and d[0] == d[1] for d in discarded)


def test_slab_arena_acquire_release_cycle():
    arena = SlabArena(2, 1024)
    try:
        a = arena.acquire()
        b = arena.acquire()
        assert a != b
        assert a.startswith(segment_prefix()) and b.startswith(arena.prefix)
        with pytest.raises(RuntimeError, match="exhausted"):
            arena.acquire()
        arena.release(a)
        assert arena.acquire() == a
        # worker-visible roundtrip through an attach
        arena.view(b)[:4] = b"ping"
        seg = attach(b)
        assert bytes(seg.buf[:4]) == b"ping"
        seg.close()
        assert _own_segments() == {a, b}
    finally:
        arena.close()
    arena.close()  # idempotent
    assert not _own_segments()


def test_one_shot_segment_named_under_prefix():
    seg = create_segment(100, segment_prefix())
    try:
        assert seg.name.startswith(f"rtorch_{os.getpid()}_")
        assert seg.size >= 100 and _own_segments() == {seg.name}
    finally:
        destroy_segment(seg)
    assert not _own_segments()


def test_sections_layout_is_aligned():
    offs, total = sections_layout([13, 0, 7, 8])
    assert offs == [0, 16, 16, 24]
    assert total == 32
    assert all(o % 8 == 0 for o in offs)


# ---------------------------------------------------------------------------
# executor interface and the start-method rule
# ---------------------------------------------------------------------------

def test_registry_lists_all_four_backends():
    assert set(available_executors()) == {"serial", "threads", "processes",
                                          "ranks"}
    ex = get_executor("ranks", 2)
    assert ex.driver == "ranks" and not ex.in_process
    with pytest.raises(ValueError, match="unknown executor"):
        get_executor("gpu-rdma")


@pytest.mark.skipif(sys.platform != "linux", reason="fork default")
def test_start_method_rule(monkeypatch):
    """fork by default on Linux; REPRO_MP_CONTEXT wins when set; an
    explicit mp_context wins over both; executor_for spawns an
    out-of-process pool for compute="device" unless REPRO_MP_CONTEXT is
    set, and leaves in-process backends and compute="cpu" alone."""
    monkeypatch.delenv("REPRO_MP_CONTEXT", raising=False)
    assert get_executor("processes", 2)._ctx.get_start_method() == "fork"
    assert executor_for("processes", 2, "device")._ctx.get_start_method() \
        == "spawn"
    assert executor_for("ranks", 2, "device")._ctx.get_start_method() \
        == "spawn"
    assert executor_for("processes", 2, "cpu")._ctx.get_start_method() \
        == "fork"
    assert executor_for("threads", 2, "device").name == "threads"
    monkeypatch.setenv("REPRO_MP_CONTEXT", "forkserver")
    assert get_executor("processes", 2)._ctx.get_start_method() == \
        "forkserver"
    assert executor_for("processes", 2, "device")._ctx.get_start_method() \
        == "forkserver"
    assert get_executor("processes", 2, mp_context="spawn") \
        ._ctx.get_start_method() == "spawn"


def test_tree_reduce_shared_with_rank_reduction():
    from repro_torch.core.reduction import tree_reduce as legacy
    assert legacy is tree_reduce
    total, rounds = tree_reduce(list(np.arange(16)), lambda a, b: a + b, 2)
    assert total == 120 and rounds == 4
