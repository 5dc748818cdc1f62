"""The port's launch funnel and its callers on the CPU: DeviceAggregator
(device="cpu", the kernels' plain versions) against the reference's
DeviceAggregator (Pallas interpret mode), fused_transform and build_cms
against the reference, and the no-hidden-fallback rules."""
import hashlib
import threading

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from tests._hypothesis_compat import given, settings, st

from repro.core import cms as rcms
from repro.core.aggregate import AggregationConfig as RConfig
from repro.core.aggregate import StreamingAggregator as RAggregator
from repro.core.pipeline import fused_transform as r_fused
from repro.core.sparse import SparseMetrics as RSparse
from repro.kernels import batch as rbatch
from repro_torch.core import cms as pcms
from repro_torch.core.cct import ContextTree
from repro_torch.core.pipeline import fused_transform
from repro_torch.core.sparse import SparseMetrics
from repro_torch.kernels import batch as kb


def _chain_end(n):
    """A root->child chain tree: end[i] == n for all i."""
    return np.full(n, n, dtype=np.int64)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("vals", [
    [1.0, 2.0, 3.0], [], [1.5], [float(2 ** 25)], [4096.0] * 4096,
    [np.inf], [-3.0, 7.0], [np.nan],
])
def test_classify_plane_matches_reference(vals):
    v = np.asarray(vals, dtype=np.float64)
    assert kb.classify_plane(v) == rbatch.classify_plane(v)


def test_inclusive_matches_reference_aggregator(rng):
    n = 40
    end = np.sort(rng.integers(1, n + 1, n))[::-1].copy()
    end = np.maximum(end, np.arange(n) + 1)   # a valid interval family
    cols = rng.integers(0, 5, (n, 3)).astype(np.float32)
    dev = kb.DeviceAggregator(end, device="cpu")
    out = dev.inclusive(cols)
    ref = rbatch.DeviceAggregator(end).inclusive(cols)
    assert out.dtype == np.float32 and out.shape == (n, 3)
    assert_array_equal(out, ref)  # integer columns: exact either way
    assert dev.launches == 1 and dev.requests == 1
    assert dev.device_ms == {"h2d": 0.0, "kernel": 0.0, "d2h": 0.0}


def test_inclusive_coalesces_concurrent_requests():
    """Threads racing into the combining funnel each get exactly their own
    columns back, with no more launches than requests."""
    n, n_threads = 64, 6
    dev = kb.DeviceAggregator(_chain_end(n), device="cpu")
    barrier = threading.Barrier(n_threads)
    outs, errs = [None] * n_threads, [None] * n_threads

    def work(k):
        cols = np.full((n, k + 1), float(k + 1), dtype=np.float32)
        barrier.wait()
        try:
            outs[k] = dev.inclusive(cols)
        except BaseException as e:  # pragma: no cover - surfaced below
            errs[k] = e

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errs == [None] * n_threads
    for k in range(n_threads):
        want = np.outer(n - np.arange(n), np.ones(k + 1)) * (k + 1)
        assert outs[k].shape == (n, k + 1)
        assert_allclose(outs[k], want, rtol=1e-6)
    assert dev.requests == n_threads
    assert dev.launches <= dev.requests


def test_inclusive_batch_composition_cannot_change_bits(rng):
    """A column's f32 result is the same alone and inside a batch."""
    n = 3000
    dev = kb.DeviceAggregator(_chain_end(n), device="cpu")
    cols = rng.normal(size=(n, 7)).astype(np.float32)
    batch = dev.inclusive(cols)
    for j in range(7):
        assert_array_equal(dev.inclusive(cols[:, j:j + 1])[:, 0], batch[:, j])


def test_combine_sums_matches_reference_and_bincount(rng):
    end = _chain_end(8)
    seg = np.sort(rng.integers(0, 50, 400)).astype(np.int32)
    vals = rng.integers(1, 5, 400).astype(np.float32)  # exact class
    dev = kb.DeviceAggregator(end, device="cpu", combine_min=1)
    got = dev.combine_sums(seg, vals)
    want = np.bincount(seg, weights=vals.astype(np.float64),
                       minlength=int(seg[-1]) + 1)
    assert got.dtype == np.float64
    assert_array_equal(got, want)
    ref = rbatch.DeviceAggregator(end, offload_combine=True, combine_min=1)
    assert_array_equal(got, ref.combine_sums(seg, vals))
    assert dev.combine_sums(np.empty(0, np.int32),
                            np.empty(0, np.float32)).size == 0


def test_wants_combine_is_a_pure_size_threshold():
    dev = kb.DeviceAggregator(_chain_end(4), device="cpu")
    assert dev.combine_min == kb.DEVICE_COMBINE_MIN == 4096
    assert not dev.wants_combine(4095) and dev.wants_combine(4096)


def test_error_wakes_every_waiter(monkeypatch):
    """A failing launch sets the error on every request batched into it;
    nobody stays parked."""
    n, n_waiters = 16, 4
    dev = kb.DeviceAggregator(_chain_end(n), device="cpu")
    real = kb.ops.inclusive_from_exclusive
    calls = []

    def slow_then_fail(mat, end):
        calls.append(mat.shape)
        if len(calls) == 1:  # hold the first launch until the rest queue up
            for _ in range(2000):
                if len(dev._pending) == n_waiters:
                    break
                threading.Event().wait(0.005)
            return real(mat, end)
        raise RuntimeError("launch failed")

    monkeypatch.setattr(kb.ops, "inclusive_from_exclusive", slow_then_fail)
    results = {}

    def work(k):
        try:
            results[k] = dev.inclusive(np.ones((n, 1), np.float32))
        except RuntimeError as e:
            results[k] = e

    first = threading.Thread(target=work, args=("first",))
    first.start()
    while not calls:
        threading.Event().wait(0.001)
    rest = [threading.Thread(target=work, args=(k,)) for k in range(n_waiters)]
    for t in rest:
        t.start()
    for t in [first, *rest]:
        t.join(timeout=60)
        assert not t.is_alive()
    assert isinstance(results["first"], np.ndarray)
    assert all(isinstance(results[k], RuntimeError) for k in range(n_waiters))
    assert len(calls) == 2  # the waiters rode one failing launch


def test_wrong_leading_dim_raises():
    dev = kb.DeviceAggregator(_chain_end(16), device="cpu")
    with pytest.raises(ValueError, match="16 contexts"):
        dev.inclusive(np.zeros((8, 2), np.float32))


def test_device_offsets_never_none(rng):
    sizes = rng.integers(0, 1000, 333).astype(np.int64)
    got = kb.device_offsets(sizes, "cpu")
    assert_array_equal(got, np.concatenate([[0], np.cumsum(sizes)]))
    assert_array_equal(kb.device_offsets(np.empty(0, np.int64), "cpu"), [0])
    big = np.array([np.iinfo(np.int32).max] * 3, np.int64)
    assert_array_equal(kb.device_offsets(big, "cpu"),
                       np.concatenate([[0], np.cumsum(big)]))
    ref = rbatch.device_offsets(sizes)
    assert_array_equal(got, ref)


def test_device_census_counts_never_none(rng):
    rows = rng.integers(0, 300, 5000).astype(np.int64)
    got = kb.device_census_counts(rows, 300, "cpu")
    assert got.dtype == np.int64
    assert_array_equal(got, np.bincount(rows, minlength=300))
    assert kb.device_census_counts(np.empty(0, np.int64), 0, "cpu").size == 0
    assert_array_equal(kb.device_census_counts(np.empty(0, np.int64), 3,
                                               "cpu"), [0, 0, 0])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        kb.DeviceAggregator(_chain_end(4), device="cuda")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        kb.device_offsets(np.ones(3, np.int64), "cuda")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        kb.device_census_counts(np.ones(3, np.int64), 3, "cuda")
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        kb.resolve_device("meta")


# ---------------------------------------------------------------------------
# fused_transform and build_cms with a device, port against reference
# ---------------------------------------------------------------------------

def _random_tree_case(rng, max_nodes=60):
    """A preorder-space tree + a random profile remapped onto it (the
    generator of tests/test_pipeline.py, on the port's types)."""
    t = ContextTree()
    for _ in range(int(rng.integers(2, max_nodes))):
        t.child(int(rng.integers(0, len(t))), int(rng.integers(1, 5)),
                f"n{rng.integers(0, 8)}")
    pos, order, end = t.preorder()
    n = len(t)
    parent_pre = np.full(n, -1, np.int64)
    for c in range(1, n):
        parent_pre[pos[c]] = pos[t.parent[c]]
    n_local = int(rng.integers(1, 30))
    remap = pos[rng.integers(0, n, n_local)]
    x = int(rng.integers(0, 150))
    trip = (rng.integers(0, n_local, x), rng.integers(0, 6, x),
            rng.uniform(-2, 4, x))
    routes = {}
    if rng.integers(0, 2):
        for ph in rng.choice(n, size=min(3, n), replace=False):
            k = int(rng.integers(1, 4))
            routes[int(ph)] = (rng.integers(0, n, k).astype(np.int64),
                               rng.uniform(0.1, 2.0, k))
    return trip, remap, routes, parent_pre, end


def _tolerant(ref, got, atol=1e-3, rtol=1e-4):
    """f32-class planes: common keys agree to f32 precision; keys on one
    side only carry values that rounded to zero on the other."""
    g = {(int(c), int(m)): v for c, m, v in zip(*got.triplets())}
    w = {(int(c), int(m)): v for c, m, v in zip(*ref.triplets())}
    for k in set(g) ^ set(w):
        assert abs(g.get(k, w.get(k))) < atol, k
    for k in set(g) & set(w):
        assert g[k] == pytest.approx(w[k], rel=rtol, abs=atol), k


@settings(max_examples=20, deadline=None, database=None)
@given(st.integers(0, 2**31 - 1))
def test_fused_device_matches_reference_tolerantly(seed):
    rng = np.random.default_rng(seed)
    trip, remap, routes, parent_pre, end = _random_tree_case(rng)
    ref = r_fused(RSparse.from_triplets(*trip), remap, routes, parent_pre, end)
    dev = kb.DeviceAggregator(end, device="cpu", combine_min=1)
    got = fused_transform(SparseMetrics.from_triplets(*trip), remap, routes,
                          parent_pre, end, device=dev)
    _tolerant(ref, got)


@settings(max_examples=20, deadline=None, database=None)
@given(st.integers(0, 2**31 - 1), st.booleans())
def test_fused_bytes_equal_reference_on_exact_planes(seed, on_device):
    """Integer values within the 2^24 budget: the port's plane is
    byte-identical to the reference's numpy plane, with or without the
    device funnel."""
    rng = np.random.default_rng(seed)
    (r, m, _), remap, routes, parent_pre, end = _random_tree_case(rng)
    v = rng.integers(1, 8, r.size).astype(np.float64)
    ref = r_fused(RSparse.from_triplets(r, m, v), remap, {}, parent_pre, end)
    dev = (kb.DeviceAggregator(end, device="cpu", combine_min=1)
           if on_device else None)
    got = fused_transform(SparseMetrics.from_triplets(r, m, v), remap, {},
                          parent_pre, end, device=dev)
    assert got.encode() == ref.encode()


def test_device_path_edge_cases():
    """Empty, single-metric and all-placeholder planes survive the funnel
    and match the reference bytes."""
    parent = np.array([-1, 0, 0], np.int64)
    end = np.array([3, 2, 3], np.int64)
    dev = kb.DeviceAggregator(end, device="cpu", combine_min=1)
    routes = {0: (np.array([1, 2], np.int64), np.array([1.0, 1.0]))}
    for trip, rts in [(([], [], []), {}), (([1], [0], [2.0]), {}),
                      (([0, 0], [0, 0], [1.0, 3.0]), routes)]:
        got = fused_transform(SparseMetrics.from_triplets(*trip),
                              np.arange(3), rts, parent, end, device=dev)
        ref = r_fused(RSparse.from_triplets(*trip), np.arange(3), rts,
                      parent, end)
        assert got.encode() == ref.encode()


def test_legacy_pipeline_runs_on_the_host_only():
    """The legacy chain refuses a launch funnel, and without one gives the
    fused transform's bytes."""
    from repro_torch.core.pipeline import transform_plane
    sm = SparseMetrics.from_triplets([0], [0], [1.0])
    args = (sm, np.zeros(1, np.int64), {}, np.array([-1]), np.array([1]))
    dev = kb.DeviceAggregator(np.array([1]), device="cpu")
    with pytest.raises(ValueError,
                       match="device compute requires pipeline='fused'"):
        transform_plane(*args, pipeline="legacy", device=dev)
    assert transform_plane(*args, pipeline="legacy").encode() == \
        fused_transform(*args).encode()


def test_build_cms_device_matches_reference(tmp_path, rng):
    """The census and offsets on the funnel (plain versions): the CMS file
    is byte-identical to the reference's numpy build, for both gathers and
    both in-process executors."""
    from tests.conftest import make_profile
    paths = []
    for i in range(5):
        p = tmp_path / f"p{i}.rprf"
        make_profile(rng, n_nodes=70, n_metrics=6, density=0.3, n_trace=10,
                     identity={"rank": i}).save(p)
        paths.append(str(p))
    res = RAggregator(tmp_path / "ref",
                      RConfig(executor="serial", compute="cpu")).run(paths)
    want = _digest(res.cms_path)
    for executor, strategy in [("serial", "vectorized"), ("threads", "heap")]:
        out = tmp_path / f"{executor}.cms"
        pcms.build_cms(res.pms_path, out, executor=executor, n_workers=3,
                       strategy=strategy, compute="device", device="cpu")
        assert _digest(out) == want
    out = tmp_path / "numpy.cms"
    pcms.build_cms(res.pms_path, out, compute="cpu")
    assert _digest(out) == want
    with rcms.CMSReader(out) as r:
        assert r.n_ctx > 0


def test_census_hands_the_histogram_int32_ids(tmp_path, rng, monkeypatch):
    """The census's concatenated row ids reach ``ops.histogram`` as int32,
    as the reference casts them before its kernel, and x_c on the funnel is
    byte-equal to the numpy path and to the reference's Pallas histogram
    (interpret mode) on the same ids."""
    import jax.numpy as jnp

    from repro.kernels import ops as rops
    from repro_torch.core.pms import PMSReader
    from repro_torch.kernels import ops as pops
    from tests.conftest import make_profile
    paths = []
    for i in range(4):
        p = tmp_path / f"p{i}.rprf"
        make_profile(rng, n_nodes=60, n_metrics=5, density=0.3, n_trace=5,
                     identity={"rank": i}).save(p)
        paths.append(str(p))
    res = RAggregator(tmp_path / "ref",
                      RConfig(executor="serial", compute="cpu")).run(paths)
    seen = []
    histogram = pops.histogram

    def spy(ids, num_segments):
        seen.append(ids.clone())
        return histogram(ids, num_segments)

    monkeypatch.setattr(pops, "histogram", spy)
    with PMSReader(res.pms_path) as pms:
        n_ctx = len(pms.tree.parent)
        dev_x, dev_m = pcms.census(pms, n_ctx, compute="device",
                                   device="cpu")
        cpu_x, cpu_m = pcms.census(pms, n_ctx, compute="cpu")
    assert len(seen) == 1 and seen[0].dtype == torch.int32
    assert seen[0].numel() == int(cpu_x.sum()) > 0
    assert dev_x.dtype == cpu_x.dtype == np.int64
    assert dev_x.tobytes() == cpu_x.tobytes()
    assert dev_m.tobytes() == cpu_m.tobytes()
    pallas = np.asarray(rops.histogram(jnp.asarray(seen[0].numpy()), n_ctx))
    assert_array_equal(dev_x, pallas.astype(np.int64))
