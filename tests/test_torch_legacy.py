"""The legacy three-pass chain and the dense baseline on the CPU.

The port's ``propagate_inclusive``, ``propagate_inclusive_reference`` and
``redistribute_placeholders`` against the reference's on the same planes
(bytes equal); the port's legacy chain against its own ``fused_transform``
(bytes equal, the reference's contract, with and without the launch
funnel); legacy against fused databases under every executor
(``compute="cpu"``); the config rules for ``pipeline="legacy"``; and
``DenseAnalysis`` against the reference's tensor and the sparse
propagation."""
import hashlib

import numpy as np
import pytest

from repro.core import dense_baseline as rdense
from repro.core import propagate as rprop
from repro.core.sparse import SparseMetrics as RSparse
from repro_torch.core import dense_baseline as pdense
from repro_torch.core import propagate as pprop
from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.core.cct import ContextTree
from repro_torch.core.pipeline import fused_transform, transform_plane
from repro_torch.core.sparse import MeasurementProfile, SparseMetrics
from repro_torch.kernels import batch as kb
from tests.conftest import make_profile

SEEDS = [0, 1, 2, 3, 5, 8]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _digests(res):
    return tuple(_digest(p) for p in (res.pms_path, res.cms_path,
                                      res.trace_path))


def _tree_case(rng, max_nodes=60, routes=True):
    """A preorder-space tree, a random plane remapped onto it, and (half
    the time) placeholder routes: ``(trip, remap, routes, parent_pre, end,
    n)`` with ``trip`` the plane's ``(rows, mids, vals)``."""
    t = ContextTree()
    for _ in range(int(rng.integers(2, max_nodes))):
        t.child(int(rng.integers(0, len(t))), int(rng.integers(1, 5)),
                f"n{rng.integers(0, 8)}")
    pos, _, end = t.preorder()
    n = len(t)
    parent_pre = np.full(n, -1, np.int64)
    for c in range(1, n):
        parent_pre[pos[c]] = pos[t.parent[c]]
    n_local = int(rng.integers(1, 30))
    remap = pos[rng.integers(0, n, n_local)]
    x = int(rng.integers(1, 150))
    trip = (rng.integers(0, n_local, x), rng.integers(0, 6, x),
            rng.uniform(-2, 4, x))
    rts = {}
    if routes and rng.integers(0, 2):
        for ph in rng.choice(n, size=min(3, n), replace=False):
            k = int(rng.integers(1, 4))
            rts[int(ph)] = (rng.integers(0, n, k).astype(np.int64),
                            rng.uniform(0.1, 2.0, k))
    return trip, remap, rts, parent_pre, end, n


# ---------------------------------------------------------------------------
# the propagate module, port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep_exclusive", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_propagate_inclusive_bytes_equal_reference(seed, keep_exclusive):
    rng = np.random.default_rng(seed)
    (r, m, v), remap, _, _, end, n = _tree_case(rng)
    pos = rng.permutation(n)  # any preorder permutation of the rows
    got = pprop.propagate_inclusive(
        SparseMetrics.from_triplets(remap[r], m, v), pos, end,
        keep_exclusive=keep_exclusive)
    want = rprop.propagate_inclusive(
        RSparse.from_triplets(remap[r], m, v), pos, end,
        keep_exclusive=keep_exclusive)
    assert got.encode() == want.encode()


@pytest.mark.parametrize("seed", SEEDS)
def test_propagate_inclusive_reference_walk_equals_reference(seed):
    rng = np.random.default_rng(seed)
    (r, m, v), remap, _, parent_pre, _, _ = _tree_case(rng)
    got = pprop.propagate_inclusive_reference(
        SparseMetrics.from_triplets(remap[r], m, v), parent_pre)
    want = rprop.propagate_inclusive_reference(
        RSparse.from_triplets(remap[r], m, v), parent_pre)
    assert got.encode() == want.encode()


@pytest.mark.parametrize("seed", SEEDS)
def test_redistribute_placeholders_bytes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    (r, m, v), remap, _, _, _, n = _tree_case(rng)
    rts = {int(ph): (rng.integers(0, n, 3).astype(np.int64),
                     rng.uniform(0.1, 2.0, 3))
           for ph in np.unique(remap[r])[::2]}
    got = pprop.redistribute_placeholders(
        SparseMetrics.from_triplets(remap[r], m, v), rts)
    want = rprop.redistribute_placeholders(
        RSparse.from_triplets(remap[r], m, v), rts)
    assert got.encode() == want.encode()
    plane = SparseMetrics.from_triplets(r, m, v)
    assert pprop.redistribute_placeholders(plane, {}) is plane


# ---------------------------------------------------------------------------
# the port's legacy chain is its fused transform's byte oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep_exclusive", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_legacy_chain_bytes_equal_fused(seed, keep_exclusive):
    rng = np.random.default_rng(seed)
    trip, remap, rts, parent_pre, end, _ = _tree_case(rng)
    sm = SparseMetrics.from_triplets(*trip)
    legacy = transform_plane(sm, remap, rts, parent_pre, end,
                             pipeline="legacy", keep_exclusive=keep_exclusive)
    fused = fused_transform(sm, remap, rts, parent_pre, end,
                            keep_exclusive=keep_exclusive)
    assert legacy.encode() == fused.encode()


@pytest.mark.parametrize("seed", SEEDS)
def test_legacy_chain_bytes_equal_funnel_on_exact_planes(seed):
    """Integer values: the fused transform on the launch funnel (the
    kernels' plain versions, every combine through segstats) gives the
    legacy chain's bytes."""
    rng = np.random.default_rng(seed)
    (r, m, _), remap, _, parent_pre, end, _ = _tree_case(rng, routes=False)
    sm = SparseMetrics.from_triplets(
        r, m, rng.integers(1, 8, r.size).astype(np.float64))
    dev = kb.DeviceAggregator(end, device="cpu", combine_min=1)
    fused = fused_transform(sm, remap, {}, parent_pre, end, device=dev)
    legacy = transform_plane(sm, remap, {}, parent_pre, end,
                             pipeline="legacy")
    assert fused.encode() == legacy.encode()


# ---------------------------------------------------------------------------
# the engine: legacy databases equal fused ones under every executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy_wl")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(6):
        p = d / f"prof{i:03d}.rprf"
        make_profile(rng, n_nodes=70, n_metrics=6, density=0.3, n_trace=10,
                     identity={"rank": i}).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("executor", ["serial", "threads", "processes",
                                      "ranks"])
def test_legacy_database_bytes_equal_fused(tmp_path, profiles, executor):
    got = {}
    for pipeline in ("fused", "legacy"):
        cfg = AggregationConfig(executor=executor, n_workers=2, n_threads=2,
                                pipeline=pipeline, compute="cpu")
        got[pipeline] = _digests(StreamingAggregator(
            tmp_path / pipeline, cfg).run(profiles))
    assert got["legacy"] == got["fused"]


def test_legacy_rejects_device_compute(tmp_path):
    with pytest.raises(ValueError, match="requires pipeline='fused'"):
        StreamingAggregator(tmp_path / "x", AggregationConfig(
            pipeline="legacy", compute="device", device="cpu")).run([])
    with pytest.raises(ValueError, match="unknown pipeline 'fast'"):
        StreamingAggregator(tmp_path / "y", AggregationConfig(
            pipeline="fast", compute="cpu")).run([])


# ---------------------------------------------------------------------------
# the dense baseline
# ---------------------------------------------------------------------------

def test_dense_measurement_matches_reference(tmp_path, profiles):
    assert pdense.dense_measurement_nbytes(196_049, 96) == \
        rdense.dense_measurement_nbytes(196_049, 96)
    prof = MeasurementProfile.load(profiles[0])
    a = pdense.write_dense_measurement(tmp_path / "p.dense", prof, 6)
    from repro.core.sparse import MeasurementProfile as RProfile
    b = rdense.write_dense_measurement(tmp_path / "r.dense",
                                       RProfile.load(profiles[0]), 6)
    assert a == b > pdense.dense_measurement_nbytes(len(prof.tree.parent), 6)
    assert _digest(tmp_path / "p.dense") == _digest(tmp_path / "r.dense")


def test_dense_analysis_equals_reference(tmp_path, profiles):
    got = pdense.DenseAnalysis(tmp_path / "p.npy").run(profiles)
    want = rdense.DenseAnalysis(tmp_path / "r.npy").run(profiles)
    assert _digest(tmp_path / "p.npy") == _digest(tmp_path / "r.npy")
    for k in ("n_ctx", "n_profiles", "n_metrics_out", "result_bytes"):
        assert got[k] == want[k], k
    for k in ("count", "sum"):
        np.testing.assert_array_equal(got["stats"][k], want["stats"][k])
    assert got["stats"]["sum"].dtype == want["stats"]["sum"].dtype
    np.testing.assert_array_equal(got["tree"].parent_array(),
                                  want["tree"].parent_array())


def test_dense_analysis_agrees_with_sparse_propagation(tmp_path, rng):
    """As the reference's own check: each dense cell equals the port's
    sparse propagation of the same profile, within 1e-6 relative."""
    profs = [make_profile(rng, n_nodes=25, n_metrics=5) for _ in range(4)]
    paths = []
    for i, p in enumerate(profs):
        path = tmp_path / f"p{i}.rprf"
        p.save(path)
        paths.append(str(path))
    da = pdense.DenseAnalysis(tmp_path / "dense.npy")
    da.run(paths)
    profs = [MeasurementProfile.load(p) for p in paths]
    unified = ContextTree()
    remaps = [unified.merge(p.tree) for p in profs]
    pos, _, end = unified.preorder()
    checked = 0
    for i, (p, remap) in enumerate(zip(profs, remaps)):
        out = pprop.propagate_inclusive(p.metrics.remap_contexts(remap),
                                        pos, end)
        for c, m, v in zip(*out.triplets()):
            assert da.query(i, int(c), int(m)) == pytest.approx(v, rel=1e-6)
            checked += 1
    assert checked > 100
