"""The port's kernel layer on the CPU: every plain version against the
reference's Pallas kernels (interpret mode) and jnp oracles, with the
sweeps of tests/test_kernels.py; and the wrapper rules that hold without a
card (device dispatch, argument checks, the build directory, no fallback
when nvcc is missing)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import blockscan as bs
from repro_torch.kernels import int8_quant as q8
from repro_torch.kernels import scatter_add as sc
from repro_torch.kernels import segstats as ss


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_segstats(ids, vals, s):
    """The reference oracle with its wrapper's empty-segment finalisation."""
    want = np.array(rref.segstats_ref(jnp.asarray(ids), jnp.asarray(vals), s))
    empty = want[:, 1] == 0
    want[empty, 2] = 0.0
    want[empty, 3] = 0.0
    return want


# ---------------------------------------------------------------------------
# segstats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(17, 5), (200, 64), (1500, 700), (4096, 1000),
                                 (1024, 1), (64, 16)])
@pytest.mark.parametrize("sentinels", [0, 7])
def test_segstats_plain_matches_reference(rng, n, s, sentinels):
    """Sorted ids with empty segments, plus sentinel ids (>= S) at the end:
    the port agrees with the Pallas kernel and with the jnp oracle."""
    ids = np.sort(np.concatenate([rng.integers(0, s, n),
                                  np.full(sentinels, s + 3)])).astype(np.int32)
    vals = rng.normal(size=ids.size).astype(np.float32)
    got = ss.segstats(_t(ids), _t(vals), s).numpy()
    assert got.shape == (s, ss.N_STATS) and got.dtype == np.float32
    assert_allclose(got, _ref_segstats(ids, vals, s), rtol=1e-5, atol=1e-5)
    pallas = np.asarray(rops.segstats(jnp.asarray(ids), jnp.asarray(vals), s))
    assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_segstats_negative_and_empty_segments():
    ids = np.array([0, 0, 5, 5, 5, 9], dtype=np.int32)
    vals = np.array([-1.0, 2.0, 3.0, -4.0, 1.0, 7.0], dtype=np.float32)
    out = ss.segstats(_t(ids), _t(vals), 10).numpy()
    assert out[0, 0] == pytest.approx(1.0)
    assert out[0, 2] == pytest.approx(-1.0)
    assert out[5, 3] == pytest.approx(3.0)
    assert out[5, 1] == 3
    assert out[5, 4] == pytest.approx(26.0)
    assert np.all(out[1:5] == 0) and np.all(out[6:9] == 0)


def _nan_inf_case(rng, n=600, s=150):
    """Sorted ids with sentinels (>= S, the oracle's kind) at the end; NaN
    and +-inf at in-range positions."""
    ids = np.sort(np.concatenate([rng.integers(0, s, n),
                                  np.full(5, s + 1)])).astype(np.int32)
    vals = rng.normal(size=ids.size).astype(np.float32)
    inside = np.flatnonzero((ids >= 0) & (ids < s))
    pick = rng.choice(inside, size=30, replace=False)
    vals[pick[:10]] = np.nan
    vals[pick[10:20]] = np.inf
    vals[pick[20:]] = -np.inf
    return ids, vals, s


def test_segstats_plain_keeps_nan_and_inf_like_the_oracle(rng):
    """A segment holding a NaN has NaN sum, min, max and sumsq, as in the
    oracle, and no other segment does; infinities behave as in f32
    arithmetic."""
    ids, vals, s = _nan_inf_case(rng)
    got = ss.segstats(_t(ids), _t(vals), s).numpy()
    want = _ref_segstats(ids, vals, s)
    assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 2]).sum() == len(np.unique(ids[np.isnan(vals)]))
    finite = ~np.isnan(want)
    assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


def test_segstats_plain_sentinel_nan_reaches_no_segment(rng):
    """A sentinel contributes nothing, NaN included.  (The oracle's
    ``vals * 0`` for a sentinel would put its NaN into segment 0's sum and
    sumsq.)"""
    ids, vals, s = _nan_inf_case(rng)
    with_nan = vals.copy()
    with_nan[-1] = np.nan
    assert ids[-1] >= s
    assert_array_equal(ss.segstats(_t(ids), _t(with_nan), s).numpy(),
                       ss.segstats(_t(ids), _t(vals), s).numpy())


def test_segstats_plain_count_min_max_match_pallas_with_nan(rng):
    """Count, min and max agree with the Pallas kernel, NaN for NaN.  Its
    sums do not: its one-hot contraction multiplies every value by 0 or 1,
    so a NaN reaches the sum and sumsq of every row."""
    ids, vals, s = _nan_inf_case(rng)
    got = ss.segstats(_t(ids), _t(vals), s).numpy()
    pallas = np.asarray(rops.segstats(jnp.asarray(ids), jnp.asarray(vals), s))
    cols = [1, 2, 3]
    assert_array_equal(np.isnan(got[:, cols]), np.isnan(pallas[:, cols]))
    assert_array_equal(np.nan_to_num(got[:, cols]),
                       np.nan_to_num(pallas[:, cols]))
    assert np.isnan(pallas[:, 0]).all()


# ---------------------------------------------------------------------------
# blockscan
# ---------------------------------------------------------------------------

_DTYPES = [np.float32, np.float64, np.int32, np.int64]


def _scan_input(rng, shape, dtype):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("shape", [(17,), (200, 3), (1500, 700), (1, 1),
                                   (2049, 5)])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_blockscan_plain_matches_reference(rng, shape, dtype):
    """Every type keeps its own dtype (no int32 -> int64 promotion) and
    matches numpy's cumsum; integers exactly."""
    x = _scan_input(rng, shape, dtype)
    got = bs.blockscan(_t(x)).numpy()
    assert got.dtype == dtype and got.shape == x.shape
    want = np.cumsum(x, axis=0, dtype=dtype)
    if np.issubdtype(dtype, np.integer):
        assert_array_equal(got, want)
    else:
        assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# the row counts around the CUDA kernel's chunks (256, 512, 1,024 and
# 2,048 rows) and the Pallas kernel's 1,024-row blocks, in 1 and 33 columns
_CHUNK_EDGES = [(n,) if m == 1 else (n, m)
                for n in (1, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
                          2049) for m in (1, 33)]


@pytest.mark.parametrize("shape", [(17,), (200, 3), (1500, 700)]
                         + _CHUNK_EDGES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_blockscan_plain_matches_pallas(rng, shape, dtype):
    """Against the Pallas kernel (interpret mode) in the types it keeps
    without jax's 64-bit mode."""
    x = _scan_input(rng, shape, dtype)
    got = bs.blockscan(_t(x)).numpy()
    pallas = np.asarray(rops.blockscan(jnp.asarray(x)))
    oracle = np.asarray(rref.blockscan_ref(jnp.asarray(x)))
    if dtype == np.int32:
        assert_array_equal(got, pallas)
        assert_array_equal(got, oracle)
    else:
        assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
        assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_exclusive_scan_matches_reference(rng, dtype):
    x = _scan_input(rng, 1000, dtype)
    if np.issubdtype(dtype, np.integer):
        x = np.abs(x)
    got = ops.exclusive_scan(_t(x)).numpy()
    assert got.shape == (1001,) and got[0] == 0 and got.dtype == dtype
    want = np.asarray(rops.exclusive_scan(jnp.asarray(x)))
    if np.issubdtype(dtype, np.integer):
        assert_array_equal(got, want)
    else:  # f32 sums in another order: a few ulps of the running total
        assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_exclusive_scan_is_exact_past_int32():
    """The CMS offsets scan in int64: totals beyond 2^31 stay exact (the
    reference's int32 scan had to hand such sizes back to numpy)."""
    sizes = np.full(5, 2 ** 31 - 1, dtype=np.int64)
    got = ops.exclusive_scan(_t(sizes)).numpy()
    assert_array_equal(got, np.concatenate([[0], np.cumsum(sizes)]))


def test_inclusive_from_exclusive_matches_reference(rng):
    from tests.conftest import random_sparse, random_tree
    t = random_tree(rng, 64)
    sm = random_sparse(rng, len(t), 4, 0.2)
    _, order, end = t.preorder()
    dense = sm.to_dense(len(t), 4)[order].astype(np.float32)
    got = ops.inclusive_from_exclusive(_t(dense), _t(end.astype(np.int64)))
    want = np.asarray(rops.inclusive_from_exclusive(jnp.asarray(dense),
                                                    jnp.asarray(end)))
    assert got.shape == dense.shape
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# scatter_add and histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s,m", [(17, 5, 1), (256, 64, 1), (1024, 300, 4),
                                   (5000, 1200, 2), (200, 200, 3)])
def test_scatter_add_plain_matches_reference(rng, n, s, m):
    ids = rng.integers(-2, s + 3, n).astype(np.int32)  # unsorted, sentinels
    vals = rng.normal(size=(n, m)).astype(np.float32)
    got = sc.scatter_add(_t(ids), _t(vals), s).numpy()
    keep = (ids >= 0) & (ids < s)
    want = np.asarray(rref.scatter_add_ref(jnp.asarray(ids[keep]),
                                           jnp.asarray(vals[keep]), s))
    assert got.shape == (s, m)
    assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    pallas = np.asarray(rops.scatter_add(jnp.asarray(ids[keep]),
                                         jnp.asarray(vals[keep]), s))
    assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def test_scatter_add_one_dimensional_values(rng):
    ids = rng.integers(0, 5, 256).astype(np.int64)
    vals = rng.normal(size=256).astype(np.float32)
    got = sc.scatter_add(_t(ids), _t(vals), 5).numpy()
    want = np.zeros(5)
    np.add.at(want, ids, vals.astype(np.float64))
    assert got.shape == (5,)
    assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s,passes", [
    (1, ((0, 1),)), (511, ((0, 9),)), (512, ((0, 9), (9, 1))),
    (196_049, ((0, 9), (9, 9))), (2 ** 18, ((0, 9), (9, 9), (18, 1))),
    (2 ** 31 - 1, ((0, 9), (9, 9), (18, 9), (27, 4)))])
def test_scatter_add_radix_plan_covers_the_key_bits(s, passes):
    """Keys lie in [0, S] (S is the sentinels' key), so a plan covers
    bit_length(S) bits in 9-bit digits, over 2,048-row tiles."""
    assert sc.radix_plan(1_710_918, s) == (passes, 836)
    assert sc.radix_plan(0, s)[1] == 0


@pytest.mark.parametrize("n,s,match", [(2 ** 31, 10, "fewer than 2"),
                                       (10, 2 ** 31, "outside"),
                                       (-1, 10, "fewer than 2")])
def test_scatter_add_rejects_sizes_past_32_bits(n, s, match):
    """The kernels keep keys, rows and offsets in 32 bits: the wrapper's
    plan raises a clear error beyond them."""
    with pytest.raises(ValueError, match=match):
        sc.radix_plan(n, s)


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_histogram_matches_reference(rng, id_dtype):
    ids = rng.integers(0, 50, 4000).astype(id_dtype)
    got = ops.histogram(_t(ids), 50).numpy()
    assert got.dtype == np.int64
    assert_array_equal(got, np.bincount(ids, minlength=50))
    pallas = np.asarray(rops.histogram(jnp.asarray(ids.astype(np.int32)), 50))
    assert_array_equal(got, pallas.astype(np.int64))


def test_histogram_drops_sentinels_and_counts_past_f32():
    """Ids outside [0, S) are dropped, and counts past 2^24 stay exact: the
    reference's f32 count guard is gone."""
    ids = np.zeros((1 << 24) + 3, dtype=np.int64)
    ids[:2] = [-1, 9]
    got = ops.histogram(_t(ids), 2).numpy()
    assert_array_equal(got, [(1 << 24) + 1, 0])


# (16-byte vectors a tile, counts a zeroing chunk, blocks resident at once):
# the histogram's tile and chunk, and an H100 holding 6 blocks an SM
_HIST_LAYOUT = (512, 2048, 132 * 6)


@pytest.mark.parametrize("n,s,itemsize,address,want", [
    # the census: 1,710,918 ids into 196,049 counts (96 zeroing chunks);
    # int64 and int32 need more tiles than the card holds blocks
    (1_710_918, 196_049, 8, 0, (792, 96)),
    (1_710_918, 196_049, 4, 0, (792, 96)),
    # the skewed input: 200,000 int64 ids, 8 bytes past a boundary
    (200_000, 196_049, 8, 8, (196, 96)),
    # a view 12 bytes past a boundary: one more vector, one more tile
    (512 * 4, 5, 4, 0, (1, 1)),
    (512 * 4, 5, 4, 12, (2, 1)),
    # more zeroing chunks than tiles, and more of either than the card holds
    (10, 10 ** 6, 4, 4, (489, 489)),
    (10, 2 * 10 ** 6, 4, 4, (792, 977)),
    (10 ** 8, 10, 4, 0, (792, 1)),
    # no ids: one block zeroes; no counts: no launch
    (0, 1, 8, 0, (1, 1)),
    (0, 5, 4, 12, (1, 1)),
    (7, 0, 8, 0, (0, 0)),
    (0, 0, 4, 0, (0, 0)),
])
def test_histogram_plan_sizes_grid_and_zeroing(n, s, itemsize, address, want):
    """The grid is a block a tile (counted in 16-byte vectors from the
    boundary at or below the ids) or a zeroing chunk of 2,048 counts,
    whichever is more, capped at what the card holds at once."""
    assert sc.histogram_plan(n, s, itemsize, address, _HIST_LAYOUT) == want


# ---------------------------------------------------------------------------
# int8_quant
# ---------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [1, 100, 1000, 2047, 2048, 2049, 5000, 65536])
def test_int8_quant_plain_bit_equal_to_pallas(rng, n):
    """q, scales and err bit-equal to the reference's Pallas kernel in
    interpret mode, through both wrappers' block clamps and padding; the
    second block is all zero where n allows one."""
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 3)).astype(np.float32)
    if n >= 4096:
        x[2048:4096] = 0.0
    got = ops.int8_quant(_t(x))
    want = rops.int8_quant(jnp.asarray(x))
    assert [g.dtype for g in got] == [torch.int8, torch.float32,
                                      torch.float32]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_array_equal(_bits(g.numpy()), _bits(w))


def test_int8_quant_all_zero_block_has_unit_scale():
    x = np.zeros(4096, np.float32)
    x[2048:] = np.linspace(-3, 5, 2048, dtype=np.float32)
    q, s, e = ops.int8_quant(_t(x))
    rq, rs, re = rops.int8_quant(jnp.asarray(x))
    assert s[0] == 1.0 and not q[:2048].any() and not e[:2048].any()
    assert_array_equal(_bits(s.numpy()), _bits(rs))
    assert_array_equal(q.numpy(), np.asarray(rq))
    assert_array_equal(_bits(e.numpy()), _bits(re))


def test_int8_quant_nan_and_inf_blocks_match_pallas():
    """A NaN gives its block scale 1 and q 0 there; an inf block's
    residuals are NaN: the reference's behaviour, kept bit for bit."""
    x = np.random.default_rng(9).normal(size=6144).astype(np.float32)
    x[5], x[3000] = np.nan, np.inf
    got = ops.int8_quant(_t(x))
    want = rops.int8_quant(jnp.asarray(x))
    for g, w in zip(got, want):
        assert_array_equal(_bits(g.numpy()), _bits(w))
    assert float(got[1][0]) == 1.0 and int(got[0][5]) == 0


@pytest.mark.parametrize("n", [100, 2049, 65536])
def test_int8_dequant_round_trips(rng, n):
    x = rng.normal(size=n).astype(np.float32)
    q, s, e = ops.int8_quant(_t(x))
    deq = ops.int8_dequant(q, s, n)
    assert_array_equal(_bits(deq.numpy()),
                       _bits(rops.int8_dequant(*map(jnp.asarray, (
                           q.numpy(), s.numpy())), n)))
    assert_allclose((deq + e).numpy(), x, rtol=1e-6, atol=1e-7)


def test_int8_dequant_capacity_mismatch_raises_like_reference():
    q = np.zeros(5000, np.int8)
    s = np.ones(2, np.float32)
    with pytest.raises(ValueError) as want:
        rops.int8_dequant(jnp.asarray(q), jnp.asarray(s), 5000)
    with pytest.raises(ValueError) as got:
        ops.int8_dequant(_t(q), _t(s), 5000)
    assert str(got.value) == str(want.value)


def test_int8_quant_module_takes_ragged_lengths_and_any_block():
    """The kernel module pads a ragged last block with zeros itself."""
    x = torch.arange(1, 11, dtype=torch.float32)
    q, s, e = q8.int8_quant(x, 4)
    assert q.shape == (10,) and s.shape == (3,) and e.shape == (10,)
    assert_array_equal(s.numpy(), np.float32([4, 8, 10]) * np.float32(
        q8.INV_127))
    assert q8.INV_127 == float(np.float32(1 / 127))
    with pytest.raises(ValueError, match="block_n"):
        q8.int8_quant(x, 0)


# ---------------------------------------------------------------------------
# wrapper rules that hold without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: ss.segstats_cuda(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4), 2),
    lambda: bs.blockscan_cuda(torch.zeros(4)),
    lambda: sc.scatter_add_cuda(torch.zeros(4, dtype=torch.int64),
                                torch.zeros(4), 2),
    lambda: sc.histogram_cuda(torch.zeros(4, dtype=torch.int64), 2),
    lambda: q8.int8_quant_cuda(torch.zeros(4)),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_dispatch_refuses_mixed_devices():
    ids = torch.zeros(4, dtype=torch.int32)
    vals = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="one CUDA card or all on the CPU"):
        ss.segstats(ids, vals, 2)


@pytest.mark.parametrize("t,dtypes,ndims,exc", [
    (torch.zeros(4, dtype=torch.float16), (torch.float32,), (1,), TypeError),
    (torch.zeros(2, 2), (torch.float32,), (1,), ValueError),
    (torch.zeros(4, 4).t(), (torch.float32,), (2,), ValueError),
])
def test_expect_rejects_type_shape_and_layout(t, dtypes, ndims, exc):
    with pytest.raises(exc):
        _build.expect(t, "x", dtypes, ndims)


def test_build_dir_is_inside_the_checkout():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert _build.build_dir() == root / "build" / "kernels"
    lib = _build.library_path("segstats")
    assert lib.parent == root / "build" / "kernels"
    assert lib.name.startswith("libsegstats.") and lib.suffix == ".so"


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch):
    import shutil

    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_check_raises_on_launch_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")


def test_launch_counts_are_thread_safe():
    import threading
    counts = _build.LaunchCounts()
    threads = [threading.Thread(
        target=lambda: [counts.add("k") for _ in range(2000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert counts.snapshot() == {"k": 16000}
    counts.reset()
    assert counts.snapshot() == {}


def test_plain_versions_do_not_count_launches(rng):
    before = _build.launch_counts.snapshot()
    ss.segstats(_t(np.zeros(4, np.int32)), _t(np.ones(4, np.float32)), 1)
    bs.blockscan(_t(np.ones(4, np.float32)))
    ops.histogram(_t(np.zeros(4, np.int64)), 1)
    ops.int8_quant(_t(np.ones(4, np.float32)))
    assert _build.launch_counts.snapshot() == before
