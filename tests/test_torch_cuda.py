"""The port's CUDA kernels on the card: each against its plain version,
the wrapper's argument checks, column determinism and repeated launches,
analyze and live ingest end to end against the numpy path, and a
full-width training step.  Every test needs a card and is marked ``cuda``;
without one they skip.  On a host with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, batch, ops
from repro_torch.kernels import blockscan as bs
from repro_torch.kernels import int8_quant as q8
from repro_torch.kernels import scatter_add as sc
from repro_torch.kernels import segstats as ss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _on(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("n,s,sentinels", [(17, 5, 3), (200, 64, 0),
                                           (1500, 700, 9), (17280, 17280, 0)])
def test_segstats_kernel_matches_plain(dev, rng, n, s, sentinels):
    ids = np.sort(np.concatenate([rng.integers(0, s, n),
                                  np.full(sentinels, s + 1)])).astype(np.int32)
    vals = rng.normal(size=ids.size).astype(np.float32)
    got = ss.segstats(_on(dev, ids), _on(dev, vals), s)
    want = ss.segstats_plain(_on(dev, ids), _on(dev, vals), s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _stats_close(got, want, longest=32):
    """NaN at the same places; infinities equal; elsewhere within 1e-5
    plus 1e-7 per value of the longest run: the two sum a run in different
    orders, and f32 rounding grows with the run's length."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-5,
                               atol=1e-5 + 1e-7 * longest)


def _runs(lengths, s):
    """Sorted ids: segment k of ``s`` holds ``lengths[k]`` values."""
    return np.repeat(np.arange(s), lengths).astype(np.int32)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 1000])
def test_segstats_runs_of_one_length(dev, rng, length):
    """Every run ``length`` long, each starting at every offset modulo 32;
    and the same runs between runs of 1 and 7."""
    s = 200
    ids = _runs(np.full(s, length), s)
    mixed = _runs(np.where(np.arange(s) % 3 == 0, length,
                                np.where(np.arange(s) % 3 == 1, 1, 7)), s)
    for x in (ids, mixed):
        vals = _on(dev, rng.normal(size=x.size).astype(np.float32))
        got = ss.segstats(_on(dev, x), vals, s)
        _stats_close(got, ss.segstats_plain(_on(dev, x), vals, s), length)


@pytest.mark.parametrize("n,s,ids_of", [
    (0, 5, lambda n, s: np.zeros(0, np.int32)),
    (10, 0, lambda n, s: np.zeros(10, np.int32)),
    (300, 64, lambda n, s: np.full(n, s + 2, np.int32)),
    (300, 64, lambda n, s: np.sort(np.concatenate([
        np.full(100, -3), np.full(200, s)])).astype(np.int32)),
    (5000, 20000, lambda n, s: np.sort(np.random.default_rng(0).integers(
        -5, s + 5, n)).astype(np.int32)),
])
def test_segstats_empty_and_all_sentinel(dev, rng, n, s, ids_of):
    """n = 0, S = 0, every id a sentinel on either side, and wide gaps:
    empty segments are all zero."""
    ids = _on(dev, ids_of(n, s))
    vals = _on(dev, rng.normal(size=n).astype(np.float32))
    got = ss.segstats(ids, vals, s)
    assert got.shape == (s, ss.N_STATS)
    _stats_close(got, ss.segstats_plain(ids, vals, s))


def test_segstats_nan_and_inf(dev, rng):
    """A segment holding a NaN has NaN sum, min, max and sumsq; a sentinel's
    NaN reaches no segment; infinities as in the plain version."""
    s = 300
    ids = np.sort(np.concatenate([rng.integers(0, s, 5000), [-1],
                                  np.full(4, s)])).astype(np.int32)
    vals = rng.normal(size=ids.size).astype(np.float32)
    pick = rng.choice(np.arange(1, ids.size - 4), size=60, replace=False)
    vals[pick[:20]] = np.nan
    vals[pick[20:40]] = np.inf
    vals[pick[40:]] = -np.inf
    vals[0] = vals[-1] = np.nan
    it, vt = _on(dev, ids), _on(dev, vals)
    got = ss.segstats(it, vt, s)
    _stats_close(got, ss.segstats_plain(it, vt, s))
    nan_segs = np.unique(ids[1:-4][np.isnan(vals[1:-4])])
    assert torch.isnan(got[:, 2]).sum().item() == nan_segs.size
    assert torch.isnan(got[nan_segs][:, [0, 2, 3, 4]]).all()


def _main_path_like(rng, s, longest=11):
    """Sorted dense ranks with runs of 1 to ``longest`` values."""
    ids = _runs(rng.integers(1, longest + 1, s), s)
    return ids, rng.normal(size=ids.size).astype(np.float32)


def test_segstats_repeated_launches_bit_equal(dev, rng):
    ids, vals = _main_path_like(rng, 17280)
    it, vt = _on(dev, ids), _on(dev, vals)
    first = _scan_bits(ss.segstats(it, vt, 17280))
    for _ in range(9):
        assert torch.equal(_scan_bits(ss.segstats(it, vt, 17280)), first)


def test_segstats_profile_alone_equals_among_others(dev, rng):
    """A profile's ids alone and the same ids offset inside a concatenation
    with other profiles give the same bits in its rows."""
    parts = [_main_path_like(rng, s, longest) for s, longest in
             ((1000, 40), (17280, 11), (333, 1000))]
    alone_ids, alone_vals = parts[1]
    alone = ss.segstats(_on(dev, alone_ids), _on(dev, alone_vals), 17280)
    (i0, v0), _, (i2, v2) = parts
    for lead in (0, 1, 5, 31):  # shifts the profile's offset modulo 32
        ids = np.concatenate([i0[lead:], alone_ids + 1000, i2 + 18280])
        vals = np.concatenate([v0[lead:], alone_vals, v2])
        got = ss.segstats(_on(dev, ids), _on(dev, vals), 18613)
        assert torch.equal(_scan_bits(got[1000:18280]), _scan_bits(alone))


@pytest.mark.parametrize("shape", [(17,), (200, 3), (1500, 700), (2049, 33),
                                   (196000,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32,
                                   torch.int64])
def test_blockscan_kernel_matches_plain(dev, rng, shape, dtype):
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.normal(size=shape)).to(dtype).to(dev)
    else:
        x = torch.from_numpy(rng.integers(-50, 50, shape)).to(dtype).to(dev)
    got = bs.blockscan(x)
    want = bs.blockscan_plain(x)
    assert got.dtype == dtype
    if dtype.is_floating_point:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    else:
        assert torch.equal(got, want)


def test_blockscan_column_alone_equals_column_in_batch(dev, rng):
    x = _on(dev, rng.exponential(size=(5000, 40)).astype(np.float32))
    full = bs.blockscan(x)
    for j in (0, 17, 39):
        assert torch.equal(bs.blockscan(x[:, j:j + 1].contiguous()),
                           full[:, j:j + 1])


_SCAN_DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64]


def _scan_case(dev, rng, n, m, dtype):
    shape = (n,) if m == 1 else (n, m)
    a = (rng.normal(size=shape) if dtype.is_floating_point
         else rng.integers(-50, 50, shape))
    return torch.from_numpy(a).to(dtype).to(dev)


def _scan_close(got, want):
    """Integers exact; floats within 1e-5 of the largest prefix (both sum
    in f64, in different orders, and f32 rounds once)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point and got.numel():
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 196_049])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 88, 97])
@pytest.mark.parametrize("dtype", _SCAN_DTYPES)
def test_blockscan_chunk_and_tile_boundaries(dev, rng, n, m, dtype):
    """Around the kernel's 256-, 512-, 1,024- and 2,048-row chunks and its
    32-column tiles, on both bodies (single-column integers, tiles)."""
    x = _scan_case(dev, rng, n, m, dtype)
    _scan_close(bs.blockscan(x), bs.blockscan_plain(x))


@pytest.mark.parametrize("dtype", _SCAN_DTYPES)
@pytest.mark.parametrize("m", [1, 33])
def test_blockscan_unaligned_views(dev, rng, dtype, m):
    """A view that starts one element into its storage is not 16-byte
    aligned: the kernel takes its element-wise copies and stores."""
    x = _scan_case(dev, rng, 5001, m, dtype)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _scan_close(bs.blockscan(x), bs.blockscan_plain(x))


def _scan_bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}.get(t.dtype, t.dtype))


@pytest.mark.parametrize("dtype", _SCAN_DTYPES)
@pytest.mark.parametrize("m", [1, 88])
def test_blockscan_repeated_launches_bit_equal(dev, rng, dtype, m):
    """The flags and tickets are reset by the kernel itself: 10 launches
    on one input give the same bits."""
    x = _scan_case(dev, rng, 196_049, m, dtype)
    first = _scan_bits(bs.blockscan(x))
    for _ in range(9):
        assert torch.equal(_scan_bits(bs.blockscan(x)), first)


def test_blockscan_interleaved_shapes_share_scratch(dev, rng):
    """Calls of every type and body alternate on one stream's scratch: a
    word one call used for a total (here small positive integers, the
    values a flag takes) is never taken for another call's flag."""
    xs = [torch.from_numpy(rng.integers(0, 3, n)).to(dev)
          for n in (196_049, 50_000)]
    xs += [_scan_case(dev, rng, 196_049, 88, dt) for dt in _SCAN_DTYPES]
    xs += [_scan_case(dev, rng, 5001, 1, dt) for dt in _SCAN_DTYPES]
    for _ in range(3):
        for x in xs:
            _scan_close(bs.blockscan(x), bs.blockscan_plain(x))


def test_blockscan_column_alone_equals_batch_at_full_size(dev, rng):
    x = _on(dev, rng.exponential(size=(196_049, 88)).astype(np.float32))
    full = bs.blockscan(x)
    for j in (0, 31, 32, 63, 64, 87):
        alone = bs.blockscan(x[:, j:j + 1].contiguous())
        assert torch.equal(_scan_bits(alone), _scan_bits(full[:, j:j + 1]))


def test_blockscan_on_a_side_stream(dev, rng):
    """Each stream keeps its own scratch; the result is the same."""
    x = _scan_case(dev, rng, 196_049, 88, torch.float32)
    want = bs.blockscan(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = bs.blockscan(x)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(_scan_bits(got), _scan_bits(want))


@pytest.mark.parametrize("n,s,m", [(17, 5, 1), (1024, 300, 4),
                                   (5000, 1200, 2)])
def test_scatter_add_kernel_matches_plain(dev, rng, n, s, m):
    ids = _on(dev, rng.integers(-2, s + 3, n))
    vals = _on(dev, rng.normal(size=(n, m)).astype(np.float32))
    got = sc.scatter_add(ids, vals, s)
    want = sc.scatter_add_plain(ids, vals, s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, sc.scatter_add(ids, vals, s))  # fixed order


def _sums_close(got, want, tol=1e-5):
    """Within ``tol`` of the largest sum: the kernel adds each segment in
    ascending row order, the plain version in its own order."""
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    torch.testing.assert_close(got, want.to(got.dtype), rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("m", [1, 8, 40, 88])
def test_scatter_add_id_types_and_widths(dev, rng, id_dtype, m):
    n, s = 30_000, 5_000
    ids = _on(dev, rng.integers(-3, s + 3, n).astype(id_dtype))
    shape = (n,) if m == 1 else (n, m)
    vals = _on(dev, rng.normal(size=shape).astype(np.float32))
    _sums_close(sc.scatter_add(ids, vals, s),
                sc.scatter_add_plain(ids, vals, s))


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 4097])
@pytest.mark.parametrize("s", [1, 2, 511, 512, 513, 2 ** 18 - 1, 2 ** 18])
def test_scatter_add_tile_and_digit_edges(dev, rng, n, s):
    """Row counts around the 2,048-row radix tile, and S around the 9-bit
    digits (keys in [0, S] need bit_length(S) bits: one pass up to S =
    511, two from 512, three from 2^18)."""
    ids = _on(dev, np.concatenate([rng.integers(0, s, n - n // 10),
                                   rng.integers(s, s + 5, n // 10)]))
    vals = _on(dev, rng.normal(size=n).astype(np.float32))
    _sums_close(sc.scatter_add(ids, vals, s),
                sc.scatter_add_plain(ids, vals, s))


def _skewed(rng, n=200_000, s=196_049):
    """One segment holding 90% of the rows, the rest spread."""
    ids = rng.integers(0, s, n)
    ids[rng.random(n) < 0.9] = 777
    return ids


def _zipf(rng, n=200_000, s=196_049):
    return np.minimum(rng.zipf(1.3, n) - 1, s + 10)


@pytest.mark.parametrize("ids_of", [_skewed, _zipf])
@pytest.mark.parametrize("m", [1, 40])
def test_scatter_add_skewed_inputs(dev, rng, ids_of, m):
    ids = _on(dev, ids_of(rng))
    shape = (ids.numel(),) if m == 1 else (ids.numel(), m)
    vals = _on(dev, rng.uniform(0.5, 2.0, shape).astype(np.float32))
    got = sc.scatter_add(ids, vals, 196_049)
    # a segment of 180,000 values summed in f32: the plain version's
    # index_add_ in no fixed order is held at chip_smoke's RTOL, 1e-4; the
    # kernel against the same sum in f64 at 1e-5
    _sums_close(got, sc.scatter_add_plain(ids, vals, 196_049), 1e-4)
    f64 = torch.zeros(got.shape, dtype=torch.float64, device=dev)
    keep = (ids >= 0) & (ids < 196_049)
    _sums_close(got, f64.index_add_(0, ids[keep], vals[keep].double()))
    for _ in range(9):
        assert torch.equal(_scan_bits(sc.scatter_add(ids, vals, 196_049)),
                           _scan_bits(got))


def test_scatter_add_repeated_launches_bit_equal(dev, rng):
    """The census shape: 1,710,918 ids into 196,049 bins, 10 launches."""
    ids = _on(dev, rng.integers(0, 196_049, 1_710_918))
    vals = _on(dev, rng.uniform(0.5, 2.0, 1_710_918).astype(np.float32))
    first = _scan_bits(sc.scatter_add(ids, vals, 196_049))
    for _ in range(9):
        assert torch.equal(_scan_bits(sc.scatter_add(ids, vals, 196_049)),
                           first)


@pytest.mark.parametrize("m", [1, 40])
def test_scatter_add_segment_bits_unchanged_by_other_rows(dev, rng, m):
    """Rows of other segments inserted anywhere leave a segment's bits as
    they were: its rows keep their order, and it is summed alone (a long
    segment too, in chunks counted from its own first row)."""
    s, extra = 3_000, 5_000
    ids = rng.integers(0, s, 40_000)
    ids[:1000] = 7  # one segment longer than a reduce chunk
    shape = (40_000,) if m == 1 else (40_000, m)
    vals = rng.normal(size=shape).astype(np.float32)
    alone = sc.scatter_add(_on(dev, ids), _on(dev, vals), s)
    for k in (1, 100, 30_000):
        others = rng.integers(s, s + extra, k)
        at = np.sort(rng.integers(0, ids.size + 1, k))
        big_ids = np.insert(ids, at, others)
        big_vals = np.insert(vals, at, rng.normal(
            size=(k,) + shape[1:]).astype(np.float32), axis=0)
        got = sc.scatter_add(_on(dev, big_ids), _on(dev, big_vals),
                             s + extra)
        assert torch.equal(_scan_bits(got[:s]), _scan_bits(alone))


def test_scatter_add_library_layout_matches_wrapper(dev):
    sc._check_layout()


def _hist_random(rng):
    return rng.integers(-3, 5005, 100_000), 5000


def _hist_census(rng):
    """The CMS census's shape: 48 profiles' sorted rows concatenated, each
    context repeated once per metric value (runs of 1-15, ~8 on average):
    ~1.7M ids into 196,049 bins."""
    s = 196_049
    return np.concatenate([
        np.repeat(np.sort(rng.choice(s, 4_500, replace=False)),
                  rng.integers(1, 16, 4_500)) for _ in range(48)]), s


def _hist_skewed(rng):
    return _skewed(rng), 196_049


def _hist_dropped(rng):
    """Every id at or past S: nothing is counted."""
    ids, s = _hist_census(rng)
    return ids + s, s


def _hist_negative(rng):
    return -rng.integers(1, 1000, 50_000), 100


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ids_of", [_hist_random, _hist_census, _hist_skewed,
                                    _hist_dropped, _hist_negative])
def test_histogram_kernel_matches_plain(dev, rng, id_dtype, ids_of):
    ids, s = ids_of(rng)
    ids = _on(dev, ids.astype(id_dtype))
    want = sc.histogram_plain(ids, s)
    got = ops.histogram(ids, s)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    for _ in range(9):
        assert torch.equal(ops.histogram(ids, s), want)


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("length", [1, 31, 32, 33, 1000])
def test_histogram_runs_of_one_length(dev, rng, id_dtype, length):
    """Sorted runs that cross a lane's vector, a row of 32 lanes and a
    warp's chunk at every offset; the first and last ids out of range."""
    ids = np.repeat(np.arange(-1, 40_000 // length + 1), length)[:40_000]
    ids[-3:] = 10 ** 6
    ids = _on(dev, ids.astype(id_dtype))
    s = 40_000 // length
    assert torch.equal(sc.histogram_cuda(ids, s), sc.histogram_plain(ids, s))


@pytest.mark.parametrize("n", [0, 1, 5])
@pytest.mark.parametrize("s", [0, 1, 2049])
def test_histogram_empty_and_tiny(dev, n, s):
    """No ids, or no bins: all-zero counts of length S, and no launch for
    S = 0."""
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    before = _build.launch_counts.snapshot().get("histogram", 0)
    got = sc.histogram_cuda(ids, s)
    assert torch.equal(got, sc.histogram_plain(ids, s))
    after = _build.launch_counts.snapshot().get("histogram", 0)
    assert after - before == (1 if s else 0)


@pytest.mark.parametrize("id_dtype,offset", [
    (torch.int64, 1), (torch.int32, 1), (torch.int32, 2), (torch.int32, 3)])
def test_histogram_unaligned_views(dev, rng, id_dtype, offset):
    """A view that starts 4, 8 or 12 bytes past a 16-byte boundary, and
    ends short of one."""
    base = _on(dev, rng.integers(0, 3000, 100_003)).to(id_dtype)
    ids = base[offset:offset + 99_997]
    assert ids.data_ptr() % 16 == offset * ids.element_size()
    assert torch.equal(sc.histogram_cuda(ids, 3000),
                       sc.histogram_plain(ids, 3000))


def test_histogram_interleaved_sizes_and_streams(dev, rng):
    """Calls with another S right after each other on one stream, then on
    two streams by turns: each stream's barrier counts stay in step."""
    ids = _on(dev, _hist_census(rng)[0])
    small = ids[:1000] % 7
    want, want_small = (sc.histogram_plain(ids, 196_049),
                        sc.histogram_plain(small, 7))
    for _ in range(3):
        assert torch.equal(sc.histogram_cuda(ids, 196_049), want)
        assert torch.equal(sc.histogram_cuda(small, 7), want_small)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for i in range(10):
        with torch.cuda.stream(side if i % 2 else torch.cuda.current_stream()):
            got.append(sc.histogram_cuda(ids if i % 3 else small,
                                         196_049 if i % 3 else 7))
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want if i % 3 else want_small)


def test_wrappers_reject_bad_arguments(dev):
    f32 = torch.zeros(8, device=dev)
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ss.segstats(f32, f32, 2)
    with pytest.raises(ValueError, match="differ in length"):
        ss.segstats(i32, f32[:4], 2)
    with pytest.raises(ValueError, match="contiguous"):
        bs.blockscan(torch.zeros(4, 4, device=dev).t())
    with pytest.raises(TypeError):
        bs.blockscan(torch.zeros(4, dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="one CUDA card or all on the CPU"):
        ss.segstats(i32, torch.zeros(8), 2)


def test_wrappers_count_their_launches(dev):
    before = _build.launch_counts.snapshot()
    bs.blockscan(torch.ones(10, device=dev))
    ops.histogram(torch.zeros(10, dtype=torch.int64, device=dev), 2)
    ops.histogram(torch.zeros(1_710_918, dtype=torch.int32, device=dev),
                  196_049)
    after = _build.launch_counts.snapshot()
    assert after["blockscan_f32"] == before.get("blockscan_f32", 0) + 1
    assert after["histogram"] == before.get("histogram", 0) + 2


def test_aggregator_on_card_matches_plain(dev, rng):
    n = 3000
    end = np.full(n, n, dtype=np.int64)
    cols = rng.integers(0, 5, (n, 6)).astype(np.float32)
    on_card = batch.DeviceAggregator(end, device="cuda", combine_min=1)
    on_cpu = batch.DeviceAggregator(end, device="cpu", combine_min=1)
    np.testing.assert_array_equal(on_card.inclusive(cols),
                                  on_cpu.inclusive(cols))
    seg = np.sort(rng.integers(0, 700, 5000)).astype(np.int32)
    vals = rng.integers(1, 5, 5000).astype(np.float32)
    np.testing.assert_array_equal(on_card.combine_sums(seg, vals),
                                  on_cpu.combine_sums(seg, vals))
    assert on_card.device_ms["kernel"] > 0.0


def test_analyze_on_card_bytes_equal_numpy(dev, tmp_path):
    """Integer-valued SMOKE workload: --compute device on the card gives the
    numpy path's db.pms/db.cms/db.trc, and every path kernel launched."""
    from repro_torch.core.aggregate import (AggregationConfig,
                                            StreamingAggregator)
    from repro_torch.data import synth
    paths, _, _ = synth.generate(synth.SMOKE, str(tmp_path / "in"), seed=2,
                                 integer_values=True)

    def run(name, **kw):
        res = StreamingAggregator(tmp_path / name, AggregationConfig(
            executor="threads", n_workers=4, **kw)).run(paths)
        return res, [_digest(p) for p in (res.pms_path, res.cms_path,
                                          res.trace_path)]

    card, card_digests = run("card")
    _, cpu_digests = run("cpu", compute="cpu")
    assert card_digests == cpu_digests
    launches = card.timings["device_launches"]
    for k in ("blockscan_f32", "blockscan_i64", "histogram"):
        assert launches[k] > 0


def test_analyze_on_card_bit_deterministic_across_executors(dev, tmp_path):
    """Float-valued SMOKE workload on the card: serial and threads at 1, 2
    and 4 workers write one set of database bytes."""
    from repro_torch.core.aggregate import (AggregationConfig,
                                            StreamingAggregator)
    from repro_torch.data import synth
    paths, _, _ = synth.generate(synth.SMOKE, str(tmp_path / "in"), seed=1)
    digests = set()
    for executor, workers in [("serial", 1), ("threads", 1), ("threads", 2),
                              ("threads", 4)]:
        res = StreamingAggregator(
            tmp_path / f"{executor}{workers}",
            AggregationConfig(executor=executor, n_workers=workers)).run(paths)
        digests.add((_digest(res.pms_path), _digest(res.cms_path)))
    assert len(digests) == 1


@pytest.fixture(scope="module")
def card_twins(tmp_path_factory):
    """The SMOKE twins at 3,000 contexts a profile: every plane holds more
    than ``DEVICE_COMBINE_MIN`` keys, so ``segstats`` combines each one."""
    import dataclasses
    from repro_torch.data import synth
    w = dataclasses.replace(synth.SMOKE, n_ctx=3000)
    d = tmp_path_factory.mktemp("twins")
    return {"float": synth.generate(w, str(d / "float"), seed=1)[0],
            "int": synth.generate(w, str(d / "int"), seed=2,
                                  integer_values=True)[0]}


def _card_run(tmp_path, paths, name, **kw):
    from repro_torch.core.aggregate import (AggregationConfig,
                                            StreamingAggregator)
    res = StreamingAggregator(tmp_path / name,
                              AggregationConfig(**kw)).run(paths)
    return res, [_digest(p) for p in (res.pms_path, res.cms_path,
                                      res.trace_path)]


def test_processes_on_card_exact_bytes_equal_numpy(dev, card_twins,
                                                   tmp_path):
    """processes on the card, integer twin: the numpy path's bytes; the
    combine and the propagation launched in the spawned workers, the
    census and the offsets in the parent."""
    paths = card_twins["int"]
    card, card_digests = _card_run(tmp_path, paths, "card",
                                   executor="processes", n_workers=2)
    _, cpu_digests = _card_run(tmp_path, paths, "cpu", executor="threads",
                               compute="cpu")
    assert card_digests == cpu_digests
    total = card.timings["device_launches"]
    workers = card.timings["device_launches_workers"]
    assert workers["segstats"] == len(paths)
    assert workers["blockscan_f32"] == len(paths)
    for k in ("histogram", "blockscan_i64"):
        assert total[k] - workers.get(k, 0) > 0
    assert card.timings["device_kernel"] > 0.0
    assert card.timings["worker_peak_bytes"] > 0


def test_processes_on_card_float_bits_equal_threads(dev, card_twins,
                                                    tmp_path):
    """processes at 2 and 4 workers on the card, float twin: the bytes of
    threads on the card."""
    paths = card_twins["float"]
    digests = {tuple(_card_run(tmp_path, paths, f"{ex}{w}", executor=ex,
                               n_workers=w)[1])
               for ex, w in [("threads", 4), ("processes", 2),
                             ("processes", 4)]}
    assert len(digests) == 1


def test_query_ops_on_card_database_equal_numpy(dev, card_twins, tmp_path):
    """The integer twin written on the card and with numpy: every
    ``analyze query`` op and ``diagnose`` print the same bytes on both."""
    import contextlib
    import io

    from repro_torch.launch import analyze
    paths = card_twins["int"]
    card, _ = _card_run(tmp_path, paths, "card", executor="threads")
    cpu, _ = _card_run(tmp_path, paths, "cpu", executor="threads",
                       compute="cpu")
    dbs = [str(tmp_path / "card"), str(tmp_path / "cpu")]
    ops = [["topk", "--metric", "9", "-k", "10"],
           ["topk", "--metric", "2", "--exclusive"],
           ["select", "--metric", "9", "--path-regex", "solve"],
           ["stripe", "--ctx", "0", "--metric", "9", "--inclusive"],
           ["diff", dbs[1], "--metric", "9"],
           ["window", "--t0", "0", "--t1", "30"],
           ["window", "--pid", "1", "--t0", "0", "--t1", "30"]]

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            analyze.main(argv)
        return buf.getvalue()

    for op in ops:
        assert run(["query", dbs[0], *op]) == run(["query", dbs[1], *op]), op
    for extra in ([], ["--markdown"]):
        got, want = (run(["diagnose", d, "--metric", "9", *extra])
                     for d in dbs)
        assert got.replace(dbs[0], "<db>") == want.replace(dbs[1], "<db>")
    assert card.timings["device_launches"]["histogram"] > 0


def _ingest_on_card(tmp_path, paths, name, **kw):
    """``paths`` appended to the port's resident ingest state on the card
    in uneven increments, then published: the database's digests and the
    state's timings."""
    from repro_torch.core.aggregate import AggregationConfig
    from repro_torch.ingest import IngestState
    state = IngestState(AggregationConfig(**kw))
    n = len(paths)
    for lo, hi in ((0, n // 3), (n // 3, n // 3 + 1), (n // 3 + 1, n)):
        state.append(paths[lo:hi])
    out = tmp_path / name
    state.write_database(out)
    return [_digest(out / f) for f in ("db.pms", "db.cms", "db.trc")], \
        state.timings


@pytest.mark.parametrize("executor", ["threads", "processes"])
def test_ingest_on_card_exact_bytes_equal_numpy(dev, card_twins, tmp_path,
                                                executor):
    """Live ingest on the card, integer twin: every append's combine and
    propagation and the publish's census and offsets run on the kernels,
    and the epoch is the numpy one-shot run's bytes."""
    paths = card_twins["int"]
    digests, timings = _ingest_on_card(tmp_path, paths, "ingest",
                                       executor=executor, n_workers=2)
    _, cpu_digests = _card_run(tmp_path, paths, "cpu", executor="threads",
                               compute="cpu")
    assert digests == cpu_digests
    launches = timings["device_launches"]
    for k in ("segstats", "blockscan_f32", "blockscan_i64", "histogram"):
        assert launches.get(k, 0) > 0, (k, launches)
    assert timings["funnel_launches"] > 0 and timings["device_kernel"] > 0


def test_ingest_on_card_float_within_tolerance_of_oneshot(dev, card_twins,
                                                          tmp_path):
    """Float twin: the ingest epoch's planes agree with the one-shot run on
    the card within the smoke test's tolerance, and its traces are equal."""
    from repro_torch.core.pms import PMSReader
    paths = card_twins["float"]
    digests, _ = _ingest_on_card(tmp_path, paths, "ingest",
                                 executor="threads", n_workers=4)
    one, one_digests = _card_run(tmp_path, paths, "one", executor="threads")
    assert digests[2] == one_digests[2]
    with PMSReader(str(tmp_path / "ingest" / "db.pms")) as a, \
            PMSReader(one.pms_path) as b:
        for pid in range(len(paths)):
            pa, pb = a.plane(pid), b.plane(pid)
            np.testing.assert_array_equal(pa.ctx, pb.ctx)
            np.testing.assert_array_equal(pa.mid, pb.mid)
            np.testing.assert_allclose(pa.val, pb.val, atol=1e-3, rtol=1e-4)


def _assert_bits_equal(got, want):
    """Bit equality, except that a NaN's payload is not compared: the FMA
    on the card and the f64 residual of the plain version give NaNs of
    different bits, at the same places."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w))
            g, w = g.view(torch.int32)[~nan], w.view(torch.int32)[~nan]
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,block_n", [(1, 128), (1000, 1024), (2047, 2048),
                                       (2049, 2048), (5000, 2048),
                                       (65536, 2048), (1 << 22, 2048),
                                       (3001, 102)])
def test_int8_quant_kernel_bit_equal_to_plain(dev, rng, n, block_n):
    """Ragged n (the kernel pads its last block itself), an all-zero block,
    and a block size that is no multiple of 4 (the scalar path)."""
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 3)).astype(np.float32)
    if n >= 3 * block_n:
        x[block_n:2 * block_n] = 0.0
    xt = _on(dev, x)
    _assert_bits_equal(q8.int8_quant(xt, block_n),
                       q8.int8_quant_plain(xt, block_n))


def test_int8_quant_kernel_nan_inf_and_unaligned(dev, rng):
    """A NaN block (scale 1 and q 0 at the NaN, on both sides), an inf block,
    and an input 4 bytes off 16-byte alignment (the scalar path)."""
    x = rng.normal(size=3 * 2048 + 1).astype(np.float32)
    x[7], x[2048 + 9] = np.nan, np.inf
    xt = _on(dev, x)
    got = ops.int8_quant(xt[:-1])
    _assert_bits_equal(got, q8.int8_quant_plain(xt[:-1], 2048))
    assert float(got[1][0]) == 1.0 and int(got[0][7]) == 0
    off = xt[1:]
    assert off.data_ptr() % 16 == 4
    _assert_bits_equal(q8.int8_quant(off), q8.int8_quant_plain(off))


def test_int8_quant_wrapper_checks_and_counts(dev):
    before = _build.launch_counts.snapshot().get("int8_quant", 0)
    q8.int8_quant(torch.ones(4096, device=dev))
    assert _build.launch_counts.snapshot()["int8_quant"] == before + 1
    with pytest.raises(TypeError):
        q8.int8_quant(torch.ones(8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        q8.int8_quant(torch.ones(8, 2, device=dev)[:, 0])


def test_full_width_train_step_on_card(dev):
    """qwen3-0.6b at full width (596,049,920 bf16 parameters, f32 moments):
    two steps at batch 2 x 128 give finite losses and move the weights."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_arch("qwen3-0.6b")
    model = build_model(cfg, device=dev)
    assert sum(p.numel() for p in model.parameters()) == 596_049_920
    tr = Trainer(model, AdamWConfig(warmup_steps=1),
                 TrainerConfig(steps=2), TokenPipeline(cfg.vocab_size, 128, 2))
    opt = tr.init_state(torch.Generator(device=dev).manual_seed(0))
    before = model.layers[0].wq.detach().clone()
    tr.run(opt)
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert not torch.equal(before, model.layers[0].wq)
    assert model.embed.dtype == torch.bfloat16
    assert opt["m"]["embed"].dtype == torch.float32


def _family_model(arch, device, **kw):
    """A reduced model of ``arch`` in bf16 (``kw`` over the config), its
    weights from one seed on the CPU."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    cfg = reduced(get_arch(arch)).replace(dtype="bfloat16", **kw)
    tree = P.init_params(build_model(cfg, device="meta").param_defs(),
                         torch.Generator().manual_seed(0), cfg.dtype, "cpu")
    return cfg, P.from_reference(build_model(cfg, device=device), tree)


def _family_batch(cfg, device, rows=4, seq=32):
    from repro_torch.data import TokenPipeline
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.from_numpy(
        TokenPipeline(cfg.vocab_size, seq, rows).batch_at(0))}
    if cfg.family == "vlm":
        batch["vision_embed"] = torch.randn(
            (rows, cfg.vision_tokens, cfg.d_model), generator=gen)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((rows, 48, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("dispatch", ["sorted", "rowwise"])
def test_moe_step_bits_repeat_on_card(dev, dispatch):
    """A reduced MoE step in bf16 at the published capacity factor 1.25
    (copies are dropped) twice on the card: the loss and every gradient
    bit-equal (no float atomics decide a value)."""
    from repro_torch.train.loop import value_and_grad
    cfg, model = _family_model("qwen3-moe-30b-a3b", dev, capacity_factor=1.25,
                               moe_dispatch=dispatch)
    batch = _family_batch(cfg, dev, rows=8, seq=64)
    (l1, g1), (l2, g2) = (value_and_grad(model, batch) for _ in range(2))
    assert torch.equal(l1.view(torch.int32), l2.view(torch.int32))
    for n in g1:
        assert torch.equal(g1[n].view(torch.int16), g2[n].view(torch.int16)), n


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_family_card_matches_cpu(dev, arch):
    """Each ported family, reduced, in bf16: loss within 1e-2 and gradient
    global norm within 2e-2 relative between the card and the CPU."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import global_norm
    res = []
    for device in (dev, torch.device("cpu")):
        cfg, model = _family_model(arch, device)
        loss, grads = value_and_grad(model, _family_batch(cfg, device))
        res.append((float(loss), float(global_norm(grads.values()))))
    (lc, gc), (l0, g0) = res
    assert np.isfinite(lc) and np.isfinite(gc)
    assert lc == pytest.approx(l0, rel=1e-2)
    assert gc == pytest.approx(g0, rel=2e-2)


@pytest.mark.parametrize("Hk", [1, 4], ids=["shared", "per_head"])
def test_ssm_scan_card_matches_cpu(dev, Hk):
    """``linear_rnn_chunked`` at the published chunk of 256 over 320 steps
    (a whole chunk, then a padded one), log-decays ``-softplus`` of seeded
    normals (~-0.69 as at initialisation, so the unmasked decay matrix
    would overflow): on the card and the CPU, ``y`` and ``h_out`` within
    1e-4 (absolute and relative), and the gradients of a seeded linear
    functional finite and within 1e-4 of each tensor's largest."""
    from repro_torch.models.ssm import linear_rnn_chunked
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 320, 4, 16, 32
    la = -np.log1p(np.exp(rng.normal(0.0, 0.5, (B, S, H))))
    ins = [la] + [rng.normal(size=s) for s in
                  [(B, S, H, P), (B, S, Hk, N), (B, S, Hk, N), (B, H, P, N)]]
    cot = [rng.normal(size=s) for s in [(B, S, H, P), (B, H, P, N)]]
    res = []
    for device in (dev, torch.device("cpu")):
        ts = [_on(device, a.astype(np.float32)).requires_grad_() for a in ins]
        y, h = linear_rnn_chunked(*ts, chunk=256)
        gy, gh = (_on(device, c.astype(np.float32)) for c in cot)
        ((y * gy).sum() + (h * gh).sum()).backward()
        res.append([t.detach().cpu().numpy() for t in (y, h)]
                   + [t.grad.cpu().numpy() for t in ts])
    for got, want in zip(*res):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m"])
def test_ssm_family_train_step_on_card(dev, arch):
    """One AdamW step of each reduced SSM family in bf16 at the published
    chunk of 256 over 2 x 256 tokens, on the card and the CPU from the same
    weights: finite loss and gradient norm, within 1e-2 and 2e-2 relative
    of the CPU's, and the weights moved."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    kw = {"ssm_chunk": 256, "n_layers": 4}
    res = []
    for device in (dev, torch.device("cpu")):
        cfg, model = _family_model(arch, device, **kw)
        before = model.embed.detach().clone()
        m = make_train_step(model, AdamWConfig(warmup_steps=1))(
            init_opt_state(dict(model.named_parameters())),
            _family_batch(cfg, device, rows=2, seq=256))
        assert not torch.equal(before, model.embed)
        res.append((float(m["loss"]), float(m["grad_norm"])))
    (lc, gc), (l0, g0) = res
    assert np.isfinite(lc) and np.isfinite(gc)
    assert lc == pytest.approx(l0, rel=1e-2)
    assert gc == pytest.approx(g0, rel=2e-2)


def _f32_model(arch, device, **kw):
    """A reduced model of ``arch`` in f32 (``kw`` over the config), its
    weights from one seed on the CPU."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    cfg = reduced(get_arch(arch)).replace(**kw)
    tree = P.init_params(build_model(cfg, device="meta").param_defs(),
                         torch.Generator().manual_seed(0), cfg.dtype, "cpu")
    return cfg, P.from_reference(build_model(cfg, device=device), tree)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "llama-3.2-vision-11b", "whisper-small"])
def test_generation_card_matches_cpu(dev, arch):
    """Each attention family, reduced, in f32: ``prefill`` of 4 x 12
    tokens (``max_len`` 16) and 3 ``decode_step``s on the card give the
    CPU's logits within 1e-4 of the largest |logit| and every cache leaf
    within 1e-4 of its largest entry; then a full cache raises
    ``ValueError`` on the card too."""
    res = []
    for device in (dev, torch.device("cpu")):
        cfg, model = _f32_model(arch, device)
        batch = _family_batch(cfg, device, rows=4, seq=12)
        logits, cache = model.prefill(batch, max_len=16)
        steps = [logits]
        for i in range(3):
            tok = batch["tokens"][:, i:i + 1]
            logits, cache = model.decode_step(cache, {"tokens": tok})
            steps.append(logits)
        leaves = {k: v.cpu() for k, v in cache.items()
                  if isinstance(v, torch.Tensor)}
        leaves.update({f"kv{i}": t.cpu()
                       for i, t in enumerate(cache.get("kv", ()))})
        res.append(([s.cpu() for s in steps], leaves, cache["len"]))
        if device.type == "cuda":
            full = cfg.max_decoder_len if cfg.family == "audio" else 16
            tok = batch["tokens"][:, :1]
            with pytest.raises(ValueError, match="cache is full"):
                for _ in range(full):
                    model.decode_step(cache, {"tokens": tok})
    (card, card_leaves, card_len), (cpu, cpu_leaves, cpu_len) = res
    assert card_len == cpu_len == 15
    for got, want in zip(card, cpu):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    assert sorted(card_leaves) == sorted(cpu_leaves)
    for k, want in cpu_leaves.items():
        torch.testing.assert_close(card_leaves[k], want, rtol=0,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=k)


def _tensor_leaves(tree, prefix=""):
    """``{path: a copy on the CPU}`` of each tensor of a nested cache."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensor_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.to("cpu", copy=True)}
    return {}


@pytest.mark.parametrize("arch,kw", [("zamba2-7b", {"n_layers": 2}),
                                     ("xlstm-350m", {"n_layers": 4})],
                         ids=["hybrid", "ssm"])
def test_recurrent_generation_card_matches_cpu(dev, arch, kw):
    """The SSM and hybrid families, reduced, in f32, at the smoke's parity
    cuts (zamba2 2 layers: one attention application; xlstm 4 blocks: an
    sLSTM runs): ``prefill`` of 4 x 12 tokens (``max_len`` 16; a chunk of
    8 and a padded one) and 3 ``decode_step``s on the card give the CPU's
    logits within 1e-4 of the largest |logit| and every cache leaf (scan
    states, conv windows, sLSTM carries, attention caches) within 1e-4 of
    its largest entry; then on the card the hybrid's full attention cache
    raises ``ValueError``, and the xLSTM decodes past ``max_len``."""
    res = []
    for device in (dev, torch.device("cpu")):
        cfg, model = _f32_model(arch, device, **kw)
        batch = _family_batch(cfg, device, rows=4, seq=12)
        logits, cache = model.prefill(batch, max_len=16)
        steps = [logits]
        for i in range(3):
            tok = batch["tokens"][:, i:i + 1]
            logits, cache = model.decode_step(cache, {"tokens": tok})
            steps.append(logits)
        res.append(([s.cpu() for s in steps], _tensor_leaves(cache),
                    cache["len"]))
        if device.type == "cuda":
            tok = batch["tokens"][:, :1]
            if cfg.attn_every:
                with pytest.raises(ValueError, match="cache is full"):
                    for _ in range(2):
                        model.decode_step(cache, {"tokens": tok})
            else:
                for _ in range(2):
                    logits, cache = model.decode_step(cache, {"tokens": tok})
                assert cache["len"] == 17 and torch.isfinite(logits).all()
    (card, card_leaves, card_len), (cpu, cpu_leaves, cpu_len) = res
    assert card_len == cpu_len == 15
    for got, want in zip(card, cpu):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    assert sorted(card_leaves) == sorted(cpu_leaves)
    for k, want in cpu_leaves.items():
        assert card_leaves[k].dtype == want.dtype, k
        torch.testing.assert_close(
            card_leaves[k], want, rtol=0,
            atol=1e-4 * max(want.abs().max().item(), 1e-30), msg=k)


def test_logits_f32_card_matches_cpu(dev):
    """The serving head's product at qwen3-0.6b's width in bf16: on the
    card one GEMM with an f32 output, on the CPU the upcast operands;
    within 1e-5 of the largest logit."""
    from repro_torch.models.layers import logits_f32
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 1024, generator=g).bfloat16()
    w = (torch.randn(1024, 151_936, generator=g) * 0.02).bfloat16()
    want = logits_f32(x, w)
    got = logits_f32(x.to(dev), w.to(dev))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.fixture
def one_rank_nccl(dev):
    """A one-rank NCCL group for the test (the card's (1, 1) mesh)."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _elastic_trainer(device, fsdp, ckpt=None):
    """Reduced qwen3-0.6b (1 layer, f32) in a Trainer on ``device``: on a
    (1, 1) mesh with or without FSDP, or with no mesh (``fsdp`` None)."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    cfg = reduced(get_arch("qwen3-0.6b")).replace(n_layers=1)
    model = build_model(cfg, device=device)
    mesh = rules = None
    if fsdp is not None:
        mesh = make_host_mesh(1, 1)
        rules = rules_for(cfg, mesh, "train", fsdp=fsdp)
        P.distribute_params(model, mesh, rules)
    return Trainer(model, AdamWConfig(lr=1e-3),
                   TrainerConfig(steps=3, ckpt_every=2),
                   TokenPipeline(cfg.vocab_size, 16, 8), ckpt=ckpt,
                   mesh=mesh, rules=rules)


@pytest.mark.parametrize("written_on,onto", [("card_mesh", "card_mesh"),
                                             ("card_mesh", "card_plain"),
                                             ("cpu_plain", "card_mesh")])
def test_elastic_restore_on_the_card(one_rank_nccl, tmp_path, written_on,
                                     onto):
    """Two steps, a checkpoint, a third step: on the card's (1, 1) mesh
    (an async save of DTensor state) or on the CPU with no mesh.  The
    checkpoint restored onto a fresh (1, 1) card mesh under the FSDP rules
    (with ``shardings``), or into a card model with no mesh, takes the
    third step within 1e-4."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import params as P
    on_card = written_on == "card_mesh"
    first = _elastic_trainer(one_rank_nccl if on_card else "cpu",
                             False if on_card else None,
                             CheckpointManager(tmp_path))
    first.run(first.init_state(torch.Generator(
        device=one_rank_nccl if on_card else "cpu").manual_seed(0)))
    shardings = None
    if onto == "card_mesh":
        tr = _elastic_trainer(one_rank_nccl, True)
        tree = P.shardings(tr.model.param_defs(), tr.rules, tr.mesh)
        shardings = {"params": tree, "opt": {"m": tree, "v": tree}}
    else:
        tr = _elastic_trainer(one_rank_nccl, None)
    step, state = CheckpointManager(tmp_path).restore(shardings=shardings)
    assert step == 2
    tr.run(tr.load_checkpoint(state), start_step=step, steps=1)
    assert all(p.device.type == torch.device(one_rank_nccl).type
               for p in tr.model.parameters())
    assert abs(tr.history[0]["loss"] - first.history[2]["loss"]) < 1e-4
