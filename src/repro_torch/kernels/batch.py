"""Device-offloaded aggregation: the launch funnel between the phase-2
streaming engine and the kernels.

Three hot loops route here:

* **inclusive propagation** — the O(n_ctx x m) cumsum of the fused
  transform becomes a batched :func:`repro_torch.kernels.ops.
  inclusive_from_exclusive` launch: all profiles share the unified tree's
  preorder length ``n``, so their dense exclusive matrices concatenate along
  columns into one ``(n, M_total)`` blockscan.  The blockscan kernel makes a
  column's result a function of that column and ``n`` alone, so **batch
  composition cannot perturb bytes**, which keeps the device path
  deterministic across executors and thread interleavings.  The real
  column count goes to the card: a CUDA kernel takes any shape without
  recompiling, so there are no padding columns.
* **duplicate-key combine** — the stable-sorted segment sums behind
  :func:`repro_torch.core.pipeline._combine_sorted` run on the ``segstats``
  kernel, one launch per profile at its real size.
* **CMS stripe offsets / census** — the §4.3.2 exclusive scan runs through
  ``ops.exclusive_scan`` on int64 and the census through ``ops.histogram``
  on int32 ids with int64 counts: both exact, so CMS bytes never depend on
  the backend.

Dtype contract: values travel to the device as f32; the combine sums in
f32, the inclusive scan sums in f64 and stores its prefixes in f32.  A plane
classifies as **"exact"** when every value is an integer and both
``sum(|v|)`` and ``sum(v^2)`` stay within 2^24 — then every partial sum is
exactly representable in f32 regardless of association order and device
output is byte-identical to the CPU f64 path.  Anything else is **"f32"**:
device values carry f32 rounding (and near-zero inclusive sums may round to
exactly 0.0 and drop out of the sparse plane).  An inclusive value is a
difference of two f32 prefixes, so its error is about one ulp of the
metric's column total: within ``atol=1e-3, rtol=1e-4`` of the CPU path
while column totals stay below 2^14.  The class is a pure function of the
plane, and on either class the port's results are bit-identical across its
executors.

Devices: every function takes an explicit ``device``.  On ``"cuda"`` the
CUDA kernels run, and a host without a card raises; on ``"cpu"`` the same
funnel runs the kernels' plain PyTorch versions.  Nothing falls back.

Threading: the cross-thread coalescer is a combining funnel — no timers,
no dedicated dispatch thread.  A requester that finds no launch in flight
becomes the launcher and drains the pending list until it is empty; all
other requesters park on an event.  Launches share PyTorch's current
stream and run one at a time (copy in, kernels, copy out, under one lock),
so each launch's CUDA events time that launch alone; every result is
synchronised before it goes back to numpy.  The host work around the
launches (densifying, sorting, assembling planes) stays parallel.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import segstats as _ss

# below this many values the CPU bincount beats a kernel launch; a constant,
# so the offload decision is a pure function of the plane (executor/batch
# independent) and small planes stay byte-identical to the numpy path
DEVICE_COMBINE_MIN = 4096

# f32 integer-exactness ceiling: 2^24 (see module docstring)
_EXACT_LIMIT = 2.0 ** 24


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, refusing ``"cuda"`` on a host
    without a card (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "compute='device' on device 'cuda' needs an NVIDIA card, and "
                "torch.cuda.is_available() is False on this host; use "
                "device='cpu' for the kernels' plain versions or "
                "compute='cpu' for the numpy path")
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    return dev


def classify_plane(vals) -> str:
    """The per-plane dtype contract: ``"exact"`` or ``"f32"`` (docstring
    above).  Pure function of the values — every executor, worker count and
    batch composition classifies a given plane identically."""
    v = np.asarray(vals, dtype=np.float64)
    if v.size == 0:
        return "exact"
    if not np.all(np.isfinite(v)) or np.any(v != np.rint(v)):
        return "f32"
    a = np.abs(v)
    if a.sum() > _EXACT_LIMIT or np.sum(a * a) > _EXACT_LIMIT:
        return "f32"
    return "exact"


class _StreamClock:
    """Device-time split of one launch, from CUDA events on the launching
    stream: host-to-device copy, kernels (with their glue), device-to-host
    copy."""

    def __init__(self, device: torch.device):
        self._events = ([torch.cuda.Event(enable_timing=True)
                         for _ in range(4)] if device.type == "cuda" else None)

    def mark(self, k: int) -> None:
        if self._events is not None:
            self._events[k].record()

    def read(self) -> tuple[float, float, float]:
        """(h2d, kernel, d2h) milliseconds; call after the last mark."""
        if self._events is None:
            return 0.0, 0.0, 0.0
        ev = self._events
        ev[3].synchronize()
        return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                ev[2].elapsed_time(ev[3]))


class _Request:
    __slots__ = ("cols", "out", "err", "event")

    def __init__(self, cols: np.ndarray):
        self.cols = cols
        self.out: np.ndarray | None = None
        self.err: BaseException | None = None
        self.event = threading.Event()


class DeviceAggregator:
    """Per-run device context: the unified tree's ``end`` array resident on
    ``device`` and the combining funnel that coalesces concurrent threads'
    inclusive-propagation work into single launches.

    One instance serves one phase-2 run, shared by all worker threads.
    ``launches``/``requests`` count funnel launches (inclusive batches plus
    combines) and inclusive requests; ``device_ms`` splits the launches'
    stream time into copies and kernels (zero on the CPU).
    """

    def __init__(self, end: np.ndarray, *, device,
                 combine_min: int = DEVICE_COMBINE_MIN):
        self.device = resolve_device(device)
        end = np.ascontiguousarray(np.asarray(end, dtype=np.int64))
        self.n = int(end.size)
        self._end = torch.from_numpy(end).to(self.device)
        self.combine_min = int(combine_min)

        self._lock = threading.Lock()
        self._device_lock = threading.Lock()  # one launch on the stream
        self._pending: list[_Request] = []
        self._launching = False
        self.launches = 0
        self.requests = 0
        self.device_ms = {"h2d": 0.0, "kernel": 0.0, "d2h": 0.0}

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Copy to a numpy array.  From a card the copy into pinned memory
        is asynchronous: read the array only after :meth:`_account`, which
        waits for the launch's last event."""
        if self.device.type == "cpu":
            return t.numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host.numpy()

    def _account(self, clock: _StreamClock) -> None:
        h2d, kern, d2h = clock.read()  # waits for the last copy
        with self._lock:
            self.launches += 1
            self.device_ms["h2d"] += h2d
            self.device_ms["kernel"] += kern
            self.device_ms["d2h"] += d2h

    # -- inclusive propagation (the batched hot loop) ------------------------

    def inclusive(self, cols: np.ndarray) -> np.ndarray:
        """``out[i, c] = sum(cols[i:end[i], c])`` for each column — the
        preorder-interval inclusive sums, f32.  Thread-safe; concurrent
        callers' columns ride one launch."""
        req = _Request(np.ascontiguousarray(cols, dtype=np.float32))
        with self._lock:
            self._pending.append(req)
            self.requests += 1
            i_launch = not self._launching
            if i_launch:
                self._launching = True
        if i_launch:
            while True:
                with self._lock:
                    batch = self._pending
                    self._pending = []
                    if not batch:
                        self._launching = False
                        break
                self._launch(batch)
        req.event.wait()
        if req.err is not None:
            raise req.err
        return req.out

    def _launch(self, batch: list[_Request]) -> None:
        try:
            for r in batch:
                if r.cols.ndim != 2 or r.cols.shape[0] != self.n:
                    raise ValueError(f"inclusive: columns of shape "
                                     f"{r.cols.shape} for a tree of {self.n} "
                                     f"contexts")
            widths = [r.cols.shape[1] for r in batch]
            mat = (batch[0].cols if len(batch) == 1
                   else np.concatenate([r.cols for r in batch], axis=1))
            with self._device_lock:
                clock = _StreamClock(self.device)
                clock.mark(0)
                dev = torch.from_numpy(mat).to(self.device)
                clock.mark(1)
                out = ops.inclusive_from_exclusive(dev, self._end)
                clock.mark(2)
                host = self._to_host(out)
                clock.mark(3)
                self._account(clock)
            o = 0
            for r, w in zip(batch, widths):
                r.out = host[:, o:o + w]
                o += w
        except BaseException as e:
            for r in batch:
                r.err = e
        finally:
            for r in batch:
                r.event.set()

    # -- duplicate-key combine (per-profile segment sums) --------------------

    def wants_combine(self, n_values: int) -> bool:
        return n_values >= self.combine_min

    def combine_sums(self, seg_sorted: np.ndarray, vals: np.ndarray
                     ) -> np.ndarray:
        """Segment sums over stable-sorted dense ranks via the ``segstats``
        kernel; f32 accumulation (see the module dtype contract).  One
        launch per profile: concatenating profiles would change which
        values share a run with batch composition."""
        x = int(seg_sorted.size)
        n_seg = int(seg_sorted[-1]) + 1 if x else 0
        if n_seg == 0:
            return np.zeros(0, dtype=np.float64)
        seg_sorted = np.ascontiguousarray(seg_sorted, dtype=np.int32)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        with self._device_lock:
            clock = _StreamClock(self.device)
            clock.mark(0)
            ids = torch.from_numpy(seg_sorted).to(self.device)
            v = torch.from_numpy(vals).to(self.device)
            clock.mark(1)
            sums = _ss.segstats(ids, v, n_seg)[:, 0].contiguous()
            clock.mark(2)
            host = self._to_host(sums)
            clock.mark(3)
            self._account(clock)
        return host.astype(np.float64)


# ---------------------------------------------------------------------------
# CMS helpers (module-level: no per-run state needed)
# ---------------------------------------------------------------------------

def device_offsets(sizes: np.ndarray, device) -> np.ndarray:
    """CMS stripe offsets by exclusive scan on ``device`` (paper §4.3.2):
    int64, so exact at any size and byte-identical to ``np.cumsum``."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(sizes, dtype=np.int64)).to(dev)
    return ops.exclusive_scan(x).cpu().numpy()


def device_census_counts(rows_all: np.ndarray, n_ctx: int, device
                         ) -> np.ndarray:
    """Per-context value counts (the CMS census x_c) by ``histogram`` on
    ``device``, one launch over every profile's concatenated PMS rows,
    copied in their own type (int32 from the census, int64 past 2^31
    contexts): int64 counts, byte-identical to ``np.bincount``."""
    dev = resolve_device(device)
    ids = torch.from_numpy(np.ascontiguousarray(rows_all)).to(dev)
    return ops.histogram(ids, int(n_ctx)).cpu().numpy()
