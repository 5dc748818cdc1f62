"""A reader of the sparse profile the port's ``Profiler`` writes, kept
here so that the check reads the file without the program's loader.

Layout (little-endian): ``RPRF``, a u32 version; a JSON block (u32 length,
UTF-8) with ``environment`` (its ``registry`` lists each metric's ``mid``
and ``name``), ``identity`` and ``file_paths``; the context tree's four
arrays; the trace's times and contexts; the metrics' four arrays
(contexts, starts, metric ids, values).  An array is a 4-byte dtype code,
a u8 rank, u64 dimensions and its C-order bytes.
"""
from __future__ import annotations

import json
import struct

import numpy as np

_CODES = {"u8  ": np.uint8, "u16 ": np.uint16, "u32 ": np.uint32,
          "u64 ": np.uint64, "i32 ": np.int32, "i64 ": np.int64,
          "f32 ": np.float32, "f64 ": np.float64}


def _array(buf: bytes, off: int):
    dtype = np.dtype(_CODES[buf[off:off + 4].decode("ascii")])
    (ndim,) = struct.unpack_from("<B", buf, off + 4)
    shape = struct.unpack_from(f"<{ndim}Q", buf, off + 5)
    off += 5 + 8 * ndim
    n = int(np.prod(shape)) if ndim else 1
    arr = np.frombuffer(buf, dtype=dtype, count=n, offset=off).reshape(shape)
    return arr, off + n * dtype.itemsize


def read(path) -> dict:
    """``{"samples": trace samples, "totals": {metric name: sum of its
    values over every context}}``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RPRF":
        raise ValueError(f"{path}: not a profile")
    (n,) = struct.unpack_from("<I", buf, 8)
    meta = json.loads(buf[12:12 + n].decode("utf-8"))
    off = 12 + n
    for _ in range(4):                       # the context tree
        _, off = _array(buf, off)
    times, off = _array(buf, off)
    _, off = _array(buf, off)
    _, off = _array(buf, off)                # metric contexts, starts
    _, off = _array(buf, off)
    mids, off = _array(buf, off)
    vals, off = _array(buf, off)
    names = {m["mid"]: m["name"] for m in meta["environment"]["registry"]}
    totals: dict[str, float] = {}
    for mid, val in zip(mids.tolist(), vals.tolist()):
        totals[names[mid]] = totals.get(names[mid], 0.0) + val
    return {"samples": int(times.size), "totals": totals}
