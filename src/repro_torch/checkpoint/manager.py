"""Fault-tolerant checkpointing.

Port of :mod:`repro.checkpoint.manager`, with its on-disk layout:
``step_<N:010d>/arrays.npz`` holds every array under its ``/``-joined tree
path, and ``meta.json`` the step and the sorted keys.  Checkpoints move
between the two packages in both directions.

* **atomic**: a step is written into ``step_N.tmp`` and renamed to
  ``step_N`` only when complete; torn directories are removed on restore;
* **async**: the copy to host memory happens in :meth:`save`, the file
  write on a background thread, one save in flight at a time;
* **bf16**: numpy has no bfloat16, so a bf16 tensor is stored losslessly
  as its uint16 bit pattern and ``meta.json`` records its key under
  ``"dtypes"``; :meth:`restore` gives it back bit-equal.  A reference
  checkpoint has no ``"dtypes"``: its bf16 arrays read back from the
  ``.npz`` as 2-byte void (``|V2``) and restore as bf16 bits, the rest
  as written.  The reference reads the port's bf16 as uint16 integers.

Leaves may be tensors (on any device), numpy arrays or numpy scalars;
:meth:`restore` returns a tree of CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: dict):
    """Rebuild nested dict/tuple structure from path keys."""
    root: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return tuple(fix(node[str(i)]) for i in range(len(keys)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(v) -> tuple[np.ndarray, str | None]:
    """``(array, recorded dtype)``: bf16 tensors as their uint16 bits.  A
    tensor is always copied, since training goes on updating it in place
    while the write runs."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", copy=True)
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return v.numpy(), None
    return np.asarray(v), None


def _from_host(a: np.ndarray, dtype: str | None) -> torch.Tensor:
    if dtype == "bfloat16" or (a.dtype.kind == "V" and a.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending = None
        self._lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: dict, extra_meta: dict | None = None):
        """state: tree of tensors/arrays (params/opt/data cursors)."""
        host, dtypes = {}, {}
        for k, v in _flatten(state):
            host[k], dt = _to_host(v)
            if dt is not None:
                dtypes[k] = dt
        meta = dict(extra_meta or {})
        if dtypes:
            meta["dtypes"] = dtypes
        if self._pool is None:
            self._write(step, host, meta)
            return None
        with self._lock:
            if self._pending is not None:
                self._pending.result()  # backpressure: one save in flight
            self._pending = self._pool.submit(self._write, step, host, meta)
        return self._pending

    def _write(self, step: int, host: dict, meta: dict):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(host), **meta}, f)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    # -- restore ----------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
            elif name.endswith(".tmp"):  # torn write: discard
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
        return sorted(out)

    def restore(self, step: int | None = None):
        """``(step, tree of CPU tensors)`` of the newest (or the given)
        step, or ``(None, None)`` when there is none."""
        steps = self.list_steps()
        if not steps:
            return None, None
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)) for k in z.files}
        return step, _unflatten(flat)
