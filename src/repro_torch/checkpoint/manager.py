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

* **elastic**: a DTensor leaf is gathered whole (``full_tensor``, then
  copied to the host) on the calling thread, the counterpart of the
  reference's ``np.asarray`` of a sharded array, so the files hold no
  mesh; ``restore(shardings=...)`` distributes each array onto any mesh.

Leaves may be tensors (on any device), DTensors, numpy arrays or numpy
scalars; :meth:`restore` returns a tree of CPU tensors, or DTensors where
``shardings`` says.

Under an initialised default process group a save is collective: every
rank calls :meth:`save` in the same order (the gathers are collectives),
only rank 0 writes and commits ``step_N``, and the other ranks wait at the
group's barrier until it has (with ``async_save``, in :meth:`wait`, which
every rank then calls).  Saving or restoring DTensors without a process
group raises.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


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


def _rank() -> int | None:
    """This process's rank in the default process group, or None when
    there is none."""
    return dist.get_rank() if dist.is_initialized() else None


def _need_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised default process "
                           f"group (torch.distributed.init_process_group)")


def _to_host(v) -> tuple[np.ndarray, str | None]:
    """``(array, recorded dtype)``: bf16 tensors as their uint16 bits.  A
    tensor is always copied, since training goes on updating it in place
    while the write runs; a DTensor is gathered whole first."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
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
        """state: tree of tensors/arrays (params/opt/data cursors).  Returns
        the write's future under ``async_save`` on the rank that writes,
        else None."""
        flat = list(_flatten(state))
        if any(isinstance(v, DTensor) for _, v in flat):
            _need_group("saving DTensors")
        host, dtypes = {}, {}
        for k, v in flat:
            host[k], dt = _to_host(v)
            if dt is not None:
                dtypes[k] = dt
        meta = dict(extra_meta or {})
        if dtypes:
            meta["dtypes"] = dtypes
        if _rank() not in (None, 0):
            if self._pool is None:
                self._committed()
            return None
        if self._pool is None:
            self._commit(self._write, step, host, meta)
            return None
        with self._lock:
            if self._pending is not None:
                self._pending.result()  # backpressure: one save in flight
            self._pending = self._pool.submit(self._write, step, host, meta)
        return self._pending

    def _commit(self, fn, *args) -> None:
        """Run ``fn(*args)`` on the writing rank, then release the others
        (:meth:`_committed`) with its outcome, so a failed write raises on
        every rank rather than leaving them at the barrier."""
        err = None
        try:
            fn(*args)
        except BaseException as e:
            err = e
        if _rank() is not None:
            self._committed(None if err is None else repr(err))
        if err is not None:
            raise err

    @staticmethod
    def _committed(err: str | None = None) -> None:
        """The group's barrier after a commit: rank 0 sends its write's
        outcome, every other rank waits for it and raises a failure."""
        box = [err]
        dist.broadcast_object_list(box, src=0)
        if box[0] is not None and dist.get_rank() != 0:
            raise RuntimeError(f"rank 0 failed to write the checkpoint: "
                               f"{box[0]}")

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
        """Wait for the save in flight; under a process group every rank
        calls this and returns once rank 0 has committed."""
        with self._lock:
            pending, self._pending = self._pending, None
        if self._pool is None:  # save() committed already
            return
        if _rank() in (None, 0):
            self._commit(pending.result if pending else lambda: None)
        else:
            self._committed()

    # -- restore ----------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
            elif name.endswith(".tmp") and _rank() in (None, 0):
                # torn write: discard (only the writer's rank may)
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
        return sorted(out)

    def restore(self, step: int | None = None, *, shardings=None):
        """``(step, tree)`` of the newest (or the given) step, or
        ``(None, None)`` when there is none.

        The tree holds CPU tensors.  ``shardings`` is a tree shaped like
        the state whose leaves are
        :class:`~repro_torch.sharding.specs.NamedSharding`: each array
        with one comes back as a DTensor on that mesh's device with its
        placements (``distribute_tensor``: every rank of the group calls
        this); a path it lacks, or a ``None`` leaf, stays a CPU tensor."""
        if shardings is not None:
            _need_group("restoring onto a mesh")
        steps = self.list_steps()
        if not steps:
            return None, None
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)) for k in z.files}
        if shardings is not None:
            where = dict(_flatten(shardings))
            for k, t in flat.items():
                to = where.get(k)
                if to is not None:
                    flat[k] = distribute_tensor(t.to(to.mesh.device_type),
                                                to.mesh, tuple(to.placements))
        return step, _unflatten(flat)
