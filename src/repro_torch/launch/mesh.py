"""Production meshes on a process group.

Port of :mod:`repro.launch.mesh`.  The hardware modelled is an H100
cluster: 256 cards arranged (16 data x 16 model); multi-pod adds a
leading ``pod`` axis (2 x 16 x 16 = 512 cards).  Without such a cluster,
the dry-run builds the mesh over torch's fake process group
(``torch.testing._internal.distributed.fake_pg``): rank 0 of ``N`` ranks,
whose collectives return without moving data.

The default process group is process-global, as the reference's forced
XLA device count is, so only the dry-run's own process and test
subprocesses initialise one.  ``make_production_mesh`` and
``make_host_mesh`` are functions, never module constants, so importing
this module starts no group.  Each uses the default group if there is one
(a real ``gloo`` or ``nccl`` group of the same world size), and otherwise
starts a fake one.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_fake_process_group(world_size: int) -> None:
    """Start the default process group as rank 0 of ``world_size`` fake
    ranks.  A torch without ``fake_pg`` raises: there is no fallback."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process group "
            f"(torch.testing._internal.distributed.fake_pg): the dry-run "
            f"cannot build a {world_size}-rank mesh without one") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(shape: tuple, names: tuple):
    """A mesh of ``shape`` over the default group (started fake if there
    is none); a larger fake group lends its first ranks, as the reference's
    16x16 mesh takes the first 256 of its 512 devices."""
    n = math.prod(shape)
    if not dist.is_initialized():
        init_fake_process_group(n)
    world = dist.get_world_size()
    if world > n and dist.get_backend() == "fake":
        return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=names)
    if world != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {world}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 1):
    """A small mesh for tests (and the one-card check), named as the
    production ones."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))
