"""The port's sharding rules, parameter placements and dry-run inputs,
held against the JAX package's on the CPU.

* ``rules_for``: every architecture, for each step kind (train, prefill,
  decode, decode_sp) on the 16x16 and 2x16x16 meshes.  The reference's
  function reads only ``mesh.axis_names`` and ``mesh.devices.shape``, the
  port's only ``mesh.mesh_dim_names`` and ``mesh.shape``, so stand-ins
  take the place of 256 or 512 devices.
* For every parameter: the port's spec (of the unstacked module
  parameter) is the reference's ``PartitionSpec`` without its leading
  layer entry, its DTensor placements split exactly the mesh axes that
  spec names, and the largest shard is the shape ceil-divided by them.
* ``batch_struct``/``batch_logical``/``batch_specs`` and
  ``cache_struct_and_specs``: shapes, dtypes and specs equal.

No process group is started here.
"""
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as RSHAPES
from repro.configs.base import load_all as rload_all
from repro.models import params as rparams
from repro.models.api import batch_logical as rbatch_logical
from repro.models.api import batch_specs as rbatch_specs
from repro.models.api import batch_struct as rbatch_struct
from repro.models.api import build_model as rbuild_model
from repro.models.api import cache_struct_and_specs as rcache_struct_and_specs
from repro.models.api import rules_for as rrules_for
from repro_torch.configs.base import SHAPES, load_all
from repro_torch.models import params as P
from repro_torch.models.api import (batch_logical, batch_specs, batch_struct,
                                    build_model, cache_struct_and_specs,
                                    rules_for)
from repro_torch.sharding.specs import (current_rules, local_shape,
                                        placements, set_rules, train_rules)

ARCHS = sorted(rload_all())
KINDS = ("train", "prefill", "decode", "decode_sp")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = SimpleNamespace(axis_names=axes,
                          devices=SimpleNamespace(shape=shape))
    port = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return ref, port, dict(zip(axes, shape))


def _spec(ps) -> tuple:
    return tuple(ps)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_matches_reference(arch, kind, mesh):
    ref_mesh, port_mesh, _ = _meshes(mesh)
    ref = rrules_for(rload_all()[arch], ref_mesh, kind)
    port = rules_for(load_all()[arch], port_mesh, kind)
    assert port.rules == ref.rules
    assert port.mesh_axis_sizes == ref.mesh_axis_sizes


def _expected_placements(spec: tuple, axes: tuple) -> tuple:
    out = []
    for a in axes:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ("train", "decode"))
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_placements_match_reference(arch, kind, mesh):
    """Every module parameter: spec, placements, largest shard's bytes."""
    ref_mesh, port_mesh, sizes = _meshes(mesh)
    rcfg, cfg = rload_all()[arch], load_all()[arch]
    rrules = rrules_for(rcfg, ref_mesh, kind)
    rules = rules_for(cfg, port_mesh, kind)
    rdefs = rbuild_model(rcfg).param_defs()
    rspecs = dict(P.flatten(rparams.specs(rdefs, rrules)))
    rshapes = {path: d.shape for path, d in P.flatten(rdefs)}
    defs = build_model(cfg, device="meta").param_defs()
    specs = P.specs(defs, rules)
    structs = P.shapedtypes(defs, cfg.dtype)
    assert set(specs) == set(structs)
    assert set(specs) == {n for n, _ in
                          build_model(cfg, device="meta").named_parameters()}
    seen = 0
    for name, spec in specs.items():
        parts = name.split(".")
        stacked = parts[0] in P.STACKED
        path = "/".join([parts[0], *parts[2:]] if stacked else parts)
        rspec = _spec(rspecs[path])
        want = rspec[1:] if stacked else rspec
        assert spec == want, (name, spec, want)
        assert placements(spec, port_mesh) == _expected_placements(
            want, MESHES[mesh][1])
        shape = tuple(structs[name].shape)
        assert shape == tuple(rshapes[path][1:] if stacked
                              else rshapes[path])
        ceil = list(shape)
        for d, e in enumerate(want):
            n = int(np.prod([sizes[a] for a in
                             ((e,) if isinstance(e, str) else (e or ()))]))
            ceil[d] = -(-shape[d] // n)
        assert local_shape(shape, spec, sizes) == tuple(ceil)
        assert structs[name].dtype == P.torch_dtype(cfg.dtype)
        seen += 1
    assert seen > 0


def _torch_dtype(jdt):
    return getattr(torch, jnp.dtype(jdt).name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(RSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_structs_match_reference(arch, shape, mesh):
    ref_mesh, port_mesh, _ = _meshes(mesh)
    rcfg, cfg = rload_all()[arch], load_all()[arch]
    rshape, pshape = RSHAPES[shape], SHAPES[shape]
    kind = pshape.kind
    rrules = rrules_for(rcfg, ref_mesh, kind)
    rules = rules_for(cfg, port_mesh, kind)
    rb, b = rbatch_struct(rcfg, rshape), batch_struct(cfg, pshape)
    assert set(b) == set(rb)
    for k in b:
        assert tuple(b[k].shape) == tuple(rb[k].shape), k
        assert b[k].dtype == _torch_dtype(rb[k].dtype), k
        assert b[k].device.type == "meta"
    assert batch_logical(cfg, pshape) == rbatch_logical(rcfg, rshape)
    assert batch_specs(cfg, pshape, rules) == {
        k: _spec(v) for k, v in rbatch_specs(rcfg, rshape, rrules).items()}
    if kind != "decode":
        return
    rs, rsp = rcache_struct_and_specs(rbuild_model(rcfg), rcfg, rshape,
                                      rrules)
    s, sp = cache_struct_and_specs(build_model(cfg, device="meta"), cfg,
                                   pshape, rules)

    def walk(a, b, ra, rb_):
        if isinstance(ra, dict):
            assert set(a) == set(ra)
            for k in ra:
                walk(a[k], b[k], ra[k], rb_[k])
        elif isinstance(ra, tuple):
            assert len(a) == len(ra)
            for x, y, rx, ry in zip(a, b, ra, rb_):
                walk(x, y, rx, ry)
        elif ra.shape == ():  # "len": the port's Python int
            assert a == 0 and b == () and _spec(rb_) == ()
        else:
            assert tuple(a.shape) == tuple(ra.shape)
            assert a.dtype == _torch_dtype(ra.dtype)
            assert b == _spec(rb_)

    walk(s, sp, rs, rsp)


def test_rules_are_seen_by_other_threads():
    """On a card the autograd engine runs the backward, and with it a
    checkpointed block's recomputation, on a thread of its own: the rules
    the forward ran under must be the ones it sees."""
    rules = train_rules({"data": 2, "model": 4})
    seen = []
    with set_rules(None, rules):
        t = threading.Thread(target=lambda: seen.append(current_rules()))
        t.start()
        t.join()
    assert seen == [rules] and current_rules() is None
