"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake
H100 cluster.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's SPMD program for 256 and 512 placeholder TPU devices.  Here each
cell runs the port's own train, prefill or decode step on DTensor
parameters, batch and cache, placed by the reference's sharding rules, on
rank 0 of a fake process group of 256 ranks (16x16, ``data`` x ``model``)
or 512 (2x16x16, ``pod`` x ``data`` x ``model``), each shard a ``meta``
tensor: nothing is allocated and no card is needed.  (Under
``FakeTensorMode`` DTensor's bookkeeping of a strided shard calls
``tolist`` on a tensor of its own, which a fake tensor refuses.)  It
reports per-device memory, the op-level cost
(:mod:`repro_torch.analysis.op_cost`: FLOPs, bytes, collective bytes),
and a roofline with Hopper constants (:mod:`repro_torch.analysis.roofline`),
in the reference's JSON layout.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multipod
    python -m repro_torch.launch.dryrun --all --out runs/dryrun_torch

Every family runs.  A train cell with ``microbatches > 1`` traces one
microbatch's forward and backward and counts it ``microbatches`` times;
the update is counted once.  A microbatch of fewer rows than the batch
axes' devices (grok-1's 16 on 2x16x16) is split over the minor axes it
fills (:func:`_microbatch_rules`).  A serving step's loop over positions
(the sLSTM's) traces one position, counted by the sequence length
(:func:`~repro_torch.models.layers.counted_loop`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis import roofline
from repro_torch.analysis.op_cost import OpCostMode
from repro_torch.configs.base import SHAPES, load_all
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh)
from repro_torch.models import params as PD
from repro_torch.models.api import (batch_specs, batch_struct, build_model,
                                    cache_struct_and_specs, model_flops,
                                    n_active_params, n_params, rules_for)
from repro_torch.sharding.specs import (from_local, local_shape,
                                        mesh_axis_sizes, placements,
                                        set_rules)
from repro_torch.train.loop import apply_update, make_grad_fn, make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

# long-context decode requires sub-quadratic history handling: only the
# SSM/hybrid archs run long_500k (DESIGN.md §Arch-applicability).
LONG_OK = {"zamba2-7b", "xlstm-350m"}


def cell_is_skipped(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "full-attention arch: 500k dense KV decode is out of family"
    return None


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _sharded(struct: torch.Tensor, spec: tuple, mesh, sizes: dict):
    """A DTensor of ``struct``'s shape and dtype, placed by ``spec``,
    whose rank-0 shard is a fresh (fake) zero tensor."""
    local = torch.zeros(local_shape(tuple(struct.shape), spec, sizes),
                        dtype=struct.dtype, device="meta")
    return from_local(local, mesh, placements(spec, mesh), tuple(struct.shape))


def _local_bytes(structs: dict, specs: dict, sizes: dict, dtype=None) -> int:
    return sum(_nbytes(local_shape(tuple(s.shape), specs[k], sizes),
                       dtype or s.dtype)
               for k, s in structs.items())


def _pairs(structs, specs):
    """``(struct, spec)`` of each leaf of a cache tree (dicts and tuples
    of tensors, and ``"len"``), walked by the structs' shape."""
    if isinstance(structs, dict):
        for k, v in structs.items():
            yield from _pairs(v, specs[k])
    elif isinstance(structs, tuple):
        for v, sp in zip(structs, specs):
            yield from _pairs(v, sp)
    else:
        yield structs, specs


def _map(fn, structs, specs):
    if isinstance(structs, dict):
        return {k: _map(fn, v, specs[k]) for k, v in structs.items()}
    if isinstance(structs, tuple):
        return tuple(_map(fn, v, sp) for v, sp in zip(structs, specs))
    return fn(structs, specs)


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                overrides: dict | None = None, microbatches: int = 1,
                fsdp: bool | None = None, seq_shard: bool = False,
                mesh=None, moment_dtype=None) -> dict:
    """Trace one cell and return the reference's result dict.  ``mesh``
    (default: the production mesh, 16x16 or 2x16x16) may be any
    ``data``/``model`` (and ``pod``) DeviceMesh on the process group.  A
    ``moment_dtype`` given sets the moments and accumulators and skips the
    reference's rule that picks bf16 (and 16 microbatches) by size."""
    archs = load_all()
    cfg = archs[arch]
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    if shape.kind == "train" and microbatches == 1 \
            and shape.global_batch * shape.seq_len >= 1 << 20:
        # default gradient accumulation: bounds per-layer activation
        # residuals (the remat-saved per-layer carries) at ~1/8th; deep
        # stacks (zamba2: 81 layers) save a carry per layer -> go deeper
        microbatches = 16 if cfg.n_layers > 64 else 8
    # largest models (grok-1): f32 AdamW state alone exceeds a pod's HBM
    # -- physics, not sharding.  Runnable config: bf16 moments + bf16 grad
    # accumulation (10 B/param) and deeper accumulation.
    accum_dtype = moment_dtype or torch.float32
    if moment_dtype is None:
        moment_dtype = torch.float32
        if shape.kind == "train" and 14 * n_params(cfg) / n_chips > 8e9:
            moment_dtype = torch.bfloat16
            accum_dtype = torch.bfloat16
            microbatches = max(microbatches, 16)
    kind = shape.kind
    rules_kind = "decode_sp" if (kind == "decode" and
                                 shape.global_batch < sizes["data"]) \
        else kind
    rules = rules_for(cfg, mesh, rules_kind, fsdp=fsdp, seq_shard=seq_shard)
    dtype = PD.torch_dtype(cfg.dtype)

    model = build_model(cfg, device="meta")
    defs = model.param_defs()
    p_structs = PD.shapedtypes(defs, dtype)
    p_specs = PD.specs(defs, rules)
    b_structs = batch_struct(cfg, shape)
    b_specs = batch_specs(cfg, shape, rules)
    arg_bytes = (_local_bytes(p_structs, p_specs, sizes)
                 + _local_bytes(b_structs, b_specs, sizes))
    if kind == "train":
        arg_bytes += 2 * _local_bytes(p_structs, p_specs, sizes,
                                      moment_dtype) + 4  # m, v; int32 step
    elif kind == "decode":
        c_structs, c_specs = cache_struct_and_specs(model, cfg, shape, rules)
        # every tensor leaf, and "len" as the reference's int32 scalar
        arg_bytes += sum(
            4 if isinstance(s, int) else _nbytes(
                local_shape(tuple(s.shape), sp, sizes), s.dtype)
            for s, sp in _pairs(c_structs, c_specs))

    cost = OpCostMode()
    t0 = time.perf_counter()
    for name, s in p_structs.items():
        mod, leaf = _owner(model, name)
        setattr(mod, leaf, torch.nn.Parameter(
            _sharded(s, p_specs[name], mesh, sizes),
            requires_grad=kind == "train"))
    params = dict(model.named_parameters())
    batch = {k: _sharded(s, b_specs[k], mesh, sizes)
             for k, s in b_structs.items()}
    # the step's arguments, made and tracked before counting starts
    if kind == "train":
        opt = init_opt_state(params, moment_dtype)
        args = [params, opt["m"], opt["v"], batch]
    elif kind == "decode":
        cache = _map(lambda s, sp: s if isinstance(s, int) else
                     _sharded(s, sp, mesh, sizes), c_structs, c_specs)
        # a full cache but for the new token: the step attends over
        # every position, as the reference's masked step reads all
        cache["len"] = (cfg.max_decoder_len if cfg.family == "audio"
                        else shape.seq_len) - 1
        args = [params, cache, batch]
    else:
        args = [params, batch]
    cost.track(args)
    with cost, set_rules(mesh, rules):
        if kind == "train" and microbatches == 1:
            make_train_step(model, AdamWConfig(), mesh=mesh,
                            rules=rules)(opt, batch)
        elif kind == "train":
            _microbatched_step(model, opt, cfg, shape, rules, mesh,
                               sizes, microbatches, accum_dtype, cost)
        elif kind == "prefill":
            _serving(model, "prefill")(model, batch)
        else:
            _serving(model, "decode_step")(model, cache, batch)
    trace_s = time.perf_counter() - t0

    # parameters the step never reads (whisper's encoder in decode): XLA
    # drops such arguments from its count, the port's cards hold them
    unused = sum(_nbytes(tuple(p.to_local().shape), p.dtype)
                 for p in params.values() if not cost.read(p.to_local()))
    c = cost.cost
    rf = roofline.analyze(c, n_chips=n_chips,
                          model_flops=model_flops(cfg, shape))
    peak = max(c.peak_bytes, arg_bytes)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in sizes.values()),
        "n_chips": n_chips, "kind": kind, "rules_kind": rules_kind,
        "n_params": n_params(cfg), "n_active_params": n_active_params(cfg),
        "memory": {
            "argument_bytes": arg_bytes,
            "unread_argument_bytes": unused,
            "temp_bytes": peak - arg_bytes,
            "peak_per_device_bytes": peak,
            "fits_80GB": bool(peak < roofline.HBM_CAPACITY),
        },
        "roofline": rf.to_dict(),
        "collectives": rf.coll_by_kind,
        "port_dispatch": _port_dispatch(c, rf, n_chips),
        "op_cost": {"flops": c.flops, "dot_flops": c.dot_flops,
                    "bytes_accessed": c.bytes, "ops": c.ops,
                    "microbatches_traced": 1,
                    "loops_repeated": c.loops_repeated},
        "timings": {"trace_s": trace_s},
        "overrides": overrides or {}, "microbatches": microbatches,
        "moment_dtype": str(moment_dtype).removeprefix("torch."),
        "torch": torch.__version__,
    }


def _port_dispatch(c, rf, n_chips: int) -> dict | None:
    """The sorted MoE dispatch's whole-buffer sums (the ``moe_dispatch``
    scope), a cost of the port's dispatch and not of the job: their bytes
    (collective and HBM), and the roofline without them.  ``dominant_is_
    port_cost`` says that they make the cell's dominant term."""
    b = c.coll_by_scope.get("moe_dispatch", 0.0)
    if not b:
        return None
    rest = roofline.analyze(dataclasses.replace(
        c, coll_bytes=c.coll_bytes - b, bytes=c.bytes - b), n_chips=n_chips)
    return {"collective_bytes": b, "collective_s": b / roofline.LINK_BW,
            "without": {k: getattr(rest, k) for k in (
                "compute_s", "memory_s", "collective_s", "dominant")},
            "dominant_is_port_cost": rest.dominant != rf.dominant}


def _serving(model, name: str):
    """The model's ``prefill`` or ``decode_step``, its body run under
    ``no_grad`` instead of the inference mode it is decorated with: the
    same ops, but composite ones (``einsum``, ``matmul``) then reach
    DTensor decomposed, as in training, where under inference mode
    DTensor would trace each one's decomposition anew."""
    fn = getattr(type(model), name).__wrapped__
    return torch.no_grad()(fn)


def _owner(model, name: str):
    """The submodule holding parameter ``name``, and its attribute name."""
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def _microbatch_rules(rules, rows: int):
    """``rules`` with the batch (and token) axes cut, major first, to those
    whose devices ``rows`` fill evenly.  XLA pads a microbatch of fewer
    rows than devices (grok-1's 16 on 32); DTensor cannot flatten such a
    split, so the major axis holds the rows whole instead: each device
    still holds ceil(rows / devices) rows, and the axis computes them
    redundantly where XLA computes padding."""
    axes = rules.axis("batch")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    while axes and rows % math.prod(rules.mesh_axis_sizes[a] for a in axes):
        axes = axes[1:]
    cut = (axes if len(axes) > 1 else axes[0]) if axes else None
    return rules.with_overrides(batch=cut, tokens=cut)


def _microbatched_step(model, opt, cfg, shape, rules, mesh, sizes,
                       microbatches: int, accum_dtype, cost) -> None:
    """The reference's accumulated step (``loop.py:46-68``): zeroed
    accumulators, one microbatch's loss and gradients added ``microbatches``
    times (traced once, counted that often), their mean, then one AdamW
    update.  The microbatch's rows are a fresh shard of the batch, placed
    by :func:`_microbatch_rules`."""
    mb_shape = shape.__class__(shape.name, shape.seq_len,
                               shape.global_batch // microbatches, shape.kind)
    mb_rules = _microbatch_rules(rules, mb_shape.global_batch)
    b_specs = batch_specs(cfg, mb_shape, mb_rules)
    mb = {k: _sharded(s, b_specs[k], mesh, sizes)
          for k, s in batch_struct(cfg, mb_shape).items()}
    params = dict(model.named_parameters())
    acc = {n: torch.zeros_like(p, dtype=accum_dtype) for n, p in params.items()}
    with cost.repeat(microbatches), set_rules(mesh, mb_rules):
        loss, grads = make_grad_fn(model)(mb)
        for n, g in grads.items():
            acc[n] += g
    del grads
    grads = {n: t / microbatches for n, t in acc.items()}
    apply_update(model, opt, loss / microbatches, grads, AdamWConfig())


def _parse_overrides(items):
    out = {}
    for kv in items or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def all_cells() -> list[tuple[bool, str, str]]:
    """``(multi_pod, arch, shape)`` of every ``--all`` cell, in its order."""
    return [(mp, arch, shape) for mp in (False, True)
            for arch in sorted(load_all()) for shape in SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--set", dest="sets", action="append",
                    help="ModelConfig override k=v (hillclimb lever)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    overrides = _parse_overrides(args.sets)

    if not args.all:
        skip = cell_is_skipped(args.arch, args.shape)
        if skip:
            print(json.dumps({"arch": args.arch, "shape": args.shape,
                              "skipped": skip}))
            return
        res = dryrun_cell(args.arch, args.shape, multi_pod=args.multipod,
                          overrides=overrides, microbatches=args.microbatches,
                          fsdp=fsdp, seq_shard=args.seq_shard)
        print(json.dumps(res, indent=2))
        if args.tag:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
                json.dump(res, f, indent=2)
        return

    # one fake group of 512 ranks holds both meshes (16x16 on its first 256)
    init_fake_process_group(512)
    os.makedirs(args.out, exist_ok=True)
    ok = fail = skipped = 0
    for multi_pod, arch, shape_name in all_cells():
        mesh_tag = "multi" if multi_pod else "single"
        tag = f"{arch}.{shape_name}.{mesh_tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            ok += 1
            continue
        skip = cell_is_skipped(arch, shape_name)
        if skip:
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape_name,
                           "mesh": mesh_tag, "skipped": skip}, f)
            skipped += 1
            continue
        t0 = time.perf_counter()
        try:
            res = dryrun_cell(arch, shape_name, multi_pod=multi_pod)
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
            ok += 1
            port = res["port_dispatch"] or {}
            print(f"OK   {tag:48s} {time.perf_counter()-t0:6.1f}s "
                  f"dom={res['roofline']['dominant']:10s} "
                  f"mem={res['memory']['peak_per_device_bytes']/2**30:6.2f}GiB"
                  + (" (dominant: the port's MoE dispatch)"
                     if port.get("dominant_is_port_cost") else ""),
                  flush=True)
        except Exception as e:
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            fail += 1
            print(f"FAIL {tag:48s} {type(e).__name__}: {str(e)[:120]}",
                  flush=True)
    print(f"done: ok={ok} fail={fail} skipped={skipped}")


if __name__ == "__main__":
    main()
