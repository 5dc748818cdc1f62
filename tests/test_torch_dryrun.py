"""The port's dry-run held against the JAX package's on the CPU.

The reference's mini cells (``tests/test_distributed.py``: ``mini_train``
and ``mini_decode`` of a reduced qwen3-0.6b on a (2, 4) and a (2, 2, 2)
mesh), with ``mini_prefill`` and the reduced llama-3.2-vision-11b and
whisper-small beside them, run in both packages, each in a subprocess
(the port on an 8-rank fake process group, the reference on 8 forced
host devices; ``tests/test_torch_dryrun_families.py`` runs the MoE, SSM
and hybrid families through the same two templates):

* ``memory.argument_bytes`` equals the reference's ``argument_bytes``
  exactly (parameters, moments and the int32 step, or the cache with its
  int32 ``len``, and the batch; the largest device's shards), but for
  one named term: the parameters a step never reads, which ``jax.jit``
  drops from its arguments (whisper's encoder in decode);
* ``roofline.flops_per_chip`` is within ``FLOPS_RTOL`` of the
  reference's on the train and prefill cells.  On the decode cells the
  reference's count adds, for every layer its scan visits, the
  dynamic-slice of each stacked weight and whole-buffer copies of the KV
  cache, which the port (one module per layer, the cache written in
  place) does not do; there the port's dot FLOPs must equal the
  reference's, counted by its own ``hlo_cost`` over the ``dot``
  instructions alone;
* the collective bytes are positive wherever the reference's are.

The cell list and the skips equal the reference's, and the
counterparts of ``tests/test_roofline.py`` hold for
:mod:`repro_torch.analysis.op_cost` and the Hopper roofline.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import roofline
from repro_torch.analysis.op_cost import OpCostMode
from repro_torch.launch import dryrun
from repro_torch.models.layers import cost_scope, counted_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-0.6b", "llama-3.2-vision-11b", "whisper-small")
MINI = {"mini_train": (64, 8, "train"), "mini_prefill": (64, 8, "prefill"),
        "mini_decode": (64, 8, "decode")}
MESHES = ("2x4", "2x2x2")
CELLS = [(a, s, m) for a in ARCHS for s in MINI for m in MESHES]
FLOPS_RTOL = 0.25

_SETUP = """
    import json
    import {pkg}.configs.base as base
    archs = base.load_all()
    for a, over in {archs!r}.items():
        archs[a] = base.reduced(archs[a]).replace(**over)
    for name, (seq, batch, kind) in {mini!r}.items():
        base.SHAPES[name] = base.ShapeConfig(name, seq, batch, kind)
"""

PORT = _SETUP + """
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    meshes = {{"2x4": make_host_mesh(2, 4), "2x2x2": make_host_mesh(2, 2, 2)}}
    for arch, shape, m in {cells!r}:
        r = dr.dryrun_cell(arch, shape, mesh=meshes[m])
        print(json.dumps({{"cell": [arch, shape, m], "res": r}}))
"""

REFERENCE = _SETUP + """
    import jax
    import repro.launch.mesh as mesh_mod
    from repro.analysis import hlo_cost, roofline
    mesh_mod.make_production_mesh = lambda multi_pod=False: (
        jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                      **mesh_mod._mesh_kwargs(3)) if multi_pod else
        jax.make_mesh((2, 4), ("data", "model"), **mesh_mod._mesh_kwargs(2)))
    import repro.launch.dryrun as dr
    dr.make_production_mesh = mesh_mod.make_production_mesh

    dots = {{}}
    analyze = roofline.analyze

    def counting(compiled, **kw):
        # the dot instructions' FLOPs alone, trip counts included
        model = hlo_cost.HloCostModel(compiled.as_text())
        inner = model._instr_cost

        def only_dots(ins, *, in_fusion):
            c = inner(ins, in_fusion=in_fusion)
            if ins.opcode not in ("dot", "convolution", "fusion", "while",
                                  "call", "conditional"):
                c.flops = 0.0
            return c

        model._instr_cost = only_dots
        dots["last"] = model.entry_cost().flops
        return analyze(compiled, **kw)

    dr.roofline.analyze = counting
    for arch, shape, m in {cells!r}:
        r = dr.dryrun_cell(arch, shape, multi_pod=m == "2x2x2")
        r["dot_flops"] = dots["last"]
        print(json.dumps({{"cell": [arch, shape, m], "res": r}}))
    cells = [[mp, a, s] for mp in (False, True)
             for a in sorted(base.load_all()) for s in base.SHAPES
             if not s.startswith("mini")]
    print(json.dumps({{"cells": cells, "skips": [
        dr.cell_is_skipped(a, s) for _, a, s in cells]}}))
"""


def _start(code: str, pkg: str, env_extra: dict, archs: dict, mini: dict,
           cells: list) -> subprocess.Popen:
    """``code`` in a subprocess, for ``cells`` of the reduced ``archs``
    (each with its overrides) and the ``mini`` shapes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", **env_extra)
    src = textwrap.dedent(code.format(pkg=pkg, archs=archs, mini=mini,
                                      cells=cells))
    return subprocess.Popen([sys.executable, "-c", src], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _collect(proc: subprocess.Popen) -> list[dict]:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def run_both(archs: dict, mini: dict, cells: list):
    """Both packages' results of ``cells``, the two subprocesses run side
    by side: the port's and the reference's, by cell, and the
    reference's listing of every production cell and its skip."""
    port = _start(PORT, "repro_torch", {}, archs, mini, cells)
    ref = _start(REFERENCE, "repro", {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
        archs, mini, cells)
    p, r = _collect(port), _collect(ref)
    pcells = {tuple(x["cell"]): x["res"] for x in p}
    rcells = {tuple(x["cell"]): x["res"] for x in r if "cell" in x}
    listing = next(x for x in r if "cells" in x)
    return pcells, rcells, listing


@pytest.fixture(scope="module")
def runs():
    """Both packages' results of every mini cell."""
    return run_both({a: {} for a in ARCHS}, MINI, CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_argument_bytes_equal_reference(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    # jax.jit drops the arguments a step never reads (keep_unused=False):
    # in whisper's decode, the encoder's weights and the cross-attention's
    # key and value projections.  The port's cards hold them, and the
    # dry-run names them apart.
    unread = port["memory"]["unread_argument_bytes"]
    assert (unread > 0) == (cell[0] == "whisper-small"
                            and cell[1] == "mini_decode")
    assert port["memory"]["argument_bytes"] - unread == \
        ref["memory"]["argument_bytes"]
    assert port["memory"]["peak_per_device_bytes"] >= \
        port["memory"]["argument_bytes"]
    assert port["n_params"] == ref["n_params"]
    assert port["rules_kind"] == ref["rules_kind"]
    assert port["microbatches"] == ref["microbatches"]
    assert port["moment_dtype"] == ref["moment_dtype"]


def _vision_kv_extra(cell) -> int:
    """The one named term of the decode dots: where the VLM's kv heads do
    not split the model axis (2 of them on the (2, 4) mesh), each rank
    projects the vision embeddings to every kv head's keys and values and
    reads its own, while XLA projects only that head's."""
    arch, _, mesh = cell
    if arch != "llama-3.2-vision-11b" or mesh != "2x4":
        return 0
    rows, vt, d, kvh, hd = 8 // 2, 16, 128, 2, 32  # reduced(): B/data, ...
    return 2 * (2 * rows * vt * d * hd) * (kvh - 1)  # k and v


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_flops_per_chip_near_reference(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    flops = port["roofline"]["flops_per_chip"]
    assert flops == port["op_cost"]["flops"] >= port["op_cost"]["dot_flops"] > 0
    if port["kind"] == "decode":
        assert port["op_cost"]["dot_flops"] - _vision_kv_extra(cell) == \
            ref["dot_flops"]
        return
    rflops = ref["roofline"]["flops_per_chip"]
    assert abs(flops - rflops) <= FLOPS_RTOL * rflops, (flops, rflops)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_collectives_where_the_reference_has_them(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    if sum(ref["collectives"].values()) > 0:
        assert port["roofline"]["collective_bytes_per_chip"] > 0
        assert sum(port["collectives"].values()) == \
            port["roofline"]["collective_bytes_per_chip"]
    assert set(port["collectives"]) <= {"all-reduce", "all-gather",
                                        "reduce-scatter", "all-to-all"}


def test_cells_and_skips_equal_reference(runs):
    listing = runs[2]
    cells = [[mp, a, s] for mp, a, s in dryrun.all_cells()]
    assert cells == listing["cells"]
    assert [dryrun.cell_is_skipped(a, s) for _, a, s in cells] == \
        listing["skips"]


def _count(fn, *args) -> "OpCostMode":
    mode = OpCostMode()
    with mode:
        fn(*args)
    return mode.cost


def test_dot_flops_with_batch_dims():
    a = torch.empty(4, 64, 128, device="meta")
    b = torch.empty(4, 128, 32, device="meta")
    cost = _count(lambda x, y: torch.einsum("bij,bjk->bik", x, y), a, b)
    assert cost.dot_flops == 2 * 4 * 64 * 128 * 32
    assert cost.bytes > 0 and cost.coll_bytes == 0


def test_chained_matmuls_count_each():
    x = torch.empty(256, 256, device="meta")
    w = torch.empty(256, 256, device="meta")

    def chain(x, w, n):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x.sum()

    one, eight = _count(chain, x, w, 1), _count(chain, x, w, 8)
    assert one.dot_flops == 2 * 256 ** 3
    assert eight.dot_flops == 8 * one.dot_flops
    assert eight.flops == pytest.approx(8 * (one.flops - 256 * 256)
                                        + 256 * 256)


def test_repeat_scales_what_it_counts():
    x = torch.empty(64, 64, device="meta")
    mode = OpCostMode()
    with mode:
        with mode.repeat(8):
            x @ x
        x @ x
    assert mode.cost.dot_flops == 9 * 2 * 64 ** 3


def test_scope_counts_collectives_and_their_backward_apart():
    all_reduce = torch.ops._c10d_functional.all_reduce

    class Sum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return all_reduce(t, "sum", "0")

        @staticmethod
        def backward(ctx, g):
            return all_reduce(g, "sum", "0")

    x = torch.empty(256, device="meta", requires_grad=True)  # 1 KiB
    mode = OpCostMode()
    with mode:
        with cost_scope("dispatch"):
            y = Sum.apply(x * 2)
        Sum.apply(y * 3).sum().backward()
    assert mode.cost.coll_by_kind == {"all-reduce": 4 * 1024}
    assert mode.cost.coll_by_scope == {"dispatch": 2 * 1024}


@pytest.mark.parametrize("grad", [False, True])
def test_counted_loop_traces_one_iteration_without_gradient(grad):
    x = torch.empty(64, 64, device="meta", requires_grad=grad)
    mode = OpCostMode()
    with mode, torch.set_grad_enabled(grad), counted_loop(8) as loop:
        for _ in range(loop.steps):
            x @ x
    assert loop.steps == (8 if grad else 1)
    assert mode.cost.loops_repeated == (0 if grad else 1)
    assert mode.cost.dot_flops == 8 * 2 * 64 ** 3
    with counted_loop(8) as loop:  # no counter active
        assert loop.steps == 8


def test_peak_counts_live_storage():
    mode = OpCostMode()
    x = torch.empty(1024, device="meta")  # 4 KiB
    with mode:
        mode.track([x])
        y = x * 2          # 8 KiB alive
        del y
        z = x + 1          # 8 KiB again, never 12
        del z
    assert mode.cost.peak_bytes == 2 * 4096


def test_roofline_terms_with_hopper_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_CAPACITY) == (989e12, 3.35e12, 50e9, 80e9)

    class Cost:
        flops, bytes, coll_bytes = 989e12, 3.35e12, 50e9
        coll_by_kind = {"all-reduce": 50e9}

    rf = roofline.analyze(Cost, n_chips=4, model_flops=989e12 * 4)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 1.0, 1.0)
    assert rf.bound_s == 1.0
    assert rf.useful_fraction == pytest.approx(1.0)
    assert rf.mfu_bound == pytest.approx(1.0)
    assert rf.coll_by_kind == {"all-reduce": 50e9}
    Cost.bytes = 2 * 3.35e12
    assert roofline.analyze(Cost, n_chips=4).dominant == "memory"
    assert set(rf.to_dict()) == {
        "flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_per_chip",
        "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
        "n_chips", "useful_fraction", "mfu_bound"}
