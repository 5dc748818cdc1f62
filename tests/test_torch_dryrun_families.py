"""The port's dry-run of the MoE, SSM and hybrid families held against
the JAX package's on the CPU, through the templates of
``tests/test_torch_dryrun.py`` (both packages in subprocesses: the port
on an 8-rank fake process group, the reference on 8 forced host devices).

Architectures, each ``reduced()`` with one override where the reduced
config would not exercise its placement:

* qwen3-moe-30b-a3b: 4 experts, EP on both meshes;
* grok-1-314b with ``n_experts=6``: TP-in-expert on the (2, 4) mesh
  (6 experts do not divide a ``model`` axis of 4), EP on (2, 2, 2);
* zamba2-7b with ``ssm_heads=4``: ``in_proj``'s width 2 x 256 + 2 x 16 +
  4 = 548 divides a ``model`` axis of 4 (the reduced default, 546, does
  not, and the reference raises);
* xlstm-350m with ``n_layers=4``: one group of three mLSTM blocks and an
  sLSTM block.

Cells: ``mini_train``, ``mini_prefill`` and ``mini_decode`` (64 x 8) on
the (2, 4) and (2, 2, 2) meshes, and for the two recurrent architectures
``mini_long`` (256 x 1 decode: batch under the ``data`` axis, so
``decode_sp``).  Held as in ``test_torch_dryrun.py``: argument bytes
(nothing unread), ``rules_kind``, microbatches and moment dtype equal;
train and prefill FLOPs within ``FLOPS_RTOL``; decode dot FLOPs equal
but for two named terms (:func:`_split_dots`); collectives wherever the
reference has them.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from tests.test_torch_dryrun import FLOPS_RTOL, REPO, run_both

ARCHS = {"qwen3-moe-30b-a3b": {}, "grok-1-314b": {"n_experts": 6},
         "zamba2-7b": {"ssm_heads": 4}, "xlstm-350m": {"n_layers": 4}}
RECURRENT = ("zamba2-7b", "xlstm-350m")
MINI = {"mini_train": (64, 8, "train"), "mini_prefill": (64, 8, "prefill"),
        "mini_decode": (64, 8, "decode"), "mini_long": (256, 1, "decode")}
CELLS = [(a, s, m) for a in ARCHS for s in MINI for m in ("2x4", "2x2x2")
         if s != "mini_long" or a in RECURRENT]


@pytest.fixture(scope="module")
def runs():
    return run_both(ARCHS, MINI, CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_argument_bytes_equal_reference(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    assert port["memory"]["unread_argument_bytes"] == 0
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert port["memory"]["peak_per_device_bytes"] >= \
        port["memory"]["argument_bytes"]
    assert port["n_params"] == ref["n_params"]
    assert port["rules_kind"] == ref["rules_kind"] == (
        "decode_sp" if cell[1] == "mini_long" else MINI[cell[1]][2])
    assert port["microbatches"] == ref["microbatches"]
    assert port["moment_dtype"] == ref["moment_dtype"]


def _split_dots(cell) -> int:
    """The named terms of the decode dots, products that XLA splits over
    one more mesh axis than the port:

    * zamba2: the Mamba2 scan's C.B product (``"bjn,bin->bji"``, one
      position), which XLA splits by state over ``model`` and the port
      computes whole beside each rank's heads, 2 x rows x N a layer;
    * xlstm in ``decode_sp`` on the (2, 2, 2) mesh (batch whole, so
      ``pod`` and ``data`` split no activation): XLA splits the mLSTM's
      q, k and v products' input 4 ways (the port's is whole) and its
      gate product's output 2 ways (the port's is whole)."""
    arch, shape, mesh = cell
    model = 4 if mesh == "2x4" else 2
    # decode_sp keeps the one row whole; else 8 rows over pod x data
    rows = 1 if shape == "mini_long" else 8 // (8 // model)
    if arch == "zamba2-7b":
        layers, state = 4, 16               # reduced()
        return layers * 2 * rows * state * (model - 1) // model
    if (arch, shape, mesh) == ("xlstm-350m", "mini_long", "2x2x2"):
        n_run, di, heads = 3, 256, 4        # reduced(), n_layers=4
        qkv = 3 * 2 * di * (di // model)    # batch 1
        gates = 2 * (di // model) * 2 * heads
        return n_run * (qkv * 3 // 4 + gates // 2)
    return 0


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_flops_per_chip_near_reference(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    flops = port["roofline"]["flops_per_chip"]
    assert flops == port["op_cost"]["flops"] >= port["op_cost"]["dot_flops"] > 0
    if port["kind"] == "decode":
        assert port["op_cost"]["dot_flops"] - _split_dots(cell) == \
            ref["dot_flops"]
        return
    rflops = ref["roofline"]["flops_per_chip"]
    assert abs(flops - rflops) <= FLOPS_RTOL * rflops, (flops, rflops)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_port_dispatch_counted_apart(runs, cell):
    """The sorted MoE dispatch's whole-buffer sums are counted apart, a
    part of the cell's collectives, and the roofline without them has
    what the cell's has but their bytes; other families have none."""
    port = runs[0][cell]
    pd = port["port_dispatch"]
    if cell[0] not in ("qwen3-moe-30b-a3b", "grok-1-314b"):
        assert pd is None
        return
    rf = port["roofline"]
    assert 0 < pd["collective_bytes"] <= rf["collective_bytes_per_chip"]
    assert pd["without"]["compute_s"] == rf["compute_s"]
    assert pd["without"]["collective_s"] + pd["collective_s"] == \
        pytest.approx(rf["collective_s"])
    assert pd["dominant_is_port_cost"] == (
        pd["without"]["dominant"] != rf["dominant"])


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_collectives_where_the_reference_has_them(runs, cell):
    port, ref = runs[0][cell], runs[1][cell]
    assert sum(ref["collectives"].values()) > 0
    assert port["roofline"]["collective_bytes_per_chip"] > 0
    assert sum(port["collectives"].values()) == \
        port["roofline"]["collective_bytes_per_chip"]
    assert set(port["collectives"]) <= {"all-reduce", "all-gather",
                                        "reduce-scatter", "all-to-all"}


LOOPS = """
    import contextlib, json
    import repro_torch.configs.base as base
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, ssm
    archs = base.load_all()
    archs["xlstm-350m"] = base.reduced(archs["xlstm-350m"]).replace(
        n_layers=4)
    base.SHAPES["mini_prefill"] = base.ShapeConfig("mini_prefill", 64, 8,
                                                   "prefill")
    for m, mesh in (("2x4", make_host_mesh(2, 4)),
                    ("2x2x2", make_host_mesh(2, 2, 2))):
        for repeat in (True, False):
            # the dry-run's loop, or one that runs every iteration
            ssm.counted_loop = layers.counted_loop if repeat else (
                lambda n: contextlib.nullcontext(layers.Loop(n)))
            r = dr.dryrun_cell("xlstm-350m", "mini_prefill", mesh=mesh)
            print(json.dumps({"mesh": m, "repeat": repeat,
                              "op_cost": r["op_cost"],
                              "collectives": r["collectives"],
                              "peak": r["memory"]["peak_per_device_bytes"]}))
"""


@pytest.fixture(scope="module")
def loops():
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(LOOPS)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return {(r["mesh"], r["repeat"]): r for r in map(
        json.loads, filter(lambda s: s.startswith("{"),
                           out.stdout.splitlines()))}


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_loop_counted_by_trip_count_equals_untraced_loop(loops, mesh):
    """The sLSTM's 64-step loop over positions in an xLSTM prefill, traced
    once and counted 64 times, counts what the whole loop counts, and its
    reckoned peak is no lower."""
    once, whole = loops[mesh, True], loops[mesh, False]
    assert (once["op_cost"]["loops_repeated"],
            whole["op_cost"]["loops_repeated"]) == (1, 0)  # one sLSTM block
    for key in ("flops", "dot_flops", "bytes_accessed", "ops"):
        assert once["op_cost"][key] == whole["op_cost"][key], key
    assert once["collectives"] == whole["collectives"]
    assert once["peak"] >= whole["peak"]
