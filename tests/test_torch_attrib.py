"""The port's step attribution held against the reference's (paper §4.1.3).

The same train step on both sides: reduced qwen3-0.6b (``remat`` off,
causal attention in the default ``"masked"`` mode, chunks of 16), batch
4 x 32, ``AdamWConfig()``, at 2 and at 4 layers.  The reference compiles
it (``jax.jit(...).lower(...).compile()`` on the CPU) and attributes the
compiled HLO (``hlo_attrib.attribute``, ``build_structure``, its
``Profiler.attribute_compiled`` with ``cost_analysis``' FLOPs, as its
train launcher does).  The port runs it once on a ``meta`` twin under
``dispatch_attrib.trace_step`` and attributes the records
(``Profiler.attribute_step``), as ``launch/train.py::attribute_step``
does.

What is held, at each depth:

* both split the step into forward, backward and update, each with
  work: the reference by scope (``transpose(jvp(`` backward, ``jvp(``
  forward, the rest the update), the port by ``path[1]``;
* FLOPs.  The reference's loop-aware dot FLOPs (``hlo_cost.HloCostModel``
  with only dot and convolution instructions counted through fusions,
  loops and calls) equal the port's ``trace_step`` FLOPs plus the
  attention scores the reference computes twice: its kv step runs under
  ``jax.checkpoint`` (reference ``models/layers.py:116-121``), so its
  backward recomputes Q.K^T for every (q block, kv block) pair, L x 2 x
  B x H x S x S x hd in ``"masked"`` mode (2,097,152 at 2 layers).  The
  port's eager loop keeps the forward's scores for autograd.  The
  counting of ``tests/test_torch_dryrun.py`` also keeps a ``call``
  instruction's result elements as FLOPs (83 here: its tuple of s32[],
  pred[2,1,16], s32[2,1,16], s32[2] and s32[16]); with it the gap is
  the 2,097,235 first measured at 2 layers;
* the two profiles' ``dev.flops`` totals.  The port's is what the step
  runs.  The reference's is ``cost_analysis``' total, which counts each
  ``while`` body once (reference ``analysis/hlo_cost.py:3-5``): it lies
  between the dot FLOPs and all the FLOPs of the step with every loop
  counted once, and is 1.65x smaller than the port's at 2 layers, 2.92x
  at 4;
* the reference's structure file has fusions with several routes, one a
  scope (the multi-route reconstruction); the port's has none, since
  eager ops are not fused.  A recorded difference, not a target.

The numbers are in ``PERF.md`` §6.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import hlo_cost
from repro.configs.base import get_arch as rget_arch
from repro.configs.base import reduced as rreduced
from repro.data import TokenPipeline
from repro.models import params as PD
from repro.models.api import build_model as rbuild_model
from repro.profiling import Profiler as RProfiler
from repro.profiling import hlo_attrib
from repro.train.loop import make_train_step as rmake_train_step
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import init_opt_state as rinit_opt_state
from repro.utils.jaxcompat import cost_analysis_dict
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models.api import build_model
from repro_torch.profiling import Profiler, dispatch_attrib
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

ARCH, BATCH, SEQ = "qwen3-0.6b", 4, 32
# the port's dev.flops total over cost_analysis' at each depth
CA_RATIO = {2: 1.650, 4: 2.920}
PHASES = {"forward", "backward", "update"}


def _count(text: str, *, calls: bool = False, trips: bool = True) -> float:
    """The dot and convolution FLOPs of compiled HLO ``text`` through
    fusions, loops (by trip count, or once) and calls; with ``calls`` also
    each ``call``'s result elements, as ``tests/test_torch_dryrun.py``
    counts."""
    model = hlo_cost.HloCostModel(text)
    if not trips:
        model.trip_count = lambda cond: 1
    inner = model._instr_cost

    def only_dots(ins, *, in_fusion):
        c = inner(ins, in_fusion=in_fusion)
        if ins.opcode not in ("dot", "convolution", "fusion", "while",
                              "call", "conditional"):
            c.flops = 0.0
        elif ins.opcode == "call" and not calls:
            c.flops -= hlo_cost._elems_and_bytes(ins.result)[0]
        return c

    model._instr_cost = only_dots
    return model.entry_cost().flops


def _all_once(text: str) -> float:
    """Every FLOP the reference's cost model counts, each loop once."""
    model = hlo_cost.HloCostModel(text)
    model.trip_count = lambda cond: 1
    return model.entry_cost().flops


def _flops_total(prof) -> float:
    mid = prof.registry["dev.flops"].mid
    return sum(v for (_, m), v in prof._acc.items() if m == mid)


def _routes(struct_dir) -> dict:
    with open(struct_dir / "step.struct.json") as f:
        return json.load(f)["ops"]


def _ref_phase(scope: str) -> str:
    if "transpose(jvp(" in scope:
        return "backward"
    return "forward" if "jvp(" in scope else "update"


def _reference(layers: int, struct_dir) -> dict:
    cfg = rreduced(rget_arch(ARCH)).replace(n_layers=layers)
    model = rbuild_model(cfg)
    params = PD.init_params(model.param_defs(), 0, jnp.float32)
    opt = rinit_opt_state(params)
    tokens = jnp.asarray(TokenPipeline(cfg.vocab_size, SEQ,
                                       BATCH).batch_at(0))
    compiled = jax.jit(rmake_train_step(model, RAdamWConfig())).lower(
        params, opt, {"tokens": tokens}).compile()
    text = compiled.as_text()
    ca = cost_analysis_dict(compiled)["flops"]
    prof = RProfiler({"rank": 0, "stream": 0, "kind": "host"})
    prof.attribute_compiled(text, measured={"flops": ca},
                            struct_dir=str(struct_dir))
    recs = hlo_attrib.parse_hlo(text)
    by_phase = dict.fromkeys(PHASES, 0)
    for r in recs:
        by_phase[_ref_phase(r.scope)] += r.out_bytes
    agg = hlo_attrib.attribute(text)
    return {"cost_analysis": ca, "dev_flops": _flops_total(prof),
            "dots": _count(text), "dots_calls": _count(text, calls=True),
            "dots_once": _count(text, trips=False),
            "all_once": _all_once(text), "bytes": by_phase,
            "scopes": len(agg), "ops": int(sum(a["count"]
                                               for a in agg.values())),
            "fusions": sum(r.opcode == "fusion" for r in recs),
            "routes": _routes(struct_dir)}


def _port(layers: int, struct_dir) -> dict:
    cfg = reduced(get_arch(ARCH)).replace(n_layers=layers)
    meta = build_model(cfg, device="meta")
    opt = init_opt_state(dict(meta.named_parameters()))
    tokens = torch.empty((BATCH, SEQ), dtype=torch.int32, device="meta")
    records, flops = dispatch_attrib.trace_step(
        make_train_step(meta, AdamWConfig()), opt, {"tokens": tokens})
    prof = Profiler({"rank": 0, "stream": 0, "kind": "host"})
    prof.attribute_step(records, measured={"flops": flops},
                        struct_dir=str(struct_dir))
    by_phase = dict.fromkeys(PHASES, 0)
    for r in records:
        by_phase[r.path[1][1]] += r.out_bytes
    return {"flops": flops, "dev_flops": _flops_total(prof),
            "bytes": by_phase,
            "scopes": len(dispatch_attrib.attribute(records)),
            "ops": len(records), "routes": _routes(struct_dir)}


def _scores_recomputed(layers: int) -> int:
    """Q.K^T over every (q block, kv block) pair, once a layer: what the
    reference's ``jax.checkpoint``-ed kv step recomputes in its
    backward."""
    cfg = rreduced(rget_arch(ARCH))
    return layers * 2 * BATCH * cfg.n_heads * SEQ * SEQ * cfg.head_dim


@pytest.fixture(scope="module", params=[2, 4], ids=["2_layers", "4_layers"])
def sides(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"attrib{request.param}")
    (d / "ref").mkdir()
    (d / "port").mkdir()
    return (request.param, _reference(request.param, d / "ref"),
            _port(request.param, d / "port"))


def test_both_split_the_step_into_its_phases(sides):
    _, ref, port = sides
    for side in (ref, port):
        assert set(side["bytes"]) == PHASES
        assert all(v > 0 for v in side["bytes"].values()), side["bytes"]


def test_step_flops_equal_the_reference_loop_aware_dot_flops(sides):
    """Exact, once the reference's recomputed scores are added to the
    port's FLOPs; the dry-run test's counting adds the ``call``'s
    elements on top."""
    layers, ref, port = sides
    remat = _scores_recomputed(layers)
    assert ref["dots"] == port["flops"] + remat
    assert 0 < ref["dots_calls"] - ref["dots"] < 100
    if layers == 2:
        assert remat == 2_097_152
        assert ref["dots_calls"] - port["flops"] == 2_097_235
    assert abs(ref["dots"] - port["flops"]) / ref["dots"] < 0.01


def test_dev_flops_gap_is_the_loop_counted_once(sides):
    """The port's profile carries the step's FLOPs; the reference's
    carries ``cost_analysis``' total, which counts each loop body once:
    it lies between the step's dot FLOPs and all its FLOPs with every
    loop counted once, and far below the loop-aware dot FLOPs."""
    layers, ref, port = sides
    assert port["dev_flops"] == pytest.approx(port["flops"], rel=1e-9)
    assert ref["dev_flops"] == pytest.approx(ref["cost_analysis"], rel=1e-9)
    assert ref["dots_once"] <= ref["cost_analysis"] <= ref["all_once"]
    assert ref["cost_analysis"] < ref["dots"]
    assert port["dev_flops"] / ref["dev_flops"] == pytest.approx(
        CA_RATIO[layers], abs=0.005)


def test_only_the_reference_has_multi_route_fusions(sides):
    """The reference's fusions that span several scopes get one weighted
    route a scope (weights summing to 1); the port's ops have one route
    each."""
    _, ref, port = sides
    multi = {op: r for op, r in ref["routes"].items() if len(r) > 1}
    assert ref["fusions"] > 0 and multi
    for routes in multi.values():
        assert sum(r["weight"] for r in routes) == pytest.approx(1.0)
    assert all(len(r) == 1 for r in port["routes"].values())
    assert len(port["routes"]) == port["ops"]


def table(struct_root) -> list[dict]:
    """The figures ``PERF.md`` §6 records, one row a depth."""
    rows = []
    for layers in (2, 4):
        (struct_root / f"ref{layers}").mkdir()
        (struct_root / f"port{layers}").mkdir()
        ref = _reference(layers, struct_root / f"ref{layers}")
        port = _port(layers, struct_root / f"port{layers}")
        rows.append({
            "layers": layers,
            "dev_flops": [ref["dev_flops"], port["dev_flops"]],
            "loop_aware_dots": [ref["dots_calls"], ref["dots"],
                                port["flops"]],
            "recomputed_scores": _scores_recomputed(layers),
            "dots_once_all_once": [ref["dots_once"], ref["all_once"]],
            "scopes_ops": [[ref["scopes"], ref["ops"]],
                           [port["scopes"], port["ops"]]],
            "bytes": [ref["bytes"], port["bytes"]],
            "fusions": ref["fusions"],
            "multi_route_ops": [
                sum(len(r) > 1 for r in ref["routes"].values()),
                len(ref["routes"])]})
    return rows


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_attrib.py
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for row in table(pathlib.Path(tmp)):
            print(json.dumps(row))
