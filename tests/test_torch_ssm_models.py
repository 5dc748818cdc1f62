"""The port's SSM and hybrid models on the CPU, held against the JAX
package on the same inputs: loss and gradients of zamba2 (groups of
shared attention, plain Mamba2, a partial last group) and xLSTM (with and
without sLSTM blocks, and the unused-mLSTM quirk); the published chunk of
256, where the reference's gradient is not finite; remat; parameter trees
and counts; three AdamW steps; the step's attribution on ``meta``; and the
launcher end to end with a profile and checkpoints crossing between the
packages.

Sizes are ``reduced(...)`` (width 128, vocab 512, chunk 8, f32).
Parameters come from ``repro.models.params.init_params`` and are carried
across with ``repro_torch.models.params.from_reference``; tokens come from
the data pipeline.  The reference's gradients are ``jax.jit`` of
``jax.value_and_grad``.  Tolerances are stated at each test: they allow
for the two frameworks' summation orders, nothing more.
"""
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs.base import get_arch as rget_arch
from repro.configs.base import reduced as rreduced
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.data import TokenPipeline as RTokenPipeline
from repro.launch import analyze as ranalyze
from repro.models import params as rparams
from repro.models.api import build_model as rbuild_model
from repro.models.api import model_flops as rmodel_flops
from repro.models.api import n_params as rn_params
from repro.train import loop as rloop
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import adamw_update as radamw_update
from repro.train.optimizer import init_opt_state as rinit_opt_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.data import TokenPipeline
from repro_torch.launch import analyze
from repro_torch.launch import train as launch_train
from repro_torch.models import params as P
from repro_torch.models.api import build_model, model_flops, n_params
from repro_torch.models.ssm import MambaLM, XLSTMLM
from repro_torch.profiling import Profiler
from repro_torch.train import loop
from repro_torch.train.optimizer import AdamWConfig, global_norm

HYBRID = "zamba2-7b"
XLSTM = "xlstm-350m"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """``{path: f32 numpy array}`` of a reference-layout tree of either
    package."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32)
            for k, v in P.flatten(tree)}


@functools.lru_cache(maxsize=None)
def _ref(arch, **kw):
    """The reference's reduced config, model and parameters (one object
    each per case, so its jitted functions are compiled once a file)."""
    cfg = rreduced(rget_arch(arch)).replace(**kw)
    model = rbuild_model(cfg)
    return cfg, model, rparams.init_params(model.param_defs(), 0,
                                           jnp.dtype(cfg.dtype))


def _port(tree, arch, **kw):
    model = build_model(reduced(get_arch(arch)).replace(**kw))
    return P.from_reference(model, _np_tree(tree))


def _tokens(cfg, batch=4, seq=32, step=0):
    return RTokenPipeline(cfg.vocab_size, seq, batch).batch_at(step)


@functools.lru_cache(maxsize=None)
def _jitted(rmodel):
    """``(value_and_grad, loss)`` of the reference's loss, jitted."""
    return (jax.jit(jax.value_and_grad(rmodel.loss_fn)),
            jax.jit(rmodel.loss_fn))


def _ref_value_and_grad(rmodel, tree, tokens):
    return _jitted(rmodel)[0](tree, {"tokens": jnp.asarray(tokens)})


def _assert_grads_match(grads, rgrads, tol=1e-5):
    """Every gradient within ``tol`` relative, plus ``tol`` of its
    tensor's largest entry (at least ``tol``): the embedding's gradient
    sums over every position through ``1/rms`` of a 0.02-scale input and
    reaches ~2.7, where f32 rounding alone differs by 3e-5 (both packages
    against an f64 run differ by that much)."""
    want = _leaves(_np_tree(rgrads))
    got = _leaves(P.stack(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        atol = tol * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

MODEL_CASES = [
    (HYBRID, {}),                    # 4 layers, 2 groups of 2
    (HYBRID, {"attn_every": 0}),     # plain Mamba2
    (HYBRID, {"n_layers": 5}),       # groups of 2, 2 and 1
    (XLSTM, {}),                     # 2 mLSTM, no sLSTM (2 // 4 = 0)
    (XLSTM, {"n_layers": 8}),        # 2 groups of 3 mLSTM + 1 sLSTM
    (XLSTM, {"n_layers": 5}),        # 4 mLSTM defined, 3 run, 1 sLSTM
]


def _case_id(case):
    arch, kw = case
    return "-".join([arch, *(f"{k}={v}" for k, v in kw.items())])


@pytest.mark.parametrize("arch,kw", MODEL_CASES,
                         ids=[_case_id(c) for c in MODEL_CASES])
def test_loss_and_gradients_match_reference(arch, kw):
    """Chunk 8 over 4 x 32 tokens (4 chunks a row): loss within 1e-5
    relative, gradients as ``_assert_grads_match`` states.  With 5 xLSTM
    layers the fourth mLSTM block never runs and its gradient is zero in
    both packages."""
    cfg, rmodel, tree = _ref(arch, **kw)
    tokens = _tokens(cfg)
    rloss, rgrads = _ref_value_and_grad(rmodel, tree, tokens)
    model = _port(tree, arch, **kw)
    loss, grads = loop.value_and_grad(model, {"tokens": torch.from_numpy(
        tokens)})
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    _assert_grads_match(grads, rgrads)
    if kw.get("n_layers") == 5 and arch == XLSTM:
        assert (model.n_mlstm, model.n_slstm, model.per_group) == (4, 1, 3)
        assert all(not g.any() for n, g in grads.items()
                   if n.startswith("mlstm.3."))


@pytest.mark.parametrize("arch", [HYBRID, XLSTM])
def test_published_chunk_gives_finite_gradients(arch):
    """``ssm_chunk=256`` over 2 x 256 tokens (one whole chunk a row), as
    the published configs run: the reference's loss is right but most of
    its gradient leaves are not finite (19 of 21 for zamba2, 9 of 11 for
    xLSTM: asserted, as a record of the reference); the port's loss
    equals the reference's at 256 (1e-5 relative) and its gradients are
    finite and equal the reference's at chunk 8 (as
    ``_assert_grads_match``, over 1e-4: the two chunkings sum in other
    orders)."""
    cfg, rmodel, tree = _ref(arch, ssm_chunk=256)
    tokens = _tokens(cfg, batch=2, seq=256)
    rloss, rgrads = _ref_value_and_grad(rmodel, tree, tokens)
    leaves = _leaves(_np_tree(rgrads))
    bad = [k for k, v in leaves.items() if not np.isfinite(v).all()]
    assert (len(bad), len(leaves)) == {HYBRID: (19, 21), XLSTM: (9, 11)}[arch]
    _, rgrads8 = _ref_value_and_grad(_ref(arch)[1], tree, tokens)
    model = _port(tree, arch, ssm_chunk=256)
    loss, grads = loop.value_and_grad(model, {"tokens": torch.from_numpy(
        tokens)})
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert all(torch.isfinite(g).all() for g in grads.values())
    want, got = _leaves(_np_tree(rgrads8)), _leaves(P.stack(grads))
    for k in want:
        atol = 1e-4 * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("arch,kw", [(HYBRID, {"n_layers": 5}),
                                     (XLSTM, {"n_layers": 8})],
                         ids=["hybrid", "ssm"])
def test_remat_changes_no_bits(arch, kw):
    """``cfg.remat`` recomputes each checkpointed layer (each Mamba2 or
    mLSTM block) in the backward pass: loss and gradients bit-equal to
    the run without it."""
    cfg, _, tree = _ref(arch, **kw)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    (l0, g0), (l1, g1) = (loop.value_and_grad(
        _port(tree, arch, remat=r, **kw), batch) for r in (False, True))
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# parameter trees and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [(HYBRID, {"n_layers": 5}),
                                     (HYBRID, {"attn_every": 0}),
                                     (XLSTM, {"n_layers": 8})],
                         ids=["hybrid", "mamba2", "ssm"])
def test_param_tree_round_trips_bit_for_bit(arch, kw):
    """The reference tree -> the port's modules -> the reference layout:
    the same paths and bits; ``layers``, ``mlstm`` and ``slstm`` split and
    stacked again, ``shared_attn`` as it is."""
    _, _, tree = _ref(arch, **kw)
    model = _port(tree, arch, **kw)
    want = _leaves(_np_tree(tree))
    got = _leaves(P.to_reference(model))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    defs = {k: d.shape for k, d in P.flatten(model.param_defs())}
    assert defs == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch,cls,count", [
    (HYBRID, MambaLM, 6_751_078_992), (XLSTM, XLSTMLM, 480_867_328)])
def test_counts_equal_reference_at_full_size(arch, cls, count):
    """Built on ``meta`` at full size: the class the reference dispatches
    to, its parameter count and its train/prefill/decode FLOPs."""
    cfg, rcfg = get_arch(arch), rget_arch(arch)
    model = build_model(cfg, device="meta")
    assert type(model) is cls
    assert n_params(cfg) == rn_params(rcfg) == count
    assert sum(p.numel() for p in model.parameters()) == count
    for kind, seq in (("train", 512), ("prefill", 512), ("decode", 4096)):
        assert model_flops(cfg, ShapeConfig("s", seq, 8, kind)) == \
            rmodel_flops(rcfg, RShapeConfig("s", seq, 8, kind))


def test_published_counts_and_groups():
    """The figures the chip phases quote: zamba2-7b cut to 13 of 81
    layers (3 shared-attention applications over groups of 6, 6 and 1),
    the whole model's 13 groups of 6 and one of 3, its 2-layer parity cut,
    and xlstm-350m whole (18 mLSTM + 6 sLSTM) and cut to 4 blocks."""
    z13 = get_arch(HYBRID).replace(n_layers=13)
    assert n_params(z13) == 1_448_614_160
    m = build_model(z13, device="meta")
    assert m.groups == [(0, 6), (6, 12), (12, 13)] and m.n_attn_apps == 3
    full = build_model(get_arch(HYBRID), device="meta")
    assert len(full.groups) == 14 and full.groups[-1] == (78, 81)
    assert n_params(get_arch(HYBRID).replace(n_layers=2)) == \
        rn_params(rget_arch(HYBRID).replace(n_layers=2))
    x = build_model(get_arch(XLSTM), device="meta")
    assert (x.n_mlstm, x.n_slstm, x.per_group) == (18, 6, 3)
    x4 = build_model(get_arch(XLSTM).replace(n_layers=4), device="meta")
    assert (x4.n_mlstm, x4.n_slstm) == (3, 1)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [(HYBRID, {}), (XLSTM, {"n_layers": 8})],
                         ids=["hybrid", "ssm"])
def test_three_train_steps_match_reference(arch, kw):
    """3 AdamW steps, each from the reference's parameters and optimizer
    state before it (loaded through ``Trainer.load_checkpoint``): the
    port's loss within 1e-5 relative, its gradients as
    ``_assert_grads_match`` states with 2e-5 (after a step the xLSTM
    embedding's largest gradient entries differ by 1.1e-5 of the largest)
    and their norm within 1e-5 relative;
    then the port's update, given the reference's gradients, leaves
    parameters within atol=2e-5 of the reference's update and the same
    gradient norm within 1e-6 relative.

    Each optimizer takes the reference's gradients, and each step starts
    from the reference's state, because Adam's ``g / (|g| + eps)`` turns
    f32 rounding of a gradient into a visible part of the step wherever
    the clipped gradient is within ~100 eps (1.3% of the hybrid's entries
    and 2.9% of the xLSTM's here), and the xLSTM's gradient jumps where an
    sLSTM's ``max(n, 1)`` switches sides (its normalizer starts at 1 and
    stays near it): the two packages' trajectories part by more than
    their arithmetic differs."""
    cfg, rmodel, tree = _ref(arch, **kw)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    radam = jax.jit(lambda p, g, s: radamw_update(
        p, g, s, RAdamWConfig(lr=1e-3, warmup_steps=2)))
    ropt = rinit_opt_state(tree)
    tr = loop.Trainer(_port(tree, arch, **kw), acfg, loop.TrainerConfig(),
                      None)
    rp = tree
    for i in range(3):
        opt = tr.load_checkpoint({"params": _np_tree(rp),
                                  "opt": _np_tree(ropt)})
        assert opt["step"] == i
        tokens = _tokens(cfg, step=i)
        rloss, rgrads = _ref_value_and_grad(rmodel, rp, tokens)
        rp, ropt, rm = radam(rp, rgrads, ropt)
        loss, grads = tr.grad_fn({"tokens": torch.from_numpy(tokens)})
        assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
        _assert_grads_match(grads, rgrads, tol=2e-5)
        assert float(global_norm(grads.values())) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5)
        m = loop.apply_update(tr.model, opt, loss,
                              P.unstack(_np_tree(rgrads)), acfg)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        want = _leaves(_np_tree(rp))
        got = _leaves(P.to_reference(tr.model))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("arch,kw,loops", [
    (HYBRID, {"n_layers": 5}, {"layers"}),
    (XLSTM, {"n_layers": 4}, {"mlstm", "slstm"})], ids=["hybrid", "ssm"])
def test_step_attribution_on_meta_at_seq_512(arch, kw, loops, tmp_path):
    """``attribute_step`` traces a step on ``meta`` at 2 x 512 (two chunks
    of 256 a layer, 512 sLSTM steps; the published attention chunks, one
    block at 512) and writes its structure: the scan's cumulative sums,
    exponentials and products appear inside the layer loops forward and
    backward; the hybrid's shared block is its own module scope; the FLOPs
    exceed 6 N D; the sLSTM's loop is recorded step by step (three
    sigmoids a step), as eager code runs it."""
    cfg = reduced(get_arch(arch)).replace(ssm_chunk=256, q_chunk=512,
                                          kv_chunk=1024, **kw)

    class _Profiler(Profiler):  # keeps what the launcher hands it
        def attribute_step(self, records, **kw):
            self.records, self.flops = records, kw["measured"]["flops"]
            super().attribute_step(records, **kw)

    prof = _Profiler({"rank": 0, "stream": 0, "kind": "host"})
    launch_train.attribute_step(prof, cfg, 2, 512, str(tmp_path))
    assert (tmp_path / "step.struct.json").is_file()
    records = prof.records
    scopes = {name for r in records for _, name in r.path}
    assert loops <= scopes
    assert ("shared_attn" in scopes) == (arch == HYBRID)
    in_loops = [r for r in records if loops & {n for _, n in r.path}]
    for phase in ("forward", "backward"):
        ops = {r.opcode for r in in_loops if r.path[1][1] == phase}
        assert {"bmm", "exp"} <= ops, phase
    assert "cumsum" in {r.opcode for r in in_loops}
    assert model_flops(cfg, ShapeConfig("t", 512, 2, "train")) < prof.flops
    if arch == XLSTM:  # the sLSTM's loop is recorded once a time step
        assert sum(r.opcode == "sigmoid" and r.path[1][1] == "forward"
                   and r.path[-1][1] == "slstm" for r in records) == 3 * 512


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _run_launcher(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr, _ = launch_train.main(argv)
    return tr.history, buf.getvalue()


def _next_reference_loss(state, rmodel, cfg, step_no):
    """The loss of the reference's step ``step_no`` from a restored tree."""
    params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    tokens = _tokens(cfg, step=step_no)
    return float(_jitted(rmodel)[1](params, {"tokens": jnp.asarray(tokens)}))


def test_hybrid_launcher_profile_and_checkpoints_cross_packages(tmp_path):
    """The reduced zamba2 through the CLI with a profile and a checkpoint:
    the profile aggregates with both packages' numpy ``analyze`` to the
    same contexts, values and sizes; the reference restores the port's
    checkpoint and computes the loss the port's ``--resume`` step reports
    (1e-5 relative); and the port continues the reference's checkpoint to
    the reference's next loss."""
    flags = ["--arch", HYBRID, "--reduced", "--batch", "4", "--seq", "32",
             "--device", "cpu"]
    ckpt, prof = tmp_path / "ckpt", tmp_path / "prof"
    history, _ = _run_launcher([*flags, "--steps", "3", "--profile-dir",
                                str(prof), "--ckpt-dir", str(ckpt),
                                "--ckpt-every", "3"])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in history)
    outs = []
    for name, main, extra in (("ref", ranalyze.main, []),
                              ("port", analyze.main, ["--compute", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(prof / "worker0.rprf"), "--out", str(tmp_path / name),
                  "--executor", "serial", *extra])
        outs.append(json.loads(buf.getvalue()))
    ref, port = outs
    assert ref["contexts"] == port["contexts"] > 0
    assert ref["values"] == port["values"] > 0
    assert ref["sizes"] == port["sizes"]

    cfg, rmodel, tree = _ref(HYBRID)
    step, state = RCheckpointManager(ckpt).restore()
    assert step == 3
    want = _next_reference_loss(state, rmodel, cfg, step)
    resumed, out = _run_launcher([*flags, "--steps", "1", "--resume",
                                  "--ckpt-dir", str(ckpt)])
    assert "resumed from step 3" in out and resumed[0]["step"] == 3
    assert resumed[0]["loss"] == pytest.approx(want, rel=1e-5)

    rtr = rloop.Trainer(rmodel, RAdamWConfig(),
                        rloop.TrainerConfig(steps=2, ckpt_every=2),
                        RTokenPipeline(cfg.vocab_size, 32, 4),
                        ckpt=RCheckpointManager(tmp_path / "ref_ckpt"))
    rtr.run(tree, rinit_opt_state(tree))
    rstep, rstate = RCheckpointManager(tmp_path / "ref_ckpt").restore()
    want = _next_reference_loss(rstate, rmodel, cfg, rstep)
    pcfg = reduced(get_arch(HYBRID))
    tr = loop.Trainer(build_model(pcfg), AdamWConfig(),
                      loop.TrainerConfig(steps=1),
                      TokenPipeline(pcfg.vocab_size, 32, 4))
    _, pstate = CheckpointManager(tmp_path / "ref_ckpt").restore()
    opt = tr.load_checkpoint(pstate)
    assert opt["step"] == 2
    tr.run(opt, start_step=rstep, steps=1)
    assert tr.history[0]["loss"] == pytest.approx(want, rel=1e-5)
