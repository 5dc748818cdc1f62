"""The port's MoE, VLM and audio families on the CPU, held against the JAX
package on the same inputs: both MoE dispatches, with and without dropped
copies; loss and gradients of each family; the train step; parameter trees
and counts; the step's attribution on ``meta``; and the launcher end to
end with a profile and checkpoints crossing between the packages.

Sizes are ``reduced(...)`` (2 layers, width 128, vocab 512, 4 experts
top-2, f32).  Parameters come from ``repro.models.params.init_params`` and
are carried across with ``repro_torch.models.params.from_reference``;
other inputs are made from numpy seeds.  Tolerances are stated at each
test: they allow for the two frameworks' summation orders, nothing more.
"""
import contextlib
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
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models import params as rparams
from repro.models.api import build_model as rbuild_model
from repro.models.api import model_flops as rmodel_flops
from repro.models.api import n_active_params as rn_active_params
from repro.models.api import n_params as rn_params
from repro.train import loop as rloop
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import init_opt_state as rinit_opt_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.data import TokenPipeline
from repro_torch.launch import analyze
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.models.api import (build_model, model_flops,
                                    n_active_params, n_params)
from repro_torch.profiling import dispatch_attrib
from repro_torch.train import loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

MOE = "qwen3-moe-30b-a3b"
VLM = "llama-3.2-vision-11b"
AUDIO = "whisper-small"
ENC_FRAMES = 48  # encoder frames of the audio batch (3 attention chunks)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """``{path: f32 numpy array}`` of a reference-layout tree of either
    package."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32)
            for k, v in P.flatten(tree)}


def _ref(arch, **kw):
    cfg = rreduced(rget_arch(arch)).replace(**kw)
    model = rbuild_model(cfg)
    return cfg, model, rparams.init_params(model.param_defs(), 0,
                                           jnp.dtype(cfg.dtype))


def _port(tree, arch, **kw):
    model = build_model(reduced(get_arch(arch)).replace(**kw))
    return P.from_reference(model, _np_tree(tree))


def _batch(cfg, seed=0, batch=4, seq=32, step=0):
    """numpy inputs of one step: tokens from the pipeline, and the VLM's
    vision embeddings or the audio frames from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": RTokenPipeline(cfg.vocab_size, seq, batch).batch_at(step)}
    if cfg.family == "vlm":
        out["vision_embed"] = rng.normal(
            size=(batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(batch, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the MoE block (f32)
# ---------------------------------------------------------------------------

def _moe_inputs(B=2, S=64, D=32, E=4, F=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(D, E)).astype(np.float32) * 0.3,
            *(rng.normal(size=s).astype(np.float32) * 0.2
              for s in [(E, D, F), (E, D, F), (E, F, D)]))


def _copies_kept(out):
    """Tokens whose every copy was dropped come out as zero rows."""
    return int((~np.all(out == 0, axis=-1)).sum())


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("dispatch,kw", [
    ("sorted", {}), ("rowwise", {}),
    ("rowwise", {"pos_chunk": 48})])  # 48 < S*K = 128: counts carry
def test_moe_block_matches_reference(dispatch, kw, cf, act):
    """Output and router probabilities within 2e-6, the aux loss within
    1e-6 relative.  At ``capacity_factor`` 0.5 copies are dropped (the
    capacity is 32 of ~64 copies an expert, 16 a row), so the kept set
    and its stable order are compared; at 4.0 nothing is dropped."""
    fn, rfn = {"sorted": (moe.moe_block, rmoe.moe_block),
               "rowwise": (moe.moe_block_rowwise,
                           rmoe.moe_block_rowwise)}[dispatch]
    args = _moe_inputs()
    opts = dict(top_k=2, capacity_factor=cf, act=act, **kw)
    out, probs = fn(*map(_t, args), **opts)
    rout, rprobs = rfn(*map(jnp.asarray, args), **opts)
    rout, rprobs = np.asarray(rout), np.asarray(rprobs)
    assert out.shape == rout.shape and probs.shape == rprobs.shape
    np.testing.assert_allclose(out.numpy(), rout, rtol=0, atol=2e-6)
    np.testing.assert_allclose(probs.numpy(), rprobs, rtol=0, atol=2e-6)
    dropped = _copies_kept(rout) < rout.shape[0] * rout.shape[1]
    assert dropped == (cf < 1)
    assert _copies_kept(out.numpy()) == _copies_kept(rout)
    assert float(moe.moe_aux_loss(probs)) == pytest.approx(
        float(rmoe.moe_aux_loss(jnp.asarray(rprobs))), rel=1e-6)


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("dispatch", ["sorted", "rowwise"])
def test_moe_block_gradients_match_reference(dispatch, cf):
    """Gradients of ``sum(out**2) + aux`` for the input and every weight
    within 1e-6 relative to each tensor's largest gradient (f32
    summation order over tokens, copies and experts)."""
    fn, rfn = {"sorted": (moe.moe_block, rmoe.moe_block),
               "rowwise": (moe.moe_block_rowwise,
                           rmoe.moe_block_rowwise)}[dispatch]
    args = _moe_inputs(seed=1)
    opts = dict(top_k=2, capacity_factor=cf)
    ts = [_t(a).requires_grad_() for a in args]
    out, probs = fn(*ts, **opts)
    (out.square().sum() + moe.moe_aux_loss(probs)).backward()

    def loss(*a):
        o, p = rfn(*a, **opts)
        return jnp.sum(o ** 2) + rmoe.moe_aux_loss(p)

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_moe_counts_and_capacities_follow_the_reference():
    """The capacities are the reference's integer arithmetic; the published
    qwen3-moe batch of 8 x 128 gets 96 slots an expert (sorted) and 16 an
    expert in each row (rowwise)."""
    assert moe.sorted_capacity(1024, 8, 1.25, 128) == 96
    assert moe.rowwise_capacity(128, 8, 1.25, 128) == 16
    assert moe.sorted_capacity(8, 2, 4.0, 4) == 32
    assert moe.rowwise_capacity(3, 2, 4.0, 4) == 6


@pytest.mark.parametrize("n", [64, 448, 1500])
def test_sinusoid_positions_match_reference(n):
    """Within 4 f32 ulps of the largest angle, ``n`` radians: the two
    frameworks' f32 ``pow`` differ in the last bit for a few frequencies
    (4 of 384 at d 768), which moves an angle by up to an ulp of itself,
    and their f32 ``sin``/``cos`` differ by an ulp or two more."""
    np.testing.assert_allclose(
        layers.sinusoid_positions(n, 768).numpy(),
        np.asarray(rlayers.sinusoid_positions(n, 768)), rtol=0,
        atol=4 * n * 2.0 ** -23)


# ---------------------------------------------------------------------------
# each family's loss and gradients
# ---------------------------------------------------------------------------

FAMILY_CASES = [
    (MOE, {}), (MOE, {"moe_dispatch": "rowwise"}),
    (MOE, {"capacity_factor": 0.5}),
    (MOE, {"capacity_factor": 0.5, "moe_dispatch": "rowwise"}),
    ("grok-1-314b", {}), ("grok-1-314b", {"moe_dispatch": "rowwise"}),
    (VLM, {}),                                      # one group of 2
    (VLM, {"n_layers": 4, "cross_attn_every": 2}),  # two groups
    (AUDIO, {}),
]


def _case_id(case):
    arch, kw = case
    return "-".join([arch, *(f"{k}={v}" for k, v in kw.items())])


@pytest.mark.parametrize("arch,kw", FAMILY_CASES,
                         ids=[_case_id(c) for c in FAMILY_CASES])
def test_loss_and_gradients_match_reference(arch, kw):
    """f32: loss within 1e-5 relative, every gradient within atol=1e-5
    plus 1e-5 relative (the VLM gate's gradient is a sum over every
    position and feature, ~2.5 in size)."""
    cfg, rmodel, tree = _ref(arch, **kw)
    batch = _batch(cfg)
    rloss, rgrads = jax.value_and_grad(rmodel.loss_fn)(tree, _jax(batch))
    model = _port(tree, arch, **kw)
    loss, grads = loop.value_and_grad(model, _torch(batch))
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = _leaves(_np_tree(rgrads))
    got = _leaves(P.stack(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch,kw", [
    (MOE, {"capacity_factor": 0.5}), (VLM, {"n_layers": 4,
                                            "cross_attn_every": 2}),
    (AUDIO, {})], ids=["moe", "vlm", "audio"])
def test_remat_changes_no_bits(arch, kw):
    """``cfg.remat`` recomputes each checkpointed layer in the backward
    pass: loss and gradients bit-equal to the run without it."""
    _, _, tree = _ref(arch, **kw)
    batch = _torch(_batch(reduced(get_arch(arch)).replace(**kw)))
    out = [loop.value_and_grad(_port(tree, arch, remat=r, **kw), batch)
           for r in (False, True)]
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_vlm_needs_whole_groups():
    with pytest.raises(ValueError, match="cross_attn_every"):
        build_model(reduced(get_arch(VLM)).replace(n_layers=3), device="meta")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["sorted", "rowwise"])
def test_three_moe_train_steps_match_reference(dispatch):
    """3 AdamW steps of the reduced MoE from the same parameters and
    batches: losses and gradient norms within 1e-5 relative, parameters
    within atol=2e-5.

    Except where a step's gradient is zero up to f32 rounding (not 0, but
    below 1e-6 of its tensor's largest): there Adam's first step divides that
    rounding by itself plus ``eps`` = 1e-8, so the two packages' update
    sizes differ by up to a whole step.  One ``wq`` entry of 32,768 has
    gradients -5.1e-9 (port) and -1.5e-8 (reference) at step 0 against a
    largest of 0.03; such entries are checked within 2 * lr * 3, the most
    three steps can move them apart, and must stay under 1e-4 of all."""
    cfg, rmodel, tree = _ref(MOE, moe_dispatch=dispatch)
    ocfg = dict(lr=1e-3, warmup_steps=2)
    rstep = jax.jit(rloop.make_train_step(rmodel, RAdamWConfig(**ocfg)))
    ropt = rinit_opt_state(tree)
    model = _port(tree, MOE, moe_dispatch=dispatch)
    grad_fn = loop.make_grad_fn(model)
    opt = init_opt_state(dict(model.named_parameters()))
    rp, floor = tree, {}
    for i in range(3):
        batch = _batch(cfg, step=i)
        rp, ropt, rm = rstep(rp, ropt, _jax(batch))
        loss, grads = grad_fn(_torch(batch))
        for n, g in grads.items():
            tiny = (g != 0) & (g.abs() <= 1e-6 * g.abs().max())
            floor[n] = floor[n] | tiny if n in floor else tiny
        m = loop.apply_update(model, opt, loss, grads, AdamWConfig(**ocfg))
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5)
    want = _leaves(_np_tree(rp))
    got = _leaves(P.to_reference(model))
    tiny = _leaves(P.stack({n: t.float() for n, t in floor.items()}))
    n_tiny = sum(int(t.sum()) for t in tiny.values())
    assert n_tiny <= 1e-4 * sum(t.size for t in tiny.values())
    for k in want:
        strict = tiny[k] == 0
        np.testing.assert_allclose(got[k][strict], want[k][strict], rtol=0,
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k][~strict], want[k][~strict],
                                   rtol=0, atol=2 * ocfg["lr"] * 3,
                                   err_msg=k)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_vlm_and_audio_train_through_make_train_step(arch):
    """One AdamW step with the family's batch dict: loss and gradient norm
    within 1e-5 relative of the reference's jitted step."""
    cfg, rmodel, tree = _ref(arch)
    batch = _batch(cfg, seed=3)
    _, _, rm = jax.jit(rloop.make_train_step(rmodel, RAdamWConfig()))(
        tree, rinit_opt_state(tree), _jax(batch))
    model = _port(tree, arch)
    m = loop.make_train_step(model, AdamWConfig())(
        init_opt_state(dict(model.named_parameters())), _torch(batch))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-5)


# ---------------------------------------------------------------------------
# parameter trees and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    (MOE, {}), ("grok-1-314b", {}), (VLM, {"n_layers": 4,
                                           "cross_attn_every": 2}),
    (AUDIO, {})], ids=["moe", "grok", "vlm", "audio"])
def test_param_tree_round_trips_bit_for_bit(arch, kw):
    """The reference tree -> the port's modules -> the reference layout:
    the same paths and bits, the stacked groups (``layers``, ``cross``,
    ``enc``, ``dec``) split and stacked again."""
    _, rmodel, tree = _ref(arch, **kw)
    model = _port(tree, arch, **kw)
    want = _leaves(_np_tree(tree))
    got = _leaves(P.to_reference(model))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    defs = {k: d.shape for k, d in P.flatten(model.param_defs())}
    assert defs == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", [MOE, "grok-1-314b", VLM, AUDIO])
def test_counts_equal_reference_at_full_size(arch):
    """Built on ``meta`` at full size (nothing allocated): parameters,
    active parameters (MoE: top_k of n_experts expert weights) and the
    train/prefill/decode FLOPs of the reference."""
    cfg, rcfg = get_arch(arch), rget_arch(arch)
    assert n_params(cfg) == rn_params(rcfg)
    assert n_active_params(cfg) == rn_active_params(rcfg)
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_params(cfg)
    for kind, seq in (("train", 1500), ("prefill", 1500), ("decode", 4096)):
        assert model_flops(cfg, ShapeConfig("s", seq, 8, kind)) == \
            rmodel_flops(rcfg, RShapeConfig("s", seq, 8, kind))


def test_published_counts():
    """The figures the chip phases quote: qwen3-moe cut to 4 layers, the
    VLM to 10, and whisper-small whole."""
    moe4 = get_arch(MOE).replace(n_layers=4)
    assert (n_params(moe4), n_active_params(moe4)) == (3_114_814_464,
                                                      849_890_304)
    assert n_params(get_arch(VLM).replace(n_layers=10)) == 3_315_691_522
    assert n_params(get_arch(AUDIO)) == 334_860_288
    assert model_flops(get_arch(AUDIO), ShapeConfig("s", 1500, 8, "train")) \
        == 6.0 * 334_860_288 * 8 * (1500 + 448)


# ---------------------------------------------------------------------------
# attribution and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch,ops", [
    ("sorted", {"topk", "sort", "scatter_add_", "cumsum", "index_put_",
                "bmm"}),
    ("rowwise", {"topk", "cumsum", "scatter_", "gather", "bmm"})])
def test_moe_step_attribution_on_meta_records_router_and_experts(dispatch,
                                                                 ops):
    """The MoE step traces on ``meta`` (``torch.bincount`` would not): the
    router's top-k, the dispatch (the stable sort, expert counts and the
    accumulating scatter; or the running counts and the slot map) and the
    expert products appear inside the layer loop, the products forward and
    backward."""
    cfg = reduced(get_arch(MOE)).replace(moe_dispatch=dispatch)
    meta = build_model(cfg, device="meta")
    opt = init_opt_state(dict(meta.named_parameters()))
    tokens = torch.empty((4, 32), dtype=torch.int32, device="meta")
    records, flops = dispatch_attrib.trace_step(
        loop.make_train_step(meta, AdamWConfig()), opt, {"tokens": tokens})
    in_layers = [r for r in records
                 if any(name == "layers" for _, name in r.path)]
    fwd = {r.opcode for r in in_layers if r.path[1][1] == "forward"}
    bwd = {r.opcode for r in in_layers if r.path[1][1] == "backward"}
    assert ops <= fwd
    assert "bmm" in bwd
    six_nd = model_flops(cfg, ShapeConfig("t", 32, 4, "train"))
    assert six_nd < flops < 4.0 * six_nd
    assert opt["step"] == 1


def _run_launcher(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr, _ = launch_train.main(argv)
    return tr.history, buf.getvalue()


def _next_reference_loss(state, rmodel, cfg, step_no):
    """The loss of the reference's step ``step_no`` from a restored tree."""
    params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    return float(rmodel.loss_fn(params, _jax(_batch(cfg, step=step_no))))


def test_moe_launcher_profile_and_checkpoints_cross_packages(tmp_path):
    """The reduced MoE through the CLI with a profile and a checkpoint: the
    profile aggregates with both packages' numpy ``analyze`` to the same
    counts, and with the port's kernel path (their plain versions) to the
    same contexts and no value the numpy path lacks (an f32 inclusive
    value is a difference of two prefixes, and this profile's ``dev.flops``
    column sums to 2.9e8, past the 2^14 that keeps the difference exact:
    a small inclusive value can cancel to 0 and drop out, ROADMAP §3);
    the reference restores the port's checkpoint and computes the loss the
    port's ``--resume`` step reports (1e-5 relative); and the port
    continues the reference's checkpoint to the reference's next loss."""
    flags = ["--arch", MOE, "--reduced", "--batch", "4", "--seq", "32",
             "--device", "cpu"]
    ckpt, prof = tmp_path / "ckpt", tmp_path / "prof"
    history, _ = _run_launcher([*flags, "--steps", "3", "--profile-dir",
                                str(prof), "--ckpt-dir", str(ckpt),
                                "--ckpt-every", "3"])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    outs = []
    for name, main, extra in (("ref", ranalyze.main, []),
                              ("port", analyze.main, ["--compute", "cpu"]),
                              ("kernels", analyze.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(prof / "worker0.rprf"), "--out", str(tmp_path / name),
                  "--executor", "serial", *extra])
        outs.append(json.loads(buf.getvalue()))
    ref, port, kern = outs
    assert ref["contexts"] == port["contexts"] == kern["contexts"] > 0
    assert ref["values"] == port["values"] >= kern["values"] > 0
    assert ref["sizes"] == port["sizes"]

    cfg, rmodel, tree = _ref(MOE)
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
    pcfg = reduced(get_arch(MOE))
    tr = loop.Trainer(build_model(pcfg), AdamWConfig(),
                      loop.TrainerConfig(steps=1),
                      TokenPipeline(pcfg.vocab_size, 32, 4))
    _, pstate = CheckpointManager(tmp_path / "ref_ckpt").restore()
    opt = tr.load_checkpoint(pstate)
    assert opt["step"] == 2
    tr.run(opt, start_step=rstep, steps=1)
    assert tr.history[0]["loss"] == pytest.approx(want, rel=1e-5)
