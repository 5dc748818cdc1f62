"""The port's training slice on the CPU, held against the JAX package on
the same inputs: the model layers, the dense LM's loss and gradients, the
train step and its microbatching, the data pipeline, checkpoints in both
directions, the step attribution and the launcher end to end.

Sizes are ``reduced(qwen3-0.6b)`` (2 layers, width 128, vocab 512, f32).
Parameters come from ``repro.models.params.init_params`` and are carried
across with ``repro_torch.models.params.from_reference``; other inputs are
made from numpy seeds.  f32 tolerances are stated at each test: they allow
for the two frameworks' different summation orders, nothing more.
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
from repro.core.sparse import MeasurementProfile as RMeasurementProfile
from repro.data import TokenPipeline as RTokenPipeline
from repro.launch import analyze as ranalyze
from repro.models import layers as rlayers
from repro.models import params as rparams
from repro.models.api import build_model as rbuild_model
from repro.models.api import n_params as rn_params
from repro.train import loop as rloop
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import init_opt_state as rinit_opt_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.cct import KIND_OP
from repro_torch.core.metrics import MetricRegistry
from repro_torch.core.sparse import MeasurementProfile
from repro_torch.data import TokenPipeline
from repro_torch.kernels import xent
from repro_torch.launch import analyze
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models.api import build_model, model_flops, n_params
from repro_torch.models.lm import TransformerLM
from repro_torch.profiling import dispatch_attrib
from repro_torch.train import loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

ARCH = "qwen3-0.6b"
RTOL, ATOL = 1e-5, 1e-6  # f32 layer parity


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """``{path: numpy array}`` of a reference-layout tree of either
    package."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32)
            for k, v in P.flatten(tree)}


def _ref(arch=ARCH, **kw):
    cfg = rreduced(rget_arch(arch)).replace(**kw)
    model = rbuild_model(cfg)
    return cfg, model, rparams.init_params(model.param_defs(), 0,
                                           jnp.dtype(cfg.dtype))


def _port(tree, arch=ARCH, **kw):
    model = build_model(reduced(get_arch(arch)).replace(**kw))
    return P.from_reference(model, _np_tree(tree))


def _batch(cfg, seq=32, batch=4, step=0):
    return RTokenPipeline(cfg.vocab_size, seq, batch).batch_at(step)


# ---------------------------------------------------------------------------
# layers (rtol=1e-5, atol=1e-6 in f32)
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    w = rng.normal(size=32).astype(np.float32)
    pos = np.arange(7)[None, :].astype(np.int32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(rlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        layers.rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(rlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["masked", "triangle"])
@pytest.mark.parametrize("sq,t,causal", [(32, 32, True), (37, 37, True),
                                         (21, 45, False)])
def test_flash_attention_matches_reference(mode, sq, t, causal):
    """Ragged lengths pad to 16-row chunks; GQA with 4 q heads on 2 kv."""
    rng = np.random.default_rng(sq * 100 + t)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, t, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, t, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16, mode=mode)
    got = layers.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    want = np.asarray(rlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    x, wg, wu, wd = (rng.normal(size=s).astype(np.float32) * 0.3
                     for s in [(2, 5, 16), (16, 24), (16, 24), (24, 16)])
    got = layers.glu_mlp(_t(x), _t(wg), _t(wu), _t(wd), act).numpy()
    want = np.asarray(rlayers.glu_mlp(*map(jnp.asarray, (x, wg, wu, wd)),
                                      act))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_softmax_xent_matches_reference(chunk):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 32)).astype(np.int32)
    mask = (rng.uniform(size=(2, 32)) > 0.2).astype(np.float32)
    got = float(layers.chunked_softmax_xent(_t(x), _t(w), _t(labels),
                                            _t(mask), chunk=chunk))
    want = float(rlayers.chunked_softmax_xent(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
        jnp.asarray(mask), chunk=chunk))
    assert got == pytest.approx(want, rel=RTOL)


def test_head_xent_split_is_exact():
    """``hi + mid + lo == d`` bit for bit over every exponent from 2**-110
    to bf16's largest finite magnitude, both signs, zeros included; below
    2**-110 the sum is within 2**-134, bf16's subnormal spacing."""
    rng = np.random.default_rng(11)
    n = 200_000
    bits = (rng.integers(0, 2, n) << 31 | rng.integers(0, 255, n) << 23
            | rng.integers(0, 2 ** 23, n)).astype(np.uint32)
    d = torch.from_numpy(np.concatenate([
        bits.view(np.float32), np.float32([0.0, -0.0, 2.0 ** -110,
                                           -2.0 ** -110])]))
    d = d[torch.isfinite(d) & (d.abs() < 2.0 ** 127 * (2 - 2.0 ** -8))]
    hi, mid, lo = xent.split3(d)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    exact = (d.abs() >= 2.0 ** -110) | (d == 0)
    assert int(exact.sum()) > n // 2 and int((~exact).sum()) > n // 20
    assert torch.equal(total[exact], d[exact])  # -0.0 sums to +0.0
    assert float((total - d)[~exact].abs().max()) <= 2.0 ** -134


@pytest.mark.parametrize("chunk,vocab,masked", [(32, 50, True),
                                                (8, 50, True),
                                                (8, 37, False)])
def test_head_xent_plain_matches_autograd(chunk, vocab, masked):
    """The head's algorithm in plain PyTorch (the passes, the split into
    three bf16 terms, their products summed) against today's autograd of
    ``chunked_softmax_xent``, f32 on the CPU: loss, dX and dW, with one and
    several chunks, a mask and a vocabulary no multiple of 4."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(2, 32, 16)).astype(np.float32))
    w = _t(rng.normal(size=(16, vocab)).astype(np.float32))
    labels = _t(rng.integers(0, vocab, (2, 32)))
    mask = (_t((rng.uniform(size=(2, 32)) > 0.2).astype(np.float32))
            if masked else None)
    want, got = [], []
    for fn, out in ((layers.chunked_softmax_xent, want),
                    (xent.head_xent_plain, got)):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = fn(xg, wg, labels, mask, chunk=chunk)
        loss.backward()
        out += [loss.detach(), xg.grad, wg.grad]
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=RTOL, atol=ATOL)


def test_head_xent_keeps_no_logits_for_backward():
    """No tensor that the head saves for its backward holds a chunk's
    logits (B * c * V values), let alone the whole (B, S, V); today's
    autograd keeps such tensors for every chunk, which the hooks see."""
    B, S, D, V, chunk = 2, 32, 8, 64, 8
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(B, S, D)).astype(np.float32)).requires_grad_()
    w = _t(rng.normal(size=(D, V)).astype(np.float32)).requires_grad_()
    labels = _t(rng.integers(0, V, (B, S)))
    for fn, keeps in ((xent.head_xent_plain, False),
                      (layers.chunked_softmax_xent, True)):
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel()) or t, lambda t: t):
            loss = fn(x, w, labels, chunk=chunk)
        held = sum(n >= B * chunk * V for n in sizes)
        assert held >= S // chunk if keeps else held == 0
        loss.backward()


def test_chunked_softmax_xent_keeps_todays_path_off_the_card(monkeypatch):
    """CPU tensors, bf16 ones too, take today's autograd: the card's head
    is never called."""
    def card_only(*a, **k):
        raise AssertionError("head_xent called for CPU tensors")

    monkeypatch.setattr(layers, "head_xent", card_only)
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        x = _t(rng.normal(size=(2, 16, 8)).astype(np.float32)).to(dtype)
        w = _t(rng.normal(size=(8, 24)).astype(np.float32)).to(dtype)
        loss = layers.chunked_softmax_xent(x, w, _t(rng.integers(0, 24,
                                                                 (2, 16))))
        assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_param_tree_round_trips_and_counts_match():
    _, rmodel, tree = _ref()
    model = _port(tree)
    back = P.to_reference(model)
    want = _leaves(_np_tree(tree))
    got = _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for arch in ("qwen3-0.6b", "yi-6b", "gemma-7b", "codeqwen1.5-7b"):
        assert n_params(get_arch(arch)) == rn_params(rget_arch(arch))
    assert n_params(get_arch(ARCH)) == 596_049_920


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "yi-6b", "gemma-7b",
                                  "codeqwen1.5-7b"])
def test_loss_and_gradients_match_reference(arch):
    """f32, each dense family's reduced config (qk-norm and tied head,
    GeGLU, untied head): loss within 1e-5 relative, every gradient within
    atol=1e-5."""
    cfg, rmodel, tree = _ref(arch)
    tokens = _batch(cfg)
    rloss, rgrads = jax.value_and_grad(rmodel.loss_fn)(
        tree, {"tokens": jnp.asarray(tokens)})
    model = _port(tree, arch)
    loss, grads = loop.value_and_grad(model, {"tokens": _t(tokens)})
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = _leaves(_np_tree(rgrads))
    got = _leaves(P.stack(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_bf16_loss_matches_reference():
    """bf16 parameters and activations: loss within 2e-2 relative (bf16
    rounds at different places in the two frameworks)."""
    cfg, rmodel, tree = _ref(dtype="bfloat16")
    tree16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    tokens = _batch(cfg)
    rloss = float(rmodel.loss_fn(tree16, {"tokens": jnp.asarray(tokens)}))
    port_tree = {k: _t(v).to(torch.bfloat16)
                 for k, v in _leaves(_np_tree(tree)).items()}
    model = build_model(reduced(get_arch(ARCH)).replace(dtype="bfloat16"))
    P.from_reference(model, _unflatten(port_tree))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with torch.no_grad():
        loss = float(model.loss_fn({"tokens": _t(tokens)}))
    assert loss == pytest.approx(rloss, rel=2e-2)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_unported_families_and_serving_raise():
    """Every family builds at full size on ``meta``; ``prefill`` of the
    reduced model serves each of the six families (dense, MoE, VLM,
    audio, hybrid, SSM): f32 logits (1, V) of the last position and
    ``len`` 4; and ``TransformerLM`` refuses a family it does not hold,
    naming the class that does.  (The name is from before every family
    was ported; it is kept.)"""
    rng = np.random.default_rng(0)
    for arch in (ARCH, "qwen3-moe-30b-a3b", "llama-3.2-vision-11b",
                 "whisper-small", "zamba2-7b", "xlstm-350m"):
        build_model(get_arch(arch), device="meta")
        cfg = reduced(get_arch(arch))
        model = build_model(cfg)
        P.from_reference(model, P.init_params(
            model.param_defs(), torch.Generator().manual_seed(0), cfg.dtype,
            "cpu"))
        batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (1, 4)))}
        extra = {"vlm": ("vision_embed", cfg.vision_tokens),
                 "audio": ("frames", 8)}.get(cfg.family)
        if extra:
            batch[extra[0]] = torch.randn(1, extra[1], cfg.d_model)
        logits, cache = model.prefill(batch)
        assert logits.shape == (1, cfg.vocab_size)
        assert logits.dtype == torch.float32 and cache["len"] == 4
    for arch, holder in (("zamba2-7b", "MambaLM"), ("xlstm-350m", "XLSTMLM"),
                         ("whisper-small", "WhisperModel")):
        with pytest.raises(ValueError, match=holder):
            TransformerLM(get_arch(arch), device="meta")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference():
    """3 AdamW steps from the same parameters and batches: parameters
    within atol=2e-5, losses within 1e-5 relative."""
    cfg, rmodel, tree = _ref()
    ocfg = dict(lr=1e-3, warmup_steps=2)
    rstep = jax.jit(rloop.make_train_step(rmodel, RAdamWConfig(**ocfg)))
    ropt = rinit_opt_state(tree)
    model = _port(tree)
    step = loop.make_train_step(model, AdamWConfig(**ocfg))
    opt = init_opt_state(dict(model.named_parameters()))
    rp = tree
    for i in range(3):
        tokens = _batch(cfg, step=i)
        rp, ropt, rm = rstep(rp, ropt, {"tokens": jnp.asarray(tokens)})
        m = step(opt, {"tokens": _t(tokens)})
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5)
    want = _leaves(_np_tree(rp))
    got = _leaves(P.to_reference(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert opt["step"] == int(ropt["step"]) == 3


def test_grad_accumulation_matches_full_batch():
    """The reference's microbatch test on the port: loss within 1e-4
    relative, parameters within 2e-4."""
    _, _, tree = _ref("yi-6b")
    cfg = reduced(get_arch("yi-6b"))
    tokens = _t(TokenPipeline(cfg.vocab_size, 16, 8).batch_at(0))
    out = []
    for mb in (1, 4):
        model = _port(tree, "yi-6b")
        opt = init_opt_state(dict(model.named_parameters()))
        m = loop.make_train_step(model, AdamWConfig(),
                                 microbatches=mb)(opt, {"tokens": tokens})
        out.append((float(m["loss"]), _leaves(P.to_reference(model))))
    (l1, p1), (l4, p4) = out
    assert l1 == pytest.approx(l4, rel=1e-4)
    assert max(float(np.abs(p1[k] - p4[k]).max()) for k in p1) < 2e-4


@pytest.mark.parametrize("mb", [3, 5])
def test_microbatches_that_do_not_divide_the_batch_raise(mb):
    """The reference's reshape refuses a batch of 8 in 3 or 5 parts; the
    port raises ValueError before any pass, and 4 parts still run."""
    cfg, _, tree = _ref()
    tokens = _t(TokenPipeline(cfg.vocab_size, 16, 8).batch_at(0))
    grad_fn = loop.make_grad_fn(_port(tree), microbatches=mb)
    with pytest.raises(ValueError, match="does not divide"):
        grad_fn({"tokens": tokens})
    loss, _ = loop.make_grad_fn(_port(tree), microbatches=4)(
        {"tokens": tokens})
    assert torch.isfinite(loss)


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 4)])
def test_token_pipeline_bytes_equal_reference(step, shard, n_shards):
    kw = dict(vocab_size=151936, seq_len=64, global_batch=8, shard=shard,
              n_shards=n_shards, seed=5)
    got = TokenPipeline(**kw).batch_at(step)
    want = RTokenPipeline(**kw).batch_at(step)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_keeps_bf16_bits(tmp_path):
    rng = np.random.default_rng(6)
    w16 = _t(rng.normal(size=(3, 5)).astype(np.float32)).to(torch.bfloat16)
    state = {"params": {"w": w16, "b": _t(np.arange(4.0))},
             "opt": {"step": np.int32(7)}, "kv": (np.zeros(2), np.ones(2))}
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(10, state)
    step, got = mgr.restore()
    assert step == 10
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w16.view(torch.int16))
    assert torch.equal(got["params"]["b"], state["params"]["b"])
    assert int(got["opt"]["step"]) == 7 and isinstance(got["kv"], tuple)


def test_reference_bf16_checkpoint_restores_bit_equal(tmp_path):
    """A bf16 tree saved by the reference (``np.savez`` of bf16 arrays,
    read back as ``|V2`` void) restores in the port as bf16, bit for bit;
    its other leaves as written."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    w[0, :3] = [np.inf, -0.0, 1e-40]
    w16 = jnp.asarray(w, dtype=jnp.bfloat16)
    state = {"params": {"w": w16, "b": jnp.arange(3.0)},
             "opt": {"step": jnp.int32(3)}}
    RCheckpointManager(tmp_path, async_save=False).save(4, state)
    step, got = CheckpointManager(tmp_path).restore()
    assert step == 4
    assert got["params"]["w"].dtype == torch.bfloat16
    want = np.asarray(w16).view(np.int16)
    assert np.array_equal(got["params"]["w"].view(torch.int16).numpy(), want)
    assert got["params"]["b"].dtype == torch.float32
    assert torch.equal(got["params"]["b"], torch.arange(3.0))
    assert int(got["opt"]["step"]) == 3


def _continue_reference(state, cfg, rmodel, step_no):
    rstep = jax.jit(rloop.make_train_step(rmodel, RAdamWConfig()))
    params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    opt = jax.tree_util.tree_map(jnp.asarray, state["opt"])
    _, _, m = rstep(params, opt, {"tokens": jnp.asarray(
        _batch(cfg, step=step_no))})
    return float(m["loss"])


def _port_trainer(tmp_path):
    cfg = reduced(get_arch(ARCH))
    return loop.Trainer(build_model(cfg), AdamWConfig(),
                        loop.TrainerConfig(steps=2, ckpt_every=2),
                        TokenPipeline(cfg.vocab_size, 32, 4),
                        ckpt=CheckpointManager(tmp_path))


def test_reference_checkpoint_continues_in_port_and_back(tmp_path):
    """f32 checkpoints cross both ways: the next step's loss agrees within
    1e-5 relative whichever package wrote the checkpoint."""
    cfg, rmodel, tree = _ref()
    rtr = rloop.Trainer(rmodel, RAdamWConfig(),
                        rloop.TrainerConfig(steps=2, ckpt_every=2),
                        RTokenPipeline(cfg.vocab_size, 32, 4),
                        ckpt=RCheckpointManager(tmp_path / "ref"))
    rtr.run(tree, rinit_opt_state(tree))
    step, state = RCheckpointManager(tmp_path / "ref").restore()
    want = _continue_reference(state, cfg, rmodel, step)

    tr = _port_trainer(tmp_path / "port")
    _, pstate = CheckpointManager(tmp_path / "ref").restore()
    opt = tr.load_checkpoint(pstate)
    tr.run(opt, start_step=step, steps=1)
    assert tr.history[0]["loss"] == pytest.approx(want, rel=1e-5)

    tr2 = _port_trainer(tmp_path / "port2")
    opt2 = tr2.load_checkpoint(pstate)
    tr2.ckpt.save(step, tr2.checkpoint_state(opt2, step))
    tr2.ckpt.wait()
    _, back = RCheckpointManager(tmp_path / "port2").restore()
    assert _continue_reference(back, cfg, rmodel, step) == pytest.approx(
        want, rel=1e-5)


def test_trainer_retries_the_gradient_but_never_the_update(monkeypatch):
    """A failed forward/backward pass is re-run and the step ends bit-equal
    to a clean one; an update that fails partway raises at once, with no
    second update on top of the tensors it wrote."""
    cfg = reduced(get_arch(ARCH))

    def trainer():
        tr = loop.Trainer(build_model(cfg), AdamWConfig(),
                          loop.TrainerConfig(steps=1),
                          TokenPipeline(cfg.vocab_size, 32, 4))
        return tr, tr.init_state(torch.Generator().manual_seed(0))

    clean, opt = trainer()
    clean.run(opt)
    flaky, opt = trainer()
    grad_fn, calls = flaky.grad_fn, []

    def fails_once(batch):
        out = grad_fn(batch)
        calls.append(len(calls))
        if len(calls) == 1:
            raise RuntimeError("injected backward failure")
        return out

    flaky.grad_fn = fails_once
    flaky.run(opt)
    assert calls == [0, 1] and opt["step"] == 1
    want = dict(clean.model.named_parameters())
    for n, t in flaky.model.named_parameters():
        assert torch.equal(t, want[n]), n

    broken, opt = trainer()
    updates = []

    def fails_midway(params, grads, opt_state, opt_cfg):
        updates.append(opt_state["step"])
        with torch.no_grad():
            next(iter(params.values())).add_(1.0)
        raise RuntimeError("update failed partway")

    monkeypatch.setattr(loop, "adamw_update", fails_midway)
    with pytest.raises(RuntimeError, match="partway"):
        broken.run(opt)
    assert updates == [0] and broken.history == []


# ---------------------------------------------------------------------------
# attribution and the launcher
# ---------------------------------------------------------------------------

def test_step_attribution_on_meta_counts_the_step():
    """A meta trace computes nothing, but sees every phase of the step, the
    layer loop, and the FLOPs of the matrix products (about 6ND)."""
    cfg = reduced(get_arch(ARCH))
    meta = build_model(cfg, device="meta")
    opt = init_opt_state(dict(meta.named_parameters()))
    tokens = torch.empty((4, 32), dtype=torch.int32, device="meta")
    records, flops = dispatch_attrib.trace_step(
        loop.make_train_step(meta, AdamWConfig()), opt, {"tokens": tokens})
    phases = {r.path[1][1] for r in records}
    assert phases == {"forward", "backward", "update"}
    assert any(name == "layers" for r in records for _, name in r.path)
    assert {r.cls for r in records} == {"dot", "other"}
    six_nd = model_flops(cfg, ShapeConfig("t", 32, 4, "train"))
    assert 0.8 * six_nd < flops < 3.0 * six_nd
    assert opt["step"] == 1


def test_profiler_module_metric_lands_under_train(tmp_path):
    from repro_torch.profiling import Profiler
    prof = Profiler({"rank": 0, "stream": 0, "kind": "host"})
    prof.module_metric(["model", "head"], "host.step_time", 2.5)
    out = prof.finish(tmp_path / "p.rprf")
    ctx, _, vals = out.metrics.triplets()
    t = out.tree
    (c,) = ctx.tolist()
    assert vals.tolist() == [2.5] and t.name_of(c) == "head"
    assert t.name_of(t.parent[t.parent[c]]) == "train"
    assert RMeasurementProfile.load(str(tmp_path / "p.rprf")).identity == \
        {"rank": 0, "stream": 0, "kind": "host"}


def _run_launcher(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr, _ = launch_train.main(argv)
    return tr.history, buf.getvalue()


def test_launcher_profile_aggregates_with_both_packages(tmp_path):
    prof_dir = tmp_path / "prof"
    history, _ = _run_launcher([
        "--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "32", "--device", "cpu", "--profile-dir", str(prof_dir),
        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    rprf = prof_dir / "worker0.rprf"
    assert (prof_dir / "structs" / "step.struct.json").is_file()
    ref = RMeasurementProfile.load(str(rprf))
    assert ref.identity == {"rank": 0, "stream": 0, "kind": "host"}

    prof = MeasurementProfile.load(str(rprf))
    reg = MetricRegistry.from_json(prof.environment["registry"])
    ctx, mid, _ = prof.metrics.triplets()
    by_side = {"host": set(), "dev": set()}
    for c, m in zip(ctx.tolist(), mid.tolist()):
        by_side[reg.name_of(m).split(".")[0]].add(c)
    assert by_side["host"] and by_side["dev"]
    assert not by_side["host"] & by_side["dev"]
    assert all(prof.tree.kind[c] == KIND_OP for c in by_side["dev"])

    outs = []
    for name, main, flags in (("ref", ranalyze.main, []),
                              ("port", analyze.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(rprf), "--out", str(tmp_path / name), "--executor",
                  "serial", *flags])
        outs.append(json.loads(buf.getvalue()))
    assert outs[0]["contexts"] == outs[1]["contexts"] > len(by_side["dev"])
    assert outs[0]["values"] == outs[1]["values"] > 0

    resumed, out = _run_launcher([
        "--arch", ARCH, "--reduced", "--steps", "1", "--batch", "4",
        "--seq", "32", "--device", "cpu", "--resume", "--ckpt-dir",
        str(tmp_path / "ckpt")])
    assert "resumed from step 3" in out and resumed[0]["step"] == 3


def test_launcher_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
