"""The port's chunked linear-RNN scan and SSM blocks on the CPU, held
against the JAX package on the same inputs: ``linear_rnn_chunked`` in
both key forms, ragged and whole chunks, zero and seeded entering state;
the reference's non-finite gradient at the published chunk of 256 beside
the port's finite one; bits that do not depend on ``opt_einsum``; the
causal conv; and the Mamba2, mLSTM and sLSTM blocks with and without
state.

Inputs come from numpy seeds, f32; block parameters are one layer of
``repro.models.params.init_params``.  Tolerances are stated at each test:
they allow for the two frameworks' summation orders, nothing more.
"""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as rget_arch
from repro.configs.base import reduced as rreduced
from repro.models import params as rparams
from repro.models import ssm as rssm
from repro.models.api import build_model as rbuild_model
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import ssm


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(B=2, S=20, H=3, P=4, N=5, Hk=1, seed=0, h0=True,
                 log_a=None):
    """Seeded scan inputs; log-decays in [-1, 0) unless ``log_a`` fixes
    every one."""
    rng = np.random.default_rng(seed)
    la = (-rng.uniform(0.0, 1.0, (B, S, H)) if log_a is None
          else np.full((B, S, H), log_a)).astype(np.float32)
    v = rng.normal(size=(B, S, H, P)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, N)).astype(np.float32)
    q = rng.normal(size=(B, S, Hk, N)).astype(np.float32)
    h = (rng.normal(size=(B, H, P, N)) if h0 else
         np.zeros((B, H, P, N))).astype(np.float32)
    return la, v, k, q, h


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0", [False, True], ids=["h0_zero", "h0_seeded"])
@pytest.mark.parametrize("S", [24, 20], ids=["whole", "ragged"])
@pytest.mark.parametrize("Hk", [1, 3], ids=["shared", "per_head"])
def test_linear_rnn_chunked_matches_reference(Hk, S, h0):
    """Chunk 8 over 24 steps (3 chunks) or 20 (a padded tail): ``y`` and
    ``h_out`` within 1e-5 (absolute and relative)."""
    args = _scan_inputs(S=S, Hk=Hk, h0=h0)
    y, h = ssm.linear_rnn_chunked(*map(_t, args), chunk=8)
    ry, rh = rssm.linear_rnn_chunked(*map(jnp.asarray, args), chunk=8)
    assert y.shape == ry.shape and h.shape == rh.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5,
                               atol=1e-5)


def _scan_loss(y, h, gy, gh, lib):
    return lib.sum(y * gy) + lib.sum(h * gh)


def _reference_grad(args, chunk, cot):
    """d/d(log_a) of a seeded linear functional of ``(y, h_out)``."""
    def f(la):
        y, h = rssm.linear_rnn_chunked(la, *args[1:], chunk=chunk)
        return _scan_loss(y, h, *cot, jnp)
    return np.asarray(jax.grad(f)(args[0]))


@pytest.mark.parametrize("Hk", [1, 3], ids=["shared", "per_head"])
@pytest.mark.parametrize("S,ref_finite", [(64, True), (128, False),
                                          (160, False), (256, False)])
def test_published_chunk_gradient_finite_where_reference_overflows(S,
                                                                   ref_finite,
                                                                   Hk):
    """Log-decay -0.7 everywhere, chunk 256 (one chunk of S steps).  The
    reference's gradient with respect to ``log_a`` is non-finite once S
    passes ~128 (``exp`` of the unmasked decay matrix, up to 0.7 (S - 1),
    overflows f32 past 88.7): asserted, as a record of the reference.  The
    port's is finite at every S and agrees with the reference's at chunk
    8 on the same inputs (within 1e-4 of the largest, relative: the two
    chunkings sum in other orders); the port's forward at chunk 256
    agrees with the reference's at chunk 256 within 1e-4 (absolute and
    relative: a chunk's cumulative log-decay reaches -0.7 S, the two
    frameworks' cumsums differ by an ulp of it, 7.6e-6 at S 128, and each
    decay ``exp(cum[j] - cum[i])`` carries that as a relative error)."""
    args = [jnp.asarray(a) for a in _scan_inputs(S=S, Hk=Hk, log_a=-0.7)]
    rng = np.random.default_rng(7)
    cot = (rng.normal(size=(2, S, 3, 4)).astype(np.float32),
           rng.normal(size=(2, 3, 4, 5)).astype(np.float32))
    ref256 = _reference_grad(args, 256, cot)
    assert np.isfinite(ref256).all() == ref_finite
    ref8 = _reference_grad(args, 8, cot)
    assert np.isfinite(ref8).all()

    la = _t(np.asarray(args[0])).requires_grad_()
    rest = [_t(np.asarray(a)) for a in args[1:]]
    y, h = ssm.linear_rnn_chunked(la, *rest, chunk=256)
    _scan_loss(y, h, *map(_t, cot), torch).backward()
    g = la.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, ref8, rtol=0,
                               atol=1e-4 * np.abs(ref8).max())
    ry, rh = rssm.linear_rnn_chunked(*args, chunk=256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(rh),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Hk", [1, 3], ids=["shared", "per_head"])
def test_scan_bits_do_not_depend_on_opt_einsum(Hk):
    """The same scan, forward and backward, with ``opt_einsum`` on and
    off: equal bits (every product has two operands, so no contraction
    order is chosen)."""
    args = _scan_inputs(S=20, Hk=Hk)

    def run():
        ts = [_t(a).requires_grad_() for a in args]
        y, h = ssm.linear_rnn_chunked(*ts, chunk=8)
        (y.square().sum() + h.sum()).backward()
        return [y, h] + [t.grad for t in ts]

    with torch.backends.opt_einsum.flags(enabled=True):
        on = run()
    with torch.backends.opt_einsum.flags(enabled=False):
        off = run()
    for a, b in zip(on, off):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_no_einsum_with_more_than_two_operands():
    """Every ``einsum`` in the port's ``ssm.py`` names two operands."""
    tree = ast.parse(inspect.getsource(ssm))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "einsum"]
    assert len(calls) >= 6
    for c in calls:
        eq = c.args[0].value
        assert len(c.args) == 3 and eq.split("->")[0].count(",") == 1, eq


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """K = 4 over 20 steps, with the 3 previous inputs as state or zero
    padding: output within 1e-6, the new state (the last 3 inputs) equal."""
    rng = np.random.default_rng(3)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in [(2, 20, 16), (4, 16), (16,)])
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state \
        else None
    y, new = ssm._causal_conv(_t(x), _t(w), _t(b),
                              None if st is None else _t(st))
    ry, rnew = rssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0, atol=1e-6)
    assert np.array_equal(new.numpy(), np.asarray(rnew))


def _layer(tree, group, i=0):
    return {k: np.asarray(v[i]) for k, v in tree[group].items()}


def _block_case(kind):
    """The reduced config (chunk 8), one layer's parameters, a seeded
    input (2 x 20: a padded tail) and a seeded state."""
    arch = "xlstm-350m" if kind in ("mlstm", "slstm") else "zamba2-7b"
    kw = {"n_layers": 4} if kind == "slstm" else {}
    rcfg = rreduced(rget_arch(arch)).replace(**kw)
    tree = rparams.init_params(rbuild_model(rcfg).param_defs(), 0,
                               jnp.float32)
    group = {"mamba2": "layers"}.get(kind, kind)
    p = _layer(tree, group)
    if kind == "mamba2":  # away from init's zeros, so each term counts
        rng = np.random.default_rng(11)
        for n in ("A_log", "dt_bias", "conv_b", "ln", "norm"):
            p[n] = (0.3 * rng.normal(size=p[n].shape)).astype(np.float32)
    rng = np.random.default_rng(5)
    B, S, D = 2, 20, rcfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    if kind == "mamba2":
        H, DI = rcfg.n_ssm_heads, rcfg.d_inner
        state = {"h": rng.normal(size=(B, H, DI // H, rcfg.ssm_state)),
                 "conv": rng.normal(size=(B, rcfg.ssm_conv - 1, DI))}
    elif kind == "mlstm":
        H, N = rcfg.n_heads, rcfg.d_inner // rcfg.n_heads
        state = {"h": 0.1 * rng.normal(size=(B, H, N + 1, N))}
    else:
        H, hd = rcfg.n_heads, D // rcfg.n_heads
        state = {"c": rng.normal(size=(B, H, hd)),
                 "n": rng.uniform(0.5, 2.0, (B, H, hd)),  # both sides of 1
                 "hp": 0.5 * rng.normal(size=(B, H, hd))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    cfg = reduced(get_arch(arch)).replace(**kw)
    return rcfg, cfg, p, x, state


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["state_none", "state_seeded"])
@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_block_matches_reference(kind, with_state):
    """One block at the reduced width: output and every new state within
    1e-5 (absolute and relative); ``state=None`` gives no new state."""
    rcfg, cfg, p, x, state = _block_case(kind)
    fn, rfn = {"mamba2": (ssm.mamba2_block, rssm.mamba2_block),
               "mlstm": (ssm.mlstm_block, rssm.mlstm_block),
               "slstm": (ssm.slstm_block, rssm.slstm_block)}[kind]
    st = state if with_state else None
    out, new = fn({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                  None if st is None else {k: _t(v) for k, v in st.items()})
    rout, rnew = rfn({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), rcfg,
                     None if st is None else {k: jnp.asarray(v)
                                              for k, v in st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-5,
                               atol=1e-5)
    if st is None:
        assert new is None and rnew is None
        return
    assert sorted(new) == sorted(rnew)
    for k in rnew:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(rnew[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
