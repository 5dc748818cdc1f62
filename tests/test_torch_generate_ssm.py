"""Generation serving of the SSM and hybrid families on the port, held
against the JAX package on the CPU: ``prefill``, ``decode_step``,
``cache_defs`` and ``cache_init`` of ``MambaLM`` (the zamba2 hybrid, and
plain Mamba2 without its shared attention) and ``XLSTMLM`` (mLSTM only, an
sLSTM block, and the cache-shape quirk of 5 layers); the logits and every
cache leaf; ``ServeEngine``'s tokens against the reference engine's; and
the ways the port's serving differs from the reference: the cache is
written in place, and a full attention cache raises, while a recurrent
state has no positional bound.

Sizes are ``reduced(...)`` (width 128, vocab 512, ``ssm_chunk`` 8, f32).
Parameters come from ``repro.models.params.init_params`` and are carried
across with ``repro_torch.models.params.from_reference``; tokens are made
from numpy seeds.  Every tolerance is stated at its test and allows for
the two frameworks' summation orders, nothing more.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as rget_arch
from repro.configs.base import reduced as rreduced
from repro.models import params as rparams
from repro.models.api import build_model as rbuild_model
from repro.models.api import cache_init as rcache_init
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import params as P
from repro_torch.models.api import build_model, cache_init
from repro_torch.serve.engine import Request, ServeEngine

HYBRID, XLSTM = "zamba2-7b", "xlstm-350m"
CASES = [
    (HYBRID, {}),                  # 4 layers, 2 groups: 2 applications
    (HYBRID, {"attn_every": 0}),   # plain Mamba2, no attention cache
    (XLSTM, {}),                   # 2 mLSTM blocks, no sLSTM (2 // 4 = 0)
    (XLSTM, {"n_layers": 4}),      # 3 mLSTM blocks, then an sLSTM
    (XLSTM, {"n_layers": 5}),      # 4 mLSTM defined, 3 run, 1 sLSTM
]
IDS = ["-".join([a, *(f"{k}={v}" for k, v in kw.items())]) for a, kw in CASES]
B, S, MAX_LEN = 2, 12, 24          # 12 tokens: a chunk of 8 and a ragged 4
# logits within LOGIT_TOL of the largest |logit| of the reference's step;
# cache leaves within LEAF_TOL of each leaf's largest entry
LOGIT_TOL, LEAF_TOL = 1e-5, 1e-5
# the two packages' greedy tokens may part only where the reference's two
# best logits are within this of each other (of its largest |logit|)
TIE_TOL = 1e-5

cases = pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@lru_cache(maxsize=None)
def _pair(case):
    """(reference cfg, reference model, its f32 parameters, the port's
    model on the same parameters) of ``reduced(arch)`` with the case's
    replacements."""
    arch, kw = CASES[case]
    rcfg = rreduced(rget_arch(arch)).replace(**kw)
    rmodel = rbuild_model(rcfg)
    params = rparams.init_params(rmodel.param_defs(), 0, jnp.float32)
    model = build_model(reduced(get_arch(arch)).replace(**kw))
    P.from_reference(model, jax.tree_util.tree_map(np.asarray, params))
    return rcfg, rmodel, params, model


@lru_cache(maxsize=None)
def _ref_fns(case):
    """The reference's jitted prefill (at MAX_LEN) and decode_step."""
    rmodel = _pair(case)[1]
    return (jax.jit(lambda p, b: rmodel.prefill(p, b, max_len=MAX_LEN)),
            jax.jit(rmodel.decode_step))


def _tokens(cfg, seed, rows=B, seq=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)


def _tree(tree, prefix=""):
    """``{path: leaf}`` of a nested dict (a cache, or its ``cache_defs``),
    keys in sorted order."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in sorted(tree.items()):
        out.update(_tree(v, f"{prefix}{k}/"))
    return out


def _leaves(cache):
    """``{path: numpy array}`` of a cache of either package (``"len"`` a
    scalar); the port's arrays share the tensors' memory."""
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _tree(cache).items()}


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def _assert_leaves_close(g, w):
    """Every leaf of ``w`` in ``g``: its shape and dtype, and its values
    within LEAF_TOL of the leaf's largest entry."""
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        if k == "len":
            assert int(g[k]) == int(w[k])
            continue
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=LEAF_TOL * max(
                                       np.abs(w[k]).max(initial=0), 1e-30),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# prefill and decode_step against the reference
# ---------------------------------------------------------------------------

@cases
def test_prefill_and_three_decode_steps_match_reference(case):
    """``prefill(max_len=24)`` of 2 x 12 tokens (one chunk of 8 and a
    padded one), then 3 ``decode_step``s on seeded tokens: logits within
    1e-5 of the largest |logit| and every cache leaf (the scan states, the
    conv windows, the sLSTM carries, the hybrid's attention caches with
    their zero padding, ``len``) within 1e-5 of its largest entry, after
    the prefill and after each step."""
    rcfg, _, params, model = _pair(case)
    rprefill, rdecode = _ref_fns(case)
    tokens = _tokens(rcfg, 0)
    want, rcache = rprefill(params, {"tokens": jnp.asarray(tokens)})
    got, cache = model.prefill({"tokens": _t(tokens)}, max_len=MAX_LEN)
    _assert_logits_close(got, want)
    _assert_leaves_close(_leaves(cache), _leaves(rcache))
    steps = np.random.default_rng(3).integers(0, rcfg.vocab_size, (3, B, 1))
    for tok in steps.astype(np.int32):
        want, rcache = rdecode(params, rcache, {"tokens": jnp.asarray(tok)})
        got, cache = model.decode_step(cache, {"tokens": _t(tok)})
        _assert_logits_close(got, want)
        _assert_leaves_close(_leaves(cache), _leaves(rcache))


@cases
@pytest.mark.parametrize("head", [16, 11], ids=["chunks", "ragged"])
def test_prefill_then_decode_equals_full_prefill(case, head):
    """The port alone: ``prefill`` of the first ``head`` tokens (16, two
    whole chunks of 8; or 11, a padded tail chunk) and one ``decode_step``
    of the next give the logits of ``prefill`` of all ``head + 1`` within
    1e-5 of the largest |logit|, and every cache leaf within 1e-5 of its
    largest entry: the padding leaves the state after the last real
    token."""
    rcfg, _, _, model = _pair(case)
    tokens = _t(_tokens(rcfg, 4, seq=head + 1))
    want, full = model.prefill({"tokens": tokens}, max_len=MAX_LEN)
    _, cache = model.prefill({"tokens": tokens[:, :-1]}, max_len=MAX_LEN)
    assert cache["len"] == head
    got, cache = model.decode_step(cache, {"tokens": tokens[:, -1:]})
    _assert_logits_close(got, want)
    assert cache["len"] == full["len"] == head + 1
    _assert_leaves_close(_leaves(cache), _leaves(full))


@cases
def test_cache_defs_and_cache_init_match_reference(case):
    """``cache_defs`` at full width (zamba2-7b: 81 layers, 14
    applications) gives the reference's keys, shapes, logical axes and
    inits leaf by leaf; ``cache_init`` of the reduced model gives the
    reference's shapes, dtypes and fill (the sLSTM's ``n`` ones, the rest
    zeros, ``len`` the int 0); and one ``decode_step`` on each package's
    zero cache gives the same logits within 1e-5 of the largest."""
    arch, kw = CASES[case]
    full = {k: v for k, v in kw.items() if k != "n_layers"}
    defs = _tree(build_model(get_arch(arch).replace(**full),
                             device="meta").cache_defs(8, 161))
    rdefs = _tree(rbuild_model(rget_arch(arch).replace(**full))
                  .cache_defs(8, 161))
    assert sorted(defs) == sorted(rdefs)
    for k, d in rdefs.items():
        assert (defs[k].shape, defs[k].logical, defs[k].init) == (
            d.shape, d.logical, d.init), k
    if case == 0:
        assert defs["attn_k"].shape == (14, 8, 161, 32, 112)
        assert defs["ssm/h"].shape == (81, 8, 112, 64, 64)
    rcfg, rmodel, params, model = _pair(case)
    cache = cache_init(model, model.cfg, B, MAX_LEN, device="cpu")
    rcache = rcache_init(rmodel, rcfg, B, MAX_LEN)
    g, w = _leaves(cache), _leaves(rcache)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert k == "len" or g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert cache["len"] == 0 and isinstance(cache["len"], int)
    if "ssm/s/n" in g and g["ssm/s/n"].size:
        assert np.all(g["ssm/s/n"] == 1)
    tok = np.array([[5], [7]], np.int32)
    want, _ = _ref_fns(case)[1](params, rcache, {"tokens": jnp.asarray(tok)})
    got, cache = model.decode_step(cache, {"tokens": _t(tok)})
    _assert_logits_close(got, want)
    assert cache["len"] == 1


def test_xlstm_cache_shape_quirk_of_five_layers():
    """5 layers, an sLSTM every 4th: ``cache_defs`` declares 4 mLSTM
    states, but ``prefill`` carries the 3 that run, as the reference's
    does; ``decode_step`` on a ``cache_init`` cache of 4 keeps its shape,
    its rows 0-2 within 1e-5 of the reference's 3 rows (which its decode
    returns), and row 3 stays zero."""
    case = IDS.index("xlstm-350m-n_layers=5")
    rcfg, rmodel, params, model = _pair(case)
    assert model.cache_defs(B, MAX_LEN)["ssm"]["m"]["h"].shape[0] == 4
    tokens = _tokens(rcfg, 9)
    _, rpre = _ref_fns(case)[0](params, {"tokens": jnp.asarray(tokens)})
    _, pre = model.prefill({"tokens": _t(tokens)})
    assert pre["ssm"]["m"]["h"].shape == rpre["ssm"]["m"]["h"].shape
    assert pre["ssm"]["m"]["h"].shape[0] == 3
    cache = cache_init(model, model.cfg, B, MAX_LEN, device="cpu")
    rcache = rcache_init(rmodel, rcfg, B, MAX_LEN)
    tok = tokens[:, :1]
    for _ in range(2):
        want, rcache = _ref_fns(case)[1](params, rcache,
                                         {"tokens": jnp.asarray(tok)})
        got, cache = model.decode_step(cache, {"tokens": _t(tok)})
        _assert_logits_close(got, want)
    h, rh = cache["ssm"]["m"]["h"].numpy(), np.asarray(rcache["ssm"]["m"]["h"])
    assert h.shape[0] == 4 and rh.shape[0] == 3
    np.testing.assert_allclose(h[:3], rh, rtol=0,
                               atol=LEAF_TOL * np.abs(rh).max())
    assert np.any(h[:3]) and not np.any(h[3])


# ---------------------------------------------------------------------------
# the standing deviations: in place; a full attention cache raises
# ---------------------------------------------------------------------------

@cases
def test_decode_step_writes_the_cache_in_place(case):
    """``decode_step`` returns the very cache it was given, each tensor
    the same object on the same storage; every recurrent state that runs
    changes, and of the hybrid's attention caches only row ``len``."""
    rcfg, _, _, model = _pair(case)
    _, cache = model.prefill({"tokens": _t(_tokens(rcfg, 5))},
                             max_len=MAX_LEN)
    tensors = {k: v for k, v in _tree(cache).items() if k != "len"}
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    before = {k: v.clone() for k, v in tensors.items()}
    _, out = model.decode_step(cache, {"tokens": _t(
        np.array([[1], [2]], np.int32))})
    assert out is cache and out["len"] == S + 1
    after = {k: v for k, v in _tree(out).items() if k != "len"}
    assert all(after[k] is tensors[k] for k in tensors)
    assert {k: v.data_ptr() for k, v in after.items()} == ptrs
    for k, old in before.items():
        new = after[k]
        if k in ("attn_k", "attn_v"):
            assert torch.any(new[:, :, S] != old[:, :, S]), k
            keep = [t for t in range(new.shape[2]) if t != S]
            assert torch.equal(new[:, :, keep], old[:, :, keep]), k
        elif new.numel():
            assert torch.all((new != old).flatten(1).any(1)), k


@cases
def test_full_cache_raises_only_with_attention(case):
    """A prefill at ``max_len`` equal to the prompt: the hybrid's next
    ``decode_step`` raises ``ValueError`` (its attention cache is full),
    and so does ``generate`` past ``max_len``; plain Mamba2 and the xLSTM
    have no positional bound, as in the reference, and decode past it."""
    rcfg, _, _, model = _pair(case)
    tokens = _t(_tokens(rcfg, 6))
    _, cache = model.prefill({"tokens": tokens}, max_len=S)
    if rcfg.attn_every:
        with pytest.raises(ValueError, match="cache is full"):
            model.decode_step(cache, {"tokens": tokens[:, :1]})
        assert cache["len"] == S
        with pytest.raises(ValueError, match="cache is full"):
            ServeEngine(model, max_len=S + 2).generate(tokens.numpy(), 3)
        return
    for i in range(3):
        logits, cache = model.decode_step(cache, {"tokens": tokens[:, i:i + 1]})
        assert torch.isfinite(logits).all()
    assert cache["len"] == S + 3
    assert ServeEngine(model, max_len=S + 2).generate(
        tokens.numpy(), 3).shape == (B, 3)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

def _assert_same_greedy_tokens(got, want, prompts, case):
    """``got`` equals ``want`` row by row; at the first step where a row
    parts (after which the rows legitimately differ), the reference's top
    two logits there must be within TIE_TOL and ``got``'s token one of
    them: either of two tied tokens is accepted."""
    _, rmodel, params, _ = _pair(case)
    for b in range(len(want)):
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        seq = np.concatenate([prompts[b], want[b, :t]])[None]
        logits = np.asarray(rmodel.prefill(params, {"tokens": jnp.asarray(
            seq)})[0])[0]
        top = np.argsort(logits)[::-1][:2]
        margin = logits[top[0]] - logits[top[1]]
        assert margin <= TIE_TOL * np.abs(logits).max(), (b, t, margin)
        assert got[b, t] in top, (b, t)


@cases
def test_serve_engine_tokens_equal_reference(case):
    """The port's ``ServeEngine`` and the reference's on the same
    parameters, through ``serve``: 5 requests of two lengths in batches of
    2, 5 greedy tokens each, give the same tokens (ties aside)."""
    rcfg, rmodel, params, model = _pair(case)
    eng = ServeEngine(model, max_len=MAX_LEN, max_batch=2)
    reng = RServeEngine(rmodel, params, max_len=MAX_LEN, max_batch=2)
    rng = np.random.default_rng(7)
    lens = [8, 8, 6, 8, 6]
    reqs = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
            for n in lens]
    got = eng.serve([Request(r, 5) for r in reqs])
    want = reng.serve([RRequest(r, 5) for r in reqs])
    assert all(g.shape == (5,) and g.dtype == np.int32 for g in got)
    for n in set(lens):
        idx = [i for i, m in enumerate(lens) if m == n]
        _assert_same_greedy_tokens(np.stack([got[i] for i in idx]),
                                   np.stack([want[i] for i in idx]),
                                   np.stack([reqs[i] for i in idx]), case)
