"""Generation serving on the port, held against the JAX package on the CPU:
``decode_attention``; ``prefill``, ``decode_step``, ``cache_defs`` and
``cache_init`` of the dense, MoE, VLM and audio families (logits and every
cache leaf); ``ServeEngine`` (greedy against stepwise re-prefill, batched
against solo, tokens against the reference engine's); the launcher's
generation mode, for every family; and the two ways the port's serving
differs from the reference: the cache is written in place, and a full
cache raises.

Sizes are ``reduced(...)`` (2 layers, width 128, vocab 512, f32).
Parameters come from ``repro.models.params.init_params`` and are carried
across with ``repro_torch.models.params.from_reference``; other inputs are
made from numpy seeds.  Every tolerance is stated at its test and allows
for the two frameworks' summation orders, nothing more.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as rget_arch
from repro.configs.base import reduced as rreduced
from repro.models import layers as rlayers
from repro.models import params as rparams
from repro.models.api import build_model as rbuild_model
from repro.models.api import cache_init as rcache_init
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import params as P
from repro_torch.models.api import build_model, cache_init
from repro_torch.models.layers import decode_attention
from repro_torch.serve.engine import Request, ServeEngine

DENSE, MOE, VLM, AUDIO = ("qwen3-0.6b", "qwen3-moe-30b-a3b",
                          "llama-3.2-vision-11b", "whisper-small")
ARCHS = [DENSE, MOE, VLM, AUDIO]
B, S, MAX_LEN = 2, 12, 24
ENC_FRAMES = 24  # the audio batch's encoder frames
# logits within LOGIT_TOL of the largest |logit| of the reference's step;
# cache leaves within LEAF_TOL of each leaf's largest entry
LOGIT_TOL, LEAF_TOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@lru_cache(maxsize=None)
def _pair(arch, n_layers=None):
    """(reference cfg, reference model, its f32 parameters, the port's
    model on the same parameters) of ``reduced(arch)``."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    rcfg = rreduced(rget_arch(arch)).replace(**kw)
    rmodel = rbuild_model(rcfg)
    params = rparams.init_params(rmodel.param_defs(), 0, jnp.float32)
    model = build_model(reduced(get_arch(arch)).replace(**kw))
    P.from_reference(model, jax.tree_util.tree_map(np.asarray, params))
    return rcfg, rmodel, params, model


@lru_cache(maxsize=None)
def _ref_fns(arch):
    """The reference's jitted prefill (at MAX_LEN) and decode_step."""
    _, rmodel, _, _ = _pair(arch)
    return (jax.jit(lambda p, b: rmodel.prefill(p, b, max_len=MAX_LEN)),
            jax.jit(rmodel.decode_step))


def _batch(cfg, seed=0, rows=B, seq=S):
    """numpy prompt tokens, and the VLM's vision embeddings or the audio
    frames, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embed"] = rng.normal(
            size=(rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(rows, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _extras(batch):
    return {k: v for k, v in batch.items() if k != "tokens"}


def _tree(tree, prefix=""):
    """``{path: leaf}`` of a nested dict/tuple (a cache, or its
    ``cache_defs``), dict keys in sorted order."""
    if not isinstance(tree, (dict, tuple)):
        return {prefix[:-1]: tree}
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
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


def _assert_caches_close(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        if k == "len":
            assert int(g[k]) == int(w[k])
            continue
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=LEAF_TOL * max(np.abs(w[k]).max(),
                                                       1e-30), err_msg=k)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KVH,T,cache_len", [
    (4, 4, 16, 16),      # G = 1, the whole cache
    (8, 2, 16, 5),       # G = 4, a length that is no multiple of anything
    (8, 2, 16, "rows"),  # G = 4, a ragged length per row, (B, 1, 1, 1)
    (6, 3, 33, 1),       # G = 2, one position
], ids=["g1_full", "g4_len5", "g4_ragged", "g2_len1"])
def test_decode_attention_matches_reference(dtype, H, KVH, T, cache_len):
    """One query token against a (B, T, KVH, hd) cache, positions
    ``>= cache_len`` masked: within 1e-6 (f32) of the largest output, or
    one bf16 rounding (2^-7 of the largest) in bf16."""
    rng = np.random.default_rng(1)
    Bq, hd = 3, 16
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               [(Bq, 1, H, hd), (Bq, T, KVH, hd), (Bq, T, KVH, hd)])
    if cache_len == "rows":
        lens = np.array([1, 7, T], np.int32).reshape(Bq, 1, 1, 1)
        rlen, plen = jnp.asarray(lens), _t(lens)
    else:
        rlen = plen = cache_len
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(rlayers.decode_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), rlen)
        .astype(jnp.float32))
    got = decode_attention(*(_t(a).to(td) for a in (q, k, v)), plen)
    assert got.dtype == td and got.shape == (Bq, 1, H, hd)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_decode_attention_head_h_reads_kv_head_h_over_g():
    """With G = 2, a cache whose KV head 1 is all zeros gives zero output
    for query heads 2 and 3 only: heads are grouped as ``q.reshape(B, KVH,
    G, hd)``."""
    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    k = _t(rng.normal(size=(1, 5, 2, 8)).astype(np.float32))
    v = _t(rng.normal(size=(1, 5, 2, 8)).astype(np.float32))
    v[:, :, 1] = 0
    out = decode_attention(q, k, v, 5)[0, 0]
    assert torch.all(out[2:] == 0) and torch.all(out[:2] != 0)


# ---------------------------------------------------------------------------
# prefill and decode_step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_match_reference(arch):
    """``prefill(max_len=24)`` of 2 x 12 tokens, then 3 ``decode_step``s
    on seeded tokens: logits within 1e-5 of the largest |logit| and every
    cache leaf within 1e-5 of its largest entry, after the prefill and
    after each step (``len`` equal; the VLM's ``vision_embed`` and the
    zero padding too)."""
    rcfg, _, params, model = _pair(arch)
    rprefill, rdecode = _ref_fns(arch)
    batch = _batch(rcfg)
    want, rcache = rprefill(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got, cache = model.prefill({k: _t(v) for k, v in batch.items()},
                               max_len=MAX_LEN)
    _assert_logits_close(got, want)
    _assert_caches_close(cache, rcache)
    steps = np.random.default_rng(3).integers(0, rcfg.vocab_size, (3, B, 1))
    for tok in steps.astype(np.int32):
        want, rcache = rdecode(params, rcache, {"tokens": jnp.asarray(tok)})
        got, cache = model.decode_step(cache, {"tokens": _t(tok)})
        _assert_logits_close(got, want)
        _assert_caches_close(cache, rcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_prefill(arch):
    """The port alone: ``prefill`` of the first 11 tokens and one
    ``decode_step`` of the 12th give the logits of ``prefill`` of all 12
    within 1e-5 of the largest |logit|, and the same cached keys and
    values for those 12 positions within 1e-5 of each leaf's largest."""
    rcfg, _, _, model = _pair(arch)
    batch = {k: _t(v) for k, v in _batch(rcfg, seed=4).items()}
    want, full = model.prefill(batch, max_len=MAX_LEN)
    head = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = model.prefill(head, max_len=MAX_LEN)
    got, cache = model.decode_step(cache, {"tokens": batch["tokens"][:, -1:]})
    _assert_logits_close(got, want)
    assert cache["len"] == full["len"] == S
    g, w = _leaves(cache), _leaves(full)
    for k in w:
        if k != "len":
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=LEAF_TOL
                                       * np.abs(w[k]).max(), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_defs_and_cache_init_match_reference(arch):
    """``cache_defs`` at full size and ``cache_init`` of the reduced model
    give the reference's shapes and dtypes leaf by leaf (whisper's second
    argument is its encoder length: 1,500 frames at full size), and one
    ``decode_step`` on each package's zero cache gives the same logits
    within 1e-5 of the largest."""
    full = get_arch(arch)
    defs = build_model(full, device="meta").cache_defs(8, 1500)
    rdefs = rbuild_model(rget_arch(arch)).cache_defs(8, 1500)
    got = {k: d.shape for k, d in _tree(defs).items()}
    want = {k: d.shape for k, d in _tree(rdefs).items()}
    assert got == want
    if arch == AUDIO:
        assert got["k"] == (12, 8, 448, 12, 64)
        assert got["xk"] == (12, 8, 1500, 12, 64)
    rcfg, rmodel, params, model = _pair(arch)
    n = ENC_FRAMES if arch == AUDIO else MAX_LEN
    cache = cache_init(model, model.cfg, B, n, device="cpu")
    rcache = rcache_init(rmodel, rcfg, B, n)
    g, w = _leaves(cache), _leaves(rcache)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert k == "len" or g[k].dtype == w[k].dtype, k
        assert not np.any(g[k])
    assert cache["len"] == 0 and isinstance(cache["len"], int)
    tok = np.array([[5], [7]], np.int32)
    want, _ = _ref_fns(arch)[1](params, rcache, {"tokens": jnp.asarray(tok)})
    got, cache = model.decode_step(cache, {"tokens": _t(tok)})
    _assert_logits_close(got, want)
    assert cache["len"] == 1


# ---------------------------------------------------------------------------
# the standing deviations: in place, and a full cache raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [DENSE, AUDIO])
def test_decode_step_writes_the_cache_in_place(arch):
    """``decode_step`` returns the cache it was given, its tensors the same
    storage, and changes only row ``len`` of the self keys and values."""
    rcfg, _, _, model = _pair(arch)
    batch = {k: _t(v) for k, v in _batch(rcfg, seed=5).items()}
    _, cache = model.prefill(batch, max_len=MAX_LEN)
    before = {k: v.copy() for k, v in _leaves(cache).items() if k != "len"}
    tensors = {k: id(v) for k, v in _tree(cache).items() if k != "len"}
    out_logits, out = model.decode_step(cache, {"tokens": _t(
        np.array([[1], [2]], np.int32))})
    assert out is cache and out["len"] == S + 1
    assert {k: id(v) for k, v in _tree(out).items() if k != "len"} == tensors
    for k, old in before.items():
        new = _leaves(out)[k]
        if k in ("kv/0", "kv/1", "k", "v"):
            assert np.any(new[:, :, S] != old[:, :, S]), k
            new, old = np.delete(new, S, axis=2), np.delete(old, S, axis=2)
        np.testing.assert_array_equal(new, old, err_msg=k)


@pytest.mark.parametrize("arch", [DENSE, VLM, AUDIO])
def test_full_cache_raises(arch):
    """A cache with every position written raises ``ValueError`` on the
    next ``decode_step`` (the reference would overwrite its last row): the
    LM's at ``max_len``, whisper's at ``max_decoder_len`` (32 reduced)
    whatever ``max_len`` says; so does ``generate`` past ``max_len``."""
    rcfg, _, _, model = _pair(arch)
    seq = rcfg.max_decoder_len if arch == AUDIO else S
    batch = {k: _t(v) for k, v in _batch(rcfg, seed=6, seq=seq).items()}
    _, cache = model.prefill(batch, max_len=seq)
    with pytest.raises(ValueError, match="cache is full"):
        model.decode_step(cache, {"tokens": batch["tokens"][:, :1]})
    assert cache["len"] == seq
    if arch == DENSE:
        eng = ServeEngine(model, max_len=S + 2)
        with pytest.raises(ValueError, match="cache is full"):
            eng.generate(_batch(rcfg)["tokens"], 3)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

def test_serve_engine_greedy_matches_stepwise():
    """The reference's test, ported: on the dense model at 2 layers, greedy
    ``generate`` equals argmax of a full re-prefill at each step."""
    rcfg, _, _, model = _pair(DENSE)
    rng = np.random.default_rng(0)
    eng = ServeEngine(model, max_len=32)
    prompts = rng.integers(0, rcfg.vocab_size, (3, 8)).astype(np.int32)
    gen = eng.generate(prompts, 4)
    assert gen.shape == (3, 4) and gen.dtype == np.int32
    cur = prompts
    for t in range(4):
        logits, _ = model.prefill({"tokens": _t(cur)})
        nxt = logits.argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(gen[:, t], nxt)
        cur = np.concatenate([cur, nxt[:, None]], axis=1)


def test_serve_request_coalescing():
    """The reference's test, ported: on the dense model at 1 layer, 5
    requests in batches of 2 each get 3 tokens, and a request served in a
    batch equals the same request served alone."""
    rcfg, _, _, model = _pair(DENSE, n_layers=1)
    rng = np.random.default_rng(0)
    eng = ServeEngine(model, max_len=32, max_batch=2)
    reqs = [Request(rng.integers(0, rcfg.vocab_size, 8).astype(np.int32), 3)
            for _ in range(5)]
    outs = eng.serve(reqs)
    assert len(outs) == 5 and all(o.shape == (3,) for o in outs)
    solo = eng.serve([reqs[2]])[0]
    np.testing.assert_array_equal(outs[2], solo)


# the two packages' greedy tokens may part only where the reference's two
# best logits are within this of each other (of its largest |logit|)
TIE_TOL = 1e-5


def _assert_same_greedy_tokens(got, want, prompts, extras, arch):
    """``got`` equals ``want`` row by row; at the first step where a row
    parts (after which the rows legitimately differ), the reference's top
    two logits there must be within TIE_TOL and ``got``'s token one of
    them: either of two tied tokens is accepted."""
    rprefill = jax.jit(_pair(arch)[1].prefill)
    params = _pair(arch)[2]
    for b in range(len(want)):
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        batch = {"tokens": jnp.asarray(np.concatenate(
            [prompts[b], want[b, :t]])[None])}
        batch.update({k: jnp.asarray(v[b:b + 1]) for k, v in extras.items()})
        logits = np.asarray(rprefill(params, batch)[0])[0]
        top = np.argsort(logits)[::-1][:2]
        margin = logits[top[0]] - logits[top[1]]
        assert margin <= TIE_TOL * np.abs(logits).max(), (b, t, margin)
        assert got[b, t] in top, (b, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_equal_reference(arch):
    """The port's ``ServeEngine`` and the reference's on the same
    parameters give the same greedy tokens: the dense and MoE models
    through ``serve`` (5 requests of two lengths, batches of 2), the VLM
    and whisper through ``generate`` with their extras (``serve`` passes
    none, in both packages)."""
    rcfg, rmodel, params, model = _pair(arch)
    eng = ServeEngine(model, max_len=MAX_LEN, max_batch=2)
    reng = RServeEngine(rmodel, params, max_len=MAX_LEN, max_batch=2)
    if arch in (DENSE, MOE):
        rng = np.random.default_rng(7)
        lens = [8, 8, 6, 8, 6]
        reqs = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                for n in lens]
        got = eng.serve([Request(r, 5) for r in reqs])
        want = reng.serve([RRequest(r, 5) for r in reqs])
        for n in set(lens):
            idx = [i for i, m in enumerate(lens) if m == n]
            _assert_same_greedy_tokens(
                np.stack([got[i] for i in idx]),
                np.stack([want[i] for i in idx]),
                np.stack([reqs[i] for i in idx]), {}, arch)
        return
    batch = _batch(rcfg, seed=8, seq=6)
    extras = _extras(batch)
    got = eng.generate(batch["tokens"], 5, extras=extras)
    want = reng.generate(batch["tokens"], 5, extras=extras)
    assert got.shape == want.shape == (B, 5)
    _assert_same_greedy_tokens(got, want, batch["tokens"], extras, arch)
    with pytest.raises((KeyError, TypeError, AttributeError)):
        eng.serve([Request(batch["tokens"][0], 2)])  # no extras


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _serve_cli(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        ["src", os.environ.get("PYTHONPATH", "")]), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], capture_output=True, text=True, env=env,
                          timeout=180, cwd=os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__))))


def test_generate_launcher_serves_on_the_cpu():
    """``--reduced --device cpu``: the reference's ``served ...`` line and
    the first three requests' tokens, each a list of 8 token ids."""
    proc = _serve_cli("--arch", DENSE, "--reduced", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("served 6 requests, 48 tokens in ")
    assert "tok/s" in lines[0]
    assert [ln.split(":")[0] for ln in lines[1:]] == ["req0", "req1", "req2"]
    for ln in lines[1:]:
        toks = json.loads(ln.split(":", 1)[1])
        assert len(toks) == 8 and all(0 <= t < 512 for t in toks)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m"])
def test_generate_launcher_refuses_ssm_families(arch):
    """The SSM and hybrid families are served like the others: ``--reduced
    --device cpu`` exits 0 with the ``served ...`` line and the first three
    requests' tokens, each a list of 8 token ids.  (The name is from
    before their serving was ported; it is kept.)"""
    proc = _serve_cli("--arch", arch, "--reduced", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("served 6 requests, 48 tokens in ")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["req0", "req1", "req2"]
    for ln in lines[1:]:
        toks = json.loads(ln.split(":", 1)[1])
        assert len(toks) == 8 and all(0 <= t < 512 for t in toks)
