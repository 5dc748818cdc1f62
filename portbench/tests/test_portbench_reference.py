"""The plain references against the port, at tiny sizes on the CPU: the
loss and every gradient of each configuration in ``BENCHMARK.json`` at
its file's ``tiny`` sizes, the same dropped copies under capacity, one
AdamW update."""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import inputs  # noqa: E402
from portbench.reference import common, qwen3_moe, zamba2  # noqa: E402
from portbench.reference.train import family  # noqa: E402

CONFIGS = sorted(c["name"] for c in
                 json.loads((ROOT / "BENCHMARK.json").read_text())["configs"])


def tiny_run(config: str) -> dict:
    """The configuration's ``run`` with its ``tiny`` sizes for the CPU."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    return {**cfg["run"], **cfg["tiny"]}


def port_model(run: dict, seed: int):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.api import build_model
    model = build_model(ModelConfig(**run), device="cpu")
    inputs.load_into(model, family(run).param_specs(run), seed)
    return model


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_gradients_match_the_port(config):
    from repro_torch.train.loop import value_and_grad
    run = tiny_run(config)
    model = port_model(run, 11)
    tokens = torch.from_numpy(inputs.TokenBatches(run["vocab_size"], 4, 32, 11).batch_at(0))
    loss, grads = value_and_grad(model, {"tokens": tokens})
    leaves = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
    ref = family(run).loss(leaves, tokens, run, common.mm_f32)
    ref_grads = torch.autograd.grad(ref, list(leaves.values()))
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    for (n, g), r in zip(grads.items(), ref_grads):
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) <= 1e-3 * scale, n


def test_capacity_and_dropped_copies_match_the_port():
    from repro_torch.models import moe
    N, K, E = 64, 2, 8
    gen = torch.Generator().manual_seed(3)
    # skewed routing, so that some experts drop copies
    eidx = torch.multinomial(torch.tensor([8.0, 4, 2, 1, 1, 1, 1, 1]), N * K,
                             replacement=True, generator=gen).reshape(N, K)
    for factor in (0.5, 1.0, 1.25):
        C = qwen3_moe.capacity(N, K, factor, E)
        assert C == moe.sorted_capacity(N, K, factor, E)
        C = 8  # fewer slots than the busiest experts' copies
        keep = moe._positions(eidx.reshape(-1), E) < C
        kept, counts = qwen3_moe.kept_copies(eidx, C, E)
        assert keep.sum() < N * K
        assert sorted(kept.tolist()) == torch.nonzero(keep)[:, 0].tolist()
        assert counts.tolist() == torch.bincount(
            eidx.reshape(-1)[keep], minlength=E).tolist()


def test_one_adamw_update_matches_the_port():
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
    from portbench.traffic.train import HP
    gen = torch.Generator().manual_seed(5)
    params = {f"w{i}": (torch.randn(33, 17, generator=gen) * 0.05).to(torch.bfloat16)
              for i in range(3)}
    grads = {n: torch.randn(p.shape, generator=gen) * 3 for n, p in params.items()}
    cfg = AdamWConfig(**HP)
    port_p = {n: p.clone() for n, p in params.items()}
    state = init_opt_state(port_p)
    for step in (1, 2):
        adamw_update(port_p, grads, state, cfg)
    ref_p = dict(params)
    m = {n: torch.zeros(p.shape) for n, p in params.items()}
    v = copy.deepcopy(m)
    for step in (1, 2):
        common.adamw_step(ref_p, grads, m, v, step, HP)
    for n in params:
        torch.testing.assert_close(state["m"][n], m[n], rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(state["v"][n], v[n], rtol=1e-5, atol=1e-12)
        torch.testing.assert_close(port_p[n].float(), ref_p[n].float(),
                                   rtol=0, atol=2 ** -8 * 0.2)


def test_the_quadratic_scan_matches_the_chunked_one():
    from repro_torch.models.ssm import linear_rnn_chunked
    gen = torch.Generator().manual_seed(7)
    B, S, H, P, N = 2, 40, 3, 4, 5
    log_a = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen))
    v = torch.randn(B, S, H, P, generator=gen)
    k = torch.randn(B, S, N, generator=gen)
    q = torch.randn(B, S, N, generator=gen)
    y, _ = linear_rnn_chunked(log_a, v, k[:, :, None], q[:, :, None],
                              torch.zeros(B, H, P, N), chunk=16)
    torch.testing.assert_close(zamba2.ssd(log_a, v, k, q, common.mm_f32, heads=2),
                               y, rtol=1e-4, atol=1e-5)


def test_the_control_rounds_to_float8():
    gen = torch.Generator().manual_seed(9)
    a = torch.randn(16, 32, generator=gen, requires_grad=True)
    b = torch.randn(32, 8, generator=gen, requires_grad=True)
    exact, low = a @ b, common.mm_fp8(a, b)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
    ga, gb = torch.autograd.grad(low.sum(), [a, b])
    assert ga.shape == a.shape and gb.shape == b.shape


def test_attention_in_query_blocks_equals_attention_whole():
    gen = torch.Generator().manual_seed(13)
    q = torch.randn(3, 24, 4, 8, generator=gen)
    k, v = (torch.randn(3, 24, 2, 8, generator=gen) for _ in range(2))
    whole = common.causal_attention(q, k, v, common.mm_f32)
    blocks = common.causal_attention(q, k, v, common.mm_f32, budget=2 * 4 * 24 * 4 * 5)
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    # against a plain masked softmax over the whole square
    kk, vv = k.repeat_interleave(2, 2), v.repeat_interleave(2, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / 8 ** 0.5
    s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-6)
