"""The frozen operation and byte counts against counts made by hand (or
by brute force) at small shapes."""
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import roofline  # noqa: E402


def test_attention_counts_half_the_square():
    B, S, H, KVH, hd = 2, 6, 4, 2, 8
    # each (query, key) pair: QK^T and PV, 2 * hd multiply-adds each
    pairs = B * H * S * S / 2
    forward = pairs * 2 * (2 * hd)
    flops, nbytes = roofline.attention(B, S, H, KVH, hd)
    assert flops == 3 * forward
    assert nbytes == 2 * (4 * B * S * H * hd + 4 * B * S * KVH * hd)


def test_moe_counts_routed_copies_not_capacity():
    N, D, E, K, F = 4, 8, 2, 1, 4
    flops, nbytes = roofline.moe(N, D, E, K, F)
    assert flops == 2688          # 3 * (2*4*8*2 + 3 * 2*4*1*8*4)
    assert nbytes == 1088         # 2 * (4*4*8 + 2 * (8*2 + 3*2*8*4))


def test_scan_counts_the_chunked_algorithm():
    B, S, H, P, N, c = 1, 8, 2, 3, 4, 4
    fwd = 0
    for _ in range(S // c):
        fwd += 2 * B * c * c * N / 2          # C B^T, shared keys, causal
        fwd += 2 * B * H * c * c * P / 2      # (L o CB^T) V, causal
        fwd += 2 * B * H * c * P * N          # the state's update
        fwd += 2 * B * H * c * P * N          # its read-out
    flops, nbytes = roofline.scan(B, S, H, P, N, c)
    assert flops == 3 * fwd
    ins = B * S * H + B * S * H * P + 2 * B * S * N + B * H * P * N
    outs = B * S * H * P + B * H * P * N
    assert nbytes == 2 * 2 * (ins + outs)


def _products(run, B, S):
    """The parameters in products, by brute force over the leaves."""
    from portbench.reference.train import family
    total = 0
    for name, shape, init in family(run).param_specs(run):
        leaf = name.split(".")[-1]
        if len(shape) < 2 or name in ("embed",) or leaf in ("conv_w",):
            continue
        n = 1
        for d in shape:
            n *= d
        if leaf.startswith("we_"):
            n = n * run["top_k"] // run["n_experts"]
        if name.startswith("shared_attn."):
            n *= -(-run["n_layers"] // run["attn_every"])
        total += n
    return total


def test_step_flops_are_six_times_the_products_plus_the_squares():
    for config in ("qwen3-moe-30b-a3b", "zamba2-7b"):
        run = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())["run"]
        B, S = 8, 1024
        hd = run.get("head_dim") or run["d_model"] // run["n_heads"]
        n_attn = (run["n_layers"] if run["family"] == "moe"
                  else -(-run["n_layers"] // run["attn_every"]))
        want = 6 * _products(run, B, S) * B * S + n_attn * roofline.attention(
            B, S, run["n_heads"], run["n_kv_heads"], hd)[0]
        if run["family"] != "moe":
            DI = run["ssm_expand"] * run["d_model"]
            want += run["n_layers"] * roofline.scan(B, S, DI // 64, 64, run["ssm_state"],
                                                    run["ssm_chunk"])[0]
        assert roofline.step_flops(run, B, S) == want


def test_a_share_is_the_least_time_over_the_time():
    for flops, nbytes in itertools.product((1e9, 1e12), (1e6, 1e10)):
        least = roofline.least_s(flops, nbytes)
        assert roofline.share({"flops": flops, "bytes": nbytes, "ms": least * 1e3}) == 100.0
    assert roofline.share(None) is None
