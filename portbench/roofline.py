"""The yardstick of the shares: one H100 SXM's published peaks, and the
operations and bytes that a step or a layer needs, counted from the
configuration's shapes, whatever implements it.

* Operations are the products' multiply-adds (2 each) that the inputs
  need, over the bf16 dense peak: the configuration's dtype is bf16, so
  an f32 implementation is not credited with the f32 peak.
* Bytes are each input read once and each output written once, in the
  configuration's dtype (2 bytes), over the HBM bandwidth.
* Causal products count half the square; routed experts count the
  tokens' top-k copies, not the capacity's padding; a backward pass
  counts two products for each product of the forward pass.

Kept with the benchmark, never imported from the program.
"""
from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s, dense, H100 SXM at 700 W
HBM = 3.35e12           # bytes/s
BYTES = 2               # bf16


def least_s(flops: float, nbytes: float) -> float:
    """The least time a call can take: the larger of its two bounds."""
    return max(flops / PEAK_BF16, nbytes / HBM)


def attention(B: int, S: int, H: int, KVH: int, hd: int) -> tuple[float, float]:
    """Causal attention, forward and backward: QK^T and PV over half the
    square, each with two products in the backward pass; bytes of q, k, v,
    the output's gradient in, the output and q, k, v's gradients out."""
    flops = 3 * 2 * (2 * B * H * S * S * hd) / 2
    nbytes = BYTES * (4 * B * S * H * hd + 4 * B * S * KVH * hd)
    return flops, nbytes


def moe(N: int, D: int, E: int, K: int, F: int) -> tuple[float, float]:
    """The routed expert sublayer, forward and backward: the router's
    product over every token, three expert products over each of the N*K
    copies; bytes of x and the output's gradient in, the router's and the
    experts' weights in and their gradients out, the output and x's
    gradient out."""
    flops = 3 * (2 * N * D * E + 3 * 2 * N * K * D * F)
    weights = D * E + 3 * E * D * F
    nbytes = BYTES * (4 * N * D + 2 * weights)
    return flops, nbytes


def scan(B: int, S: int, H: int, P: int, N: int, chunk: int,
         shared_keys: bool = True) -> tuple[float, float]:
    """The chunked linear recurrence at ``chunk``, forward and backward: in
    each chunk the keys' products (once when shared by the heads) and the
    decayed values' over half the square, the state's update and its
    read-out; bytes of the log-decays, values, keys, queries, the entering
    state and the output's gradient in, the output, the leaving state and
    the inputs' gradients out."""
    Hk = 1 if shared_keys else H
    per_pos = (2 * B * Hk * chunk * N + 2 * B * H * chunk * P) / 2 \
        + 2 * (2 * B * H * P * N)
    flops = 3 * S * per_pos
    ins = B * S * H + B * S * H * P + 2 * B * S * Hk * N + B * H * P * N
    outs = B * S * H * P + B * H * P * N
    nbytes = BYTES * 2 * (ins + outs)
    return flops, nbytes


def step_flops(run: dict, B: int, S: int) -> float | None:
    """A training step's nominal operations at ``B`` x ``S`` tokens, as the
    configuration's family counts them (``reference/<family>.py``'s
    ``step_flops``); None where the family gives no count."""
    from portbench.reference.train import family
    count = getattr(family(run), "step_flops", None)
    return None if count is None else count(run, B, S)


def share(probe: dict | None) -> float | None:
    """A probe's share of its roofline, in percent: the least time over
    the measured one."""
    if not probe:
        return None
    return least_s(probe["flops"], probe["bytes"]) / (probe["ms"] / 1e3) * 100
