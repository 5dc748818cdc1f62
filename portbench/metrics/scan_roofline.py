"""Scan (``models/ssm.py::linear_rnn_chunked``): the Mamba2 recurrence's
forward and backward alone at the cell's shape (the batch's rows and
tokens, the model's heads, head size 64, state size, keys shared by the
heads, its chunk), on float32 inputs as the Mamba2 block hands them over,
by CUDA events, against ``roofline.scan``'s least time.  Measured in the
hybrid family it was written for (one key group, ``d_inner`` from
``ssm_expand``); another family's scan brings a probe at its own shape."""
import torch
import torch.nn.functional as F

from portbench import roofline, timing

UNIT = "%"


def probe(live):
    cfg = live.cfg
    if cfg.family != "hybrid":
        return None
    from repro_torch.models.ssm import linear_rnn_chunked
    wl = live.workload
    B, S, H, N = wl["batch"], wl["seq"], cfg.n_ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    gen = torch.Generator(device=live.device).manual_seed(live.seed)
    dev = live.device

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    log_a = (-F.softplus(rand(B, S, H))).requires_grad_()
    v = rand(B, S, H, P).requires_grad_()
    k = F.silu(rand(B, S, 1, N)).requires_grad_()
    q = F.silu(rand(B, S, 1, N)).requires_grad_()
    h0 = torch.zeros((B, H, P, N), device=dev)
    dy = rand(B, S, H, P)

    def call():
        y, _ = linear_rnn_chunked(log_a, v, k, q, h0, chunk=cfg.ssm_chunk)
        torch.autograd.grad(y, [log_a, v, k, q], dy)

    flops, nbytes = roofline.scan(B, S, H, P, N, cfg.ssm_chunk)
    return {"ms": timing.call_ms(call), "flops": flops, "bytes": nbytes}


def read(rec):
    return roofline.share(rec["probes"].get("scan_roofline"))
