"""MoE block (``models/moe.py::moe_block``): its forward and backward
alone at the cell's shape (the batch's tokens through layer 0's router
and gated experts), by CUDA events, against ``roofline.moe``'s least
time.  Measured in the MoE family it was written for, where every layer
is attention and experts; another family's experts bring a probe of
their own."""
import torch

from portbench import roofline, timing

UNIT = "%"


def probe(live):
    cfg = live.cfg
    if cfg.family != "moe":
        return None
    from repro_torch.models.moe import moe_block
    wl, blk = live.workload, live.model.layers[0]
    B, S, D = wl["batch"], wl["seq"], cfg.d_model
    gen = torch.Generator(device=live.device).manual_seed(live.seed)
    dt = blk.router.dtype
    x = torch.randn((B, S, D), generator=gen, device=live.device, dtype=dt)
    x.requires_grad_()
    dout = torch.randn((B, S, D), generator=gen, device=live.device, dtype=dt)
    ws = [blk.router, blk.we_gate, blk.we_up, blk.we_down]

    def call():
        out, _ = moe_block(x, *ws, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, act=cfg.act)
        torch.autograd.grad(out, [x, *ws], dout)

    flops, nbytes = roofline.moe(B * S, D, cfg.n_experts, cfg.top_k,
                                 cfg.moe_d_ff or cfg.d_ff)
    return {"ms": timing.call_ms(call), "flops": flops, "bytes": nbytes}


def read(rec):
    return roofline.share(rec["probes"].get("moe_roofline"))
