"""Attention (``models/layers.py::flash_attention``): its causal forward
and backward alone at the cell's shape, with the model's chunks and mode,
by CUDA events, against ``roofline.attention``'s least time.  Measured
where every layer is attention (the MoE family); a hybrid's shared block
is left to a cell of its own."""
import torch

from portbench import roofline, timing

UNIT = "%"


def probe(live):
    cfg = live.cfg
    if cfg.family not in ("dense", "moe"):
        return None
    from repro_torch.models.layers import flash_attention
    wl = live.workload
    B, S, H, KVH, hd = wl["batch"], wl["seq"], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=live.device).manual_seed(live.seed)
    dt = live.model.embed.dtype
    q, k, v, dout = (torch.randn(shape, generator=gen, device=live.device, dtype=dt)
                     for shape in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd),
                                   (B, S, H, hd)))
    for t in (q, k, v):
        t.requires_grad_()

    def call():
        out = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk, mode=cfg.causal_mode)
        torch.autograd.grad(out, [q, k, v], dout)

    flops, nbytes = roofline.attention(B, S, H, KVH, hd)
    return {"ms": timing.call_ms(call), "flops": flops, "bytes": nbytes}


def read(rec):
    return roofline.share(rec["probes"].get("attn_roofline"))
