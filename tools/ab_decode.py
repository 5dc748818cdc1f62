"""A/B of the port's plain decode step between two checkouts, on one card.

Each checkout runs in its own process, in the order A, B, B, A: qwen3-0.6b
whole, qwen3-moe-30b-a3b cut to 4 layers and llama-3.2-vision-11b cut to
10, bf16 weights from a seed, a prefill of 8 x 128 then 32 greedy decode
steps, twice; the median ms of the second pass's steps is printed per
model, one JSON line per process::

    python tools/ab_decode.py PARENT_CHECKOUT CHANGE_CHECKOUT
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

STEP = r'''
import json, statistics, time
import torch
from repro_torch.configs.base import get_arch
from repro_torch.models import params as P
from repro_torch.models.api import build_model

res = {}
for arch, layers in (("qwen3-0.6b", None), ("qwen3-moe-30b-a3b", 4),
                     ("llama-3.2-vision-11b", 10)):
    cfg = get_arch(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    P.from_reference(model, P.init_params(model.param_defs(), gen,
                                          cfg.dtype, "cuda"))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 128),
                                     device="cuda", generator=gen)}
    if cfg.family == "vlm":
        batch["vision_embed"] = torch.randn(
            (8, cfg.vision_tokens, cfg.d_model), device="cuda",
            generator=gen).to(torch.bfloat16)
    times = []
    for _ in range(2):
        logits, cache = model.prefill(batch, max_len=128 + 40)
        nxt = logits.argmax(-1, keepdim=True)
        for _ in range(32):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = model.decode_step(cache, {"tokens": nxt})
            nxt = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    res[arch] = statistics.median(times[32:]) * 1e3
    del model, cache
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def main(a: str, b: str) -> None:
    for tree in (a, b, b, a):
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        out = subprocess.run([sys.executable, "-c", STEP], env=env,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise SystemExit(out.stderr[-2000:])
        rec = {"tree": tree, "decode_ms": json.loads(
            out.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
