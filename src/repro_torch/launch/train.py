"""Training launcher on the port.

Runs an architecture (reduced, or at full width) with the substrate: the
train step, the deterministic data pipeline, async checkpoints, the
straggler watchdog, and the paper's measurement subsystem writing a
per-worker sparse profile for post-mortem analysis::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--reduced] [--steps 50] [--batch 8] [--seq 128] \\
        [--profile-dir runs/profiles] [--ckpt-dir runs/ckpt] [--resume] \\
        [--device cuda|cpu]

The flags are the reference's (``repro.launch.train``) plus ``--device``:
``cuda`` (the default) trains on the card, and a host without one raises;
``cpu`` trains on the CPU.  Parameters are initialised in ``cfg.dtype``
(bf16 at full width, f32 under ``--reduced``) with f32 Adam moments: at
full width the reference's own step traces only so (ROADMAP.md §3).
``--resume`` continues from the newest checkpoint in ``--ckpt-dir``,
either package's.  With ``--profile-dir`` it writes
``structs/step.struct.json`` and ``worker0.rprf``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch, reduced
from repro_torch.data import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.profiling import Profiler, dispatch_attrib
from repro_torch.train.loop import Trainer, TrainerConfig, make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; ``cuda`` on a host without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA card, and "
                           "torch.cuda.is_available() is False on this host; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)


def attribute_step(profiler: Profiler, cfg, batch: int, seq: int,
                   struct_dir: str) -> None:
    """Trace one train step on a ``meta`` twin of the model (nothing is
    computed) and attribute it to the profile's device contexts."""
    meta = build_model(cfg, device="meta")
    opt = init_opt_state(dict(meta.named_parameters()))
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    records, flops = dispatch_attrib.trace_step(
        make_train_step(meta, AdamWConfig()), opt, {"tokens": tokens})
    profiler.attribute_step(records, measured={"flops": flops},
                            struct_dir=struct_dir)


def main(argv=None) -> tuple[Trainer, dict]:
    """Train as the flags say; returns the Trainer (its ``history`` holds
    one record per step) and its optimizer state, so a caller may go on."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the CUDA card (a host without one "
                         "raises) or on the CPU")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=device)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    profiler = Profiler({"rank": 0, "stream": 0, "kind": "host"}) \
        if args.profile_dir else None
    tr = Trainer(model, AdamWConfig(lr=args.lr, warmup_steps=10),
                 TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                               microbatches=args.microbatches,
                               deadline_s=30.0),
                 pipe, ckpt=ckpt, profiler=profiler)
    start = 0
    opt = None
    if args.resume and ckpt is not None:
        step, state = ckpt.restore()
        if state is not None:
            start = step
            opt = tr.load_checkpoint(state)
            print(f"resumed from step {step}")
    if opt is None:
        opt = tr.init_state(torch.Generator(device=device).manual_seed(0))

    if profiler is not None:
        attribute_step(profiler, cfg, args.batch, args.seq,
                       os.path.join(args.profile_dir, "structs"))

    opt = tr.run(opt, start_step=start, steps=args.steps)
    print(json.dumps(tr.history[-3:], indent=2))
    if profiler is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.finish(os.path.join(args.profile_dir, "worker0.rprf"))
        print(f"profile written to {args.profile_dir}/worker0.rprf")
    return tr, opt


if __name__ == "__main__":
    main()
