"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out chiprun_out/calib_<cell>.json]

For each of ``--seeds``: the program's first steps, set up exactly as a
run sets them up, against the reference's (the lower reading of each
number is the largest over these seeds).  For each of ``--control-seeds``:
the reference put in the program's place and computed in float8 (the
control), and the reference on half of each batch (the fault "half of the
batch left out, the mean taken over the rest"), each against the float32
reference (the upper readings).  One JSON line a reading, and a summary.
"""
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness, inputs, judge  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
from portbench.traffic import train  # noqa: E402

NUMBERS = judge.TRAINING


def program_readings(ctx, device) -> dict:
    tr, opt, specs = train.build(ctx, device)
    out = train.first_steps(tr, opt, specs, ctx.seed)
    del tr, opt
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "leaves"}),
              flush=True)

    for kind, seed in [("program", s) for s in seeds] + \
                      [("control", s) for s in controls]:
        ns = harness.parse(["--workload", args.workload, "--seed", str(seed),
                            "--seconds", "0"])
        ctx = harness.context(ns, time.perf_counter(), args.device)
        run, wl = ctx.config["run"], ctx.workload
        feed = inputs.TokenBatches(run["vocab_size"], wl["batch"], wl["seq"], seed)

        def follow(**kw):
            return ref_train.follow(run, seed, feed.batch_at, train.HP,
                                    train.FOLLOWED, device, **kw)
        t = time.perf_counter()
        if kind == "program":
            prog = program_readings(ctx, device)
            train.free()
            pairs = {"program": (prog, follow())}
        else:
            ref = follow()
            pairs = {"control_float8": (follow(precision="float8"), ref),
                     "fault_half_batch": (follow(rows=wl["batch"] // 2), ref)}
        for name, (a, b) in pairs.items():
            g = judge.gaps(a, b)
            emit({"seed": seed, "reading": name,
                  **{k: g[k] for k in NUMBERS + judge.LEAVES},
                  "loss": a["loss"], "ref_loss": b["loss"],
                  "leaves": {"grad": a["grad"], "ref_grad": b["grad"],
                             "change": a["change"], "ref_change": b["change"],
                             "grad_diff": g["leaf_grad_diff"],
                             "change_diff": g["leaf_change_diff"]}})
        train.free()
        emit({"seed": seed, "kind": kind, "seconds": time.perf_counter() - t})

    summary = {}
    for name in ("program", "control_float8", "fault_half_batch"):
        rows = [r for r in lines if r.get("reading") == name]
        if rows:
            agg = max if name == "program" else min
            summary[name] = {k: agg(r[k] for r in rows) for k in NUMBERS}
    dev = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    emit({"summary": summary, "workload": args.workload, "device": dev,
          "seeds": seeds, "control_seeds": controls})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
