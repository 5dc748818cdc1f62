"""The port's train step on DTensors across 8 CPU ranks matches its
unsharded step: the counterpart of ``tests/test_distributed.py::
test_sharded_train_step_runs_and_matches_single_device``.

Reduced yi-6b cut to 2 layers (f32), batch 8 x 32 from the token
pipeline, one AdamW step.  The unsharded step runs on each rank; the
sharded one on a (2, 4) ``data`` x ``model`` mesh with the reference's
rules and ``fsdp=True`` (so parameters split over both axes, the queries'
heads over ``model`` with the keys and values expanded, the vocab over
``model``), each rank a spawned process on one ``gloo`` group.  The
bounds are the reference test's own: loss within 1e-3, every parameter
within 5e-3; and every gradient within 1e-5 of its tensor's largest
entry (AdamW's first steps move each parameter by about ``lr`` whatever
its gradient's size, so the parameters alone cannot show a wrong
gradient).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_TOL = 1e-3, 5e-3
# each gradient against its largest entry (f32 sums in other orders)
GRAD_TOL = 1e-5

WORKER = """
    import copy
    import json
    import sys

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.sharding.specs import distribute, set_rules
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state


    def worker(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=8)
        cfg = reduced(get_arch("yi-6b")).replace(n_layers=2)
        model = build_model(cfg, device="cpu")
        P.from_reference(model, P.init_params(
            model.param_defs(), torch.Generator().manual_seed(0),
            torch.float32, "cpu"))
        tokens = torch.from_numpy(
            TokenPipeline(cfg.vocab_size, 32, 8).batch_at(0))

        ref = copy.deepcopy(model)
        _, g_ref = value_and_grad(ref, {"tokens": tokens})
        ref_opt = init_opt_state(dict(ref.named_parameters()))
        m1 = make_train_step(ref, AdamWConfig())(ref_opt, {"tokens": tokens})

        mesh = make_host_mesh(2, 4)
        rules = rules_for(cfg, mesh, "train", fsdp=True)
        P.distribute_params(model, mesh, rules)
        split = sum(any(x.is_shard() for x in p.placements)
                    for p in model.parameters())
        opt = init_opt_state(dict(model.named_parameters()))
        batch = {"tokens": distribute(tokens, ("batch", "seq"), mesh, rules)}
        # every gradient, each against its tensor's largest entry
        with set_rules(mesh, rules):
            _, g = value_and_grad(model, batch)
        grad_diff = max(float((P.whole(g[n]) - t).abs().max())
                        / float(t.abs().max()) for n, t in g_ref.items())
        m2 = make_train_step(model, AdamWConfig(), mesh=mesh,
                             rules=rules)(opt, batch)
        loss2 = m2["loss"]
        if isinstance(loss2, DTensor):
            loss2 = loss2.full_tensor()
        ref_p = dict(ref.named_parameters())
        diff = max(float((p.full_tensor() - ref_p[n]).abs().max())
                   for n, p in model.named_parameters())
        if rank == 0:
            print(json.dumps({"loss_ref": float(m1["loss"]),
                              "loss": float(loss2), "param_diff": diff,
                              "grad_diff": grad_diff,
                              "split": split, "rules": rules.rules,
                              "n": len(ref_p)}), flush=True)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]),), nprocs=8)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_train_step_matches_unsharded(tmp_path):
    script = tmp_path / "sharded_step.py"
    script.write_text(textwrap.dedent(WORKER))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(_free_port())],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(next(line for line in out.stdout.splitlines()
                          if line.startswith("{")))
    assert res["rules"]["fsdp"] == "data" and res["rules"]["heads"] == "model"
    assert res["split"] > res["n"] // 2  # most parameters are split
    assert abs(res["loss"] - res["loss_ref"]) < LOSS_TOL, res
    assert res["param_diff"] < PARAM_TOL, res
    assert res["grad_diff"] < GRAD_TOL, res
