"""The MoE, SSM and hybrid families on DTensors across 8 CPU ranks match
their unsharded steps: the counterpart of ``tests/test_torch_sharded_step.py``
for the families whose dry-run runs explicit reshards (the MoE dispatch's
summed buffers and combine, the shard-by-shard scans, the sequence-split
decode), which the dry-run, on ``meta`` tensors, never computes.

One spawn of 8 ``gloo`` ranks on a (2, 4) ``data`` x ``model`` mesh, f32,
runs every case; each rank also runs the unsharded model.  The train
cases take one AdamW step from the same initial parameters and batch
(8 x 32 from the token pipeline) with the reference's rules and
``fsdp=True``, and hold the loss within 1e-3 and every parameter within
5e-3, the reference test's own bounds, and every gradient within 5e-5 of
its tensor's largest entry (AdamW's first step moves each parameter by
about ``lr`` whatever its gradient, so the parameters cannot show a wrong
one):

* reduced qwen3-moe-30b-a3b, EP (4 experts on ``model``), both
  dispatches; the sorted one at a capacity factor of 1, so that copies
  are dropped by the global rule;
* reduced grok-1-314b with 6 experts, TP-in-expert (``expert_ff`` on
  ``model``, the sorted dispatch's capacity over ``data``), both
  dispatches;
* reduced zamba2-7b with 4 SSM heads (the hybrid: Mamba2 layers and the
  shared attention) and reduced xlstm-350m at 4 blocks (mLSTM and sLSTM).

The ``decode_sp`` case: reduced zamba2-7b at batch 1 prefills 12 tokens
into a 16-position cache unsharded; the same cache, split by position
over ``data`` (the ``decode_sp`` rules), takes one ``decode_step`` on the
mesh, through the dry-run's serving body (``no_grad``: DTensors make
no views under inference mode).  Its logits are within 1e-5 of the largest |logit| of the
unsharded step, the row it writes equals the unsharded row, and no other
row changes.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_TOL, LOGIT_TOL = 1e-3, 5e-3, 1e-5
# each gradient against its largest entry: f32 sums in other orders (the
# SSM scans' run to ~1e-5)
GRAD_TOL = 5e-5
TRAIN = {
    "moe_ep_sorted": ("qwen3-moe-30b-a3b", {"capacity_factor": 1.0}),
    "moe_ep_rowwise": ("qwen3-moe-30b-a3b", {"moe_dispatch": "rowwise"}),
    "moe_tp_sorted": ("grok-1-314b", {"n_experts": 6}),
    "moe_tp_rowwise": ("grok-1-314b", {"n_experts": 6,
                                       "moe_dispatch": "rowwise"}),
    "hybrid": ("zamba2-7b", {"ssm_heads": 4}),
    "xlstm": ("xlstm-350m", {"n_layers": 4}),
}

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
    from repro_torch.launch.dryrun import _serving
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.sharding.specs import distribute, set_rules
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    TRAIN = {train!r}


    def model_of(arch, over):
        cfg = reduced(get_arch(arch)).replace(**over)
        model = build_model(cfg, device="cpu")
        P.from_reference(model, P.init_params(
            model.param_defs(), torch.Generator().manual_seed(0),
            torch.float32, "cpu"))
        return cfg, model


    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t


    def train_case(arch, over, mesh):
        cfg, model = model_of(arch, over)
        tokens = torch.from_numpy(
            TokenPipeline(cfg.vocab_size, 32, 8).batch_at(0))
        ref = copy.deepcopy(model)
        _, g_ref = value_and_grad(ref, {{"tokens": tokens}})
        m1 = make_train_step(ref, AdamWConfig())(
            init_opt_state(dict(ref.named_parameters())),
            {{"tokens": tokens}})
        rules = rules_for(cfg, mesh, "train", fsdp=True)
        P.distribute_params(model, mesh, rules)
        batch = {{"tokens": distribute(tokens, ("batch", "seq"), mesh,
                                       rules)}}
        with set_rules(mesh, rules):
            _, g = value_and_grad(model, batch)
        grad_diff = max(float((P.whole(g[n]) - t).abs().max())
                        / max(float(t.abs().max()), 1e-30)
                        for n, t in g_ref.items())
        m2 = make_train_step(model, AdamWConfig(), mesh=mesh, rules=rules)(
            init_opt_state(dict(model.named_parameters())), batch)
        ref_p = dict(ref.named_parameters())
        diff = max(float((p.full_tensor() - ref_p[n]).abs().max())
                   for n, p in model.named_parameters())
        return {{"loss_ref": float(m1["loss"]),
                 "loss": float(full(m2["loss"])), "param_diff": diff,
                 "grad_diff": grad_diff, "rules": {{k: rules.rules[k] for k in (
                     "experts", "expert_ff", "moe_cap", "ssm_inner")}}}}


    def decode_sp_case(mesh):
        cfg, model = model_of("zamba2-7b", {{"ssm_heads": 4}})
        prompt = torch.from_numpy(
            TokenPipeline(cfg.vocab_size, 12, 1).batch_at(0))
        nxt = torch.from_numpy(TokenPipeline(cfg.vocab_size, 1, 1,
                                             seed=1).batch_at(0))
        _, cache = model.prefill({{"tokens": prompt}}, max_len=16)
        before = {{k: cache[k].clone() for k in ("attn_k", "attn_v")}}
        logits_ref, ref_cache = model.decode_step(
            {{"ssm": {{k: v.clone() for k, v in cache["ssm"].items()}},
              "attn_k": cache["attn_k"].clone(),
              "attn_v": cache["attn_v"].clone(), "len": cache["len"]}},
            {{"tokens": nxt}})
        rules = rules_for(cfg, mesh, "decode_sp")
        P.distribute_params(model, mesh, rules)
        defs = model.cache_defs(1, 16)

        def split(t, d):  # a copy made outside inference mode
            return distribute(t.clone(), d.logical, mesh, rules)

        sharded = {{
            "ssm": {{k: split(cache["ssm"][k], defs["ssm"][k])
                    for k in ("h", "conv")}},
            "attn_k": split(cache["attn_k"], defs["attn_k"]),
            "attn_v": split(cache["attn_v"], defs["attn_v"]),
            "len": cache["len"]}}
        with set_rules(mesh, rules):  # the dry-run's body: DTensors
            # cannot make views under inference mode
            logits, out = _serving(model, "decode_step")(
                model, sharded, {{"tokens": nxt}})
        logits = full(logits)
        at = cache["len"]
        res = {{"logit_err": float((logits - logits_ref).abs().max()),
                "logit_max": float(logits_ref.abs().max()),
                "kv_split": [str(p) for p in out["attn_k"].placements],
                "len": out["len"], "len_ref": ref_cache["len"]}}
        for k in ("attn_k", "attn_v"):
            got = full(out[k])
            res[k + "_row"] = float((got[:, :, at] - ref_cache[k][:, :, at]
                                     ).abs().max())
            keep = torch.ones(got.shape[2], dtype=torch.bool)
            keep[at] = False
            res[k + "_rest"] = float((got[:, :, keep] - before[k][:, :, keep]
                                      ).abs().max())
            res[k + "_row_norm"] = float(ref_cache[k][:, :, at].abs().max())
        res["ssm_h"] = float((full(out["ssm"]["h"]) - ref_cache["ssm"]["h"]
                              ).abs().max())
        return res


    def worker(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                                rank=rank, world_size=8)
        mesh = make_host_mesh(2, 4)
        out = {{name: train_case(arch, over, mesh)
               for name, (arch, over) in TRAIN.items()}}
        out["decode_sp"] = decode_sp_case(mesh)
        if rank == 0:
            print(json.dumps(out), flush=True)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]),), nprocs=8)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    script = tmp_path_factory.mktemp("sharded") / "sharded_families.py"
    script.write_text(textwrap.dedent(WORKER.format(train=TRAIN)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(_free_port())],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(next(line for line in out.stdout.splitlines()
                           if line.startswith("{")))


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_sharded_family_step_matches_unsharded(results, case):
    res = results[case]
    rules = res["rules"]
    if case.startswith("moe_ep"):
        assert rules["experts"] == "model" and rules["expert_ff"] is None
    elif case.startswith("moe_tp"):
        assert rules["experts"] is None and rules["expert_ff"] == "model"
        assert rules["moe_cap"] == "data"
    else:
        assert rules["ssm_inner"] == "model"
    assert abs(res["loss"] - res["loss_ref"]) < LOSS_TOL, res
    assert res["param_diff"] < PARAM_TOL, res
    assert res["grad_diff"] < GRAD_TOL, res


def test_sequence_split_decode_matches_unsharded(results):
    res = results["decode_sp"]
    assert res["kv_split"][0] == "S(2)"  # positions over data
    assert res["logit_err"] <= LOGIT_TOL * res["logit_max"], res
    assert res["len"] == res["len_ref"]


def test_sequence_split_decode_writes_one_row(results):
    res = results["decode_sp"]
    for k in ("attn_k", "attn_v"):
        assert res[k + "_row_norm"] > 0
        assert res[k + "_row"] <= 1e-6 * res[k + "_row_norm"], res
        assert res[k + "_rest"] == 0.0, res
    assert res["ssm_h"] < 1e-5, res
