"""The elastic restore across meshes on the CPU: the counterpart of
``tests/test_distributed.py::test_elastic_restore_across_mesh_sizes``.

Reduced qwen3-0.6b cut to 1 layer (f32), batch 8 x 16 from the token
pipeline, ``AdamWConfig(lr=1e-3)``, the reference's rules without FSDP
unless a case says otherwise.  The reference trains 2 steps on a (2, 4)
mesh of 8 forced host devices (a subprocess), checkpoints, and takes a
third step; its initial parameters, written as a step-0 checkpoint, are
the port's too.  One spawned script then runs every case of the port on
8 ``gloo`` ranks (each a process): a (2, 4) ``Trainer`` with an async
checkpoint manager, restores onto (4, 2) with and without ``fsdp`` and
into a model with no mesh, the reference's checkpoint restored onto
(4, 2), a plain Trainer's checkpoint resumed on a mesh, a tree of
DTensors saved asynchronously (rank 0 alone writes), and saving or
restoring DTensors once the group is gone.  The bounds are the reference
test's: the next loss within 1e-4 of the uninterrupted one; the (2, 4)
losses within 1e-5 of the reference's.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.sharding.specs import NamedSharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOL, RESUME_TOL = 1e-5, 1e-4

REFERENCE = """
    import json, sys
    import jax, jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs.base import get_arch, reduced
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models import params as PD
    from repro.models.api import build_model, rules_for
    from repro.train.loop import make_train_step
    from repro.train.optimizer import AdamWConfig, init_opt_state

    out = sys.argv[1]
    cfg = reduced(get_arch("qwen3-0.6b")).replace(n_layers=1)
    model = build_model(cfg)
    pipe = TokenPipeline(cfg.vocab_size, 16, 8)
    mesh = make_host_mesh(2, 4)
    rules = rules_for(cfg, mesh, "train", fsdp=False)
    step = jax.jit(make_train_step(model, AdamWConfig(lr=1e-3), mesh=mesh,
                                   rules=rules))
    params = PD.init_params(model.param_defs(), 0, jnp.float32)
    opt = init_opt_state(params)
    CheckpointManager(out + "/init", async_save=False).save(
        0, {"params": params, "opt": opt})
    losses = []
    with mesh:
        for s in range(3):
            if s == 2:
                CheckpointManager(out + "/ref_ckpt", async_save=False).save(
                    2, {"params": params, "opt": opt})
            params, opt, m = step(params, opt,
                                  {"tokens": jnp.asarray(pipe.batch_at(s))})
            losses.append(float(m["loss"]))
    print(json.dumps({"losses": losses}))
"""

PORT = """
    import json
    import os
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.sharding.specs import NamedSharding
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig

    CFG = reduced(get_arch("qwen3-0.6b")).replace(n_layers=1)
    PIPE = TokenPipeline(CFG.vocab_size, 16, 8)


    MESHES = {}


    def layout(shape, fsdp):
        if shape is None:
            return None, None
        if shape not in MESHES:
            MESHES[shape] = make_host_mesh(*shape)
        mesh = MESHES[shape]
        return mesh, rules_for(CFG, mesh, "train", fsdp=fsdp)


    def trainer(shape, fsdp=False, ckpt=None, every=2):
        mesh, rules = layout(shape, fsdp)
        model = build_model(CFG, device="cpu")
        if mesh is not None:
            P.distribute_params(model, mesh, rules)
        return Trainer(model, AdamWConfig(lr=1e-3),
                       TrainerConfig(steps=3, ckpt_every=every), PIPE,
                       ckpt=ckpt, mesh=mesh, rules=rules)


    def state_shardings(shape, fsdp):
        mesh, rules = layout(shape, fsdp)
        tree = P.shardings(build_model(CFG, device="meta").param_defs(),
                           rules, mesh)
        return {"params": tree, "opt": {"m": tree, "v": tree}}


    def resume(ckpt_dir, shape, fsdp=False, shardings=None):
        step, state = CheckpointManager(ckpt_dir).restore(
            shardings=shardings)
        tr = trainer(shape, fsdp)
        opt = tr.load_checkpoint(state)
        tr.run(opt, start_step=step, steps=1)
        placed = all(type(p).__name__ == "DTensor"
                     for p in tr.model.parameters())
        return tr.history[0]["loss"], placed


    def worker(rank, port, d):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=8)
        res = {}
        # (2, 4): the reference's initial state, restored onto the mesh
        tr = trainer((2, 4), ckpt=CheckpointManager(d + "/port_ckpt"))
        _, init = CheckpointManager(d + "/init").restore(
            shardings=state_shardings((2, 4), False))
        tr.run(tr.load_checkpoint(init), start_step=0, steps=3)
        res["losses_2x4"] = [h["loss"] for h in tr.history]
        res["port_ckpt"] = sorted(os.listdir(d + "/port_ckpt"))
        for name, args in (
                ("4x2", ((4, 2), False, state_shardings((4, 2), False))),
                ("4x2_fsdp", ((4, 2), True, None)),
                ("plain", (None,))):
            res[name], res[name + "_placed"] = resume(d + "/port_ckpt",
                                                      *args)
        # the reference's (2, 4) checkpoint onto (4, 2)
        res["ref_to_4x2"], _ = resume(d + "/ref_ckpt", (4, 2), False,
                                      state_shardings((4, 2), False))
        # a plain Trainer's checkpoint (rank 0 writes) resumed on (2, 4)
        # under FSDP
        mgr = CheckpointManager(d + "/plain_ckpt", async_save=False)
        tr = trainer(None, ckpt=mgr)
        tr.run(tr.load_checkpoint(init), start_step=0, steps=3)
        res["plain_losses"] = [h["loss"] for h in tr.history]
        res["plain_to_2x4_fsdp"], _ = resume(d + "/plain_ckpt", (2, 4), True)

        # a tree of DTensors on (4, 2), saved asynchronously
        shard = state_shardings((4, 2), True)
        _, tree = CheckpointManager(d + "/port_ckpt").restore(shardings=shard)
        leaves = list(P.flatten(tree["params"]))
        res["restored_placements"] = {
            k: [repr(x) for x in v.placements] for k, v in leaves}
        res["restored_expected"] = {
            k: [repr(x) for x in s.placements]
            for k, s in P.flatten(shard["params"])}
        full = {k: P.whole(v).numpy() for k, v in leaves}
        mgr = CheckpointManager(d + "/dtensor_ckpt", async_save=True)
        writes = []
        write = mgr._write
        mgr._write = lambda *a: (writes.append(a[0]), write(*a))
        mgr.save(2, {"params": tree["params"]})
        mgr.wait()
        res["dtensor_listing"] = sorted(os.listdir(d + "/dtensor_ckpt"))
        res["writes"] = [None] * 8
        dist.all_gather_object(res["writes"], writes)
        if rank == 0:
            np.savez(d + "/full.npz", **full)
        x = tree["params"]["embed"]
        mesh = x.device_mesh
        dist.barrier()
        dist.destroy_process_group()
        res["no_group"] = {}
        for what, fn in (
                ("save", lambda: mgr.save(3, {"x": x})),
                ("restore", lambda: mgr.restore(shardings={
                    "params": {"embed": NamedSharding(mesh, x.placements)}}))):
            try:
                fn()
                res["no_group"][what] = "returned"
            except RuntimeError as e:
                res["no_group"][what] = str(e)
        if rank == 0:
            print(json.dumps(res), flush=True)


    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=8)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code: str, args: list, env: dict, path) -> dict:
    path.write_text(textwrap.dedent(code))
    out = subprocess.run([sys.executable, str(path), *args],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(next(line for line in out.stdout.splitlines()
                           if line.startswith("{")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    ref = _run(REFERENCE, [str(d)], dict(
        env, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        d / "reference.py")
    port = _run(PORT, [str(_free_port()), str(d)], env, d / "port.py")
    return ref, port, d


def test_losses_on_2x4_match_the_reference(runs):
    ref, port, _ = runs
    assert np.allclose(port["losses_2x4"], ref["losses"], rtol=0,
                       atol=REF_TOL), (port["losses_2x4"], ref["losses"])


@pytest.mark.parametrize("case", ["4x2", "4x2_fsdp", "plain"])
def test_restore_continues_the_uninterrupted_loss(runs, case):
    """The (2, 4) Trainer's step-2 checkpoint restored onto (4, 2) (with
    ``shardings``; under FSDP through ``load_checkpoint``) and into a
    model with no mesh: the third step's loss is the uninterrupted one."""
    _, port, _ = runs
    assert abs(port[case] - port["losses_2x4"][2]) < RESUME_TOL, port
    assert port[case + "_placed"] == (case != "plain")


def test_reference_checkpoint_restored_onto_4x2(runs):
    ref, port, _ = runs
    assert abs(port["ref_to_4x2"] - ref["losses"][2]) < RESUME_TOL


def test_plain_checkpoint_resumes_on_a_mesh(runs):
    """A Trainer with no mesh (each rank the same; rank 0 writes) and its
    checkpoint resumed on (2, 4) under FSDP."""
    _, port, _ = runs
    assert np.allclose(port["plain_losses"], port["losses_2x4"], rtol=0,
                       atol=REF_TOL)
    assert abs(port["plain_to_2x4_fsdp"] - port["plain_losses"][2]) < \
        RESUME_TOL


def test_restore_with_shardings_places_each_array(runs):
    _, port, _ = runs
    assert port["restored_placements"] == port["restored_expected"]
    assert any("Shard" in str(v) for v in port["restored_placements"].values())


def test_async_dtensor_save_is_written_by_rank_0_alone(runs):
    _, port, _ = runs
    assert port["writes"] == [[2]] + [[]] * 7
    assert port["dtensor_listing"] == ["step_0000000002"]
    assert port["port_ckpt"] == ["step_0000000002"]


def test_dtensor_checkpoint_read_by_the_reference(runs):
    """What 8 DTensor ranks saved, the reference reads back as the
    gathered whole tensors, exactly."""
    _, _, d = runs
    step, state = RCheckpointManager(d / "dtensor_ckpt").restore()
    assert step == 2
    with np.load(d / "full.npz") as z:
        full = {k: z[k] for k in z.files}
    got = dict(_flat(state["params"]))
    assert set(got) == set(full)
    for k, v in full.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_dtensors_without_a_process_group_raise(runs, tmp_path):
    _, port, _ = runs
    for what in ("save", "restore"):
        assert "process group" in port["no_group"][what], port["no_group"]
    # restoring onto a mesh in a process with no group raises too
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"a": np.zeros(4, np.float32)})
    with pytest.raises(RuntimeError, match="process group"):
        mgr.restore(shardings={"a": NamedSharding(None, ())})
