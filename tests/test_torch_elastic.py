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

The same script counts what a save and a restore hold: the bytes each
rank copies to host memory during the (2, 4) Trainer's save (through
the manager's one host-copy function), and the order in which a restore
reads and places its leaves.  It also fails ranks on purpose: rank 3's
forward and backward pass once (with retries, and with none), and rank
0's asynchronous write; every rank must then retry or raise together.
A vocab-split embedding table whose rows do not divide the mesh dim must
raise.  The group has a 60 s timeout and the script 300 s, so a rank
left waiting in a collective fails the run rather than hanging it.
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
    import datetime
    import json
    import os
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    import repro_torch.checkpoint.manager as M
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.models.layers import embed
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


    def gathered(x):
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, x)
        return out


    COPIES = []


    def count_host_copies():
        # count every copy to host memory the manager makes (its bytes);
        # a manager without one host-copy function counts nothing
        copy = getattr(M, "_host_copy", None)
        if copy is None:
            return False

        def counting(t, out=None):
            COPIES.append(t.numel() * t.element_size())
            return copy(t, out)

        M._host_copy = counting
        return True


    def logged_restore(mgr, shardings):
        # mgr.restore(shardings=...) with each leaf read ("r") and each
        # leaf placed ("p") logged in order
        seq, read, place = [], M._from_host, M.distribute_tensor
        M._from_host = lambda *a: (seq.append("r"), read(*a))[1]
        M.distribute_tensor = lambda *a: (seq.append("p"), place(*a))[1]
        try:
            step, tree = mgr.restore(shardings=shardings)
        finally:
            M._from_host, M.distribute_tensor = read, place
        with np.load(os.path.join(mgr.dir, f"step_{step:010d}",
                                  "arrays.npz")) as z:
            files = z.files
        flat = dict(P.flatten(tree))
        want = "".join("rp" if isinstance(flat[k], DTensor) else "r"
                       for k in files)
        return step, tree, {"seq": "".join(seq), "want": want}


    def failing_grad(tr, rank, fail_rank=3):
        # tr's forward and backward pass fails once on fail_rank, after
        # its collectives; returns the list of calls
        grad_fn, calls = tr.grad_fn, []

        def fails_once(batch):
            out = grad_fn(batch)
            calls.append(len(calls))
            if rank == fail_rank and len(calls) == 1:
                raise RuntimeError("injected backward failure")
            return out

        tr.grad_fn = fails_once
        return calls


    def failure_cases(rank, d, init):
        # every rank retries a pass that failed on one rank, or raises
        # with it; a failed asynchronous write raises on every rank
        res = {}
        clean = trainer((2, 4))
        clean.run(clean.load_checkpoint(init), start_step=0, steps=1)
        want = {n: p.to_local() for n, p in clean.model.named_parameters()}
        flaky = trainer((2, 4))
        calls = failing_grad(flaky, rank)
        flaky.run(flaky.load_checkpoint(init), start_step=0, steps=1)
        res["retry_calls"] = gathered(calls)
        res["retry_equal"] = gathered(all(
            torch.equal(p.to_local(), want[n])
            for n, p in flaky.model.named_parameters()))
        strict = trainer((2, 4))
        strict.tcfg.max_retries = 0
        failing_grad(strict, rank)
        try:
            strict.run(strict.load_checkpoint(init), start_step=0, steps=1)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        res["no_retry_raised"] = gathered(raised)
        res["no_retry_history"] = gathered(len(strict.history))

        mgr = CheckpointManager(d + "/failing_ckpt", async_save=True)
        if rank == 0:
            write = mgr._write

            def fails_at_1(step, *a):
                if step == 1:
                    raise OSError("injected write failure")
                return write(step, *a)

            mgr._write = fails_at_1
        small = {"x": np.arange(4, dtype=np.float32)}
        mgr.save(1, small)
        try:
            mgr.save(2, small)
            raised = None
        except (OSError, RuntimeError) as e:
            raised = str(e)
        mgr.wait()
        res["write_raised"] = gathered(raised)
        res["failing_listing"] = sorted(os.listdir(d + "/failing_ckpt"))
        return res


    def uneven_embed(mesh):
        # a table of 10 vocab rows split over the 4-wide model dim
        table = distribute_tensor(torch.randn(10, 4), mesh,
                                  (Replicate(), Shard(0)))
        try:
            embed(torch.zeros(2, 3, dtype=torch.long), table)
            return "returned"
        except ValueError as e:
            return str(e)


    def worker(rank, port, d):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=8,
                                timeout=datetime.timedelta(seconds=60))
        res = {"host_copy_counted": count_host_copies()}
        # (2, 4): the reference's initial state, restored onto the mesh
        tr = trainer((2, 4), ckpt=CheckpointManager(d + "/port_ckpt"))
        _, init = CheckpointManager(d + "/init").restore(
            shardings=state_shardings((2, 4), False))
        tr.run(tr.load_checkpoint(init), start_step=0, steps=3)
        res["host_copies"] = gathered([sum(COPIES), len(COPIES)])
        res["n_params"] = len(list(tr.model.parameters()))
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
        _, tree, res["restore_order"] = logged_restore(
            CheckpointManager(d + "/port_ckpt"), shard)
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
        res.update(failure_cases(rank, d, init))
        res["uneven_embed"] = uneven_embed(layout((2, 4), False)[0])
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


def test_save_copies_each_leaf_once_on_rank_0_alone(runs):
    """The (2, 4) Trainer's save: rank 0 copies every parameter and
    moment to host memory once (the bytes of the file's arrays, one copy
    a module parameter and moment); no other rank copies a byte."""
    _, port, d = runs
    assert port["host_copy_counted"], "the manager has no _host_copy"
    with np.load(d / "port_ckpt" / "step_0000000002" / "arrays.npz") as z:
        want = sum(z[k].nbytes for k in z.files if z[k].ndim)
    assert port["host_copies"][0] == [want, 3 * port["n_params"]]
    assert port["host_copies"][1:] == [[0, 0]] * 7


def test_restore_reads_one_leaf_at_a_time(runs):
    """``restore(shardings=...)`` places each leaf before it reads the
    next ("r" a read, "p" a placement, in the file's order)."""
    _, port, _ = runs
    order = port["restore_order"]
    assert "p" in order["want"] and order["seq"] == order["want"], order


def test_a_failed_gradient_is_retried_by_every_rank(runs):
    """rank 3's pass fails once after its collectives: every rank runs
    the pass twice, and the step is bit-equal to a clean one's."""
    _, port, _ = runs
    assert port["retry_calls"] == [[0, 1]] * 8
    assert port["retry_equal"] == [True] * 8


def test_past_max_retries_every_rank_raises(runs):
    _, port, _ = runs
    raised = port["no_retry_raised"]
    assert "injected backward failure" in raised[3], raised
    for r in (0, 1, 2, 4, 5, 6, 7):
        assert raised[r] and "another rank" in raised[r], raised
    assert port["no_retry_history"] == [0] * 8


def test_a_failed_async_write_raises_on_every_rank(runs):
    """rank 0's background write of step 1 fails: the next ``save``
    raises on every rank, before any rank gathers step 2."""
    _, port, _ = runs
    raised = port["write_raised"]
    assert "injected write failure" in raised[0], raised
    for r in range(1, 8):
        assert raised[r] and "rank 0 failed" in raised[r], raised
    assert port["failing_listing"] == []


def test_embed_refuses_an_uneven_vocab_split(runs):
    _, port, _ = runs
    assert "split must be even" in port["uneven_embed"], port["uneven_embed"]
