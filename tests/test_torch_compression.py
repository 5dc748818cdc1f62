"""The port's gradient compression on the CPU, held against the JAX
package: block-int8 error feedback bit-equal to the reference (its
``int8_quant`` runs the Pallas kernel in interpret mode here), top-k equal
on tie-free inputs, and the int8 all-gather mean over ``gloo`` process
groups of 1 and 2 ranks, spawned."""
import multiprocessing as mp
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as rcomp
from repro_torch.train import compression as comp

SIZES = [1, 100, 1000, 2047, 2048, 2049, 5000, 65536]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _grad(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 2)).astype(
        np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_int8_error_feedback_bit_equal_to_reference(n):
    """Two rounds of error feedback: payloads and residuals bit-equal."""
    g = _grad(n, n)
    r_res, res = jnp.zeros(n, jnp.float32), torch.zeros(n)
    for _ in range(2):
        (rq, rs), r_res = rcomp.int8_compress(jnp.asarray(g), r_res)
        (q, s), res = comp.int8_compress(_t(g), res)
        for got, want in ((q, rq), (s, rs), (res, r_res)):
            assert got.numpy().shape == np.asarray(want).shape
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        recon = comp.int8_decompress((q, s), n)
        np.testing.assert_array_equal(
            _bits(recon.numpy()),
            _bits(rcomp.int8_decompress((rq, rs), n)))


def test_int8_error_feedback_recovers_the_input():
    g = _grad(4096, 0)
    payload, err = comp.int8_compress(_t(g), torch.zeros(4096))
    recon = comp.int8_decompress(payload, 4096)
    np.testing.assert_allclose((recon + err).numpy(), g, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_equal_to_reference_on_tie_free_input(frac):
    n = 4096
    g = np.random.default_rng(1).permutation(n).astype(np.float32) - n / 2
    residual = np.random.default_rng(2).uniform(-0.25, 0.25, n).astype(
        np.float32)
    (ridx, rvals, rn), rres = rcomp.topk_compress(
        jnp.asarray(g), frac, jnp.asarray(residual))
    (idx, vals, pn), res = comp.topk_compress(_t(g), frac, _t(residual))
    assert pn == rn
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres))
    np.testing.assert_array_equal(
        comp.topk_decompress((idx, vals, pn), n).numpy(),
        np.asarray(rcomp.topk_decompress((ridx, rvals, rn), n)))


def _psum_worker(rank, world, port, shape, out):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        x = torch.from_numpy(np.random.default_rng(rank).normal(
            size=shape).astype(np.float32))
        out.put((rank, comp.compressed_psum_pod(x).numpy()))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_compressed_psum_pod_over_gloo(world):
    """Every rank gets the same mean, within amax/127 of the exact one (the
    bound tests/test_distributed.py holds the reference to)."""
    shape = (64, 33)  # 2112 values: a full 2048 block and a ragged one
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_psum_worker,
                         args=(r, world, port, shape, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = dict(out.get(timeout=120) for _ in range(world))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    xs = [np.random.default_rng(r).normal(size=shape).astype(np.float32)
          for r in range(world)]
    exact = np.mean(xs, axis=0)
    amax = max(float(np.abs(x).max()) for x in xs)
    for r in range(world):
        assert results[r].shape == shape and results[r].dtype == np.float32
        np.testing.assert_array_equal(results[r], results[0])
        assert float(np.abs(results[r] - exact).max()) <= amax / 127 + 1e-5
