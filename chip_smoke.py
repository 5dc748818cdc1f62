#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``repro_torch``).

Run from the root of a checkout on a host with one NVIDIA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel, into ``build/kernels``), then drives the port's two
paths, each with every kernel launch counter zeroed just before it and
read just after:

1. ``analyze`` — ``repro_torch.launch.analyze --executor threads --compute
   device --device cuda`` on the reference benchmark's STANDARD workload
   (48 profiles, 8 host + 40 device metrics, ~196k unified contexts),
   generated from a seed; each kernel of the path must have launched.
2. ``float_parity`` — the same workload through ``--compute cpu``: every
   PMS plane must agree within ``atol=1e-3, rtol=1e-4`` (f32-class data)
   and the trace files must be byte-identical.
3. ``exact_parity`` — an integer-valued workload of the same shape through
   both computes: ``db.pms``, ``db.cms`` and ``db.trc`` byte-identical.
   ``analyze_processes`` — both workloads through ``--executor processes
   --workers 4 --compute device --device cuda``: four spawned worker
   processes, each with its own CUDA context, run ``segstats`` and the f32
   ``blockscan``; the parent runs the census ``histogram`` and the int64
   ``blockscan``.  The float databases must be byte-identical to phase 1's
   ``threads`` run on the card, the integer ones to ``exact_parity``'s
   numpy run; ``device_launches`` (parent plus workers) must show every
   path kernel, the workers' share ``segstats`` and ``blockscan_f32``, the
   parent's counters the rest.  The ``ranks`` driver runs no kernel (it
   refuses ``--compute device``), so only the CPU tests drive it.
   ``legacy_parity`` — both workloads through ``pipeline="legacy"`` (the
   three-pass numpy chain, ``compute="cpu"``): ``db.pms``, ``db.cms`` and
   ``db.trc`` byte-identical to the fused numpy run of the same workload.
   ``query`` — ``repro_torch.launch.analyze query`` ``topk``, ``select``,
   ``stripe``, ``window`` (with and without ``--pid``) and ``diff``, each
   a subprocess with ``CUDA_VISIBLE_DEVICES=""``, on the databases the card
   wrote and on the numpy ones: the integer twin's stdout byte-identical,
   the float twin's rows the same contexts and paths with values within
   ``atol=1e-3, rtol=1e-4``; each op also timed in this process, cold and
   warm.  ``diagnose`` — ``analyze diagnose`` on each database with the
   float workload's numpy database as ``--baseline``, as JSON and as
   ``--markdown``: no regression of the card's float database against the
   numpy run of its own workload, the float findings within tolerance; the
   integer workload's regressions against it, JSON (its ``db`` field
   aside) and table byte-identical between card and numpy.
   ``dense_baseline`` — ``DenseAnalysis`` over the integer workload's first
   2 profiles: 200 sampled exclusive and inclusive cells equal the card's
   sparse database through ``repro_torch.query.Database.value``; and the
   paper's ratio, the whole workload's dense tensor (by
   ``dense_measurement_nbytes``, not written: ~7.2 GB) against the card
   run's PMS and CMS bytes.
   ``ingest`` — live ingest on the card, ``--publish-every 24``, 4 threads:
   the float workload's 48 profiles uploaded one a call through
   ``IngestClient`` to an in-process ``IngestHTTPServer`` (every launch
   counter zeroed just before), then ``/v1/publish``: ``segstats``, both
   ``blockscan`` bodies and the ``histogram`` must have launched, and the
   48-profile epoch agree with phase 1's one-shot card database within
   ``atol=1e-3, rtol=1e-4``, traces byte-identical; the integer workload
   through ``python -m repro_torch.launch.serve ingest`` as a subprocess,
   then SIGTERM: exit 0 with a drain line, and the last epoch's ``db.pms``,
   ``db.cms`` and ``db.trc`` byte-identical to ``exact_parity``'s numpy and
   card databases.  Per-append and per-publish seconds and the state's
   timings are printed.  ``query_server`` — ``serve query-server ROOT
   --follow`` on the integer ingest root with ``CUDA_VISIBLE_DEVICES=""``,
   single-process and with ``--shards 2``: ``profile``, ``stripe`` (the
   root, the hottest context), ``value``, ``topk``, ``threshold``,
   ``window`` and ``findings``, each reply body byte-identical to the
   in-process ``QueryServer.serve_one`` on the numpy database; seconds to
   the ready line, and the first call and the median and p95 of 20 warm
   calls per op.  ``watch`` — ``serve watch`` (no card), started before
   the integer ingest publishes, against the numpy database: one report per
   epoch it saw, the last the 48-profile epoch with no regression; the
   seconds from each epoch's publish to its report.  ``chaos`` — the
   replica-failure drill (no card: a subprocess with
   ``CUDA_VISIBLE_DEVICES=""``) on the integer database the card wrote:
   ``ShardedQueryServer`` with 3 shards of 2 replicas, hedged reads armed
   and a 2 s hung-peer kill, serves mixed batches of 25 requests once
   cold, for 3 s unfaulted, then 4 s under
   ``serve.chaos.default_schedule(3)`` (a worker SIGKILLed, a peer's
   requests dropped, a peer stalled): no
   ``QueryError``, every reply byte-equal to the in-process
   ``QueryServer``'s, the respawn and failover counters positive; the
   median, p95 and longest batch ms of each window.
4. ``determinism`` — one inclusive column scanned alone and inside the
   main path's batch gives bitwise-equal results; 10 launches of
   ``blockscan`` on each of the main path's scan inputs, of ``segstats`` on
   its input, of the float ``scatter_add`` at the census shape and of the
   ``histogram`` on the census ids give equal bits; the census counted
   right after a call with another S on the same stream is right; and a
   ``segstats`` profile, and the census segments of the ``scatter_add``,
   give the same bits alone and among others.
   ``combine_repeats`` — the integer workload's 48 profiles through
   ``fused_transform`` with a CUDA ``DeviceAggregator`` on a unified tree
   of the main path's context count, remapped many to one with placeholder
   routes so that ``segstats`` combines runs longer than one: exact-class
   planes byte-equal to the numpy path, the others within tolerance.
5. ``train`` — ``repro_torch.launch.train --arch qwen3-0.6b`` at full width
   (28 layers, 596,049,920 bf16 parameters, f32 moments), 5 steps at
   batch 8 x 128, with a profile and a checkpoint: step times, tokens/s,
   peak device memory, finite losses.
   ``train_trace`` — the train phase's Trainer takes one more step under
   ``torch.profiler``: its device time, kernel launches and idle share.
6. ``train_parity`` — the full-width model cut to 2 layers, batch 2 x 128,
   one seed: loss and gradient global norm on the card against the port
   on the CPU, within 1e-2 and 2e-2 relative (bf16).
7. ``train_profile`` — the port's ``analyze`` on the card over the train
   phase's ``worker0.rprf``: the database holds its host and device
   metrics, and the analyze kernels launched.
8. ``resume`` — ``--resume`` from the train phase's checkpoint takes one
   more step.
9. ``compression`` — the full model's flattened f32 gradient (291,040
   blocks of 2048) through 3 rounds of ``int8_compress`` error feedback on
   the ``int8_quant`` kernel; each round bit-equal to the plain version.
10. ``kernels`` — each kernel on the inputs its path gave it, against its
    plain PyTorch version on the card, with its call time (``call_ms``,
    CUDA events over back-to-back calls) and device time (``device_ms``,
    ``torch.profiler``'s kernel durations per call), the plain version's
    time, the same two for one library call where there is one, and the
    least time the card could take; the names of the device kernels the
    calls ran (``device_kernels``), which must all be the port's own, and
    their durations alone per call (``kernel_ms``, no gaps between them).
    ``segstats`` is also held on its input with NaN and infinities put in
    (``nan_case``); the ``histogram`` on the path's int32 census ids
    (``histogram_i32``), on the same ids as int64 (``histogram``), on the
    skewed ids and on the census ids moved past S (``histogram_dropped``,
    nothing counted), each one kernel a call; the float ``scatter_add`` at
    the census shape, at 40 columns and on a skewed input (90% of 200,000
    rows in one segment).
11. The other families at full width, each freeing the card before the
    next.  ``train_moe`` — qwen3-moe-30b-a3b (128 experts top-8, capacity
    factor 1.25) cut to 2 of 48 layers (the smoke's time: every dry-run
    family beside it), registered in process and run
    through ``repro_torch.launch.train`` (the sorted dispatch), 5 steps at
    batch 8 x 128 with a profile and a checkpoint; one more step with the
    rowwise dispatch through ``make_train_step``, then one more step of
    each dispatch under ``torch.profiler``; then ``--resume`` takes one
    more step: step times, tokens/s, model TFLOP/s (6 N_active D), peak
    memory, losses, gradient norms, the share of routed copies over
    capacity, and each traced step's device ms, launches and idle share.  ``train_moe_profile`` — the port's ``analyze`` on the
    card over that run's ``worker0.rprf``: host and device metrics in the
    database, the path kernels launched.  ``train_vlm`` (llama-3.2-vision
    cut to 10 of 40 layers: two cross-attention groups, 1,600 seeded
    vision embeddings a row) and ``train_audio`` (whisper-small whole,
    1,500 seeded frames and 448 decoder tokens a row) — 3 steps each at
    batch 8 through ``make_train_step``, and a fourth under
    ``torch.profiler``.  ``family_parity`` — each family
    cut to its least depth (MoE 2 layers, VLM one group of 5, audio 2 + 2;
    item 12's two), one seed, batch 2: loss and gradient norm on the card
    against the CPU
    within 1e-2 and 2e-2 relative (bf16), and the MoE's top-k agreement.
    ``moe_determinism`` — one MoE step (2 layers, batch 8 x 128) twice on
    the card with each dispatch: loss and every gradient bit-equal.
12. The SSM and hybrid families at full width and the published chunk of
    256, each freeing the card before the next.  ``train_hybrid`` —
    zamba2-7b cut to 7 of 81 layers (the shared attention block before
    groups of 6 and 1), registered in process and run through
    ``repro_torch.launch.train`` at batch 8 x 512 (two chunks a layer), 5
    steps with a profile and a checkpoint, one more step under
    ``torch.profiler``, then ``--resume`` takes one more step and the
    checkpoint is deleted: step times, tokens/s, model TFLOP/s, peak
    memory, losses and gradient norms, which must all be finite.
    ``train_hybrid_profile`` — the port's ``analyze`` on the card over that
    run's ``worker0.rprf``.  ``train_xlstm`` — xlstm-350m cut to 12 of 24
    blocks (9 mLSTM and 3 sLSTM) at batch 8 x 512 through
    ``make_train_step``, 3
    steps and a traced fourth, all finite, and one mLSTM and one sLSTM
    block's forward and backward timed alone.  ``ssm_scan`` —
    ``linear_rnn_chunked`` alone at both families' full shapes (batch 8 x
    512; zamba2: 112 heads, P 64, N 64, keys shared; xlstm: 4 heads, P 513,
    N 512, keys per head), seeded log-decays as at initialisation: output,
    final state and gradients at chunk 256 against chunk 64 within 1e-4 of
    each tensor's largest, every gradient finite; peak memory and call and
    device ms of one forward and backward.  ``family_parity`` holds both
    families too (zamba2 cut to 2 layers, xlstm to 4 blocks, batch 2 x 256).
13. Generation for every family, each model freeing the card before the
    next (no kernel of the port is on this path: its launch counters are
    reported).  ``generate`` — qwen3-0.6b whole through
    ``python -m repro_torch.launch.serve`` (no mode word) as a subprocess,
    8 requests of 128 tokens and 32 new tokens each in one batch; then in
    process through ``ServeEngine.generate``, bf16 parameters from a seed:
    qwen3-0.6b whole, the MoE cut to 2 layers and the VLM to 10 (8 x 128
    prompts, 1,600 seeded vision embeddings a row), whisper-small whole
    (8 x 64 decoder prompts after 1,500 seeded frames), and the recurrent
    families whole at the published chunk of 256 (8 x 128 prompts):
    zamba2-7b (81 Mamba2 layers, the shared attention block applied 14
    times, each application with its own KV cache) and xlstm-350m (18
    mLSTM and 6 sLSTM blocks), 32 new tokens each after a warm-up call:
    the engine's wall time; the same loop with the prefill and the decode
    steps timed apart (ms, tokens/s); peak memory; the weights' and the
    cache's bytes (every tensor leaf: KV caches, scan states, conv
    windows); one more decode step under ``torch.profiler`` (device ms,
    launches, idle share); and the head's product with an f32 output
    against casting the head to f32 first.  ``generate_parity`` — each
    family in f32 at its least depth (dense 2 layers, MoE 2, VLM one group
    of 5, audio 2 + 2, zamba2 2 layers with one attention application,
    xlstm 4 blocks with an sLSTM), 2 prompts of 16 tokens, on the card and
    on the CPU: ``prefill`` of all 16 against ``prefill`` of 15 then one
    ``decode_step`` within 1e-4 of the largest |logit| on the card, the
    card against the CPU within 1e-3, and the share of 4 greedy tokens
    equal on both.
14. The dry-run (no card: each cell a ``python -m repro_torch.launch.dryrun``
    process on the CPU, all started together).  ``dryrun`` — every family
    at full width on fake meshes: qwen3-0.6b ``train_4k`` on 16x16, yi-6b
    ``train_4k`` on 2x16x16 (FSDP, the pod axis), qwen3-moe-30b-a3b
    ``train_4k`` on 16x16 (EP, 8 microbatches, f32 moments) and zamba2-7b
    ``long_500k`` on 16x16 (``decode_sp``: the KV cache split by position
    over ``data``, 14 attention applications of 524,288 positions); and
    while the phase is under DRYRUN_BUDGET_S llama-3.2-vision-11b
    ``decode_32k`` and whisper-small ``prefill_32k`` on 16x16, grok-1-314b
    ``train_4k`` on 2x16x16 (TP-in-expert, bf16 moments, 16 microbatches)
    and xlstm-350m ``prefill_32k`` on 16x16 (its sLSTM loop counted by its
    trip count): per-device memory, roofline terms and dominant term,
    collectives, the MoE cells' ``port_dispatch`` (the sorted dispatch's
    whole-buffer sums, a cost of the port's dispatch, and the roofline
    without them), ``rules_kind``, microbatches, moment dtype and trace
    seconds.  ``dryrun_check`` — the dry-run's predictions (made beside
    ``dryrun``) for qwen3-0.6b whole and qwen3-moe-30b-a3b cut to 2 layers
    (its sorted dispatch on DTensors), each at 8 x 128 on a 1x1 mesh,
    against that step on the card on a one-rank NCCL group: the DTensor
    step's loss within 1e-5 of the plain step's, ``FlopCounterMode``'s
    FLOPs of the plain step equal to the predicted dot FLOPs, the peak
    within 15% of the predicted one, the parameters' and moments' bytes
    equal to the predicted argument bytes less the batch and the int32
    step, and the median step no faster than the roofline bound.
    ``python3 chip_smoke.py --dryrun-only`` runs these two phases alone
    (and is not the smoke).
15. ``elastic`` — checkpoints of DTensor state across meshes, on a
    one-rank NCCL group: qwen3-0.6b whole in f32 at batch 8 x 128, a
    ``Trainer`` on a (1, 1) mesh takes two AdamW steps, saves with
    ``async_save`` (each DTensor gathered whole) and takes the third step
    beside the write; the checkpoint is restored onto a fresh (1, 1) mesh
    under the FSDP rules (``restore(shardings=...)``) and into a model
    with no mesh, and each takes the third step.  Beside it, 8 CPU
    ``gloo`` ranks in a subprocess train the reduced model (1 layer) on a
    (2, 4) mesh, save and take their third step; the card restores that
    checkpoint onto its (1, 1) mesh.  Every third-step loss within 1e-4
    of its uninterrupted one (the gap and bit-equality printed); the
    checkpoint's bytes, the gather-and-copy, commit and restore seconds.
    ``phase_seconds`` gives each phase's seconds.

Every line before the last is one JSON object; the last is
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero without
that line, as does a host without a card or a directory without the
package.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import math
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED_FLOAT, SEED_INT = 1, 2
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the f32 rate
# outside the tensor cores, used for the integer adds too
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
ATOL, RTOL = 1e-3, 1e-4
ARCH = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 128
PARITY_LAYERS, PARITY_BATCH = 2, 2
PARITY_RTOL_LOSS, PARITY_RTOL_GNORM = 1e-2, 2e-2  # bf16, card vs CPU
COMPRESSION_ROUNDS = 3
# the other families at full width (depth cut as noted)
MOE_ARCH, VLM_ARCH, AUDIO_ARCH = ("qwen3-moe-30b-a3b", "llama-3.2-vision-11b",
                                  "whisper-small")
# the MoE's, zamba2's and the xLSTM's training depths keep the whole
# smoke near 1,000 s of its 1,200 with every family's dry-run cells
MOE_LAYERS, VLM_LAYERS = 2, 10          # of 48 and 40
MOE_CUT = f"{MOE_ARCH}-{MOE_LAYERS}l"   # registered in process
FAMILY_STEPS = 3                        # VLM and audio
AUDIO_FRAMES, AUDIO_TOKENS = 1500, 448  # whisper's 30 s window, its decoder
# the SSM and hybrid families at full width: every layer's scan runs whole
# chunks of the published 256, two a row in training and one in parity
HYBRID_ARCH, XLSTM_ARCH = "zamba2-7b", "xlstm-350m"
# zamba2: 7 of 81 layers, groups of 6 and 1; the xLSTM: 3 of its 6 groups
HYBRID_LAYERS, XLSTM_TRAIN_LAYERS = 7, 12
HYBRID_CUT = f"{HYBRID_ARCH}-{HYBRID_LAYERS}l"  # registered in process
SSM_TRAIN_SEQ, SSM_PARITY_SEQ = 512, 256
# linear_rnn_chunked alone at each family's full shape (batch 8 x 512)
SSM_SCAN_SHAPES = {"zamba2": dict(H=112, P=64, N=64, Hk=1),
                   "xlstm": dict(H=4, P=513, N=512, Hk=4)}
SSM_SCAN_CHUNKS = (256, 64)
SSM_SCAN_TOL = 1e-4  # of each tensor's largest: the chunkings sum apart
FAMILY_PARITY = {"moe": (MOE_ARCH, {"n_layers": 2}),
                 "vlm": (VLM_ARCH, {"n_layers": 5}),
                 "audio": (AUDIO_ARCH, {"n_layers": 2, "encoder_layers": 2}),
                 "hybrid": (HYBRID_ARCH, {"n_layers": 2}),
                 "ssm": (XLSTM_ARCH, {"n_layers": 4})}
SKEW_ROWS, SKEW_SHARE = 200_000, 0.9  # the skewed scatter-add input
# generation, every family: GEN_BATCH seeded prompts of
# GEN_PROMPT tokens (whisper: GEN_AUDIO_PROMPT decoder tokens after
# AUDIO_FRAMES frames), GEN_NEW greedy tokens each
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_AUDIO_PROMPT = 8, 128, 32, 64
# generate_parity: f32, 2 prompts of 16 tokens, 4 greedy tokens; logits
# within these shares of the largest |logit|
GEN_PARITY_PROMPT, GEN_PARITY_NEW = 16, 4
GEN_TOL_STEP = 1e-4    # prefill(S-1) + decode against prefill(S), the card
GEN_TOL_DEVICE = 1e-3  # the card against the CPU
# the dry-run at full width on fake 256- and 512-rank meshes (no card):
# (arch, shape, multi-pod, required); a cell that is not required runs
# only while the phase is under DRYRUN_BUDGET_S
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False, True),
                ("yi-6b", "train_4k", True, True),
                ("qwen3-moe-30b-a3b", "train_4k", False, True),
                ("zamba2-7b", "long_500k", False, True),
                ("llama-3.2-vision-11b", "decode_32k", False, False),
                ("whisper-small", "prefill_32k", False, False),
                ("grok-1-314b", "train_4k", True, False),
                ("xlstm-350m", "prefill_32k", False, False))
DRYRUN_BUDGET_S, DRYRUN_TIMEOUT_S = 100, 600
# dryrun_check: the dry-run's prediction for each (arch, depth cut) at the
# train phase's batch on a (1, 1) mesh, against the step on the card:
# qwen3-0.6b whole, and the MoE cut to MOE_LAYERS (its sorted dispatch on
# DTensors)
CHECK_ROWS = ((ARCH, None), (MOE_ARCH, MOE_LAYERS))
CHECK_LOSS_TOL = 1e-5   # the DTensor step's loss against the plain step's
CHECK_PEAK_RTOL = 0.15  # max_memory_allocated against the predicted peak
CHECK_STEPS = 5         # timed DTensor steps after the checked one
# elastic: the next step after a restore against the uninterrupted one;
# the cross-size leg's CPU ranks, their mesh and batch (reduced, 1 layer)
ELASTIC_TOL = 1e-4
ELASTIC_CPU_MESH, ELASTIC_CPU_SEQ, ELASTIC_CPU_BATCH = (2, 4), 16, 8
# chaos: 3 shards of 2 replicas each under default_schedule(3); load for
# CHAOS_CALM_S unfaulted, then CHAOS_SPAN_S under the schedule, batches of
# CHAOS_BATCH mixed requests
CHAOS_SHARDS, CHAOS_REPLICAS, CHAOS_BATCH = 3, 2, 25
CHAOS_CALM_S, CHAOS_SPAN_S = 3.0, 4.0
# hedged reads armed, as the reference's serve_load chaos leg arms them
# (a single-owner read a drop swallowed goes to the next replica), and a
# peer with work unanswered for CHAOS_HANG_KILL_S presumed hung (a
# scattered read it swallowed is replayed after the kill; the default
# 30 s would be most of the phase)
CHAOS_HEDGE_MS, CHAOS_HANG_KILL_S = 50.0, 2.0


class SmokeFailure(RuntimeError):
    pass


_T0 = time.perf_counter()
_PHASE_S: dict = {}


def emit(obj) -> None:
    """Print one phase's line; note the seconds since the previous one."""
    global _T0
    now = time.perf_counter()
    for key in obj:
        _PHASE_S[key] = now - _T0
    _T0 = now
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_analyze(analyze, paths, out: Path, *flags,
                executor: str = "threads") -> tuple[dict, float]:
    """The port's CLI entry point, its JSON summary captured."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        analyze.main([*paths, "--out", str(out), "--executor", executor,
                      *flags])
    return json.loads(buf.getvalue()), time.perf_counter() - t0


def _smi(query: str) -> list[list[str]]:
    out = subprocess.run(["nvidia-smi", query,
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=10).stdout
    return [ln.split(", ") for ln in out.splitlines() if ln.strip()]


class ComputeApps:
    """Samples ``nvidia-smi`` every half second while the block runs: the
    compute processes (pid, MiB used), keeping the sample that lists the
    most, and the card's used MiB, keeping the largest (``used_mib``)
    beside the reading before the block (``used_mib_before``)."""

    def __enter__(self):
        self.most: list[list[str]] = []
        self.used_mib_before = int(_smi("--query-gpu=memory.used")[0][0])
        self.used_mib = self.used_mib_before
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.5):
            rows = _smi("--query-compute-apps=pid,used_memory")
            if len(rows) > len(self.most):
                self.most = rows
            self.used_mib = max(self.used_mib, int(
                _smi("--query-gpu=memory.used")[0][0]))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


class Recorder:
    """Wraps a module's function to keep (a clone of) the arguments of its
    largest call per key, so the kernels can be re-run on the main path's
    own inputs."""

    def __init__(self):
        self.calls: dict[str, tuple] = {}
        self._undo = []

    def wrap(self, module, name, key_of):
        import torch
        orig = getattr(module, name)

        def recorded(*args):
            key = key_of(*args)
            size = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
            if size > self.calls.get(key, (-1,))[0]:
                self.calls[key] = (size, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
            return orig(*args)

        setattr(module, name, recorded)
        self._undo.append((module, name, orig))

    def restore(self):
        for module, name, orig in self._undo:
            setattr(module, name, orig)

    def args(self, key):
        require(key in self.calls, f"the main path never called {key}")
        return self.calls[key][1]


def _plane_diff(pa, pb) -> tuple[float, float, int]:
    """Max |a - b| over the common (ctx, metric) keys of two planes, the
    largest value present on one side only, and the count of common keys
    outside ATOL/RTOL."""
    import numpy as np
    ra, ma, va = pa.triplets()
    rb, mb, vb = pb.triplets()
    ka = (ra.astype(np.int64) << 16) | ma.astype(np.int64)
    kb = (rb.astype(np.int64) << 16) | mb.astype(np.int64)
    _, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                               return_indices=True)
    d = np.abs(va[ia] - vb[ib])
    only = np.concatenate([np.delete(va, ia), np.delete(vb, ib)])
    return (float(d.max()) if d.size else 0.0,
            float(np.abs(only).max()) if only.size else 0.0,
            int(np.sum(d > ATOL + RTOL * np.abs(vb[ib]))))


def plane_agreement(pms_a, pms_b) -> dict:
    """Max |a - b| over common (ctx, metric) keys of every plane, and the
    largest value present on one side only; checked against ATOL/RTOL."""
    worst, lone, bad = 0.0, 0.0, 0
    for pid in range(pms_a.n_profiles):
        w, o, b = _plane_diff(pms_a.plane(pid), pms_b.plane(pid))
        worst, lone, bad = max(worst, w), max(lone, o), bad + b
    return {"max_abs_err": worst, "max_one_sided": lone, "violations": bad,
            "ok": bad == 0 and lone < ATOL}


def time_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of back-to-back calls, by CUDA events
    after a warm-up: the call time, which is the host's time per call when
    that exceeds the device's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int = 20) -> float | None:
    """Mean device milliseconds per call: the durations of the CUDA kernels
    (and copies) that ``torch.profiler`` records, summed and divided by the
    calls it recorded, each call marked with ``record_function``; None when
    it records no device time.  The profile runs a warm-up cycle and an
    active one of ``iters`` calls each: without the warm-up the tracer can
    miss the first launches after it starts."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    fn()
    torch.cuda.synchronize()
    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                with record_function("smoke_call"):
                    fn()
            torch.cuda.synchronize()
            prof.step()
    require(len(cycles) == 1, f"the profiler gave {len(cycles)} cycles")
    calls = sum(e.count for e in cycles[0] if e.key == "smoke_call")
    us = sum(_dev_us(e) for e in cycles[0]
             if e.device_type == torch.autograd.DeviceType.CUDA)
    require(calls >= iters, f"the profiler recorded {calls} of the calls")
    return us / 1e3 / calls if us > 0 else None


def port_kernel_names() -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    import re
    names = set()
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


def device_kernels(fn, iters: int = 20) -> tuple[list[str], float | None]:
    """The names of the device activities (kernels, memsets) that
    ``torch.profiler`` records over ``iters`` calls of ``fn``, and their
    durations summed per call (None when it records none).  No call is
    annotated, so this is the kernels' own time, without the gaps in which
    the card waits for the host's next launch.  A warm-up cycle runs first,
    as in ``device_ms``.  A capture that records no device activity at all
    is taken once more: the tracer can lose its buffer (one smoke on an
    H100 saw nothing for the ``histogram``, whose launches and result were
    right)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        cycles = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: cycles.append(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        require(len(cycles) == 1, f"the profiler gave {len(cycles)} cycles")
        events = [e for e in cycles[0]
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    us = sum(_dev_us(e) for e in events)
    return (sorted({e.key for e in events}),
            us / 1e3 / iters if us > 0 else None)


def foreign_kernels(names: list[str], own: set[str]) -> list[str]:
    """The names that are neither one of ``own`` kernels nor a memset: a
    library's sort, scan or scatter would be among them."""
    import re
    return [k for k in names if not k.startswith("Memset") and not any(
        re.search(rf"(?<!\w){o}\s*[<(]", k) for o in own)]


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, kernel, plain, library,
                 nbytes, nops, exact, on_path=True) -> dict:
    """Run ``kernel`` and ``plain`` on the same inputs, compare and time.
    ``exact`` results must be bit-equal; others agree within RTOL of the
    largest magnitude, since the two sum in different orders.  A kernel may
    return a tuple of tensors."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, scale, tol = 0.0, 0.0, 0.0
    for g, w in zip(got, want, strict=True):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{name}: kernel gives {g.dtype}{tuple(g.shape)}, plain "
                f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
            scale = max(scale, float(w.double().abs().max()))
        if exact:
            require(torch.equal(_bits(g), _bits(w)),
                    f"{name}: kernel and plain version differ in bits")
    tol = 0.0 if exact else RTOL * max(1.0, scale)
    require(err <= tol, f"{name}: max_abs_err {err} > tolerance {tol}")
    names, kernel_ms = device_kernels(kernel)
    foreign = foreign_kernels(names, port_kernel_names())
    require(names and not foreign, f"{name}: the profiler saw {names}, "
            f"of which not the port's own: {foreign}")
    call_ms = time_ms(kernel)
    lib_call_ms = time_ms(library) if library else None
    bound_ms, bound_by = bound(nbytes, nops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "on_path": on_path, "launches": launches,
            "max_abs_err": err, "tolerance": tol, "ms": call_ms,
            "call_ms": call_ms, "device_ms": device_ms(kernel),
            "plain_ms": time_ms(plain), "library_ms": lib_call_ms,
            "library_call_ms": lib_call_ms,
            "library_device_ms": device_ms(library) if library else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "device_kernels": names, "kernel_ms": kernel_ms}


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def combine_repeats_phase(ipaths, n_ctx: int, device: str = "cuda") -> dict:
    """The duplicate-key combine at full size: each integer STANDARD
    profile's values (1..8) through ``fused_transform`` with a
    ``DeviceAggregator`` on ``device`` and through the numpy path, on a
    unified tree of ``n_ctx`` contexts.  Each profile's contexts map many to
    one onto an eighth as many unified contexts (as
    ``tests/test_torch_batch.py``'s generator remaps them), so keys repeat,
    and three placeholder routes are added.  Even profiles route each
    placeholder to one leaf, which keeps their values integers: "exact"
    planes, byte-equal to numpy.  Odd profiles route to 1-3 leaves with
    random weights: "f32" planes, held within ATOL/RTOL.  The ``segstats``
    calls are counted by run length."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline import fused_transform
    from repro_torch.core.sparse import MeasurementProfile
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch as kb
    from repro_torch.kernels import segstats as ss
    rng = np.random.default_rng(SEED_INT)
    t0 = time.perf_counter()
    tree = synth.build_app_tree(n_ctx, rng)
    pos, _, end = tree.preorder()
    parent_pre = np.full(n_ctx, -1, np.int64)
    parent_pre[pos[1:]] = pos[tree.parent_array()[1:]]
    build_s = time.perf_counter() - t0
    agg = kb.DeviceAggregator(end, device=device)

    runs = {"calls": 0, "longer_than_one": 0, "longest": 0}
    orig = ss.segstats

    def counted(ids, vals, n_seg):
        _, counts = torch.unique_consecutive(ids, return_counts=True)
        runs["calls"] += 1
        runs["longer_than_one"] += int((counts > 1).sum())
        runs["longest"] = max(runs["longest"], int(counts.max()))
        return orig(ids, vals, n_seg)

    exact_equal, n_exact, values = True, 0, 0
    worst, lone, bad = 0.0, 0.0, 0
    ss.segstats = counted
    _build.launch_counts.reset()
    t0 = time.perf_counter()
    try:
        for pid, path in enumerate(ipaths):
            prof = MeasurementProfile.load(path)
            n_local = len(prof.tree)
            targets = rng.choice(n_ctx, size=max(1, n_local // 8),
                                 replace=False)
            remap = targets[rng.integers(0, targets.size, n_local)]
            routes = {}
            for ph in rng.choice(targets, size=3, replace=False):
                k = 1 if pid % 2 == 0 else int(rng.integers(1, 4))
                routes[int(ph)] = (rng.integers(0, n_ctx, k).astype(np.int64),
                                   rng.uniform(0.1, 2.0, k))
            vals = prof.metrics.triplets()[2]
            values += vals.size
            got = fused_transform(prof.metrics, remap, routes, parent_pre,
                                  end, device=agg)
            want = fused_transform(prof.metrics, remap, routes, parent_pre,
                                   end)
            if pid % 2 == 0:
                require(kb.classify_plane(vals) == "exact",
                        f"profile {pid}: plane is not exact-class")
                n_exact += 1
                exact_equal &= got.encode() == want.encode()
            else:
                w, o, b = _plane_diff(got, want)
                worst, lone, bad = max(worst, w), max(lone, o), bad + b
    finally:
        ss.segstats = orig
    wall = time.perf_counter() - t0
    counts = _build.launch_counts.snapshot()
    out = {"profiles": len(ipaths), "contexts": n_ctx, "values": values,
           "device": device, "tree_s": build_s, "wall_s": wall,
           "exact_planes": n_exact, "exact_bytes_equal": exact_equal,
           "f32_planes": len(ipaths) - n_exact, "f32_max_abs_err": worst,
           "f32_max_one_sided": lone, "f32_violations": bad,
           "segstats_calls": runs["calls"],
           "segstats_runs_longer_than_one": runs["longer_than_one"],
           "segstats_longest_run": runs["longest"], "launches": counts}
    require(exact_equal, f"exact planes differ from numpy: {out}")
    require(bad == 0 and lone < ATOL, f"f32 planes disagree: {out}")
    require(runs["longer_than_one"] > 0,
            f"segstats combined no run longer than one: {out}")
    if device == "cuda":
        require(counts.get("segstats", 0) == len(ipaths),
                f"segstats launched {counts.get('segstats', 0)} times for "
                f"{len(ipaths)} profiles")
    return out


def segstats_nan_case(ss, ids, vals, n_seg) -> dict:
    """The main path's segstats input with NaN and +-inf put at in-range
    positions: NaN at the same places as the plain version, the rest
    within RTOL of the largest magnitude."""
    import torch
    g = torch.Generator(device=vals.device).manual_seed(SEED_FLOAT)
    v = vals.clone()
    pick = torch.randperm(v.numel(), generator=g, device=v.device)[:30]
    v[pick[:10]] = float("nan")
    v[pick[10:20]] = float("inf")
    v[pick[20:]] = float("-inf")
    got, want = ss.segstats_cuda(ids, v, n_seg), ss.segstats_plain(
        ids, v, n_seg)
    nan = torch.isnan(want)
    same_nan = bool(torch.equal(torch.isnan(got), nan))
    fin = ~nan & torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    tol = RTOL * max(1.0, float(want[fin].abs().max()))
    out = {"nan_values": 10, "inf_values": 20,
           "nan_rows": int(torch.isnan(got[:, 2]).sum()),
           "nan_positions_equal": same_nan,
           "inf_equal": bool(torch.equal(got[~fin & ~nan], want[~fin & ~nan])),
           "max_abs_err": err, "tolerance": tol}
    require(same_nan and out["inf_equal"] and err <= tol and
            out["nan_rows"] > 0, f"segstats with NaN and inf: {out}")
    return out


def segstats_alone_among_others(ss, ids, vals, n_seg) -> bool:
    """The main path's segstats input alone, and offset inside a
    concatenation after the same input less its first 5 values: its rows
    give the same bits."""
    import torch
    alone = ss.segstats_cuda(ids, vals, n_seg)
    among = ss.segstats_cuda(torch.cat([ids[5:], ids + n_seg]),
                             torch.cat([vals[5:], vals]), 2 * n_seg)
    return bool(torch.equal(_bits(among[n_seg:]), _bits(alone)))


def scatter_add_alone_among_others(sc, ids, vals, n_bins) -> bool:
    """The census ids alone, and with as many rows of other segments put
    between them: the census segments give the same bits."""
    import torch
    g = torch.Generator(device=ids.device).manual_seed(SEED_FLOAT)
    n = ids.numel()
    others = torch.randint(n_bins, 2 * n_bins, (n,), generator=g,
                           device=ids.device, dtype=ids.dtype)
    mixed = torch.randperm(2 * n, generator=g, device=ids.device)
    own = torch.sort(mixed[:n]).values  # the census rows keep their order
    big_ids = torch.empty(2 * n, dtype=ids.dtype, device=ids.device)
    big_vals = torch.empty(2 * n, dtype=vals.dtype, device=vals.device)
    big_ids[mixed[n:]] = others
    big_vals[mixed[n:]] = torch.rand(n, generator=g, device=vals.device)
    big_ids[own], big_vals[own] = ids, vals
    alone = sc.scatter_add_cuda(ids, vals, n_bins)
    among = sc.scatter_add_cuda(big_ids, big_vals, 2 * n_bins)
    return bool(torch.equal(_bits(among[:n_bins]), _bits(alone)))


def histogram_after_other_size(sc, ids, n_bins) -> bool:
    """The census ids counted right after a call with another S on the same
    stream (fewer bins, then more) give the plain version's counts."""
    import torch
    want = sc.histogram_plain(ids, n_bins)
    same = True
    for other in (7, 2 * n_bins + 1):
        sc.histogram_cuda(ids, other)
        same &= torch.equal(sc.histogram_cuda(ids, n_bins), want)
    return same


PROCESS_WORKERS = 4


def analyze_processes_phase(analyze, fpaths, ipaths, work: Path,
                            threads: dict, threads_wall: float,
                            threads_counts: dict, numpy_int: dict) -> dict:
    """``--executor processes`` on the card over both workloads: databases
    against phase 1's ``threads`` summary (float) and ``exact_parity``'s
    numpy summary (integer), and the launches of each kernel, in the parent
    and in the workers."""
    from repro_torch.kernels import _build
    out = {"workers": PROCESS_WORKERS, "threads_wall_s": threads_wall,
           "threads_timings": {k: threads["timings"].get(k) for k in
                               ("phase1", "phase2", "cms", "total")}}
    for name, paths, ref in (("float", fpaths, threads),
                             ("int", ipaths, numpy_int)):
        _build.launch_counts.reset()
        with ComputeApps() as apps:
            summ, wall = run_analyze(
                analyze, paths, work / f"proc_{name}", "--compute", "device",
                "--device", "cuda", "--workers", str(PROCESS_WORKERS),
                executor="processes")
        parent = _build.launch_counts.snapshot()
        t = summ["timings"]
        total, workers = t["device_launches"], t["device_launches_workers"]
        same = {k: sha(summ[k]) == sha(ref[k]) for k in ("pms", "cms",
                                                          "traces")}
        out[name] = {
            "wall_s": wall, "profiles": summ["profiles"],
            **{k: t.get(k) for k in ("phase1", "phase2", "cms", "completion",
                                     "total", "sink_peak", "funnel_launches",
                                     "funnel_requests", "device_h2d",
                                     "device_kernel", "device_d2h",
                                     "phase2_first_result", "workers_used",
                                     "worker_init_s", "worker_task_s",
                                     "worker_peak_bytes")},
            "launches": total, "launches_workers": workers,
            "launches_parent": parent, "compute_apps_mib": apps.most,
            "card_used_mib_before": apps.used_mib_before,
            "card_used_mib_peak": apps.used_mib, "bytes_equal": same}
        require(all(same.values()),
                f"processes {name} databases differ: {same}")
        require(all(parent.get(k, 0) == total[k] - workers.get(k, 0)
                    for k in total),
                f"processes {name}: device_launches {total} is not the "
                f"parent's {parent} plus the workers' {workers}")
        for k in ("segstats", "blockscan_f32"):
            require(workers.get(k, 0) > 0,
                    f"processes {name}: no worker launched {k}")
        for k in ("histogram", "blockscan_i64"):
            require(parent.get(k, 0) > 0 and workers.get(k, 0) == 0,
                    f"processes {name}: {k} launched outside the parent")
    # a worker propagates one profile a launch; threads coalesce concurrent
    # profiles into shared launches, so only blockscan_f32 may differ
    got = out["float"]["launches"]
    out["threads_launches"] = threads_counts
    out["equal_to_threads"] = {k: got.get(k, 0) == threads_counts.get(k, 0)
                               for k in sorted({*got, *threads_counts})}
    for k in ("segstats", "blockscan_i64", "histogram"):
        require(got.get(k, 0) == threads_counts.get(k, 0),
                f"processes launched {k} {got.get(k, 0)} times, threads "
                f"{threads_counts.get(k, 0)}")
    require(got.get("blockscan_f32", 0) == len(fpaths),
            f"processes launched blockscan_f32 {got.get('blockscan_f32', 0)} "
            f"times for {len(fpaths)} profiles")
    return out


# -- the read side: legacy chain, query, diagnose, dense baseline ------------

def legacy_parity_phase(fpaths, ipaths, work: Path, fused: dict) -> dict:
    """Both workloads through the legacy three-pass chain (numpy only):
    ``db.pms``, ``db.cms`` and ``db.trc`` byte-equal to the fused numpy run
    of the same workload (``fused``: name -> (summary, wall seconds))."""
    from repro_torch.core.aggregate import (AggregationConfig,
                                            StreamingAggregator)
    out = {}
    for name, paths in (("float", fpaths), ("int", ipaths)):
        t0 = time.perf_counter()
        res = StreamingAggregator(work / f"legacy_{name}", AggregationConfig(
            pipeline="legacy", compute="cpu")).run(paths)
        wall = time.perf_counter() - t0
        ref, ref_wall = fused[name]
        same = {k: sha(p) == sha(ref[k]) for k, p in (
            ("pms", res.pms_path), ("cms", res.cms_path),
            ("traces", res.trace_path))}
        out[name] = {"legacy_wall_s": wall, "fused_numpy_wall_s": ref_wall,
                     "legacy_phase2_s": res.timings.get("phase2"),
                     "fused_numpy_phase2_s": ref["timings"].get("phase2"),
                     "bytes_equal": same}
        require(all(same.values()),
                f"legacy {name} databases differ from fused: {same}")
    return out


def run_query_cli(argv: list[str]) -> tuple[str, float]:
    """``python -m repro_torch.launch.analyze`` in a subprocess with no card
    visible: its stdout and wall milliseconds."""
    return run_query_clis([argv])[0]


def run_query_clis(argvs: list) -> list:
    """:func:`run_query_cli` for each of ``argvs``, all started together;
    each one's wall milliseconds run from the start to its own end."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.analyze", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for argv in argvs]
    out = []
    try:
        for argv, proc in zip(argvs, procs):
            stdout, stderr = proc.communicate(timeout=300)
            out.append((stdout, (time.perf_counter() - t0) * 1e3))
            require(proc.returncode == 0, f"analyze {' '.join(argv[:3])} "
                                          f"failed: {stderr[-2000:]}")
    finally:
        for proc in procs:  # stops any left after a failure
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _rows_by(rows: list) -> dict | None:
    """Rows keyed by their context (or call path) where that key is unique
    in every row, else None."""
    for key in ("ctx", "path"):
        if all(isinstance(r, dict) and key in r for r in rows):
            keyed = {r[key]: r for r in rows}
            if len(keyed) == len(rows):
                return keyed
    return None


def _close(a, b) -> bool:
    """Two query documents agree: equal keys, rows matched by context (or
    call path) so that values within the tolerance may order them either
    way, integers and strings equal, floats within ATOL/RTOL."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        ka, kb = _rows_by(a), _rows_by(b)
        if a and ka is not None and kb is not None:
            return ka.keys() == kb.keys() and all(_close(ka[k], kb[k])
                                                  for k in ka)
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL)
    return a == b


def query_phase(analyze, dbs: dict) -> dict:
    """The port's ``analyze query`` ops on the databases the card wrote and
    on the numpy ones (``dbs``: ``{float,int}_{card,numpy}`` -> directory),
    each op in a subprocess with ``CUDA_VISIBLE_DEVICES=""``, the four
    databases' at once.  The integer
    twin's stdout must be byte-equal between card and numpy; the float
    twin's rows the same contexts and paths with values within ATOL/RTOL.
    Each op is also timed in this process: the first call (cold: the
    database's first open here) and the second (warm); ``open_ms`` is
    the time to open and close each database alone, twice."""
    from repro_torch.query import Database
    out = {"open_ms": {}}
    for name, db in dbs.items():  # opening alone: first, then again
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            Database(db).close()
            times.append((time.perf_counter() - t0) * 1e3)
        out["open_ms"][name] = times
    metric = "9"  # a device metric: the odd profiles carry it
    hot = {}  # each workload's hottest exclusive context, from numpy's
    for twin in ("float", "int"):
        top, _ = run_query_cli(["query", dbs[f"{twin}_numpy"], "topk",
                                "--metric", metric, "-k", "1", "--exclusive"])
        hot[twin] = str(json.loads(top)["rows"][0]["ctx"])
    ops = {
        "topk": ["topk", "--metric", metric, "-k", "10"],
        "select": ["select", "--metric", metric, "--path-regex", "solve"],
        "stripe": ["stripe", "--ctx", "0", "--metric", metric,
                   "--inclusive"],
        "stripe_hot": ["stripe", "--ctx", "{hot}", "--metric", metric],
        "window": ["window", "--t0", "10", "--t1", "20"],
        "window_pid": ["window", "--pid", "1", "--t0", "10", "--t1", "20"],
        "diff": ["diff", "{other}", "--metric", metric, "--top", "20"],
    }
    # diff: the float twin against the integer twin of the same backend,
    # the integer twin against the one float numpy database
    other = {"float_card": dbs["int_card"], "float_numpy": dbs["int_numpy"],
             "int_card": dbs["float_numpy"], "int_numpy": dbs["float_numpy"]}
    for op, args in ops.items():
        docs, row = {}, {}
        argvs = {}
        for name, db in dbs.items():
            fill = {"{other}": other[name], "{hot}": hot[name.split("_")[0]]}
            argvs[name] = ["query", db, *[fill.get(a, a) for a in args]]
        for name, res in zip(argvs, run_query_clis(list(argvs.values()))):
            docs[name], row[f"{name}_subprocess_ms"] = res
        for name, argv in argvs.items():
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    analyze.main(argv)
                times.append((time.perf_counter() - t0) * 1e3)
            row[f"{name}_cold_ms"], row[f"{name}_warm_ms"] = times
        fdoc = json.loads(docs["float_card"])
        row["rows"] = len(fdoc.get("rows", fdoc.get("occupancy",
                                                    fdoc.get("values", []))))
        row["int_bytes_equal"] = docs["int_card"] == docs["int_numpy"]
        row["float_close"] = _close(fdoc, json.loads(docs["float_numpy"]))
        row["stdout_bytes"] = len(docs["float_card"])
        out[op] = row
        require(row["int_bytes_equal"],
                f"query {op}: card and numpy integer databases print "
                f"different bytes")
        require(row["float_close"],
                f"query {op}: card float database disagrees with numpy's")
        require(row["rows"] > 0, f"query {op} returned nothing")
    return out


DIAGNOSE_LIMIT = 25  # the most severe findings kept (the CLI's --limit)


def diagnose_phase(dbs: dict) -> dict:
    """``analyze diagnose`` on every database with the float workload's
    numpy database as ``--baseline``, as JSON and as ``--markdown``.  The
    float twin is the baseline's own workload, so the card's database must
    show no regression and its other findings must agree with numpy's; the
    integer twin is another workload, so the call paths both hold give
    regressions, and the card's JSON (its ``db`` field aside) and table
    must be byte-identical to numpy's.  Each run keeps its
    ``DIAGNOSE_LIMIT`` most severe findings."""
    base = dbs["float_numpy"]
    out, docs = {"limit": DIAGNOSE_LIMIT}, {}
    for name, db in dbs.items():
        argv = ["diagnose", db, "--baseline", base, "--limit",
                str(DIAGNOSE_LIMIT)]
        js, ms = run_query_cli(argv)
        md, md_ms = run_query_cli([*argv, "--markdown"])
        doc = json.loads(js)
        require(doc["db"] == db and doc["baseline"] == base,
                f"diagnose {name}: wrong db/baseline fields")
        doc["db"] = "<db>"
        docs[name] = (doc, md)
        kinds: dict[str, int] = {}
        for f in doc["findings"]:
            kinds[f["kind"]] = kinds.get(f["kind"], 0) + 1
        out[name] = {"findings": doc["count"], "kinds": kinds,
                     "json_ms": ms, "markdown_ms": md_ms,
                     "markdown_lines": len(md.splitlines())}
    fc, fn = docs["float_card"], docs["float_numpy"]
    out["float_regressions"] = sum(f["kind"] == "regression"
                                   for f in fc[0]["findings"])
    out["float_close"] = (_close(fc[0]["findings"], fn[0]["findings"])
                          and fc[1].splitlines()[:2] == fn[1].splitlines()[:2])
    out["int_bytes_equal"] = (
        json.dumps(docs["int_card"][0]) == json.dumps(docs["int_numpy"][0])
        and docs["int_card"][1] == docs["int_numpy"][1])
    require(out["float_regressions"] == 0,
            "diagnose: the card's float database regressed against the "
            "numpy run of the same workload")
    require(out["float_close"],
            "diagnose: card and numpy float findings disagree")
    require(out["int_bytes_equal"],
            "diagnose: card and numpy integer findings differ")
    require(out["int_card"]["kinds"].get("regression", 0) > 0,
            "diagnose: another workload against the baseline showed no "
            "regression")
    return out


DENSE_PROFILES, DENSE_SAMPLES = 2, 200


def dense_baseline_phase(ipaths, int_db: str, work: Path, sizes: dict,
                         n_ctx: int, n_metrics: int) -> dict:
    """The HPCToolkit-style dense analysis over the first profiles of the
    integer workload: sampled exclusive and inclusive cells equal the
    card's sparse database; and the paper's ratio, the whole workload's
    dense tensor (``dense_measurement_nbytes`` arithmetic, not written)
    against the card run's sparse PMS and CMS bytes."""
    import numpy as np

    from repro_torch.core.cct import ContextTree
    from repro_torch.core.dense_baseline import (DenseAnalysis,
                                                 dense_measurement_nbytes)
    from repro_torch.core.metrics import INCLUSIVE_BIT
    from repro_torch.query import Database

    da = DenseAnalysis(work / "dense.npy")
    t0 = time.perf_counter()
    res = da.run(ipaths[:DENSE_PROFILES])
    dense_s = time.perf_counter() - t0
    tensor = np.load(work / "dense.npy", mmap_mode="r")
    m_half = tensor.shape[2] // 2
    rng = np.random.default_rng(SEED_INT)
    pid, ctx, col = np.nonzero(tensor)
    pick = rng.choice(pid.size, DENSE_SAMPLES, replace=False)
    bad = 0
    with Database(int_db) as db:
        # the dense tree's ids onto the database's: merge into a copy
        tree = ContextTree.from_arrays(db.tree.to_arrays())
        remap = tree.merge(res["tree"])
        require(len(tree) == db.n_contexts,
                "the dense tree holds a context the database lacks")
        for i in pick:
            p, c, k = int(pid[i]), int(ctx[i]), int(col[i])
            mid = (k - m_half) | INCLUSIVE_BIT if k >= m_half else k
            got = db.value(p, int(remap[c]), mid)
            bad += got != float(tensor[p, c, k])
        n_incl = int(np.sum(col[pick] >= m_half))
    standard_dense = dense_measurement_nbytes(n_ctx, 2 * n_metrics) * len(
        ipaths)
    sparse = sizes["pms"] + sizes["cms"]
    out = {"profiles": DENSE_PROFILES, "contexts": res["n_ctx"],
           "metrics_out": res["n_metrics_out"],
           "tensor_bytes": res["result_bytes"], "run_s": dense_s,
           "samples": DENSE_SAMPLES, "inclusive_samples": n_incl,
           "mismatches": bad,
           "standard": {"profiles": len(ipaths), "contexts": n_ctx,
                        "metrics": n_metrics,
                        "dense_bytes": standard_dense,
                        "sparse_pms_bytes": sizes["pms"],
                        "sparse_cms_bytes": sizes["cms"],
                        "dense_over_pms": standard_dense / sizes["pms"],
                        "dense_over_pms_cms": standard_dense / sparse}}
    require(bad == 0, f"dense and sparse values differ on {bad} of "
            f"{DENSE_SAMPLES} samples")
    require(0 < n_incl < DENSE_SAMPLES,
            "the samples must hold exclusive and inclusive cells")
    return out


# -- live ingest, the resident query server and the regression watch ---------

INGEST_PUBLISH_EVERY, INGEST_WORKERS = 24, 4
WARM_CALLS = 20  # timed calls of each op after its first
SMOKE_TRACE_ID = "chip-smoke-0001"
# the analyzers' thresholds lowered so that the findings op finds something
# on the synthetic workload, where the defaults find nothing: its traces
# are 500 uniform samples over 60 s, so each rank's largest gap is ~1% of
# its span, and no one of 196,049 contexts holds 1% of a metric
FINDINGS_THRESHOLDS = {"imbalance": 1.1, "straggler": 1.1,
                       "gap_frac": 0.005}
INGEST_KERNELS = ("segstats", "blockscan_f32", "blockscan_i64", "histogram")


class ServeProcess:
    """``python -m repro_torch.launch.serve ARGV`` in a subprocess, the card
    visible or not.  Threads collect its stdout lines (JSON, each with its
    arrival time on the wall clock and its seconds since the start, and
    ``on_line``'s result) and its stderr; :meth:`stop` sends SIGTERM and
    kills it if it outlives the grace."""

    def __init__(self, argv: list[str], *, card: bool, on_line=None):
        import os
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        if not card:
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        self.lines: list[dict] = []
        self.err: list[str] = []
        self._cond = threading.Condition()
        self._on_line = on_line
        self._readers = [threading.Thread(target=self._read_out, daemon=True),
                         threading.Thread(target=self._read_err, daemon=True)]
        for t in self._readers:
            t.start()

    def _read_out(self):
        for ln in self.proc.stdout:
            entry = {"at": time.time(), "s": time.perf_counter() - self.t0,
                     "doc": json.loads(ln)}
            if self._on_line is not None:
                entry["hook"] = self._on_line(entry["doc"])
            with self._cond:
                self.lines.append(entry)
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def _read_err(self):
        for ln in self.proc.stderr:
            self.err.append(ln)

    def wait_line(self, pred, timeout_s: float) -> dict:
        """The first stdout line whose document satisfies ``pred``."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                for entry in self.lines:
                    if pred(entry["doc"]):
                        return entry
                left = deadline - time.monotonic()
                require(left > 0 and self.proc.poll() is None,
                        f"serve {self.proc.args[3]}: no expected line "
                        f"(exit {self.proc.poll()}): "
                        f"{''.join(self.err)[-2000:]}")
                self._cond.wait(min(left, 1.0))

    def stop(self, grace_s: float = 120.0) -> tuple[int, str]:
        """SIGTERM, then the exit code and stderr (killed past the grace)."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        for t in self._readers:
            t.join(timeout=10)
        return rc, "".join(self.err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _recorded(obj, name: str, into: list) -> None:
    """Wrap ``obj.name`` so each call's return value is kept in ``into``
    with its wall seconds."""
    fn = getattr(obj, name)

    def call(*args):
        t0 = time.perf_counter()
        res = fn(*args)
        into.append({"wall_s": time.perf_counter() - t0, **res})
        return res
    setattr(obj, name, call)


def _db_shas(db_dir) -> dict:
    return {k: sha(Path(db_dir) / f"db.{k}") for k in ("pms", "cms", "trc")}


def _upload_all(client_cls, url_or_addr, paths) -> tuple[dict, float, float]:
    """Every profile in order, one upload a call, then ``/v1/publish``:
    the publish reply, the upload seconds and the publish seconds."""
    host, port = url_or_addr
    with client_cls(host, int(port), timeout_s=900) as c:
        t0 = time.perf_counter()
        for p in paths:
            c.upload(Path(p).read_bytes())
        t1 = time.perf_counter()
        pub = c.publish()
        return pub, t1 - t0, time.perf_counter() - t1


def ingest_float_twin(fpaths, work: Path, dev_sum: dict) -> dict:
    """The float workload through an in-process ingest server on the card,
    every launch counter zeroed just before the uploads: the epoch of all
    48 profiles against the one-shot card database."""
    from repro_torch.core.aggregate import AggregationConfig
    from repro_torch.core.pms import PMSReader
    from repro_torch.ingest import IngestClient, IngestHTTPServer
    from repro_torch.kernels import _build
    srv = IngestHTTPServer(
        str(work / "ingest_float"), publish_every=INGEST_PUBLISH_EVERY,
        config=AggregationConfig(executor="threads",
                                 n_workers=INGEST_WORKERS, compute="device",
                                 device="cuda"))
    appends, publishes = [], []
    _recorded(srv.state, "append", appends)
    _recorded(srv.state, "write_database", publishes)
    _build.launch_counts.reset()
    t0 = time.perf_counter()
    with srv:
        pub, upload_s, publish_s = _upload_all(IngestClient, srv.address,
                                               fpaths)
        metrics = srv.metrics()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts.snapshot()
    epoch_dir = Path(srv.root) / pub["dir"]
    with PMSReader(epoch_dir / "db.pms") as a, \
            PMSReader(dev_sum["pms"]) as b:
        agree = plane_agreement(a, b)
    one = _db_shas(Path(dev_sum["pms"]).parent)
    got = _db_shas(epoch_dir)
    timings = dict(srv.state.timings)
    out = {"wall_s": wall, "upload_s": upload_s, "final_publish_s": publish_s,
           "epoch": pub["epoch"], "profiles": pub["stats"]["n_profiles"],
           "contexts": pub["stats"]["n_contexts"],
           "appends": appends, "publishes": publishes,
           "merges": metrics["merges"],
           "epochs_published": metrics["epochs_published"],
           "launches": counts, "timings": timings, **agree,
           "traces_equal": got["trc"] == one["trc"],
           "bytes_equal_to_oneshot": {k: got[k] == one[k] for k in got}}
    require(out["profiles"] == len(fpaths),
            f"ingest float: the last epoch holds {out['profiles']} profiles")
    for k in INGEST_KERNELS:
        require(counts.get(k, 0) > 0, f"ingest never launched {k}")
    require(timings["device_launches"] == counts,
            f"ingest device_launches {timings['device_launches']} disagree "
            f"with the counters {counts}")
    require(agree["ok"], f"ingest float epoch disagrees with the one-shot "
            f"card database: {agree}")
    require(out["traces_equal"], "ingest float traces differ")
    return out


def ingest_int_twin(ipaths, work: Path, dbs: dict) -> tuple[dict, dict]:
    """The integer workload through the ingest CLI with the card visible,
    while the ``watch`` CLI (no card) follows the same root against the
    numpy database of the same profiles: the ingest and watch lines."""
    from repro_torch.ingest import IngestClient
    from repro_torch.ingest.snapshot import MANIFEST_NAME, epoch_dirname
    root = work / "ingest_int"

    def published_at(doc):  # the epoch's manifest time, on report arrival
        m = root / epoch_dirname(doc["epoch"]) / MANIFEST_NAME
        return m.stat().st_mtime if m.exists() else None

    with ServeProcess(["watch", f"int={root}", "--baseline",
                       dbs["int_numpy"], "--poll-ms", "100", "--wait-s",
                       "900"], card=False, on_line=published_at) as watch, \
            ServeProcess(["ingest", str(root), "--port", "0",
                          "--publish-every", str(INGEST_PUBLISH_EVERY)],
                         card=True) as ing:
        ready = ing.wait_line(lambda d: "url" in d, 300)
        addr = ready["doc"]["url"].removeprefix("http://").split(":")
        pub, upload_s, publish_s = _upload_all(IngestClient, addr, ipaths)
        rc, err = ing.stop()
        last = watch.wait_line(lambda d: d.get("epoch") == pub["epoch"], 300)
        wrc, werr = watch.stop()
    drains = [json.loads(ln)["drain"] for ln in err.splitlines()
              if ln.startswith('{"drain"')]
    epoch_dir = root / pub["dir"]
    got = _db_shas(epoch_dir)
    numpy, card = _db_shas(dbs["int_numpy"]), _db_shas(dbs["int_card"])
    ingest = {"ready_s": ready["s"], "upload_s": upload_s,
              "final_publish_s": publish_s, "epoch": pub["epoch"],
              "profiles": pub["stats"]["n_profiles"],
              "final_publish_stats": pub["stats"], "exit": rc,
              "drain": drains[0] if drains else None,
              "equal_to_numpy": {k: got[k] == numpy[k] for k in got},
              "equal_to_card": {k: got[k] == card[k] for k in got}}
    require(rc == 0 and drains, f"ingest CLI exit {rc}, no drain line: "
            f"{err[-2000:]}")
    require(ingest["profiles"] == len(ipaths),
            f"ingest int: the last epoch holds {ingest['profiles']} profiles")
    require(all(ingest["equal_to_numpy"].values())
            and all(ingest["equal_to_card"].values()),
            f"ingest int epoch differs: {ingest}")
    reports = [e for e in watch.lines if "epoch" in e["doc"]]
    epochs = [e["doc"]["epoch"] for e in reports]
    status = [json.loads(ln)["status"] for ln in werr.splitlines()
              if ln.startswith('{"status"')]
    final = last["doc"]
    watch_out = {
        "exit": wrc, "epochs": epochs,
        "reports": [{"epoch": e["doc"]["epoch"], "eval_s": e["doc"]["eval_s"],
                     "worst": e["doc"]["worst"],
                     "findings": len(e["doc"]["findings"]),
                     "detect_s": (e["at"] - e["hook"]
                                  if e["hook"] is not None else None)}
                    for e in reports],
        "final_regressions": sum(f["kind"] == "regression"
                                 for f in final["findings"]),
        "final_kinds": sorted({f["kind"] for f in final["findings"]}),
        "status": status[0] if status else None}
    require(wrc == 0, f"watch exit {wrc}: {werr[-2000:]}")
    require(epochs == sorted(set(epochs)) and epochs[-1] == pub["epoch"],
            f"watch reported epochs {epochs}, the last published "
            f"{pub['epoch']}")
    require(watch_out["final_regressions"] == 0,
            "watch: the final epoch regressed against the numpy database of "
            "the same profiles")
    return ingest, watch_out


def _smoke_requests(db) -> list:
    """The seven ops (the stripe twice: the root and the hottest context)
    on metric 9, a device metric, aimed from ``db``."""
    from repro_torch.query import topk_hot_paths
    from repro_torch.serve.engine import QueryRequest
    metric = 9
    hot = topk_hot_paths(db, metric, k=1, inclusive=False)[0].ctx
    tenth = topk_hot_paths(db, metric, k=10, inclusive=True)[-1].value
    return [("profile", QueryRequest(op="profile", pid=1)),
            ("stripe", QueryRequest(op="stripe", ctx=0, metric=metric,
                                    inclusive=True)),
            ("stripe_hot", QueryRequest(op="stripe", ctx=int(hot),
                                        metric=metric)),
            ("value", QueryRequest(op="value", pid=1, ctx=int(hot),
                                   metric=metric)),
            ("topk", QueryRequest(op="topk", metric=metric, k=10,
                                  inclusive=True)),
            ("threshold", QueryRequest(op="threshold", metric=metric,
                                       inclusive=True,
                                       params={"min_value": float(tenth)})),
            ("window", QueryRequest(op="window", pid=1, t0=10.0, t1=20.0)),
            ("findings", QueryRequest(op="findings", metric=metric, params={
                "limit": DIAGNOSE_LIMIT,
                "thresholds": FINDINGS_THRESHOLDS}))]


def query_server_phase(root: Path, numpy_db: str) -> dict:
    """``query-server ROOT --follow`` on the integer ingest root with no card
    visible, single-process and with ``--shards 2``: each op's reply body
    byte-equal to the in-process engine's on numpy's database of the same
    profiles, and its first and warm call times."""
    import http.client

    from repro_torch.query import Database
    from repro_torch.serve.engine import QueryServer
    from repro_torch.serve.wire import request_to_wire, result_to_wire
    with Database(numpy_db) as db:
        reqs = _smoke_requests(db)
        server = QueryServer(db)
        results = {name: server.serve_one(r) for name, r in reqs}
    expect = {name: json.dumps({"results": [result_to_wire(res)],
                                "trace_id": SMOKE_TRACE_ID}).encode()
              for name, res in results.items()}
    out = {"warm_calls": WARM_CALLS, "findings": len(results["findings"]),
           "findings_kinds": sorted({f.kind for f in results["findings"]})}
    require(out["findings"] > 0, "the findings op found nothing")
    for mode, extra in (("single", []), ("shards2", ["--shards", "2"])):
        row = {}
        with ServeProcess(["query-server", str(root), "--follow", "--port",
                           "0", *extra], card=False) as qs:
            ready = qs.wait_line(lambda d: "url" in d, 300)
            row["ready_s"] = ready["s"]
            row["epoch"] = ready["doc"].get("epoch")
            row["warm"] = ready["doc"].get("warm")
            host, port = ready["doc"]["url"].removeprefix(
                "http://").split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=300)
            try:
                for name, r in reqs:
                    body = json.dumps(
                        {"requests": [request_to_wire(r)]}).encode()
                    times, replies = [], set()
                    for _ in range(WARM_CALLS + 1):
                        t0 = time.perf_counter()
                        conn.request("POST", "/v1/query", body=body, headers={
                            "Content-Type": "application/json",
                            "X-Trace-Id": SMOKE_TRACE_ID})
                        resp = conn.getresponse()
                        raw = resp.read()
                        times.append((time.perf_counter() - t0) * 1e3)
                        require(resp.status == 200,
                                f"query-server {mode} {name}: {resp.status}")
                        replies.add(raw)
                    warm = sorted(times[1:])
                    row[name] = {
                        "first_ms": times[0],
                        "warm_median_ms": statistics.median(warm),
                        "warm_p95_ms": warm[math.ceil(0.95 * len(warm)) - 1],
                        "reply_bytes": len(raw),
                        "bytes_equal": replies == {expect[name]}}
                    require(row[name]["bytes_equal"],
                            f"query-server {mode} {name}: the reply differs "
                            f"from the in-process engine's")
            finally:
                conn.close()
            rc, err = qs.stop()
        row["exit"] = rc
        row["drained"] = any(ln.startswith('{"drain"') and
                             json.loads(ln)["drain"]["drained"]
                             for ln in err.splitlines())
        require(rc == 0 and row["drained"],
                f"query-server {mode}: exit {rc}: {err[-2000:]}")
        out[mode] = row
    return out


def repeated_launches(fn, times: int = 10) -> bool:
    """``fn`` run ``times`` times gives the same bits each time."""
    import torch
    first = _bits(fn())
    return all(torch.equal(_bits(fn()), first) for _ in range(times - 1))


def run_train(train, argv):
    """The port's training CLI; its Trainer, optimizer state, stdout and
    wall seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tr, opt = train.main(argv)
    return tr, opt, buf.getvalue(), time.perf_counter() - t0


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(train, work: Path):
    """Full-width training through the CLI, with profile and checkpoint;
    returns the Trainer and its optimizer state too, for the trace."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.api import model_flops, n_params
    from repro_torch.configs.base import ShapeConfig, get_arch
    prof, ckpt = work / "train_prof", work / "train_ckpt"
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.reset()
    tr, opt, _, wall = run_train(train, [
        "--arch", ARCH, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--profile-dir", str(prof), "--ckpt-dir", str(ckpt),
        "--ckpt-every", str(TRAIN_STEPS), "--device", "cuda"])
    launches = _build.launch_counts.snapshot()
    peak = torch.cuda.max_memory_allocated()
    history = tr.history
    cfg = get_arch(ARCH)
    steps = [h["step_time"] for h in history]
    median = statistics.median(steps[1:])
    flops = model_flops(cfg, ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    out = {"arch": ARCH, "params": n_params(cfg), "steps": len(history),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "wall_s": wall,
           "step_s": steps, "median_step_s_after_first": median,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
           "model_tflop_per_step_6nd": flops / 1e12,
           "model_tflop_per_s": flops / median / 1e12,
           "max_memory_allocated": peak,
           "losses": [h["loss"] for h in history],
           "grad_norms": [h["grad_norm"] for h in history],
           "launches": launches}
    require(len(history) == TRAIN_STEPS, f"train took {len(history)} steps")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in history), f"train losses not finite: {out}")
    require((prof / "worker0.rprf").is_file(), "train wrote no profile")
    return out, prof / "worker0.rprf", ckpt, tr, opt


def parity_tree(cfg) -> dict:
    """Seeded weights for ``cfg``, drawn on the card, where a full-width
    model's draw is quick: a parity phase loads the same tree into the
    card's model and the CPU's."""
    import torch
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    return P.init_params(build_model(cfg, device="meta").param_defs(),
                         torch.Generator("cuda").manual_seed(SEED_FLOAT),
                         cfg.dtype, "cuda")


def train_parity_phase() -> dict:
    """The full-width model cut to 2 layers, one seed, on the card and on
    the CPU: loss and gradient global norm."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import global_norm
    cfg = get_arch(ARCH).replace(n_layers=PARITY_LAYERS)
    tree = parity_tree(cfg)
    tokens = torch.from_numpy(TokenPipeline(cfg.vocab_size, TRAIN_SEQ,
                                            PARITY_BATCH).batch_at(0))
    res = {}
    for dev in ("cuda", "cpu"):
        model = P.from_reference(build_model(cfg, device=dev), tree)
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model, {"tokens": tokens.to(dev)})
        gnorm = global_norm(grads.values())
        res[dev] = {"loss": float(loss), "grad_norm": float(gnorm),
                    "seconds": time.perf_counter() - t0}
        del model, grads
    free_card()
    rel_loss = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(
        res["cpu"]["loss"])
    rel_gnorm = abs(res["cuda"]["grad_norm"] - res["cpu"]["grad_norm"]) / abs(
        res["cpu"]["grad_norm"])
    out = {"layers": PARITY_LAYERS, "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
           "seed": SEED_FLOAT, **res, "rel_loss": rel_loss,
           "rel_grad_norm": rel_gnorm, "rtol_loss": PARITY_RTOL_LOSS,
           "rtol_grad_norm": PARITY_RTOL_GNORM}
    require(rel_loss <= PARITY_RTOL_LOSS and rel_gnorm <= PARITY_RTOL_GNORM,
            f"card and CPU disagree: {out}")
    return out


# ---------------------------------------------------------------------------
# the MoE, VLM and audio families
# ---------------------------------------------------------------------------

class RoutingRecorder:
    """Wraps the port's two MoE dispatches (``repro_torch.models.moe``) and
    keeps, for each call on a real device, the dispatch, the batch shape,
    the capacity factor and each token's top-k experts; ``restore`` undoes
    the wrapping."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe = moe
        self.calls: list[tuple] = []
        self._orig = {n: getattr(moe, n)
                      for n in ("moe_block", "moe_block_rowwise")}
        for name, orig in self._orig.items():
            setattr(moe, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        import torch

        def recorded(x, router_w, *weights, top_k, capacity_factor, **kw):
            out, probs = orig(x, router_w, *weights, top_k=top_k,
                              capacity_factor=capacity_factor, **kw)
            if not probs.is_meta:
                B, S, _ = x.shape
                self.calls.append((name, B, S, probs.shape[-1], top_k,
                                   capacity_factor,
                                   torch.topk(probs.detach(), top_k).indices))
            return out, probs

        return recorded

    def restore(self) -> None:
        for name, orig in self._orig.items():
            setattr(self.moe, name, orig)

    def dropped(self, dispatch: str) -> dict:
        """Routed copies over capacity in the calls of one dispatch: a
        sorted expert keeps ``sorted_capacity`` copies of the whole batch,
        a rowwise one ``rowwise_capacity`` of each row."""
        import torch
        name = {"sorted": "moe_block", "rowwise": "moe_block_rowwise"}[dispatch]
        drop = total = 0
        for n, B, S, E, K, cf, eidx in self.calls:
            if n != name:
                continue
            if n == "moe_block":
                C = self.moe.sorted_capacity(B * S, K, cf, E)
                counts = torch.bincount(eidx.reshape(-1), minlength=E)
            else:
                C = self.moe.rowwise_capacity(S, K, cf, E)
                rows = eidx.reshape(B, S * K)
                counts = torch.zeros((B, E), dtype=torch.int64,
                                     device=rows.device).scatter_add_(
                    1, rows, torch.ones_like(rows))
            drop += int(torch.clamp_min(counts - C, 0).sum())
            total += B * S * K
        return {"calls": sum(c[0] == name for c in self.calls),
                "copies": total, "dropped": drop,
                "dropped_share": drop / total if total else None}


def set_dispatch(model, dispatch: str) -> None:
    """Switch a built MoE model's dispatch (its blocks read their config
    at each call)."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = m.cfg.replace(moe_dispatch=dispatch)


def _step_stats(cfg, shape_seq: int, batch: int, tokens_per_step: int,
                history: list[dict]) -> dict:
    """Step times, tokens/s, model TFLOP/s (6 N_active D) and the losses
    of a family's steps (the first step is left out of the median)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import model_flops, n_active_params, n_params
    steps = [h["step_time"] for h in history]
    median = statistics.median(steps[1:])
    flops = model_flops(cfg, ShapeConfig("smoke", shape_seq, batch, "train"))
    out = {"params": n_params(cfg), "active_params": n_active_params(cfg),
           "steps": len(history), "step_s": steps,
           "median_step_s_after_first": median,
           "tokens_per_s": tokens_per_step / median,
           "model_tflop_per_step_6nd": flops / 1e12,
           "model_tflop_per_s": flops / median / 1e12,
           "losses": [h["loss"] for h in history],
           "grad_norms": [h["grad_norm"] for h in history]}
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in history), f"{cfg.name}: losses not finite: {out}")
    return out


def profiled_step(fn, median_step_s: float) -> dict:
    """``fn()``, one train step, under ``torch.profiler``: its wall ms to a
    synchronise, the card's kernel ms and launches, the idle share over
    that step and over the unprofiled median step, and the top kernels.
    Only the card's activity is traced: none of these reads the host's
    ops, and an xLSTM step runs over a million of them, whose events took
    ~90 s to gather and average."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    profiler_s = time.perf_counter() - t_prof - step_ms / 1e3
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    require(busy_ms > 0, "torch.profiler saw no device time")
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    out = {"step_ms_profiled": step_ms, "device_ms": busy_ms,
           "kernel_launches": sum(e.count for e in kernels),
           "idle_share": 1.0 - busy_ms / step_ms,
           "idle_share_vs_median_step": 1.0 - busy_ms / (median_step_s * 1e3),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": _dev_us(e) / 1e3} for e in top],
           "profiler_overhead_s": profiler_s}
    if isinstance(metrics, dict) and "loss" in metrics:  # a train step's
        out["loss"] = float(metrics["loss"])
        out["grad_norm"] = float(metrics["grad_norm"])
    return out


def timed_steps(step_fn, opt, batches) -> list[dict]:
    """``step_fn(opt, batch)`` on each batch, each timed to a synchronise:
    ``[{"step", "loss", "grad_norm", "step_time"}]``."""
    import torch
    history = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(opt, batch)
        torch.cuda.synchronize()
        history.append({"step": i, "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "step_time": time.perf_counter() - t0})
    return history


def train_moe_phase(train, work: Path):
    """qwen3-moe-30b-a3b at full width, cut to MOE_LAYERS layers, through
    the CLI with profile and checkpoint (the sorted dispatch), then one
    traced step of it, and two with the rowwise dispatch through
    ``make_train_step``, the second traced."""
    import torch
    from repro_torch.configs.base import get_arch, load_all, register_arch
    from repro_torch.kernels import _build
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    load_all()  # the published configs first: a filled registry loads none
    cfg = register_arch(get_arch(MOE_ARCH).replace(name=MOE_CUT,
                                                   n_layers=MOE_LAYERS))
    prof, ckpt = work / "moe_prof", work / "moe_ckpt"
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.reset()
    routing = RoutingRecorder()
    try:
        tr, opt, _, wall = run_train(train, [
            "--arch", MOE_CUT, "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--profile-dir", str(prof), "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(TRAIN_STEPS), "--device", "cuda"])
        peak_cli = torch.cuda.max_memory_allocated()
        sorted_drop = routing.dropped("sorted")
        history = list(tr.history)
        median = statistics.median(h["step_time"] for h in history[1:])
        # one more step of each dispatch under torch.profiler
        tr.profiler = tr.ckpt = None  # the CLI's profile and checkpoint are written
        trace = profiled_step(lambda: tr.run(opt, start_step=TRAIN_STEPS,
                                             steps=1), median)
        set_dispatch(tr.model, "rowwise")
        step = make_train_step(tr.model, AdamWConfig(lr=3e-4,
                                                     warmup_steps=10))
        tokens = [{"tokens": torch.from_numpy(tr.pipeline.batch_at(
            TRAIN_STEPS + i)).cuda()} for i in (1, 2)]
        row = timed_steps(step, opt, tokens[:1])
        row_drop = routing.dropped("rowwise")
        row_trace = profiled_step(lambda: step(opt, tokens[1]),
                                  row[0]["step_time"])
    finally:
        routing.restore()
    launches = _build.launch_counts.snapshot()
    peak = torch.cuda.max_memory_allocated()
    del tr, opt, tokens, step
    free_card()
    out = {"arch": MOE_ARCH, "layers": f"{MOE_LAYERS} of 48",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "wall_s": wall,
           **_step_stats(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_BATCH * TRAIN_SEQ,
                         history),
           "max_memory_allocated_cli": peak_cli,
           "max_memory_allocated": peak,
           "dropped_sorted": sorted_drop, "trace_sorted": trace,
           "rowwise_step": {"step_s": row[0]["step_time"],
                            "loss": row[0]["loss"],
                            "grad_norm": row[0]["grad_norm"],
                            "dropped_rowwise": row_drop,
                            "trace": row_trace},
           "checkpoint_bytes": sum(f.stat().st_size
                                   for f in ckpt.rglob("*") if f.is_file()),
           "disk_free_bytes": shutil.disk_usage(work).free,
           "launches": launches}
    require(math.isfinite(row[0]["loss"]), f"rowwise MoE step: {out}")
    require(sorted_drop["calls"] > 0 and row_drop["calls"] > 0,
            f"an MoE dispatch never ran: {out}")
    require((prof / "worker0.rprf").is_file(), "train_moe wrote no profile")
    return out, prof / "worker0.rprf", ckpt


def _raw(t):
    """``t``'s bits as integers of its width (bf16 too)."""
    import torch
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _init_model(cfg, device: str, seed: int):
    """The port's model for ``cfg`` on ``device``, its weights drawn by
    ``init_params`` from ``seed``."""
    import torch
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return P.from_reference(model, P.init_params(model.param_defs(), gen,
                                                 cfg.dtype, device))


def family_batch(cfg, rows: int, step: int, device: str,
                 seq: int = TRAIN_SEQ) -> dict:
    """One step's batch: ``seq`` tokens a row from ``TokenPipeline``; for
    the VLM, ``vision_tokens`` seeded embeddings a row; for audio,
    AUDIO_FRAMES seeded frames a row and AUDIO_TOKENS decoder tokens."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models.params import torch_dtype
    seq = AUDIO_TOKENS if cfg.family == "audio" else seq
    batch = {"tokens": torch.from_numpy(TokenPipeline(
        cfg.vocab_size, seq, rows).batch_at(step)).to(device)}
    gen = torch.Generator().manual_seed(SEED_FLOAT * 1000 + step)
    extra = {"vlm": ("vision_embed", cfg.vision_tokens),
             "audio": ("frames", AUDIO_FRAMES)}.get(cfg.family)
    if extra:
        name, n = extra
        batch[name] = torch.randn((rows, n, cfg.d_model), generator=gen).to(
            device, torch_dtype(cfg.dtype))
    return batch


def train_family_phase(cfg, steps: int, seq: int = TRAIN_SEQ) -> dict:
    """``steps`` AdamW steps of ``cfg`` at batch TRAIN_BATCH x ``seq``
    through ``make_train_step`` with the family's batch dict (the CLI
    feeds tokens only, as the reference's does, so it cannot train the VLM
    and audio families), and one more under ``torch.profiler``; for the
    xLSTM also one mLSTM and one sLSTM block's forward and backward
    alone."""
    import torch
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _init_model(cfg, "cuda", 0)
    opt = init_opt_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = [family_batch(cfg, TRAIN_BATCH, i, "cuda", seq)
               for i in range(steps + 1)]
    step = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=10))
    history = timed_steps(step, opt, batches[:steps])
    peak = torch.cuda.max_memory_allocated()
    trace = profiled_step(lambda: step(opt, batches[steps]), statistics.median(
        h["step_time"] for h in history[1:]))
    blocks = xlstm_block_ms(model, seq) if hasattr(model, "slstm") else None
    del model, opt, batches, step
    free_card()
    if cfg.family == "audio":
        shape_seq, tokens = AUDIO_FRAMES, TRAIN_BATCH * (AUDIO_FRAMES
                                                         + AUDIO_TOKENS)
        shapes = {"frames": AUDIO_FRAMES, "decoder_tokens": AUDIO_TOKENS}
    else:
        shape_seq, tokens = seq, TRAIN_BATCH * seq
        shapes = {"seq": seq, "vision_tokens": cfg.vision_tokens}
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "batch": TRAIN_BATCH,
           **shapes, "init_s": init_s,
           **_step_stats(cfg, shape_seq, TRAIN_BATCH, tokens, history),
           "max_memory_allocated": peak, "trace": trace}
    if blocks:
        out["block_ms"] = blocks
    require(all(math.isfinite(m) for m in (trace["loss"],
                                           trace["grad_norm"])),
            f"{cfg.name}: the traced step is not finite: {trace}")
    return out


def family_parity_phase() -> dict:
    """Each family at full width, cut to the least depth its structure
    allows, one seed, PARITY_BATCH rows (of SSM_PARITY_SEQ tokens for the
    SSM and hybrid families, one whole chunk): loss and gradient global
    norm on the card against the port on the CPU (bf16 both); for the MoE
    also the share of top-k choices the two agree on."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, n_params
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import global_norm
    out = {}
    for fam, (arch, cut) in FAMILY_PARITY.items():
        cfg = get_arch(arch).replace(**cut)
        tree = parity_tree(cfg)
        seq = (SSM_PARITY_SEQ if cfg.family in ("hybrid", "ssm")
               else TRAIN_SEQ)
        batch = family_batch(cfg, PARITY_BATCH, 0, "cpu", seq)
        res, routes = {}, {}
        for dev in ("cuda", "cpu"):
            model = P.from_reference(build_model(cfg, device=dev), tree)
            routing = RoutingRecorder()
            try:
                t0 = time.perf_counter()
                loss, grads = value_and_grad(
                    model, {k: v.to(dev) for k, v in batch.items()})
                gnorm = global_norm(grads.values())
                res[dev] = {"loss": float(loss), "grad_norm": float(gnorm),
                            "seconds": time.perf_counter() - t0}
            finally:
                routing.restore()
            routes[dev] = [c[-1].cpu() for c in routing.calls]
            del model, grads
        free_card()
        rel_loss = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(
            res["cpu"]["loss"])
        rel_gnorm = abs(res["cuda"]["grad_norm"]
                        - res["cpu"]["grad_norm"]) / abs(res["cpu"]["grad_norm"])
        row = {"arch": arch, "cut": cut, "params": n_params(cfg),
               "batch": PARITY_BATCH, "seq": seq, "seed": SEED_FLOAT, **res,
               "rel_loss": rel_loss, "rel_grad_norm": rel_gnorm}
        if cfg.n_experts:
            require(len(routes["cuda"]) == len(routes["cpu"]) > 0,
                    f"{fam}: the routing calls differ")
            agree = total = 0
            for a, b in zip(routes["cuda"], routes["cpu"]):
                hit = torch.zeros(a.shape[0], cfg.n_experts, dtype=torch.bool)
                hit.scatter_(1, a, True)
                agree += int(hit.gather(1, b).sum())
                total += b.numel()
            row["topk_agreement"] = agree / total
            row["routing_calls"] = len(routes["cpu"])
        out[fam] = row
        require(rel_loss <= PARITY_RTOL_LOSS and rel_gnorm <= PARITY_RTOL_GNORM,
                f"{fam}: card and CPU disagree: {row}")
    out["rtol_loss"], out["rtol_grad_norm"] = (PARITY_RTOL_LOSS,
                                               PARITY_RTOL_GNORM)
    return out


def moe_determinism_phase() -> dict:
    """One MoE step's loss and gradients (the parity cut, batch TRAIN_BATCH
    x TRAIN_SEQ) twice on the card with each dispatch: bit-equal."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.train.loop import value_and_grad
    arch, cut = FAMILY_PARITY["moe"]
    out = {"arch": arch, "cut": cut, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}
    for dispatch in ("sorted", "rowwise"):
        cfg = get_arch(arch).replace(moe_dispatch=dispatch, **cut)
        model = _init_model(cfg, "cuda", SEED_INT)
        batch = family_batch(cfg, TRAIN_BATCH, 1, "cuda")
        (l1, g1), (l2, g2) = (value_and_grad(model, batch) for _ in range(2))
        differ = [n for n in g1 if not torch.equal(_raw(g1[n]),
                                                   _raw(g2[n]))]
        out[dispatch] = {"loss": float(l1),
                         "loss_equal": bool(torch.equal(_raw(l1), _raw(l2))),
                         "gradients": len(g1), "gradients_differ": differ}
        del model, g1, g2
        free_card()
        require(out[dispatch]["loss_equal"] and not differ,
                f"MoE step not bit-equal ({dispatch}): {out[dispatch]}")
    return out


# ---------------------------------------------------------------------------
# the SSM and hybrid families
# ---------------------------------------------------------------------------

def train_hybrid_phase(train, work: Path):
    """zamba2-7b at full width, cut to HYBRID_LAYERS layers, through the
    CLI at TRAIN_BATCH x SSM_TRAIN_SEQ with profile and checkpoint, then
    one traced step of the same Trainer; returns the profile and the
    checkpoint too, for ``train_profile_phase`` and ``resume_phase``."""
    import torch
    from repro_torch.configs.base import get_arch, load_all, register_arch
    from repro_torch.kernels import _build
    load_all()  # the published configs first: a filled registry loads none
    cfg = register_arch(get_arch(HYBRID_ARCH).replace(
        name=HYBRID_CUT, n_layers=HYBRID_LAYERS))
    prof, ckpt = work / "hybrid_prof", work / "hybrid_ckpt"
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.reset()
    tr, opt, _, wall = run_train(train, [
        "--arch", HYBRID_CUT, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(SSM_TRAIN_SEQ),
        "--profile-dir", str(prof), "--ckpt-dir", str(ckpt),
        "--ckpt-every", str(TRAIN_STEPS), "--device", "cuda"])
    peak_cli = torch.cuda.max_memory_allocated()
    history = list(tr.history)
    median = statistics.median(h["step_time"] for h in history[1:])
    tr.profiler = tr.ckpt = None  # the CLI wrote its profile, checkpoint
    trace = profiled_step(lambda: tr.run(opt, start_step=TRAIN_STEPS,
                                         steps=1), median)
    trace.update(loss=tr.history[-1]["loss"],
                 grad_norm=tr.history[-1]["grad_norm"])
    launches = _build.launch_counts.snapshot()
    groups = tr.model.groups
    del tr, opt
    free_card()
    out = {"arch": HYBRID_ARCH, "layers": f"{HYBRID_LAYERS} of 81",
           "groups": groups, "batch": TRAIN_BATCH, "seq": SSM_TRAIN_SEQ,
           "ssm_chunk": cfg.ssm_chunk, "wall_s": wall,
           **_step_stats(cfg, SSM_TRAIN_SEQ, TRAIN_BATCH,
                         TRAIN_BATCH * SSM_TRAIN_SEQ, history),
           "max_memory_allocated": peak_cli, "trace": trace,
           "checkpoint_bytes": sum(f.stat().st_size
                                   for f in ckpt.rglob("*") if f.is_file()),
           "launches": launches}
    require(math.isfinite(trace["loss"]) and math.isfinite(
        trace["grad_norm"]), f"the traced hybrid step is not finite: {out}")
    require((prof / "worker0.rprf").is_file(), "train_hybrid wrote no profile")
    return out, prof / "worker0.rprf", ckpt


def _fwd_bwd_ms(fn, x, reps: int = 3) -> float:
    """Median wall ms of ``fn(x)``'s forward and backward, each timed to a
    synchronise after one warm-up."""
    import torch
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = fn(x)
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def xlstm_block_ms(model, seq: int) -> dict:
    """One mLSTM and one sLSTM block of ``model`` alone, forward and
    backward on a seeded TRAIN_BATCH x ``seq`` input: where the step's
    time goes, block by block."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED_FLOAT)
    x = torch.randn((TRAIN_BATCH, seq, cfg.d_model), generator=gen,
                    device="cuda").to(model.embed.dtype).requires_grad_()
    out = {}
    for name, blocks in (("mlstm", model.mlstm), ("slstm", model.slstm)):
        ms = _fwd_bwd_ms(blocks[0], x)
        out[name] = {"ms": ms, "blocks": len(blocks),
                     "ms_all_blocks": ms * len(blocks)}
    model.zero_grad(set_to_none=True)
    return out


def _scan_inputs(B: int, S: int, H: int, P: int, N: int, Hk: int, gen):
    """Seeded scan inputs on the card, f32: log-decays ``-softplus`` of
    standard normals, as Mamba2's and the mLSTM's are at initialisation
    (~-0.69, so a chunk of 256 would overflow an unmasked decay matrix);
    keys over sqrt(N) in the per-head form, as the mLSTM scales them."""
    import torch
    import torch.nn.functional as F
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    k = r(B, S, Hk, N)
    return (-F.softplus(r(B, S, H)), r(B, S, H, P),
            k if Hk == 1 else k / math.sqrt(N), r(B, S, Hk, N),
            torch.zeros((B, H, P, N), device="cuda"))


def ssm_scan_phase() -> dict:
    """``linear_rnn_chunked`` alone at each family's full shape (batch
    TRAIN_BATCH x SSM_TRAIN_SEQ): the forward and the gradients of a
    seeded linear functional at chunk 256 against chunk 64, each tensor
    within SSM_SCAN_TOL of its largest, every gradient finite; the peak
    memory of one forward + backward at 256 and its call and device ms."""
    import torch
    from repro_torch.models.ssm import linear_rnn_chunked
    out = {"batch": TRAIN_BATCH, "seq": SSM_TRAIN_SEQ,
           "chunks": list(SSM_SCAN_CHUNKS), "tol_of_largest": SSM_SCAN_TOL}
    for name, shape in SSM_SCAN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED_FLOAT)
        ins = _scan_inputs(TRAIN_BATCH, SSM_TRAIN_SEQ, **shape, gen=gen)
        y0, _ = linear_rnn_chunked(*ins, chunk=SSM_SCAN_CHUNKS[0])
        cot = (torch.randn(y0.shape, generator=gen, device="cuda"),
               torch.randn(ins[-1].shape, generator=gen, device="cuda"))
        del y0

        def fwd_bwd(chunk):
            ts = [t.clone().requires_grad_() for t in ins[:4]]
            y, h = linear_rnn_chunked(*ts, ins[4], chunk=chunk)
            ((y * cot[0]).sum() + (h * cot[1]).sum()).backward()
            return [y.detach(), h.detach()] + [t.grad for t in ts]

        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fwd_bwd(SSM_SCAN_CHUNKS[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = fwd_bwd(SSM_SCAN_CHUNKS[1])
        names = ["y", "h_out", "d_log_a", "d_v", "d_k", "d_q"]
        rows = {}
        for n, a, b in zip(names, got, want):
            largest = float(b.abs().max())
            rows[n] = {"finite": bool(torch.isfinite(a).all()),
                       "max_abs_diff": float((a - b).abs().max()),
                       "largest": largest}
            rows[n]["ok"] = rows[n]["finite"] and (
                rows[n]["max_abs_diff"] <= SSM_SCAN_TOL * largest)
        del got, want
        out[name] = {**shape, "agree": rows, "peak_bytes_fwd_bwd": peak,
                     "call_ms_fwd_bwd": time_ms(
                         lambda: fwd_bwd(SSM_SCAN_CHUNKS[0]), iters=5),
                     "device_ms_fwd_bwd": device_ms(
                         lambda: fwd_bwd(SSM_SCAN_CHUNKS[0]), iters=5)}
        del ins, cot
        free_card()
        require(all(r["ok"] for r in rows.values()),
                f"ssm_scan {name}: chunk 256 and 64 disagree: {out[name]}")
    return out


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _gen_inputs(cfg, rows: int, prompt: int, seed: int):
    """Seeded prompts (rows, prompt) int32 and the family's extras, numpy
    f32: the VLM's vision embeddings, whisper's AUDIO_FRAMES frames."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (rows, prompt)).astype(np.int32)
    extra = {"vlm": ("vision_embed", cfg.vision_tokens),
             "audio": ("frames", AUDIO_FRAMES)}.get(cfg.family)
    extras = {}
    if extra:
        extras[extra[0]] = rng.standard_normal(
            (rows, extra[1], cfg.d_model), dtype=np.float32)
    return prompts, extras


def generate_launcher_phase() -> dict:
    """qwen3-0.6b whole through ``python -m repro_torch.launch.serve`` (no
    mode word) as a subprocess: GEN_BATCH requests of GEN_PROMPT tokens,
    GEN_NEW new tokens each, one batch; its ``served ...`` line parsed."""
    import os
    import re
    argv = ["--arch", ARCH, "--requests", str(GEN_BATCH), "--prompt-len",
            str(GEN_PROMPT), "--new-tokens", str(GEN_NEW), "--max-batch",
            str(GEN_BATCH)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"the generation launcher failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    m = re.match(r"served (\d+) requests, (\d+) tokens in ([0-9.]+)s "
                 r"\(([0-9.]+) tok/s", lines[0] if lines else "")
    require(m is not None and int(m[1]) == GEN_BATCH
            and int(m[2]) == GEN_BATCH * GEN_NEW
            and [ln.split(":")[0] for ln in lines[1:4]]
            == [f"req{i}" for i in range(min(3, GEN_BATCH))],
            f"the generation launcher printed {proc.stdout[-2000:]!r}")
    return {"argv": argv, "wall_s": wall, "served_line": lines[0],
            "serve_s": float(m[3]), "tokens_per_s": float(m[4]),
            "req0": lines[1]}


def _cache_bytes(cache, batch: dict) -> int:
    """Bytes of every tensor leaf of a serving cache (KV caches, recurrent
    states, conv windows), except the batch's own tensors that it keeps
    (the VLM's ``vision_embed``)."""
    import torch
    inputs = {id(v) for v in batch.values()}

    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, (tuple, list)):
            return sum(walk(v) for v in t)
        if isinstance(t, torch.Tensor) and id(t) not in inputs:
            return t.numel() * t.element_size()
        return 0
    return walk(cache)


def generate_family(cfg, prompt: int) -> dict:
    """``ServeEngine.generate`` on the card (bf16 parameters from a seed)
    of GEN_BATCH seeded prompts of ``prompt`` tokens, GEN_NEW new tokens
    each, after a warm-up call; then the same loop with the prefill and
    the decode steps timed apart, and one more decode step under
    ``torch.profiler``; and the head's product at batch GEN_BATCH, with an
    f32 output against casting the head to f32 first."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.layers import logits_f32
    from repro_torch.serve.engine import ServeEngine
    model = _init_model(cfg, "cuda", 0)
    prompts, extras = _gen_inputs(cfg, GEN_BATCH, prompt, SEED_FLOAT)
    max_len = prompt + GEN_NEW + 1
    eng = ServeEngine(model, max_len=max_len, max_batch=GEN_BATCH)
    eng.generate(prompts, 2, extras=extras)  # first-call set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.reset()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, GEN_NEW, extras=extras)  # ends on the host
    gen_s = time.perf_counter() - t0
    launches = _build.launch_counts.snapshot()
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompts).cuda(),
                 **{k: torch.from_numpy(v).cuda() for k, v in extras.items()}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, max_len=max_len)
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(GEN_NEW):
            logits, cache = model.decode_step(cache, {"tokens": tok[:, None]})
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        split = torch.stack(out[:GEN_NEW], 1).cpu().numpy()
        trace = profiled_step(lambda: model.decode_step(
            cache, {"tokens": tok[:, None]}), decode_s / GEN_NEW)
        cache_bytes = _cache_bytes(cache, batch)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    head = model._head() if hasattr(model, "_head") else model.lm_head
    x = torch.randn((GEN_BATCH, cfg.d_model), device="cuda").to(head.dtype)
    head_ms = {"f32_output_gemm": time_ms(lambda: logits_f32(x, head)),
               "cast_then_f32_gemm": time_ms(lambda: x.float() @ head.float())}
    del model, eng, cache, batch, logits, head, x
    free_card()
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": GEN_BATCH,
           "prompt": prompt, "new_tokens": GEN_NEW, "max_len": max_len,
           "weights_bytes": weights, "cache_bytes": cache_bytes,
           "generate_s": gen_s,
           "generate_tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": GEN_BATCH * prompt / prefill_s,
           "decode_ms_per_step": decode_s / GEN_NEW * 1e3,
           "decode_tokens_per_s": GEN_BATCH * GEN_NEW / decode_s,
           "weights_once_ms_at_hbm": weights / HBM_BYTES_PER_S * 1e3,
           "max_memory_allocated": peak,
           "split_tokens_equal_generate": bool((split == tokens).all()),
           "launches": launches, "trace": trace, "head_ms": head_ms}
    if cfg.family == "audio":
        res["frames"] = AUDIO_FRAMES
    require(finite and tokens.shape == (GEN_BATCH, GEN_NEW)
            and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
            f"{cfg.name}: generation gave {tokens!r}, logits finite: "
            f"{finite}")
    return res


def generate_phase() -> dict:
    """Generation on the card, each model freeing the card before the next:
    qwen3-0.6b whole through the launcher, then in process qwen3-0.6b
    whole, the MoE cut to MOE_LAYERS, the VLM to VLM_LAYERS, whisper-small
    whole with AUDIO_FRAMES frames, and the recurrent families whole at
    the published chunk: zamba2-7b (81 Mamba2 layers, 14 applications of
    the shared attention block) and xlstm-350m (18 mLSTM and 6 sLSTM
    blocks)."""
    from repro_torch.configs.base import get_arch
    out = {"launcher": generate_launcher_phase()}
    for fam, cfg, prompt in (
            ("dense", get_arch(ARCH), GEN_PROMPT),
            ("moe", get_arch(MOE_ARCH).replace(name=MOE_CUT,
                                               n_layers=MOE_LAYERS),
             GEN_PROMPT),
            ("vlm", get_arch(VLM_ARCH).replace(n_layers=VLM_LAYERS),
             GEN_PROMPT),
            ("audio", get_arch(AUDIO_ARCH), GEN_AUDIO_PROMPT),
            ("hybrid", get_arch(HYBRID_ARCH), GEN_PROMPT),
            ("ssm", get_arch(XLSTM_ARCH), GEN_PROMPT)):
        out[fam] = generate_family(cfg, prompt)
    return out


def _cpu_env() -> dict:
    """The environment of a subprocess that must not touch the card."""
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


def dryrun_phase() -> dict:
    """``python -m repro_torch.launch.dryrun`` on each DRYRUN_CELLS cell,
    all started together, each in its own process on the CPU: memory,
    roofline terms, dominant term and trace seconds of each.  A cell that
    is not required is stopped once the phase passes DRYRUN_BUDGET_S."""
    t0 = time.perf_counter()
    procs = []
    for arch, shape, multi, required in DRYRUN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape] + (
                    ["--multipod"] if multi else [])
        procs.append((arch, shape, multi, required, subprocess.Popen(
            argv, cwd=ROOT, env=_cpu_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    try:
        cells = _dryrun_results(procs, t0)
    finally:
        for *_, proc in procs:  # stops any left after a failure
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"cells": cells, "seconds": time.perf_counter() - t0,
            "budget_s": DRYRUN_BUDGET_S}


def _dryrun_results(procs, t0: float) -> list:
    cells = []
    for arch, shape, multi, required, proc in procs:
        left = (DRYRUN_TIMEOUT_S if required else DRYRUN_BUDGET_S) - (
            time.perf_counter() - t0)
        cell = {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi else "16x16"}
        try:
            out, err = proc.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            require(not required, f"dry-run {arch} {shape}: past "
                                  f"{DRYRUN_TIMEOUT_S} s")
            cell["cut"] = f"stopped: the phase passed {DRYRUN_BUDGET_S} s"
            cells.append(cell)
            continue
        require(proc.returncode == 0,
                f"dry-run {arch} {shape} failed: {err[-2000:]}")
        res = json.loads(out)
        rf, mem = res["roofline"], res["memory"]
        require(rf["flops_per_chip"] > 0 and rf["collective_bytes_per_chip"] > 0
                and mem["peak_per_device_bytes"] >= mem["argument_bytes"] > 0,
                f"dry-run {arch} {shape}: empty result {res}")
        cell.update({
            "n_chips": res["n_chips"], "rules_kind": res["rules_kind"],
            "microbatches": res["microbatches"],
            "moment_dtype": res["moment_dtype"], "memory": mem,
            "roofline": {k: rf[k] for k in (
                "compute_s", "memory_s", "collective_s", "dominant",
                "flops_per_chip", "hbm_bytes_per_chip",
                "collective_bytes_per_chip", "useful_fraction",
                "mfu_bound")},
            "collectives": res["collectives"],
            "port_dispatch": res["port_dispatch"], "op_cost": res["op_cost"],
            "trace_s": res["timings"]["trace_s"], "torch": res["torch"]})
        cells.append(cell)
    return cells


_PREDICT = """
import json, sys
import torch
import repro_torch.configs.base as base
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
base.SHAPES["smoke_train"] = base.ShapeConfig("smoke_train", {seq}, {batch},
                                              "train")
res = dryrun.dryrun_cell({arch!r}, "smoke_train", mesh=make_host_mesh(1, 1),
                         moment_dtype=torch.float32, overrides={overrides!r})
print(json.dumps(res))
"""


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_phases() -> None:
    """``dryrun``, then ``dryrun_check``, whose predictions run beside the
    first; no process outlives them."""
    predicts = [start_prediction(arch, layers) for arch, layers in CHECK_ROWS]
    try:
        emit({"dryrun": dryrun_phase()})
        t0 = time.perf_counter()
        rows = [dryrun_check_row(arch, layers, predict) for (arch, layers),
                predict in zip(CHECK_ROWS, predicts)]
        emit({"dryrun_check": {"rows": rows,
                               "seconds": time.perf_counter() - t0}})
    finally:
        for predict in predicts:
            if predict.poll() is None:
                predict.kill()
                predict.communicate()


def start_prediction(arch: str, layers) -> subprocess.Popen:
    """The dry-run of a dryrun_check row's cell (``arch`` cut to
    ``layers``, or whole), started in its own process on the CPU (it runs
    beside the ``dryrun`` phase)."""
    return subprocess.Popen(
        [sys.executable, "-c", _PREDICT.format(
            seq=TRAIN_SEQ, batch=TRAIN_BATCH, arch=arch,
            overrides={"n_layers": layers} if layers else None)],
        cwd=ROOT, env=_cpu_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def dryrun_check_row(arch: str, layers, predict: subprocess.Popen) -> dict:
    """The dry-run's prediction for ``arch`` (cut to ``layers``, or whole)
    at TRAIN_BATCH x TRAIN_SEQ (bf16 parameters, f32 moments) on a (1, 1)
    mesh, made on a fake one-rank group in ``predict``
    (:func:`start_prediction`), against the same step on the card
    on a real one-rank NCCL group: the DTensor step's loss against the
    plain step's; ``FlopCounterMode``'s FLOPs of the plain step (the same
    local ops) against the predicted dot FLOPs; the DTensor step's peak
    ``max_memory_allocated`` against the predicted peak, and its
    parameters' and moments' bytes against the predicted argument bytes
    less the batch and the int32 step; the median of CHECK_STEPS steps
    against the roofline's ``bound_s``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import rules_for
    from repro_torch.sharding.specs import from_local, placements
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    t0 = time.perf_counter()
    out, err = predict.communicate(timeout=DRYRUN_TIMEOUT_S)
    require(predict.returncode == 0, f"prediction failed: {err[-2000:]}")
    pred = json.loads(out.strip().splitlines()[-1])
    wait_s = time.perf_counter() - t0

    cfg = get_arch(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    tokens = torch.from_numpy(TokenPipeline(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch_at(0)).to(
            "cuda", torch.int32)
    batch_bytes = _bytes([tokens])
    # the plain step, its dot FLOPs counted
    model = _init_model(cfg, "cuda", SEED_FLOAT)
    opt = init_opt_state(dict(model.named_parameters()))
    with FlopCounterMode(display=False) as fc:
        plain = make_train_step(model, AdamWConfig())(opt, {"tokens": tokens})
    plain_loss, plain_flops = float(plain["loss"]), fc.get_total_flops()
    del model, opt, plain
    free_card()

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        rules = rules_for(cfg, mesh, "train")
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = _init_model(cfg, "cuda", SEED_FLOAT)
        # from_local keeps each tensor (distribute_tensor copies each
        # shard, which moves the MoE row's peak by 51,200 bytes)
        specs = P.specs(model.param_defs(), rules)
        for name, p in list(model.named_parameters()):
            *path, leaf = name.split(".")
            setattr(model.get_submodule(".".join(path)), leaf,
                    torch.nn.Parameter(from_local(
                        p.detach(), mesh, placements(specs[name], mesh),
                        tuple(p.shape))))
        params = dict(model.named_parameters())
        opt = init_opt_state(params)
        held = _bytes(t.to_local() for t in [*params.values(),
                                             *opt["m"].values(),
                                             *opt["v"].values()])
        batch = {"tokens": from_local(tokens, mesh, placements(
            _batch_spec(cfg, rules), mesh),
            tuple(tokens.shape))}
        step = make_train_step(model, AdamWConfig(), mesh=mesh, rules=rules)
        m = step(opt, batch)
        loss = m["loss"]
        loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_bytes
        times = []
        for _ in range(CHECK_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        del model, opt, params, batch, m
    finally:
        dist.destroy_process_group()
        free_card()
    mem, rf = pred["memory"], pred["roofline"]
    median = statistics.median(times)
    res = {
        "arch": arch, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "mesh": "1x1", "rules_kind": pred["rules_kind"],
        "predict_trace_s": pred["timings"]["trace_s"],
        "predict_wait_s": wait_s, "moment_dtype": pred["moment_dtype"],
        "loss_plain": plain_loss, "loss_dtensor": loss,
        "loss_diff": abs(loss - plain_loss), "loss_tol": CHECK_LOSS_TOL,
        "flops_counted_plain": plain_flops,
        "dot_flops_predicted": pred["op_cost"]["dot_flops"],
        "flops_predicted": pred["op_cost"]["flops"],
        "peak_bytes": peak, "peak_bytes_predicted": mem["peak_per_device_bytes"],
        "peak_ratio": peak / mem["peak_per_device_bytes"],
        "peak_rtol": CHECK_PEAK_RTOL,
        "param_moment_bytes": held,
        "argument_bytes_predicted": mem["argument_bytes"],
        "batch_bytes": batch_bytes,
        "step_s": times, "median_step_s": median,
        "bound_s": max(rf["compute_s"], rf["memory_s"], rf["collective_s"]),
        "roofline": {k: rf[k] for k in ("compute_s", "memory_s",
                                        "collective_s", "dominant")},
        "seconds": time.perf_counter() - t0}
    res["step_over_bound"] = median / res["bound_s"]
    require(res["loss_diff"] <= CHECK_LOSS_TOL,
            f"DTensor loss {loss} against plain {plain_loss}")
    require(plain_flops == res["dot_flops_predicted"],
            f"FlopCounterMode {plain_flops} against predicted dot FLOPs "
            f"{res['dot_flops_predicted']}")
    require(abs(res["peak_ratio"] - 1) <= CHECK_PEAK_RTOL,
            f"peak {peak} against predicted {mem['peak_per_device_bytes']}")
    # the int32 step counter: the reference's argument, a Python int here
    require(held == mem["argument_bytes"] - batch_bytes - 4,
            f"parameter and moment bytes {held} against "
            f"{mem['argument_bytes']} - {batch_bytes} - 4")
    require(median >= res["bound_s"],
            f"a step took {median} s, under its bound {res['bound_s']} s")
    return res


def _batch_spec(cfg, rules) -> tuple:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import batch_specs
    return batch_specs(cfg, ShapeConfig("smoke_train", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), rules)["tokens"]


_ELASTIC_CPU = """
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, port, out):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            rank=rank, world_size={ranks})
    cfg = reduced(get_arch({arch!r})).replace(n_layers=1)
    mesh = make_host_mesh(*{mesh!r})
    rules = rules_for(cfg, mesh, "train", fsdp=False)
    model = P.distribute_params(build_model(cfg, device="cpu"), mesh, rules)
    tr = Trainer(model, AdamWConfig(lr=1e-3),
                 TrainerConfig(steps=3, ckpt_every=2),
                 TokenPipeline(cfg.vocab_size, {seq}, {batch}),
                 ckpt=CheckpointManager(out, async_save=False),
                 mesh=mesh, rules=rules)
    tr.run(tr.init_state(torch.Generator().manual_seed({seed})))
    if rank == 0:
        print(json.dumps({{"losses": [h["loss"] for h in tr.history]}}))
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs={ranks})
"""


def _elastic_trainer(cfg, pipe, opt_cfg, fsdp: bool | None):
    """A Trainer of ``cfg`` on the card: on a fresh (1, 1) mesh under the
    rules with or without FSDP, or with no mesh (``fsdp`` None)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model, rules_for
    from repro_torch.train.loop import Trainer, TrainerConfig
    model = build_model(cfg, device="cuda")
    mesh = rules = None
    if fsdp is not None:
        mesh = make_host_mesh(1, 1)
        rules = rules_for(cfg, mesh, "train", fsdp=fsdp)
        P.distribute_params(model, mesh, rules)
    return Trainer(model, opt_cfg, TrainerConfig(steps=3), pipe, mesh=mesh,
                   rules=rules)


def _elastic_resume(tr, ckpt_dir, *, onto_mesh: bool) -> dict:
    """Restore the newest checkpoint of ``ckpt_dir`` into ``tr`` (with
    ``shardings`` onto its mesh when ``onto_mesh``) and take the next
    step: its loss, and the restore-plus-distribute seconds."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import params as P
    shardings = None
    if onto_mesh:
        tree = P.shardings(tr.model.param_defs(), tr.rules, tr.mesh)
        shardings = {"params": tree, "opt": {"m": tree, "v": tree}}
    t0 = time.perf_counter()
    step, state = CheckpointManager(ckpt_dir).restore(shardings=shardings)
    opt = tr.load_checkpoint(state)
    del state
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    tr.run(opt, start_step=step, steps=1)
    return {"step": step, "restore_s": restore_s,
            "loss": tr.history[-1]["loss"]}


def _gap(row: dict, loss: float) -> dict:
    row["gap"] = abs(row["loss"] - loss)
    row["bit_equal"] = row["loss"] == loss
    require(row["gap"] <= ELASTIC_TOL,
            f"elastic: the resumed loss {row['loss']} against {loss}")
    return row


def elastic_phase(work: Path) -> dict:
    """qwen3-0.6b whole in f32 at TRAIN_BATCH x TRAIN_SEQ on a one-rank
    NCCL group: two AdamW steps of a Trainer on a (1, 1) mesh, an async
    save of its state (each DTensor gathered whole), and the third step
    beside the write (the uninterrupted loss); the checkpoint restored
    onto a fresh (1, 1) mesh under the FSDP rules (``shardings``) and into
    a model with no mesh, each taking the third step.  Then the cross-size
    leg: ELASTIC_CPU_MESH CPU ``gloo`` ranks in a subprocess (started
    first, running beside the card) train the reduced model (1 layer) two
    steps, save, and take the third; the card restores that checkpoint
    onto its (1, 1) mesh and takes the third step.  Every third-step loss
    within ELASTIC_TOL of its uninterrupted one."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig

    t_phase = time.perf_counter()
    ranks = math.prod(ELASTIC_CPU_MESH)
    script, cpu_dir = work / "elastic_cpu.py", work / "elastic_cpu"
    script.write_text(_ELASTIC_CPU.format(
        ranks=ranks, arch=ARCH, mesh=ELASTIC_CPU_MESH, seq=ELASTIC_CPU_SEQ,
        batch=ELASTIC_CPU_BATCH, seed=SEED_FLOAT))
    cpu = subprocess.Popen(
        [sys.executable, str(script), str(_free_port()), str(cpu_dir)],
        cwd=ROOT, env=dict(_cpu_env(), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        cfg = get_arch(ARCH).replace(dtype="float32")
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        out = {"arch": ARCH, "layers": cfg.n_layers, "dtype": "float32",
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "tol": ELASTIC_TOL}
        ck = work / "elastic_ckpt"
        tr = _elastic_trainer(cfg, pipe, AdamWConfig(), False)
        opt = tr.init_state(torch.Generator(device="cuda").manual_seed(
            SEED_FLOAT))
        tr.run(opt, start_step=0, steps=2)
        mgr = CheckpointManager(ck, async_save=True)
        done: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, tr.checkpoint_state(opt, 2)).add_done_callback(
            lambda _: done.append(time.perf_counter()))
        save_s = time.perf_counter() - t0
        tr.run(opt, start_step=2, steps=1)  # beside the write
        t1 = time.perf_counter()
        mgr.wait()
        base = tr.history[-1]["loss"]
        step_dir = ck / f"step_{2:010d}"
        out["save"] = {
            "gather_copy_s": save_s, "commit_s": done[0] - t0,
            "wait_after_step_s": time.perf_counter() - t1,
            "bytes": sum(f.stat().st_size for f in step_dir.iterdir()),
            "rules": "fsdp=False"}
        out["losses"] = [h["loss"] for h in tr.history]
        del tr, opt
        free_card()
        out["mesh_fsdp"] = _gap(_elastic_resume(
            _elastic_trainer(cfg, pipe, AdamWConfig(), True), ck,
            onto_mesh=True), base)
        free_card()
        out["plain"] = _gap(_elastic_resume(
            _elastic_trainer(cfg, pipe, AdamWConfig(), None), ck,
            onto_mesh=False), base)
        shutil.rmtree(ck)
        free_card()

        stdout, err = cpu.communicate(timeout=DRYRUN_TIMEOUT_S)
        require(cpu.returncode == 0, f"elastic CPU ranks failed: "
                                     f"{err[-2000:]}")
        cpu_losses = json.loads(stdout.strip().splitlines()[-1])["losses"]
        small = reduced(get_arch(ARCH)).replace(n_layers=1)
        row = _elastic_resume(_elastic_trainer(
            small, TokenPipeline(small.vocab_size, ELASTIC_CPU_SEQ,
                                 ELASTIC_CPU_BATCH),
            AdamWConfig(lr=1e-3), False), cpu_dir, onto_mesh=True)
        row.update({"cpu_mesh": "x".join(map(str, ELASTIC_CPU_MESH)),
                    "cpu_losses": cpu_losses})
        out["cross_size"] = _gap(row, cpu_losses[2])
        out["seconds"] = time.perf_counter() - t_phase
        return out
    finally:
        dist.destroy_process_group()
        if cpu.poll() is None:
            cpu.kill()
            cpu.communicate()
        free_card()


_CHAOS = """
import json, math, statistics, sys, time
import numpy as np
from repro_torch.query import Database
from repro_torch.serve.chaos import ChaosSchedule, default_schedule
from repro_torch.serve.engine import QueryError, QueryRequest, QueryServer
from repro_torch.serve.shard import ShardedQueryServer
from repro_torch.serve.wire import result_to_wire

db_dir = sys.argv[1]


def mixed(db, n, seed):
    rng = np.random.default_rng(seed)
    ctxs, mids = db.stats["ctx"], db.stats["mid"]
    out = []
    for _ in range(n):
        i = int(rng.integers(len(ctxs)))
        p = rng.random()
        if p < 0.35:
            out.append(QueryRequest(op="stripe", ctx=int(ctxs[i]),
                                    metric=int(mids[i])))
        elif p < 0.55:
            out.append(QueryRequest(op="profile",
                                    pid=int(rng.integers(db.n_profiles))))
        elif p < 0.75:
            out.append(QueryRequest(op="topk", metric=0, inclusive=True,
                                    k=int(rng.integers(3, 10))))
        else:
            out.append(QueryRequest(op="window",
                                    pid=int(rng.integers(db.n_profiles)),
                                    t0=0.0, t1=0.7))
    return out


def enc(results):
    return [json.dumps(result_to_wire(r), sort_keys=True) for r in results]


def load(srv, span_s):
    deadline = time.monotonic() + span_s
    ms, errors, mismatches, n = [], 0, 0, 0
    while time.monotonic() < deadline or n < len(batches):
        b = n % len(batches)
        t0 = time.perf_counter()
        got = srv.serve(batches[b])
        ms.append((time.perf_counter() - t0) * 1e3)
        errors += sum(isinstance(r, QueryError) for r in got)
        mismatches += enc(got) != refs[b]
        n += 1
    ms.sort()
    return {{"batches": n, "errors": errors, "mismatches": mismatches,
             "median_ms": statistics.median(ms),
             "p95_ms": ms[math.ceil(0.95 * len(ms)) - 1], "max_ms": ms[-1]}}


with Database(db_dir) as db:
    batches = [mixed(db, {batch}, 100 + s) for s in range(6)]
    server = QueryServer(db)
    refs = [enc(server.serve(b)) for b in batches]
t0 = time.perf_counter()
with ShardedQueryServer(db_dir, {shards}, replicas={replicas},
                        hedge_ms={hedge}, hang_kill_s={hang},
                        mp_context="spawn") as srv:
    ready_s = time.perf_counter() - t0
    cold = load(srv, 0)  # one pass over every batch: planes decoded cold
    calm = load(srv, {calm})
    events = default_schedule({shards})
    with ChaosSchedule(srv, events) as sched:
        faulted = load(srv, {span})
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and srv.metrics()["respawns"] < 1:
        time.sleep(0.05)
    m = srv.metrics()
    report = sched.report()
print(json.dumps({{"ready_s": ready_s, "cold": cold, "unfaulted": calm,
                  "faulted": faulted,
                  "events": report, "respawns": m["respawns"],
                  "failovers": m["failovers"], "replayed": m["replayed"],
                  "hedges": m["hedges"]}}))
"""


def chaos_phase(db_dir: str) -> dict:
    """``ShardedQueryServer(db, CHAOS_SHARDS, replicas=CHAOS_REPLICAS,
    hedge_ms=CHAOS_HEDGE_MS, hang_kill_s=CHAOS_HANG_KILL_S)`` (workers
    spawned) on the integer database the card wrote, in a subprocess
    with no card visible: one cold pass over the mixed request batches,
    CHAOS_CALM_S of them unfaulted, then CHAOS_SPAN_S under
    ``default_schedule`` (a worker killed, a peer's
    requests dropped, a peer stalled); every reply byte-equal to the
    in-process ``QueryServer``'s, no ``QueryError``, the respawn and
    failover counters positive; each window's batch latencies."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CHAOS.format(
            batch=CHAOS_BATCH, shards=CHAOS_SHARDS, replicas=CHAOS_REPLICAS,
            calm=CHAOS_CALM_S, span=CHAOS_SPAN_S, hedge=CHAOS_HEDGE_MS,
            hang=CHAOS_HANG_KILL_S),
         db_dir],
        cwd=ROOT, env=_cpu_env(), capture_output=True, text=True,
        timeout=300)
    require(proc.returncode == 0, f"chaos failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out.update({"shards": CHAOS_SHARDS, "replicas": CHAOS_REPLICAS,
                "batch": CHAOS_BATCH, "seconds": time.perf_counter() - t0})
    for window in ("cold", "unfaulted", "faulted"):
        w = out[window]
        require(w["errors"] == 0 and w["mismatches"] == 0,
                f"chaos {window}: {w}")
    require([e["kind"] for e in out["events"]] == ["kill", "drop", "stall"],
            f"chaos: the schedule applied {out['events']}")
    require(out["respawns"] > 0 and out["failovers"] > 0,
            f"chaos: respawns {out['respawns']}, failovers "
            f"{out['failovers']}")
    return out


def generate_parity_phase() -> dict:
    """Each family in f32 at its least depth (dense PARITY_LAYERS, the
    rest their FAMILY_PARITY cut), one seed, 2 prompts of
    GEN_PARITY_PROMPT tokens, on the card and on the CPU: ``prefill`` of
    all the tokens, ``prefill`` of all but the last then one
    ``decode_step`` of it, and GEN_PARITY_NEW greedy tokens through
    ``ServeEngine``.  On the card the two ways agree within GEN_TOL_STEP of
    the largest |logit|; the card agrees with the CPU within
    GEN_TOL_DEVICE; the share of greedy tokens equal on both is
    reported."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine
    cases = {"dense": (ARCH, {"n_layers": PARITY_LAYERS}), **FAMILY_PARITY}
    out = {}
    for fam, (arch, cut) in cases.items():
        cfg = get_arch(arch).replace(dtype="float32", **cut)
        tree = parity_tree(cfg)
        prompts, extras = _gen_inputs(cfg, PARITY_BATCH, GEN_PARITY_PROMPT,
                                      SEED_INT)
        max_len = GEN_PARITY_PROMPT + GEN_PARITY_NEW + 1
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model = P.from_reference(build_model(cfg, device=dev), tree)
            batch = {"tokens": torch.from_numpy(prompts).to(dev),
                     **{k: torch.from_numpy(v).to(dev)
                        for k, v in extras.items()}}
            full, _ = model.prefill(batch, max_len=max_len)
            _, cache = model.prefill(dict(batch, tokens=batch["tokens"][:, :-1]),
                                     max_len=max_len)
            step, _ = model.decode_step(
                cache, {"tokens": batch["tokens"][:, -1:]})
            tokens = ServeEngine(model, max_len=max_len).generate(
                prompts, GEN_PARITY_NEW, extras=extras)
            res[dev] = {"full": full.cpu().numpy(), "step": step.cpu().numpy(),
                        "tokens": tokens, "seconds": time.perf_counter() - t0}
            del model, cache, batch
        free_card()
        rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
        card, cpu = res["cuda"], res["cpu"]
        row = {"arch": arch, "cut": cut, "dtype": "float32",
               "batch": PARITY_BATCH, "prompt": GEN_PARITY_PROMPT,
               "seed": SEED_FLOAT,
               "card_step_vs_prefill": rel(card["step"], card["full"]),
               "cpu_step_vs_prefill": rel(cpu["step"], cpu["full"]),
               "card_vs_cpu_prefill": rel(card["full"], cpu["full"]),
               "card_vs_cpu_step": rel(card["step"], cpu["step"]),
               "greedy_tokens_equal_share": float(
                   (card["tokens"] == cpu["tokens"]).mean()),
               "card_s": card["seconds"], "cpu_s": cpu["seconds"]}
        out[fam] = row
        require(np.isfinite(card["full"]).all()
                and row["card_step_vs_prefill"] <= GEN_TOL_STEP
                and row["card_vs_cpu_prefill"] <= GEN_TOL_DEVICE
                and row["card_vs_cpu_step"] <= GEN_TOL_DEVICE,
                f"{fam}: generation disagrees: {row}")
    out["tol_step"], out["tol_device"] = GEN_TOL_STEP, GEN_TOL_DEVICE
    return out


def train_profile_phase(analyze, rprf: Path, work: Path,
                        db: str = "train_db") -> dict:
    """The port's analyze on the card over a train profile."""
    from repro_torch.core.metrics import INCLUSIVE_BIT, MetricRegistry
    from repro_torch.core.pms import PMSReader
    from repro_torch.kernels import _build
    _build.launch_counts.reset()
    summary, wall = run_analyze(analyze, [str(rprf)], work / db,
                                "--compute", "device", "--device", "cuda")
    counts = _build.launch_counts.snapshot()
    with PMSReader(summary["pms"]) as r:
        reg = MetricRegistry.from_json(r.meta["registry"])
        _, mids, _ = r.plane(0).triplets()
        names = sorted({reg.name_of(int(m) & ~INCLUSIVE_BIT)
                        for m in set(mids.tolist())})
    out = {"profile": str(rprf.name), "wall_s": wall,
           "contexts": summary["contexts"], "values": summary["values"],
           "metrics": names, "launches": counts}
    for m in ("host.step_time", "dev.bytes_hbm", "dev.occupancy",
              "dev.flops"):
        require(m in names, f"train profile database lacks {m}: {out}")
    for k in ("blockscan_f32", "blockscan_i64", "histogram"):
        require(counts.get(k, 0) > 0, f"train_profile never launched {k}")
    return out


def resume_phase(train, ckpt: Path, arch: str = ARCH,
                 seq: int = TRAIN_SEQ) -> dict:
    tr, _, stdout, wall = run_train(train, [
        "--arch", arch, "--steps", "1", "--batch", str(TRAIN_BATCH),
        "--seq", str(seq), "--ckpt-dir", str(ckpt), "--resume",
        "--device", "cuda"])
    history = tr.history
    del tr
    free_card()
    out = {"wall_s": wall, "history": history,
           "resumed": f"resumed from step {TRAIN_STEPS}" in stdout}
    require(out["resumed"] and [h["step"] for h in history] == [TRAIN_STEPS]
            and math.isfinite(history[0]["loss"])
            and math.isfinite(history[0]["grad_norm"]),
            f"resume failed: {out}")
    return out


def train_trace_phase(tr, opt, median_step_s: float):
    """Where a full-width step's time goes: the train phase's Trainer takes
    one more step under ``torch.profiler`` (device time by kernel, kernel
    launches); then one more backward pass of its model, whose flattened
    f32 gradient feeds compression."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.loop import value_and_grad
    tr.profiler = tr.ckpt = None  # the train phase's profile is written
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(opt, start_step=TRAIN_STEPS, steps=1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    step_ms = tr.history[-1]["step_time"] * 1e3
    median_ms = median_step_s * 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:10]
    require(busy_ms > 0, "torch.profiler saw no device time")
    out = {"step": TRAIN_STEPS, "step_ms_profiled": step_ms,
           "device_ms": busy_ms,
           "kernel_launches": sum(e.count for e in kernels),
           # device time over the wall time of the same profiled step
           "idle_share": 1.0 - busy_ms / step_ms,
           # the same device time over the train phase's median step
           "median_step_ms_unprofiled": median_ms,
           "idle_share_vs_median_step": 1.0 - busy_ms / median_ms,
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": _dev_us(e) / 1e3} for e in top]}
    tokens = torch.from_numpy(tr.pipeline.batch_at(0)).cuda()
    _, grads = value_and_grad(tr.model, {"tokens": tokens})
    g = torch.cat([t.float().reshape(-1) for t in grads.values()])
    del grads
    return out, g


def compression_phase(g) -> tuple[dict, object]:
    """3 rounds of int8 error feedback on the kernel, each round against
    the plain version on the same input; returns the last input."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import int8_quant as q8
    from repro_torch.train import compression as comp
    residual = torch.zeros_like(g)
    rounds, last = [], None
    _build.launch_counts.reset()
    t0 = time.perf_counter()
    for i in range(COMPRESSION_ROUNDS):
        x = g + residual
        (q, scales), residual = comp.int8_compress(g, residual)
        torch.cuda.synchronize()
        pq, ps, pe = q8.int8_quant_plain(x, q8.DEFAULT_BLOCK_N)
        equal = (torch.equal(q, pq) and torch.equal(_bits(scales), _bits(ps))
                 and torch.equal(_bits(residual), _bits(pe)))
        rounds.append({"round": i, "blocks": scales.numel(),
                       "bit_equal": equal,
                       "residual_max_abs": float(residual.abs().max()),
                       "scale_max": float(scales.max())})
        require(equal, f"int8_quant round {i}: kernel and plain differ")
        del pq, ps, pe
        last = x
    wall = time.perf_counter() - t0
    counts = _build.launch_counts.snapshot()
    out = {"values": g.numel(), "rounds": rounds, "wall_s": wall,
           "launches": counts}
    require(counts.get("int8_quant", 0) == COMPRESSION_ROUNDS,
            f"compression launched int8_quant {counts.get('int8_quant', 0)} "
            f"times, expected {COMPRESSION_ROUNDS}")
    return out, last


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--dryrun-only"]:
        # the dry-run phases alone, for a short call; not the whole smoke
        emit({"gpu": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), "torch": torch.__version__})
        dryrun_phases()
        emit({"partial": "dryrun phases only"})
        return 0
    import numpy as np

    from repro_torch.core.pms import PMSReader
    from repro_torch.data import synth
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import blockscan as bs
    from repro_torch.kernels import int8_quant as q8
    from repro_torch.kernels import scatter_add as sc
    from repro_torch.kernels import segstats as ss
    from repro_torch.launch import analyze, train

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    build_s = _build.build_all()
    emit({"gpu": gpu, "build": {"seconds": build_s,
                                "dir": str(_build.build_dir())},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "opt_einsum": torch.backends.opt_einsum.is_available()})

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke.", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        fpaths, _, n_metrics = synth.generate(
            synth.STANDARD, str(work / "float"), seed=SEED_FLOAT)
        ipaths, _, _ = synth.generate(synth.STANDARD, str(work / "int"),
                                      seed=SEED_INT, integer_values=True)
        gen_s = time.perf_counter() - t0

        # -- 1. the main path, with every launch counter zeroed just before
        rec = Recorder()
        rec.wrap(ss, "segstats", lambda ids, vals, s: "segstats")
        rec.wrap(bs, "blockscan", lambda x: f"blockscan_{bs._SUFFIX[x.dtype]}")
        rec.wrap(ops, "histogram", lambda ids, s: "histogram")
        rec.wrap(ops, "inclusive_from_exclusive", lambda x, end: "inclusive")
        _build.launch_counts.reset()
        dev_sum, dev_wall = run_analyze(analyze, fpaths, work / "dev",
                                        "--compute", "device",
                                        "--device", "cuda")
        counts = _build.launch_counts.snapshot()
        rec.restore()
        path_kernels = ("segstats", "blockscan_f32", "blockscan_i64",
                        "histogram")
        emit({"analyze": {"workload": "STANDARD", "seed": SEED_FLOAT,
                          "generate_s": gen_s, "wall_s": dev_wall,
                          "profiles": dev_sum["profiles"],
                          "contexts": dev_sum["contexts"],
                          "values": dev_sum["values"],
                          "sizes": dev_sum["sizes"],
                          "timings": dev_sum["timings"],
                          "launches": counts}})
        for k in path_kernels:
            require(counts.get(k, 0) > 0, f"main path never launched {k}")
        require(dev_sum["timings"]["device_launches"] == counts,
                "analyze's device_launches disagree with the counters")

        # -- 2. float workload against the numpy path
        cpu_sum, cpu_wall = run_analyze(analyze, fpaths, work / "cpu",
                                        "--compute", "cpu")
        with PMSReader(dev_sum["pms"]) as a, PMSReader(cpu_sum["pms"]) as b:
            agree = plane_agreement(a, b)
        agree["traces_identical"] = sha(dev_sum["traces"]) == sha(
            cpu_sum["traces"])
        emit({"float_parity": {"cpu_wall_s": cpu_wall,
                               "cpu_timings": cpu_sum["timings"], **agree,
                               "atol": ATOL, "rtol": RTOL}})
        require(agree["ok"], f"float planes disagree: {agree}")
        require(agree["traces_identical"], "float traces differ")

        # -- 3. integer workload: byte parity
        idev, idev_wall = run_analyze(analyze, ipaths, work / "idev",
                                      "--compute", "device", "--device",
                                      "cuda")
        icpu, icpu_wall = run_analyze(analyze, ipaths, work / "icpu",
                                      "--compute", "cpu")
        same = {k: sha(idev[k]) == sha(icpu[k])
                for k in ("pms", "cms", "traces")}
        emit({"exact_parity": {"seed": SEED_INT, "device_wall_s": idev_wall,
                               "cpu_wall_s": icpu_wall, **same}})
        require(all(same.values()), f"integer databases differ: {same}")

        # -- the processes executor: kernels in spawned workers
        emit({"analyze_processes": analyze_processes_phase(
            analyze, fpaths, ipaths, work, dev_sum, dev_wall, counts, icpu)})

        # -- the read side on the databases the card wrote: the legacy
        #    chain, query, diagnose and the dense baseline (host only)
        emit({"legacy_parity": legacy_parity_phase(
            fpaths, ipaths, work, {"float": (cpu_sum, cpu_wall),
                                   "int": (icpu, icpu_wall)})})
        dbs = {name: str(Path(summ["pms"]).parent) for name, summ in (
            ("float_card", dev_sum), ("float_numpy", cpu_sum),
            ("int_card", idev), ("int_numpy", icpu))}
        emit({"query": query_phase(analyze, dbs)})
        emit({"diagnose": diagnose_phase(dbs)})
        emit({"dense_baseline": dense_baseline_phase(
            ipaths, dbs["int_card"], work, idev["sizes"], idev["contexts"],
            n_metrics)})

        # -- live ingest on the card (the float twin in process, the integer
        #    twin through the CLI), then the resident query server and the
        #    regression watch on what it published (host only)
        ingest_float = ingest_float_twin(fpaths, work, dev_sum)
        ingest_int, watch = ingest_int_twin(ipaths, work, dbs)
        emit({"ingest": {"workload": "STANDARD",
                         "publish_every": INGEST_PUBLISH_EVERY,
                         "workers": INGEST_WORKERS, "float": ingest_float,
                         "int": ingest_int}})
        emit({"query_server": query_server_phase(work / "ingest_int",
                                                 dbs["int_numpy"])})
        emit({"watch": watch})
        emit({"chaos": chaos_phase(dbs["int_card"])})

        # -- 4. each kernel of the analyze path on its inputs, against its
        #    plain version (emitted with the int8_quant entry, after 9.)
        ids, vals, n_seg = rec.args("segstats")
        (xf,) = rec.args("blockscan_f32")
        (xi,) = rec.args("blockscan_i64")
        hids, n_bins = rec.args("histogram")  # int32, as the path gives them
        h64 = hids.long()
        src = "src/repro_torch/csrc/"
        # inputs off the path, from one generator: the float scatter-add's
        # values (M = 1 and 40), then the skewed ids and their values
        frng = np.random.default_rng(SEED_FLOAT)
        fvals = torch.from_numpy(frng.uniform(
            0.5, 2.0, hids.numel()).astype(np.float32)).cuda()
        f40 = torch.from_numpy(frng.uniform(
            0.5, 2.0, (hids.numel(), 40)).astype(np.float32)).cuda()
        sk_ids = frng.integers(0, n_bins, SKEW_ROWS)
        sk_ids[frng.random(SKEW_ROWS) < SKEW_SHARE] = n_bins // 2
        sk_ids = torch.from_numpy(sk_ids).cuda()
        sk_vals = torch.from_numpy(frng.uniform(
            0.5, 2.0, SKEW_ROWS).astype(np.float32)).cuda()
        entries = [
            kernel_entry(
                "segstats", src + "segstats.cu",
                "src/repro/kernels/segstats.py:75", counts["segstats"],
                lambda: ss.segstats_cuda(ids, vals, n_seg),
                lambda: ss.segstats_plain(ids, vals, n_seg), None,
                8 * ids.numel() + 32 * n_seg, 5 * ids.numel(), False),
            kernel_entry(
                "blockscan_f32", src + "blockscan.cu",
                "src/repro/kernels/blockscan.py:39", counts["blockscan_f32"],
                lambda: bs.blockscan_cuda(xf), lambda: bs.blockscan_plain(xf),
                lambda: torch.cumsum(xf, 0), 2 * 4 * xf.numel(), xf.numel(),
                False),
            kernel_entry(
                "blockscan_i64", src + "blockscan.cu",
                "src/repro/kernels/blockscan.py:39", counts["blockscan_i64"],
                lambda: bs.blockscan_cuda(xi), lambda: bs.blockscan_plain(xi),
                lambda: torch.cumsum(xi, 0), 2 * 8 * xi.numel(), xi.numel(),
                True),
        ]
        # the census histogram on the path's int32 ids, on the same ids as
        # int64 (the shape of earlier runs), on the skewed ids, and on ids
        # that are all out of range (the floor of reading and zeroing)
        for name, hi, on_path in (("histogram", h64, False),
                                  ("histogram_i32", hids, True),
                                  ("histogram_skewed", sk_ids, False),
                                  ("histogram_dropped", hids + n_bins, False)):
            entries.append(kernel_entry(
                name, src + "scatter_add.cu",
                "src/repro/kernels/scatter_add.py:41", counts["histogram"],
                lambda i=hi: sc.histogram_cuda(i, n_bins),
                lambda i=hi: sc.histogram_plain(i, n_bins),
                lambda i=hi: torch.bincount(i, minlength=n_bins)[:n_bins],
                hi.element_size() * hi.numel() + 8 * n_bins, hi.numel(),
                True, on_path=on_path))
            require(len(entries[-1]["device_kernels"]) == 1,
                    f"{name}: one call ran {entries[-1]['device_kernels']}, "
                    f"not one kernel")
        entries[0]["nan_case"] = segstats_nan_case(ss, ids, vals, n_seg)
        # the float scatter-add is off the path: held at the census shape,
        # at 40 columns, and on a skewed input, each against its plain
        # version and index_add_
        for name, sids, sv in (("scatter_add", h64, fvals),
                               ("scatter_add_m40", h64, f40),
                               ("scatter_add_skewed", sk_ids, sk_vals)):
            m = 1 if sv.dim() == 1 else sv.shape[1]
            entries.append(kernel_entry(
                name, src + "scatter_add.cu",
                "src/repro/kernels/scatter_add.py:41",
                counts.get("scatter_add", 0),
                lambda i=sids, v=sv: sc.scatter_add_cuda(i, v, n_bins),
                lambda i=sids, v=sv: sc.scatter_add_plain(i, v, n_bins),
                lambda i=sids, v=sv: torch.zeros(
                    (n_bins,) + tuple(v.shape[1:]),
                    device=v.device).index_add_(0, i, v),
                sids.element_size() * sids.numel() + 4 * sv.numel()
                + 4 * n_bins * m,
                sv.numel(), False, on_path=False))

        # -- determinism: a column alone vs inside the batch
        xb, end = rec.args("inclusive")
        j = xb.shape[1] // 2
        alone = ops.inclusive_from_exclusive(xb[:, j:j + 1].contiguous(), end)
        batch = ops.inclusive_from_exclusive(xb, end)[:, j:j + 1]
        scan_alone = bs.blockscan_cuda(xb[:, j:j + 1].contiguous())
        scan_batch = bs.blockscan_cuda(xb)[:, j:j + 1]
        det = {"rows": xb.shape[0], "batch_columns": xb.shape[1], "column": j,
               "inclusive_equal": bool(torch.equal(alone, batch)),
               "scan_equal": bool(torch.equal(scan_alone, scan_batch)),
               "repeat_launches": 10,
               "blockscan_f32_repeats_equal": repeated_launches(
                   lambda: bs.blockscan_cuda(xf)),
               "blockscan_i64_repeats_equal": repeated_launches(
                   lambda: bs.blockscan_cuda(xi)),
               "segstats_repeats_equal": repeated_launches(
                   lambda: ss.segstats_cuda(ids, vals, n_seg)),
               "scatter_add_repeats_equal": repeated_launches(
                   lambda: sc.scatter_add_cuda(h64, fvals, n_bins)),
               "histogram_repeats_equal": repeated_launches(
                   lambda: sc.histogram_cuda(hids, n_bins)),
               "histogram_after_other_size_equal": histogram_after_other_size(
                   sc, hids, n_bins),
               "segstats_alone_equal": segstats_alone_among_others(
                   ss, ids, vals, n_seg),
               "scatter_add_alone_equal": scatter_add_alone_among_others(
                   sc, h64, fvals, n_bins)}
        emit({"determinism": det})
        require(det["inclusive_equal"] and det["scan_equal"],
                f"a column's result depends on its batch: {det}")
        require(all(v for k, v in det.items() if k.endswith("_equal")),
                f"repeated launches, or a segment alone and among others, "
                f"differ: {det}")

        # -- the combine on repeated keys at full size, against numpy
        emit({"combine_repeats": combine_repeats_phase(
            ipaths, dev_sum["contexts"])})

        # -- 5.-9. the training path, then compression on its gradient
        out, rprf, ckpt, tr, opt = train_phase(train, work)
        emit({"train": out})
        trace, g = train_trace_phase(tr, opt,
                                     out["median_step_s_after_first"])
        del tr, opt
        free_card()
        emit({"train_trace": trace})
        emit({"train_parity": train_parity_phase()})
        emit({"train_profile": train_profile_phase(analyze, rprf, work)})
        emit({"resume": resume_phase(train, ckpt)})
        out, x = compression_phase(g)
        del g
        emit({"compression": out})
        nb = -(-x.numel() // q8.DEFAULT_BLOCK_N)
        entries.append(kernel_entry(
            "int8_quant", src + "int8_quant.cu",
            "src/repro/kernels/int8_quant.py:31",
            out["launches"]["int8_quant"],
            lambda: q8.int8_quant_cuda(x, q8.DEFAULT_BLOCK_N),
            lambda: q8.int8_quant_plain(x, q8.DEFAULT_BLOCK_N), None,
            9 * x.numel() + 4 * nb, 8 * x.numel(), True))
        del x
        free_card()

        # -- the MoE, VLM and audio families at full width (depth cut)
        from repro_torch.configs.base import get_arch
        moe_out, moe_rprf, moe_ckpt = train_moe_phase(train, work)
        moe_out["resume"] = resume_phase(train, moe_ckpt, MOE_CUT)
        shutil.rmtree(moe_ckpt)  # 19 GB of disk
        emit({"train_moe": moe_out})
        emit({"train_moe_profile": train_profile_phase(analyze, moe_rprf,
                                                       work, "moe_db")})
        emit({"train_vlm": train_family_phase(
            get_arch(VLM_ARCH).replace(n_layers=VLM_LAYERS), FAMILY_STEPS)})
        emit({"train_audio": train_family_phase(get_arch(AUDIO_ARCH),
                                                FAMILY_STEPS)})
        emit({"family_parity": family_parity_phase()})
        emit({"moe_determinism": moe_determinism_phase()})

        # -- the SSM and hybrid families at full width, the published chunk
        hyb_out, hyb_rprf, hyb_ckpt = train_hybrid_phase(train, work)
        hyb_out["resume"] = resume_phase(train, hyb_ckpt, HYBRID_CUT,
                                         SSM_TRAIN_SEQ)
        # the resumed step is the traced step again, from the checkpoint
        hyb_out["resume"]["same_loss_as_traced_step"] = (
            hyb_out["resume"]["history"][0]["loss"] == hyb_out["trace"]["loss"])
        shutil.rmtree(hyb_ckpt)  # ~8 GB of disk
        emit({"train_hybrid": hyb_out})
        emit({"train_hybrid_profile": train_profile_phase(
            analyze, hyb_rprf, work, "hybrid_db")})
        emit({"train_xlstm": train_family_phase(
            get_arch(XLSTM_ARCH).replace(n_layers=XLSTM_TRAIN_LAYERS),
            FAMILY_STEPS, SSM_TRAIN_SEQ)})
        emit({"ssm_scan": ssm_scan_phase()})

        # -- generation: every family on the card, then card vs CPU
        emit({"generate": generate_phase()})
        emit({"generate_parity": generate_parity_phase()})

        # -- the dry-run on fake H100 meshes, then its prediction on the card
        dryrun_phases()
        # -- a checkpoint of DTensor state restored across meshes
        emit({"elastic": elastic_phase(work)})
        for e in entries:  # the launches of the ingest phase's float twin
            key = next(k for k in (*INGEST_KERNELS, "scatter_add",
                                   "int8_quant") if e["name"].startswith(k))
            e["ingest_launches"] = ingest_float["launches"].get(key, 0)
        emit({"kernels": entries})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase_seconds": dict(_PHASE_S)})

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
