"""The training head's cross-entropy on the tensor cores: :func:`head_xent`.

The mean cross-entropy of ``x (B, S, D) @ w (D, V)`` against ``labels``
(B, S) under a ``mask``, walked in sequence chunks so that logits exist
only as one chunk's (B * c, V) f32 tile, as
``models.layers.chunked_softmax_xent`` walks them.  Replaces no TPU kernel:
the reference leaves its loss head to XLA, which multiplies the bf16
operands with ``preferred_element_type=f32``.

* Forward, each chunk: the logits by one bf16 GEMM with an f32 output
  (``torch.mm(..., out_dtype=torch.float32)``; the head is read in bf16 and
  never copied to f32), then one pass (``xent_rows``) that gives each
  row's log-sum-exp and gold logit.  Only the log-sum-exps are kept.
* Backward, each chunk: the logits recomputed by the same GEMM, then one
  pass (``xent_split``) that forms the logit gradient
  ``(softmax - onehot) * mask / count`` in f32 and writes it as three bf16
  terms whose sum is that f32 value (:func:`split3`); ``dx`` and ``dw`` are
  bf16 GEMMs over the three terms with f32 accumulation, ``dw`` one GEMM
  over the terms stacked along the tokens and summed into an f32
  accumulator that is cast to the head's dtype once.

A product of two bf16 values is exact in f32, so these GEMMs form the same
products as f32 GEMMs of the upcast operands; only the order of the f32
sums differs.  The head's least time on an H100 is its three products,
3 x 2·N·D·V FLOP (N tokens) at 989e12; the recomputed logits and the three
terms of the gradient (8 x 2·N·D·V in all) and the two passes' bytes
(``csrc/xent.cu``) are this design's own cost.

On CUDA tensors the two passes are the hand-written kernels of
``csrc/xent.cu`` (each launch counted in ``_build.launch_counts`` as
``xent_rows`` and ``xent_split``); on CPU tensors their plain versions run
and the products upcast their operands, so :func:`head_xent_plain` is the
same algorithm in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

ROWS, SPLIT = "xent_rows", "xent_split"


# ---------------------------------------------------------------------------
# the two passes
# ---------------------------------------------------------------------------

def _check_rows(logits, labels, *per_row) -> None:
    _build.expect(logits, "xent logits", (torch.float32,), (2,))
    _build.expect(labels, "xent labels", (torch.int64,), (1,))
    for t in per_row:
        _build.expect(t, "xent row terms", (torch.float32,), (1,))
    if any(t.shape[0] != logits.shape[0] for t in (labels, *per_row)):
        raise ValueError(f"xent: {logits.shape[0]} rows of logits, per-row "
                         f"terms of {[t.shape[0] for t in (labels, *per_row)]}")
    if logits.shape[0] >= 2 ** 31:
        raise ValueError(f"xent: {logits.shape[0]} rows exceed the kernel's "
                         f"32-bit grid")


def xent_rows_cuda(logits: torch.Tensor, labels: torch.Tensor):
    """The CUDA pass: ``(logz, gold)``, each (rows,) f32, of ``logits``
    (rows, V) f32 and ``labels`` (rows,) int64, contiguous on a card."""
    if not _build.on_cuda(logits, labels):
        raise ValueError("xent_rows_cuda takes CUDA tensors")
    _check_rows(logits, labels)
    rows, V = logits.shape
    logz = torch.empty(rows, dtype=torch.float32, device=logits.device)
    gold = torch.empty_like(logz)
    fn = _build.function("xent", "xent_rows_f32",
                         (_build.PTR, _build.I64, _build.I64, _build.PTR,
                          _build.PTR, _build.PTR, _build.PTR))
    with torch.cuda.device(logits.device):
        status = fn(logits.data_ptr(), rows, V, labels.data_ptr(),
                    logz.data_ptr(), gold.data_ptr(), _build.stream_of(logits))
    _build.check(status, ROWS)
    if rows:
        _build.launch_counts.add(ROWS)
    return logz, gold


def xent_rows_plain(logits: torch.Tensor, labels: torch.Tensor):
    """The same pass in plain PyTorch: ``logsumexp`` and the gold logit,
    NaN for a label outside ``[0, V)``."""
    V = logits.shape[-1]
    ok = (labels >= 0) & (labels < V)
    gold = torch.gather(logits, -1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1),
            torch.where(ok, gold, torch.full_like(gold, float("nan"))))


def xent_split_cuda(logits, labels, logz, scale) -> torch.Tensor:
    """The CUDA pass: the three bf16 planes (3, rows, V) of the logit
    gradient ``scale * (exp(logits - logz) - onehot(labels))``."""
    if not _build.on_cuda(logits, labels, logz, scale):
        raise ValueError("xent_split_cuda takes CUDA tensors")
    _check_rows(logits, labels, logz, scale)
    rows, V = logits.shape
    out = torch.empty((3, rows, V), dtype=torch.bfloat16,
                      device=logits.device)
    fn = _build.function("xent", "xent_split_f32",
                         (_build.PTR, _build.I64, _build.I64, _build.PTR,
                          _build.PTR, _build.PTR, _build.PTR, _build.PTR))
    with torch.cuda.device(logits.device):
        status = fn(logits.data_ptr(), rows, V, labels.data_ptr(),
                    logz.data_ptr(), scale.data_ptr(), out.data_ptr(),
                    _build.stream_of(logits))
    _build.check(status, SPLIT)
    if rows:
        _build.launch_counts.add(SPLIT)
    return out


def xent_split_plain(logits, labels, logz, scale) -> torch.Tensor:
    """The same pass in plain PyTorch."""
    V = logits.shape[-1]
    q = torch.exp(logits - logz[:, None])
    ok = (labels >= 0) & (labels < V)
    rows = torch.arange(logits.shape[0], device=logits.device)[ok]
    q[rows, labels[ok]] -= 1.0
    return split3(q * scale[:, None])


def split3(d: torch.Tensor) -> torch.Tensor:
    """``stack(hi, mid, lo)``, three bf16 tensors of ``d``'s shape whose
    f32 sum ``(hi + mid) + lo`` is ``d`` (f32): ``hi = bf16(d)``,
    ``mid = bf16(d - hi)``, ``lo = bf16(d - hi - mid)``.  Each remainder
    is exact in f32 and holds at most 16, then 8 significant bits, so the
    sum is exact wherever ``|d| >= 2**-110`` (or ``d`` is 0) and ``hi`` does
    not overflow; below 2**-110 it is within 2**-134, bf16's subnormal
    spacing."""
    hi = d.to(torch.bfloat16)
    r = d - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack((hi, mid, (r - mid.float()).to(torch.bfloat16)))


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

# The longest sum one tensor-core GEMM forms here.  A bf16 GEMM's f32
# accumulation drifts by an error that grows linearly with the length of
# the sum, as an accumulator that cuts off the bits below its last place
# would: dx's sum over 151,936 words (each row's gold term large among
# small ones) read 2.3e-4 of its largest value off an f64 product in one
# GEMM, 1.5e-5 in pieces of 8,192 and 7.9e-6 in pieces of 4,096, against
# 1.8e-5 for f32 GEMMs of the upcast operands (H100, B = 2, S = 1,024,
# D = 2,048).  Longer products run in pieces of K_PIECE, added in f32.
# (Not by ``addmm`` into the output: ``torch.utils.flop_counter`` fails on
# its ``out_dtype`` overload.)
K_PIECE = 8192


class _Card:
    """The passes and products of CUDA tensors: the kernels, and bf16 GEMMs
    with f32 accumulation over at most ``K_PIECE`` products; ``mm`` adds
    its product into ``out`` where one is given."""
    rows = staticmethod(xent_rows_cuda)
    split = staticmethod(xent_split_cuda)

    @staticmethod
    def mm(a, b, out=None):
        for k in range(0, a.shape[1], K_PIECE):
            p = torch.mm(a[:, k:k + K_PIECE], b[k:k + K_PIECE],
                         out_dtype=torch.float32)
            out = p if out is None else out.add_(p)
        return out


class _Plain:
    """The plain versions: the passes in PyTorch, products of the operands
    upcast to f32."""
    rows = staticmethod(xent_rows_plain)
    split = staticmethod(xent_split_plain)

    @staticmethod
    def mm(a, b, out=None):
        p = a.float() @ b.float()
        return p if out is None else out.add_(p)


def _by_chunk(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S) -> (n, B * S // n): row ``i`` holds chunk ``i`` of every
    sequence, in the order of ``x[:, chunk].reshape(-1, D)``'s rows."""
    B, S = t.shape
    return t.reshape(B, n, S // n).transpose(0, 1).reshape(n, -1)


def _forward(x, w, labs, masks, c: int, ops):
    """``(loss, logz)``: the mean masked cross-entropy and each row's
    log-sum-exp (n, B * c), chunk by chunk."""
    D = x.shape[2]
    logz = torch.empty(masks.shape, dtype=torch.float32, device=x.device)
    gold = torch.empty_like(logz)
    for i in range(masks.shape[0]):
        logits = ops.mm(x[:, i * c:(i + 1) * c].reshape(-1, D), w)
        logz[i], gold[i] = ops.rows(logits, labs[i])
        del logits
    loss = ((logz - gold) * masks).sum() / torch.clamp_min(masks.sum(), 1.0)
    return loss, logz


def _scale(masks, g):
    """Each row's factor of the logit gradient: ``g * mask / count``."""
    return masks * (g / torch.clamp_min(masks.sum(), 1.0))


def _backward(x, w, labs, logz, scale, c: int, ops, want_dx=True,
              want_dw=True):
    """``(dx, dw)`` in f32 (None where not wanted) of the logit gradient
    ``scale * (softmax - onehot)``, each chunk's logits recomputed."""
    B, S, D = x.shape
    dx = (torch.empty((B, S, D), dtype=torch.float32, device=x.device)
          if want_dx else None)
    dw = None
    for i in range(labs.shape[0]):
        xs = x[:, i * c:(i + 1) * c].reshape(-1, D)
        logits = ops.mm(xs, w)
        g3 = ops.split(logits, labs[i], logz[i], scale[i])
        del logits
        g3 = g3.view(-1, w.shape[1])  # (hi; mid; lo) along the tokens
        if want_dx:
            p = ops.mm(g3, w.t()).view(3, B, c, D)
            dx[:, i * c:(i + 1) * c] = (p[2] + p[1]) + p[0]
        if want_dw:
            dw = ops.mm(xs.repeat(3, 1).t(), g3, out=dw)
    return dx, dw


class _HeadXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labs, masks, c: int, ops):
        loss, logz = _forward(x, w, labs, masks, c, ops)
        ctx.save_for_backward(x, w, labs, masks, logz)
        ctx.c, ctx.ops = c, ops
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labs, masks, logz = ctx.saved_tensors
        scale = _scale(masks, g)
        dx, dw = _backward(x, w, labs, logz, scale, ctx.c, ctx.ops,
                           *ctx.needs_input_grad[:2])
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None, None,
                None)


def head_xent(x, w, labels, mask=None, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of ``x (B, S, D) @ w (D, V)`` against ``labels``
    (B, S) under ``mask`` (B, S) (all ones if None), in chunks of
    ``chunk`` positions.  On a card ``x`` and ``w`` are bf16 and the passes
    are the CUDA kernels; CPU tensors take :func:`head_xent_plain`."""
    return _HeadXent.apply(x, w, *_inputs(x, labels, mask, chunk),
                           _ops(x, w, labels))


def head_xent_plain(x, w, labels, mask=None, chunk: int = 512
                    ) -> torch.Tensor:
    """:func:`head_xent` with the passes' plain versions and the products
    of upcast operands, on any device."""
    return _HeadXent.apply(x, w, *_inputs(x, labels, mask, chunk), _Plain)


def head_xent_grads(x, w, labels, mask=None, chunk: int = 512, plain=False):
    """``(loss, dx, dw)`` of :func:`head_xent` (or, ``plain``, of
    :func:`head_xent_plain`), the gradients in f32 as the products leave
    them, before the cast to ``x``'s and ``w``'s dtypes."""
    labs, masks, c = _inputs(x, labels, mask, chunk)
    ops = _Plain if plain else _ops(x, w, labels)
    with torch.no_grad():
        loss, logz = _forward(x, w, labs, masks, c, ops)
        scale = _scale(masks, torch.ones((), device=x.device))
        return (loss, *_backward(x, w, labs, logz, scale, c, ops))


def _ops(x, w, labels):
    if not _build.on_cuda(x, w, labels):
        return _Plain
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"head_xent on a card takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    return _Card


def _inputs(x, labels, mask, chunk: int):
    """The labels and mask by chunk (:func:`_by_chunk`), and the chunk."""
    S = x.shape[1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of chunk {c}")
    if mask is None:
        mask = torch.ones(labels.shape, device=x.device)
    return (_by_chunk(labels.long(), S // c), _by_chunk(mask.float(), S // c),
            c)
