"""What the benchmark hands to both sides: token batches and weights, each
a pure function of the seed.

Tokens are drawn with numpy's PCG64 from ``(seed, step)``, so that a
batch does not depend on which batches came before it.  Weights are drawn
on the device with a ``torch.Generator``, one ``randn`` call for each
group of leaves (a layer, the shared block, the embedding and head), in
the configuration's dtype: a group can be drawn again alone, from the same
seed, to the same bits.  Each leaf is named, shaped and initialised as
its parameter spec says (``reference.<family>.param_specs``), in the
port's parameter names.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class TokenBatches:
    """The training feed: ``batch_at(step)`` is a (batch, seq) int32 array
    of token ids drawn uniformly from ``[0, vocab)``, every row its own."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, step])
        return rng.integers(0, self.vocab, (self.batch, self.seq),
                            dtype=np.int32)


def group_of(name: str) -> str:
    """The draw group of a leaf: ``layers.<i>`` for a layer's leaves, else
    the first part of its name (``shared_attn``, ``embed``, ...) and the
    embedding, final norm and head together as ``top``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ".".join(parts[:2])
    if parts[0] in ("embed", "final_norm", "lm_head"):
        return "top"
    return parts[0]


def _group_seed(seed: int, group: str) -> int:
    h = 1469598103934665603
    for b in f"{seed}/{group}".encode():
        h = ((h ^ b) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def draw_group(specs, group: str, seed: int, device, dtype) -> dict:
    """``{name: tensor}`` of one group's leaves: one ``randn`` of every
    normal leaf's elements together, cut and scaled leaf by leaf; zeros
    and ones filled."""
    leaves = [s for s in specs if group_of(s[0]) == group]
    normal = [s for s in leaves if s[2] in ("normal", "embed")]
    total = sum(math.prod(s[1]) for s in normal)
    gen = torch.Generator(device=device).manual_seed(_group_seed(seed, group))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, init in leaves:
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            out[name] = fill(shape, device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        scale = 0.02 if init == "embed" else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[0])
        out[name] = flat[off:off + n].view(shape).mul_(scale)
        off += n
    return out


def groups(specs) -> list[str]:
    """The draw groups of ``specs`` in first-seen order."""
    seen: dict[str, None] = {}
    for s in specs:
        seen.setdefault(group_of(s[0]), None)
    return list(seen)


@torch.no_grad()
def load_into(model, specs, seed: int) -> None:
    """Draw every group on the model's device in its dtype and copy it into
    the model's parameters, which must be exactly the specs' names and
    shapes."""
    params = dict(model.named_parameters())
    want = {s[0]: tuple(s[1]) for s in specs}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        raise ValueError(f"parameter specs and model differ: specs only "
                         f"{missing}, model only {extra}")
    p0 = next(iter(params.values()))
    for g in groups(specs):
        for name, t in draw_group(specs, g, seed, p0.device,
                                  p0.dtype).items():
            params[name].copy_(t)
