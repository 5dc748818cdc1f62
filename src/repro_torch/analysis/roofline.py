"""Roofline terms of a dry-run cell, for an H100 cluster.

Port of :mod:`repro.analysis.roofline`.  Per (arch x shape x mesh)::

    compute term    = op FLOPs / peak FLOP/s per card             [s]
    memory term     = op bytes / HBM bytes/s per card             [s]
    collective term = collective operand bytes / link bytes/s     [s]

The counts are per device (:mod:`repro_torch.analysis.op_cost` counts
rank 0's local ops), so each term divides by one card's rate.

Hardware constants, modelled and not measured: an NVIDIA H100 SXM5 80 GB
at its 700 W limit (NVIDIA's data sheet): 989e12 FLOP/s dense bf16 on the
tensor cores, 3.35e12 B/s of HBM3, 80e9 bytes of it.  Each 16-wide mesh
axis spans two 8-card nodes, so a collective runs at the one 400 Gb/s NIC
each card has in a DGX H100 (50e9 B/s), not at NVLink's 450 GB/s each way
inside a node.
"""
from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12       # bf16 dense per card
HBM_BW = 3.35e12          # bytes/s per card
LINK_BW = 50e9            # bytes/s per card: one 400 Gb/s NIC
HBM_CAPACITY = 80e9       # bytes per card


@dataclass
class CollectiveStats:
    """Collective operand bytes by kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``)."""
    bytes_by_kind: dict = field(default_factory=dict)

    @property
    def total(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    n_chips: int = 1
    coll_by_kind: dict = field(default_factory=dict)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (op FLOPs x cards): how much counted compute is
        the model's."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU upper bound: model flops / (cards x peak x
        bound time)."""
        denom = self.n_chips * PEAK_FLOPS * self.bound_s
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops, "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "n_chips": self.n_chips,
            "useful_fraction": self.useful_fraction,
            "mfu_bound": self.mfu_bound,
        }


def analyze(cost, *, n_chips: int, model_flops: float = 0.0) -> Roofline:
    """Roofline terms of an :class:`~repro_torch.analysis.op_cost.Cost`
    counted on one device."""
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.coll_bytes / LINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return Roofline(cost.flops, cost.bytes, cost.coll_bytes, compute_s,
                    memory_s, collective_s, dominant, model_flops, n_chips,
                    dict(cost.coll_by_kind))
