"""Baseline fleets: per-call-path noise bands learned from known-good runs.

A regression verdict against a *single* baseline run can't distinguish a
slowdown from run-to-run weather.  A fleet of baselines gives each call
path a distribution — mean and spread across runs — and the band's upper
edge scales with that observed variance: ``mean + max(z*std,
rel_margin*mean, abs_margin)``.  A fleet of byte-identical runs has
std 0 everywhere, so the band collapses to the relative margin and any
real bump fires; a noisy path earns a wide band and stops crying wolf.

Paths absent from some baseline runs contribute 0 for those runs — the
band then straddles "sometimes present", which is the honest prior.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

from repro_torch.query.database import PMS_NAME, Database
from repro_torch.query.diff import metric_stats_by_path


@dataclass(frozen=True)
class PathBand:
    """One call path's cost distribution over the baseline fleet."""

    path: str
    mean: float   # mean cost across runs (absent runs count as 0)
    std: float    # population std across runs
    n: int        # fleet size

    def hi(self, *, z: float = 3.0, rel_margin: float = 0.05,
           abs_margin: float = 0.0) -> float:
        """Upper band edge: widest of the statistical and floor margins."""
        return self.mean + max(z * self.std, rel_margin * self.mean,
                               abs_margin)


class BaselineFleet:
    """A set of baseline databases and the bands computed over them.

    Construct from already-open :class:`Database` handles, or with
    :meth:`from_dir` which opens every database directory found under a
    root (sorted by name, so band arithmetic is order-deterministic).
    Bands are memoized per ``(metric, stat, inclusive)``.
    """

    def __init__(self, dbs: list[Database], *, owned: bool = False):
        if not dbs:
            raise ValueError("BaselineFleet needs at least one baseline run")
        self._dbs = list(dbs)
        self._owned = owned
        self._bands: dict[tuple, dict[str, PathBand]] = {}

    @classmethod
    def from_dir(cls, root, *, cache_bytes: int = 32 << 20
                 ) -> "BaselineFleet":
        """Open every db under ``root`` (or ``root`` itself if it is one).

        A directory counts as a run if it contains ``db.pms`` — so a plain
        collection of analyze outputs and a snapshot root's epoch dirs
        both work unmodified.
        """
        root = str(root)
        dirs: list[str] = []
        if os.path.exists(os.path.join(root, PMS_NAME)):
            dirs.append(root)
        else:
            for name in sorted(os.listdir(root)):
                cand = os.path.join(root, name)
                if os.path.isdir(cand) and \
                        os.path.exists(os.path.join(cand, PMS_NAME)):
                    dirs.append(cand)
        if not dirs:
            raise FileNotFoundError(
                f"no databases (dirs containing {PMS_NAME}) under {root}")
        return cls([Database(d, cache_bytes=cache_bytes) for d in dirs],
                   owned=True)

    @property
    def n_runs(self) -> int:
        return len(self._dbs)

    def bands(self, metric, *, stat: str = "sum", inclusive: bool = True
              ) -> dict[str, PathBand]:
        key = (str(metric), stat, bool(inclusive))
        hit = self._bands.get(key)
        if hit is not None:
            return hit
        n = len(self._dbs)
        acc: dict[str, list[float]] = {}
        for db in self._dbs:
            for path, (_ctx, v, _s) in metric_stats_by_path(
                    db, metric, stat, inclusive).items():
                acc.setdefault(path, []).append(v)
        out: dict[str, PathBand] = {}
        for path, vals in acc.items():
            # absent runs contribute 0 so mean/std reflect the whole fleet
            s = sum(vals)
            mean = s / n
            var = sum((v - mean) ** 2 for v in vals) + \
                (n - len(vals)) * mean ** 2
            std = math.sqrt(max(var / n, 0.0))
            out[path] = PathBand(path=path, mean=mean, std=std, n=n)
        self._bands[key] = out
        return out

    def close(self) -> None:
        if self._owned:
            for db in self._dbs:
                db.close()
        self._dbs = []
        self._bands.clear()

    def __enter__(self) -> "BaselineFleet":
        return self

    def __exit__(self, *a) -> None:
        self.close()
