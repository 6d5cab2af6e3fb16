"""Range (alpha) analysis results — paper §IV-B, Algorithm 1.

The port's own copy of `repro.core.range_analysis.StageRange`, the
per-stage 3-tuple a `BitwidthPlan` column holds.  The analyses that
compute it are not ported yet: the port reads designs as data
(`pipelines.types`, `analysis.plan.BitwidthPlan.from_json`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.fixedpoint import alpha_for_range
from repro_torch.core.interval import Interval


@dataclasses.dataclass
class StageRange:
    """Algorithm 1's (z_lo, z_hi, alpha) bit-width 3-tuple for one stage."""
    range: Interval
    alpha: int
    signed: bool

    @staticmethod
    def from_interval(iv: Interval) -> "StageRange":
        return StageRange(range=iv, alpha=alpha_for_range(iv.lo, iv.hi),
                          signed=iv.lo < 0)
