"""Core: bit-width analysis for stage DAGs (port of `repro.core`).

- `fixedpoint`: (alpha, beta) fixed-point types and the array ops on
  torch tensors
- `interval`, `affine`: abstract domains (paper §III-C)
- `absval`: the pluggable-domain framework (paper §IV-C)
- `intersect`: the interval ∩ affine reduced product
- `graph`: stage-DAG IR with expanded expression trees
- `range_analysis`: alpha-analysis, Algorithm 1 (paper §IV-B)
- `profile`: profile-driven alpha^max / alpha^avg (paper §V-A), on the
  device the runner's tensors are on
- `policy`: container legalization
"""
from repro_torch.core.affine import AffineForm
from repro_torch.core.fixedpoint import FixedPointType, alpha_for_range
from repro_torch.core.graph import Pipeline, Stage, stencil_expr
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange, alpha_table, analyze

__all__ = [
    "FixedPointType", "alpha_for_range", "Interval", "AffineForm",
    "Pipeline", "Stage", "stencil_expr", "analyze", "alpha_table", "StageRange",
]
