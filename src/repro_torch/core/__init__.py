"""Core IR and fixed-point types (port of `repro.core`'s JAX-free parts)."""
from repro_torch.core.fixedpoint import FixedPointType, alpha_for_range
from repro_torch.core.graph import Pipeline, Stage, stencil_expr
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange

__all__ = ["FixedPointType", "alpha_for_range", "Interval", "Pipeline",
           "Stage", "StageRange", "stencil_expr"]
