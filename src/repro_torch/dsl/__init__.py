"""DSL front end and the port's fixed-point executor."""
from repro_torch.dsl.builder import (PipelineBuilder, absv, ite, maxv, minv,
                                     shifted, sqrtv)

__all__ = ["PipelineBuilder", "absv", "ite", "maxv", "minv", "shifted",
           "sqrtv"]
