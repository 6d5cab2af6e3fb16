"""Harris Corner Detection — paper Figure 3 / Table I.

The port's own copy of `repro.pipelines.hcd` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

Stage structure and stencils exactly as Table I:

    Ix, Iy : 1/12-scaled Sobel derivatives of the 8-bit input
    Ixx=Ix^2, Ixy=Ix*Iy, Iyy=Iy^2 (the compiler maps x*x -> x**2, §IV-B)
    Sxx/Sxy/Syy : 3x3 box sums
    det = Sxx*Syy - Sxy^2 ; trace = Sxx + Syy ; harris = det - 0.04*trace^2

Static interval analysis over this DAG must reproduce paper Table II
([0,255] -> [-85,85] -> ... -> alpha 34 at `harris`), asserted in tests.
"""
from __future__ import annotations

from repro_torch.core.graph import Pipeline, Pow
from repro_torch.dsl.builder import PipelineBuilder

SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
SOBEL_Y = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
BOX3 = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]

HARRIS_K = 0.04


def build() -> Pipeline:
    p = PipelineBuilder("hcd")
    img = p.image("img", 0, 255)
    Ix = p.stencil("Ix", img, SOBEL_X, scale=1.0 / 12)
    Iy = p.stencil("Iy", img, SOBEL_Y, scale=1.0 / 12)
    Ixx = p.define("Ixx", Pow(Ix, 2))
    Ixy = p.define("Ixy", Ix * Iy)
    Iyy = p.define("Iyy", Pow(Iy, 2))
    Sxx = p.stencil("Sxx", Ixx, BOX3)
    Sxy = p.stencil("Sxy", Ixy, BOX3)
    Syy = p.stencil("Syy", Iyy, BOX3)
    det = p.define("det", Sxx * Syy - Pow(Sxy, 2))
    trace = p.define("trace", Sxx + Syy)
    harris = p.define("harris", det - HARRIS_K * Pow(trace, 2))
    p.output(harris)
    return p.build()


def corner_threshold(ref_harris) -> float:
    """Classification threshold: a fixed fraction of the max response."""
    import numpy as np
    return 0.01 * float(np.max(np.asarray(ref_harris)))
