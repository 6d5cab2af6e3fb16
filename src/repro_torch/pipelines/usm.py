"""Unsharp Mask — paper Listing 1 / Figure 1.

The port's own copy of `repro.pipelines.usm` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

    blurx   : vertical 5-tap binomial /16
    blury   : horizontal 5-tap binomial /16
    sharpen : img*(1+weight) + blury*(-weight)
    masked  : Select(|img - blury| < thresh, img, sharpen), clamped at 0
              (output pixels are non-negative -> unsigned 9-bit, Table V)

`weight` is declared over [0, 1] and `thresh` over [0, 255]; with these the
static analysis reproduces Table V's alpha column (8/8/8/10/9).
"""
from __future__ import annotations

from repro_torch.core.graph import Const, Pipeline
from repro_torch.dsl.builder import PipelineBuilder, absv, ite, maxv

BINOMIAL5 = [1, 4, 6, 4, 1]

DEFAULT_PARAMS = {"weight": 1.0, "thresh": 0.01 * 255}


def build() -> Pipeline:
    p = PipelineBuilder("usm")
    img = p.image("img", 0, 255)
    weight = p.param("weight", 0.0, 1.0)
    thresh = p.param("thresh", 0.0, 255.0)
    blurx = p.stencil("blurx", img, [[w] for w in BINOMIAL5], scale=1.0 / 16)
    blury = p.stencil("blury", blurx, [BINOMIAL5], scale=1.0 / 16)
    sharpen = p.define("sharpen", img * (1 + weight) + blury * (-weight))
    masked = p.define(
        "masked", maxv(ite(absv(img - blury) < thresh, img, sharpen), Const(0.0)))
    p.output(masked)
    return p.build()
