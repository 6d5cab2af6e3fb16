"""PolyMage-flavored pipeline builder (paper Listing 1 analogue).

The port's own copy of `repro.dsl.builder` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

Example (Unsharp Mask):

    p = PipelineBuilder("usm")
    img = p.image("img", 0, 255)
    blurx = p.stencil("blurx", img, [[1], [4], [6], [4], [1]], scale=1/16)
    blury = p.stencil("blury", blurx, [[1, 4, 6, 4, 1]], scale=1/16)
    sharpen = p.define("sharpen", img * (1 + W) + blury * (-W))
    masked = p.define("masked", ite(absv(img - blury) < T, img, sharpen))
    p.output(masked)
    pipe = p.build()

All handles are `Ref` expression nodes, so arbitrary point-wise arithmetic
composes with Python operators; `Stencil`/up/down-sampling helpers expand to
expression trees the analyses walk.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.graph import (Call, Cmp, Const, Expr, ParamRef, Pipeline, Ref,
                              Select, Stage, expr_refs, stencil_expr)
from repro_torch.core.interval import Interval


def _wrap(e) -> Expr:
    return e if isinstance(e, Expr) else Const(float(e))


# -- expression helpers (usable inside stage definitions) --------------------

def ite(cond: Cmp, then, other) -> Select:
    """Select(Condition, then, else) — paper Listing 1's Select."""
    if not isinstance(cond, Cmp):
        raise TypeError("ite condition must be a comparison")
    return Select(cond, _wrap(then), _wrap(other))


def absv(e: Expr) -> Call:
    return Call("abs", (e,))


def sqrtv(e: Expr) -> Call:
    return Call("sqrt", (e,))


def minv(a: Expr, b: Expr) -> Call:
    return Call("min", (a, b))


def maxv(a: Expr, b: Expr) -> Call:
    return Call("max", (a, b))


def shifted(h: Ref, dy: int, dx: int) -> Ref:
    """Access pixel (i+dy, j+dx) of a stage — for hand-written stencils."""
    return Ref(h.stage, dy=h.dy + dy, dx=h.dx + dx)


class PipelineBuilder:
    def __init__(self, name: str):
        self.p = Pipeline(name)

    # -- inputs / params ------------------------------------------------------
    def image(self, name: str, lo: float, hi: float) -> Ref:
        self.p.add_stage(Stage(name=name, expr=None, is_input=True,
                               input_range=Interval(float(lo), float(hi))))
        return Ref(name)

    def param(self, name: str, lo: float, hi: float) -> ParamRef:
        self.p.add_param(name, lo, hi)
        return ParamRef(name)

    # -- stages -----------------------------------------------------------------
    def define(self, name: str, expr: Expr,
               stride: Tuple[int, int] = (1, 1),
               upsample: Tuple[int, int] = (1, 1)) -> Ref:
        inputs = tuple(dict.fromkeys(r.stage for r in expr_refs(expr)))
        self.p.add_stage(Stage(name=name, expr=expr, inputs=inputs,
                               stride=stride, upsample=upsample))
        return Ref(name)

    def stencil(self, name: str, inp: Ref, weights: Sequence[Sequence[float]],
                scale: float = 1.0,
                center: Optional[Tuple[int, int]] = None) -> Ref:
        return self.define(name, stencil_expr(inp.stage, weights, scale, center))

    def downsample(self, name: str, inp: Ref,
                   weights: Sequence[Sequence[float]], scale: float = 1.0,
                   stride: Tuple[int, int] = (2, 2)) -> Ref:
        """Filter-then-decimate along the strided axes."""
        return self.define(name, stencil_expr(inp.stage, weights, scale),
                           stride=stride)

    def upsample(self, name: str, inp: Ref,
                 weights: Sequence[Sequence[float]], scale: float = 1.0,
                 factor: Tuple[int, int] = (2, 2)) -> Ref:
        """Nearest-expand by `factor`, then smooth with the given stencil."""
        return self.define(name, stencil_expr(inp.stage, weights, scale),
                           upsample=factor)

    def output(self, h: Ref) -> None:
        self.p.mark_output(h.stage)

    def build(self) -> Pipeline:
        if not self.p.outputs:
            # default: stages nothing consumes
            for n in self.p.stages:
                if not self.p.consumers(n):
                    self.p.mark_output(n)
        return self.p
