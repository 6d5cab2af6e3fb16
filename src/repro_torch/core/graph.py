"""Stage-DAG IR — the PolyMage analogue (paper §III-A).

The port's own copy of `repro.core.graph` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

An image-processing pipeline is a DAG of *stages*; each stage computes one
output pixel at (i, j) from pixels of its input stages via an expression
tree.  The expression tree is exactly what Algorithm 1 walks (`e->left`,
`e->right`, `e->operator`), and what the executors evaluate on arrays.

Stencils are represented *expanded* into expression form (paper §IV-B: "The
stencil operation here can be expanded in the form of an expression"), with
`Ref` leaves carrying the (dy, dx) tap offset.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.interval import Interval


# ---------------------------------------------------------------------------
# Expression IR
# ---------------------------------------------------------------------------

class Expr:
    """Base expression node. Operator overloads build trees."""

    def _wrap(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        return Const(float(other))

    def __add__(self, o): return BinOp("+", self, self._wrap(o))
    def __radd__(self, o): return BinOp("+", self._wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, self._wrap(o))
    def __rsub__(self, o): return BinOp("-", self._wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, self._wrap(o))
    def __rmul__(self, o): return BinOp("*", self._wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, self._wrap(o))
    def __rtruediv__(self, o): return BinOp("/", self._wrap(o), self)
    def __pow__(self, n: int): return Pow(self, int(n))
    def __neg__(self): return BinOp("*", Const(-1.0), self)

    # comparisons build Cmp nodes (for Select conditions)
    def __lt__(self, o): return Cmp("<", self, self._wrap(o))
    def __le__(self, o): return Cmp("<=", self, self._wrap(o))
    def __gt__(self, o): return Cmp(">", self, self._wrap(o))
    def __ge__(self, o): return Cmp(">=", self, self._wrap(o))


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True)
class Ref(Expr):
    """Pixel (i+dy, j+dx) of input stage `stage`."""
    stage: str
    dy: int = 0
    dx: int = 0


@dataclasses.dataclass(frozen=True)
class ParamRef(Expr):
    """Runtime scalar parameter with a declared range (e.g. USM `weight`)."""
    name: str


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * /
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class Pow(Expr):
    base: Expr
    n: int


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    fn: str  # abs | sqrt | min | max
    args: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    op: str  # < <= > >=
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class Select(Expr):
    cond: Cmp
    then: Expr
    other: Expr


def expr_refs(e: Expr) -> List[Ref]:
    """All Ref leaves of an expression tree, in traversal order."""
    out: List[Ref] = []

    def go(n: Expr):
        if isinstance(n, Ref):
            out.append(n)
        elif isinstance(n, BinOp):
            go(n.left); go(n.right)
        elif isinstance(n, Pow):
            go(n.base)
        elif isinstance(n, Call):
            for a in n.args:
                go(a)
        elif isinstance(n, Cmp):
            go(n.left); go(n.right)
        elif isinstance(n, Select):
            go(n.cond); go(n.then); go(n.other)

    go(e)
    return out


def expr_ops(e: Expr) -> Dict[str, int]:
    """Operation census of an expression tree (for the cost model)."""
    counts: Dict[str, int] = {}

    def bump(k: str):
        counts[k] = counts.get(k, 0) + 1

    def go(n: Expr):
        if isinstance(n, BinOp):
            # constant-folded multiplies by +-1 are wires, not ops
            if not (n.op == "*" and isinstance(n.left, Const) and abs(n.left.value) == 1.0):
                bump(n.op)
            go(n.left); go(n.right)
        elif isinstance(n, Pow):
            bump("*")  # squaring ~ one multiplier; higher powers log-many
            go(n.base)
        elif isinstance(n, Call):
            bump(n.fn)
            for a in n.args:
                go(a)
        elif isinstance(n, Cmp):
            bump("cmp")
            go(n.left); go(n.right)
        elif isinstance(n, Select):
            bump("sel")
            go(n.cond); go(n.then); go(n.other)

    go(e)
    return counts


# ---------------------------------------------------------------------------
# Stages and pipelines
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    name: str
    expr: Optional[Expr]                      # None for input stages
    inputs: Tuple[str, ...] = ()
    # sampling: output(i,j) = expr evaluated on input grid at (i*sy, j*sx)
    stride: Tuple[int, int] = (1, 1)          # >1 = downsample
    upsample: Tuple[int, int] = (1, 1)        # >1 = nearest-expand before expr
    is_input: bool = False
    input_range: Optional[Interval] = None    # for input stages (e.g. [0,255])

    def refs(self) -> List[Ref]:
        return expr_refs(self.expr) if self.expr is not None else []

    def halo_yx(self) -> Tuple[int, int]:
        """Per-axis stencil halo (hy, hx) this stage reads.

        A 1-D separable stencil has a zero halo on its orthogonal axis: a
        horizontal 5-tap blur needs no line buffer at all (hy = 0) and a
        vertical one pads no columns (hx = 0).  Executors and the cost
        model must use the per-axis values — the old isotropic
        ``max(|dy|, |dx|)`` over-padded (and over-priced line buffers on)
        every separable stage.
        """
        rs = self.refs()
        if not rs:
            return (0, 0)
        return (max(abs(r.dy) for r in rs), max(abs(r.dx) for r in rs))

    def halo(self) -> int:
        """Isotropic halo — max over both axes of `halo_yx` (legacy)."""
        hy, hx = self.halo_yx()
        return max(hy, hx)


class Pipeline:
    """A DAG of stages with named scalar parameters."""

    def __init__(self, name: str):
        self.name = name
        self.stages: Dict[str, Stage] = {}
        self.params: Dict[str, Interval] = {}   # declared parameter ranges
        self.outputs: List[str] = []

    # -- construction -----------------------------------------------------
    def add_stage(self, stage: Stage) -> Stage:
        if stage.name in self.stages:
            raise ValueError(f"duplicate stage {stage.name!r}")
        for inp in stage.inputs:
            if inp not in self.stages:
                raise ValueError(f"stage {stage.name!r} reads undefined {inp!r}")
        self.stages[stage.name] = stage
        return stage

    def add_param(self, name: str, lo: float, hi: float):
        self.params[name] = Interval(float(lo), float(hi))

    def mark_output(self, name: str):
        if name not in self.stages:
            raise ValueError(name)
        if name not in self.outputs:
            self.outputs.append(name)

    # -- queries ------------------------------------------------------------
    def topo_order(self) -> List[str]:
        order: List[str] = []
        seen: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(n: str):
            st = seen.get(n)
            if st == 1:
                return
            if st == 0:
                raise ValueError(f"cycle through {n!r}")
            seen[n] = 0
            for inp in self.stages[n].inputs:
                visit(inp)
            seen[n] = 1
            order.append(n)

        for n in self.stages:
            visit(n)
        return order

    def input_stages(self) -> List[str]:
        return [n for n, s in self.stages.items() if s.is_input]

    def consumers(self, name: str) -> List[str]:
        return [n for n, s in self.stages.items() if name in s.inputs]

    def __repr__(self) -> str:
        return f"Pipeline({self.name!r}, {len(self.stages)} stages)"


def pipeline_content_hash(pipeline: Pipeline) -> str:
    """Stable content hash over stages, params, and outputs.

    Expression trees are frozen dataclasses with deterministic reprs, so
    the hash changes iff the pipeline's analyzed content changes (a mutated
    `Pipeline` object re-hashes — the memo never serves stale results).
    """
    h = hashlib.sha256()
    for name in sorted(pipeline.stages):
        st = pipeline.stages[name]
        h.update(repr((st.name, st.inputs, st.stride, st.upsample,
                       st.is_input, st.input_range, st.expr)).encode())
    h.update(repr(sorted(pipeline.params.items(),
                         key=lambda kv: kv[0])).encode())
    h.update(repr(list(pipeline.outputs)).encode())
    return h.hexdigest()[:16]


def stencil_expr(input_name: str, weights: Sequence[Sequence[float]],
                 scale: float = 1.0, center: Optional[Tuple[int, int]] = None) -> Expr:
    """Expand a 2-D stencil into expression form (paper §IV-B).

    `weights[r][c]` taps pixel (i + r - cy, j + c - cx).  Zero taps are
    skipped.  The whole sum is multiplied by `scale` (e.g. 1/16 for the
    binomial blur in Listing 1).
    """
    rows = len(weights)
    cols = max(len(r) for r in weights)
    if center is None:
        center = (rows // 2, cols // 2)
    cy, cx = center
    acc: Optional[Expr] = None
    for r, row in enumerate(weights):
        for c, w in enumerate(row):
            if w == 0:
                continue
            tap: Expr = Ref(input_name, dy=r - cy, dx=c - cx)
            if w != 1:
                tap = BinOp("*", Const(float(w)), tap)
            acc = tap if acc is None else BinOp("+", acc, tap)
    if acc is None:
        acc = Const(0.0)
    if scale != 1.0:
        acc = BinOp("*", Const(float(scale)), acc)
    return acc
