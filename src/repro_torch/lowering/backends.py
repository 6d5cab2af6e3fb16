"""Datapath rules of the fused executor, in torch.

Port of the datapath helpers of `repro.lowering.backends` and of
`repro.dsl.exec.eval_expr`.  The reference helpers take a
`LoweredStage` and build jnp closures; here the rules take the plain
numbers the band kernel's encoded tables carry
(`repro_torch.kernels.stencil.kernel.encode_program`), because the plain
version of the kernel walks those tables.  The CUDA kernel
(`kernels/stencil/csrc/fused_band.cu`) transcribes the same rules.

Every integer tile here is carried in int64 and every float tile in
f64.  That is bit-equal to the reference's int32 / int32-pair carriers:
`lowering.ir._plan_intlinear` elects those only after proving that no
partial sum overflows them, so the wider sum holds the same integer.
Narrow containers (uint8 ... uint32) are storage only: values are
clipped in the carrier and cast into the container last.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                                    Pow, Ref, Select)
from repro_torch.core.policy import legalize
from repro_torch.lowering.ir import LoweredPipeline, LoweredStage

Executor = Callable[..., Dict[str, torch.Tensor]]

# one saturation bound per sampling-lattice residue: (ry, rx, qmin, qmax)
ResidueBound = Tuple[int, int, int, int]


def rhe_shift(p: torch.Tensor, t: int) -> torch.Tensor:
    """Round-half-even of `p / 2^t` on int64 tensors (t may be <= 0).

    Bit-identical to `rint` of the exact dyadic rational.  `>>` on a
    negative int64 tensor is an arithmetic shift, i.e. floor division.
    """
    if t <= 0:
        return p << (-t)
    base = p >> t
    rem = p - (base << t)
    half = 1 << (t - 1)
    inc = (rem > half) | ((rem == half) & ((base & 1) == 1))
    return base + inc.to(p.dtype)


def residue_bounds(lattice: Tuple[int, int], entries: Sequence[ResidueBound],
                   rows_abs: torch.Tensor, cols_abs: torch.Tensor,
                   int_min: int, int_max: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qmin, qmax) int64 saturation grids for a phase-split stage tile.

    `rows_abs` and `cols_abs` hold the tile's absolute rows and
    columns.  Residues absent from
    `entries` keep the union bounds; where two entries name the same
    residue the later one wins, as in the reference's `where` chain.
    """
    my, mx = lattice
    dev = rows_abs.device
    rr = (rows_abs % my).reshape(-1, 1)
    cc = (cols_abs % mx).reshape(1, -1)
    shape = (rows_abs.shape[0], cols_abs.shape[0])
    qmin = torch.full(shape, int_min, dtype=torch.int64, device=dev)
    qmax = torch.full(shape, int_max, dtype=torch.int64, device=dev)
    for ry, rx, lo, hi in entries:
        mask = (rr == ry % my) & (cc == rx % mx)
        qmin = torch.where(mask, lo, qmin)
        qmax = torch.where(mask, hi, qmax)
    return qmin, qmax


def store_dtype(ls: LoweredStage) -> torch.dtype:
    """Container a fused backend materializes for this stage.

    The smallest legalized container (`core.policy.legalize`) of the
    stage's (alpha, beta) width; int64 for 33..52 exact-integer bits;
    f64 for float-stored stages.  Exact because every store site clips
    into ``[t.int_min, t.int_max]`` before the narrowing cast.
    """
    if ls.store_float:
        return torch.float64
    lt = legalize(ls.t)
    if lt.fp is not None:              # width <= 32: smallest container
        return lt.dtype
    return torch.int64                 # 33..52 exact-int bits


def accumulate_intlinear(taps: Sequence[Tuple[int, torch.Tensor]],
                         zeros: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Integer multiply-accumulate ``sum(w * tap)`` in int64."""
    acc = zeros()
    for w, tile in taps:
        acc = acc + w * tile
    return acc


def _clip(q: torch.Tensor, qmin, qmax) -> torch.Tensor:
    """Clip `q` in its own carrier (int64 or f64)."""
    if isinstance(qmin, torch.Tensor):
        return torch.minimum(torch.maximum(q, qmin.to(q.dtype)),
                             qmax.to(q.dtype))
    if q.dtype == torch.float64:
        qmin, qmax = float(qmin), float(qmax)
    return torch.clamp(q, qmin, qmax)


def finish_intlinear(acc: torch.Tensor, dyadic: bool, sm: int, t_shift: int,
                     cscale: float, qmin, qmax) -> torch.Tensor:
    """Accumulator -> saturated scaled-int tile (int64).

    Dyadic scales finish with the round-half-even shift; any other scale
    with one f64 multiply and `rint` (`torch.round` is half-even), the
    same multiply the oracle issues.  `qmin`/`qmax` are the union bounds
    or per-residue grids (`residue_bounds`)."""
    if dyadic:
        q = rhe_shift(acc * sm if sm != 1 else acc, t_shift)
    else:
        q = torch.round(acc.to(torch.float64) * cscale)
    return _clip(q, qmin, qmax).to(torch.int64)


def snap_float(raw: torch.Tensor, step: float, int_min, int_max
               ) -> torch.Tensor:
    """The oracle's `_snap`: rint, clip, rescale (f64 in, f64 out)."""
    return torch.clamp(torch.round(raw * step), float(int_min),
                       float(int_max)) / step


# snap rules of an expression stage, by the stage's stored form
SNAP_INT, SNAP_FLOAT, SNAP_MIXED, SNAP_RAW = 0, 1, 2, 3


def snap_expr(raw: torch.Tensor, mode: int, step: float, int_min, int_max,
              lattice: Optional[Tuple[int, int]] = None,
              entries: Sequence[Tuple[int, int, int, int, float]] = (),
              rows_abs: Optional[torch.Tensor] = None,
              cols_abs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw f64 stage tile -> stored tile (int64 grid or f64 values).

    * ``SNAP_RAW``   — untyped stage: the raw f64 value;
    * ``SNAP_FLOAT`` — float-stored typed stage: `snap_float`;
    * ``SNAP_MIXED`` — residues with different betas: the union snap,
      then each listed residue re-snapped on its own grid;
    * ``SNAP_INT``   — ``rint(raw * 2^beta)`` clipped to the union or
      per-residue bounds, stored as an integer.

    `entries` are ``(ry, rx, qmin, qmax, step)`` per residue; `rows_abs`
    and `cols_abs` the tile's absolute rows and columns."""
    if mode == SNAP_RAW:
        return raw
    if mode == SNAP_FLOAT:
        return snap_float(raw, step, int_min, int_max)
    if mode == SNAP_MIXED:
        out = snap_float(raw, step, int_min, int_max)
        my, mx = lattice
        rows = (rows_abs % my).reshape(-1, 1)
        cols = (cols_abs % mx).reshape(1, -1)
        for ry, rx, lo, hi, st in entries:
            mask = (rows == ry % my) & (cols == rx % mx)
            out = torch.where(mask, snap_float(raw, st, lo, hi), out)
        return out
    q = torch.round(raw * step)
    if entries:
        qmin, qmax = residue_bounds(lattice, [e[:4] for e in entries],
                                    rows_abs, cols_abs, int_min, int_max)
        q = _clip(q, qmin, qmax)
    else:
        q = _clip(q, int_min, int_max)
    return q.to(torch.int64)


def quantize_input(x: torch.Tensor, t: Optional[FixedPointType],
                   dtype: torch.dtype) -> torch.Tensor:
    """f64 image -> scaled-int tile on `t`'s grid (oracle input snapping),
    clipped in f64 and cast into the container last."""
    if t is None:
        return x
    q = torch.clamp(torch.round(x * (2.0 ** t.beta)), float(t.int_min),
                    float(t.int_max))
    return q.to(dtype)


def ingest_input(x: torch.Tensor, ls: LoweredStage) -> torch.Tensor:
    """Image (or pre-quantized container tensor) -> stored input tile.

    A tensor already in the stage's container dtype is taken as
    pre-quantized — its values are ``rint(v * 2^beta)`` — and used as
    the stored tile as it is (zero-copy).  Anything else takes the
    oracle path: cast to f64, snap onto `t`'s grid."""
    dt = store_dtype(ls)
    if ls.t is not None and x.dtype == dt:
        return x
    x = x.to(torch.float64)
    if ls.t is None:
        return x
    return quantize_input(x, ls.t, dt)


def dequant(ls: LoweredStage, tile: torch.Tensor) -> torch.Tensor:
    """Stored tile -> the f64 stage value the oracle's env carries."""
    if ls.store_float:
        return tile
    return tile.to(torch.float64) * (2.0 ** -ls.t.beta)


def needed_stages(lp: LoweredPipeline, outputs: Sequence[str]) -> List[str]:
    """Ancestors of `outputs` in topo order (prune dead stages)."""
    need = set()
    stack = list(outputs)
    while stack:
        n = stack.pop()
        if n in need:
            continue
        need.add(n)
        stack.extend(lp.pipeline.stages[n].inputs)
    return [n for n in lp.order if n in need]


def normalize_images(lp: LoweredPipeline, image):
    """run_fixed's input convention: dict / tuple / single array."""
    input_names = lp.pipeline.input_stages()
    if isinstance(image, dict):
        return [image[n] for n in input_names], input_names
    if isinstance(image, (tuple, list)):
        return list(image), input_names
    return [image], input_names


def eval_expr(e: Expr, ref: Callable, params: Dict[str, float], xp, where):
    """Evaluate an expression tree with a pluggable `Ref` resolver.

    The one definition of concrete evaluation order, copied from
    `repro.dsl.exec.eval_expr`.  The band kernel's encoder runs it on
    symbolic values to emit its postfix program, so the kernel issues
    every floating op in the oracle's order.
    """

    def go(n: Expr):
        if isinstance(n, Const):
            return n.value
        if isinstance(n, ParamRef):
            return params[n.name]
        if isinstance(n, Ref):
            return ref(n.stage, n.dy, n.dx)
        if isinstance(n, BinOp):
            l, r = go(n.left), go(n.right)
            if n.op == "+":
                return l + r
            if n.op == "-":
                return l - r
            if n.op == "*":
                return l * r
            return l / r
        if isinstance(n, Pow):
            return go(n.base) ** n.n
        if isinstance(n, Call):
            args = [go(a) for a in n.args]
            if n.fn == "abs":
                return xp.abs(args[0])
            if n.fn == "sqrt":
                return xp.sqrt(args[0])
            if n.fn == "min":
                return xp.minimum(args[0], args[1])
            return xp.maximum(args[0], args[1])
        if isinstance(n, Cmp):
            l, r = go(n.left), go(n.right)
            return {"<": l < r, "<=": l <= r, ">": l > r, ">=": l >= r}[n.op]
        if isinstance(n, Select):
            return where(go(n.cond), go(n.then), go(n.other))
        raise TypeError(type(n))

    return go(e)
