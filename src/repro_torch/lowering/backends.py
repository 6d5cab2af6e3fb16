"""Datapath rules and the whole-frame executors, in torch.

Port of `repro.lowering.backends` and of `repro.dsl.exec.eval_expr`.
The reference helpers take a `LoweredStage` and build jnp closures; here
the rules take the plain numbers the band kernel's encoded tables carry
(`repro_torch.kernels.stencil.kernel.encode_program`), because the plain
version of the kernel walks those tables.  The CUDA kernel
(`kernels/stencil/csrc/fused_band.cu`) transcribes the same rules.

Two executors over a `LoweredPipeline` live here, each returning the
stages it is asked for as f64 tensors:

  * `compile_interp` — the per-stage f64 walk (`dsl.exec._run_concrete`,
    the port of the reference's numpy oracle), a batch as a loop over
    images;
  * `compile_lowered` — one whole-frame program (the counterpart of the
    reference's `compile_jnp`): integer multiply-accumulates for the
    linear stages, the expression tree on dequantized operands for the
    rest (in f32 where narrow mode elected it), a batch in one pass.

Neither is a kernel in the reference, so plain PyTorch is their port.

Every integer tile here is carried in int64 and every float tile in f64
(f32 for an f32 expression stage's values).  That is bit-equal to the
reference's int32 / int32-pair carriers: `lowering.ir._plan_intlinear`
elects those only after proving that no partial sum overflows them, so
the wider sum holds the same integer.  Narrow containers (uint8 ...
uint32) are storage only: values are clipped in the carrier and cast
into the container last.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import npops
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                                    Pow, Ref, Select)
from repro_torch.core.policy import legalize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.lowering.ir import LoweredPipeline, LoweredStage, LoweringError
from repro_torch.lowering.schedule import stage_shapes

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


def dequant_f32(ls: LoweredStage, tile: torch.Tensor) -> torch.Tensor:
    """Stored tile -> the exact f32 stage value (narrow-mode f32 stages):
    f32(q) * f32(2^-beta), exact because `lowering.ir._expr_fits_f32`
    bounds |q| below 2^24 and the rescale is a power of two."""
    return tile.to(torch.float32) * torch.tensor(
        2.0 ** -ls.t.beta, dtype=torch.float32, device=tile.device)


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


def check_stage_shapes(lp: LoweredPipeline, in_shape: Tuple[int, int]
                       ) -> None:
    """Raise `LoweringError` where a stage's inputs, each upsampled by the
    stage, do not meet at the input shape `in_shape`.

    A stage computes the shape of its first input (upsampled); another
    input may be larger, and is cropped, but not smaller.  The
    reference's oracle fails there on a numpy broadcast (optical flow's
    pyramid at an odd height or width: its re-expanded flow has a row or
    column more than the frame); every executor of the port refuses the
    shape before it computes anything."""
    shapes = stage_shapes(lp, tuple(in_shape))
    for name in lp.order:
        check_inputs_meet(name, lp.stages[name].stage, shapes, in_shape)


def check_inputs_meet(name: str, st, shapes: Dict[str, Tuple[int, int]],
                      in_shape: Tuple[int, int]) -> None:
    """`check_stage_shapes` for one stage `st`, its inputs' (H, W) in
    `shapes` (a walk checks each stage as it reaches it)."""
    if len(st.inputs) < 2:
        return
    uy, ux = st.upsample
    up = {i: (shapes[i][0] * uy, shapes[i][1] * ux) for i in st.inputs}
    first = st.inputs[0]
    for other in st.inputs[1:]:
        if up[other][0] < up[first][0] or up[other][1] < up[first][1]:
            raise LoweringError(
                f"stage {name!r}: its inputs do not meet at input "
                f"shape {tuple(in_shape)}: {first!r} gives "
                f"{up[first]}, {other!r} gives {up[other]}")


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


# ---------------------------------------------------------------------------
# whole-frame evaluation of an expression tree on tensors
# ---------------------------------------------------------------------------

class _Val:
    """A tensor as `eval_expr` sees it.  A Python number it meets becomes
    a 0-dim f64 tensor: then ``2.0 / x`` is one correctly rounded
    division (torch's reflected ``/`` is a reciprocal and a multiply),
    and an f32 tensor meets the number rounded to f32, as a weak scalar
    meets an f32 array in the reference.  Constant subtrees stay Python
    numbers, folded in Python's doubles as the oracle folds them."""
    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t

    def _o(self, o) -> torch.Tensor:
        if isinstance(o, _Val):
            return o.t
        return torch.tensor(o, dtype=torch.float64, device=self.t.device)

    def __add__(self, o): return _Val(torch.add(self.t, self._o(o)))
    def __radd__(self, o): return _Val(torch.add(self._o(o), self.t))
    def __sub__(self, o): return _Val(torch.sub(self.t, self._o(o)))
    def __rsub__(self, o): return _Val(torch.sub(self._o(o), self.t))
    def __mul__(self, o): return _Val(torch.mul(self.t, self._o(o)))
    def __rmul__(self, o): return _Val(torch.mul(self._o(o), self.t))
    def __truediv__(self, o): return _Val(torch.div(self.t, self._o(o)))
    def __rtruediv__(self, o): return _Val(torch.div(self._o(o), self.t))
    # a reflected comparison (``2.0 < v``) arrives as ``v > 2.0``
    def __lt__(self, o): return _Val(torch.lt(self.t, self._o(o)))
    def __le__(self, o): return _Val(torch.le(self.t, self._o(o)))
    def __gt__(self, o): return _Val(torch.gt(self.t, self._o(o)))
    def __ge__(self, o): return _Val(torch.ge(self.t, self._o(o)))

    def __pow__(self, n): return _Val(npops.npow(self.t, n))


class _TorchXP:
    """The `xp` namespace (and `where`) `eval_expr` calls on `_Val`s."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.dtype, self.device = dtype, device

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, _Val):
            return x.t
        return torch.tensor(x, dtype=self.dtype, device=self.device)

    # numpy's rules for sqrt, min and max (`core.npops`)
    def abs(self, x): return _Val(torch.abs(self._t(x)))
    def sqrt(self, x): return _Val(npops.sqrt(self._t(x)))
    def minimum(self, a, b): return _Val(npops.minimum(self._t(a), self._t(b)))
    def maximum(self, a, b): return _Val(npops.maximum(self._t(a), self._t(b)))

    def where(self, c, a, b):
        cond = self._t(c)
        if cond.dtype != torch.bool:
            cond = cond != 0
        return _Val(torch.where(cond, self._t(a), self._t(b)))


def eval_tensor_expr(e: Expr, tap: Callable[[str, int, int], torch.Tensor],
                     params: Dict[str, float], dtype: torch.dtype,
                     shape: Sequence[int], device) -> torch.Tensor:
    """`eval_expr` on tensors: `tap(stage, dy, dx)` gives a Ref's values
    (in `dtype`); returns the stage's raw values, broadcast to `shape`."""
    xp = _TorchXP(dtype, torch.device(device))
    out = eval_expr(e, lambda st, dy, dx: _Val(tap(st, dy, dx)), params,
                    xp, xp.where)
    return xp._t(out).to(dtype).expand(*shape)


def edge_pad(a: torch.Tensor, hy: int, hx: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dimensions (any dtype)."""
    H, W = a.shape[-2:]
    dev = a.device
    if hy:
        rows = torch.clamp(torch.arange(-hy, H + hy, device=dev), 0, H - 1)
        a = a.index_select(-2, rows)
    if hx:
        cols = torch.clamp(torch.arange(-hx, W + hx, device=dev), 0, W - 1)
        a = a.index_select(-1, cols)
    return a


def upsample_pad(a: torch.Tensor, upsample: Tuple[int, int],
                 halo: Tuple[int, int]) -> torch.Tensor:
    """The oracle's `_pad_inputs` for one input: nearest-expand by the
    stage's upsampling factors, then edge-pad by its halo."""
    uy, ux = upsample
    if uy > 1:
        a = a.repeat_interleave(uy, dim=-2)
    if ux > 1:
        a = a.repeat_interleave(ux, dim=-1)
    return edge_pad(a, *halo)


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return x.to(device)


# ---------------------------------------------------------------------------
# the per-stage oracle walk, as an executor
# ---------------------------------------------------------------------------

def compile_interp(lp: LoweredPipeline,
                   outputs: Optional[Sequence[str]] = None,
                   device: DeviceLike = None) -> Executor:
    """The per-stage f64 walk (`dsl.exec._run_concrete`) as an executor:
    the port's oracle, the counterpart of the reference's numpy one.

    Batched ``(B, H, W)`` input runs as a loop over images, the
    definition the batched executors are held to.  A frame in its input
    stage's container dtype is pre-quantized: it dequantizes to the
    on-grid value the walk's own input snap reproduces."""
    from repro_torch.dsl.exec import _run_concrete
    dev = resolve_device(device)
    outs = list(outputs or lp.pipeline.outputs)
    phase_types = {n: (ls.phase.lattice, dict(ls.phase.types))
                   for n, ls in lp.stages.items() if ls.phase is not None}

    def one(image):
        env = _run_concrete(lp.pipeline, image, dict(lp.params), lp.types,
                            phase_types=phase_types or None, device=dev)
        return {k: env[k] for k in outs}

    def to_f64(im, n):
        x = _to_tensor(im, dev)
        ls = lp.stages[n]
        if ls.t is not None and x.dtype == store_dtype(ls):
            return x.to(torch.float64) * (2.0 ** -ls.t.beta)
        return x.to(torch.float64)

    def run(image):
        imgs, names = normalize_images(lp, image)
        arrs = [to_f64(im, n) for im, n in zip(imgs, names)]
        check_stage_shapes(lp, arrs[0].shape[-2:])
        # per-stage spans and runtime range telemetry live inside
        # `_run_concrete` (it sees every intermediate stage value)
        with obs.span("exec.interp", backend="interp",
                      pipeline=lp.pipeline.name, outputs=len(outs)):
            if all(a.ndim == 3 for a in arrs):
                per = [one(dict(zip(names, [a[b] for a in arrs])))
                       for b in range(arrs[0].shape[0])]
                return {k: torch.stack([p[k] for p in per]) for k in outs}
            return one(dict(zip(names, arrs)))

    run.lowered = lp
    return run


# ---------------------------------------------------------------------------
# the whole-frame program (the reference's `compile_jnp`)
# ---------------------------------------------------------------------------

def compile_lowered(lp: LoweredPipeline,
                    outputs: Optional[Sequence[str]] = None,
                    device: DeviceLike = None) -> Executor:
    """One whole-frame torch program with the oracle's padded geometry.

    Integer linear stages run as int64 multiply-accumulates (the stride
    folded into the tap slices) finished by `finish_intlinear`; every
    other stage evaluates the oracle's expression tree (`eval_expr`) on
    dequantized operands, in f32 where the lowering elected it
    (`dequant_f32`), and snaps with `snap_expr`.  A ``(B, H, W)`` batch
    runs as one program: every op is per pixel.  Returns
    ``{stage: f64 tensor}`` for `outputs` (default: the pipeline's)."""
    dev = resolve_device(device)
    outs = list(outputs or lp.pipeline.outputs)
    order = needed_stages(lp, outs)
    params = dict(lp.params)

    def residues(ls: LoweredStage, with_step: bool):
        if ls.phase is None:
            return ()
        return [(ry, rx, t.int_min, t.int_max) +
                ((2.0 ** t.beta,) if with_step else ())
                for (ry, rx), t in sorted(ls.phase.types.items())]

    def forward(img_of: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tiles: Dict[str, torch.Tensor] = {}    # int64 grid or f64 values
        vals: Dict[str, torch.Tensor] = {}     # f64 stage values
        for name in order:
            ls = lp.stages[name]
            st = ls.stage
            if st.is_input:
                tile = ingest_input(img_of[name], ls)
                tiles[name] = tile if ls.store_float else tile.to(torch.int64)
                vals[name] = dequant(ls, tile)
                continue
            H, W = tiles[st.inputs[0]].shape[-2:]
            H, W = H * st.upsample[0], W * st.upsample[1]
            hy, hx = ls.halo
            sy, sx = st.stride
            Hs, Ws = -(-H // sy), -(-W // sx)
            lead = tiles[st.inputs[0]].shape[:-2]
            rows_abs = torch.arange(Hs, dtype=torch.int64, device=dev)
            cols_abs = torch.arange(Ws, dtype=torch.int64, device=dev)
            t = ls.t
            if ls.kind == "intlinear":
                padded = {i: upsample_pad(tiles[i], st.upsample, ls.halo)
                          for i in st.inputs}
                acc = accumulate_intlinear(
                    [(tp.W, padded[tp.stage][..., hy + tp.dy:hy + tp.dy + H:sy,
                                             hx + tp.dx:hx + tp.dx + W:sx])
                     for tp in ls.int_taps],
                    lambda: torch.zeros(lead + (Hs, Ws), dtype=torch.int64,
                                        device=dev))
                qmin, qmax = t.int_min, t.int_max
                if ls.phase is not None:
                    qmin, qmax = residue_bounds(
                        ls.phase.lattice, residues(ls, False), rows_abs,
                        cols_abs, qmin, qmax)
                tiles[name] = finish_intlinear(acc, ls.dyadic, ls.sm,
                                               ls.t_shift, ls.cscale, qmin,
                                               qmax)
            else:
                f32 = ls.expr_dtype == "f32"
                padded = {i: upsample_pad(
                    dequant_f32(lp.stages[i], tiles[i]) if f32 else vals[i],
                    st.upsample, ls.halo) for i in st.inputs}
                fdt = torch.float32 if f32 else torch.float64
                raw = eval_tensor_expr(
                    st.expr, lambda s_, dy, dx: padded[s_][
                        ..., hy + dy:hy + dy + H, hx + dx:hx + dx + W],
                    params, fdt, lead + (H, W), dev)
                raw = raw[..., ::sy, ::sx]
                if t is None:
                    mode, lo, hi, step = SNAP_RAW, 0, 0, 1.0
                elif ls.phase is not None and not ls.phase.int_ok:
                    mode = SNAP_MIXED
                elif ls.store_float:
                    mode = SNAP_FLOAT
                else:
                    mode = SNAP_INT
                if t is not None:
                    lo, hi, step = t.int_min, t.int_max, 2.0 ** t.beta
                tiles[name] = snap_expr(
                    raw, mode, step, lo, hi,
                    ls.phase.lattice if ls.phase is not None else None,
                    residues(ls, True), rows_abs, cols_abs)
            vals[name] = dequant(ls, tiles[name])
        return {k: vals[k] for k in outs}

    def run(image):
        imgs, names = normalize_images(lp, image)
        xs = [_to_tensor(im, dev) for im in imgs]
        if len({x.ndim for x in xs}) != 1 or xs[0].ndim not in (2, 3) \
                or len({tuple(x.shape) for x in xs}) != 1:
            raise LoweringError(f"images must all be (H, W) or all (B, H, W) "
                                f"of one shape; got "
                                f"{[tuple(x.shape) for x in xs]}")
        check_stage_shapes(lp, xs[0].shape[-2:])
        with obs.span("exec.lowered", backend="lowered",
                      pipeline=lp.pipeline.name, outputs=len(outs)) as sp:
            if xs[0].ndim == 3:
                sp.set(batch=int(xs[0].shape[0]))
            res = forward(dict(zip(names, xs)))
        # read-only post-processing: never feeds back into the computation
        obs.runtime.record_env(res, lp, backend="lowered")
        return res

    run.lowered = lp
    return run


# ---------------------------------------------------------------------------
# the compile front door
# ---------------------------------------------------------------------------

COMPILE_BACKENDS = ("cuda", "torch", "lowered", "interp", "sharded")


def compile_backend(lp: LoweredPipeline, backend: str = "cuda",
                    outputs: Optional[Sequence[str]] = None,
                    device: DeviceLike = None, **options) -> Executor:
    """An executor of `lp` on `backend`: ``"cuda"`` (the band kernel,
    `lowering.cuda_backend`), ``"torch"`` (its plain version),
    ``"lowered"`` (`compile_lowered`), ``"interp"`` (`compile_interp`)
    or ``"sharded"`` (the band kernel split over a device mesh,
    `lowering.sharded`).  `outputs` defaults to the pipeline's outputs.
    `options` go to the backend: ``tile_rows`` for the band-kernel
    backends, and ``mesh`` for ``"sharded"``."""
    if backend not in COMPILE_BACKENDS:
        raise LoweringError(f"unknown lowering backend {backend!r}; "
                            f"expected one of {COMPILE_BACKENDS}")
    kinds = lp.kinds()
    with obs.span("lowering.compile", backend=backend,
                  pipeline=lp.pipeline.name, n_stages=len(lp.stages),
                  intlinear=sum(1 for k in kinds.values()
                                if k == "intlinear")):
        if backend in ("cuda", "torch"):
            from repro_torch.lowering.cuda_backend import compile_cuda
            return compile_cuda(lp, device=device, plain=backend == "torch",
                                outputs=outputs, **options)
        if backend == "sharded":
            from repro_torch.lowering.sharded import compile_sharded
            return compile_sharded(lp, outputs=outputs, device=device,
                                   **options)
        compile_ = compile_lowered if backend == "lowered" else compile_interp
        return compile_(lp, outputs=outputs, device=device, **options)


def compile_pipeline(pipeline, types, params: Optional[Dict[str, float]] = None,
                     backend: str = "cuda",
                     outputs: Optional[Sequence[str]] = None,
                     column: Optional[str] = None, datapath: str = "exact",
                     device: DeviceLike = None) -> Executor:
    """Lower and compile in one call (the reference's
    `repro.lowering.compile_pipeline`; its ``"jnp"`` and ``"pallas"`` are
    the port's ``"lowered"`` and ``"cuda"``).  Not memoized: each call
    lowers and compiles anew (`dsl.exec.run_fixed` keeps a memo)."""
    from repro_torch.lowering.ir import lower
    lp = lower(pipeline, types, params=params, column=column,
               datapath=datapath)
    return compile_backend(lp, backend, outputs=outputs, device=device)
