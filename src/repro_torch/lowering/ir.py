"""Typed per-stage program IR for plan-driven lowering.

The port's own copy of `repro.lowering.ir` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

`lower()` (see `repro_torch.lowering.lower_pipeline`) turns `(Pipeline,
BitwidthPlan)` into a `LoweredPipeline`: one `LoweredStage` per stage
carrying everything a backend needs to synthesize the stage's datapath —
quantized integer taps, beta-alignment shifts, the finishing rule
(dyadic round-half-even shift or one f64 scale multiply), per-axis halos,
sampling rates, saturation bounds, and per-phase datapaths (one set of
bounds per sampling-lattice residue, the paper §IV homogeneity clusters).

Datapath-kind selection is the load-bearing decision.  The bit-exactness
contract with the `run_fixed` per-pixel oracle (numpy f64) rests on two
facts:

  * an ``expr`` stage re-issues the oracle's IEEE-754 double ops in the
    identical order (`dsl.exec.eval_expr` is shared), so it is equal by
    construction;
  * an ``intlinear`` stage replaces the oracle's float tree with integer
    multiply-accumulates, which is equal **iff the oracle's float math was
    exact**: all taps are dyadic multiples of on-grid inputs and every
    partial sum stays below 2^53.  `_plan_intlinear` proves that bound
    from the input types before electing the integer path; anything it
    cannot prove falls back to ``expr``.

The finishing step after an integer accumulation:

  value = s * acc / 2^(w_beta + bmax),   q_out = rint(value * 2^beta_out)

  * dyadic s = sm/2^se  ->  q_out = round_half_even(acc * sm, t) with
    t = se + w_beta + bmax - beta_out (pure integer datapath);
  * otherwise  q_out = rint(f64(acc) * cscale) with cscale =
    s * 2^(beta_out - w_beta - bmax), exact because scaling a double by a
    power of two is lossless — one IEEE multiply, the same one the oracle
    issues.

**Narrow datapath re-election** (`lower(..., datapath="narrow")`) is the
real-hardware mode: the exact-mode election above happily hands out
int64 carriers and f64 expression datapaths, which no FPGA lane
holds natively.  Narrow mode re-elects every datapath int32/f32-first,
and only keeps a 64-bit resource when it can *prove* no narrower one is
bit-exact — recording each election (and each justified retention) in
the plan's provenance:

  * accumulator bounds are re-tightened per tap from the plan's
    per-phase columns (a tap that only ever lands on low-magnitude
    lattice residues is bounded by those residues' types, not the union
    column — edge clamps handled conservatively);
  * an accumulator whose tightened bound still exceeds `INT32_BUDGET`
    is *split* into two int32 partial accumulators (`carrier =
    "int32pair"`, taps partitioned by `acc_split`), combined by one wide
    add before the finishing rule — bit-equal because integer adds are
    associative and the combined value stays below 2^53;
  * an `expr` stage is demoted to f32 evaluation (`expr_dtype = "f32"`)
    when a value-grid walk over its tree proves every intermediate is a
    dyadic rational whose scaled magnitude fits a 24-bit mantissa — then
    every f32 op is exact, hence bit-identical to the oracle's f64 ops.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import BinOp, Const, Expr, Pipeline, Ref, Stage

Residue = Tuple[int, int]


class LoweringError(ValueError):
    """The pipeline (or shape) cannot be lowered by the requested backend."""


# ---------------------------------------------------------------------------
# linear-form matching (generalizes kernels/stencil/ops.py tap extraction)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tap:
    """One structural stencil tap: `w * input[(i+dy, j+dx)]`."""
    stage: str
    dy: int
    dx: int
    w: float


def match_linear(expr: Expr) -> Optional[Tuple[Tuple[Tap, ...], float]]:
    """Match `[Const(s) *] (sum/difference of [Const(w) *] Ref taps)`.

    This is exactly the shape `core.graph.stencil_expr` emits (plus bare
    linear point-wise stages like ``img2 - img1``), multi-input included.
    Returns (taps, scale) or None when the stage is not a linear stencil.
    """
    scale = 1.0
    body = expr
    if isinstance(body, BinOp) and body.op == "*" \
            and isinstance(body.left, Const) \
            and not isinstance(body.right, (Ref, Const)):
        scale = float(body.left.value)
        body = body.right
    taps: List[Tap] = []

    def go(n: Expr, sign: int) -> bool:
        if isinstance(n, BinOp) and n.op == "+":
            return go(n.left, sign) and go(n.right, sign)
        if isinstance(n, BinOp) and n.op == "-":
            return go(n.left, sign) and go(n.right, -sign)
        if isinstance(n, BinOp) and n.op == "*" \
                and isinstance(n.left, Const) and isinstance(n.right, Ref):
            r = n.right
            taps.append(Tap(r.stage, r.dy, r.dx, sign * float(n.left.value)))
            return True
        if isinstance(n, Ref):
            taps.append(Tap(n.stage, n.dy, n.dx, float(sign)))
            return True
        return False

    if not go(body, 1) or not taps:
        return None
    return tuple(taps), scale


def dyadic_weights(vals: Sequence[float], max_beta: int = 24
                   ) -> Optional[Tuple[List[int], int]]:
    """Smallest w_beta with every `v * 2^w_beta` an exact integer, else None.

    The exact-only core of `kernels.stencil.ops.quantize_weights` (which
    additionally accepts lossy rounding at its beta cap)."""
    for w_beta in range(max_beta + 1):
        sc = 1 << w_beta
        if all(float(v) * sc == int(v * sc) for v in vals):
            return [int(v * sc) for v in vals], w_beta
    return None


def dyadic_scale(s: float, max_num: int = 1 << 20,
                 max_exp: int = 64) -> Optional[Tuple[int, int]]:
    """`s == sm / 2^se` with a small odd-ish integer sm, else None."""
    if s == 0 or not math.isfinite(s):
        return None
    f = Fraction(s)          # exact: every float is p/2^k
    den = f.denominator
    if den & (den - 1) != 0:         # not a power of two (cannot happen for
        return None                  # floats, but keep the guard explicit)
    se = den.bit_length() - 1
    sm = f.numerator
    if abs(sm) > max_num or se > max_exp:
        return None
    return sm, se


# ---------------------------------------------------------------------------
# lowered stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntTap:
    """Beta-aligned integer tap: `W * q_in[(i+dy, j+dx)]` on scaled ints."""
    stage: str
    dy: int
    dx: int
    W: int


@dataclasses.dataclass
class PhaseSnap:
    """Per-phase datapaths: one output type per sampling-lattice residue.

    `int_ok` marks the common case where every residue shares the union
    column's beta — the residue split then only changes the saturation
    bounds, so the integer datapath re-clips per residue.  Mixed betas
    (possible with hand-built type maps) force the float path: the oracle
    re-snaps each residue's raw value onto a different grid.
    """
    lattice: Tuple[int, int]                     # (My, Mx)
    types: Dict[Residue, FixedPointType]
    int_ok: bool = True


@dataclasses.dataclass
class LoweredStage:
    name: str
    kind: str                        # "input" | "intlinear" | "expr"
    stage: Stage                     # original IR node (expr/stride/upsample)
    t: Optional[FixedPointType]      # union-column output type (None = float)
    halo: Tuple[int, int]            # per-axis (hy, hx)
    # -- intlinear datapath ---------------------------------------------------
    int_taps: Tuple[IntTap, ...] = ()
    sm: int = 1                      # dyadic finishing numerator
    t_shift: int = 0                 # dyadic finishing right-shift (may be <0)
    dyadic: bool = True
    cscale: float = 1.0              # f64 finishing multiplier (non-dyadic)
    carrier: str = "int64"           # accumulator ("int32"|"int32pair"|"int64")
    acc_bound: int = 0               # proved |accumulator| bound
    # int32pair: int_taps[:acc_split] / int_taps[acc_split:] accumulate in
    # separate int32 registers, combined by one wide add before finishing
    acc_split: int = 0
    # -- expr datapath --------------------------------------------------------
    expr_dtype: str = "f64"          # "f32" only under a narrow-mode proof
    # -- saturation -----------------------------------------------------------
    phase: Optional[PhaseSnap] = None
    # backends keep this stage's tile as f64 values instead of scaled ints
    # (untyped, wider than a double's mantissa, or residue-mixed-beta)
    store_float: bool = False
    # narrow-mode election record ("" in exact mode): the chosen datapath,
    # with the proof obligation that blocked anything narrower
    election: str = ""


@dataclasses.dataclass
class LoweredPipeline:
    """Topologically ordered typed program — what backends compile."""
    pipeline: Pipeline
    stages: Dict[str, LoweredStage]          # in topo order
    order: List[str]
    params: Dict[str, float]
    types: Dict[str, Optional[FixedPointType]]
    column: Optional[str] = None             # plan column, if plan-derived
    datapath: str = "exact"                  # "exact" | "narrow"

    def outputs(self) -> List[str]:
        return list(self.pipeline.outputs)

    def kinds(self) -> Dict[str, str]:
        return {n: s.kind for n, s in self.stages.items()}


# ---------------------------------------------------------------------------
# datapath planning
# ---------------------------------------------------------------------------

F64_EXACT = 1 << 53      # integer sums below this are exact IEEE doubles
F32_EXACT = 1 << 24      # scaled magnitudes below this are exact IEEE singles
INT32_BUDGET = 1 << 30


def _qabs(t: FixedPointType) -> int:
    return max(abs(t.int_min), t.int_max)


def _touched_residues(s: int, u: int, d: int, m: int) -> Optional[set]:
    """Row (or col) residues mod `m` a tap offset `d` can read, or None.

    The consumer reads input index `floor((y*s + d)/u)`; over one lattice
    period (`y` mod `m*u`) the unclamped indices hit a fixed residue set.
    Edge clamping is handled conservatively: a negative offset can clamp
    onto index 0 (residue 0, added); a positive offset can clamp onto
    `H-1`, whose residue is shape-dependent — unknown at lowering time,
    so the caller falls back to the union bound (None).
    """
    if m <= 1:
        return {0}
    res = {((y * s + d) // u) % m for y in range(m * u)}
    if d < 0:
        res.add(0)
    if d > 0:
        return None
    return res


def _tap_qabs_narrow(st: Stage, tp: Tap, t_in: FixedPointType,
                     phase_in: Optional["PhaseSnap"]) -> int:
    """Tightened |q| bound for one tap from the input's per-phase types.

    Sound because the runtime (every backend and the oracle alike) clips
    the input stage per lattice residue, so a stored value at residue
    (ry, rx) obeys that residue's saturation bounds.
    """
    if phase_in is None or not phase_in.int_ok:
        return _qabs(t_in)
    my, mx = phase_in.lattice
    ry = _touched_residues(st.stride[0], st.upsample[0], tp.dy, my)
    rx = _touched_residues(st.stride[1], st.upsample[1], tp.dx, mx)
    if ry is None or rx is None:
        return _qabs(t_in)
    best = 0
    for a in ry:
        for b in rx:
            t_ph = phase_in.types.get((a, b), t_in)
            best = max(best, _qabs(t_ph))
    return best


def _split_int32(tap_bounds: List[int]
                 ) -> Optional[Tuple[List[int], int]]:
    """2-partition tap indices so each partial sum stays under the int32
    budget.  Returns `(reordered_indices, split_at)` — taps before the
    split accumulate in one int32 register, the rest in the other — or
    None when no split exists.  Integer adds are associative and
    commutative, so any regrouping is bit-exact."""
    if len(tap_bounds) < 2:
        return None
    order = sorted(range(len(tap_bounds)), key=lambda i: -tap_bounds[i])
    a: List[int] = []
    b: List[int] = []
    sa = sb = 0
    for i in order:
        if sa <= sb:
            a.append(i)
            sa += tap_bounds[i]
        else:
            b.append(i)
            sb += tap_bounds[i]
    if sa >= INT32_BUDGET or sb >= INT32_BUDGET or not a or not b:
        return None
    return a + b, len(a)


def _expr_fits_f32(st: Stage, t_out: Optional[FixedPointType],
                   in_types: Dict[str, Optional[FixedPointType]],
                   float_stored: set,
                   phase: Optional["PhaseSnap"]) -> Optional[str]:
    """Proof that f32 evaluation of `st.expr` is bit-identical to f64.

    Walks the tree tracking an exact dyadic value grid `(bound, e)`:
    every node's value is `k * 2^-e` with `|k| <= bound`.  When every
    node keeps `bound < 2^24` (and `e` well inside the exponent range),
    each op's result is exactly representable in BOTH f32 and f64, so
    neither rounds — the two evaluations are equal, and the final snap
    (`rint` after a lossless power-of-two rescale, clip against
    f32-exact bounds) is the same single rounding the oracle performs.

    Returns None when the proof succeeds, else the retention reason.
    """
    if t_out is None:
        return "untyped output"
    if phase is not None:
        return "phase-split residues re-snap per lattice residue"
    if _qabs(t_out) >= F32_EXACT:
        return (f"output grid needs "
                f"{_qabs(t_out).bit_length()} magnitude bits")
    if abs(t_out.beta) > 60:
        return "output beta outside f32 exponent headroom"

    class _No(Exception):
        pass

    def fail(msg: str):
        raise _No(msg)

    def chk(b: int, e: int) -> Tuple[int, int]:
        if b >= F32_EXACT:
            fail(f"a node needs {b.bit_length()} magnitude bits")
        if e > 60:
            fail("a node's beta exceeds f32 exponent headroom")
        return b, e

    def go(n: Expr) -> Tuple[int, int]:
        from repro_torch.core.graph import Call, Cmp, ParamRef, Pow, Select
        if isinstance(n, Const):
            if n.value == 0:
                return 0, 0
            ds = dyadic_scale(float(n.value), max_num=F32_EXACT - 1,
                              max_exp=60)
            if ds is None:
                fail(f"constant {n.value!r} is not f32-exact")
            return chk(abs(ds[0]), ds[1])
        if isinstance(n, Ref):
            t = in_types.get(n.stage)
            if t is None:
                fail(f"input {n.stage!r} is untyped")
            if n.stage in float_stored:
                fail(f"input {n.stage!r} is float-stored")
            return chk(_qabs(t), t.beta)
        if isinstance(n, ParamRef):
            fail(f"runtime parameter {n.name!r} has no proven grid")
        if isinstance(n, BinOp):
            if n.op == "/":
                fail("division rounds")
            (bl, el), (br, er) = go(n.left), go(n.right)
            if n.op == "*":
                return chk(bl * br, el + er)
            e = max(el, er)
            return chk((bl << (e - el)) + (br << (e - er)), e)
        if isinstance(n, Pow):
            b, e = go(n.base)
            if n.n < 0:
                fail("negative power rounds")
            return chk(b ** n.n, e * n.n)
        if isinstance(n, Call):
            if n.fn == "sqrt":
                fail("sqrt rounds")
            gs = [go(a) for a in n.args]
            e = max(ee for _, ee in gs)
            return chk(max(bb << (e - ee) for bb, ee in gs), e)
        if isinstance(n, Cmp):
            go(n.left)
            go(n.right)
            return 1, 0      # exact compare of exact values
        if isinstance(n, Select):
            go(n.cond)
            gs = [go(n.then), go(n.other)]
            e = max(ee for _, ee in gs)
            return chk(max(bb << (e - ee) for bb, ee in gs), e)
        fail(f"unsupported node {type(n).__name__}")

    try:
        go(st.expr)
    except _No as exc:
        return str(exc)
    return None


def _plan_intlinear(st: Stage, taps: Tuple[Tap, ...], scale: float,
                    t_out: FixedPointType,
                    in_types: Dict[str, Optional[FixedPointType]],
                    narrow: bool = False,
                    in_phases: Optional[Dict[str, "PhaseSnap"]] = None):
    """Integer-datapath parameters, or None when exactness is unprovable.

    With `narrow=True` the carrier election is int32-first: accumulator
    bounds are tightened per tap from the inputs' per-phase types, and a
    bound over `INT32_BUDGET` is split across an int32 pair before an
    int64 carrier is conceded (the retention reason lands in `election`).
    """
    if any(in_types.get(tp.stage) is None for tp in taps):
        return None
    w = dyadic_weights([tp.w for tp in taps])
    if w is None:
        return None
    wq, w_beta = w
    bmax = max(in_types[tp.stage].beta for tp in taps)
    int_taps: List[IntTap] = []
    tap_bounds: List[int] = []
    for tp, q in zip(taps, wq):
        t_in = in_types[tp.stage]
        W = q << (bmax - t_in.beta)
        if W == 0:
            continue
        qa = (_tap_qabs_narrow(st, tp, t_in, (in_phases or {}).get(tp.stage))
              if narrow else _qabs(t_in))
        int_taps.append(IntTap(tp.stage, tp.dy, tp.dx, W))
        tap_bounds.append(abs(W) * qa)
    bound = sum(tap_bounds)
    if bound >= F64_EXACT:
        # the oracle's own float sum may round — only `expr` replays that
        return None
    ds = dyadic_scale(scale)
    if ds is not None:
        sm, se = ds
        t_shift = se + w_beta + bmax - t_out.beta
        # the oracle computes fl(s * sum): exact only while |sm * acc|
        # fits a double's mantissa — beyond that the float tree rounds and
        # only the `expr` kind can replay it.  The carrier must hold the
        # *finished* value too: a negative t_shift left-shifts the product
        # (beta_out deeper than the input grid), so bound the post-shift
        # magnitude, not just the accumulator.
        prod = bound * abs(sm)
        if t_shift < 0:
            fin = prod << (-t_shift)
        else:
            fin = prod + (1 << max(t_shift - 1, 0))
        if fin >= F64_EXACT:
            return None
        plan = dict(int_taps=tuple(int_taps), sm=sm, t_shift=t_shift,
                    dyadic=True, cscale=1.0, acc_bound=bound)
        gate = fin       # the finishing multiply/shift runs in-carrier
    else:
        # non-dyadic scale: one f64 multiply finishes the stage, bit-equal
        # to the oracle's fl(scale * sum) (power-of-two rescale is
        # lossless); the carrier only has to hold the raw accumulator
        cscale = scale * 2.0 ** (t_out.beta - w_beta - bmax)
        plan = dict(int_taps=tuple(int_taps), sm=1, t_shift=0, dyadic=False,
                    cscale=cscale, acc_bound=bound)
        gate = bound
    if gate < INT32_BUDGET:
        plan.update(carrier="int32", acc_split=0,
                    election="int32" if narrow else "")
        return plan
    if not narrow:
        plan.update(carrier="int64", acc_split=0)
        return plan
    # narrow mode: split the accumulation across an int32 pair when every
    # partial sum fits; the widening combine + finish run in int64
    if bound < INT32_BUDGET:
        sp = (list(range(len(int_taps))), len(int_taps))
    else:
        sp = _split_int32(tap_bounds)
    if sp is not None:
        order_ix, k = sp
        plan["int_taps"] = tuple(int_taps[i] for i in order_ix)
        plan.update(
            carrier="int32pair", acc_split=k,
            election=(f"int32pair: acc bound 2^{bound.bit_length()} split "
                      f"{k}+{len(int_taps) - k} taps under INT32_BUDGET"))
        return plan
    why = ("a single tap's bound exceeds INT32_BUDGET"
           if max(tap_bounds) >= INT32_BUDGET
           else "no 2-way tap split fits INT32_BUDGET")
    plan.update(carrier="int64", acc_split=0,
                election=(f"int64 kept: acc bound "
                          f"2^{bound.bit_length()} — {why}"))
    return plan


def _phase_snap(t_union: FixedPointType, entry) -> PhaseSnap:
    (my, mx), tmap = entry
    return PhaseSnap(lattice=(my, mx), types=dict(tmap),
                     int_ok=all(t.beta == t_union.beta
                                for t in tmap.values()))


def lower(pipeline: Pipeline, types, params: Optional[Dict[str, float]] = None,
          column: Optional[str] = None,
          datapath: str = "exact") -> LoweredPipeline:
    """Lower `(Pipeline, BitwidthPlan-or-TypeMap)` into a typed program.

    Mirrors `dsl.exec.run_fixed`'s duck-typed plan handling: a plan
    supplies its `column` types plus per-phase sub-types; a plain dict is
    a per-stage union type map.

    `datapath="narrow"` turns on int32/f32-first re-election (see the
    module docstring); every election — and every justified 64-bit
    retention — is recorded on the stages and, when `types` is a
    `BitwidthPlan`, appended to the plan column's provenance notes.
    """
    if datapath not in ("exact", "narrow"):
        raise LoweringError(f"unknown datapath mode {datapath!r}; "
                            "expected 'exact' or 'narrow'")
    narrow = datapath == "narrow"
    phase_types = {}
    col = column
    plan_obj = None
    if hasattr(types, "phase_types"):            # BitwidthPlan (duck-typed)
        plan_obj = types
        phase_types = plan_obj.phase_types(column) or {}
        col = column or getattr(plan_obj, "default_column", None)
        types = plan_obj.types(column)
    tmap: Dict[str, Optional[FixedPointType]] = {
        n: types.get(n) for n in pipeline.stages}
    stages: Dict[str, LoweredStage] = {}
    order = pipeline.topo_order()
    # stages whose values backends must keep as floats (no single
    # scaled-int grid): untyped, wider than a double's mantissa, or
    # residue-mixed-beta.  Their consumers cannot take the integer path.
    float_stored: set = set()
    for name in order:
        st = pipeline.stages[name]
        t_out = tmap.get(name)
        halo = st.halo_yx()
        phase = None
        if name in phase_types and t_out is not None:
            phase = _phase_snap(t_out, phase_types[name])
        sf = (t_out is None or t_out.width > 52
              or (phase is not None and not phase.int_ok))
        if sf:
            float_stored.add(name)
        if st.is_input:
            stages[name] = LoweredStage(name=name, kind="input", stage=st,
                                        t=t_out, halo=(0, 0),
                                        store_float=sf)
            continue
        lin = match_linear(st.expr) if t_out is not None else None
        plan_int = None
        if lin is not None and not sf \
                and not any(i in float_stored for i in st.inputs):
            plan_int = _plan_intlinear(
                st, lin[0], lin[1], t_out,
                {i: tmap.get(i) for i in st.inputs},
                narrow=narrow,
                in_phases={i: stages[i].phase for i in st.inputs})
        if plan_int is not None:
            stages[name] = LoweredStage(name=name, kind="intlinear",
                                        stage=st, t=t_out, halo=halo,
                                        phase=phase, **plan_int)
        else:
            expr_dtype, election = "f64", ""
            if narrow:
                reason = _expr_fits_f32(st, t_out, tmap, float_stored,
                                        phase)
                if reason is None:
                    expr_dtype, election = "f32", "f32"
                else:
                    election = f"f64 kept: {reason}"
            stages[name] = LoweredStage(name=name, kind="expr", stage=st,
                                        t=t_out, halo=halo, phase=phase,
                                        store_float=sf,
                                        expr_dtype=expr_dtype,
                                        election=election)
    if narrow and plan_obj is not None \
            and hasattr(plan_obj, "record_election"):
        plan_obj.record_election(col, _election_notes(pipeline.name, stages))
    return LoweredPipeline(pipeline=pipeline, stages=stages, order=order,
                           params=dict(params or {}), types=tmap, column=col,
                           datapath=datapath)


def _election_notes(pipe_name: str,
                    stages: Dict[str, LoweredStage]) -> List[str]:
    """Provenance lines for a narrow-mode lowering: one census line plus
    one justification line per retained 64-bit datapath."""
    labels = []
    details = []
    for name, ls in stages.items():
        if ls.stage.is_input:
            continue
        label = ls.carrier if ls.kind == "intlinear" else ls.expr_dtype
        labels.append(f"{name}={label}")
        if ls.election.startswith(("int64 kept", "f64 kept")):
            details.append(f"datapath[narrow] {pipe_name}.{name}: "
                           f"{ls.election}")
    return [f"datapath[narrow] {pipe_name}: " + ", ".join(labels)] + details
