"""Whole-DAG constraint encoding — the front half of `repro_torch.smt`.

The per-stage interval walk (`core.range_analysis`) deliberately discards
cross-stage correlations: every `Ref` leaf materializes the producer's
*combined* range as a fresh signal.  The paper's SMT analysis (§V-B) instead
encodes the whole stage DAG as one constraint system over shared input-pixel
and parameter variables, so `img - blur(img)` knows both operands read the
same pixels.

`encode_stage` flattens the transitive expression DAG feeding one stage into
a flat CSP:

  * each distinct input pixel ``(stage, dy, dx)`` is ONE variable — taps at
    the same offset share it (correlation recovered), taps at different
    offsets stay independent (the §IV-B homogeneity model);
  * each scalar parameter is one shared variable;
  * every operator application becomes an auxiliary variable with a
    defining constraint ``v = op(args)``;
  * flattening is *budgeted*: past ``max_vars``, and across re/up-sampling
    stages (where tap alignment is data-layout dependent and sharing would
    be unsound), a producer instance becomes a free "cut" variable bounded
    by the best already-known sound range for that stage.  Cuts are what
    make the analysis compositional on deep pipelines: `analyze_smt`
    tightens stages in topological order, so cut bounds inherit earlier
    SMT results rather than raw interval ones.

**Phase-split encoding** (`encode_stage_phases`) removes the sampling cuts:
across stride/upsample stages the §IV homogeneity classes are exactly the
output-phase residues mod the pipeline's sampling lattice, so fixing the
root's output coordinate to one residue makes every tap→source coordinate
map a concrete integer (floor) map — the expansion through sampled
producers becomes exactly aligned and sharing is sound again.  One CSP per
phase; the stage range is the union over phases (`optimize` solves them as
one multi-phase query, `solver.decide_multi`).

Everything downstream (HC4 contraction, branch-and-prune, dichotomic
tightening) operates on this CSP; see `repro_torch.smt.solver` /
`.optimize`.

The port's own copy of `repro.smt.encoder`: the CSP and its `Program`
are host data, field for field the reference's (numpy op table, the same
dtypes).  `device_program` adds what the batched engine needs on a
device: the program's constants and base-variable index as tensors
there, made once per device and cached on the program beside the CSP's
own `_program` cache.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                              Pipeline, Pow, Ref, Select)
from repro_torch.core.interval import Interval

# operand encoding: ("v", var_id) or ("c", float)
Operand = Tuple[str, float]

VAR, CONST = "v", "c"


def var(i: int) -> Operand:
    return (VAR, i)


def const(x: float) -> Operand:
    return (CONST, float(x))


@dataclasses.dataclass(frozen=True)
class Def:
    """Defining constraint of one auxiliary variable: ``v = op(args)``.

    ops: ``+ - * / pow abs sqrt min max select``.  For ``pow`` the exponent
    is in `n`; for ``select`` args are ``(cond_l, cond_r, then, other)`` and
    `cmp` holds the comparison operator of the condition.
    """
    op: str
    args: Tuple[Operand, ...]
    n: int = 0
    cmp: str = ""


class CSP:
    """Flat constraint system over interval-boxed real variables."""

    def __init__(self):
        self.names: List[str] = []
        self.kinds: List[str] = []          # input | param | cut | aux
        self.init: List[Interval] = []      # initial box
        self.defs: List[Optional[Def]] = [] # aux vars only; operands < var id

    # -- construction -------------------------------------------------------
    def new_var(self, name: str, iv: Interval, kind: str,
                d: Optional[Def] = None) -> int:
        self.names.append(name)
        self.kinds.append(kind)
        self.init.append(iv)
        self.defs.append(d)
        return len(self.names) - 1

    # -- queries ------------------------------------------------------------
    @property
    def nvars(self) -> int:
        return len(self.names)

    def base_vars(self) -> List[int]:
        """Free variables of the system (everything without a definition)."""
        return [i for i, d in enumerate(self.defs) if d is None]

    def is_linear(self) -> bool:
        """True when every def is affine in the base vars (then one affine
        sweep computes the exact range hull — no search needed)."""
        for d in self.defs:
            if d is None:
                continue
            if d.op in ("+", "-"):
                continue
            if d.op == "*" and (d.args[0][0] == CONST or d.args[1][0] == CONST):
                continue
            if d.op == "/" and d.args[1][0] == CONST:
                continue
            return False
        return True

    def cond_dependent_vars(self) -> set:
        """Base vars some Select condition depends on (transitively).

        The objective has jump discontinuities in these, so monotonicity
        fixing must exclude them (see solver._monotone_fix).
        """
        # deps[v] = set of base vars feeding v
        deps: List[set] = [set() for _ in range(self.nvars)]
        for i, d in enumerate(self.defs):
            if d is None:
                deps[i].add(i)
            else:
                for (tag, val) in d.args:
                    if tag == VAR:
                        deps[i] |= deps[int(val)]
        out: set = set()
        for d in self.defs:
            if d is not None and d.op == "select":
                for (tag, val) in d.args[:2]:
                    if tag == VAR:
                        out |= deps[int(val)]
        return out


_CMP_OPS = {"<", "<=", ">", ">="}


def _is_sampled(pipeline: Pipeline, name: str) -> bool:
    st = pipeline.stages[name]
    return st.stride != (1, 1) or st.upsample != (1, 1)


def closure_is_sampled(pipeline: Pipeline, stage: str) -> bool:
    """True when `stage` or any transitive producer is strided/upsampled —
    i.e. when the alignment-blind encoder would cut (and phase-split can
    recover sharing)."""
    seen = set()
    stack = [stage]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        if _is_sampled(pipeline, n):
            return True
        st = pipeline.stages[n]
        if st.expr is not None:
            stack.extend(r.stage for r in st.refs())
    return False


def sampling_lattice(pipeline: Pipeline, stage: str
                     ) -> Optional[Tuple[int, int]]:
    """Per-axis phase modulus (My, Mx) of the DAG feeding `stage`.

    Walking from the root, a producer read through a stage with stride `s`
    and upsample `u` advances `s/u` source pixels per root pixel; the
    accumulated per-stage rates are exact rationals.  Choosing the modulus
    as the lcm of all rate denominators makes every per-stage coordinate
    step (`M * rate`) an integer, which is precisely the condition for the
    floor tap→source maps to be translation-invariant within one output
    residue class — each phase CSP then models *every* pixel of its class.

    Returns None when two paths reach the same producer at different rates
    (no uniform lattice exists; callers fall back to the blind encoding).
    """
    rates: Dict[str, Tuple[Fraction, Fraction]] = {
        stage: (Fraction(1), Fraction(1))}
    stack = [stage]
    while stack:
        name = stack.pop()
        st = pipeline.stages[name]
        if st.is_input or st.expr is None:
            continue
        ry, rx = rates[name]
        child_rate = (ry * st.stride[0] / st.upsample[0],
                      rx * st.stride[1] / st.upsample[1])
        for child in dict.fromkeys(r.stage for r in st.refs()):
            if child in rates:
                if rates[child] != child_rate:
                    return None
            else:
                rates[child] = child_rate
                stack.append(child)
    my = mx = 1
    for ry, rx in rates.values():
        my = my * ry.denominator // math.gcd(my, ry.denominator)
        mx = mx * rx.denominator // math.gcd(mx, rx.denominator)
    return my, mx


def _flatten(pipeline: Pipeline, stage: str,
             stage_bounds: Dict[str, Interval],
             input_ranges: Optional[Dict[str, Interval]],
             max_vars: int,
             origin: Optional[Tuple[int, int]]) -> Tuple[CSP, int]:
    """Shared flattening core.

    `origin=None` is the alignment-blind mode (classic `encode_stage`):
    tap offsets accumulate additively, sampled producers are cut, and an
    upsampled root stage cuts each tap individually.  `origin=(ry, rx)`
    is phase-split mode: coordinates are absolute on each stage's own
    output grid, the root sits at its phase residue, and every Ref maps
    through the exact `(y*stride + dy) // upsample` source coordinate —
    sampled producers expand and share like any other stage.
    """
    phase_mode = origin is not None
    csp = CSP()
    inst: Dict[Tuple[str, int, int], Operand] = {}
    params: Dict[str, int] = {}

    def cut(name: str, dy: int, dx: int, tag: str = "") -> Operand:
        return var(csp.new_var(f"{name}[{dy},{dx}]{tag}", stage_bounds[name],
                               "cut"))

    def instantiate(name: str, dy: int, dx: int) -> Operand:
        key = (name, dy, dx)
        if key in inst:
            return inst[key]
        st = pipeline.stages[name]
        if st.is_input:
            iv = (input_ranges or {}).get(name, st.input_range)
            if iv is None:
                raise ValueError(f"input stage {name!r} has no declared range")
            op = var(csp.new_var(f"{name}[{dy},{dx}]", iv, "input"))
        elif (not phase_mode and name != stage
              and _is_sampled(pipeline, name)):
            # blind mode, sampled producer: tap alignment is not uniform
            # across output pixels, so sharing its expansion would be
            # unsound — cut.
            op = cut(name, dy, dx)
        elif csp.nvars >= max_vars:
            op = cut(name, dy, dx)
        else:
            # blind mode only: nearest-expand upsampling makes the *reading*
            # stage's tap->source mapping alignment-dependent — cut each tap
            # individually.  Phase mode resolves the mapping exactly instead.
            cut_taps = not phase_mode and st.upsample != (1, 1)
            op = encode_expr(st.expr, st, dy, dx, cut_taps)
            # the expansion defines the value, but the producer's best known
            # sound range is extra information the flattened expression may
            # not imply (it can come from earlier SMT tightening): meet it
            # into the instance's initial box.  Applied uniformly: constant-
            # folded expansions are wrapped in an aux var first, so they
            # benefit from earlier tightening exactly like VAR roots.
            b = stage_bounds.get(name)
            if b is not None:
                if op[0] == CONST:
                    op = var(csp.new_var(
                        f"{name}[{dy},{dx}]", Interval.point(op[1]), "aux",
                        Def("+", (const(op[1]), const(0.0)))))
                i = int(op[1])
                lo = max(csp.init[i].lo, b.lo)
                hi = min(csp.init[i].hi, b.hi)
                if lo <= hi:
                    csp.init[i] = Interval(lo, hi)
        inst[key] = op
        return op

    def aux(name: str, d: Def) -> Operand:
        return var(csp.new_var(name, Interval.top(), "aux", d))

    def encode_expr(e: Expr, st, Y: int, X: int,
                    cut_taps: bool = False) -> Operand:
        if isinstance(e, Const):
            return const(e.value)
        if isinstance(e, Ref):
            if phase_mode:
                # exact tap->source map: output (Y, X) of `st` reads its
                # producer at the decimated-then-expanded source coordinate
                cy = (Y * st.stride[0] + e.dy) // st.upsample[0]
                cx = (X * st.stride[1] + e.dx) // st.upsample[1]
                return instantiate(e.stage, cy, cx)
            if cut_taps:
                key = (e.stage, Y + e.dy, X + e.dx)
                if key not in inst:
                    inst[key] = cut(e.stage, Y + e.dy, X + e.dx, "~up")
                return inst[key]
            return instantiate(e.stage, Y + e.dy, X + e.dx)
        if isinstance(e, ParamRef):
            if e.name not in params:
                params[e.name] = csp.new_var(
                    e.name, pipeline.params[e.name], "param")
            return var(params[e.name])
        if isinstance(e, BinOp):
            l = encode_expr(e.left, st, Y, X, cut_taps)
            r = encode_expr(e.right, st, Y, X, cut_taps)
            if l[0] == CONST and r[0] == CONST:
                return const(_fold(e.op, l[1], r[1]))
            return aux(e.op, Def(e.op, (l, r)))
        if isinstance(e, Pow):
            b = encode_expr(e.base, st, Y, X, cut_taps)
            if b[0] == CONST:
                return const(b[1] ** e.n)
            return aux(f"pow{e.n}", Def("pow", (b,), n=e.n))
        if isinstance(e, Call):
            args = tuple(encode_expr(a, st, Y, X, cut_taps) for a in e.args)
            return aux(e.fn, Def(e.fn, args))
        if isinstance(e, Select):
            c = e.cond
            if not isinstance(c, Cmp) or c.op not in _CMP_OPS:
                raise ValueError(f"unsupported select condition {c!r}")
            cl = encode_expr(c.left, st, Y, X, cut_taps)
            cr = encode_expr(c.right, st, Y, X, cut_taps)
            t = encode_expr(e.then, st, Y, X, cut_taps)
            o = encode_expr(e.other, st, Y, X, cut_taps)
            return aux("select", Def("select", (cl, cr, t, o), cmp=c.op))
        raise TypeError(f"unknown expr node {type(e)}")

    oy, ox = origin if phase_mode else (0, 0)
    root = instantiate(stage, oy, ox)
    if root[0] == CONST:
        root = var(csp.new_var("root", Interval.point(root[1]), "aux",
                               Def("+", (const(root[1]), const(0.0)))))
    return csp, int(root[1])


def encode_stage(pipeline: Pipeline, stage: str,
                 stage_bounds: Dict[str, Interval],
                 input_ranges: Optional[Dict[str, Interval]] = None,
                 max_vars: int = 400) -> Tuple[CSP, int]:
    """Flatten the DAG feeding `stage` into a CSP; returns (csp, root_var).

    `stage_bounds` must hold a *sound* range for every stage (interval seed,
    progressively replaced by SMT-tightened ones) — used to bound cut vars.
    This is the alignment-blind encoding (sampled producers are cut); see
    `encode_stage_phases` for the phase-split alternative.
    """
    return _flatten(pipeline, stage, stage_bounds, input_ranges, max_vars,
                    origin=None)


def encode_stage_phase(pipeline: Pipeline, stage: str,
                       origin: Tuple[int, int],
                       stage_bounds: Dict[str, Interval],
                       input_ranges: Optional[Dict[str, Interval]] = None,
                       max_vars: int = 400) -> Tuple[CSP, int]:
    """Exactly-aligned CSP for the output pixels `origin (mod lattice)`."""
    return _flatten(pipeline, stage, stage_bounds, input_ranges, max_vars,
                    origin=origin)


def encode_stage_phases(pipeline: Pipeline, stage: str,
                        stage_bounds: Dict[str, Interval],
                        input_ranges: Optional[Dict[str, Interval]] = None,
                        max_vars: int = 400,
                        max_phases: int = 16
                        ) -> Optional[List[Tuple[CSP, int]]]:
    """Phase-split encoding: one exactly-aligned CSP per output-phase
    residue `(ry, rx)` mod the sampling lattice; the stage range is the
    union over phases.

    Returns None (callers fall back to the alignment-blind `encode_stage`)
    when no uniform lattice exists or the phase count exceeds `max_phases`
    — the budget guard for pathologically deep sampling chains.
    """
    lat = sampling_lattice(pipeline, stage)
    if lat is None:
        return None
    my, mx = lat
    if my * mx > max_phases:
        return None
    return [encode_stage_phase(pipeline, stage, (ry, rx), stage_bounds,
                               input_ranges, max_vars)
            for ry in range(my) for rx in range(mx)]


# ---------------------------------------------------------------------------
# program compilation — the batched-box evaluator's input format
# ---------------------------------------------------------------------------
#
# The scalar solver walks `csp.defs` box-by-box through Python dicts/lists.
# The batched evaluator (solver.hc4_batch & friends) instead runs a whole
# (N, nvars) frontier of lo/hi arrays through one flat numpy op table; this
# section compiles a CSP into that table exactly once (cached on the CSP).

OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_POW = 0, 1, 2, 3, 4
OP_ABS, OP_SQRT, OP_MIN, OP_MAX, OP_SELECT = 5, 6, 7, 8, 9

OPCODES = {"+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_DIV,
           "pow": OP_POW, "abs": OP_ABS, "sqrt": OP_SQRT,
           "min": OP_MIN, "max": OP_MAX, "select": OP_SELECT}

CMP_CODES = {"<": 0, "<=": 1, ">": 2, ">=": 3}


@dataclasses.dataclass
class Program:
    """One CSP compiled to a flat, topo-ordered numpy op table.

    Row ``k`` defines variable ``def_var[k]`` as ``opcode[k]`` applied to up
    to four operands; operand slot ``j`` is variable ``argv[k, j]`` when
    ``argv[k, j] >= 0``, else the constant ``argc[k, j]``.  Rows are in
    increasing ``def_var`` order, so a single forward pass is an evaluation
    of the whole DAG (operand ids are always < the defined id).
    """
    nvars: int
    def_var: np.ndarray        # (nd,)  int32 — id of the defined variable
    opcode: np.ndarray         # (nd,)  int8
    argv: np.ndarray           # (nd,4) int32 operand var id; -1 = constant
    argc: np.ndarray           # (nd,4) float64 constant (0 where var)
    nargs: np.ndarray          # (nd,)  int8 number of live operand slots
    pow_n: np.ndarray          # (nd,)  int16 exponent (pow rows)
    cmp: np.ndarray            # (nd,)  int8 comparison code (select rows)
    init_lo: np.ndarray        # (nvars,) initial box
    init_hi: np.ndarray        # (nvars,)
    base: np.ndarray           # (nbase,) int32 base (free) variable ids
    frozen: np.ndarray         # (nvars,) bool — cond-dependent base vars
    # static split-candidate table, scalar `_split_candidates` order: sign
    # splits of zero-straddling mul/div/even-pow operands and select
    # thresholds, nearest the root first.  Columns: (var, split_at,
    # is_select_threshold); sign splits have split_sel=False and split at 0.
    split_var: np.ndarray      # (ns,) int32
    split_at: np.ndarray       # (ns,) float64 (select threshold, else 0.0)
    split_sel: np.ndarray      # (ns,) bool

    @property
    def ndefs(self) -> int:
        return len(self.def_var)


_N_SLOTS = 4


def compile_csp(csp: CSP) -> Program:
    """Compile (and cache) the flat numpy program for `csp`."""
    prog = getattr(csp, "_program", None)
    if prog is not None:
        return prog
    rows = [(i, d) for i, d in enumerate(csp.defs) if d is not None]
    nd = len(rows)
    def_var = np.empty(nd, np.int32)
    opcode = np.empty(nd, np.int8)
    argv = np.full((nd, _N_SLOTS), -1, np.int32)
    argc = np.zeros((nd, _N_SLOTS), np.float64)
    nargs = np.zeros(nd, np.int8)
    pow_n = np.zeros(nd, np.int16)
    cmp = np.zeros(nd, np.int8)
    for k, (i, d) in enumerate(rows):
        def_var[k] = i
        opcode[k] = OPCODES[d.op]
        nargs[k] = len(d.args)
        pow_n[k] = d.n
        if d.op == "select":
            cmp[k] = CMP_CODES[d.cmp]
        for j, (tag, val) in enumerate(d.args):
            if tag == VAR:
                argv[k, j] = int(val)
            else:
                argc[k, j] = float(val)
    init_lo = np.array([iv.lo for iv in csp.init], np.float64)
    init_hi = np.array([iv.hi for iv in csp.init], np.float64)
    base = np.array(csp.base_vars(), np.int32)
    frozen = np.zeros(csp.nvars, bool)
    for i in csp.cond_dependent_vars():
        frozen[i] = True

    # static split candidates, mirroring solver._split_candidates' priority
    # order (reverse def order; within a def: mul/div slots, even-pow
    # operand, select-vs-constant thresholds).  Deduplication is per-box at
    # runtime (only the first qualifying row fires), so repeats are fine.
    s_var: List[int] = []
    s_at: List[float] = []
    s_sel: List[bool] = []
    for i in range(csp.nvars - 1, -1, -1):
        d = csp.defs[i]
        if d is None:
            continue
        if d.op in ("*", "/"):
            cand = [d.args[0], d.args[1]]
        elif d.op == "pow" and d.n % 2 == 0:
            cand = [d.args[0]]
        elif d.op == "select":
            for a, b in ((d.args[0], d.args[1]), (d.args[1], d.args[0])):
                if a[0] == VAR and b[0] == CONST:
                    s_var.append(int(a[1]))
                    s_at.append(float(b[1]))
                    s_sel.append(True)
            continue
        else:
            continue
        for o in cand:
            if o[0] == VAR:
                s_var.append(int(o[1]))
                s_at.append(0.0)
                s_sel.append(False)
    prog = Program(
        nvars=csp.nvars, def_var=def_var, opcode=opcode, argv=argv,
        argc=argc, nargs=nargs, pow_n=pow_n, cmp=cmp,
        init_lo=init_lo, init_hi=init_hi, base=base, frozen=frozen,
        split_var=np.array(s_var, np.int32),
        split_at=np.array(s_at, np.float64),
        split_sel=np.array(s_sel, bool))
    csp._program = prog
    return prog


@dataclasses.dataclass
class DeviceProgram:
    """A `Program`'s op table as Python rows for the host loop that drives
    the batched engine, and its tensors on one device.

    ``rows[k]`` is ``(def_var, opcode, argv, pow_n, cmp)`` of row ``k``
    as Python ints (``argv`` a 4-tuple, -1 = constant);
    ``consts[k][j]`` is the constant of slot ``j`` as a 0-dim f64 tensor
    on the device (None where the slot is a variable), so every operand
    the engine meets is a tensor there; ``base`` indexes the base
    variables on the device; ``split`` is the static split-candidate
    table as ``(var, split_at, is_select_threshold)`` rows.
    """
    rows: List[Tuple[int, int, Tuple[int, ...], int, int]]
    consts: List[Tuple[Optional[torch.Tensor], ...]]
    base: torch.Tensor         # (nbase,) int64 index
    base_list: List[int]
    frozen: List[bool]
    split: List[Tuple[int, float, bool]]


def device_program(prog: Program, device) -> DeviceProgram:
    """`prog` on `device`, made once per device and cached on `prog`."""
    device = torch.device(device)
    cache = prog.__dict__.setdefault("_on", {})
    dp = cache.get(device)
    if dp is not None:
        return dp
    argc = torch.from_numpy(prog.argc).to(device)
    rows, consts = [], []
    for k in range(prog.ndefs):
        av = tuple(int(a) for a in prog.argv[k])
        rows.append((int(prog.def_var[k]), int(prog.opcode[k]), av,
                     int(prog.pow_n[k]), int(prog.cmp[k])))
        consts.append(tuple(argc[k, j] if av[j] < 0 else None
                            for j in range(_N_SLOTS)))
    dp = DeviceProgram(
        rows=rows, consts=consts,
        base=torch.from_numpy(prog.base.astype(np.int64)).to(device),
        base_list=[int(i) for i in prog.base],
        frozen=[bool(f) for f in prog.frozen],
        split=[(int(v), float(a), bool(sel)) for v, a, sel in
               zip(prog.split_var, prog.split_at, prog.split_sel)])
    cache[device] = dp
    return dp


def _fold(op: str, a: float, b: float) -> float:
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b if b != 0 else float("inf")
    raise ValueError(op)
