"""Branch-and-prune satisfiability core — the back half of `repro_torch.smt`.

Answers the paper's §V-B queries — "can stage `s` exceed threshold T?" —
over the CSP produced by `repro_torch.smt.encoder`, without any external
solver:

  * **HC4 contraction**: forward interval evaluation of every defining
    constraint, then backward projection (inverse transfer functions) from
    the queried bound onto the free variables, iterated to a fixpoint;
  * **affine relaxation**: one affine-arithmetic sweep with a noise symbol
    per free variable, so linear cancellation (``img - blur(img)``) is
    exact; products of *colinear* deviations keep the signed quadratic
    term, which is what certifies e.g. HCD's ``Ix*Iy <= (3*255/12)^2``;
  * **monotonicity fixing**: interval-gradient (reverse-mode AD over the
    DAG) pins free variables whose derivative sign is constant to the
    bound that maximizes the query — equi-satisfiable, collapses most
    dimensions;
  * **branch-and-prune**: when contraction stalls, split a variable
    (sign-splits of zero-straddling multiplication operands first, then
    largest smear) and recurse under a node budget.

Verdicts are three-valued: UNSAT is a *certificate* (every box refuted),
SAT carries a concrete witness value, UNKNOWN means budget exhausted —
`optimize.dichotomic_tighten` only tightens bounds on UNSAT, so the
analysis stays sound whatever the budget.

The port's own copy of `repro.smt.solver`.  The scalar half (the
reference oracle, ``"smt-scalar"``, and the batched engine's path for
narrow frontiers) is the reference's Python on host floats.  The batched
half runs the frontier as f64 tensors on the device its caller names and
gives the reference's numpy results bit for bit (see the comment that
opens it).  The reference's optional z3 delegation (`repro.smt.z3backend`)
is not ported.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.affine import AffineForm
from repro_torch.core.interval import Interval
from repro_torch.core.npops import (fmax as _fmax, fmin as _fmin,
                                    maximum as _maximum, minimum as _minimum,
                                    npow as _npow, power as _power,
                                    sqrt as _sqrt)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.smt import walk
from repro_torch.smt.encoder import (CONST, CSP, Def, DeviceProgram, Program,
                                     VAR, compile_csp, device_program,
                                     OP_ABS, OP_ADD, OP_DIV, OP_MAX, OP_MIN,
                                     OP_MUL, OP_POW, OP_SQRT, OP_SUB)

UNSAT, SAT, UNKNOWN = "unsat", "sat", "unknown"

_INF = math.inf
_WIDTH_EPS = 1e-7      # below this a variable is no longer split
_MEET_SLACK = 1e-9     # relative slack absorbing float round-off in meets

Box = List[Interval]

# rolling throughput counters (solver boxes/sec); an obs counter group, so
# mutation is locked and `STATS.reset()` restores the zeros between
# `analyze_smt` runs — still a plain dict to every reader, never used for
# solver logic
STATS = obs.CounterGroup("smt.solver", boxes=0, secs=0.0)


@dataclasses.dataclass
class Verdict:
    status: str                      # UNSAT | SAT | UNKNOWN
    witness: Optional[float] = None  # concrete objective value (SAT / best)
    nodes: int = 0                   # boxes processed answering the query


# ---------------------------------------------------------------------------
# interval plumbing
# ---------------------------------------------------------------------------

def _meet(a: Interval, b: Interval) -> Optional[Interval]:
    """Intersection; None = empty.  Near-misses within float slack collapse
    to the touching point instead of reporting empty."""
    lo = max(a.lo, b.lo)
    hi = min(a.hi, b.hi)
    if lo > hi:
        if lo - hi <= _MEET_SLACK * max(1.0, abs(lo), abs(hi)):
            mid = 0.5 * (lo + hi)
            return Interval(mid, mid)
        return None
    return Interval(lo, hi)


def _val(box: Box, o) -> Interval:
    return box[int(o[1])] if o[0] == VAR else Interval.point(o[1])


def _cmp_decide(op: str, l: Interval, r: Interval) -> Optional[bool]:
    """Decide `l op r` under the box, or None when undetermined."""
    if op == "<":
        if l.hi < r.lo:
            return True
        if l.lo >= r.hi:
            return False
    elif op == "<=":
        if l.hi <= r.lo:
            return True
        if l.lo > r.hi:
            return False
    elif op == ">":
        if l.lo > r.hi:
            return True
        if l.hi <= r.lo:
            return False
    elif op == ">=":
        if l.lo >= r.hi:
            return True
        if l.hi < r.lo:
            return False
    return None


def _forward_op(d: Def, box: Box) -> Interval:
    a = _val(box, d.args[0])
    if d.op == "pow":
        return a ** d.n
    if d.op == "abs":
        return a.abs()
    if d.op == "sqrt":
        return a.sqrt()
    b = _val(box, d.args[1])
    if d.op == "+":
        return a + b
    if d.op == "-":
        return a - b
    if d.op == "*":
        return a * b
    if d.op == "/":
        return a / b
    if d.op == "min":
        return a.min_(b)
    if d.op == "max":
        return a.max_(b)
    if d.op == "select":
        t = _val(box, d.args[2])
        o = _val(box, d.args[3])
        dec = _cmp_decide(d.cmp, a, b)
        if dec is True:
            return t
        if dec is False:
            return o
        return t.join(o)
    raise ValueError(f"unknown op {d.op}")


def _ext_div(v: Interval, b: Interval) -> Interval:
    """Hull of the Kahan extended division v / b (for backward mul)."""
    if b.lo > 0 or b.hi < 0:
        return v / b
    if b.lo == 0.0 and b.hi > 0:
        if v.lo > 0:
            return Interval(v.lo / b.hi, _INF)
        if v.hi < 0:
            return Interval(-_INF, v.hi / b.hi)
    elif b.hi == 0.0 and b.lo < 0:
        if v.lo > 0:
            return Interval(-_INF, v.lo / b.lo)
        if v.hi < 0:
            return Interval(v.hi / b.lo, _INF)
    return Interval.top()


def _root_n(x: float, n: int) -> float:
    if x <= 0:
        return 0.0
    return x ** (1.0 / n)


_INFEASIBLE = object()   # backward projection proved the box empty


def _backward_op(d: Def, v: Interval, box: Box) -> List:
    """Inverse projections: contracted intervals for each *var* operand
    (None = no contraction, _INFEASIBLE = box refuted).  Caller meets
    Interval results into the box."""
    out: List = [None] * len(d.args)
    a = _val(box, d.args[0])
    if d.op == "pow":
        n = d.n
        if n % 2 == 1:
            lo = math.copysign(_root_n(abs(v.lo), n), v.lo)
            hi = math.copysign(_root_n(abs(v.hi), n), v.hi)
            out[0] = Interval(min(lo, hi), max(lo, hi))
        elif n > 0:
            r = _root_n(max(v.hi, 0.0), n)
            if a.lo >= 0:
                out[0] = Interval(_root_n(max(v.lo, 0.0), n), r)
            elif a.hi <= 0:
                out[0] = Interval(-r, -_root_n(max(v.lo, 0.0), n))
            else:
                out[0] = Interval(-r, r)
        return out
    if d.op == "abs":
        if a.lo >= 0:
            out[0] = Interval(max(v.lo, 0.0), v.hi)
        elif a.hi <= 0:
            out[0] = Interval(-v.hi, -max(v.lo, 0.0))
        else:
            out[0] = Interval(-v.hi, v.hi)
        return out
    if d.op == "sqrt":
        # v = sqrt(max(a, 0)): a <= v.hi^2 always; a >= v.lo^2 only if v.lo>0
        hi2 = v.hi * v.hi
        lo2 = v.lo * v.lo if v.lo > 0 else -_INF
        out[0] = Interval(lo2, hi2)
        return out
    b = _val(box, d.args[1])
    if d.op == "+":
        out[0] = v - b
        out[1] = v - a
    elif d.op == "-":
        out[0] = v + b
        out[1] = a - v
    elif d.op == "*":
        out[0] = _ext_div(v, b)
        out[1] = _ext_div(v, a)
    elif d.op == "/":
        out[0] = v * b
        out[1] = _ext_div(a, v)
    elif d.op == "min":
        # both operands >= v.lo; an operand must also be <= v.hi when the
        # other provably cannot supply the minimum
        for slot, (x, y) in enumerate(((a, b), (b, a))):
            lo = v.lo
            hi = x.hi if y.lo <= v.hi else min(x.hi, v.hi)
            out[slot] = _INFEASIBLE if lo > hi else Interval(lo, hi)
    elif d.op == "max":
        for slot, (x, y) in enumerate(((a, b), (b, a))):
            hi = v.hi
            lo = x.lo if y.hi >= v.lo else max(x.lo, v.lo)
            out[slot] = _INFEASIBLE if lo > hi else Interval(lo, hi)
    elif d.op == "select":
        dec = _cmp_decide(d.cmp, a, b)
        if dec is True:
            out[2] = v
        elif dec is False:
            out[3] = v
    return out


def hc4(csp: CSP, box: Box, rounds: int = 6) -> bool:
    """Forward/backward contraction to (approximate) fixpoint.

    Returns False when the box is proven empty (constraint refuted)."""
    n = csp.nvars
    for _ in range(rounds):
        changed = False
        for i in range(n):           # forward (operand ids < def id)
            d = csp.defs[i]
            if d is None:
                continue
            m = _meet(box[i], _forward_op(d, box))
            if m is None:
                return False
            if m is not box[i] and (m.lo != box[i].lo or m.hi != box[i].hi):
                box[i] = m
                changed = True
        for i in range(n - 1, -1, -1):  # backward
            d = csp.defs[i]
            if d is None:
                continue
            for slot, niv in enumerate(_backward_op(d, box[i], box)):
                if niv is None:
                    continue
                if niv is _INFEASIBLE:
                    return False     # holds even when the slot is a const
                tag, val = d.args[slot]
                if tag != VAR:
                    continue
                j = int(val)
                m = _meet(box[j], niv)
                if m is None:
                    return False
                if m.lo != box[j].lo or m.hi != box[j].hi:
                    box[j] = m
                    changed = True
        if not changed:
            break
    return True


# ---------------------------------------------------------------------------
# affine relaxation sweep
# ---------------------------------------------------------------------------

def _colinear_ratio(a: Dict[int, float], b: Dict[int, float]) -> Optional[float]:
    """r with b == r*a (same symbol support), else None."""
    if not a or len(a) != len(b):
        return None
    r = None
    for k, av in a.items():
        bv = b.get(k)
        if bv is None or av == 0.0:
            return None
        rk = bv / av
        if r is None:
            r = rk
        elif not math.isclose(rk, r, rel_tol=1e-12, abs_tol=1e-300):
            return None
    return r


def _aff_mul(x: AffineForm, y: AffineForm) -> AffineForm:
    """Affine product keeping the signed quadratic term when the deviation
    vectors are colinear: dev_y = r*dev_x  =>  dev_x*dev_y = r*dev_x^2 in
    r*[0, rad_x^2] — exact, instead of the symmetric ±rad_x*rad_y blob.

    This single refinement is what proves Cauchy–Schwarz-flavored facts like
    HCD's `Ix*Iy` bound, where interval and plain affine both give ±85²."""
    r = _colinear_ratio(x.terms, y.terms)
    if r is None or not x.terms:
        return x * y
    rad2 = x.radius ** 2
    qlo, qhi = (r * 0.0, r * rad2) if r >= 0 else (r * rad2, 0.0)
    # x*y = x0*y0 + x0*dev_y + y0*dev_x + r*dev_x^2
    out = AffineForm(x.x0 * y.x0 + 0.5 * (qlo + qhi))
    terms: Dict[int, float] = {}
    for k, c in x.terms.items():
        terms[k] = y.x0 * c + x.x0 * y.terms[k]
    out.terms.update({k: c for k, c in terms.items() if c != 0.0})
    err = 0.5 * (qhi - qlo)
    if err > 0.0:
        from repro_torch.core.affine import _fresh
        out.terms[_fresh()] = err
    return out


def affine_sweep(csp: CSP, box: Box) -> bool:
    """One affine evaluation of the DAG, meeting each var's affine hull into
    the box.  Returns False on empty.

    Base var `i` gets noise symbol `-(i+1)`: negative ids cannot collide
    with the non-negative ids AffineForm's `_fresh()` mints for
    linearization-error terms (aliasing them would fabricate correlations)."""
    forms: List[Optional[AffineForm]] = [None] * csp.nvars

    def form_of(o) -> AffineForm:
        if o[0] == CONST:
            return AffineForm.point(o[1])
        return forms[int(o[1])]

    for i in range(csp.nvars):
        d = csp.defs[i]
        if d is None:
            iv = box[i]
            if math.isinf(iv.lo) or math.isinf(iv.hi):
                forms[i] = AffineForm.from_interval(iv.lo, iv.hi)
            else:
                mid, rad = 0.5 * (iv.lo + iv.hi), 0.5 * (iv.hi - iv.lo)
                forms[i] = AffineForm(mid, {-(i + 1): rad} if rad else {})
            continue
        a = form_of(d.args[0])
        if d.op == "pow":
            f = a ** d.n
        elif d.op == "abs":
            f = a.abs()
        elif d.op == "sqrt":
            f = a.sqrt()
        else:
            b = form_of(d.args[1])
            if d.op == "+":
                f = a + b
            elif d.op == "-":
                f = a - b
            elif d.op == "*":
                f = _aff_mul(a, b)
            elif d.op == "/":
                f = a / b
            elif d.op == "min":
                f = a.min_(b)
            elif d.op == "max":
                f = a.max_(b)
            elif d.op == "select":
                dec = _cmp_decide(d.cmp, a.to_interval(), b.to_interval())
                t, o = form_of(d.args[2]), form_of(d.args[3])
                if dec is True:
                    f = t
                elif dec is False:
                    f = o
                else:
                    iv = t.to_interval().join(o.to_interval())
                    f = AffineForm.from_interval(iv.lo, iv.hi)
            else:
                raise ValueError(d.op)
        # meet the hull into the box, but keep the *form* intact: its
        # correlations are its value (rebuilding from the clamped box would
        # destroy exactly the colinearity the refined product exploits)
        m = _meet(box[i], f.to_interval())
        if m is None:
            return False
        box[i] = m
        forms[i] = f
    return True


# ---------------------------------------------------------------------------
# interval gradients (reverse mode) + monotonicity fixing
# ---------------------------------------------------------------------------

_ZERO = Interval.point(0.0)
_UNIT = Interval(0.0, 1.0)


def gradients(csp: CSP, box: Box, root: int) -> List[Interval]:
    """adjoint[i] ⊇ d(root)/d(var i) over the box (reverse-mode interval AD).

    Select conditions contribute TOP to their operands (jump discontinuity);
    callers must not monotonicity-fix variables feeding a condition."""
    adj: List[Interval] = [_ZERO] * csp.nvars
    adj[root] = Interval.point(1.0)
    for i in range(csp.nvars - 1, -1, -1):
        d = csp.defs[i]
        g = adj[i]
        if d is None or (g.lo == 0.0 and g.hi == 0.0):
            continue
        a = _val(box, d.args[0])
        if d.op == "pow":
            if d.n == 0:
                parts = [_ZERO]      # d(x^0)/dx = 0 (x**-1 would raise)
            else:
                parts = [Interval.point(float(d.n)) * a ** (d.n - 1)]
        elif d.op == "abs":
            if a.lo >= 0:
                parts = [Interval.point(1.0)]
            elif a.hi <= 0:
                parts = [Interval.point(-1.0)]
            else:
                parts = [Interval(-1.0, 1.0)]
        elif d.op == "sqrt":
            if a.lo > 0:
                parts = [Interval(0.5 / math.sqrt(a.hi), 0.5 / math.sqrt(a.lo))]
            else:
                parts = [Interval(0.0, _INF)]
        else:
            b = _val(box, d.args[1])
            if d.op == "+":
                parts = [Interval.point(1.0), Interval.point(1.0)]
            elif d.op == "-":
                parts = [Interval.point(1.0), Interval.point(-1.0)]
            elif d.op == "*":
                parts = [b, a]
            elif d.op == "/":
                if b.lo > 0 or b.hi < 0:
                    inv = Interval(1.0, 1.0) / b
                    parts = [inv, -a * (inv ** 2)]
                else:
                    parts = [Interval.top(), Interval.top()]
            elif d.op in ("min", "max"):
                parts = [_UNIT, _UNIT]
            elif d.op == "select":
                dec = _cmp_decide(d.cmp, a, b)
                if dec is True:
                    parts = [_ZERO, _ZERO, Interval.point(1.0), _ZERO]
                elif dec is False:
                    parts = [_ZERO, _ZERO, _ZERO, Interval.point(1.0)]
                else:
                    parts = [Interval.top(), Interval.top(), _UNIT, _UNIT]
            else:
                raise ValueError(d.op)
        for slot, p in enumerate(parts):
            tag, val = d.args[slot]
            if tag == VAR:
                j = int(val)
                adj[j] = adj[j] + g * p
    return adj


def _monotone_fix(csp: CSP, box: Box, root: int, maximize: bool,
                  frozen: set) -> bool:
    """Pin base vars with constant derivative sign to the objective-optimal
    bound.  Equi-satisfiable for a `root >= T` (maximize) / `root <= T`
    (minimize) query, since the only non-box constraint is on the root.
    Returns True when anything was fixed."""
    adj = gradients(csp, box, root)
    fixed = False
    for i in csp.base_vars():
        if i in frozen or box[i].width <= 0:
            continue
        g = adj[i]
        if g.lo >= 0:
            v = box[i].hi if maximize else box[i].lo
        elif g.hi <= 0:
            v = box[i].lo if maximize else box[i].hi
        else:
            continue
        if math.isinf(v):
            continue
        box[i] = Interval.point(v)
        fixed = True
    return fixed


# ---------------------------------------------------------------------------
# concrete evaluation (witness extraction)
# ---------------------------------------------------------------------------

def concrete_eval(csp: CSP, point: Dict[int, float]) -> List[float]:
    vals = [0.0] * csp.nvars

    def v(o) -> float:
        return vals[int(o[1])] if o[0] == VAR else float(o[1])

    for i in range(csp.nvars):
        d = csp.defs[i]
        if d is None:
            vals[i] = point[i]
            continue
        a = v(d.args[0])
        if d.op == "pow":
            vals[i] = a ** d.n
        elif d.op == "abs":
            vals[i] = abs(a)
        elif d.op == "sqrt":
            vals[i] = math.sqrt(max(a, 0.0))
        else:
            b = v(d.args[1])
            if d.op == "+":
                vals[i] = a + b
            elif d.op == "-":
                vals[i] = a - b
            elif d.op == "*":
                vals[i] = a * b
            elif d.op == "/":
                vals[i] = a / b if b != 0 else math.copysign(_INF, a)
            elif d.op == "min":
                vals[i] = min(a, b)
            elif d.op == "max":
                vals[i] = max(a, b)
            elif d.op == "select":
                ok = {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[d.cmp]
                vals[i] = v(d.args[2]) if ok else v(d.args[3])
    return vals


def _mid(iv: Interval) -> float:
    if math.isinf(iv.lo) and math.isinf(iv.hi):
        return 0.0
    if math.isinf(iv.lo):
        return iv.hi
    if math.isinf(iv.hi):
        return iv.lo
    return 0.5 * (iv.lo + iv.hi)


def _witness_points(csp: CSP, box: Box, root: int,
                    maximize: bool) -> List[Dict[int, float]]:
    base = csp.base_vars()
    mid = {i: _mid(box[i]) for i in base}
    pts = [mid]
    adj = gradients(csp, box, root)
    corner = {}
    for i in base:
        g = adj[i]
        if g.lo >= 0:
            corner[i] = box[i].hi if maximize else box[i].lo
        elif g.hi <= 0:
            corner[i] = box[i].lo if maximize else box[i].hi
        else:
            corner[i] = mid[i]
        if math.isinf(corner[i]):
            corner[i] = mid[i]
    pts.append(corner)
    for pick in (lambda iv: iv.lo, lambda iv: iv.hi):
        p = {i: pick(box[i]) for i in base}
        if all(not math.isinf(v) for v in p.values()):
            pts.append(p)
    return pts


# ---------------------------------------------------------------------------
# branch and prune
# ---------------------------------------------------------------------------

def _split_candidates(csp: CSP, box: Box, adj: List[Interval]
                      ) -> List[Tuple[int, float]]:
    """(var, split_point) candidates, best first.

    Sign-splits of zero-straddling `*` / `/` / even-`pow` operands come
    first (closest to the root first): they unlock both the extended-
    division backward rule and the colinear affine product.  Select
    conditions against a constant split at the threshold.  Base vars use
    the smear heuristic (width x |gradient|)."""
    out: List[Tuple[int, float]] = []
    seen = set()
    for i in range(csp.nvars - 1, -1, -1):
        d = csp.defs[i]
        if d is None:
            continue
        cand = []
        if d.op in ("*", "/"):
            cand = [d.args[0], d.args[1]]
        elif d.op == "pow" and d.n % 2 == 0:
            cand = [d.args[0]]
        elif d.op == "select":
            for a, b in ((d.args[0], d.args[1]), (d.args[1], d.args[0])):
                if a[0] == VAR and b[0] == CONST:
                    j = int(a[1])
                    iv = box[j]
                    if (j not in seen and iv.lo < b[1] < iv.hi
                            and iv.width > _WIDTH_EPS):
                        seen.add(j)
                        out.append((j, float(b[1])))
        for o in cand:
            if o[0] != VAR:
                continue
            j = int(o[1])
            iv = box[j]
            if j in seen or not (iv.lo < 0.0 < iv.hi):
                continue
            if iv.width <= _WIDTH_EPS:
                continue
            seen.add(j)
            out.append((j, 0.0))
    scored = []
    for i in csp.base_vars():
        iv = box[i]
        w = iv.width
        if i in seen or w <= _WIDTH_EPS or math.isinf(w):
            continue
        g = adj[i]
        mag = max(abs(g.lo), abs(g.hi))
        if math.isinf(mag):
            mag = 1e18
        scored.append((w * max(mag, 1e-18), i, _mid(iv)))
    scored.sort(reverse=True)
    out.extend((i, m) for _, i, m in scored)
    return out


@dataclasses.dataclass
class BPBudget:
    max_nodes: int = 48
    hc4_rounds: int = 6
    batch: int = 512     # boxes popped per iteration (batched engine only)
    deadline: float = _INF   # time.monotonic() cutoff -> UNKNOWN (anytime)


def decide_scalar(csp: CSP, root: int, sense: str, threshold: float,
                  budget: Optional[BPBudget] = None) -> Verdict:
    """Reference-oracle scalar branch-and-prune (the pre-batching engine).

    Decide satisfiability of `root >= T` (sense "ge") or `root <= T`
    ("le") subject to the CSP's defining constraints and box.  Kept as the
    differential-test oracle for `decide` (the batched engine): one box at
    a time, Python dict/list walks, depth-first stack.

    UNSAT is certified (all boxes refuted by contraction / relaxation);
    SAT carries a concrete witness objective value; UNKNOWN = budget out.
    """
    return decide_scalar_multi(((csp, root),), sense, threshold, budget)


def decide_scalar_multi(entries, sense: str, threshold: float,
                        budget: Optional[BPBudget] = None) -> Verdict:
    """Scalar oracle for a multi-phase (OR-composed) query.

    `entries` is a sequence of `(csp, root)` phase systems — the phase-split
    encoding of one stage.  The query "∃ output pixel with root {sense} T"
    is satisfiable iff *some* phase is, so SAT short-circuits, UNSAT
    requires refuting every phase, and the node budget / deadline is shared
    across all phases (one query costs one budget, phase-split or not).
    """
    with obs.span("smt.decide", engine="scalar", phases=len(entries),
                  sense=sense, threshold=threshold) as sp:
        return _decide_scalar_multi(entries, sense, threshold, budget, sp)


def _decide_scalar_multi(entries, sense: str, threshold: float,
                         budget: Optional[BPBudget], sp) -> Verdict:
    t0 = time.perf_counter()
    bud = budget or BPBudget()
    maximize = sense == "ge"
    query = (Interval(threshold, _INF) if maximize
             else Interval(-_INF, threshold))
    stack: List[Tuple[int, Box]] = []
    for pi in range(len(entries) - 1, -1, -1):    # phase 0 popped first
        csp, root = entries[pi]
        box0 = list(csp.init)
        m = _meet(box0[root], query)
        if m is None:
            continue                              # phase refuted up front
        box0[root] = m
        stack.append((pi, box0))
    frozen: Dict[int, set] = {}
    peak = len(stack)

    def _done(v: Verdict) -> Verdict:
        STATS.add("boxes", v.nodes)
        STATS.add("secs", time.perf_counter() - t0)
        sp.set(status=v.status, nodes=v.nodes, frontier_peak=peak)
        return v

    best: Optional[float] = None
    nodes = 0
    while stack:
        peak = max(peak, len(stack))
        nodes += 1
        if nodes > bud.max_nodes or time.monotonic() > bud.deadline:
            return _done(Verdict(UNKNOWN, best, nodes - 1))
        pi, box = stack.pop()
        csp, root = entries[pi]
        if pi not in frozen:
            frozen[pi] = csp.cond_dependent_vars()
        sat_v, best, children, stuck, _ = _scalar_step(
            csp, box, root, maximize, threshold, best, frozen[pi],
            bud.hc4_rounds)
        if sat_v is not None:
            return _done(Verdict(SAT, sat_v, nodes))
        if stuck:
            return _done(Verdict(UNKNOWN, best, nodes))
        stack.extend((pi, ch) for ch in children)
    return _done(Verdict(UNSAT, best, nodes))


def _scalar_step(csp: CSP, box: Box, root: int, maximize: bool,
                 threshold: float, best, frozen, hc4_rounds: int):
    """One scalar branch-and-prune node: contract, probe, fix, split.

    Returns (sat_value, best, children, stuck, score): `sat_value`
    non-None means SAT; `children` is the (possibly empty) list of split
    boxes; `stuck` marks an irreducible-yet-unrefuted box (UNSAT can no
    longer be certified); `score` is the split variable's smear (width x
    clamped |gradient|) so batched-engine callers can push children with
    the same best-first priority scale `_split_batch` uses.  Shared by
    `decide_scalar` and the batched engine's small-frontier fallback."""
    if not hc4(csp, box, hc4_rounds):
        return None, best, [], False, 0.0
    if not affine_sweep(csp, box):
        return None, best, [], False, 0.0
    if not hc4(csp, box, 2):
        return None, best, [], False, 0.0
    sat_v, best = _check_witness(csp, box, root, maximize, threshold, best)
    if sat_v is not None:
        return sat_v, best, [], False, 0.0
    if _monotone_fix(csp, box, root, maximize, frozen):
        if not (hc4(csp, box, hc4_rounds) and affine_sweep(csp, box)):
            return None, best, [], False, 0.0
        sat_v, best = _check_witness(csp, box, root, maximize, threshold,
                                     best)
        if sat_v is not None:
            return sat_v, best, [], False, 0.0
    adj = gradients(csp, box, root)
    cands = _split_candidates(csp, box, adj)
    if not cands:
        return None, best, [], True, 0.0   # box irreducible yet not refuted
    j, at = cands[0]
    iv = box[j]
    if not (iv.lo < at < iv.hi):
        at = _mid(iv)
        if not (iv.lo < at < iv.hi):
            return None, best, [], True, 0.0
    left, right = list(box), list(box)
    left[j] = Interval(iv.lo, at)
    right[j] = Interval(at, iv.hi)
    # same smear scale as _split_batch's priority score
    w = iv.width if math.isfinite(iv.width) else 1e18
    mag = max(abs(adj[j].lo), abs(adj[j].hi))
    if math.isinf(mag) or math.isnan(mag):
        mag = 1e18
    score = w * max(mag, 1e-18)
    return None, best, [left, right], False, score


def _check_witness(csp, box, root, maximize, threshold, best):
    for pt in _witness_points(csp, box, root, maximize):
        val = concrete_eval(csp, pt)[root]
        if math.isnan(val) or math.isinf(val):
            continue
        if best is None or (val > best if maximize else val < best):
            best = val
        if (val >= threshold) if maximize else (val <= threshold):
            return val, best
    return None, best


# ===========================================================================
# batched-box engine
# ===========================================================================
#
# Everything below re-implements the scalar walk above over a whole frontier
# of boxes at once: the frontier is a pair of (N, nvars) f64 lo/hi tensors
# on the device the caller names, the CSP is compiled once into a flat op
# table (encoder.compile_csp, moved to the device once by
# encoder.device_program), and hc4 contraction, the affine relaxation,
# interval gradients, monotone fixing, witness probes, and splitting all
# run as (N,)-vectorized sweeps over that table.  A "node" of the
# branch-and-prune budget is one row.
#
# The affine relaxation uses an AF1-style form (dense coefficients over the
# base variables + one aggregated non-negative error radius per variable)
# instead of the scalar path's sparse symbol dicts: base-variable
# correlations — linear cancellation and the colinear signed-quadratic
# product — are preserved exactly; only correlations *between* fresh
# linearization-error terms are lumped (sound, and none of the paper
# pipelines rely on them).
#
# Every operation gives the bits the reference's numpy gives, on the CPU
# and on the card alike: elementwise IEEE arithmetic, numpy's choice of
# operand in maximum/minimum/fmax/fmin (`_maximum` and friends), numpy's
# first-index argmax (`_argmax_rows`), numpy's pairwise order for the
# affine radius (`_pw_rowsum`), and numpy's square roots and powers
# (`_sqrt`, `_npow`, `_power`; `core.npops`).  Divisions whose
# numerator is a constant go through `reciprocal` only where the numerator
# is +-1 or a power of two, and no divisor is ever a host scalar (a CUDA
# division by one is a multiplication by its reciprocal).  On the card a
# power other than 0, 1 and 2 (no benchmark has one) is torch's `pow`,
# which may differ from numpy's in the last place.  Data-dependent
# branches read one device flag each,
# as numpy's do; which boxes the frontier pops is decided on the host by
# numpy's own `argpartition` over a host copy of the scores.
#
# On the card the two op-table walks, hc4 (`_hc4_rows`) and the
# gradients (`_gradients_rows`), are one kernel launch each
# (`smt/walk.py`, `smt/csrc/smt_walk.cu`) with the bits of their plain
# versions (`_hc4_plain`, `_gradients_plain`), which run on the CPU.

_F64 = torch.float64
_SMALL_BATCH = 12   # below this many rows the scalar per-box path is faster


def _any(x) -> bool:
    return bool(x.any())


def _argmax_rows(x):
    """`np.argmax(x, axis=1)`: the first maximum, or the first NaN."""
    k = torch.argmax(x, dim=1)
    nan = torch.isnan(x)
    if _any(nan):
        k = torch.where(nan.any(dim=1),
                        torch.argmax(nan.to(torch.int8), dim=1), k)
    return k


_PW_PLANS: Dict[int, tuple] = {}


def _pw_plan(n: int):
    """numpy's pairwise-summation recursion over n terms: the leaves
    ``(start, length)`` in order, and the tree that adds their sums."""
    plan = _PW_PLANS.get(n)
    if plan is not None:
        return plan
    leaves: List[Tuple[int, int]] = []

    def walk(start, m):
        if m <= 128:
            leaves.append((start, m))
            return len(leaves) - 1
        m2 = m // 2
        m2 -= m2 % 8
        return (walk(start, m2), walk(start + m2, m - m2))

    tree = walk(0, n)
    nb = max(m // 8 for _, m in leaves)
    blocks = np.full((len(leaves), nb, 8), n, np.int64)
    tails = np.full((len(leaves), 7), n, np.int64)
    for li, (s, m) in enumerate(leaves):
        b = m // 8
        blocks[li, :b] = (s + np.arange(8 * b)).reshape(b, 8)
        t = m % 8
        tails[li, :t] = s + 8 * b + np.arange(t)
    ntail = max(m % 8 for _, m in leaves)
    plan = (tree, blocks, tails[:, :ntail])
    _PW_PLANS[n] = plan
    return plan


def _pw_rowsum(x):
    """``np.sum(x, axis=1)`` of an (N, n) tensor of non-negative (or NaN)
    values, bit for bit: numpy adds a contiguous row by pairwise
    summation (8 running sums over blocks of 8, a fixed tree over them,
    then the remainder one by one; halves above 128 terms).  Each step
    here is an elementwise add, so the order and the bits are numpy's on
    every device.  Leaves shorter than the longest are padded with +0,
    which leaves a non-negative sum as it was."""
    N, n = x.shape
    if n < 8:
        res = torch.zeros(N, dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[:, i]
        return 0.0 + res
    tree, blocks, tails = _pw_plan(n)
    if n <= 128:
        b = n // 8
        g = x[:, :8 * b].reshape(N, 1, b, 8)
        t = x[:, 8 * b:].reshape(N, 1, n - 8 * b)
    else:
        xp = torch.cat([x, x.new_zeros(N, 1)], dim=1)
        dev = x.device
        g = xp[:, torch.from_numpy(blocks).to(dev)]
        t = xp[:, torch.from_numpy(tails).to(dev)]
    r = g[:, :, 0]
    for k in range(1, g.shape[2]):
        r = r + g[:, :, k]
    s = r[..., 0::2] + r[..., 1::2]
    s = s[..., 0::2] + s[..., 1::2]
    leaf = s[..., 0] + s[..., 1]
    for k in range(t.shape[2]):
        leaf = leaf + t[:, :, k]

    def add(node):
        if isinstance(node, int):
            return leaf[:, node]
        return add(node[0]) + add(node[1])

    return 0.0 + add(tree)


def _b_meet(lo_c, hi_c, nlo, nhi):
    """Meet (nlo, nhi) into the column (lo_c, hi_c).

    Returns (mlo, mhi, empty, changed) — same slack rule as `_meet`:
    near-misses within float round-off collapse to the touching point.
    nan bounds (inf-inf artifacts) carry no information: fmax/fmin drop
    them, which is exactly "no contraction" on that side."""
    mlo = _fmax(lo_c, nlo)
    mhi = _fmin(hi_c, nhi)
    gap = mlo - mhi
    viol = gap > 0.0
    if _any(viol):
        slack = _MEET_SLACK * _maximum(
            torch.ones_like(mlo), _maximum(torch.abs(mlo), torch.abs(mhi)))
        near = viol & (gap <= slack) & torch.isfinite(mlo) & \
            torch.isfinite(mhi)
        if _any(near):
            mid = 0.5 * (mlo + mhi)
            mlo = torch.where(near, mid, mlo)
            mhi = torch.where(near, mid, mhi)
        empty = viol & ~near
    else:
        empty = viol
    changed = (mlo != lo_c) | (mhi != hi_c)
    return mlo, mhi, empty, changed


def _b_mul(alo, ahi, blo, bhi):
    """Interval product with the 0 * inf = 0 convention, elementwise."""
    p1 = alo * blo
    p2 = alo * bhi
    p3 = ahi * blo
    p4 = ahi * bhi
    if _any(torch.isnan(p1 + p2 + p3 + p4)):   # 0*inf (or inf-inf)
        p1 = torch.where((alo == 0.0) | (blo == 0.0), 0.0, p1)
        p2 = torch.where((alo == 0.0) | (bhi == 0.0), 0.0, p2)
        p3 = torch.where((ahi == 0.0) | (blo == 0.0), 0.0, p3)
        p4 = torch.where((ahi == 0.0) | (bhi == 0.0), 0.0, p4)
    return (_minimum(_minimum(p1, p2), _minimum(p3, p4)),
            _maximum(_maximum(p1, p2), _maximum(p3, p4)))


def _b_div(alo, ahi, blo, bhi):
    straddle = (blo <= 0.0) & (0.0 <= bhi)
    ilo = torch.reciprocal(bhi)
    ihi = torch.reciprocal(blo)
    rlo, rhi = _b_mul(alo, ahi, ilo, ihi)
    if _any(straddle):
        rlo = torch.where(straddle, -_INF, rlo)
        rhi = torch.where(straddle, _INF, rhi)
    return rlo, rhi


def _b_pow(alo, ahi, n: int):
    if n == 0:
        one = torch.ones_like(alo)
        return one, one
    l = _npow(alo, n)
    h = _npow(ahi, n)
    if n % 2 == 1:
        return l, h
    lo = torch.where(alo >= 0, l, torch.where(ahi < 0, h, 0.0))
    hi = torch.where(alo >= 0, h, torch.where(ahi < 0, l, _maximum(l, h)))
    return lo, hi


def _b_abs(alo, ahi):
    lo = torch.where(alo >= 0, alo, torch.where(ahi <= 0, -ahi, 0.0))
    hi = torch.where(alo >= 0, ahi, torch.where(ahi <= 0, -alo,
                                                _maximum(-alo, ahi)))
    return lo, hi


def _b_sqrt(alo, ahi):
    return (_sqrt(_maximum(alo, 0.0)), _sqrt(_maximum(ahi, 0.0)))


def _b_cmp(code: int, llo, lhi, rlo, rhi):
    """Vectorized `_cmp_decide`: (provably_true, provably_false) masks."""
    if code == 0:      # <
        return lhi < rlo, llo >= rhi
    if code == 1:      # <=
        return lhi <= rlo, llo > rhi
    if code == 2:      # >
        return llo > rhi, lhi <= rlo
    return llo >= rhi, lhi < rlo   # >=


def _b_ext_div(vlo, vhi, blo, bhi):
    """Vectorized Kahan extended division hull (see `_ext_div`)."""
    nz = (blo > 0) | (bhi < 0)
    dlo, dhi = _b_div(vlo, vhi, blo, bhi)
    if bool(nz.all()):
        return dlo, dhi
    rlo = torch.where(nz, dlo, -_INF)
    rhi = torch.where(nz, dhi, _INF)
    m1 = (blo == 0.0) & (bhi > 0)
    if _any(m1):
        c = m1 & (vlo > 0)
        rlo = torch.where(c, vlo / bhi, rlo)
        rhi = torch.where(c, _INF, rhi)
        c = m1 & (vhi < 0)
        rlo = torch.where(c, -_INF, rlo)
        rhi = torch.where(c, vhi / bhi, rhi)
    m2 = (bhi == 0.0) & (blo < 0)
    if _any(m2):
        c = m2 & (vlo > 0)
        rlo = torch.where(c, -_INF, rlo)
        rhi = torch.where(c, vlo / blo, rhi)
        c = m2 & (vhi < 0)
        rlo = torch.where(c, vhi / blo, rlo)
        rhi = torch.where(c, _INF, rhi)
    return rlo, rhi


def _b_root(x, n: int):
    ax = torch.abs(x)
    if n == 1:
        r = ax
    elif n == 2:
        r = _sqrt(ax)
    else:
        r = _power(ax, 1.0 / n)
    return torch.where(x > 0, r, 0.0)


def _b_arg(dp: DeviceProgram, k: int, lo, hi, j: int):
    ix = dp.rows[k][2][j]
    if ix >= 0:
        return lo[:, ix], hi[:, ix]
    c = dp.consts[k][j]
    return c, c


def _b_forward(dp: DeviceProgram, k: int, lo, hi):
    _, op, _, pow_n, cmp = dp.rows[k]
    alo, ahi = _b_arg(dp, k, lo, hi, 0)
    if op == OP_POW:
        return _b_pow(alo, ahi, pow_n)
    if op == OP_ABS:
        return _b_abs(alo, ahi)
    if op == OP_SQRT:
        return _b_sqrt(alo, ahi)
    blo, bhi = _b_arg(dp, k, lo, hi, 1)
    if op == OP_ADD:
        return alo + blo, ahi + bhi
    if op == OP_SUB:
        return alo - bhi, ahi - blo
    if op == OP_MUL:
        return _b_mul(alo, ahi, blo, bhi)
    if op == OP_DIV:
        return _b_div(alo, ahi, blo, bhi)
    if op == OP_MIN:
        return _minimum(alo, blo), _minimum(ahi, bhi)
    if op == OP_MAX:
        return _maximum(alo, blo), _maximum(ahi, bhi)
    # select
    t, f = _b_cmp(cmp, alo, ahi, blo, bhi)
    tlo, thi = _b_arg(dp, k, lo, hi, 2)
    olo, ohi = _b_arg(dp, k, lo, hi, 3)
    jlo = _minimum(tlo, olo)
    jhi = _maximum(thi, ohi)
    return (torch.where(t, tlo, torch.where(f, olo, jlo)),
            torch.where(t, thi, torch.where(f, ohi, jhi)))


def _b_backward(dp: DeviceProgram, k: int, lo, hi):
    """Vectorized `_backward_op`: ([(slot, clo, chi), ...], infeasible);
    `infeasible` is None where no row can be refuted."""
    i, op, argv, n, cmp = dp.rows[k]
    vlo, vhi = lo[:, i], hi[:, i]
    alo, ahi = _b_arg(dp, k, lo, hi, 0)
    if op == OP_POW:
        if n % 2 == 1:
            rl = torch.copysign(_b_root(torch.abs(vlo), n), vlo)
            rh = torch.copysign(_b_root(torch.abs(vhi), n), vhi)
            return [(0, _minimum(rl, rh), _maximum(rl, rh))], None
        if n > 0:
            r = _b_root(_maximum(vhi, 0.0), n)
            rp = _b_root(_maximum(vlo, 0.0), n)
            clo = torch.where(alo >= 0, rp, -r)
            chi = torch.where(alo >= 0, r, torch.where(ahi <= 0, -rp, r))
            return [(0, clo, chi)], None
        return [], None
    if op == OP_ABS:
        clo = torch.where(alo >= 0, _maximum(vlo, 0.0), -vhi)
        chi = torch.where(alo >= 0, vhi,
                          torch.where(ahi <= 0, -_maximum(vlo, 0.0), vhi))
        return [(0, clo, chi)], None
    if op == OP_SQRT:
        hi2 = vhi * vhi
        lo2 = torch.where(vlo > 0, vlo * vlo, -_INF)
        return [(0, lo2, hi2)], None
    blo, bhi = _b_arg(dp, k, lo, hi, 1)
    # only compute projections for slots that are variables — the caller
    # cannot meet a constant slot anyway (mul-by-stencil-weight is the
    # single hottest def shape, and this halves its backward cost)
    v0 = argv[0] >= 0
    v1 = argv[1] >= 0
    if op == OP_ADD:
        out = []
        if v0:
            out.append((0, vlo - bhi, vhi - blo))
        if v1:
            out.append((1, vlo - ahi, vhi - alo))
        return out, None
    if op == OP_SUB:
        out = []
        if v0:
            out.append((0, vlo + blo, vhi + bhi))
        if v1:
            out.append((1, alo - vhi, ahi - vlo))
        return out, None
    if op == OP_MUL:
        out = []
        if v0:
            out.append((0,) + _b_ext_div(vlo, vhi, blo, bhi))
        if v1:
            out.append((1,) + _b_ext_div(vlo, vhi, alo, ahi))
        return out, None
    if op == OP_DIV:
        out = []
        if v0:
            out.append((0,) + _b_mul(vlo, vhi, blo, bhi))
        if v1:
            out.append((1,) + _b_ext_div(alo, ahi, vlo, vhi))
        return out, None
    if op in (OP_MIN, OP_MAX):
        outs = []
        infeas = None
        for slot, (xlo, xhi, ylo, yhi) in enumerate(
                ((alo, ahi, blo, bhi), (blo, bhi, alo, ahi))):
            if op == OP_MIN:
                clo = vlo + torch.zeros_like(xhi)
                chi = torch.where(ylo <= vhi, xhi, _minimum(xhi, vhi))
            else:
                chi = vhi + torch.zeros_like(xlo)
                clo = torch.where(yhi >= vlo, xlo, _maximum(xlo, vlo))
            bad = clo > chi
            infeas = bad if infeas is None else infeas | bad
            # keep meet well-formed on rows just proven infeasible
            outs.append((slot, torch.where(bad, -_INF, clo),
                         torch.where(bad, _INF, chi)))
        return outs, infeas
    # select: the decided branch inherits the output interval
    t, f = _b_cmp(cmp, alo, ahi, blo, bhi)
    return [(2, torch.where(t, vlo, -_INF), torch.where(t, vhi, _INF)),
            (3, torch.where(f, vlo, -_INF), torch.where(f, vhi, _INF))], None


def hc4_batch(prog: Program, lo, hi, alive, rounds: int = 6):
    """Vectorized `hc4` over the whole (N, nvars) frontier, in place, on
    the device of `lo`.  Returns the updated alive mask (False = box
    proven empty)."""
    return _hc4_rows(device_program(prog, lo.device), lo, hi, alive, rounds)


def _hc4_rows(dp: DeviceProgram, lo, hi, alive, rounds: int):
    """hc4 over the frontier in place; returns the new alive mask.  On
    the card one launch of the walk kernel (`smt/walk.py`), which raises
    rather than fall back; on the CPU its plain version."""
    if lo.device.type != "cpu":
        return walk.hc4_walk(dp, lo, hi, alive, rounds)
    return _hc4_plain(dp, lo, hi, alive, rounds)


def _hc4_plain(dp: DeviceProgram, lo, hi, alive, rounds: int):
    nd = len(dp.rows)
    for _ in range(rounds):
        changed = torch.zeros(lo.shape[0], dtype=torch.bool,
                              device=lo.device)
        for k in range(nd):                      # forward
            i = dp.rows[k][0]
            flo, fhi = _b_forward(dp, k, lo, hi)
            mlo, mhi, empty, ch = _b_meet(lo[:, i], hi[:, i], flo, fhi)
            alive = alive & ~empty
            changed |= ch
            lo[:, i] = mlo
            hi[:, i] = mhi
        for k in range(nd - 1, -1, -1):          # backward
            outs, infeas = _b_backward(dp, k, lo, hi)
            if infeas is not None:
                alive = alive & ~infeas
            argv = dp.rows[k][2]
            for slot, clo, chi in outs:
                ix = argv[slot]
                if ix < 0:
                    continue
                mlo, mhi, empty, ch = _b_meet(lo[:, ix], hi[:, ix], clo, chi)
                alive = alive & ~empty
                changed |= ch
                lo[:, ix] = mlo
                hi[:, ix] = mhi
        if not _any(changed & alive):
            break
    return alive


# ---------------------------------------------------------------------------
# batched affine relaxation (AF1 forms: dense base coeffs + lumped error)
# ---------------------------------------------------------------------------
#
# A form is (c, K, e, s): value = c + K @ eps + e*u, eps_i/u in [-1, 1],
# with one eps per *base* variable and every fresh linearization error
# lumped into the single non-negative radius e; s is the sum of |K| over
# the base, kept beside the form once computed (None until then), so the
# radius `s + e` of a stored form is summed once.  Mirrors
# `affine_sweep`/`_aff_mul` op by op; only inter-error correlations are
# dropped (sound over-approximation).

_AFFINE_MEM_CAP = 48e6     # bytes of coefficient tensor per sub-batch


def _af1_sum(x):
    if x[3] is None:
        return _pw_rowsum(torch.abs(x[1]))
    return x[3]


def _af1_rad(x):
    return _af1_sum(x) + x[2]


def _af1_mul(x, y, colinear: bool):
    """AF1 product; `colinear` enables the `_aff_mul` signed-quadratic
    refinement where the deviation vectors are colinear and error-free."""
    cx, Kx, ex, _ = x
    cy, Ky, ey, _ = y
    rx = _af1_rad(x)
    ry = _af1_rad(y)
    c = cx * cy
    K = cy[:, None] * Kx + cx[:, None] * Ky
    e = torch.abs(cx) * ey + torch.abs(cy) * ex + rx * ry
    e = torch.where(torch.isnan(e), _INF, e)
    if not colinear:
        return c, K, e, None
    # colinear refinement: dev_y = r * dev_x  =>  dev_x*dev_y = r*dev_x^2
    # in r*[0, rad_x^2] (exact, signed) instead of +-rad_x*rad_y
    xnz = Kx != 0.0
    ynz = Ky != 0.0
    supp = ~(xnz ^ ynz).any(dim=1) & xnz.any(dim=1)
    if _any(supp):
        rows = torch.arange(Kx.shape[0], device=Kx.device)
        jmax = _argmax_rows(torch.abs(Kx))
        kx = Kx[rows, jmax]
        ky = Ky[rows, jmax]
        r = torch.where(kx == 0.0, 0.0, ky / kx)
        pr = r[:, None] * Kx
        close = torch.where(
            xnz, torch.abs(Ky - pr) <= 1e-12 * _maximum(torch.abs(Ky),
                                                        torch.abs(pr)),
            True).all(dim=1)
        col = supp & close & (ex == 0.0) & (ey == 0.0)
        if _any(col):
            sx = _af1_sum(x)
            rad2 = sx * sx
            q = r * rad2                     # quadratic term in r*[0, rad2]
            qlo = _minimum(q, 0.0)
            qhi = _maximum(q, 0.0)
            c = torch.where(col, cx * cy + 0.5 * (qlo + qhi), c)
            e = torch.where(col, 0.5 * (qhi - qlo), e)
    return c, K, e, None


def _af1_square(x):
    cx, Kx, ex, _ = x
    r = _af1_rad(x)
    c = cx * cx + 0.5 * r * r
    K = 2.0 * cx[:, None] * Kx
    e = 2.0 * torch.abs(cx) * ex + 0.5 * r * r
    e = torch.where(torch.isnan(e), _INF, e)
    return c, K, e, None


def _af1_pow(x, n: int):
    if n == 0:
        c = torch.ones_like(x[0])
        z = torch.zeros_like(x[0])
        return c, torch.zeros_like(x[1]), z, z
    if n == 1:
        return x
    if n == 2:
        return _af1_square(x)
    half = _af1_pow(_af1_square(x), n // 2)
    return _af1_mul(half, x, colinear=False) if n % 2 else half


def _af1_hull(x):
    c = x[0]
    r = _af1_rad(x)
    return c - r, c + r


def _af1_from_hull(lo, hi):
    """from_interval twin: finite -> (mid, 0, rad); infinite -> (0, 0, inf)."""
    bad = ~torch.isfinite(lo) | ~torch.isfinite(hi)
    c = torch.where(bad, 0.0, 0.5 * (lo + hi))
    e = torch.where(bad, _INF, 0.5 * (hi - lo))
    return c, e


def _af1_recip(y):
    """1/y via the min-range linear approximation (see AffineForm.reciprocal)."""
    cy, Ky, ey, _ = y
    lo, hi = _af1_hull(y)
    straddle = (lo <= 0.0) & (0.0 <= hi)
    point = _af1_rad(y) == 0.0
    p = torch.where(lo > 0, -torch.reciprocal(hi * hi),
                    -torch.reciprocal(lo * lo))
    ya = torch.reciprocal(lo) - p * lo
    yb = torch.reciprocal(hi) - p * hi
    q = 0.5 * (ya + yb)
    delta = 0.5 * torch.abs(ya - yb)
    c = torch.where(straddle, 0.0,
                    torch.where(point, torch.reciprocal(cy), p * cy + q))
    K = torch.where((straddle | point)[:, None], 0.0, p[:, None] * Ky)
    e = torch.where(straddle, _INF,
                    torch.where(point, 0.0, torch.abs(p) * ey + delta))
    c = torch.where(torch.isnan(c), 0.0, c)
    e = torch.where(torch.isnan(e), _INF, e)
    return c, K, e, None


def _af1_blend(mask, x, y):
    """Elementwise form select: mask ? x : y."""
    return (torch.where(mask, x[0], y[0]),
            torch.where(mask[:, None], x[1], y[1]),
            torch.where(mask, x[2], y[2]), None)


def affine_batch(prog: Program, lo, hi, alive):
    """Vectorized `affine_sweep` over the frontier (AF1 forms), in place.

    Sub-batches rows so the (rows, nvars, nbase) coefficient tensor stays
    under a fixed memory cap.  Returns the updated alive mask."""
    nb = len(prog.base)
    if nb == 0 or prog.ndefs == 0:
        return alive
    dp = device_program(prog, lo.device)
    rows_per = max(1, int(_AFFINE_MEM_CAP / (prog.nvars * nb * 8 + 1)))
    for s in range(0, lo.shape[0], rows_per):
        sl = slice(s, min(s + rows_per, lo.shape[0]))
        if _any(alive[sl]):
            alive[sl] = _affine_rows(prog, dp, lo[sl], hi[sl], alive[sl])
    return alive


def _affine_rows(prog: Program, dp: DeviceProgram, lo, hi, alive):
    N = lo.shape[0]
    nb = len(dp.base_list)
    dev = lo.device
    C = torch.zeros((N, prog.nvars), dtype=_F64, device=dev)
    K = torch.zeros((N, prog.nvars, nb), dtype=_F64, device=dev)
    E = torch.zeros((N, prog.nvars), dtype=_F64, device=dev)
    S = torch.zeros((N, prog.nvars), dtype=_F64, device=dev)
    # base var i (column col of K) gets the noise symbol of its own
    # column; every base column at once
    base = dp.base
    l, h = lo[:, base], hi[:, base]
    inf_m = ~torch.isfinite(l) | ~torch.isfinite(h)
    C[:, base] = torch.where(inf_m, 0.0, 0.5 * (l + h))
    kb = torch.where(inf_m, 0.0, 0.5 * (h - l))
    K[:, base, torch.arange(nb, device=dev)] = kb
    E[:, base] = torch.where(inf_m, _INF, torch.zeros_like(l))
    S[:, base] = 0.0 + torch.abs(kb)      # one term: numpy's 0 + |k|

    zK = torch.zeros((N, nb), dtype=_F64, device=dev)
    z0 = torch.zeros(N, dtype=_F64, device=dev)

    def form(k, j):
        ix = dp.rows[k][2][j]
        if ix >= 0:
            return C[:, ix], K[:, ix], E[:, ix], S[:, ix]
        return dp.consts[k][j].expand(N), zK, z0, z0

    for k in range(len(dp.rows)):
        i, op, _, pow_n, cmp = dp.rows[k]
        a = form(k, 0)
        if op == OP_POW:
            f = _af1_pow(a, pow_n)
        elif op == OP_ABS:
            l, h = _af1_hull(a)
            pos = l >= 0.0
            neg = h <= 0.0
            hc, he = _af1_from_hull(torch.zeros_like(l), _maximum(-l, h))
            f = _af1_blend(pos, a, _af1_blend(neg, (-a[0], -a[1], a[2], None),
                                              (hc, zK, he, None)))
        elif op == OP_SQRT:
            l, h = _af1_hull(a)
            c, e = _af1_from_hull(_sqrt(_maximum(l, 0.0)),
                                  _sqrt(_maximum(h, 0.0)))
            f = (c, zK, e, z0)
        else:
            b = form(k, 1)
            if op == OP_ADD:
                f = (a[0] + b[0], a[1] + b[1], a[2] + b[2], None)
            elif op == OP_SUB:
                f = (a[0] - b[0], a[1] - b[1], a[2] + b[2], None)
            elif op == OP_MUL:
                f = _af1_mul(a, b, colinear=True)
            elif op == OP_DIV:
                f = _af1_mul(a, _af1_recip(b), colinear=False)
            elif op in (OP_MIN, OP_MAX):
                la, ha = _af1_hull(a)
                lb, hb = _af1_hull(b)
                if op == OP_MIN:
                    c, e = _af1_from_hull(_minimum(la, lb),
                                          _minimum(ha, hb))
                else:
                    c, e = _af1_from_hull(_maximum(la, lb),
                                          _maximum(ha, hb))
                f = (c, zK, e, z0)
            else:      # select — decided on the FORM hulls, like the scalar
                la, ha = _af1_hull(a)
                lb, hb = _af1_hull(b)
                t, fm = _b_cmp(cmp, la, ha, lb, hb)
                th = form(k, 2)
                ot = form(k, 3)
                lt, ht = _af1_hull(th)
                log, hog = _af1_hull(ot)
                jc, je = _af1_from_hull(_minimum(lt, log),
                                        _maximum(ht, hog))
                f = _af1_blend(t, th, _af1_blend(fm, ot, (jc, zK, je, z0)))
        # meet the hull into the box; keep the form intact (its correlations
        # are its value, exactly like the scalar sweep)
        s = _af1_sum(f)
        r = s + f[2]
        mlo, mhi, empty, _ = _b_meet(lo[:, i], hi[:, i], f[0] - r, f[0] + r)
        alive = alive & ~empty
        lo[:, i] = mlo
        hi[:, i] = mhi
        C[:, i] = f[0]
        K[:, i] = f[1]
        E[:, i] = f[2]
        S[:, i] = s
    return alive


# ---------------------------------------------------------------------------
# batched gradients + monotonicity fixing + witness probes + splitting
# ---------------------------------------------------------------------------

def gradients_batch(prog: Program, lo, hi, root: int):
    """Vectorized `gradients`: (glo, ghi) tensors of shape (N, nvars)."""
    return _gradients_rows(device_program(prog, lo.device), prog.nvars,
                           lo, hi, root)


def _gradients_rows(dp: DeviceProgram, nvars: int, lo, hi, root: int):
    """(glo, ghi): the interval gradients of `root`.  On the card one
    launch of the walk kernel (`smt/walk.py`), which raises rather than
    fall back; on the CPU its plain version."""
    if lo.device.type != "cpu":
        if lo.dim() != 2 or lo.shape[1] != nvars:
            raise ValueError(f"_gradients_rows: want {nvars} columns, got "
                             f"{tuple(lo.shape)}")
        return walk.grad_walk(dp, lo, hi, root)
    return _gradients_plain(dp, nvars, lo, hi, root)


def _gradients_plain(dp: DeviceProgram, nvars: int, lo, hi, root: int):
    N = lo.shape[0]
    dev = lo.device
    glo = torch.zeros((N, nvars), dtype=_F64, device=dev)
    ghi = torch.zeros((N, nvars), dtype=_F64, device=dev)
    glo[:, root] = 1.0
    ghi[:, root] = 1.0
    one = torch.ones(N, dtype=_F64, device=dev)
    zero = torch.zeros(N, dtype=_F64, device=dev)
    inf = torch.full((N,), _INF, dtype=_F64, device=dev)
    for k in range(len(dp.rows) - 1, -1, -1):
        i, op, argv, n, cmp = dp.rows[k]
        gl, gh = glo[:, i], ghi[:, i]
        if not _any((gl != 0.0) | (gh != 0.0)):
            continue
        alo, ahi = _b_arg(dp, k, lo, hi, 0)
        if op == OP_POW:
            if n == 0:
                parts = [(0, zero, zero)]
            else:
                plo, phi = _b_pow(alo, ahi, n - 1)
                parts = [(0, n * plo, n * phi)]
        elif op == OP_ABS:
            plo = torch.where(alo >= 0, one, -one)
            phi = torch.where(alo >= 0, one,
                              torch.where(ahi <= 0, -one, one))
            parts = [(0, plo, phi)]
        elif op == OP_SQRT:
            pos = alo > 0
            plo = torch.where(
                pos, 0.5 * torch.reciprocal(_sqrt(_maximum(ahi, 1e-300))),
                0.0)
            phi = torch.where(
                pos, 0.5 * torch.reciprocal(
                    _sqrt(torch.where(pos, alo, 1.0))), _INF)
            parts = [(0, plo, phi)]
        elif op == OP_ADD:
            parts = [(0, one, one), (1, one, one)]
        elif op == OP_SUB:
            parts = [(0, one, one), (1, -one, -one)]
        elif op == OP_MUL:
            blo, bhi = _b_arg(dp, k, lo, hi, 1)
            parts = [(0, blo, bhi), (1, alo, ahi)]
        elif op == OP_DIV:
            blo, bhi = _b_arg(dp, k, lo, hi, 1)
            nz = (blo > 0) | (bhi < 0)
            ivlo = torch.reciprocal(torch.where(nz, bhi, 1.0))
            ivhi = torch.reciprocal(torch.where(nz, blo, 1.0))
            i2lo, i2hi = _b_pow(ivlo, ivhi, 2)
            q0lo, q0hi = _b_mul(-ahi, -alo, i2lo, i2hi)
            parts = [(0, torch.where(nz, ivlo, -inf),
                      torch.where(nz, ivhi, inf)),
                     (1, torch.where(nz, q0lo, -inf),
                      torch.where(nz, q0hi, inf))]
        elif op in (OP_MIN, OP_MAX):
            parts = [(0, zero, one), (1, zero, one)]
        else:     # select
            blo, bhi = _b_arg(dp, k, lo, hi, 1)
            t, f = _b_cmp(cmp, alo, ahi, blo, bhi)
            und = ~t & ~f
            parts = [
                (0, torch.where(und, -inf, 0.0), torch.where(und, inf, 0.0)),
                (1, torch.where(und, -inf, 0.0), torch.where(und, inf, 0.0)),
                (2, torch.where(t, one, 0.0), torch.where(t | und, one, 0.0)),
                (3, torch.where(f, one, 0.0), torch.where(f | und, one, 0.0)),
            ]
        for slot, plo, phi in parts:
            ix = argv[slot]
            if ix < 0:
                continue
            dlo, dhi = _b_mul(gl, gh, plo, phi)
            nlo = glo[:, ix] + dlo
            nhi = ghi[:, ix] + dhi
            glo[:, ix] = torch.where(torch.isnan(nlo), -_INF, nlo)
            ghi[:, ix] = torch.where(torch.isnan(nhi), _INF, nhi)
    return glo, ghi


def _monotone_fix_batch(dp: DeviceProgram, lo, hi, glo, ghi, maximize: bool,
                        alive):
    """Vectorized `_monotone_fix`; returns the per-box fixed-anything mask.

    Each base column reads and writes only itself, so all of them are
    fixed in one sweep (the reference walks them one by one)."""
    cols = [i for i in dp.base_list if not dp.frozen[i]]
    if not cols:
        return torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    ix = torch.tensor(cols, dtype=torch.int64, device=lo.device)
    L, H = lo[:, ix], hi[:, ix]
    elig = alive[:, None] & (H - L > 0)
    up = elig & (glo[:, ix] >= 0)
    dn = elig & ~up & (ghi[:, ix] <= 0)
    v_up = H if maximize else L
    v_dn = L if maximize else H
    m_up = up & torch.isfinite(v_up)
    m_dn = dn & torch.isfinite(v_dn)
    pin = torch.where(m_up, v_up, v_dn)
    m = m_up | m_dn
    lo[:, ix] = torch.where(m, pin, L)
    hi[:, ix] = torch.where(m, pin, H)
    return m.any(dim=1)


def concrete_batch(prog: Program, pts):
    """Vectorized `concrete_eval`: pts is (N, nvars) with base columns set;
    fills every defined column in place and returns the tensor."""
    return _concrete_rows(device_program(prog, pts.device), pts)


def _concrete_rows(dp: DeviceProgram, pts):
    for k in range(len(dp.rows)):
        i, op, argv, n, cmp = dp.rows[k]

        def v(j):
            ix = argv[j]
            return pts[:, ix] if ix >= 0 else dp.consts[k][j]

        a = v(0)
        if op == OP_POW:
            r = _npow(a, n)
        elif op == OP_ABS:
            r = torch.abs(a)
        elif op == OP_SQRT:
            r = _sqrt(_maximum(a, 0.0))
        else:
            b = v(1)
            if op == OP_ADD:
                r = a + b
            elif op == OP_SUB:
                r = a - b
            elif op == OP_MUL:
                r = a * b
            elif op == OP_DIV:
                r = torch.where(b == 0.0, torch.copysign(
                    torch.full_like(a, _INF), a), a / b)
            elif op == OP_MIN:
                r = _minimum(a, b)
            elif op == OP_MAX:
                r = _maximum(a, b)
            else:
                ok = (a < b if cmp == 0 else a <= b if cmp == 1
                      else a > b if cmp == 2 else a >= b)
                r = torch.where(ok, v(2), v(3))
        pts[:, i] = r
    return pts


def _b_mid(l, h):
    """Vectorized `_mid`."""
    m = 0.5 * (l + h)
    m = torch.where(torch.isinf(l) & torch.isinf(h), 0.0,
                    torch.where(torch.isinf(l), h,
                                torch.where(torch.isinf(h), l, m)))
    return m


def _witness_batch(dp: DeviceProgram, nvars: int, lo, hi, alive, root: int,
                   maximize: bool, threshold: float, glo, ghi, best):
    """Vectorized `_check_witness` over the frontier.

    Probes mid / gradient-corner / all-lo / all-hi points of every alive
    box; returns (sat_value_or_None, best)."""
    base = dp.base
    bl = lo[:, base]
    bh = hi[:, base]
    mid = _b_mid(bl, bh)
    gl = glo[:, base]
    gh = ghi[:, base]
    pick_hi = bh if maximize else bl
    pick_lo = bl if maximize else bh
    corner = torch.where(gl >= 0, pick_hi,
                         torch.where(gh <= 0, pick_lo, mid))
    corner = torch.where(torch.isinf(corner), mid, corner)
    probes = [(mid, alive), (corner, alive),
              (bl, alive & torch.isfinite(bl).all(dim=1)),
              (bh, alive & torch.isfinite(bh).all(dim=1))]
    probes = [(pt, valid) for pt, valid in probes if _any(valid)]
    if not probes:
        return None, best
    # stack all probe points into ONE forward pass over the op table: the
    # per-def Python cost is paid once, not once per probe kind
    P = len(probes)
    N = lo.shape[0]
    pts = torch.zeros((P * N, nvars), dtype=_F64, device=lo.device)
    for q, (pt, _) in enumerate(probes):
        pts[q * N:(q + 1) * N, base] = pt
    valid = torch.cat([vd for _, vd in probes])
    vals = _concrete_rows(dp, pts)[:, root]
    good = valid & torch.isfinite(vals)
    sat_val = None
    if _any(good):
        gv = vals[good]
        ext = float(gv.max() if maximize else gv.min())
        if best is None or (ext > best if maximize else ext < best):
            best = ext
        meets = good & ((vals >= threshold) if maximize
                        else (vals <= threshold))
        if _any(meets):
            mv = vals[meets]
            sat_val = float(mv.max() if maximize else mv.min())
    return sat_val, best


def _split_batch(dp: DeviceProgram, lo, hi, glo, ghi, alive):
    """Vectorized `_split_candidates`[0]: per-box (split var, split point,
    priority score).  var = -1 marks an irreducible box."""
    N = lo.shape[0]
    dev = lo.device
    svar = torch.full((N,), -1, dtype=torch.int64, device=dev)
    sat = torch.zeros(N, dtype=_F64, device=dev)
    pend = alive.clone()
    for j, at, sel in dp.split:
        if not _any(pend):
            break
        l, h = lo[:, j], hi[:, j]
        at = at if sel else 0.0
        ok = pend & (l < at) & (at < h) & (h - l > _WIDTH_EPS)
        if _any(ok):
            svar = torch.where(ok, j, svar)
            sat = torch.where(ok, at, sat)
            pend &= ~ok
    nb = len(dp.base_list)
    if nb and _any(pend):
        base = dp.base
        bl = lo[:, base]
        bh = hi[:, base]
        w = bh - bl
        mag = _maximum(torch.abs(glo[:, base]), torch.abs(ghi[:, base]))
        mag = torch.where(torch.isinf(mag) | torch.isnan(mag), 1e18, mag)
        score = w * _maximum(mag, 1e-18)
        score = torch.where((w <= _WIDTH_EPS) | torch.isinf(w), -_INF, score)
        kbest = _argmax_rows(score)
        rows = torch.arange(N, device=dev)
        sc = score[rows, kbest]
        jvar = base[kbest]
        mids = _b_mid(bl[rows, kbest], bh[rows, kbest])
        inside = (lo[rows, jvar] < mids) & (mids < hi[rows, jvar])
        take = pend & (sc > -_INF) & inside
        svar = torch.where(take, jvar, svar)
        sat = torch.where(take, mids, sat)
    # priority score for best-first popping: smear of the chosen split var
    rows = torch.arange(N, device=dev)
    jj = torch.clamp(svar, min=0)
    w = hi[rows, jj] - lo[rows, jj]
    mag = _maximum(torch.abs(glo[rows, jj]), torch.abs(ghi[rows, jj]))
    mag = torch.where(torch.isinf(mag) | torch.isnan(mag), 1e18, mag)
    score = torch.where(torch.isfinite(w), w, 1e18) * _maximum(mag, 1e-18)
    return svar, sat, score


def _rows_of(mask) -> Optional[torch.Tensor]:
    """Indices of the True rows of `mask` (read on the host), or None
    when every row is True."""
    m = mask.cpu().numpy()
    if m.all():
        return None
    return torch.from_numpy(np.nonzero(m)[0]).to(mask.device)


def _group_step(csp: CSP, prog: Program, root: int, lo, hi, maximize: bool,
                threshold: float, best, bud: BPBudget, frozen_set):
    """Process one homogeneous (single-CSP) batch of popped boxes: contract,
    probe, fix, split.  Returns (sat_value, best, kid_lo, kid_hi,
    kid_scores, stuck); `kid_lo`/`kid_hi` are the split children on the
    device of `lo` (possibly (0, nvars)), `kid_scores` their host
    priority scores."""
    B = lo.shape[0]
    dev = lo.device
    dp = device_program(prog, dev)
    empty = (lo.new_empty((0, prog.nvars)), lo.new_empty((0, prog.nvars)),
             np.empty(0))
    if B < _SMALL_BATCH:
        # narrow frontier: per-def overhead beats vectorization gains
        # below ~a dozen rows, so run these boxes through the scalar
        # per-box step (identical semantics), from one host copy
        lo_h = lo.cpu().tolist()
        hi_h = hi.cpu().tolist()
        kid_rows = []
        kid_scores = []
        stuck = False
        for r in range(B):
            lr, hr = lo_h[r], hi_h[r]
            box = [Interval(lr[i], hr[i]) if lr[i] <= hr[i] else
                   Interval(lr[i], lr[i]) for i in range(prog.nvars)]
            sat_v, best, children, irred, sc = _scalar_step(
                csp, box, root, maximize, threshold, best, frozen_set,
                bud.hc4_rounds)
            if sat_v is not None:
                return sat_v, best, *empty, stuck
            stuck = stuck or irred
            for ch in children:
                kid_rows.append(([iv.lo for iv in ch],
                                 [iv.hi for iv in ch]))
                kid_scores.append(sc)
        if not kid_rows:
            return None, best, *empty, stuck
        return (None, best,
                torch.tensor([r[0] for r in kid_rows], dtype=_F64,
                             device=dev),
                torch.tensor([r[1] for r in kid_rows], dtype=_F64,
                             device=dev),
                np.array(kid_scores), stuck)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    alive = _hc4_rows(dp, lo, hi, alive, bud.hc4_rounds)
    if _any(alive):
        alive = affine_batch(prog, lo, hi, alive)
    if _any(alive):
        alive = _hc4_rows(dp, lo, hi, alive, 2)
    if not _any(alive):
        return None, best, *empty, False
    keep_rows = _rows_of(alive)
    if keep_rows is not None:
        # compact to the surviving rows: gradients/witness/monotone-fix
        # cost is proportional to N, and near an UNSAT threshold most
        # of a batch dies in contraction
        lo, hi = lo[keep_rows], hi[keep_rows]
        alive = torch.ones(len(keep_rows), dtype=torch.bool, device=dev)
    glo, ghi = _gradients_rows(dp, prog.nvars, lo, hi, root)
    sat_v, best = _witness_batch(dp, prog.nvars, lo, hi, alive, root,
                                 maximize, threshold, glo, ghi, best)
    if sat_v is not None:
        return sat_v, best, *empty, False
    fixed = _monotone_fix_batch(dp, lo, hi, glo, ghi, maximize, alive)
    if _any(fixed):
        alive = _hc4_rows(dp, lo, hi, alive, bud.hc4_rounds)
        if _any(alive):
            alive = affine_batch(prog, lo, hi, alive)
        if not _any(alive):
            return None, best, *empty, False
        keep_rows = _rows_of(alive)
        if keep_rows is not None:
            lo, hi = lo[keep_rows], hi[keep_rows]
            alive = torch.ones(len(keep_rows), dtype=torch.bool, device=dev)
        glo, ghi = _gradients_rows(dp, prog.nvars, lo, hi, root)
        sat_v, best = _witness_batch(dp, prog.nvars, lo, hi, alive, root,
                                     maximize, threshold, glo, ghi, best)
        if sat_v is not None:
            return sat_v, best, *empty, False
    svar, sat, score = _split_batch(dp, lo, hi, glo, ghi, alive)
    sv = svar.cpu().numpy()
    al = alive.cpu().numpy()
    stuck = bool((al & (sv < 0)).any())  # cannot certify UNSAT any more
    sp = al & (sv >= 0)
    if not sp.any():
        return None, best, *empty, stuck
    rows_h = np.nonzero(sp)[0]
    rows = torch.from_numpy(rows_h).to(dev)
    j = svar[rows]
    at = sat[rows]
    left_lo, left_hi = lo[rows], hi[rows].clone()
    right_lo, right_hi = lo[rows].clone(), hi[rows]
    rr = torch.arange(len(rows_h), device=dev)
    left_hi[rr, j] = at
    right_lo[rr, j] = at
    ks = score[rows].cpu().numpy()
    return (None, best, torch.cat([left_lo, right_lo]),
            torch.cat([left_hi, right_hi]), np.concatenate([ks, ks]),
            stuck)


def decide(csp: CSP, root: int, sense: str, threshold: float,
           budget: Optional[BPBudget] = None,
           device: DeviceLike = None) -> Verdict:
    """Batched-box `decide`: same three-valued contract as `decide_scalar`
    (UNSAT is certified, SAT carries a witness, UNKNOWN = budget out), but
    the frontier is popped and split in best-first batches of vectorized
    rows instead of one Python box at a time.  The frontier lives on
    `device` (``None`` means the card).
    """
    return decide_multi(((csp, root),), sense, threshold, budget, device)


def decide_multi(entries, sense: str, threshold: float,
                 budget: Optional[BPBudget] = None,
                 device: DeviceLike = None) -> Verdict:
    """Batched-box engine for a multi-phase (OR-composed) query.

    The phase id is an extra leading axis folded into the box frontier:
    rows of every phase live in ONE `(N, max_nvars)` lo/hi tensor (short
    phases are padded with inert point columns) tagged by a per-row phase
    index, so all phases share the same best-first loop, node budget, and
    anytime deadline.  Each popped batch is regrouped by phase and run
    through that phase's compiled op table.  SAT short-circuits on any
    phase; UNSAT certifies that *every* phase's frontier was refuted.
    The frontier lives on `device` (``None`` means the card); the phase
    tags and the priority scores stay on the host.
    """
    dev = resolve_device(device)
    with obs.span("smt.decide", engine="batched", phases=len(entries),
                  sense=sense, threshold=threshold) as sp:
        return _decide_multi(entries, sense, threshold, budget, sp, dev)


def _decide_multi(entries, sense: str, threshold: float,
                  budget: Optional[BPBudget], sp, dev) -> Verdict:
    t0 = time.perf_counter()
    bud = budget or BPBudget()
    progs = [compile_csp(c) for c, _ in entries]
    nv = max(p.nvars for p in progs)
    maximize = sense == "ge"
    query = (Interval(threshold, _INF) if maximize
             else Interval(-_INF, threshold))
    rows_lo, rows_hi, rows_ph = [], [], []
    for pi, ((csp, root), prog) in enumerate(zip(entries, progs)):
        m = _meet(Interval(float(prog.init_lo[root]),
                           float(prog.init_hi[root])), query)
        if m is None:
            continue                              # phase refuted up front
        lo = np.zeros(nv)
        hi = np.zeros(nv)
        lo[:prog.nvars] = prog.init_lo
        hi[:prog.nvars] = prog.init_hi
        lo[root] = m.lo
        hi[root] = m.hi
        rows_lo.append(lo)
        rows_hi.append(hi)
        rows_ph.append(pi)
    if not rows_lo:
        sp.set(status=UNSAT, nodes=0, frontier_peak=0)
        return Verdict(UNSAT)
    f_lo = torch.from_numpy(np.stack(rows_lo)).to(dev)
    f_hi = torch.from_numpy(np.stack(rows_hi)).to(dev)
    f_ph = np.array(rows_ph, np.int32)
    f_score = np.zeros(len(rows_ph))
    peak = f_lo.shape[0]

    def _done(v: Verdict) -> Verdict:
        STATS.add("boxes", v.nodes)
        STATS.add("secs", time.perf_counter() - t0)
        sp.set(status=v.status, nodes=v.nodes, frontier_peak=peak)
        return v

    frozen_sets: Dict[int, set] = {}
    best: Optional[float] = None
    nodes = 0
    stuck = False
    while f_lo.shape[0]:
        peak = max(peak, f_lo.shape[0])
        remaining = bud.max_nodes - nodes
        if remaining <= 0 or time.monotonic() > bud.deadline:
            return _done(Verdict(UNKNOWN, best, nodes))
        B = min(f_lo.shape[0], remaining, bud.batch)
        if B < f_lo.shape[0]:          # pop the best-scored B boxes
            # numpy's introselect on the host picks them, so the popped
            # set and its order are the reference's
            order = np.argpartition(-f_score, B - 1)
            take, keep = order[:B], order[B:]
            take_t = torch.from_numpy(take).to(dev)
            keep_t = torch.from_numpy(keep).to(dev)
            lo, hi, ph = f_lo[take_t], f_hi[take_t], f_ph[take]
            f_lo, f_hi, f_ph, f_score = (f_lo[keep_t], f_hi[keep_t],
                                         f_ph[keep], f_score[keep])
        else:
            lo, hi, ph = f_lo, f_hi, f_ph
            f_lo = lo.new_empty((0, nv))
            f_hi = lo.new_empty((0, nv))
            f_ph = np.empty(0, np.int32)
            f_score = np.empty(0)
        nodes += B
        for pi in np.unique(ph):
            pi = int(pi)
            csp, root = entries[pi]
            prog = progs[pi]
            if pi not in frozen_sets:
                frozen_sets[pi] = {int(i)
                                   for i in np.nonzero(prog.frozen)[0]}
            rows = torch.from_numpy(np.nonzero(ph == pi)[0]).to(dev)
            g_lo = lo[rows][:, :prog.nvars].contiguous()
            g_hi = hi[rows][:, :prog.nvars].contiguous()
            sat_v, best, k_lo, k_hi, k_sc, g_stuck = _group_step(
                csp, prog, root, g_lo, g_hi, maximize, threshold, best,
                bud, frozen_sets[pi])
            if sat_v is not None:
                return _done(Verdict(SAT, sat_v, nodes))
            stuck = stuck or g_stuck
            if len(k_lo):
                if prog.nvars < nv:    # pad children back to the frontier
                    pad_lo = k_lo.new_zeros((len(k_lo), nv))
                    pad_hi = k_lo.new_zeros((len(k_lo), nv))
                    pad_lo[:, :prog.nvars] = k_lo
                    pad_hi[:, :prog.nvars] = k_hi
                    k_lo, k_hi = pad_lo, pad_hi
                f_lo = torch.cat([f_lo, k_lo])
                f_hi = torch.cat([f_hi, k_hi])
                f_ph = np.concatenate(
                    [f_ph, np.full(len(k_lo), pi, np.int32)])
                f_score = np.concatenate([f_score, k_sc])
    status = UNKNOWN if stuck else UNSAT
    return _done(Verdict(status, best, nodes))
