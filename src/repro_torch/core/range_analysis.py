"""Range (alpha) analysis — paper §IV-B, Algorithm 1.

Walks the stage DAG in topologically sorted order; at each stage the
expression tree is evaluated over the chosen abstract domain, exploiting the
homogeneity of pixel signals within a stage: every `Ref` leaf materializes
the *stage-level* combined range of its producer (fresh signal per tap
occurrence — taps read distinct pixels and are treated as independent).

Returns per-stage `(range, alpha)` exactly as Algorithm 1's
COMPUTEBITWIDTH 3-tuples.  The port's own copy of
`repro.core.range_analysis`; it runs on the host (abstract values are
Python objects).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.absval import Domain, get_domain
from repro_torch.core.fixedpoint import alpha_for_range
from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                                    Pipeline, Pow, Ref, Select)
from repro_torch.core.interval import Interval


@dataclasses.dataclass
class StageRange:
    """Algorithm 1's (z_lo, z_hi, alpha) bit-width 3-tuple for one stage."""
    range: Interval
    alpha: int
    signed: bool

    @staticmethod
    def from_interval(iv: Interval) -> "StageRange":
        return StageRange(range=iv, alpha=alpha_for_range(iv.lo, iv.hi),
                          signed=iv.lo < 0)


def static_cmp(op: str, l: Interval, r: Interval) -> Optional[bool]:
    """Decide a comparison statically when the operand ranges separate.

    Returns True when `l op r` holds for *every* pair of values, False when
    it holds for none, None when both outcomes are possible (the caller
    must join both Select branches).
    """
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


def eval_expr_abstract(e: Expr, domain: Domain,
                       stage_ranges: Dict[str, Interval],
                       params: Dict[str, Interval],
                       param_cache: Optional[Dict[str, Any]] = None) -> Any:
    """Recursive abstract evaluation — the body of COMPUTEBITWIDTH.

    `param_cache` shares one abstract signal across all occurrences of the
    same scalar parameter (a parameter is a single correlated signal; the
    affine domain exploits this for cancellation, e.g. USM's `weight`).
    """
    if param_cache is None:
        param_cache = {}

    def rec(n: Expr) -> Any:
        return eval_expr_abstract(n, domain, stage_ranges, params, param_cache)

    if isinstance(e, Const):
        return domain.const(e.value)
    if isinstance(e, Ref):
        return domain.fresh_signal(stage_ranges[e.stage])
    if isinstance(e, ParamRef):
        if e.name not in param_cache:
            param_cache[e.name] = domain.fresh_signal(params[e.name])
        return param_cache[e.name]
    if isinstance(e, BinOp):
        l = rec(e.left)
        r = rec(e.right)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        if e.op == "/":
            return l / r
        raise ValueError(f"unknown binop {e.op}")
    if isinstance(e, Pow):
        # the compiler maps x*x -> x**2 for tighter even-power ranges (§IV-B)
        return rec(e.base) ** e.n
    if isinstance(e, Call):
        args = [rec(a) for a in e.args]
        if e.fn == "abs":
            return args[0].abs()
        if e.fn == "sqrt":
            return args[0].sqrt()
        if e.fn == "min":
            return args[0].min_(args[1])
        if e.fn == "max":
            return args[0].max_(args[1])
        raise ValueError(f"unknown call {e.fn}")
    if isinstance(e, Select):
        # evaluate the Cmp guard: when the operand ranges separate, only the
        # taken branch can execute; otherwise the value range is the join of
        # both branches.
        if isinstance(e.cond, Cmp):
            taken = static_cmp(e.cond.op,
                               domain.to_interval(rec(e.cond.left)),
                               domain.to_interval(rec(e.cond.right)))
            if taken is True:
                return rec(e.then)
            if taken is False:
                return rec(e.other)
        t, o = rec(e.then), rec(e.other)
        # legacy third-party domains may implement select() but not join()
        return t.join(o) if hasattr(t, "join") else t.select(t, o)
    if isinstance(e, Cmp):
        raise ValueError("bare comparison outside Select")
    raise TypeError(f"unknown expr node {type(e)}")


def analyze_direct(pipeline: Pipeline, domain: str | Domain = "interval",
                   input_ranges: Optional[Dict[str, Interval]] = None,
                   ) -> Dict[str, StageRange]:
    """alpha-analysis over the whole DAG (topological order) — direct walk.

    `input_ranges` overrides the declared ranges of input stages (used by the
    profile-refined re-analysis).

    Domains flagged `whole_dag` (the reference's "smt") cannot run as a
    per-stage expression walk — the whole pipeline is analyzed at once via
    the domain's `analyze_pipeline` hook, which returns the same per-stage
    `StageRange` mapping.

    This is the unmemoized backend the `analysis` pass architecture wraps;
    application code should call `analyze` (the one-pass-plan shim) or
    build a `BitwidthPlan` via `repro_torch.analysis.run_plan`.
    """
    dom = get_domain(domain) if isinstance(domain, str) else domain
    if getattr(dom, "whole_dag", False):
        return dom.analyze_pipeline(pipeline, input_ranges=input_ranges)
    ranges: Dict[str, Interval] = {}
    out: Dict[str, StageRange] = {}
    param_cache: Dict[str, Any] = {}   # shared across stages: one signal/param

    for name in pipeline.topo_order():
        st = pipeline.stages[name]
        if st.is_input:
            iv = (input_ranges or {}).get(name, st.input_range)
            if iv is None:
                raise ValueError(f"input stage {name!r} has no declared range")
        else:
            v = eval_expr_abstract(st.expr, dom, ranges, pipeline.params,
                                   param_cache)
            iv = dom.to_interval(v)
        ranges[name] = iv
        out[name] = StageRange.from_interval(iv)
    return out


def analyze(pipeline: Pipeline, domain: str | Domain = "interval",
            input_ranges: Optional[Dict[str, Interval]] = None,
            ) -> Dict[str, StageRange]:
    """alpha-analysis entry point — a shim over a one-pass `BitwidthPlan`.

    New code declares a pass pipeline with `repro_torch.analysis.run_plan`
    and reads the resulting plan.  This shim routes string domains through
    `run_plan` (results are content-hash memoized and byte-identical
    to the direct walk) and returns the per-stage `StageRange` dict.
    """
    from repro_torch.analysis import one_pass_ranges
    return one_pass_ranges(pipeline, domain, input_ranges=input_ranges)


def alpha_table(pipeline: Pipeline, **kw) -> Dict[str, int]:
    """Convenience: stage -> alpha (the paper's Table II right column)."""
    return {k: v.alpha for k, v in analyze(pipeline, **kw).items()}
