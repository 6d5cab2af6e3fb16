"""Pass combinators: `meet`, `refine`, `widen_to`.

Combinators are themselves `AnalysisPass`es, so they nest arbitrarily and
memoize like any other pass; their sub-passes run through `ctx.run`, so a
sub-pass shared between two combinators (or requested standalone in the
same plan) executes exactly once per pipeline.

  * ``meet(a, b, ...)`` — sound ∧ sound composition: the per-stage range
    intersection of sound over-approximations is itself sound and at least
    as tight as every operand (the classic reduced product, generalized
    from `core.intersect` to whole passes).
  * ``refine(static, empirical)`` — profile-clamped re-analysis: re-run the
    static pass with the pipeline's *input* ranges clamped to what the
    empirical pass observed.  Sound w.r.t. the profiled input distribution
    only (recorded in the column's provenance notes).
  * ``widen_to(sub, budget)`` — widen every range outward to its exact
    alpha bit boundary, making plans insensitive to sub-bit range jitter
    (stable diffs, stable memo hits downstream).  Widening never changes
    an alpha; stages whose alpha exceeds `budget` are reported in notes —
    soundness always wins over the budget request.

The port's own copy of `repro.analysis.combinators`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.intersect import _meet as _meet_iv
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange

from repro_torch.analysis.passes import (AnalysisPass, PassContext,
                                         PassResult, make_pass)


class MeetPass:
    name = "meet"

    def __init__(self, *passes, column: Optional[str] = None):
        self.passes: List[AnalysisPass] = [make_pass(p) for p in passes]
        if len(self.passes) < 2:
            raise ValueError("meet() needs at least two passes")
        self.column = column or \
            f"meet({','.join(p.column for p in self.passes)})"

    def key(self) -> str:
        return "meet(" + ";".join(p.key() for p in self.passes) + ")"

    def run(self, ctx: PassContext) -> PassResult:
        results = [ctx.run(p) for p in self.passes]
        ranges: Dict[str, Interval] = dict(results[0].ranges)
        for r in results[1:]:
            for n, iv in r.ranges.items():
                ranges[n] = _meet_iv(ranges[n], iv) if n in ranges else iv
        # phase sub-columns survive the meet: first operand carrying them
        # wins per stage, each phase range met with the stage's met union
        # bound (both sound for that phase, so the meet is too)
        phases = {}
        for r in results:
            for stage, (lat, rmap) in (r.phases or {}).items():
                if stage in phases:
                    continue
                phases[stage] = (lat, {res: _meet_iv(iv, ranges[stage])
                                       for res, iv in rmap.items()})
        return PassResult(ranges=ranges, phases=phases or None)


class RefinePass:
    name = "refine"

    def __init__(self, static, empirical, column: Optional[str] = None):
        self.static = make_pass(static)
        self.empirical = make_pass(empirical)
        self.column = column or \
            f"refine({self.static.column},{self.empirical.column})"

    def key(self) -> str:
        return f"refine({self.static.key()};{self.empirical.key()})"

    def run(self, ctx: PassContext) -> PassResult:
        emp = ctx.run(self.empirical)
        clamped: Dict[str, Interval] = dict(ctx.input_ranges or {})
        for n in ctx.pipeline.input_stages():
            if n not in emp.ranges:
                continue
            declared = clamped.get(n, ctx.pipeline.stages[n].input_range)
            obs = emp.ranges[n]
            clamped[n] = _meet_iv(declared, obs) if declared is not None else obs
        res = ctx.with_input_ranges(clamped).run(self.static)
        return PassResult(
            ranges=dict(res.ranges), alphas=res.alphas, phases=res.phases,
            notes=list(res.notes) + [
                "input ranges clamped to profiled observations; sound only "
                "w.r.t. the profiled input distribution"])


def _bit_boundary(sr: StageRange) -> Interval:
    """Widest range with the same (alpha, signed) at integer granularity."""
    a = sr.alpha
    if a >= 64:                 # analysis blow-up sentinel: leave untouched
        return sr.range
    if sr.signed:
        return Interval(-(2.0 ** (a - 1)), 2.0 ** (a - 1) - 1.0)
    return Interval(0.0, 2.0 ** a - 1.0)


class WidenPass:
    name = "widen_to"

    def __init__(self, sub, budget: int, column: Optional[str] = None):
        self.sub = make_pass(sub)
        self.budget = int(budget)
        self.column = column or f"widen({self.sub.column},{self.budget})"

    def key(self) -> str:
        return f"widen({self.sub.key()};budget={self.budget})"

    def run(self, ctx: PassContext) -> PassResult:
        res = ctx.run(self.sub)
        srs = res.stage_ranges()
        over = [n for n, sr in srs.items() if sr.alpha > self.budget]
        notes = list(res.notes)
        if over:
            notes.append(f"alpha budget {self.budget} exceeded on: "
                         f"{', '.join(over)} (bounds kept sound)")
        widened = {n: _bit_boundary(sr).join(sr.range)
                   for n, sr in srs.items()}

        def widen_iv(iv: Interval) -> Interval:
            return _bit_boundary(StageRange.from_interval(iv)).join(iv)

        phases = None
        if res.phases:                 # phase sub-columns widen alongside
            phases = {stage: (lat, {r: widen_iv(iv)
                                    for r, iv in rmap.items()})
                      for stage, (lat, rmap) in res.phases.items()}
        return PassResult(ranges=widened, alphas=res.alphas, phases=phases,
                          notes=notes)


def meet(*passes, column: Optional[str] = None) -> MeetPass:
    return MeetPass(*passes, column=column)


def refine(static, empirical, column: Optional[str] = None) -> RefinePass:
    return RefinePass(static, empirical, column=column)


def widen_to(sub, budget: int, column: Optional[str] = None) -> WidenPass:
    return WidenPass(sub, budget, column=column)
