"""Dichotomic bound tightening — paper §V-B's search loop.

For every stage the paper binary-searches a threshold T, asking the SMT
solver "can this stage's value exceed T?"; UNSAT answers ratchet the bound
down.  `tighten_stage_phases` reproduces that loop on top of
`repro_torch.smt.solver.decide_multi`:

  1. a certified initial pass (HC4 + affine relaxation on the full box)
     already beats the per-stage interval walk wherever correlations are
     linear — and is *exact* for linear DAGs, no queries needed;
  2. a dichotomic pass over power-of-two thresholds — exactly the
     bit-boundary precision alpha cares about;
  3. a few real-valued bisection steps inside the final bit for reporting
     tight ranges.

Only UNSAT verdicts tighten, so every bound stays a sound over-
approximation regardless of budget; SAT verdicts carry concrete witnesses
that floor the search.  `analyze_smt` runs this per stage in topological
order, feeding tightened ranges back in as cut-variable bounds for deeper
stages (compositional whole-DAG analysis).

The port's own copy of `repro.smt.optimize`.  `SMTConfig` keeps every
field, default and its `repr` (the SMT passes' memo keys are the
reference's).  The reference's optional z3 delegation is not ported:
`use_z3` stays a field, and ``"auto"`` answers as ``"never"``.  The
batched engine's frontier lives on the `device` that `analyze_smt` and
the tightening functions take (``None`` means the card); the scalar
engine and the certified passes run on the host.  Deadlines and the
fair-share slicing of the time budget are the reference's, so a run
that reaches a deadline depends on how fast the engine is.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Optional

from repro_torch import obs
from repro_torch.core.graph import Pipeline
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange, analyze

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.smt import solver as S
from repro_torch.smt.encoder import (CSP, closure_is_sampled, encode_stage,
                               encode_stage_phases, sampling_lattice)

_INF = math.inf


class BudgetExhaustedWarning(RuntimeWarning):
    """A stage kept its interval seed because `time_budget_s` ran out.

    The stage's alpha is still *sound* (the seed is a valid over-
    approximation) but should not be read as the converged SMT answer —
    the `smt.budget_exhausted` obs event carries the same information in
    traces, and `SmtPass` writes such stages into the plan's provenance."""


@dataclasses.dataclass
class SMTConfig:
    """Budgets for the branch-and-prune emulation of the paper's solver.

    Two engines answer queries: ``"batched"`` (default) runs the whole
    branch-and-prune frontier as vectorized tensor rows — a node costs ~100x
    less than a scalar dict walk, which is why its default budgets are ~64x
    the scalar ones — and ``"scalar"`` is the original box-at-a-time
    reference oracle (kept for differential tests and debugging; it uses
    the pre-batching `scalar_*` budgets so equal-engine comparisons stay
    affordable).

    ``phase_split`` (default on) encodes stages whose producer closure
    crosses stride/upsample boundaries as one exactly-aligned CSP per
    output-phase residue (`encoder.encode_stage_phases`) and solves all
    phases as a single OR-composed query; the alignment-blind cut encoding
    remains the fallback when no uniform sampling lattice exists or the
    phase count exceeds ``max_phases``.
    """
    max_vars: int = 400         # flattening budget per stage CSP (then cuts)
    engine: str = "batched"     # "batched" | "scalar" (reference oracle)
    max_nodes: int = 4096       # batched: branch-and-prune boxes per query
    work_budget: int = 262144   # batched: ~boxes*vars per query — scales
                                # nodes down on large CSPs
    scalar_max_nodes: int = 64  # reference-oracle (pre-batching) budgets
    scalar_work_budget: int = 4096
    batch: int = 512            # boxes popped per batched solver iteration
    hc4_rounds: int = 6
    real_queries: int = 5       # real-valued bisection steps per side
    unknown_budget: int = 3     # UNKNOWN verdicts tolerated per side before
                                # the search settles for the current bound
    time_budget_s: float = 30.0  # per pipeline; overflow stages keep the seed
    use_z3: str = "auto"        # "auto" | "never" — optional z3 delegation
    phase_split: bool = True    # polyphase encoding across sampled stages
    max_phases: int = 16        # fall back to the blind encoding above this

    def decide_fn(self):
        return (S.decide_multi if self.engine == "batched"
                else S.decide_scalar_multi)

    def _nodes_for(self, nvars: int, scalar_scale: bool) -> int:
        mn, wb = ((self.scalar_max_nodes, self.scalar_work_budget)
                  if scalar_scale else (self.max_nodes, self.work_budget))
        return max(8, min(mn, wb // max(nvars, 1)))

    def quick_nodes(self, nvars: int) -> int:
        """Pre-batching (scalar-era) node budget — what one PR-1 query got;
        the batched engine's iterative-deepening quick pass uses this."""
        return self._nodes_for(nvars, scalar_scale=True)

    def bp_budget(self, nvars: int, deadline: float = _INF) -> S.BPBudget:
        nodes = self._nodes_for(nvars, scalar_scale=self.engine != "batched")
        return S.BPBudget(nodes, self.hc4_rounds, self.batch, deadline)


def _query(cfg: SMTConfig, device):
    """`cfg.decide_fn()` with the batched engine bound to `device`."""
    fn = cfg.decide_fn()
    if cfg.engine != "batched":
        return fn
    return lambda entries, sense, t, budget: fn(entries, sense, t, budget,
                                                device=device)


def _decide(entries, sense: str, t: float,
            cfg: SMTConfig, deadline: float = _INF,
            escalate: bool = True, device=None) -> S.Verdict:
    fn = _query(cfg, device)
    nvars = max(csp.nvars for csp, _ in entries)
    full = cfg.bp_budget(nvars, deadline)
    if cfg.engine == "batched":
        # iterative deepening: most dichotomic queries resolve within the
        # pre-batching node budget (contraction alone certifies them), so
        # answer those at scalar-era cost and spend the 64x batched budget
        # only where the quick pass is UNKNOWN.  This keeps the *number*
        # of queries a stage completes per second no worse than the scalar
        # engine's while the hard boundary queries get the deep frontier.
        quick_nodes = cfg.quick_nodes(nvars)
        if full.max_nodes > quick_nodes:
            v = fn(entries, sense, t,
                   S.BPBudget(quick_nodes, cfg.hc4_rounds, cfg.batch,
                              deadline))
            now = time.monotonic()
            if v.status != S.UNKNOWN or not escalate or now >= deadline:
                return v
            # time-box the deep run: a failed escalation must not eat the
            # whole remaining slice (it returns a sound UNKNOWN at the cut)
            esc_deadline = (now + max(1.0, 0.25 * (deadline - now))
                            if math.isfinite(deadline) else deadline)
            deep = fn(entries, sense, t,
                      dataclasses.replace(full,
                                          deadline=min(deadline,
                                                       esc_deadline)))
            if deep.status != S.UNKNOWN:
                return deep
            if v.witness is not None and (
                    deep.witness is None or
                    (sense == "ge" and v.witness > deep.witness) or
                    (sense == "le" and v.witness < deep.witness)):
                return v
            return deep
    return fn(entries, sense, t, full)


def _pow2_thresholds(lo: float, hi: float) -> list:
    """Powers of two strictly inside (lo, hi) — the alpha bit boundaries."""
    out = []
    for k in range(-4, 64):
        for sgn in (1.0, -1.0):
            b = sgn * (2.0 ** k)
            if lo < b < hi:
                out.append(b)
    return sorted(set(out))


def _tighten_side(entries, iv: Interval, side: str,
                  cfg: SMTConfig, deadline: float,
                  escalate: bool = True, device=None) -> float:
    """Sound new bound for one side of `iv` (hi for "hi", lo for "lo").

    `entries` is the phase list `[(csp, root), ...]` (a single pair for the
    classic alignment-blind encoding); the bound covers the union of phases.
    """
    maximize = side == "hi"
    sense = "ge" if maximize else "le"
    bound = iv.hi if maximize else iv.lo
    if math.isinf(bound):
        return bound
    # floor of the search: best concrete value seen (always achievable)
    floor = iv.lo if maximize else iv.hi
    v0 = _query(cfg, device)(entries, sense, bound,
                             S.BPBudget(max_nodes=len(entries),
                                        hc4_rounds=cfg.hc4_rounds))
    if v0.status == S.SAT:
        return bound            # the seed bound itself is attained
    if v0.witness is not None:
        floor = v0.witness

    unknowns = 0
    deep_strikes = 0

    def q(t: float) -> S.Verdict:
        # pass the deadline down so one over-budget query cannot overshoot
        # the stage's time slice (the batched engine is "anytime": it
        # returns a sound UNKNOWN at the cutoff).  Deep escalations that
        # come back UNKNOWN twice stop paying for themselves on this side:
        # fall back to quick-only queries (PR-1-era behavior) after that.
        nonlocal deep_strikes
        allow = escalate and deep_strikes < 2
        v = _decide(entries, sense, t, cfg, deadline, escalate=allow,
                    device=device)
        if allow and v.status == S.UNKNOWN:
            deep_strikes += 1
        return v

    # -- dichotomic pass over bit boundaries --------------------------------
    bs = _pow2_thresholds(floor, bound) if maximize else \
        sorted(-b for b in _pow2_thresholds(-floor, -bound))
    lo_i, hi_i = 0, len(bs)      # candidate boundary window (unresolved)
    while lo_i < hi_i and time.monotonic() < deadline:
        mid = (lo_i + hi_i) // 2
        t = bs[mid] if maximize else bs[len(bs) - 1 - mid]
        r = q(t)
        if r.status == S.UNSAT:
            bound = math.nextafter(t, -_INF if maximize else _INF)
            hi_i = mid
        else:
            if r.status == S.SAT and r.witness is not None:
                floor = (max(floor, r.witness) if maximize
                         else min(floor, r.witness))
            elif r.status == S.UNKNOWN:
                unknowns += 1
                if unknowns >= cfg.unknown_budget:
                    return bound   # search is stalling; keep the sound bound
            lo_i = mid + 1
    # -- real-valued refinement inside the final bit ------------------------
    for _ in range(cfg.real_queries):
        if time.monotonic() >= deadline:
            break
        span = bound - floor if maximize else floor - bound
        if not math.isfinite(span) or span <= 1e-6 * max(1.0, abs(bound)):
            break
        t = 0.5 * (floor + bound)
        r = q(t)
        if r.status == S.UNSAT:
            bound = math.nextafter(t, -_INF if maximize else _INF)
        elif r.status == S.SAT and r.witness is not None:
            floor = (max(floor, r.witness, t) if maximize
                     else min(floor, r.witness, t))
        else:
            unknowns += 1
            if unknowns >= cfg.unknown_budget:
                break           # UNKNOWN: cannot resolve further, stay sound
            floor = t           # skip the unresolvable region, search higher
    return bound


def tighten_stage(csp: CSP, root: int, seed: Interval, cfg: SMTConfig,
                  deadline: float, device: DeviceLike = None) -> Interval:
    """Tightened sound range for `root`, always a subset of `seed`."""
    return tighten_stage_phases([(csp, root)], seed, cfg, deadline, device)


def tighten_stage_phases(entries, seed: Interval, cfg: SMTConfig,
                         deadline: float,
                         device: DeviceLike = None) -> Interval:
    """Tightened sound union-of-phases range, always a subset of `seed`.

    `entries` holds one `(csp, root)` per output phase (a single entry is
    the classic whole-stage CSP).  Every phase's certified initial pass
    (HC4 + affine relaxation) runs first; when all phases are linear the
    union of their exact affine hulls is returned without any search,
    otherwise the dichotomic searches below query all phases as one
    OR-composed `decide_multi` problem under the shared budget/deadline.
    The batched engine's queries run on `device` (``None`` means the
    card).
    """
    if cfg.engine == "batched":
        device = resolve_device(device)
    # certified initial pass per phase: HC4 + affine relaxation on full box
    iv: Optional[Interval] = None
    all_linear = True
    for pi, (csp, root) in enumerate(entries):
        with obs.span("smt.phase", phase=pi, nvars=csp.nvars) as psp:
            box = list(csp.init)
            m = S._meet(box[root], seed)
            if m is None:
                psp.set(pruned=True)
                continue        # seed excludes this phase's root box entirely
            box[root] = m
            if not (S.hc4(csp, box, cfg.hc4_rounds)
                    and S.affine_sweep(csp, box) and S.hc4(csp, box, 2)):
                return seed     # should not happen (seed is sound); bail out
            iv = box[root] if iv is None else iv.join(box[root])
            all_linear &= csp.is_linear()
            psp.set(linear=csp.is_linear(),
                    hull=[box[root].lo, box[root].hi])
    if iv is None:
        return seed
    if all_linear:
        return iv               # affine hulls are exact: no search needed
    if cfg.engine != "batched":
        # scalar reference oracle: exact PR-1 semantics — each side may use
        # the full remaining deadline
        hi = _tighten_side(entries, iv, "hi", cfg, deadline)
        lo = _tighten_side(entries, iv, "lo", cfg, deadline)
        if lo > hi:             # numerical corner: fall back to the pass-1 hull
            return iv
        return Interval(lo, hi)
    # Phase 1 — quick-only dichotomic search (PR-1 semantics: every query
    # runs at the pre-batching node budget, so this phase costs what the
    # scalar engine cost and its bounds are never looser than PR-1's given
    # the same time).  The hi search runs first; split the time between
    # the sides so it cannot starve the lo search.
    now = time.monotonic()
    span = max(deadline - now, 0.0)
    hi = _tighten_side(entries, iv, "hi", cfg,
                       min(deadline, now + 0.35 * span), escalate=False,
                       device=device)
    lo = _tighten_side(entries, iv, "lo", cfg,
                       min(deadline, now + 0.7 * span), escalate=False,
                       device=device)
    if lo > hi:                 # numerical corner: fall back to the pass-1 hull
        return iv
    # Phase 2 — spend whatever time is left re-searching the (much smaller)
    # residual window with deep batched escalations; UNSAT-only updates, so
    # this can only tighten the phase-1 result.
    if time.monotonic() < deadline:
        iv2 = Interval(lo, hi)
        now = time.monotonic()
        hi = _tighten_side(entries, iv2, "hi", cfg,
                           min(deadline, now + 0.5 * (deadline - now)),
                           device=device)
        lo = _tighten_side(entries, Interval(lo, hi), "lo", cfg, deadline,
                           device=device)
        if lo > hi:
            return iv2
    return Interval(lo, hi)


def _certified_phase_hull(csp: CSP, root: int, bound: Interval,
                          cfg: SMTConfig) -> Interval:
    """Certified (search-free) sound hull of one phase's root variable.

    The phase's true range is contained in both its own contracted hull
    (HC4 + affine relaxation on the full box) and the stage's final union
    bound, so their meet is sound per phase.  All-linear cut-free phase
    CSPs make the hull exact (affine sweep = exact range hull).
    """
    box = list(csp.init)
    m = S._meet(box[root], bound)
    if m is None:
        return bound
    box[root] = m
    if not (S.hc4(csp, box, cfg.hc4_rounds) and S.affine_sweep(csp, box)
            and S.hc4(csp, box, 2)):
        return bound            # contraction emptied: keep the union bound
    m = S._meet(box[root], bound)
    return m if m is not None else bound


def analyze_smt(pipeline: Pipeline,
                input_ranges: Optional[Dict[str, Interval]] = None,
                config: Optional[SMTConfig] = None,
                collect_phases: Optional[Dict] = None,
                diagnostics: Optional[Dict] = None,
                device: DeviceLike = None,
                ) -> Dict[str, StageRange]:
    """Whole-DAG range analysis — drop-in for `range_analysis.analyze` with
    `domain="smt"`, returning the same per-stage 3-tuples.

    Stages are tightened in topological order; each stage's CSP flattens its
    transitive producers into shared input-pixel/parameter variables, with
    already-tightened SMT ranges bounding budget/sampling cut points.  Every
    result is the meet of the tightening with the interval seed, so
    `smt ⊆ interval` holds per stage by construction.

    `collect_phases`, when a dict, is filled with per-phase certified
    sub-ranges for every phase-split stage:  ``{stage: ((My, Mx),
    {(ry, rx): Interval})}``.  Collection is read-only — the union bounds
    this function returns are identical with or without it; the sub-ranges
    feed `BitwidthPlan` phase columns (one datapath per lattice residue).

    `diagnostics`, when a dict, receives ``{"budget_exhausted": [stage,
    ...]}`` — the stages that kept their interval seed because
    `time_budget_s` ran out.  Each such stage also raises a
    `BudgetExhaustedWarning` and emits an `smt.budget_exhausted` obs
    event, so budget-starved alphas are never silently mistaken for
    converged ones.  When tracing is enabled every worked stage gets an
    `smt.stage` span (boxes explored, budget granted vs consumed,
    verdict, deadline-exhaustion flag) with `smt.phase` child spans.

    The batched engine runs on `device` (``None`` means the card, and
    raises where there is none); the scalar engine takes no device.
    """
    cfg = config or SMTConfig()
    if cfg.engine == "batched":
        device = resolve_device(device)
    seed = analyze(pipeline, "interval", input_ranges=input_ranges)
    bounds: Dict[str, Interval] = {n: r.range for n, r in seed.items()}
    deadline = time.monotonic() + cfg.time_budget_s
    topo = pipeline.topo_order()
    work = {n for n in topo
            if not pipeline.stages[n].is_input and bounds[n].width > 0}
    n_left = len(work)
    out: Dict[str, StageRange] = {}
    exhausted = []
    asp = obs.span("smt.analyze", pipeline=pipeline.name, engine=cfg.engine,
                   time_budget_s=cfg.time_budget_s, stages=len(work))
    with asp:
        for name in topo:
            iv = bounds[name]
            seed_iv = iv
            phase_entries = None
            now = time.monotonic()
            stage_exhausted = False
            if name in work and now < deadline:
                # fair-share time slicing: with the batched engine's large
                # per-query budgets a single greedy stage could otherwise eat
                # the whole pipeline budget and leave deep stages (where the
                # whole-DAG analysis wins most) with their interval seeds.
                # Each stage may use up to 2x its equal share of the remaining
                # time; unused time rolls over to later stages.
                slice_s = 2.0 * (deadline - now) / max(n_left, 1)
                stage_deadline = min(deadline, now + max(slice_s, 0.5))
                ssp = obs.span("smt.stage", stage=name,
                               budget_s=stage_deadline - now)
                with ssp:
                    t_stage = time.perf_counter()
                    boxes0 = S.STATS["boxes"]
                    entries = None
                    if cfg.phase_split and closure_is_sampled(pipeline, name):
                        # phase-split: exactly-aligned expansion per
                        # output-phase residue; None = no uniform lattice /
                        # too many phases — fall back to the alignment-blind
                        # cut encoding below
                        entries = encode_stage_phases(
                            pipeline, name, bounds,
                            input_ranges=input_ranges,
                            max_vars=cfg.max_vars, max_phases=cfg.max_phases)
                    if entries is None:
                        entries = [encode_stage(pipeline, name, bounds,
                                                input_ranges=input_ranges,
                                                max_vars=cfg.max_vars)]
                    elif not all(c.is_linear() and "cut" not in c.kinds
                                 for c, _ in entries):
                        # nonlinear (or budget-cut) phases need search, and
                        # the exact expansions are much larger CSPs than the
                        # blind cut encoding — a fixed slice can leave them
                        # UNKNOWN where the small blind system converges.
                        # Run the blind search on half the slice first and
                        # seed the phase pass with its result: the
                        # phase-split bound is then never looser than the
                        # alignment-blind one by construction.  (All-linear
                        # cut-free phases skip this: their union hull is
                        # exact.)
                        b_csp, b_root = encode_stage(
                            pipeline, name, bounds,
                            input_ranges=input_ranges, max_vars=cfg.max_vars)
                        now = time.monotonic()
                        b_deadline = min(stage_deadline,
                                         now + 0.5 * (stage_deadline - now))
                        biv = tighten_stage_phases([(b_csp, b_root)], iv,
                                                   cfg, b_deadline, device)
                        m = S._meet(iv, biv)
                        iv = m if m is not None else iv
                    tiv = tighten_stage_phases(entries, iv, cfg,
                                               stage_deadline, device)
                    m = S._meet(iv, tiv)
                    iv = m if m is not None else iv
                    if len(entries) > 1:
                        phase_entries = entries
                    unchanged = (iv.lo == seed_iv.lo and iv.hi == seed_iv.hi)
                    stage_exhausted = (unchanged and
                                       time.monotonic() >= stage_deadline)
                    ssp.set(nvars=max(c.nvars for c, _ in entries),
                            phases=len(entries),
                            boxes=S.STATS["boxes"] - boxes0,
                            consumed_s=time.perf_counter() - t_stage,
                            verdict="seed" if unchanged else "tightened",
                            range=[iv.lo, iv.hi],
                            deadline_exhausted=stage_exhausted)
            elif name in work:
                # the pipeline budget ran out before this stage even started
                stage_exhausted = True
            if stage_exhausted:
                exhausted.append(name)
                obs.event("smt.budget_exhausted", stage=name,
                          time_budget_s=cfg.time_budget_s)
                warnings.warn(
                    f"SMT stage {name!r} kept its interval seed: "
                    f"time_budget_s={cfg.time_budget_s:g} exhausted",
                    BudgetExhaustedWarning, stacklevel=2)
            if name in work:
                n_left -= 1
            bounds[name] = iv
            out[name] = StageRange.from_interval(iv)
            if collect_phases is not None and phase_entries is not None:
                lat = sampling_lattice(pipeline, name)
                if lat is not None:
                    my, mx = lat
                    residues = [(ry, rx)
                                for ry in range(my) for rx in range(mx)]
                    collect_phases[name] = (lat, {
                        res: _certified_phase_hull(csp, root, iv, cfg)
                        for res, (csp, root) in zip(residues, phase_entries)})
        asp.set(budget_exhausted=list(exhausted))
    if diagnostics is not None:
        diagnostics["budget_exhausted"] = list(exhausted)
    return out


def alpha_table_smt(pipeline: Pipeline, **kw) -> Dict[str, int]:
    """Stage -> alpha under the SMT analysis (Table II right-column twin)."""
    return {k: v.alpha for k, v in analyze_smt(pipeline, **kw).items()}
