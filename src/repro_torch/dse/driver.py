"""`run_design_search` — the closed loop: plan → propose → execute → keep.

One call takes a `BitwidthPlan` and calibration images and returns a
`DSEResult`: the Pareto frontier of measured error vs modeled area/power,
the chosen (cheapest feasible) design, the homogeneity clusters the
search moved over, and the §V-B beta-search result that seeded it.

Layering (each stage feeds the next, every probe lands in the frontier):

  1. seed alphas from the plan — profile column when present (the paper's
     empirical floor), capped by the sound column's proved alphas;
  2. `seeded_beta_sweep` finds per-stage betas meeting the PSNR budget;
  3. `cluster_alpha_descent` shaves shared integer bits per §IV cluster;
  4. `anneal` runs the NAS-style controller over cluster-level ±1 moves.

Determinism: same plan, images, budget, and seed ⇒ the identical frontier
JSON (seeded rng, ordered dicts, measured — not timed — objectives).

The port's own copy of `repro.dse.driver`: every candidate is scored
through `Evaluator` on `device` (``None`` means the card), by default
with the band kernel (``backend="cuda"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.analysis.cluster import homogeneity_clusters
from repro_torch.analysis.plan import BitwidthPlan
from repro_torch.core import cost_model
from repro_torch.core.beta_search import BetaSearchResult
from repro_torch.core.graph import Pipeline
from repro_torch.device import DeviceLike
from repro_torch.dse.evaluate import DSE_STATS, Evaluator
from repro_torch.dse.frontier import DesignPoint, ErrorBudget, Frontier
from repro_torch.dse.strategies import (anneal, cluster_alpha_descent,
                                  seeded_beta_sweep)


@dataclasses.dataclass
class DSEResult:
    frontier: Frontier
    chosen: Optional[DesignPoint]     # cheapest-power feasible design
    clusters: List[List[str]]
    beta_result: BetaSearchResult
    evaluations: int                  # distinct candidates executed
    plan_column: str

    def to_json_dict(self) -> Dict:
        return {
            "frontier": self.frontier.to_json_dict(),
            "chosen": self.chosen.to_json_dict() if self.chosen else None,
            "clusters": [list(c) for c in self.clusters],
            "uniform_beta": self.beta_result.uniform_beta,
            "beta_search_passes": self.beta_result.profile_passes,
            "evaluations": self.evaluations,
            "plan_column": self.plan_column,
        }


def seed_alphas(plan: BitwidthPlan, column: Optional[str] = None,
                ) -> Dict[str, int]:
    """Starting alphas: the profile column's empirical floor where the
    plan carries one, capped by the sound column's proved alphas."""
    sound = plan.alphas(column)
    if "profile" in plan.columns:
        prof = plan.alphas("profile")
        return {n: min(prof.get(n, a), a) for n, a in sound.items()}
    return dict(sound)


def run_design_search(pipeline: Pipeline, plan: BitwidthPlan,
                      images: Sequence, budget: ErrorBudget, *,
                      params: Optional[Dict[str, float]] = None,
                      column: Optional[str] = None, seed: int = 0,
                      beta_hi: int = 12, anneal_iters: int = 40,
                      ladder: int = 3, image_width: int = 1920,
                      backend: str = "cuda", device: DeviceLike = None,
                      verify: bool = False) -> DSEResult:
    """Search per-stage (alpha, beta) assignments under an error budget.

    `column` names the plan's sound column (default column when None) —
    it bounds every alpha move; the profile column, when present, seeds
    the starting point.  `backend` is the scoring executor and `device`
    where it runs (see `Evaluator`; ``None`` means the card, and it raises
    without one).  `verify=True` re-scores every frontier point through
    the kernel path, asserts bit-equality with its recorded score and
    cross-checks the oracle (`Evaluator.verify`, `DesignPoint.verified`).
    """
    col = plan._col(column)
    sound_alphas = plan.alphas(col)
    signed = plan.signed(col)
    frontier = Frontier(budget)

    def sink(point: DesignPoint) -> None:
        disp = frontier.add(point)
        if disp == "accepted":
            DSE_STATS.add("accepted")
            obs.event("dse.accept", pipeline=pipeline.name,
                      strategy=point.strategy, psnr=round(point.psnr, 3),
                      power=point.power, area=point.area,
                      total_bits=point.total_bits)
        else:
            DSE_STATS.add("rejected")
            obs.event("dse.reject", pipeline=pipeline.name,
                      strategy=point.strategy, reason=disp)

    evaluator = Evaluator(pipeline, signed, images, budget,
                          params=params, image_width=image_width,
                          backend=backend, plan_hash=plan.content_hash,
                          plan_column=col, sink=sink, device=device)
    with obs.span("dse.search", pipeline=pipeline.name, column=col,
                  seed=seed, backend=backend) as sp:
        start = seed_alphas(plan, column)
        clusters = homogeneity_clusters(pipeline, plan.stage_ranges(col))

        # 1+2: plan-seeded §V-B beta sweep at the seed alphas
        betas, beta_res = seeded_beta_sweep(
            evaluator, pipeline, start, budget.min_psnr, beta_hi=beta_hi)

        # 3: greedy shared-alpha narrowing over the homogeneity clusters
        alphas = cluster_alpha_descent(evaluator, pipeline, clusters,
                                       start, betas, sound_alphas)

        # 4: NAS-style annealing controller around the greedy design
        flt = cost_model.design_cost(
            pipeline, cost_model.float_design(pipeline), image_width)
        best_a, best_b = anneal(
            evaluator, pipeline, clusters, alphas, betas, sound_alphas,
            power_ref=flt.power_proxy,
            area_ref=flt.lut_bits + flt.dsp_bits,
            seed=seed, iters=anneal_iters, beta_hi=beta_hi)

        # 5: quality ladders — the frontier is a trade-off curve, not one
        # winner: step the best design's betas upward (what each extra
        # fractional bit buys in PSNR) and its alphas toward the sound
        # column (what lifting saturation buys), so the caller sees the
        # whole error axis, not just the cheapest feasible corner
        for k in range(1, ladder + 1):
            up_a = {n: min(a + k, sound_alphas[n])
                    for n, a in best_a.items()}
            up_b = {n: min(b + k, beta_hi) for n, b in best_b.items()}
            evaluator.evaluate(best_a, up_b, strategy="beta-ladder")
            evaluator.evaluate(up_a, best_b, strategy="alpha-ladder")
            # saturation and rounding error cap each other: stepping both
            # knobs is what actually climbs the quality axis
            evaluator.evaluate(up_a, up_b, strategy="joint-ladder")

        if verify:
            for p in frontier.points():
                evaluator.verify(p)
        frontier.check_invariants()
        chosen = frontier.best("power")
        sp.set(evaluations=len(evaluator._memo),
               frontier=len(frontier),
               chosen_psnr=(round(chosen.psnr, 3) if chosen else None),
               chosen_power=(chosen.power if chosen else None))
    return DSEResult(frontier=frontier, chosen=chosen, clusters=clusters,
                     beta_result=beta_res,
                     evaluations=len(evaluator._memo), plan_column=col)
