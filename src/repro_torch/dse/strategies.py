"""Search strategies, layered cheap → smart.

Every strategy speaks the same currency: it proposes candidate
`(alphas, betas)` assignments to an `Evaluator` (emitting a
`dse.propose` span per proposal batch) and lets the measured
`DesignPoint`s flow into the frontier through the evaluator sink.
Three layers:

  1. `seeded_beta_sweep` — the paper's §V-B heuristic as a DSE strategy:
     plan-seeded uniform beta binary search + reverse-topological
     refinement (`core.beta_search`, un-orphaned), with quality = the
     evaluator's measured worst-output PSNR.  Every probe of the binary
     search is recorded as a first-class candidate.
  2. `cluster_alpha_descent` — greedy alpha-narrowing moves at cluster
     granularity: walk the §IV homogeneity clusters in reverse topo
     order and shave shared integer bits below the profile seed while
     the error budget still holds.  Bounded by [1, sound alpha] from the
     plan — a widening move never exceeds what the sound column proved.
  3. `anneal` — the NAS-style controller loop: propose a random
     cluster-level ±1 (alpha|beta) mutation, evaluate it for real,
     accept on improvement or with Boltzmann probability under a
     geometric temperature schedule.  Seeded `random.Random` end to end,
     so the whole search replays bit-identically.

The port's own copy of `repro.dse.strategies`.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core import beta_search
from repro_torch.core.beta_search import BetaSearchResult
from repro_torch.core.graph import Pipeline
from repro_torch.dse.evaluate import Evaluator
from repro_torch.dse.frontier import DesignPoint

Assignment = Tuple[Dict[str, int], Dict[str, int]]   # (alphas, betas)


def seeded_beta_sweep(evaluator: Evaluator, pipeline: Pipeline,
                      alphas: Dict[str, int], target_psnr: float,
                      beta_hi: int = 12, frozen: Sequence[str] = (),
                      ) -> Tuple[Dict[str, int], BetaSearchResult]:
    """Strategy 1: uniform beta sweep + reverse-topo refine (§V-B)."""
    with obs.span("dse.propose", strategy="beta-sweep",
                  pipeline=pipeline.name, beta_hi=beta_hi) as sp:
        qf = evaluator.quality_fn(alphas, strategy="beta-sweep")
        res = beta_search.search(pipeline, qf, target_psnr,
                                 beta_hi=beta_hi, frozen=frozen)
        sp.set(uniform_beta=res.uniform_beta, passes=res.profile_passes,
               quality=round(res.quality, 3))
    return dict(res.betas), res


def cluster_alpha_descent(evaluator: Evaluator, pipeline: Pipeline,
                          clusters: List[List[str]],
                          alphas: Dict[str, int], betas: Dict[str, int],
                          sound_alphas: Dict[str, int],
                          ) -> Dict[str, int]:
    """Strategy 2: greedy shared-alpha narrowing per homogeneity cluster.

    Inputs (is_input stages) keep their alphas — their representation is
    fixed by the source data, not the design.  Returns the refined alphas.
    """
    alphas = dict(alphas)
    order = list(reversed(clusters))
    for members in order:
        if any(pipeline.stages[m].is_input for m in members):
            continue
        while min(alphas[m] for m in members) > 1:
            with obs.span("dse.propose", strategy="alpha-descent",
                          pipeline=pipeline.name,
                          cluster=",".join(members)) as sp:
                trial = dict(alphas)
                for m in members:
                    trial[m] = max(alphas[m] - 1, 1)
                point = evaluator.evaluate(trial, betas,
                                           strategy="alpha-descent")
                sp.set(meets_budget=point.meets_budget,
                       psnr=round(point.psnr, 3), power=point.power)
            if not point.meets_budget:
                break
            alphas = trial
    return alphas


def _energy(point: DesignPoint, power_ref: float, area_ref: float,
            min_psnr: float) -> float:
    """Scalarized annealing objective (lower = better).

    Feasible designs score their float-normalized power + area; budget
    violations pay a constant wall plus their PSNR shortfall, so the
    walk can brush the boundary but never settles outside it.
    """
    e = point.power / power_ref + point.area / area_ref
    if not point.meets_budget:
        e += 4.0 + max(min_psnr - point.psnr, 0.0) / 10.0
    return e


def anneal(evaluator: Evaluator, pipeline: Pipeline,
           clusters: List[List[str]], alphas: Dict[str, int],
           betas: Dict[str, int], sound_alphas: Dict[str, int],
           power_ref: float, area_ref: float, *,
           seed: int = 0, iters: int = 40, beta_hi: int = 12,
           t0: float = 0.25, decay: float = 0.92) -> Assignment:
    """Strategy 3: the NAS-style propose → evaluate → accept/refine loop.

    Mutations are cluster-level ±1 steps on alpha (clamped to
    [1, cluster max sound alpha] — never wider than the plan proved
    sound) or beta (clamped to [0, beta_hi]).  Acceptance is simulated
    annealing on the measured, float-normalized power+area energy with a
    geometric temperature schedule; the frontier independently keeps
    every feasible non-dominated probe, so a rejected move is not lost.
    """
    rng = random.Random(seed)
    movable = [c for c in clusters
               if not any(pipeline.stages[m].is_input for m in c)]
    if not movable or iters <= 0:
        return dict(alphas), dict(betas)
    cur_a, cur_b = dict(alphas), dict(betas)
    cur = evaluator.evaluate(cur_a, cur_b, strategy="anneal")
    cur_e = _energy(cur, power_ref, area_ref, evaluator.budget.min_psnr)
    best_a, best_b, best_e = dict(cur_a), dict(cur_b), cur_e
    temp = t0
    for i in range(iters):
        members = movable[rng.randrange(len(movable))]
        knob = rng.choice(("alpha", "beta"))
        delta = rng.choice((-1, 1))
        trial_a, trial_b = dict(cur_a), dict(cur_b)
        if knob == "alpha":
            cap = max(sound_alphas[m] for m in members)
            for m in members:
                trial_a[m] = min(max(trial_a[m] + delta, 1), cap)
        else:
            for m in members:
                trial_b[m] = min(max(trial_b[m] + delta, 0), beta_hi)
        if (trial_a, trial_b) == (cur_a, cur_b):   # clamped into a no-op
            temp *= decay
            continue
        with obs.span("dse.propose", strategy="anneal",
                      pipeline=pipeline.name, step=i, knob=knob,
                      delta=delta, cluster=",".join(members),
                      temp=round(temp, 4)) as sp:
            point = evaluator.evaluate(trial_a, trial_b, strategy="anneal")
            e = _energy(point, power_ref, area_ref,
                        evaluator.budget.min_psnr)
            accept = e < cur_e or rng.random() < math.exp(
                min((cur_e - e) / max(temp, 1e-9), 0.0))
            sp.set(energy=round(e, 4), accepted=accept,
                   meets_budget=point.meets_budget)
        if accept:
            cur_a, cur_b, cur_e = trial_a, trial_b, e
            if point.meets_budget and e < best_e:
                best_a, best_b, best_e = dict(trial_a), dict(trial_b), e
        temp *= decay
    return best_a, best_b
