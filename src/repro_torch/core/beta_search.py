"""Fractional-bit (beta) analysis — paper §V-B.

The paper's two-phase heuristic, verbatim:

  1. **Uniform search** — fix integral bits (from static or profile
     analysis), sweep one global beta applied to every stage, and binary
     search for the smallest beta meeting the application quality target.
  2. **Reverse-topological refinement** — one pass over the stages in
     reverse topologically sorted order; at each stage, binary search the
     per-stage beta downward from the uniform estimate while the quality
     target still holds.

Both phases are generic in a `quality_fn(beta_map) -> float` callback
(higher is better), so the same machinery drives HCD corner accuracy, USM
classification error, DUS PSNR, OF angular error, and the LM token-agreement
metric.  The number of profile passes is tracked — the paper's selling point
is that this needs *very few* passes versus simulated annealing.

The port's own copy of `repro.core.beta_search` (pure Python).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

from repro_torch.core.graph import Pipeline

QualityFn = Callable[[Dict[str, int]], float]


@dataclasses.dataclass
class BetaSearchResult:
    betas: Dict[str, int]
    uniform_beta: int
    quality: float
    profile_passes: int


def uniform_beta_search(stage_names: Sequence[str], quality_fn: QualityFn,
                        target: float, beta_hi: int = 16) -> tuple[int, int]:
    """Smallest uniform beta in [0, beta_hi] with quality >= target.

    Returns (beta, passes).  Assumes quality is monotone non-decreasing in
    beta (more precision never hurts) — the same assumption the paper's
    binary search makes.  If even beta_hi misses the target, beta_hi is
    returned (caller sees the achieved quality in the full search).
    """
    passes = 0

    def q(b: int) -> float:
        nonlocal passes
        passes += 1
        return quality_fn({n: b for n in stage_names})

    if q(0) >= target:
        return 0, passes
    lo, hi = 0, beta_hi          # invariant: q(lo) < target
    if q(hi) < target:
        return hi, passes
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if q(mid) >= target:
            hi = mid
        else:
            lo = mid
    return hi, passes


def refine_sequence(order: Sequence[str], betas: Dict[str, int],
                    quality_fn: QualityFn, target: float,
                    beta_lo: int = 0) -> tuple[Dict[str, int], int]:
    """Per-name downward binary searches in the given order (§V-B core).

    For each name in `order`, finds the minimal beta in `[beta_lo, cur]`
    still meeting the target while every other assignment is held fixed.
    This is the refinement kernel shared by the pipeline-stage search
    (`reverse_topo_refine`, beta_lo=0) and, in the reference, the LM
    weight-class search (`repro.quant.autoquant`, beta_lo=MIN_BITS).
    Returns (refined, passes).
    """
    betas = dict(betas)
    passes = 0

    for name in order:
        cur = betas[name]
        if cur <= beta_lo:
            continue
        lo, hi = beta_lo, cur     # find min b in [beta_lo, cur] meeting target

        def q(b: int) -> float:
            nonlocal passes
            passes += 1
            trial = dict(betas)
            trial[name] = b
            return quality_fn(trial)

        if q(beta_lo) >= target:
            betas[name] = beta_lo
            continue
        # invariant: q(lo) < target <= q(hi)  (hi=cur met target on entry)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if q(mid) >= target:
                hi = mid
            else:
                lo = mid
        betas[name] = hi
    return betas, passes


def reverse_topo_refine(pipeline: Pipeline, betas: Dict[str, int],
                        quality_fn: QualityFn, target: float,
                        frozen: Sequence[str] = ()) -> tuple[Dict[str, int], int]:
    """One reverse-topological pass of per-stage binary searches (§V-B).

    `frozen` stages (e.g. 8-bit inputs) are not touched.  Returns the
    refined beta map and the number of profile passes consumed.
    """
    order = [n for n in reversed(pipeline.topo_order()) if n not in frozen]
    return refine_sequence(order, betas, quality_fn, target)


def search(pipeline: Pipeline, quality_fn: QualityFn, target: float,
           beta_hi: int = 16, frozen: Sequence[str] = (),
           fixed_betas: Dict[str, int] | None = None) -> BetaSearchResult:
    """Full beta-analysis: uniform binary search + reverse-topo refinement."""
    names = [n for n in pipeline.topo_order() if n not in frozen]
    fixed = dict(fixed_betas or {})

    def qf(m: Dict[str, int]) -> float:
        return quality_fn({**m, **fixed})

    uni, p1 = uniform_beta_search(names, qf, target, beta_hi)
    start = {n: uni for n in names}
    refined, p2 = reverse_topo_refine(pipeline, start, qf, target, frozen=frozen)
    final_quality = quality_fn({**refined, **fixed})
    return BetaSearchResult(betas={**refined, **fixed}, uniform_beta=uni,
                            quality=final_quality, profile_passes=p1 + p2 + 1)
