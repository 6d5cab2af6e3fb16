"""`repro_torch.dse` — closed-loop bitwidth design-space exploration.

The port of `repro.dse`: search per-stage `(alpha, beta)` assignments
against `cost_model.design_cost` under a measured output-error budget
and return a Pareto frontier of error vs area/power.  On the card every
candidate is scored by one launch of the band kernel per rate island
over all calibration images, reduced on the device.

    from repro_torch.analysis import ProfilePass, run_plan
    from repro_torch.dse import ErrorBudget, run_design_search
    plan = run_plan(pipe, ["interval", ProfilePass(images, params=p)])
    res = run_design_search(pipe, plan, images,
                            ErrorBudget(min_psnr=50.0), params=p)
    res.chosen            # cheapest feasible DesignPoint
    res.frontier.to_json()

Pieces: `frontier` (DesignPoint / Frontier model + serde), `evaluate`
(measured scoring through `run_fixed`, executor-cache memoized),
`betas` (plan-aware §V-B beta search over `core.beta_search`),
`strategies` (beta sweep / cluster alpha descent / annealing controller),
`driver` (`run_design_search`).  Homogeneity clustering itself is an
analysis pass — `repro_torch.analysis.ClusterPass`.
"""
from repro_torch.dse.betas import (min_output_psnr, quality_fn_from_plan,
                                   search_betas)
from repro_torch.dse.driver import DSEResult, run_design_search, seed_alphas
from repro_torch.dse.evaluate import (DSE_STATS, Evaluator, output_stages,
                                      psnr_of)
from repro_torch.dse.frontier import (PSNR_CAP, DesignPoint, ErrorBudget,
                                      Frontier)
from repro_torch.dse.strategies import (anneal, cluster_alpha_descent,
                                        seeded_beta_sweep)

__all__ = [
    "DSE_STATS", "DSEResult", "DesignPoint", "ErrorBudget", "Evaluator",
    "Frontier", "PSNR_CAP", "anneal", "cluster_alpha_descent",
    "min_output_psnr", "output_stages", "psnr_of", "quality_fn_from_plan",
    "run_design_search", "search_betas", "seed_alphas",
    "seeded_beta_sweep",
]
