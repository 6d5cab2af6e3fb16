"""`repro_torch.analysis` — the composable analysis-pass architecture
(paper §V), the port of `repro.analysis`.

One pass pipeline, one artifact: analyses (interval / affine / intersect /
smt / profile) are `AnalysisPass`es composed with `meet` / `refine` /
`widen_to` / `cluster`; `run_plan` executes the declared pass DAG once
per pipeline with content-hash memoization and emits a single
`BitwidthPlan` — per-stage range columns with provenance, optional
per-phase sub-columns, beta assignments, and stable JSON serialization.

    from repro_torch.analysis import ProfilePass, cluster, refine, run_plan
    plan = run_plan(pipe, ["interval", "affine", "intersect",
                           ProfilePass(frames),
                           refine("interval", "profile"),
                           cluster("interval")],
                    betas={n: 4 for n in pipe.stages})
    plan.check_nesting(["profile", "interval"])
    types = plan.types("interval")             # -> dsl.exec.run_fixed

`core.range_analysis.analyze` is a thin shim over a one-pass plan.  The
SMT pass (`SmtPass`, registered as ``"smt"``, ``"smt-scalar"`` and
``"smt-phase-split"``) runs its batched engine on the card unless it is
given a `device`; `cluster()` takes it as its default sub-pass.
"""
from repro_torch.analysis.cluster import (ClusterPass, cluster,
                                          homogeneity_clusters, stage_rates)
from repro_torch.analysis.combinators import (MeetPass, RefinePass,
                                              WidenPass, meet, refine,
                                              widen_to)
from repro_torch.analysis.driver import (DISK_CACHE_STATS, MEMO_STATS,
                                         clear_memo, one_pass_ranges,
                                         pipeline_content_hash, run_plan)
from repro_torch.analysis.passes import (AnalysisPass, DomainPass,
                                         PassResult, ProfilePass, SmtPass,
                                         make_pass, register_pass)
from repro_torch.analysis.plan import (BitwidthPlan, PlanNestingError,
                                       Provenance)

__all__ = [
    "AnalysisPass", "BitwidthPlan", "ClusterPass", "DISK_CACHE_STATS",
    "DomainPass", "MeetPass", "MEMO_STATS",
    "PassResult", "PlanNestingError", "ProfilePass", "Provenance",
    "RefinePass", "SmtPass", "WidenPass", "clear_memo", "cluster",
    "homogeneity_clusters", "make_pass", "meet",
    "one_pass_ranges", "pipeline_content_hash", "refine", "register_pass",
    "run_plan", "stage_rates", "widen_to",
]
