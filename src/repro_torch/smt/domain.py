"""Registry glue: the "smt" entry in the pluggable-domain registry.

The paper's §IV-C framework treats an analysis as a type parameter swap;
`analyze(pipe, domain="smt")` should therefore be the whole integration
effort.  Unlike interval/affine, the SMT analysis is *whole-DAG* — it
cannot run as a per-stage expression walk — so the domain carries a
`whole_dag` marker plus an `analyze_pipeline` hook that
`core.range_analysis.analyze` dispatches to.

The per-expression protocol methods still behave like the interval domain,
so code that feeds this domain to `eval_expr_abstract` directly (e.g. the
per-pixel abstract executor) degrades gracefully to interval semantics.

Two registry entries share this adapter: `"smt"` answers queries with the
batched-box engine (the frontier as tensors on `device`, ``None`` meaning
the card), and `"smt-scalar"` pins the box-at-a-time reference oracle on
the host — useful for differential testing and for debugging solver
regressions through the same `analyze(pipe, domain=...)` surface.

The port's own copy of `repro.smt.domain`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.absval import register_domain
from repro_torch.core.interval import Interval
from repro_torch.device import DeviceLike

from repro_torch.smt.optimize import SMTConfig, analyze_smt


class SMTDomain:
    name = "smt"
    whole_dag = True     # range_analysis.analyze dispatches to analyze_pipeline
    engine = "batched"

    def __init__(self, config: Optional[SMTConfig] = None,
                 device: DeviceLike = None):
        if config is None:
            config = SMTConfig(engine=self.engine)
        elif config.engine != self.engine:
            config = dataclasses.replace(config, engine=self.engine)
        self.config = config
        self.device = device

    # -- whole-DAG entry point ----------------------------------------------
    def analyze_pipeline(self, pipeline,
                         input_ranges: Optional[Dict[str, Interval]] = None):
        return analyze_smt(pipeline, input_ranges=input_ranges,
                           config=self.config, device=self.device)

    # -- per-expression protocol (interval fallback) ------------------------
    def const(self, v: float) -> Interval:
        return Interval.point(v)

    def fresh_signal(self, rng: Interval) -> Interval:
        return rng

    def to_interval(self, v: Interval) -> Interval:
        return v


class SMTScalarDomain(SMTDomain):
    """Reference-oracle twin: same analysis, scalar branch-and-prune."""
    name = "smt-scalar"
    engine = "scalar"


register_domain("smt", SMTDomain)
register_domain("smt-scalar", SMTScalarDomain)
