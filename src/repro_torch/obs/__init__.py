"""`repro_torch.obs` — tracing and counters for the analysis driver,
the design search and the executor cache.

Port of the part of `repro.obs` that `analysis.driver`, `dse` and
`dsl.exec` use: spans (`analysis.pass`, `dse.search`, `dse.evaluate`,
`lowering.lower`, `lowering.encode`, ...), events and counter groups
(`tracer`) and the process-once warning (`warnonce`)::

    from repro_torch import obs
    with obs.tracing() as tr:
        plan = run_plan(pipe, ["interval", "affine"])
    [(s.name, s.attrs["column"]) for s in tr.spans("analysis.pass")]
"""
from repro_torch.obs.tracer import (CounterGroup, Span, Tracer, event, span,
                                    tracing)
from repro_torch.obs.warnonce import reset_warn_once, warn_once

__all__ = ["CounterGroup", "Span", "Tracer", "event", "reset_warn_once",
           "span", "tracing", "warn_once"]
