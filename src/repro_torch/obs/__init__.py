"""`repro_torch.obs` — tracing, counters and runtime telemetry for the
analysis, the SMT engine, the design search and the executors.

Port of `repro.obs`::

    from repro_torch import obs

    with obs.tracing(runtime_ranges=True) as tr:
        plan = run_plan(pipe, ["interval", "affine"])
        run_fixed(pipe, imgs, plan, backend="cuda")
    obs.write_chrome_trace(tr, "trace.json")     # perfetto-loadable
    obs.write_jsonl(tr, "trace.jsonl")           # obs.report input

Submodules: `tracer` (spans, events, gauges, counter groups), `exporters`
(JSONL and Chrome trace-event JSON), `runtime` (per-stage range,
saturation and headroom telemetry, reduced on the device the values are
on), `report` (per-stage summary tables, also a command line:
``python -m repro_torch.obs.report trace.jsonl``) and `warnonce`.
"""
from repro_torch.obs.tracer import (CounterGroup, Span, Tracer,
                                    active_tracer, all_counters, disable,
                                    enable, event, gauge, is_enabled,
                                    runtime_ranges_enabled, span, tracing)
from repro_torch.obs.exporters import (load_jsonl, to_chrome_trace,
                                       to_jsonl_records, write_chrome_trace,
                                       write_jsonl)
from repro_torch.obs.warnonce import reset_warn_once, warn_once
from repro_torch.obs import runtime

__all__ = [
    "CounterGroup", "Span", "Tracer", "active_tracer", "all_counters",
    "disable", "enable", "event", "gauge", "is_enabled", "load_jsonl",
    "reset_warn_once", "runtime", "runtime_ranges_enabled", "span",
    "to_chrome_trace", "to_jsonl_records", "tracing", "warn_once",
    "write_chrome_trace", "write_jsonl",
]
