"""Trace exporters: JSONL event stream + Chrome trace-event JSON.

Port of `repro.obs.exporters`.  Two serializations of the same `Tracer`
contents:

  * **JSONL** — one JSON object per line, machine-first.  Spans carry
    `{"kind": "span", "name", "id", "parent", "ts_us", "dur_us",
    "thread", "attrs"}`; instant events and gauges keep their `kind`;
    the final line is a `{"kind": "counters"}` snapshot of every
    registered `CounterGroup`.  `repro_torch.obs.report` and the tests consume
    this form via `load_jsonl`.
  * **Chrome trace-event JSON** — `{"traceEvents": [...]}` with `ph:"X"`
    complete events (ts/dur in microseconds), `ph:"i"` instants and
    `ph:"C"` counter samples, loadable in Perfetto (ui.perfetto.dev) or
    `chrome://tracing`.

Attribute values are sanitized with `_jsonable` (numpy scalars and 0-dim
tensors, on the host or the card, → Python numbers; small arrays and
tensors → lists; unknown objects → `repr`), so instrumentation sites may
attach Intervals, numpy results or device scalars without worrying about
serializability.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List

from repro_torch.obs.tracer import Tracer, all_counters

__all__ = [
    "load_jsonl", "to_chrome_trace", "to_jsonl_records",
    "write_chrome_trace", "write_jsonl",
]


def _jsonable(v: Any) -> Any:
    """Best-effort conversion to a JSON-serializable value."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)          # "inf" / "-inf" / "nan": JSON has none
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    # numpy scalars and tensors (a CUDA tensor is copied to the host)
    import numpy as np
    import torch
    if isinstance(v, torch.Tensor):
        if v.numel() == 1 and v.ndim == 0:
            return _jsonable(v.item())
        if v.numel() <= 16:
            return [_jsonable(x) for x in v.detach().cpu().tolist()]
        return repr(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return _jsonable(float(v))
    if isinstance(v, np.ndarray) and v.size <= 16:
        return [_jsonable(x) for x in v.tolist()]
    return repr(v)


def _attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {str(k): _jsonable(v) for k, v in attrs.items()}


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def to_jsonl_records(tracer: Tracer) -> List[dict]:
    """The JSONL schema as a list of dicts (ts_us/dur_us relative to the
    tracer origin), ordered by start time; counters snapshot last."""
    recs: List[dict] = [{
        "kind": "meta",
        "wall_t0": tracer.wall_t0,
        "runtime_ranges": tracer.runtime_ranges,
    }]
    rows = [(s.t0, 0, {
        "kind": "span", "name": s.name, "id": s.span_id,
        "parent": s.parent_id, "ts_us": tracer.us(s.t0),
        "dur_us": (s.t1 - s.t0) * 1e6, "thread": s.thread_id,
        "attrs": _attrs(s.attrs),
    }) for s in tracer.spans()]
    for e in tracer.events():
        rec = {"kind": e["kind"], "name": e["name"],
               "ts_us": tracer.us(e["ts"]), "thread": e["thread"],
               "attrs": _attrs(e["attrs"])}
        if e["kind"] == "event":
            rec["parent"] = e["parent"]
        else:
            rec["value"] = _jsonable(e["value"])
        rows.append((e["ts"], 1, rec))
    rows.sort(key=lambda r: (r[0], r[1]))
    recs.extend(r[2] for r in rows)
    recs.append({"kind": "counters", "values": _jsonable(all_counters())})
    return recs


def write_jsonl(tracer: Tracer, path) -> None:
    with open(path, "w") as f:
        for rec in to_jsonl_records(tracer):
            f.write(json.dumps(rec) + "\n")


def load_jsonl(path) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def to_chrome_trace(tracer: Tracer, process_name: str = "repro_torch"
                    ) -> dict:
    ev: List[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for s in tracer.spans():
        ev.append({
            "ph": "X", "pid": 0, "tid": s.thread_id,
            "name": s.name, "cat": s.name.split(".", 1)[0],
            "ts": tracer.us(s.t0), "dur": (s.t1 - s.t0) * 1e6,
            "args": _attrs(s.attrs),
        })
    for e in tracer.events():
        if e["kind"] == "gauge":
            val = e["value"]
            if not isinstance(val, (int, float)):
                continue            # Chrome counter tracks are numeric-only
            ev.append({
                "ph": "C", "pid": 0, "tid": e["thread"],
                "name": e["name"], "ts": tracer.us(e["ts"]),
                "args": {"value": _jsonable(val)},
            })
        else:
            ev.append({
                "ph": "i", "s": "t", "pid": 0, "tid": e["thread"],
                "name": e["name"], "cat": e["name"].split(".", 1)[0],
                "ts": tracer.us(e["ts"]), "args": _attrs(e["attrs"]),
            })
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"counters": _jsonable(all_counters())}}


def write_chrome_trace(tracer: Tracer, path,
                       process_name: str = "repro_torch") -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, process_name), f)
