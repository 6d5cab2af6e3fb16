"""Per-stage trace summarizer: `python -m repro_torch.obs.report <trace.jsonl>`.

Port of `repro.obs.report`.  Reads the JSONL stream written by
`repro_torch.obs.exporters.write_jsonl` (or the reference's) and prints
its tables (plain text, or GitHub-flavoured markdown with `--markdown`):

  * **analysis passes** — one row per `analysis.pass` span: time and
    memo/disk-cache disposition;
  * **SMT stages** — one row per `smt.stage` span: time, boxes explored,
    boxes/s, budget consumed vs granted, verdict, and a `!budget` marker
    on deadline-exhausted stages;
  * **runtime stages** — execution time per stage (`exec.stage` spans)
    joined with `rt.range` telemetry: observed min/max, saturation
    counts, and alpha headroom (plan bits − observed bits);
  * **islands** — one row per rate island of the band-kernel executor
    (`exec.cuda.island` spans, or the reference's `exec.pallas.island`):
    rate, fused stage count, grid, carrier mix, stored-container mix
    with the boundary-buffer MB it materializes and the MB saved vs a
    uniform int32 baseline, and host time aggregated over calls;
  * **design search** — per-strategy evaluation rollup (`dse.evaluate`
    spans + cached hits) and the Pareto frontier as accepted during the
    search (`dse.accept` events): psnr / power / area / total bits.

`summarize` / `render` are importable for programmatic use (benchmarks,
examples, tests).
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

__all__ = ["main", "render", "summarize"]

# the band-kernel executor's island spans (the reference names its own
# `exec.pallas.island`; either trace summarizes)
_ISLAND_SPANS = ("exec.cuda.island", "exec.pallas.island")


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or 0 < abs(v) < 0.01:
            return f"{v:.3g}"
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def _table(title: str, cols: List[str], rows: List[Dict[str, Any]],
           markdown: bool) -> str:
    if not rows:
        return ""
    cells = [[_fmt(r.get(c)) for c in cols] for r in rows]
    if markdown:
        lines = [f"#### {title}", "",
                 "| " + " | ".join(cols) + " |",
                 "|" + "|".join("---" for _ in cols) + "|"]
        lines += ["| " + " | ".join(row) + " |" for row in cells]
        return "\n".join(lines) + "\n"
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(cols)]
    sep = "  "
    lines = [f"== {title} ==",
             sep.join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += [sep.join(x.ljust(w) for x, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines) + "\n"


def summarize(records: List[dict]) -> Dict[str, List[Dict[str, Any]]]:
    """Aggregate JSONL records into {passes, smt_stages, runtime} rows."""
    spans = [r for r in records if r.get("kind") == "span"]
    events = [r for r in records if r.get("kind") == "event"]

    passes = []
    for s in spans:
        if s["name"] != "analysis.pass":
            continue
        a = s.get("attrs", {})
        passes.append({
            "pass": a.get("pass", "?"), "column": a.get("column"),
            "ms": s["dur_us"] / 1e3, "memo": a.get("memo"),
        })

    smt_rows = []
    for s in spans:
        if s["name"] != "smt.stage":
            continue
        a = s.get("attrs", {})
        ms = s["dur_us"] / 1e3
        boxes = a.get("boxes")
        row = {
            "stage": a.get("stage", "?"), "ms": ms, "boxes": boxes,
            "boxes/s": (boxes / (ms / 1e3)) if boxes and ms > 0 else None,
            "budget_s": a.get("budget_s"), "consumed_s": a.get("consumed_s"),
            "verdict": a.get("verdict"),
        }
        if a.get("deadline_exhausted"):
            row["verdict"] = f"{row['verdict'] or 'seed'} !budget"
        smt_rows.append(row)

    exec_ms: Dict[str, float] = {}
    for s in spans:
        if s["name"] == "exec.stage":
            st = s.get("attrs", {}).get("stage", "?")
            exec_ms[st] = exec_ms.get(st, 0.0) + s["dur_us"] / 1e3
    runtime = []
    seen = set()
    for e in events:
        if e["name"] != "rt.range":
            continue
        a = e.get("attrs", {})
        st = a.get("stage", "?")
        if st in seen:      # first observation per stage keeps the table small
            continue
        seen.add(st)
        runtime.append({
            "stage": st, "type": a.get("type"),
            "exec_ms": exec_ms.get(st),
            "min": a.get("min"), "max": a.get("max"),
            "sat": a.get("sat"),
            "alpha_plan": a.get("alpha_plan"), "alpha_obs": a.get("alpha_obs"),
            "headroom": a.get("headroom"),
        })
    for st, ms in exec_ms.items():      # spans without telemetry still show
        if st not in seen:
            runtime.append({"stage": st, "exec_ms": ms})

    isl: Dict[tuple, Dict[str, Any]] = {}
    for s in spans:
        if s["name"] not in _ISLAND_SPANS:
            continue
        a = s.get("attrs", {})
        key = (a.get("island"), a.get("rate"), a.get("carriers"),
               a.get("containers"))
        row = isl.setdefault(key, {
            "island": a.get("island"), "rate": a.get("rate"),
            "stages": a.get("stages"), "grid": a.get("grid"),
            "single_tile": a.get("single_tile"),
            "carriers": a.get("carriers"),
            "containers": a.get("containers"),
            "out_mb": a.get("out_mb"), "saved_mb": a.get("saved_mb"),
            "ms": 0.0, "calls": 0,
        })
        row["ms"] += s["dur_us"] / 1e3
        row["calls"] += 1
    islands = sorted(isl.values(), key=lambda r: (r["island"] is None,
                                                  r["island"]))

    # design search: per-strategy evaluation rollup (dse.evaluate spans +
    # cached-hit events) and the frontier as accepted (dse.accept events)
    strat: Dict[tuple, Dict[str, Any]] = {}
    for s in spans:
        if s["name"] != "dse.evaluate":
            continue
        a = s.get("attrs", {})
        key = (a.get("pipeline"), a.get("strategy") or "?")
        row = strat.setdefault(key, {
            "pipeline": key[0], "strategy": key[1],
            "evals": 0, "cached": 0, "ms": 0.0, "best_psnr": None,
        })
        row["evals"] += 1
        row["ms"] += s["dur_us"] / 1e3
        p = a.get("psnr")
        if p is not None and (row["best_psnr"] is None
                              or p > row["best_psnr"]):
            row["best_psnr"] = p
    for e in events:
        if e["name"] != "dse.evaluate":
            continue
        a = e.get("attrs", {})
        key = (a.get("pipeline"), a.get("strategy") or "?")
        if key in strat:
            strat[key]["cached"] += 1
    dse_strategies = sorted(strat.values(),
                            key=lambda r: (str(r["pipeline"]),
                                           -r["evals"], r["strategy"]))

    dse_frontier = []
    for e in events:
        if e["name"] != "dse.accept":
            continue
        a = e.get("attrs", {})
        dse_frontier.append({
            "pipeline": a.get("pipeline"), "strategy": a.get("strategy"),
            "psnr": a.get("psnr"), "power": a.get("power"),
            "area": a.get("area"), "total_bits": a.get("total_bits"),
        })
    dse_frontier.sort(key=lambda r: (str(r["pipeline"]),
                                     r["power"] if r["power"] is not None
                                     else 0.0))

    return {"passes": passes, "smt_stages": smt_rows, "runtime": runtime,
            "islands": islands, "dse_strategies": dse_strategies,
            "dse_frontier": dse_frontier}


def render(summary: Dict[str, List[Dict[str, Any]]],
           markdown: bool = False) -> str:
    parts = [
        _table("analysis passes", ["pass", "column", "ms", "memo"],
               summary["passes"], markdown),
        _table("smt stages",
               ["stage", "ms", "boxes", "boxes/s", "budget_s",
                "consumed_s", "verdict"],
               summary["smt_stages"], markdown),
        _table("runtime stages",
               ["stage", "type", "exec_ms", "min", "max", "sat",
                "alpha_plan", "alpha_obs", "headroom"],
               summary["runtime"], markdown),
        _table("islands",
               ["island", "rate", "stages", "grid", "single_tile",
                "carriers", "containers", "out_mb", "saved_mb",
                "ms", "calls"],
               summary.get("islands", []), markdown),
        _table("design search strategies",
               ["pipeline", "strategy", "evals", "cached", "ms",
                "best_psnr"],
               summary.get("dse_strategies", []), markdown),
        _table("design frontier (accepted points)",
               ["pipeline", "strategy", "psnr", "power", "area",
                "total_bits"],
               summary.get("dse_frontier", []), markdown),
    ]
    out = "\n".join(p for p in parts if p)
    return out if out else "(trace contains no summarizable spans)\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize an obs JSONL trace into per-stage tables.")
    ap.add_argument("trace", help="path to a .jsonl trace file")
    ap.add_argument("--markdown", action="store_true",
                    help="emit GitHub-flavoured markdown tables")
    args = ap.parse_args(argv)
    from repro_torch.obs.exporters import load_jsonl
    print(render(summarize(load_jsonl(args.trace)), markdown=args.markdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
