"""Per-benchmark alpha delta of the port's Table 11 plans vs the goldens.

    python -m repro_torch.benchmarks.alpha_delta [--markdown] \\
        [--plans chiprun_out/paper_tables/table11_plans.json] \\
        [--golden benchmarks/results/table11_plans.json]

Port of the reference's `benchmarks/alpha_delta.py`.  `--plans` is the
port's artifact, one serialized `BitwidthPlan` per benchmark group,
written by `paper_tables.table11_smt_alphas` with the device it ran on;
`--golden` is the committed reference artifact under
`benchmarks/results/` (plan JSON or the legacy rows format), which this
script only reads.  It prints one summary line per benchmark group:
every per-stage smt alpha move (port against golden), the group's alpha
sums per column beside the golden's smt sum, and the stages whose smt
alpha is an interval seed because the time budget ran out.

Exit status is non-zero when any smt alpha grew on a stage both
artifacts know, or when a golden row is missing from the port's plans.
At the reference's time budgets the smt column depends on the engine's
speed on the device, so a grown alpha there is a measurement of that
device, recorded, not hidden.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
PLANS = os.path.join(REPO_ROOT, "chiprun_out", "paper_tables",
                     "table11_plans.json")
GOLDEN = os.path.join(REPO_ROOT, "benchmarks", "results",
                      "table11_plans.json")

Alphas = Dict[Tuple[str, str], Tuple[int, int, int]]


def load(path: str) -> Alphas:
    """(group, stage) -> (interval, smt, profile) alphas, either format."""
    with open(path) as f:
        data = json.load(f)
    if "groups" in data:           # plan JSON (BitwidthPlan per group)
        out = {}
        for g, plan in data["groups"].items():
            cols = plan["columns"]
            for stage in cols["interval"]:
                out[(g, stage)] = (int(cols["interval"][stage]["alpha"]),
                                   int(cols["smt"][stage]["alpha"]),
                                   int(cols["profile"][stage]["alpha"]))
        return out
    return {(r[0], r[1]): (int(r[2]), int(r[3]), int(r[4]))
            for r in data["rows"]}


# provenance note SmtPass writes when analyze_smt's time budget ran out on
# a stage and the interval seed was kept (see repro_torch.smt.optimize)
_STARVED_NOTE = "budget-exhausted (seed kept): "


def starved(path: str) -> Dict[str, List[str]]:
    """group -> [stage, ...] whose smt alphas are interval seeds because
    the SMT time budget was exhausted (from plan provenance notes; empty
    for the legacy rows format, which carries no provenance)."""
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, List[str]] = {}
    for g, plan in data.get("groups", {}).items():
        for prov in plan.get("provenance", {}).values():
            for note in prov.get("notes", []):
                if note.startswith(_STARVED_NOTE):
                    stages = [s.strip()
                              for s in note[len(_STARVED_NOTE):].split(",")]
                    out.setdefault(g, []).extend(s for s in stages if s)
    return out


def device_of(path: str) -> str:
    with open(path) as f:
        return json.load(f).get("device", "?")


def report(plans: str, golden: str, markdown: bool = False
           ) -> Tuple[List[str], List, List]:
    """(printed lines, regressed stages, golden rows missing)."""
    got, want = load(plans), load(golden)
    kept = starved(plans)
    groups = defaultdict(lambda: {"delta": 0, "moves": [], "new": 0,
                                  "sums": [0, 0, 0, 0]})
    regressed = []
    for key, (ia, sa, pa) in sorted(got.items()):
        g, stage = key
        sums = groups[g]["sums"]      # interval, smt, profile, golden smt
        sums[0] += ia
        sums[1] += sa
        sums[2] += pa
        sums[3] += want.get(key, (0, 0, 0))[1]
        if key not in want:
            groups[g]["new"] += 1
            continue
        d = sa - want[key][1]          # negative = bits recovered
        if d:
            groups[g]["delta"] += d
            groups[g]["moves"].append(f"{stage} {want[key][1]}->{sa}")
        if d > 0:
            regressed.append((key, want[key][1], sa))
    dropped = sorted(set(want) - set(got))
    lines = []
    if markdown:
        lines += [f"### table11 smt alpha delta vs golden "
                  f"({device_of(plans)})", "",
                  "| benchmark | alpha bits moved | stages | new stages "
                  "| budget-starved | sum interval / smt / profile "
                  "| golden smt |", "|---|---|---|---|---|---|---|"]
        for g in sorted(set(k[0] for k in got)):
            info = groups[g]
            moves = ", ".join(info["moves"]) or "—"
            seeds = ", ".join(sorted(set(kept.get(g, [])))) or "—"
            i_, s_, p_, w_ = info["sums"]
            lines.append(f"| {g} | {info['delta']:+d} | {moves} | "
                         f"{info['new']} | {seeds} | {i_} / {s_} / {p_} "
                         f"| {w_} |")
    else:
        lines.append(f"plans: {plans} ({device_of(plans)}); golden: "
                     f"{golden}")
        for g in sorted(set(k[0] for k in got)):
            info = groups[g]
            moves = ", ".join(info["moves"]) or "none"
            i_, s_, p_, w_ = info["sums"]
            line = (f"{g}: delta {info['delta']:+d} bits "
                    f"({moves}; {info['new']} new stages); alpha sums "
                    f"interval {i_}, smt {s_} (golden {w_}), profile {p_}")
            seeds = sorted(set(kept.get(g, [])))
            if seeds:
                line += ("  [budget-exhausted, seed kept: "
                         + ", ".join(seeds) + "]")
            lines.append(line)
    return lines, regressed, dropped


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.alpha_delta")
    ap.add_argument("--markdown", action="store_true",
                    help="emit a GitHub-flavored markdown table")
    ap.add_argument("--plans", default=PLANS,
                    help="the port's table11_plans.json")
    ap.add_argument("--golden", default=GOLDEN,
                    help="the committed golden table11_plans.json")
    args = ap.parse_args(argv)
    lines, regressed, dropped = report(args.plans, args.golden,
                                       args.markdown)
    print("\n".join(lines))
    if regressed:
        print(f"\nALPHA REGRESSION on {len(regressed)} stage(s): "
              f"{regressed}", file=sys.stderr)
    if dropped:
        print(f"\nGOLDEN ROWS MISSING from the port's plans: {dropped}",
              file=sys.stderr)
    return 1 if (regressed or dropped) else 0


if __name__ == "__main__":
    sys.exit(main())
