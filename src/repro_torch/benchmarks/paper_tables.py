"""The paper's tables and figures on the port (one function each).

Port of the reference's `benchmarks/paper_tables.py`.  Each function takes
the `device` it runs on (``None`` means the card; it raises without one)
and returns ``(rows, derived)``, where `derived` is a short summary line
held against the paper's claims where the claim is hardware-independent
(static analysis) and reported as modeled where the paper measured watts
on a Zynq.  Every fixed-point design a table executes runs through the
port's ``"cuda"`` backend: the band kernel `fused_band.cu` on the card,
its plain version on ``device="cpu"``.

    python -m repro_torch.benchmarks.paper_tables --only table2_hcd_ranges
    python -m repro_torch.benchmarks.paper_tables --device cpu \\
        --only table4_hcd_bitwidths,fig6_beta_sweep

`main` prints ``name,device,seconds,"derived"`` lines and writes each
table's rows to ``<out>/<name>.json`` (default `chiprun_out/paper_tables/`
at the repository root).  Table 11 also writes its plans to
``<out>/table11_plans.json``; it never writes under `benchmarks/results/`,
whose committed goldens `alpha_delta` compares against.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.range_analysis import analyze
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.pipelines import hcd, optical_flow
from repro_torch.pipelines import workflows as W

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
OUT_DIR = os.path.join(REPO_ROOT, "chiprun_out", "paper_tables")

PAPER_TABLE2 = {"img": 8, "Ix": 8, "Iy": 8, "Ixx": 13, "Ixy": 14, "Iyy": 13,
                "Sxx": 16, "Sxy": 17, "Syy": 16, "det": 33, "trace": 17,
                "harris": 34}

Table = Tuple[List, str]


def table2_hcd_ranges(device: DeviceLike = None) -> Table:
    """Paper Table II: HCD static ranges + integral bit-widths (a host
    analysis: `device` is not used)."""
    res = analyze(hcd.build())
    rows = [(k, f"[{v.range.lo:g},{v.range.hi:g}]", v.alpha)
            for k, v in res.items()]
    match = all(res[k].alpha == a for k, a in PAPER_TABLE2.items())
    return rows, f"alpha==paper for {len(PAPER_TABLE2)} stages: {match}"


def _bitwidth_table(setup: W.BenchmarkSetup, beta_hi: int = 10) -> Dict:
    alphas, signed = W.static_alphas(setup.pipeline)
    prof = setup.profile()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = setup.run_beta_search(prof.alpha_max, signed, beta_hi=beta_hi)
    return {
        "alpha_sa": alphas,
        "alpha_max": prof.alpha_max,
        "alpha_avg": prof.alpha_avg,
        "beta": res.betas,
        "signed": signed,
        "quality": res.quality,
        "passes": res.profile_passes,
    }


def table4_hcd_bitwidths(device: DeviceLike = None) -> Table:
    """Paper Table IV: alpha^sa vs alpha^max vs alpha^avg vs beta (HCD)."""
    b = W.make_hcd(n_train=4, n_test=4, shape=(40, 40), device=device)
    t = _bitwidth_table(b)
    rows = [(s, t["alpha_sa"][s], t["alpha_max"][s], t["alpha_avg"][s],
             t["beta"][s]) for s in b.pipeline.topo_order()]
    deep_gap = t["alpha_sa"]["det"] - t["alpha_max"]["det"]
    return rows, (f"profile<=static everywhere; det gap={deep_gap} bits "
                  f"(paper: 3); quality={t['quality']:.2f}% "
                  f"passes={t['passes']}")


def table5_usm_bitwidths(device: DeviceLike = None) -> Table:
    b = W.make_usm(n_train=4, n_test=4, shape=(40, 40), device=device)
    t = _bitwidth_table(b)
    rows = [(s, t["alpha_sa"][s], t["alpha_max"][s], t["alpha_avg"][s],
             t["beta"][s]) for s in b.pipeline.topo_order()]
    return rows, (f"static alphas "
                  f"{[t['alpha_sa'][s] for s in b.pipeline.topo_order()]}"
                  f" == paper [8,8,8,10,9]; quality={t['quality']:.3f}%")


def table8_dus_bitwidths(device: DeviceLike = None) -> Table:
    b = W.make_dus(n_train=4, n_test=4, shape=(40, 40), device=device)
    t = _bitwidth_table(b)
    rows = [(s, t["alpha_sa"][s], t["alpha_max"][s], t["alpha_avg"][s],
             t["beta"][s]) for s in b.pipeline.topo_order()]
    all8 = all(v == 8 for v in t["alpha_sa"].values())
    return rows, f"all static alpha == 8 (paper Table VIII): {all8}"


def table9_of_bitwidths(device: DeviceLike = None) -> Table:
    b = W.make_of(n_pairs=3, shape=(32, 32), device=device)
    t = _bitwidth_table(b, beta_hi=12)
    fams = optical_flow.stage_families()
    rows = [(f, [t["alpha_sa"][s] for s in ss],
             [t["alpha_max"][s] for s in ss],
             [t["beta"][s] for s in ss]) for f, ss in fams.items()]
    v_sa = [t["alpha_sa"][f"Vx{k}"] for k in range(1, 5)]
    v_prof = [t["alpha_max"][f"Vx{k}"] for k in range(1, 5)]
    return rows, (f"V-stage static alpha grows {v_sa} while profile stays "
                  f"{v_prof} (paper: (13,18,25,33) vs (8,8,9,9)); "
                  f"AAE={-t['quality']:.3f} deg")


def _power_area_table(make: Callable[[], W.BenchmarkSetup], name: str,
                      paper_power: float, paper_area: float) -> Table:
    """Tables III/VI/VII/X: float vs alpha^sa vs alpha^avg designs."""
    b = make()
    alphas_sa, signed = W.static_alphas(b.pipeline)
    prof = b.profile()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = b.run_beta_search(prof.alpha_avg, signed, beta_hi=10)
    rows = []
    ratios = {}
    for label, alph in (("float", None), ("alpha_sa", alphas_sa),
                        ("alpha_avg", prof.alpha_avg)):
        if alph is None:
            types = cost_model.float_design(b.pipeline)
            quality = float("nan")
        else:
            types = W.types_from_alpha(b.pipeline, alph, signed, res.betas)
            quality = b.mean_quality(types)
        rep = W.design_report(b.pipeline, types)
        fixed = rep["fixed"] if alph is not None else rep["float"]
        rows.append((label, f"{quality:.3f}", f"{fixed.power_proxy:.0f}",
                     f"{fixed.lut_bits:.0f}", f"{fixed.dsp_bits:.0f}",
                     f"{fixed.bram_bits / 1e3:.0f}k"))
        if alph is not None:
            ratios[label] = rep["improvement"]
    imp = ratios["alpha_avg"]
    return rows, (f"{name}: modeled power x{imp['power']:.1f} "
                  f"area(LUT) x{imp['area_lut']:.1f} DSP x{imp['area_dsp']:.1f}"
                  f" vs float (paper measured x{paper_power} power, "
                  f"x{paper_area} slices)")


def table3_hcd_power(device: DeviceLike = None) -> Table:
    return _power_area_table(lambda: W.make_hcd(4, 4, (40, 40), device),
                             "HCD", 3.8, 6.2)


def table6_usm_power(device: DeviceLike = None) -> Table:
    return _power_area_table(lambda: W.make_usm(4, 4, (40, 40), device),
                             "USM", 1.6, 2.6)


def table7_dus_power(device: DeviceLike = None) -> Table:
    return _power_area_table(lambda: W.make_dus(4, 4, (40, 40), device),
                             "DUS", 1.7, 4.0)


def table10_of_power(device: DeviceLike = None) -> Table:
    return _power_area_table(lambda: W.make_of(3, (32, 32), device), "OF",
                             1.6, 2.5)


def table11_makers(device: DeviceLike = None, smt_configs=None) -> Dict:
    """{group: (setup maker, SMTConfig)} of Table 11 at the reference's
    sizes and budgets (`smt_configs` overrides the configs by group)."""
    from repro_torch.smt import SMTConfig
    makers = {
        "usm": (lambda: W.make_usm(3, 3, (32, 32), device), SMTConfig()),
        "dus": (lambda: W.make_dus(3, 3, (32, 32), device), SMTConfig()),
        "hcd": (lambda: W.make_hcd(3, 3, (32, 32), device), SMTConfig()),
        # optical flow needs the long budget: ~30 stages x two dichotomic
        # passes
        "optical_flow": (lambda: W.make_of(2, (24, 24), device),
                         SMTConfig(time_budget_s=240.0)),
        # phase-split groups: the recovered bits live in the extended
        # pyramid's detail stages and the coarse-to-fine flow stages
        "dus_ext": (lambda: W.make_dus_ext(3, 3, (32, 32), device),
                    SMTConfig()),
        "of_pyramid": (lambda: W.make_of_pyramid(2, (24, 24), device),
                       SMTConfig(time_budget_s=120.0)),
    }
    for g, cfg in (smt_configs or {}).items():
        makers[g] = (makers[g][0], cfg)
    return makers


def table11_smt_alphas(device: DeviceLike = None,
                       out_dir: Optional[str] = None,
                       smt_configs=None,
                       groups: Optional[List[str]] = None) -> Table:
    """Paper §V-B/§VI: interval vs SMT vs profile alpha per stage.

    The SMT column is the whole-DAG branch-and-prune analysis
    (`repro_torch.smt`, its batched engine on `device`); sound analyses
    must nest as profile <= smt <= interval per stage.  Each benchmark
    runs as one `BitwidthPlan` (`BenchmarkSetup.plan`), and the plans are
    written to ``<out_dir>/table11_plans.json`` with the device named —
    the artifact `repro_torch.benchmarks.alpha_delta` compares with the
    committed goldens.  At the reference's budgets the SMT column depends
    on the engine's speed, so it is a property of the device it ran on.
    `smt_configs` ({group: SMTConfig}) and `groups` (a subset, in the
    table's order) cut the table down for tests.
    """
    from repro_torch.analysis import PlanNestingError
    from repro_torch.smt import solver as S

    S.STATS.reset()
    rows: List = []
    plans: Dict[str, Dict] = {}
    closed_bits = 0
    gap_bits = 0
    nested = True
    n_phase_cols = 0
    for name, (make, cfg) in table11_makers(device, smt_configs).items():
        if groups is not None and name not in groups:
            continue
        b = make()
        plan = b.plan(smt_config=cfg, phases=True)
        plans[name] = plan.to_json_dict()
        ia = plan.columns["interval"]
        sm = plan.columns["smt"]
        pr = plan.columns["profile"]
        try:
            plan.check_nesting(["profile", "smt", "interval"])
        except PlanNestingError:
            nested = False
        n_phase_cols += len(plan.phases.get("smt", {}))
        for s in b.pipeline.topo_order():
            rows.append((name, s, ia[s].alpha, sm[s].alpha, pr[s].alpha))
            closed_bits += ia[s].alpha - sm[s].alpha
            gap_bits += ia[s].alpha - pr[s].alpha
    out_dir = OUT_DIR if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "table11_plans.json"), "w") as f:
        json.dump({"version": 1, "groups": plans,
                   "device": _device_name(device)}, f, sort_keys=True,
                  indent=1)
    pct = 100.0 * closed_bits / max(gap_bits, 1)
    boxes_per_s = S.STATS["boxes"] / max(S.STATS["secs"], 1e-9)
    return rows, (f"profile<=smt<=interval nesting holds: {nested}; SMT "
                  f"recovers {closed_bits}/{gap_bits} interval-vs-profile "
                  f"alpha bits ({pct:.0f}%) across USM/DUS/HCD/OF + "
                  f"phase-split DUS-ext/OF-pyramid; {n_phase_cols} per-phase "
                  f"stage columns in table11_plans.json; solver throughput "
                  f"{S.STATS['boxes']} boxes in "
                  f"{S.STATS['secs']:.1f}s ({boxes_per_s:.0f} boxes/s)")


def design_frontier(setup: W.BenchmarkSetup, plan) -> Table:
    """Table XII's search and rows for one setup and plan: the design
    search (`repro_torch.dse.run_design_search`) scored through the band
    kernel on the setup's device, every frontier point verified."""
    from repro_torch.dse import ErrorBudget, run_design_search
    res = run_design_search(setup.pipeline, plan, setup.train_images,
                            ErrorBudget(min_psnr=50.0),
                            params=setup.params, seed=0, anneal_iters=16,
                            backend="cuda", device=setup.device, verify=True)
    pts = res.frontier.points()
    assert pts and all(p.verified for p in pts)
    rows = [(p.strategy, f"{p.psnr:.2f}", f"{p.power:.0f}",
             f"{p.lut_bits:.0f}", f"{p.dsp_bits:.0f}", p.total_bits)
            for p in pts]
    ch = res.chosen
    flt = cost_model.design_cost(setup.pipeline,
                                 cost_model.float_design(setup.pipeline))
    return rows, (f"USM frontier: {len(pts)} verified points; chosen "
                  f"x{flt.power_proxy / ch.power:.1f} power "
                  f"x{(flt.lut_bits + flt.dsp_bits) / ch.area:.1f} area "
                  f"vs float at {ch.psnr:.1f} dB (paper Table VI: x1.6 "
                  f"power, x2.6 slices for its one hand-mapped design)")


def table12_design_frontier(device: DeviceLike = None) -> Table:
    """Beyond-paper table: the USM bitwidth design search's Pareto
    frontier, one row per point, cheapest power first.  Every PSNR comes
    from executing the specialized design through the band kernel
    against the f64 float design, re-verified bit for bit."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        b = W.make_usm(n_train=2, n_test=2, shape=(32, 32), device=device)
        return design_frontier(b, b.plan())


def fig5_cdf(device: DeviceLike = None) -> Table:
    """Fig 5: per-pixel integral-bit CDFs for HCD stages."""
    b = W.make_hcd(4, 4, (40, 40), device)
    prof = b.profile()
    rows = []
    for stage in ("Ix", "Ixy", "Sxy", "det", "trace", "harris"):
        bits, cum = prof.cdf[stage]
        p95 = int(bits[np.searchsorted(cum, 95.0)]) if len(bits) else 0
        rows.append((stage, p95, int(bits[-1]) if len(bits) else 0))
    return rows, "per-stage (bits at 95% pixels, max bits) CDF summary"


def fig6_beta_sweep(device: DeviceLike = None) -> Table:
    """Fig 6: HCD accuracy + power proxy vs uniform beta."""
    b = W.make_hcd(3, 3, (32, 32), device)
    alphas, signed = W.static_alphas(b.pipeline)
    rows = []
    for beta in range(0, 9, 2):
        types = W.types_from_alpha(b.pipeline, alphas, signed,
                                   {n: beta for n in b.pipeline.stages})
        q = b.mean_quality(types)
        c = cost_model.design_cost(b.pipeline, types)
        rows.append((beta, f"{q:.3f}", f"{c.power_proxy:.0f}"))
    q0 = float(rows[0][1])
    return rows, (f"accuracy at beta=0: {q0:.2f}% "
                  f"(paper: >99% with zero fractional bits)")


TABLES: Dict[str, Callable[..., Table]] = {
    "table2_hcd_ranges": table2_hcd_ranges,
    "table3_hcd_power": table3_hcd_power,
    "table4_hcd_bitwidths": table4_hcd_bitwidths,
    "table5_usm_bitwidths": table5_usm_bitwidths,
    "table6_usm_power": table6_usm_power,
    "table7_dus_power": table7_dus_power,
    "table8_dus_bitwidths": table8_dus_bitwidths,
    "table9_of_bitwidths": table9_of_bitwidths,
    "table10_of_power": table10_of_power,
    "table11_smt_alphas": table11_smt_alphas,
    "table12_design_frontier": table12_design_frontier,
    "fig5_cdf": fig5_cdf,
    "fig6_beta_sweep": fig6_beta_sweep,
}


def _device_name(device: DeviceLike) -> str:
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return str(dev)


def run_table(name: str, device: DeviceLike = None,
              out_dir: Optional[str] = None) -> Dict:
    """Run one table on `device`; returns (and writes, where `out_dir`
    is given) ``{"rows", "derived", "seconds", "device"}``."""
    fn = TABLES[name]
    t0 = time.perf_counter()
    if name == "table11_smt_alphas":
        rows, derived = fn(device, out_dir=out_dir)
    else:
        rows, derived = fn(device)
    rec = {"rows": [list(map(str, r)) for r in rows], "derived": derived,
           "seconds": time.perf_counter() - t0,
           "device": _device_name(device)}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.paper_tables",
        description="The paper's tables and figures on the port.")
    ap.add_argument("--only", default="",
                    help="comma-separated table names (default: all but "
                         "table11_smt_alphas, which takes minutes); one of "
                         + ", ".join(TABLES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for <name>.json (default: "
                         "chiprun_out/paper_tables)")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n] or \
        [n for n in TABLES if n != "table11_smt_alphas"]
    unknown = [n for n in names if n not in TABLES]
    if unknown:
        ap.error(f"unknown tables {unknown}; expected some of "
                 f"{list(TABLES)}")
    print(f"device: {_device_name(args.device)}")
    print("name,device,seconds,derived")
    for name in names:
        rec = run_table(name, args.device, args.out)
        print(f"{name},{args.device},{rec['seconds']:.3f},"
              f"\"{rec['derived']}\"", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
