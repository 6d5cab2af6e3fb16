"""Author a NEW pipeline in the DSL and synthesize its bit-widths.

    python -m repro_torch.examples.analyze_pipeline               # the card
    python -m repro_torch.examples.analyze_pipeline --device cpu

Port of the reference's `examples/analyze_pipeline.py`.  Shows the
composable analysis-pass architecture (paper SS IV-C / V): the same
pipeline is analyzed by a declared pass DAG — interval, affine, their
meet, and the whole-DAG SMT pass — into one `BitwidthPlan` with
provenance, then profiled, refined, and executed from the plan.  The SMT
pass's batched engine, the profile pass, every fixed-point execution and
the design search run on `--device`; the fixed-point designs run
through the band kernel (`fused_band.cu`) on the card.  The SMT passes
run at their default 30 s budget, so their columns can depend on the
device's speed.
"""
import argparse
import warnings
from typing import List, Optional

import torch

from repro_torch.analysis import ProfilePass, SmtPass, meet, refine, run_plan
from repro_torch.dsl.builder import PipelineBuilder, absv, ite
from repro_torch.dsl.exec import run_abstract, run_fixed, run_float
from repro_torch.pipelines import workflows as W
from repro_torch.pipelines.data import natural_image
from repro_torch.pipelines.metrics import psnr


def build_edge_enhance():
    """A custom pipeline: Laplacian edge boost with a noise gate.

    `resid` re-reads `img` alongside `boost` — the per-stage interval walk
    treats the two as independent signals, while the whole-DAG SMT analysis
    (`domain="smt"`) sees that `boost - img == 0.5*lap` exactly."""
    p = PipelineBuilder("edge_enhance")
    img = p.image("img", 0, 255)
    lap = p.stencil("lap", img, [[0, -1, 0], [-1, 4, -1], [0, -1, 0]])
    mag = p.define("mag", absv(lap))
    boost = p.define("boost", img + 0.5 * lap)
    out = p.define("out", ite(mag < 8.0, img, boost))
    resid = p.define("resid", boost - img)   # how much boosting happened
    p.output(out)
    p.output(resid)
    return p.build()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "analyze_pipeline")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    pipe = build_edge_enhance()
    print(f"pipeline: {pipe.topo_order()}  (device: {dev})")

    print("\n== one pass DAG, one plan (paper SS V architecture) ==")
    imgs = [natural_image((48, 48), seed=i) for i in range(4)]
    prof = ProfilePass(imgs, device=dev)
    plan = run_plan(pipe, ["interval", "affine", meet("interval", "affine"),
                           SmtPass(device=dev), prof,
                           refine("interval", prof)])
    for col in plan.columns:
        print(f"   {col:24s}: {plan.alphas(col)}")
    plan.check_nesting(["profile", "smt", "meet(interval,affine)"])
    print("   nesting profile ⊆ smt ⊆ meet(interval,affine): OK")
    print(f"   provenance[smt] = {plan.provenance['smt'].spec[:60]}...")

    print("\n== whole-DAG SMT analysis vs interval (paper SS V-B) ==")
    ia = plan.stage_ranges("interval")
    sm = plan.stage_ranges("smt")
    for k in pipe.topo_order():
        note = "  <- tightened" if (sm[k].range.lo, sm[k].range.hi) != \
            (ia[k].range.lo, ia[k].range.hi) else ""
        print(f"   {k:6s} interval {ia[k].range!s:>18s}   "
              f"smt {sm[k].range!s:>22s}{note}")
    per_pix = run_abstract(pipe, (12, 12), "interval")
    print(f"   per-pixel : out range {per_pix['out']['range']}")

    print("\n== per-phase alpha columns across sampling boundaries ==")
    # detail stages of a down/up pyramid difference signals across
    # stride-2 producers; the plan keeps one sub-column per output-phase
    # residue, so the aligned phase's smaller alpha survives the union
    from repro_torch.pipelines import dus
    from repro_torch.smt import SMTConfig
    pyr = dus.build_extended()
    pplan = run_plan(pyr, ["interval",
                           SmtPass(config=SMTConfig(), phases=True,
                                   device=dev)],
                     default_column="smt")
    sm = pplan.stage_ranges("smt")
    for k in ("band", "res", "resS"):
        phases = pplan.phases.get("smt", {}).get(k)
        ph = ("  phases: " + ", ".join(
            f"{r}={sr.range!s} (a{sr.alpha})"
            for r, sr in sorted(phases[1].items()))) if phases else ""
        print(f"   {k:5s} union {sm[k].range!s:>18s} (alpha {sm[k].alpha})"
              f"{ph}")

    print("\n== execute the plan (per-phase datapaths where present) ==")
    img = natural_image((48, 48), seed=99)
    ref = run_float(pyr, img, device=dev)
    # plan in, per-phase types applied; "interp" is the per-stage walk
    fix = run_fixed(pyr, img, pplan, backend="interp", device=dev)
    union_bits = sum(t.width for t in pplan.types().values())
    phase_bits = union_bits
    for stage, (lat, tmap) in pplan.phase_types().items():
        u = pplan.types()[stage].width
        phase_bits += sum(t.width for t in tmap.values()) / len(tmap) - u
    print(f"   PSNR(resS fixed vs float): {psnr(ref['resS'], fix['resS']):.1f}"
          f" dB; mean datapath bits {phase_bits:.1f} vs union {union_bits}")

    print("\n== lower the plan (the band kernel, one launch per island) ==")
    from repro_torch.lowering import compile_pipeline, lower
    lp = lower(pyr, pplan)
    kinds = lp.kinds()
    n_int = sum(1 for k in kinds.values() if k == "intlinear")
    print(f"   {n_int} integer-datapath stages / "
          f"{sum(1 for k in kinds.values() if k == 'expr')} f64-replay "
          f"stages")
    fused = compile_pipeline(pyr, pplan, backend="cuda", device=dev)
    low = fused(img)
    exact = all(torch.equal(fix[k], low[k]) for k in low)
    print(f"   band-kernel outputs bit-identical to the oracle: {exact}")

    print("\n== profile + synthesize (the one-pass shims) ==")
    alphas, signed = W.static_alphas(pipe)
    types = W.types_from_alpha(
        pipe, plan.alphas("profile"), signed,
        {n: 4 for n in pipe.stages})
    rep = W.design_report(pipe, types)
    print(f"   alpha^max: {plan.alphas('profile')}")
    print(f"   modeled power x{rep['improvement']['power']:.1f}, "
          f"LUT x{rep['improvement']['area_lut']:.1f} vs float")
    ref = run_float(pipe, img, device=dev)
    fix = run_fixed(pipe, img, types, device=dev)
    print(f"   PSNR(fixed vs float): "
          f"{psnr(ref['out'], fix['out']):.1f} dB")

    print("\n== traced compile + execution (repro_torch.obs) ==")
    # the whole compile path emits spans into one obs trace; with
    # runtime_ranges=True the executed stages also report observed range,
    # saturation, and alpha headroom (plan bits this input did not need)
    from repro_torch import obs
    from repro_torch.obs import report
    from repro_torch.pipelines import usm

    upipe = usm.build()
    with obs.tracing(runtime_ranges=True) as tr:
        uplan = run_plan(upipe, ["interval", SmtPass(device=dev)],
                         default_column="smt")
        run_fixed(upipe, natural_image((48, 48), seed=5), uplan,
                  usm.DEFAULT_PARAMS, backend="lowered", device=dev)
    total_us = sum(s.t1 - s.t0 for s in tr.spans("analysis.pass")) * 1e6
    print(f"   plan time breakdown ({total_us:.0f} us across "
          f"{len(tr.spans('analysis.pass'))} passes):")
    for s in tr.spans("analysis.pass"):
        print(f"     {s.attrs['pass']:10s} {(s.t1 - s.t0) * 1e6:8.0f} us  "
              f"memo={s.attrs['memo']}")
    summary = report.summarize(obs.to_jsonl_records(tr))
    table = report.render({"passes": [], "smt_stages": [],
                           "runtime": summary["runtime"]})
    print("   " + table.replace("\n", "\n   ").rstrip())

    print("\n== closed-loop bitwidth design search ==")
    # search per-stage (alpha, beta) under a measured error budget: every
    # candidate is specialized, executed through the band kernel, and
    # scored against the f64 float design — the result is a Pareto
    # frontier of verified designs
    from repro_torch.core import cost_model
    from repro_torch.dse import ErrorBudget, run_design_search

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        setup = W.make_usm(n_train=2, n_test=2, shape=(32, 32), device=dev)
        res = run_design_search(setup.pipeline, setup.plan(),
                                setup.train_images,
                                ErrorBudget(min_psnr=50.0),
                                params=setup.params, seed=0,
                                anneal_iters=12, backend="cuda",
                                device=dev, verify=True)
    print(f"   clusters: {res.clusters}")
    print(f"   {res.evaluations} designs executed -> "
          f"{len(res.frontier)} on the frontier (all verified):")
    print("   strategy         psnr_dB   power     lut     dsp  bits")
    for p in res.frontier.points():
        print(f"   {p.strategy:15s} {p.psnr:8.2f} {p.power:7.0f} "
              f"{p.lut_bits:7.0f} {p.dsp_bits:7.0f} {p.total_bits:5d}")
    flt = cost_model.design_cost(setup.pipeline,
                                 cost_model.float_design(setup.pipeline))
    ch = res.chosen
    print(f"   chosen: {ch.psnr:.1f} dB at "
          f"x{flt.power_proxy / ch.power:.1f} power, "
          f"x{(flt.lut_bits + flt.dsp_bits) / ch.area:.1f} area vs float")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
