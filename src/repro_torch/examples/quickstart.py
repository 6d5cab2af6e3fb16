"""Quickstart: the paper's full bit-width synthesis loop on Unsharp Mask.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu

Port of the reference's `examples/quickstart.py`.  Walks Figure 4 of the
paper end to end: build the DSL pipeline -> static interval
alpha-analysis -> profile refinement -> beta search against the quality
metric -> fixed-point design + power/area report -> run the resulting
design on an image.  Every candidate design of the beta search, and the
final one, runs through the band kernel (`fused_band.cu`) on the card,
or its plain version on the CPU.
"""
import argparse
from typing import List, Optional

import torch

from repro_torch.core.range_analysis import analyze
from repro_torch.dse import search_betas
from repro_torch.dsl.exec import run_fixed, run_float
from repro_torch.pipelines import usm
from repro_torch.pipelines import workflows as W
from repro_torch.pipelines.data import natural_image


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    print("== 1. build the USM pipeline (paper Listing 1) ==")
    pipe = usm.build()
    print(f"   stages: {pipe.topo_order()}")

    print("\n== 2. static alpha-analysis (Algorithm 1) ==")
    res = analyze(pipe)
    for stage in pipe.topo_order():
        r = res[stage]
        print(f"   {stage:8s} range={str(r.range):16s} alpha={r.alpha}")

    print(f"\n== 3. profile-driven refinement + beta search on {dev} "
          f"(paper SS V) ==")
    bench = W.make_usm(n_train=4, n_test=4, shape=(48, 48), device=dev)
    prof = bench.profile()
    alphas, signed = W.static_alphas(pipe)
    search = search_betas(pipe, prof.alpha_max, signed=signed,
                          images=bench.train_images,
                          target=bench.quality_target, params=bench.params,
                          metric=bench.quality_of, beta_hi=10, device=dev,
                          outputs=bench.scored_outputs())
    print(f"   betas: {search.betas}")
    print(f"   quality: {search.quality:.3f}% correct classification "
          f"({search.profile_passes} profile passes)")

    print("\n== 4. fixed-point design vs float: modeled power/area ==")
    types = W.types_from_alpha(pipe, prof.alpha_max, signed, search.betas)
    rep = W.design_report(pipe, types)
    imp = rep["improvement"]
    print(f"   power x{imp['power']:.1f}  LUT x{imp['area_lut']:.1f}  "
          f"DSP x{imp['area_dsp']:.1f}  container bytes "
          f"x{imp['tpu_bytes']:.1f}")
    print(f"   containers: {rep['containers']}")

    print("\n== 5. run both designs on an image ==")
    img = natural_image((48, 48), seed=3)
    ref = run_float(pipe, img, usm.DEFAULT_PARAMS, device=dev)
    fix = run_fixed(pipe, img, types, usm.DEFAULT_PARAMS, device=dev)
    err = torch.abs(ref["masked"] - fix["masked"])
    print(f"   max abs pixel error: {float(err.max()):.3f} (of 255)")
    print("\ndone")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
