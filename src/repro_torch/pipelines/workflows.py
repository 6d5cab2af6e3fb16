"""End-to-end bit-width synthesis workflows — Figure 4 of the paper.

Port of `repro.pipelines.workflows`.  For each benchmark this wires
together: static alpha analysis -> profile alpha refinement -> beta
search against the application quality metric -> fixed-point design and
its cost against the float reference.

Analyses run through the `repro_torch.analysis` pass architecture: a
`BenchmarkSetup.plan()` is the standard interval/smt/profile
`BitwidthPlan` (with per-phase sub-columns on phase-split stages), and
the historical entry points (`static_alphas`, `smt_alphas`,
`alpha_columns`) are thin shims over one-pass plans.

A `BenchmarkSetup` runs on a `device` (``None`` means the card; it
raises without one).  The reference's backends map onto the port's:
its numpy oracle is ``"interp"``, and its fused ``"lowered"`` / ``"jnp"``
path is ``"cuda"`` — the band kernel on the card, its plain version on
``device="cpu"``.  `fixed_envs` runs ``"cuda"`` unless asked for
another backend, and `mean_quality` and `run_beta_search` score through
it, so on the card every candidate design runs through
`kernels/stencil/csrc/fused_band.cu`.

Used by the paper tables (`repro_torch.benchmarks.paper_tables`), the
examples and the tests, so the methodology lives in one place.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis import BitwidthPlan, ProfilePass, SmtPass, run_plan
from repro_torch.core import cost_model, policy
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import Pipeline
from repro_torch.core.profile import ProfileResult, profile_pipeline
from repro_torch.device import DeviceLike
from repro_torch.dsl.exec import make_profile_runner, run_fixed, run_float
from repro_torch.pipelines import data as pdata
from repro_torch.pipelines import dus, hcd, metrics, optical_flow, usm

TypeMap = Dict[str, Optional[FixedPointType]]


def types_from_alpha(pipeline: Pipeline, alphas: Dict[str, int],
                     signed: Dict[str, bool], betas: Dict[str, int]) -> TypeMap:
    """Per-stage fixed-point types from (alpha, signed, beta) columns.

    Alphas below 1 are clamped (a `FixedPointType` needs at least one field
    bit); the clamp is surfaced as a `RuntimeWarning` so zero-range stages
    stay visible instead of silently widening.  Plan-based flows record the
    same event in provenance — see `BitwidthPlan.types`.
    """
    clamped = sorted(n for n in pipeline.stages if alphas[n] < 1)
    if clamped:
        warnings.warn(
            f"alpha clamped to 1 on zero-range stage(s): "
            f"{', '.join(clamped)}", RuntimeWarning, stacklevel=2)
    return {
        n: FixedPointType(alpha=max(alphas[n], 1), beta=betas.get(n, 0),
                          signed=signed[n])
        for n in pipeline.stages
    }


def static_alphas(pipeline: Pipeline, domain: str = "interval"):
    """Per-stage (alpha, signed) columns of the synthesis flow.

    A one-pass `BitwidthPlan` column.  `domain` selects the static
    analysis: "interval" (Algorithm 1), "affine", "intersect", or "smt"
    (whole-DAG solver-style analysis, `repro_torch.smt`; its batched
    engine runs on the card)."""
    plan = run_plan(pipeline, [domain])
    return plan.alphas(), plan.signed()


def smt_alphas(pipeline: Pipeline, config=None, device: DeviceLike = None):
    """SMT-column twin of `static_alphas` with explicit budget control:
    a one-pass plan (`SmtPass(config)`), the batched engine on `device`."""
    plan = run_plan(pipeline, [SmtPass(config=config, device=device)])
    return plan.alphas("smt"), plan.signed("smt")


def alpha_columns(setup: "BenchmarkSetup", smt_config=None,
                  profile: Optional[ProfileResult] = None) -> Dict[str, Dict]:
    """interval vs smt vs profile alpha columns for one benchmark.

    The paper's §VI comparison axis: static interval bounds,
    solver-tightened static bounds, and profile-driven lower bounds —
    sound analyses must nest as profile ⊆ smt ⊆ interval per stage.
    The columns are one three-pass `BitwidthPlan` on the setup's device
    (see `BenchmarkSetup.plan` for the plan itself)."""
    passes = ["interval", SmtPass(config=smt_config, device=setup.device)]
    if profile is None:
        passes.append(setup.profile_pass())
    plan = run_plan(setup.pipeline, passes)
    ia = plan.columns["interval"]
    sm = plan.columns["smt"]
    if profile is None:
        pr = plan.columns["profile"]
        prof_alpha = {n: r.alpha for n, r in pr.items()}
        prof_range = {n: r.range for n, r in pr.items()}
    else:
        prof_alpha = profile.alpha_max
        prof_range = profile.observed_range
    return {
        n: {
            "interval": ia[n].alpha,
            "smt": sm[n].alpha,
            "profile_max": prof_alpha[n],
            "interval_range": ia[n].range,
            "smt_range": sm[n].range,
            "profile_range": prof_range[n],
        }
        for n in setup.pipeline.topo_order()
    }


@dataclasses.dataclass
class BenchmarkSetup:
    """One paper benchmark bound to data, params, its quality metric and
    the device it runs on (``None``: the card)."""
    name: str
    pipeline: Pipeline
    params: Dict[str, float]
    train_images: List
    test_images: List
    # quality_fn(ref_env, fixed_env, params) -> float, higher = better
    quality_of: Callable
    quality_target: float
    two_input: bool = False
    device: DeviceLike = None
    # stages `quality_of` reads besides the pipeline's outputs: the band
    # kernel returns only the stages it is asked for
    quality_stages: Tuple[str, ...] = ()

    def scored_outputs(self) -> Optional[List[str]]:
        """The stages a band-kernel execution returns for `quality_of`
        (None: the pipeline's outputs suffice)."""
        extra = [n for n in self.quality_stages
                 if n not in self.pipeline.outputs]
        return list(self.pipeline.outputs) + extra if extra else None

    def ref_envs(self, images=None):
        imgs = self.test_images if images is None else images
        return [run_float(self.pipeline, im, self.params, device=self.device)
                for im in imgs]

    def fixed_envs(self, types: TypeMap, images=None, backend: str = "cuda"):
        imgs = self.test_images if images is None else images
        return [run_fixed(self.pipeline, im, types, self.params,
                          backend=backend,
                          device=self.device,
                          outputs=self.scored_outputs())
                for im in imgs]

    def executor(self, types, backend: str = "cuda", outputs=None,
                 column: Optional[str] = None):
        """Compiled fixed-point executor over the plan-driven lowering
        (`repro_torch.lowering.compile_pipeline`): reusable across
        images, one band-kernel launch per rate island on the card."""
        from repro_torch.lowering import compile_pipeline
        return compile_pipeline(self.pipeline, types, params=self.params,
                                backend=backend, outputs=outputs,
                                column=column, device=self.device)

    def mean_quality(self, types: TypeMap, images=None, refs=None) -> float:
        imgs = self.test_images if images is None else images
        refs = self.ref_envs(imgs) if refs is None else refs
        qs = [self.quality_of(r, f, self.params)
              for r, f in zip(refs, self.fixed_envs(types, imgs))]
        return float(np.mean(qs))

    def profile(self) -> ProfileResult:
        return profile_pipeline(self.pipeline, self.train_images,
                                make_profile_runner(self.pipeline,
                                                    self.device),
                                self.params)

    def profile_pass(self) -> ProfilePass:
        """The profile analysis as a memoizable plan pass (same executor
        and sample set as `profile`, keyed on the image content hash)."""
        return ProfilePass(self.train_images, params=self.params,
                           device=self.device)

    def plan(self, smt_config=None, phases: bool = True,
             include_profile: bool = True,
             betas: Optional[Dict[str, int]] = None,
             cache_dir: Optional[str] = None) -> BitwidthPlan:
        """The benchmark's standard `BitwidthPlan`: interval + smt (with
        per-phase sub-columns on phase-split stages) + profile columns,
        default column "smt" — the artifact `run_fixed`, `design_report`
        and the paper tables consume.  `cache_dir` enables the
        disk-backed plan cache (`repro_torch.analysis.run_plan`)."""
        passes = ["interval", SmtPass(config=smt_config, phases=phases,
                                      device=self.device)]
        if include_profile:
            passes.append(self.profile_pass())
        return run_plan(self.pipeline, passes, betas=betas,
                        default_column="smt", cache_dir=cache_dir)

    def beta_quality_fn(self, alphas, signed, images=None, refs=None):
        imgs = self.train_images if images is None else images
        refs = self.ref_envs(imgs) if refs is None else refs

        def qf(beta_map: Dict[str, int]) -> float:
            types = types_from_alpha(self.pipeline, alphas, signed, beta_map)
            return self.mean_quality(types, imgs, refs)

        return qf

    def run_beta_search(self, alphas, signed, beta_hi: int = 12):
        """Deprecated raw-dict beta search — a shim over
        `repro_torch.dse.search_betas`, which is the plan-aware entry
        point (same uniform + reverse-topo machinery, measured quality
        callback); this shim forwards the benchmark's quality metric,
        training images and device."""
        warnings.warn(
            "BenchmarkSetup.run_beta_search is deprecated; use "
            "repro_torch.dse.search_betas(pipeline, plan, images=..., "
            "target=...) instead", DeprecationWarning, stacklevel=2)
        from repro_torch.dse import search_betas
        return search_betas(
            self.pipeline, alphas, signed=signed, column=None,
            images=self.train_images, target=self.quality_target,
            params=self.params,
            metric=lambda r, f, p: self.quality_of(r, f, p),
            beta_hi=beta_hi, device=self.device,
            outputs=self.scored_outputs())


# ---------------------------------------------------------------------------
# benchmark constructors (paper §VI) — small default sizes for CPU speed;
# sizes only affect profiling statistics, not the static analysis.
# ---------------------------------------------------------------------------

def make_hcd(n_train: int = 6, n_test: int = 6, shape=(48, 48),
             device: DeviceLike = None) -> BenchmarkSetup:
    train, test = pdata.train_test_split(n_train + n_test, shape, seed=11)

    def quality(ref_env, fix_env, params):
        thr = hcd.corner_threshold(ref_env["harris"])
        return metrics.hcd_accuracy(ref_env["harris"], fix_env["harris"], thr)

    return BenchmarkSetup("hcd", hcd.build(), {}, train[:n_train],
                          test[:n_test], quality, quality_target=99.0,
                          device=device)


def make_usm(n_train: int = 6, n_test: int = 6, shape=(48, 48),
             device: DeviceLike = None) -> BenchmarkSetup:
    train, test = pdata.train_test_split(n_train + n_test, shape, seed=23)
    params = dict(usm.DEFAULT_PARAMS)

    def quality(ref_env, fix_env, params_):
        rb = metrics.usm_branch(ref_env, params_)
        fb = metrics.usm_branch(fix_env, params_)
        err = metrics.usm_classification_error(rb, fb)
        return 100.0 - err     # % correctly classified

    return BenchmarkSetup("usm", usm.build(), params, train[:n_train],
                          test[:n_test], quality, quality_target=99.5,
                          device=device, quality_stages=("img", "blury"))


def make_dus(n_train: int = 6, n_test: int = 6, shape=(48, 48),
             device: DeviceLike = None) -> BenchmarkSetup:
    train, test = pdata.train_test_split(n_train + n_test, shape, seed=37)

    def quality(ref_env, fix_env, params_):
        out = "Uy"
        return metrics.psnr(ref_env[out], fix_env[out])

    # paper sets required PSNR to infinity; numerically we use a high bar
    return BenchmarkSetup("dus", dus.build(), {}, train[:n_train],
                          test[:n_test], quality, quality_target=50.0,
                          device=device)


def make_of(n_pairs: int = 4, shape=(40, 40),
            device: DeviceLike = None) -> BenchmarkSetup:
    pairs = [pdata.shifted_pair(shape, seed=100 + i, shift=(1, 1))
             for i in range(2 * n_pairs)]
    train = pairs[:n_pairs]
    test = pairs[n_pairs:]

    def quality(ref_env, fix_env, params_):
        k = optical_flow.N_ITERS
        aae = metrics.aae_degrees(ref_env[f"Vx{k}"], ref_env[f"Vy{k}"],
                                  fix_env[f"Vx{k}"], fix_env[f"Vy{k}"])
        return -aae            # higher is better

    return BenchmarkSetup("optical_flow", optical_flow.build(), {}, train,
                          test, quality, quality_target=-2.0, two_input=True,
                          device=device)


def make_dus_ext(n_train: int = 6, n_test: int = 6, shape=(48, 48),
                 device: DeviceLike = None) -> BenchmarkSetup:
    """Extended DUS: the paper chain plus DoG band + reconstruction
    residual — the sampled detail stages the phase-split encoder tightens."""
    train, test = pdata.train_test_split(n_train + n_test, shape, seed=37)

    def quality(ref_env, fix_env, params_):
        return metrics.psnr(ref_env["res"], fix_env["res"])

    return BenchmarkSetup("dus_ext", dus.build_extended(), {},
                          train[:n_train], test[:n_test], quality,
                          quality_target=50.0, device=device)


def make_of_pyramid(n_pairs: int = 4, shape=(40, 40),
                    device: DeviceLike = None) -> BenchmarkSetup:
    """Coarse-to-fine Horn–Schunck (2 levels, 1 fine iteration) — the
    sampled deep pipeline for phase-split range analysis."""
    pairs = [pdata.shifted_pair(shape, seed=300 + i, shift=(1, 1))
             for i in range(2 * n_pairs)]
    train = pairs[:n_pairs]
    test = pairs[n_pairs:]

    def quality(ref_env, fix_env, params_):
        aae = metrics.aae_degrees(ref_env["Vx1"], ref_env["Vy1"],
                                  fix_env["Vx1"], fix_env["Vy1"])
        return -aae            # higher is better

    return BenchmarkSetup("of_pyramid", optical_flow.build_pyramid(1), {},
                          train, test, quality, quality_target=-2.0,
                          two_input=True, device=device)


ALL_BENCHMARKS = {"hcd": make_hcd, "usm": make_usm, "dus": make_dus,
                  "optical_flow": make_of, "dus_ext": make_dus_ext,
                  "of_pyramid": make_of_pyramid}


# ---------------------------------------------------------------------------
# cost comparison — the paper's Tables III/VI/VII/X axis
# ---------------------------------------------------------------------------

def design_report(pipeline: Pipeline, types,
                  image_width: int = 1920, column: Optional[str] = None) -> Dict:
    """Fixed-vs-float cost report; `types` is a TypeMap or a `BitwidthPlan`
    (whose `column` — default column when None — supplies the types).

    A plan with per-phase sub-columns additionally yields the phase-split
    design costs (`fixed_phase` / `phase_improvement`): one datapath per
    sampling-lattice residue, priced at the residue-mean width
    (`cost_model.design_cost(phase_types=...)`) — the area/power the union
    column over-reports on stages like `dus_ext.resS`.
    """
    phase_types = None
    if isinstance(types, BitwidthPlan):
        plan = types
        phase_types = plan.phase_types(column) or None
        types = plan.types(column)
    fixed = cost_model.design_cost(pipeline, types, image_width)
    flt = cost_model.design_cost(pipeline, cost_model.float_design(pipeline),
                                 image_width)
    legal = policy.legalize_design(types)
    report = {
        "fixed": fixed,
        "float": flt,
        "improvement": fixed.ratios_vs(flt),
        "containers": {k: v.container for k, v in legal.items()},
        "total_bits": sum(t.width if t else 32 for t in types.values()),
    }
    if phase_types:
        fixed_ph = cost_model.design_cost(pipeline, types, image_width,
                                          phase_types=phase_types)
        report["fixed_phase"] = fixed_ph
        # >1 where the per-residue datapaths beat the union-width design
        report["phase_improvement"] = fixed_ph.ratios_vs(fixed)
    return report
