"""`AnalysisPass` protocol, registry, and the built-in passes.

A pass is the unit of composition of the analysis architecture (paper §V:
"easily deploying any kind of interval/affine arithmetic based range
analyses in the DSL compiler").  Every pass

  * names itself (`name`) and its output plan column (`column`);
  * exposes a **content key** (`key()`) — a stable string over all of its
    parameters, combined with the pipeline content hash for memoization;
  * `run(ctx)` returns a `PassResult`: per-stage sound `Interval` bounds,
    optional explicit alphas (profile statistics are not range-derived),
    optional per-phase sub-ranges keyed by sampling-lattice residue, and
    free-form notes that land in plan provenance.

Passes compose through `PassContext.run`, which consults `run_plan`'s memo
table — a sub-pass shared by two combinators executes once per pipeline.
Built-ins wrap the existing analyses: the per-stage domain walk
(interval / affine / intersect), the whole-DAG SMT tightening
(``"smt"``, ``"smt-scalar"``, ``"smt-phase-split"``) and the profile
executor; the SMT batched engine and the profile executor run on the
card by default.  The combinators (`meet`, `refine`, `widen_to`) live
in `analysis.combinators`.

The port's own copy of `repro.analysis.passes`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Pipeline
from repro_torch.core.interval import Interval
from repro_torch.core.profile import profile_pipeline
from repro_torch.core.range_analysis import StageRange, analyze_direct
from repro_torch.device import DeviceLike

Residue = Tuple[int, int]

@dataclasses.dataclass
class PassResult:
    """What one pass produces for one pipeline (pre-plan form)."""
    ranges: Dict[str, Interval]
    # explicit alpha override (profile's alpha^max is a per-pixel statistic,
    # not `alpha_for_range` of the observed join — see core.profile)
    alphas: Optional[Dict[str, int]] = None
    # per-phase sub-ranges: stage -> (lattice (My, Mx), residue -> Interval)
    phases: Optional[Dict[str, Tuple[Tuple[int, int],
                                     Dict[Residue, Interval]]]] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    def stage_ranges(self) -> Dict[str, StageRange]:
        out = {}
        for n, iv in self.ranges.items():
            sr = StageRange.from_interval(iv)
            if self.alphas is not None and n in self.alphas:
                sr = StageRange(range=iv, alpha=self.alphas[n], signed=sr.signed)
            out[n] = sr
        return out

    def phase_stage_ranges(self) -> Optional[Dict]:
        if not self.phases:
            return None
        return {stage: (lat, {res: StageRange.from_interval(iv)
                              for res, iv in rmap.items()})
                for stage, (lat, rmap) in self.phases.items()}


class PassContext(Protocol):
    """What `run_plan` hands each pass (see `analysis.driver`)."""
    pipeline: Pipeline
    input_ranges: Optional[Dict[str, Interval]]

    def run(self, p: "AnalysisPass") -> PassResult: ...
    def with_input_ranges(self, ir: Dict[str, Interval]) -> "PassContext": ...


class AnalysisPass(Protocol):
    name: str
    column: str

    def key(self) -> str: ...
    def run(self, ctx: PassContext) -> PassResult: ...


# ---------------------------------------------------------------------------
# built-in passes
# ---------------------------------------------------------------------------

class DomainPass:
    """Per-stage abstract walk in a registered domain (Algorithm 1)."""

    def __init__(self, domain: str, column: Optional[str] = None):
        self.name = domain
        self.domain = domain
        self.column = column or domain

    def key(self) -> str:
        return f"domain:{self.domain}"

    def run(self, ctx: PassContext) -> PassResult:
        res = analyze_direct(ctx.pipeline, self.domain,
                             input_ranges=ctx.input_ranges)
        return PassResult(ranges={n: r.range for n, r in res.items()})


class SmtPass:
    """Whole-DAG branch-and-prune tightening (`repro_torch.smt.analyze_smt`).

    `phases=True` additionally collects per-phase certified sub-ranges on
    phase-split stages (one entry per sampling-lattice residue) — the union
    bound is unchanged, the sub-ranges become plan phase columns.  The
    batched engine runs on `device` (``None`` means the card).  The device
    is not part of the content key: the engine gives the same bits on
    every device, so the key equals the reference's.
    """

    name = "smt"

    def __init__(self, config=None, phases: bool = False,
                 engine: Optional[str] = None, column: str = "smt",
                 device: DeviceLike = None):
        self.config = config
        self.phases = phases
        self.engine = engine
        self.column = column
        self.device = device

    def _config(self):
        from repro_torch.smt import SMTConfig
        cfg = self.config if self.config is not None else SMTConfig()
        if self.engine is not None and cfg.engine != self.engine:
            cfg = dataclasses.replace(cfg, engine=self.engine)
        return cfg

    def key(self) -> str:
        return f"smt:phases={self.phases}:{self._config()!r}"

    def run(self, ctx: PassContext) -> PassResult:
        from repro_torch.smt import analyze_smt
        collect: Optional[Dict] = {} if self.phases else None
        diag: Dict = {}
        res = analyze_smt(ctx.pipeline, input_ranges=ctx.input_ranges,
                          config=self._config(), collect_phases=collect,
                          diagnostics=diag, device=self.device)
        phases = None
        if collect:
            phases = {stage: (lat, dict(rmap))
                      for stage, (lat, rmap) in collect.items()}
        notes = []
        starved = diag.get("budget_exhausted") or []
        if starved:
            # lands in plan provenance (and thus serialized plan JSON), so
            # downstream readers can flag seed-kept alphas instead of
            # treating them as converged
            notes.append("budget-exhausted (seed kept): "
                         + ", ".join(starved))
        return PassResult(ranges={n: r.range for n, r in res.items()},
                          phases=phases, notes=notes)


def _hash_images(images) -> str:
    """Content hash of a sample set: each array's shape, dtype and bytes,
    the same for a numpy array and a tensor (on any device) that hold
    the same values."""
    h = hashlib.sha256()
    for img in images:
        arrs = img if isinstance(img, (tuple, list)) else (img,)
        if isinstance(img, dict):
            arrs = [img[k] for k in sorted(img)]
        for a in arrs:
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            a = np.ascontiguousarray(a)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


class ProfilePass:
    """Empirical lower-bound column: run the float executor over samples.

    The result is *not* a sound worst-case bound — it is the paper's
    profile-driven analysis (§V-A), the floor every sound column must
    enclose.  `runner(image, params) -> {stage: tensor or ndarray}`
    defaults to the pipeline-bound float executor on `device`
    (`dsl.exec.make_profile_runner`; ``None`` means the card), whose
    stage tensors `core.profile.profile_pipeline` reduces where they
    are.  The device is not part of the content key: the float executor
    gives the same values on every device.
    """

    name = "profile"

    _seq = 0       # per-instance token for custom runners (see key())

    def __init__(self, images, runner: Optional[Callable] = None,
                 params: Optional[Dict[str, float]] = None,
                 column: str = "profile", key_suffix: str = "",
                 device: DeviceLike = None):
        self.images = list(images)
        self.runner = runner
        self.params = dict(params or {})
        self.column = column
        self.key_suffix = key_suffix
        self.device = device
        if runner is not None and not key_suffix:
            # a custom runner's behavior is not content-hashable: give each
            # instance its own memo identity (same instance still hits the
            # cache; two instances with different runners never collide)
            ProfilePass._seq += 1
            self.key_suffix = f":runner#{ProfilePass._seq}"
        # images are never mutated: hash once, not per key() call
        self._img_hash = _hash_images(self.images)

    def key(self) -> str:
        return (f"profile:n={len(self.images)}:img={self._img_hash}"
                f":params={sorted(self.params.items())!r}{self.key_suffix}")

    def run(self, ctx: PassContext) -> PassResult:
        runner = self.runner
        if runner is None:
            from repro_torch.dsl.exec import make_profile_runner
            runner = make_profile_runner(ctx.pipeline, device=self.device)
        prof = profile_pipeline(ctx.pipeline, self.images, runner, self.params)
        return PassResult(
            ranges=dict(prof.observed_range),
            alphas=dict(prof.alpha_max),
            notes=[f"profiled over {len(self.images)} sample(s); empirical "
                   f"lower bound, not a sound worst-case range"])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_PASS_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_pass(name: str, factory: Callable[..., Any]) -> None:
    _PASS_REGISTRY[name] = factory


def make_pass(spec, **kw):
    """Resolve a pass spec: an `AnalysisPass` instance passes through, a
    registry name is instantiated (kwargs forwarded to the factory)."""
    if isinstance(spec, str):
        try:
            factory = _PASS_REGISTRY[spec]
        except KeyError:
            raise KeyError(
                f"unknown analysis pass {spec!r}; registered: "
                f"{sorted(_PASS_REGISTRY)}") from None
        return factory(**kw)
    return spec


register_pass("interval", lambda **kw: DomainPass("interval", **kw))
register_pass("affine", lambda **kw: DomainPass("affine", **kw))
register_pass("intersect", lambda **kw: DomainPass("intersect", **kw))
register_pass("smt", lambda **kw: SmtPass(**kw))
register_pass("smt-scalar",
              lambda **kw: SmtPass(engine="scalar", column="smt-scalar", **kw))
register_pass("smt-phase-split",
              lambda **kw: SmtPass(**{"phases": True,
                                      "column": "smt-phase-split", **kw}))
register_pass("profile", lambda **kw: ProfilePass(**kw))
