"""Measured candidate evaluation — every `DesignPoint` earns its numbers.

The port of `repro.dse.evaluate`.  A candidate `(alpha, beta)` assignment
is *specialized* into a concrete fixed-point program (`dsl.exec.run_fixed`
over the plan-driven lowering) and run on the calibration images; quality
is PSNR / max-abs-err of the pipeline outputs against the f64 float
reference, and area/power come from `cost_model.design_cost` on the same
type map.  There is deliberately **no analytical quality model** anywhere
in this module — the paper's search trusts only executed designs.

On the card every candidate is one batch: the calibration images go
through `run_fixed(backend="cuda")` as one ``(B, H, W)`` stack, which is
one launch of the band kernel (`kernels/stencil/csrc/fused_band.cu`) per
rate island.  The float reference and each output's peak are computed
once, on the device, when the evaluator is made; each candidate's
per-image mean squared error and largest absolute error are reduced on
the device, and only those scalars reach the host.

Scoring backends (`Evaluator(backend=...)`):

  * ``"cuda"``   — the band kernel (the reference's ``"lowered"``, its
    fused scoring path); on a CPU device it is the kernel's plain
    version, which is ``"torch"``;
  * ``"torch"``  — the kernel's plain PyTorch version;
  * ``"interp"`` — the per-stage f64 walk, the oracle (the reference's
    ``"numpy"``);
  * ``"sharded"`` — the band kernel with each island's bands split over
    every device of `device`'s kind (`lowering.sharded`, the reference's
    ``"sharded"``).

All four give the same output bits, so the same scores.

Two memo layers keep the closed loop fast:

  * the evaluator's own result memo, keyed on the candidate's
    (alphas, betas) content — a re-proposed duplicate config returns its
    `DesignPoint` without touching an executor (`DSE_STATS["cached"]`);
  * the process-wide locked-LRU executor cache in `dsl.exec`
    (`EXEC_CACHE_STATS`), keyed on the type-map content — distinct
    configs that lower identically compile (lower and encode) once.

`verify(point)` re-scores a point through the kernel path (``"cuda"`` on
the card, ``"torch"`` on the CPU) and asserts bit-identity with the
recorded score, then cross-checks the oracle (``"interp"``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import cost_model
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import Pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dse.frontier import PSNR_CAP, DesignPoint, ErrorBudget
from repro_torch.dsl.exec import run_fixed, run_float

# closed-loop search telemetry: how many candidates were actually executed,
# how many short-circuited on the result memo, how many the frontier threw
# away (budget violation / dominated), how many it kept
DSE_STATS = obs.CounterGroup("dse", evaluated=0, cached=0, rejected=0,
                             accepted=0)

# Oracle cross-check tolerance for rint rounding-tie flips (see
# Evaluator.verify): one flipped LSB at one pixel moves PSNR by far less
# than this, while any real lowering bug drifts by whole decibels.
ORACLE_TIE_TOL_DB = 1e-3

SCORING_BACKENDS = ("cuda", "torch", "interp", "sharded")


def output_stages(pipeline: Pipeline) -> List[str]:
    """The pipeline's terminal stages — the signals quality is scored on."""
    outs = [n for n in pipeline.topo_order() if not pipeline.consumers(n)]
    return outs or list(pipeline.topo_order())[-1:]


def psnr_of(ref, test, peak: float) -> float:
    """PSNR against an explicit peak (the reference signal's own scale).
    `ref` and `test` are tensors (or arrays) on one device; the mean is
    taken there."""
    d = torch.as_tensor(ref).to(torch.float64) \
        - torch.as_tensor(test).to(torch.float64)
    mse = float((d * d).mean())
    if mse == 0.0:
        return PSNR_CAP
    if peak <= 0.0:
        return PSNR_CAP if mse == 0.0 else 0.0
    return min(10.0 * math.log10(peak * peak / mse), PSNR_CAP)


def _stack(frames, device: torch.device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(f).to(torch.float64)
                        for f in frames]).to(device)


def _calibration_batch(images: Sequence, device: torch.device):
    """The calibration images as one batch on `device`: a (B, H, W) f64
    tensor, or a tuple of them (one per input stage) for frame pairs."""
    first = images[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack([im[k] for im in images], device)
                     for k in range(len(first)))
    return _stack(images, device)


class Evaluator:
    """Scores candidate configs by executing them on calibration images.

    `backend` is the `run_fixed` backend the search loop scores with:
    ``"cuda"`` (default: the band kernel, one launch per island for all
    images), ``"torch"`` (its plain version), ``"interp"`` (the
    per-stage oracle) or ``"sharded"`` (one launch per island and
    device).  `device` is where the images, the float
    reference and the reductions live (``None`` means the card; it
    raises without one).  `verify` always re-scores through the kernel
    path, so frontier points are kernel-scored either way.
    """

    def __init__(self, pipeline: Pipeline, signed: Dict[str, bool],
                 images: Sequence, budget: ErrorBudget,
                 params: Optional[Dict[str, float]] = None,
                 image_width: int = 1920, backend: str = "cuda",
                 plan_hash: str = "", plan_column: str = "",
                 sink: Optional[Callable[[DesignPoint], None]] = None,
                 device: DeviceLike = None):
        if backend not in SCORING_BACKENDS:
            raise ValueError(f"unknown scoring backend {backend!r}; "
                             f"expected one of {SCORING_BACKENDS}")
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.signed = dict(signed)
        self.budget = budget
        self.params = dict(params or {})
        self.image_width = image_width
        self.backend = backend
        self.plan_hash = plan_hash
        self.plan_column = plan_column
        self.sink = sink
        self._memo: Dict[Tuple, DesignPoint] = {}
        self.outputs = output_stages(pipeline)
        # the calibration batch and the f64 float reference of each
        # output, computed once on the device; per-output peak = the
        # reference's own max magnitude (so deep-integer outputs like
        # HCD's `harris` are scored on their real scale, not [0, 255])
        self.batch = _calibration_batch(list(images), self.device)
        env = run_float(pipeline, self.batch, self.params,
                        device=self.device)
        self.refs = {o: env[o] for o in self.outputs}
        self.peaks = {o: float(self.refs[o].abs().max())
                      for o in self.outputs}

    # -- candidate -> concrete design ---------------------------------------
    def types_of(self, alphas: Dict[str, int],
                 betas: Dict[str, int]) -> Dict[str, FixedPointType]:
        """Type map of one candidate (alpha floor of 1, plan discipline)."""
        return {n: FixedPointType(alpha=max(int(alphas[n]), 1),
                                  beta=int(betas.get(n, 0)),
                                  signed=self.signed[n])
                for n in self.pipeline.stages}

    def _score(self, types: Dict[str, FixedPointType],
               backend: str) -> Tuple[float, float]:
        """(psnr, max_abs_err) of executed outputs vs the f64 reference.

        psnr is the worst output's PSNR (mse averaged over images);
        max_abs_err is the global worst-case across outputs and images.
        All images run as one batch; the per-image mse and max |error|
        are reduced on the device and copied to the host in one piece.
        """
        env = run_fixed(self.pipeline, self.batch, types, self.params,
                        backend=backend, device=self.device)
        stats = []
        for o in self.outputs:
            d = self.refs[o] - env[o]
            stats.append((d * d).mean(dim=(-2, -1)))
            stats.append(d.abs().amax(dim=(-2, -1)))
        host = torch.stack(stats).cpu().numpy()
        abs_err = 0.0
        for v in host[1::2].ravel():
            abs_err = max(abs_err, float(v))
        psnr = PSNR_CAP
        for k, o in enumerate(self.outputs):
            mse = float(np.mean([float(v) for v in host[2 * k]]))
            peak = self.peaks[o]
            if mse == 0.0:
                continue
            p = 0.0 if peak <= 0.0 else min(
                10.0 * math.log10(peak * peak / mse), PSNR_CAP)
            psnr = min(psnr, p)
        return psnr, abs_err

    # -- the one evaluation entry point -------------------------------------
    def evaluate(self, alphas: Dict[str, int], betas: Dict[str, int],
                 strategy: str = "") -> DesignPoint:
        key = (tuple(sorted((n, max(int(a), 1)) for n, a in alphas.items())),
               tuple(sorted((n, int(b)) for n, b in betas.items())))
        hit = self._memo.get(key)
        if hit is not None:
            DSE_STATS.add("cached")
            obs.event("dse.evaluate", result="cached", strategy=strategy,
                      pipeline=self.pipeline.name)
            return hit
        with obs.span("dse.evaluate", pipeline=self.pipeline.name,
                      strategy=strategy, backend=self.backend) as sp:
            types = self.types_of(alphas, betas)
            psnr, abs_err = self._score(types, self.backend)
            cost = cost_model.design_cost(self.pipeline, types,
                                          self.image_width)
            point = DesignPoint(
                alphas={n: t.alpha for n, t in types.items()},
                betas={n: t.beta for n, t in types.items()},
                signed=dict(self.signed),
                psnr=psnr, max_abs_err=abs_err,
                power=cost.power_proxy, lut_bits=cost.lut_bits,
                dsp_bits=cost.dsp_bits, bram_bits=cost.bram_bits,
                total_bits=sum(t.width for t in types.values()),
                meets_budget=self.budget.met_by(psnr, abs_err),
                strategy=strategy, pipeline=self.pipeline.name,
                plan_hash=self.plan_hash, plan_column=self.plan_column,
                verified=False)   # only verify() asserts, never assumes
            sp.set(psnr=round(psnr, 3), max_abs_err=abs_err,
                   power=cost.power_proxy,
                   area=cost.lut_bits + cost.dsp_bits,
                   total_bits=point.total_bits,
                   meets_budget=point.meets_budget)
        DSE_STATS.add("evaluated")
        self._memo[key] = point
        if self.sink is not None:
            self.sink(point)
        return point

    def verify(self, point: DesignPoint) -> DesignPoint:
        """Assert the point's score came from bit-exact kernel execution.

        Two checks, with different strictness on purpose:

        * the kernel path (``"cuda"`` on the card, ``"torch"`` on the
          CPU) must reproduce the recorded score **bit-exactly** — the
          score is a deterministic measurement of the real program,
          never a guess;
        * the per-stage oracle (``"interp"``) must agree exactly too,
          *except* on rint rounding ties in an f64 expression, where a
          contracted multiply-add can land 1 ulp off a representable tie
          point and flip a single output LSB.  That envelope is bounded
          — at most one resolution step per output pixel — so oracle
          drift beyond one LSB (or beyond `ORACLE_TIE_TOL_DB` of PSNR)
          still raises.  Such points are kept but flagged
          `oracle_exact=False`; the port's kernels are built without
          contraction, so none is expected.
        """
        types = self.types_of(point.alphas, point.betas)
        kernel = "cuda" if self.device.type == "cuda" else "torch"
        low = self._score(types, kernel)
        if low != (point.psnr, point.max_abs_err):
            raise AssertionError(
                f"{kernel} re-score drifted on {self.pipeline.name}: "
                f"{kernel}={low} point=({point.psnr}, {point.max_abs_err})")
        if self.backend != "interp":
            ora = self._score(types, "interp")
        else:
            ora = low   # scored on the oracle already; equality proven
        point.oracle_exact = ora == low
        if not point.oracle_exact:
            lsb = max(2.0 ** -types[o].beta for o in self.outputs)
            if (abs(ora[0] - low[0]) > ORACLE_TIE_TOL_DB
                    or abs(ora[1] - low[1]) > lsb):
                raise AssertionError(
                    f"{kernel}/oracle divergence beyond the rounding-tie "
                    f"envelope on {self.pipeline.name}: {kernel}={low} "
                    f"oracle={ora} (tol {ORACLE_TIE_TOL_DB} dB / {lsb})")
            obs.event("dse.verify", pipeline=self.pipeline.name,
                      result="tie-flip", strategy=point.strategy,
                      psnr_delta=abs(ora[0] - low[0]),
                      abs_err_delta=abs(ora[1] - low[1]))
        point.verified = True
        return point

    def quality_fn(self, alphas: Dict[str, int],
                   strategy: str = "beta-search") -> Callable:
        """`core.beta_search`-shaped callback over this evaluator.

        quality(beta_map) = measured worst-output PSNR; every probe the
        beta search makes lands in the evaluator memo (and the sink, i.e.
        the frontier) as a first-class candidate.
        """

        def qf(beta_map: Dict[str, int]) -> float:
            return self.evaluate(alphas, beta_map, strategy=strategy).psnr

        return qf
