"""Plan-aware beta search — `core.beta_search` driven from plans.

`core/beta_search.py` is the paper's §V-B two-phase heuristic over an
opaque `quality_fn(beta_map)`.  `search_betas` is the entry point that
builds that callback from a `BitwidthPlan` (or raw columns) plus
calibration images — fixed-point execution on a named `run_fixed`
backend against the f64 float reference — and runs uniform search +
reverse-topo refinement.

The port's own copy of `repro.dse.betas`.  Scoring runs on `device`
(``None`` means the card) through `backend` (default ``"cuda"``, the band
kernel; the reference's default ``"numpy"`` is the port's ``"interp"``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import beta_search
from repro_torch.core.beta_search import BetaSearchResult
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import Pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dse.evaluate import output_stages, psnr_of
from repro_torch.dsl.exec import run_fixed, run_float


def plan_columns(plan_or_alphas, signed=None, column: Optional[str] = None):
    """(alphas, signed, column_name) from a plan or raw dict columns."""
    if hasattr(plan_or_alphas, "alphas") and hasattr(plan_or_alphas, "_col"):
        plan = plan_or_alphas
        return (plan.alphas(column), plan.signed(column),
                plan._col(column))
    if signed is None:
        raise TypeError("raw alphas need an explicit signed map "
                        "(or pass a BitwidthPlan)")
    return dict(plan_or_alphas), dict(signed), column or ""


def min_output_psnr(pipeline: Pipeline):
    """Default quality metric: worst-output PSNR vs the reference env."""
    outs = output_stages(pipeline)

    def metric(ref_env, fix_env, params) -> float:
        vals = []
        for o in outs:
            r = torch.as_tensor(ref_env[o]).to(torch.float64)
            peak = float(r.abs().max())
            vals.append(psnr_of(r, fix_env[o], peak))
        return min(vals)

    return metric


def quality_fn_from_plan(pipeline: Pipeline, plan_or_alphas, *,
                         images: Sequence, signed=None,
                         column: Optional[str] = None,
                         params: Optional[Dict[str, float]] = None,
                         metric: Optional[Callable] = None,
                         backend: str = "cuda",
                         refs=None,
                         device: DeviceLike = None,
                         ) -> Callable[[Dict[str, int]], float]:
    """Measured `quality_fn(beta_map)` for `core.beta_search`.

    `metric(ref_env, fixed_env, params) -> float` (higher = better)
    defaults to worst-output PSNR; quality is the mean over `images`.
    Alphas below 1 take the standard clamp-to-1 (plan discipline).
    """
    dev = resolve_device(device)
    alphas, signed, _col = plan_columns(plan_or_alphas, signed, column)
    params = dict(params or {})
    metric = metric or min_output_psnr(pipeline)
    if refs is None:
        refs = [run_float(pipeline, im, params, device=dev) for im in images]

    def qf(beta_map: Dict[str, int]) -> float:
        types = {n: FixedPointType(alpha=max(alphas[n], 1),
                                   beta=beta_map.get(n, 0),
                                   signed=signed[n])
                 for n in pipeline.stages}
        qs = [metric(r, run_fixed(pipeline, im, types, params,
                                  backend=backend, device=dev), params)
              for im, r in zip(images, refs)]
        return float(np.mean(qs))

    return qf


def search_betas(pipeline: Pipeline, plan_or_alphas, *, images: Sequence,
                 target: float, signed=None, column: Optional[str] = None,
                 params: Optional[Dict[str, float]] = None,
                 metric: Optional[Callable] = None, backend: str = "cuda",
                 refs=None, beta_hi: int = 12, frozen: Sequence[str] = (),
                 fixed_betas: Optional[Dict[str, int]] = None,
                 device: DeviceLike = None) -> BetaSearchResult:
    """Uniform sweep + reverse-topo refine against a measured quality.

    The plan-aware face of `core.beta_search.search`: alphas/signed come
    from the plan's `column` (default column when None), quality from
    executing each trial design on `images` via `backend` on `device`.
    """
    qf = quality_fn_from_plan(pipeline, plan_or_alphas, images=images,
                              signed=signed, column=column, params=params,
                              metric=metric, backend=backend, refs=refs,
                              device=device)
    return beta_search.search(pipeline, qf, target, beta_hi=beta_hi,
                              frozen=frozen, fixed_betas=fixed_betas)
