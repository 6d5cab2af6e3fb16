"""Application-specific quality metrics — paper §VI.

  HCD : % of pixels whose corner classification matches the wide-type
        reference (paper: "percentage of mis-classified corners")
  USM : (a) fraction of pixels mis-classified at the `masked` Select,
        (b) RMS error of correctly-classified pixels vs float
  DUS : PSNR against the wide-type reference
  OF  : Average Angular Error (AAE, degrees) of the flow field
        [Fleet & Jepson '90 / Otte & Nagel '94 formulation]

All metrics compare a candidate design against a reference produced with
"sufficiently long" types (the f64 float executor), matching the paper's
methodology.

The port's copy of `repro.pipelines.metrics`.  Arguments are tensors on
any device (or arrays, taken to the CPU): each metric reduces where its
tensors are and returns a Python float, so scoring on the card copies
scalars, never frames, to the host.
"""
from __future__ import annotations

import math

import torch


def _f64(x) -> torch.Tensor:
    """`x` as an f64 tensor, on the device it is already on."""
    return torch.as_tensor(x).to(torch.float64)


def hcd_accuracy(ref_harris, test_harris, threshold: float | None = None) -> float:
    """% pixels with identical corner classification (higher is better)."""
    ref = _f64(ref_harris)
    test = _f64(test_harris)
    if threshold is None:
        threshold = 0.01 * float(ref.max())
    agree = (ref > threshold) == (test > threshold)
    return 100.0 * float(agree.to(torch.float64).mean())


def usm_classification_error(ref_mask_branch, test_mask_branch) -> float:
    """% pixels whose Select branch flipped under fixed point (lower=better)."""
    flipped = torch.as_tensor(ref_mask_branch) != torch.as_tensor(
        test_mask_branch)
    return 100.0 * float(flipped.to(torch.float64).mean())


def usm_branch(env, params) -> torch.Tensor:
    """The masked stage's Select predicate: |img - blury| < thresh."""
    return (_f64(env["img"]) - _f64(env["blury"])).abs() < params["thresh"]


def rms_correct(ref, test, ref_branch, test_branch) -> float:
    """RMS over pixels classified the same way in both designs."""
    ok = torch.as_tensor(ref_branch) == torch.as_tensor(test_branch)
    if not bool(ok.any()):
        return float("inf")
    d = (_f64(ref) - _f64(test))[ok]
    return math.sqrt(float((d * d).mean()))


def psnr(ref, test, peak: float = 255.0) -> float:
    d = _f64(ref) - _f64(test)
    mse = float((d * d).mean())
    if mse == 0.0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def aae_degrees(u_ref, v_ref, u_test, v_test) -> float:
    """Average Angular Error between flow fields, in degrees."""
    u_ref, v_ref = _f64(u_ref), _f64(v_ref)
    u_test, v_test = _f64(u_test), _f64(v_test)
    num = u_ref * u_test + v_ref * v_test + 1.0
    den = torch.sqrt((u_ref ** 2 + v_ref ** 2 + 1.0)
                     * (u_test ** 2 + v_test ** 2 + 1.0))
    cosang = torch.clamp(num / den, -1.0, 1.0)
    return math.degrees(float(torch.arccos(cosang).mean()))
