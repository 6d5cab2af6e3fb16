"""Profile-driven analysis — paper §V-A.

Runs the pipeline (float executor) over a sample image set and extracts, per
stage i and sample s, the max integral bits alpha_i^s needed by any pixel;
then

    alpha_i^max = max_s alpha_i^s        (worst case over the training set)
    alpha_i^avg = round(mean_s alpha_i^s)

plus the per-pixel bit-width CDF data behind the paper's Figure 5.

The port of `repro.core.profile`.  `profile_pipeline` reduces each stage
where the runner's tensors are (on the card, as the port's float
executor leaves them): per-pixel alpha bits, min, max and a 65-bin
`torch.bincount`; only those scalars and histograms move to the host.
A runner that returns numpy arrays takes the plain version on the host,
`np_alpha_bits`.

Bits are counted with integer-exact arithmetic (`frexp`), not `log2`:
for v >= 0, ceil(log2(floor(v) + 1)) is the bit length of floor(v), the
exponent e of floor(v) = f 2^e, f in [0.5, 1); for v < 0, ceil(log2(c))
of c = ceil(|v|) is e - 1 where c is a power of two and e otherwise.
The reference's `np.log2` form rounds log2(2^k + j) down to k for small
j from k = 49 on, and so counts one bit too few on such values; below
2^49 the two agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Pipeline
from repro_torch.core.interval import Interval

HIST_BINS = 65


def _np_ceil_log2(m: np.ndarray) -> np.ndarray:
    """ceil(log2(m)) of integer-valued m >= 1, exactly."""
    f, e = np.frexp(m)
    return np.where(f == 0.5, e - 1, e)


def np_alpha_bits(x: np.ndarray) -> np.ndarray:
    """Per-pixel integral bits (paper's alpha formula, vectorized), the
    plain version on numpy.

    For v >= 0: ceil(log2(floor(v)+1)), at least 1; for v < 0 the sign bit
    is added and the magnitude uses ceil(log2(ceil(|v|))).  Matches
    `fixedpoint.alpha_for_range` applied to the degenerate range [v, v]
    below 2^49 (above, `alpha_for_range`'s `log2` can count a bit fewer).
    Defined for finite values.
    """
    x = np.asarray(x, dtype=np.float64)
    bits_pos = np.maximum(np.frexp(np.floor(np.maximum(x, 0.0)))[1], 1)
    bits_neg = _np_ceil_log2(np.maximum(np.ceil(-x), 1.0)) + 1
    return np.where(x < 0.0, bits_neg, bits_pos).astype(np.int32)


def _ceil_log2(m: torch.Tensor) -> torch.Tensor:
    """ceil(log2(m)) of integer-valued m >= 1, exactly."""
    f, e = torch.frexp(m)
    return torch.where(f == 0.5, e - 1, e)


def alpha_bits(x: torch.Tensor) -> torch.Tensor:
    """`np_alpha_bits` on a tensor, on its device (int32)."""
    x = x.to(torch.float64)
    bits_pos = torch.clamp(torch.frexp(torch.floor(torch.clamp(x, min=0.0)))
                           .exponent, min=1)
    bits_neg = _ceil_log2(torch.clamp(torch.ceil(-x), min=1.0)) + 1
    return torch.where(x < 0.0, bits_neg, bits_pos).to(torch.int32)


@dataclasses.dataclass
class ProfileResult:
    """Per-stage profile statistics over a sample set."""
    alpha_max: Dict[str, int]
    alpha_avg: Dict[str, int]
    observed_range: Dict[str, Interval]          # join over all samples
    # Fig-5 data: stage -> (bit values, cumulative % of pixels <= bits)
    cdf: Dict[str, Tuple[np.ndarray, np.ndarray]]


def _sample_stats(arrs: Sequence) -> Tuple:
    """(alpha max, min, max, histogram) of each stage of one sample:
    numpy arrays for numpy stages; otherwise tensors on the stages'
    device."""
    if all(isinstance(a, np.ndarray) for a in arrs):
        bits = [np_alpha_bits(a) for a in arrs]
        return (np.array([b.max() for b in bits], dtype=np.int64),
                np.array([a.min() for a in arrs], dtype=np.float64),
                np.array([a.max() for a in arrs], dtype=np.float64),
                np.stack([np.bincount(b.ravel(), minlength=HIST_BINS)
                          [:HIST_BINS] for b in bits]))
    arrs = [torch.as_tensor(a) for a in arrs]
    bits = [alpha_bits(a) for a in arrs]
    return (torch.stack([b.max() for b in bits]).to(torch.int64),
            torch.stack([a.min() for a in arrs]).to(torch.float64),
            torch.stack([a.max() for a in arrs]).to(torch.float64),
            torch.stack([torch.bincount(b.flatten(), minlength=HIST_BINS)
                         [:HIST_BINS] for b in bits]))


def _host_stack(xs: Sequence) -> np.ndarray:
    """Stack per-sample statistics; tensors are stacked on their device
    and copied to the host once."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(list(xs)).cpu().numpy()
    return np.stack(xs)


def profile_pipeline(pipeline: Pipeline, images: Sequence,
                     run_float, param_values: Dict[str, float] | None = None,
                     ) -> ProfileResult:
    """`run_float(image, params) -> Dict[stage, tensor or ndarray]` is the
    executor (injected to avoid a core->dsl dependency; see
    `repro_torch.dsl.exec.make_profile_runner`)."""
    names = pipeline.topo_order()
    if not images:
        raise ValueError("profile_pipeline needs at least one image")
    per_sample = []
    for img in images:
        outs = run_float(img, param_values or {})
        per_sample.append(_sample_stats([outs[n] for n in names]))
    # (samples, stages) alphas, minima and maxima; (samples, stages, bins)
    alphas, los, his, hists = (_host_stack([s[k] for s in per_sample])
                               for k in range(4))
    lo, hi = los.min(axis=0), his.max(axis=0)
    if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
        bad = [n for i, n in enumerate(names)
               if not (np.isfinite(lo[i]) and np.isfinite(hi[i]))]
        raise ValueError(f"profile: non-finite values in stage(s) {bad}")
    hist = hists.sum(axis=0, dtype=np.int64)
    alpha_max = {n: int(alphas[:, i].max()) for i, n in enumerate(names)}
    alpha_avg = {n: int(round(float(np.mean(alphas[:, i]))))
                 for i, n in enumerate(names)}
    cdf = {}
    for i, n in enumerate(names):
        total = hist[i].sum()
        cum = 100.0 * np.cumsum(hist[i]) / max(total, 1)
        upper = max(int(np.nonzero(hist[i])[0].max(initial=0)) + 1, 1)
        cdf[n] = (np.arange(upper), cum[:upper])
    return ProfileResult(
        alpha_max=alpha_max,
        alpha_avg=alpha_avg,
        observed_range={n: Interval(float(lo[i]), float(hi[i]))
                        for i, n in enumerate(names)},
        cdf=cdf,
    )
