"""Runtime range telemetry — per-stage observed min/max, saturation, headroom.

Port of `repro.obs.runtime`.  The paper's profile-driven analysis (§IV)
bounds each stage's range from a handful of sample images *before*
synthesis; this module closes the loop from the other side, measuring on
the production execution path what the plan's alpha bits actually cover:

  * **observed range** — finite min/max of the stage's (dequantized f64)
    values;
  * **observed alpha** — `alpha_for_range` of that observed range, i.e.
    the integral bits this run *needed*;
  * **headroom** — plan alpha minus observed alpha: positive = the static
    plan reserved more bits than this input exercised, negative would
    mean runtime values escaped the proven range (never, for certified
    plans);
  * **saturation counts** — pixels sitting exactly on the type's clip
    rails after the snap (`q == int_max`, plus `q == int_min` for signed
    types; an unsigned lower rail of 0 would count every legitimate zero
    pixel).  For stages with a `PhaseSnap`, each sampling-lattice residue
    is counted against its own rails and a per-residue breakdown is
    attached.

Stage values are `(y, x)` planes, optionally under leading batch axes
(the batched executors produce `(B, H, W)`): every reduction runs over
all leading axes, and the residue slicing applies to the trailing two,
so batched and per-image telemetry agree (min/max join, rail counts
sum).  The reductions run where the values are: on a CUDA tensor the
min, max and counts are computed on the card and one small vector of
scalars is copied to the host per stage.

Everything here is read-only post-processing of stage outputs: it never
feeds back into the computation, so results with telemetry on are
bit-equal to results with it off.  It runs only when the active tracer
was created with `runtime_ranges=True`.  Records land in the shared
stream as `rt.range` events; `obs.report` tabulates them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import tracer as _tracer

__all__ = ["enabled", "record_env", "record_stage"]


def enabled() -> bool:
    """True when an active tracer requested runtime range telemetry."""
    return _tracer.runtime_ranges_enabled()


def _rail_counts(q: torch.Tensor, t) -> List[torch.Tensor]:
    """[lo, hi]: pixels at the saturation rails of type `t` for qvalues
    `q` (device scalars)."""
    hi = torch.count_nonzero(q >= t.int_max)
    lo = (torch.count_nonzero(q <= t.int_min) if t.int_min < 0
          else torch.zeros((), dtype=torch.int64, device=q.device))
    return [lo, hi]


def record_stage(name: str, value, t=None, phase=None,
                 backend: str = "?") -> Optional[dict]:
    """Measure one stage's values and emit an `rt.range` event.

    `value` is a tensor on any device or an array.  `t` is the stage's
    union `FixedPointType` (None = float stage: range only, no
    saturation or headroom).  `phase` is a `lowering.ir.PhaseSnap` or the
    raw plan form ``((My, Mx), {residue: type})``; when given, saturation
    is counted per residue against that residue's own rails.  Returns
    the attribute dict, or None when telemetry is off.
    """
    tr = _tracer.active_tracer()
    if tr is None or not tr.runtime_ranges:
        return None
    from repro_torch.core.fixedpoint import alpha_for_range

    v = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.asarray(value, dtype=np.float64))
    v = v.to(torch.float64)
    # every statistic as a device scalar, copied to the host in one piece
    fin = torch.isfinite(v)
    scal = [torch.count_nonzero(fin).to(torch.float64)]
    if v.numel():
        scal += [torch.where(fin, v, torch.inf).amin(),
                 torch.where(fin, v, -torch.inf).amax()]
    lattice = types = None
    residues = []
    if t is not None:
        if phase is not None:
            lattice = getattr(phase, "lattice", None)
            types = getattr(phase, "types", None)
            if lattice is None:       # raw plan entry ((My, Mx), {res: t})
                lattice, types = phase
        if lattice is not None and v.ndim >= 2:
            # residues live on the trailing (y, x) axes; leading batch
            # axes pass through the slice, so batched rail counts are the
            # sum of the per-image counts
            my, mx = lattice
            residues = [(ry, rx, types.get((ry, rx), t))
                        for ry in range(my) for rx in range(mx)]
            for ry, rx, t_res in residues:
                q = torch.round(v[..., ry::my, rx::mx] * (2.0 ** t_res.beta))
                scal += [c.to(torch.float64) for c in _rail_counts(q, t_res)]
        else:
            lattice = None
            q = torch.round(v * (2.0 ** t.beta))
            scal += [c.to(torch.float64) for c in _rail_counts(q, t)]
    host = torch.stack(scal).cpu().tolist()
    attrs: Dict[str, Any] = {"stage": name, "backend": backend,
                             "n": int(v.numel())}
    n_finite, host = int(host[0]), host[1:]
    if v.numel():
        vmin, vmax, host = host[0], host[1], host[2:]
        if n_finite:
            attrs["min"] = vmin
            attrs["max"] = vmax
            attrs["alpha_obs"] = int(alpha_for_range(vmin, vmax))
    if t is not None:
        attrs["type"] = str(t)
        attrs["alpha_plan"] = int(t.alpha)
        if "alpha_obs" in attrs:
            attrs["headroom"] = attrs["alpha_plan"] - attrs["alpha_obs"]
        counts = [int(c) for c in host]
        if lattice is not None:
            sat_lo = sat_hi = 0
            per_res = {}
            for k, (ry, rx, _) in enumerate(residues):
                lo, hi = counts[2 * k], counts[2 * k + 1]
                sat_lo += lo
                sat_hi += hi
                if lo or hi:
                    per_res[f"{ry},{rx}"] = lo + hi
            attrs["sat_phases"] = per_res
        else:
            sat_lo, sat_hi = counts
        attrs["sat_lo"] = sat_lo
        attrs["sat_hi"] = sat_hi
        attrs["sat"] = sat_lo + sat_hi
    tr.event("rt.range", **attrs)
    return attrs


def record_env(env: Dict[str, Any], lp, backend: str) -> None:
    """Measure every stage present in `env` against a `LoweredPipeline`'s
    per-stage types (the executors call this after execution)."""
    if not enabled():
        return
    for n in lp.order:
        if n in env:
            ls = lp.stages[n]
            record_stage(n, env[n], ls.t, ls.phase, backend=backend)
