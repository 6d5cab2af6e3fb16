"""Bit-width designs: the state a pipeline run carries in.

A design — per-stage (alpha, beta, signedness), plus per-residue phase
types where the plan split a stage by sampling-lattice residue — plays
the part weights play for a model.  The port computes designs with its
own range analyses (`repro_torch.analysis.run_plan`); `design_from_plan`
turns a plan column into a `DesignTypes`.  Serving reads designs as
data, a cache of that computation, so it needs no analysis at start-up.

Data shape (the stage entries of `BitwidthPlan.to_json`)::

    {"types":  {stage: {"alpha": a, "beta": b, "signed": s}, ...},
     "phases": {stage: {"lattice": [my, mx],
                        "ranges": {"ry,rx": {"alpha": a, "signed": s,
                                             ["beta": b]}}}}}   # optional

A residue entry without "beta" takes its stage's beta, as
`BitwidthPlan.phase_types` does; extra keys ("lo", "hi") are ignored.
`types/<pipeline>_b4.json` hold the serving benchmark's designs (static
interval alphas, beta 4 on every stage) for usm, hcd, dus, dus_ext, of
and of_pyramid: ``design_from_plan(run_plan(pipe, ["interval"],
betas={n: 4 for n in pipe.stages}))``, which the tests and
`chip_smoke.py` hold equal to them.  A reference `BitwidthPlan` with
several columns comes across whole as
`repro_torch.analysis.plan.BitwidthPlan.from_json`.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.core.fixedpoint import FixedPointType

Residue = Tuple[int, int]
PhaseTypes = Dict[str, Tuple[Tuple[int, int], Dict[Residue, FixedPointType]]]

TYPES_DIR = Path(__file__).resolve().parent / "types"


@dataclasses.dataclass(frozen=True)
class DesignTypes:
    """A bit-width design.  `types()` and `phase_types()` are the plan
    interface `lowering.ir.lower` reads, as from a `BitwidthPlan`."""
    union: Dict[str, FixedPointType]
    phases: PhaseTypes = dataclasses.field(default_factory=dict)

    def types(self, column=None) -> Dict[str, FixedPointType]:
        return dict(self.union)

    def phase_types(self, column=None) -> PhaseTypes:
        return dict(self.phases)

    def to_data(self) -> Dict:
        def entry(t: FixedPointType) -> Dict:
            return {"alpha": t.alpha, "beta": t.beta, "signed": t.signed}

        data: Dict = {"types": {n: entry(t) for n, t in self.union.items()}}
        if self.phases:
            data["phases"] = {
                stage: {"lattice": list(lat),
                        "ranges": {f"{ry},{rx}": entry(t)
                                   for (ry, rx), t in rmap.items()}}
                for stage, (lat, rmap) in self.phases.items()}
        return data

    def to_json(self) -> str:
        """Stable text form (the executor memo's key)."""
        return json.dumps(self.to_data(), sort_keys=True)


def _fixed(name: str, d: Dict, beta: int) -> FixedPointType:
    alpha = int(d["alpha"])
    if alpha < 1:
        # a FixedPointType needs a field bit; the plan clamps the same way
        warnings.warn(f"alpha clamped to 1 on zero-range stage {name!r}",
                      RuntimeWarning, stacklevel=3)
    return FixedPointType(alpha=max(alpha, 1), beta=int(d.get("beta", beta)),
                          signed=bool(d["signed"]))


def design_from_plan(plan, column: Optional[str] = None,
                     betas: Optional[Dict[str, int]] = None) -> DesignTypes:
    """One column of a `BitwidthPlan` (default: its default column) as a
    design: its type map and per-residue types, at `betas` (default:
    the plan's)."""
    return DesignTypes(plan.types(column, betas),
                       plan.phase_types(column, betas))


def types_from_data(d: Dict) -> DesignTypes:
    """Plain data (see the module docstring) -> `DesignTypes`."""
    union = {n: _fixed(n, v, 0) for n, v in d["types"].items()}
    phases: PhaseTypes = {}
    for stage, entry in d.get("phases", {}).items():
        rmap = {}
        for key, v in entry["ranges"].items():
            ry, rx = key.split(",")
            rmap[(int(ry), int(rx))] = _fixed(stage, v, union[stage].beta)
        phases[stage] = (tuple(int(m) for m in entry["lattice"]), rmap)
    return DesignTypes(union, phases)


def load_types(pipeline: str) -> DesignTypes:
    """The committed serving design of `pipeline` (usm, hcd, dus,
    dus_ext, of, of_pyramid): static interval alphas, beta 4 on every
    stage."""
    path = TYPES_DIR / f"{pipeline}_b4.json"
    return types_from_data(json.loads(path.read_text()))
