"""`DesignPoint` / `Frontier` — the artifacts of the bitwidth design search.

The paper's end product is not a bit-range table but an area/power-optimal
fixed-point *design*: one (alpha, beta) assignment per stage whose measured
output error stays inside the application budget.  A design search produces
many candidates; the useful summary is the **Pareto frontier** over

    error   (PSNR vs the f64 oracle, higher is better)
    power   (`cost_model.DesignCost.power_proxy`, lower is better)
    area    (LUT + DSP bits, lower is better)

A point enters the frontier only if it *meets the error budget* and no kept
point dominates it; dominated incumbents are evicted on insert, so the two
invariants — mutual non-domination and budget-compliance of every
returned point — hold by construction.

Every point carries provenance back to the `BitwidthPlan` that seeded the
search (pipeline content hash, plan column, proposing strategy) plus a
`verified` flag set only after the candidate's score was reproduced bit
for bit through the band-kernel path and checked against the per-stage
oracle (`evaluate.Evaluator.verify`).  Serialization is stable sorted
JSON, same discipline as the plan itself.

The port's own copy of `repro.dse.frontier`: `to_json` writes the
reference's text for the same points.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

# PSNR is capped here so exact designs (mse == 0) serialize as a finite,
# stable number instead of Infinity (which is not strict JSON)
PSNR_CAP = 999.0


@dataclasses.dataclass
class ErrorBudget:
    """Output-quality floor every returned design must respect.

    `min_psnr` is measured against the f64 float reference on the
    pipeline's output stages (peak = the reference's own signal peak, so
    deep-integer outputs like HCD's `harris` are scored on their real
    scale).  `max_abs_err`, when set, additionally caps the worst-case
    absolute output error.
    """
    min_psnr: float
    max_abs_err: Optional[float] = None

    def met_by(self, psnr: float, abs_err: float) -> bool:
        if psnr < self.min_psnr:
            return False
        if self.max_abs_err is not None and abs_err > self.max_abs_err:
            return False
        return True

    def to_json_dict(self) -> Dict:
        return {"min_psnr": self.min_psnr, "max_abs_err": self.max_abs_err}

    @classmethod
    def from_json_dict(cls, d: Dict) -> "ErrorBudget":
        return cls(min_psnr=float(d["min_psnr"]),
                   max_abs_err=(None if d.get("max_abs_err") is None
                                else float(d["max_abs_err"])))


@dataclasses.dataclass
class DesignPoint:
    """One evaluated (alpha, beta) assignment with its measured objectives."""

    alphas: Dict[str, int]
    betas: Dict[str, int]
    signed: Dict[str, bool]
    # measured objectives (never analytical guesses — see evaluate.Evaluator)
    psnr: float
    max_abs_err: float
    power: float                 # DesignCost.power_proxy
    lut_bits: float
    dsp_bits: float
    bram_bits: float
    total_bits: int
    meets_budget: bool
    # provenance: which strategy proposed it, which plan seeded the search
    strategy: str = ""
    pipeline: str = ""
    plan_hash: str = ""          # BitwidthPlan.content_hash
    plan_column: str = ""        # plan column the alphas were seeded from
    verified: bool = False       # re-scored bit for bit by the kernel path
    # the per-stage oracle ("interp") reproduced the kernel path's score
    # exactly; False would mark a design whose f64 expression landed on
    # an rint rounding tie resolved the other way (bounded by one output
    # LSB).  The port builds its kernels without FMA contraction, so it
    # is expected to be True on every design
    oracle_exact: bool = True

    @property
    def area(self) -> float:
        """Scalar area objective: logic + multiplier array bits."""
        return self.lut_bits + self.dsp_bits

    def dominates(self, other: "DesignPoint") -> bool:
        """Pareto dominance over (error, power, area): no worse on all
        three objectives and strictly better on at least one."""
        ge = (self.psnr >= other.psnr and self.power <= other.power
              and self.area <= other.area)
        gt = (self.psnr > other.psnr or self.power < other.power
              or self.area < other.area)
        return ge and gt

    def key(self) -> Tuple:
        """Content identity of the candidate configuration itself."""
        return (tuple(sorted(self.alphas.items())),
                tuple(sorted(self.betas.items())))

    def to_json_dict(self) -> Dict:
        return {
            "alphas": dict(sorted(self.alphas.items())),
            "betas": dict(sorted(self.betas.items())),
            "signed": dict(sorted(self.signed.items())),
            # numeric fields coerced so serialization is type-stable no
            # matter how the point was constructed (int vs float costs)
            "psnr": float(self.psnr),
            "max_abs_err": float(self.max_abs_err),
            "power": float(self.power), "lut_bits": float(self.lut_bits),
            "dsp_bits": float(self.dsp_bits),
            "bram_bits": float(self.bram_bits),
            "total_bits": int(self.total_bits),
            "meets_budget": self.meets_budget,
            "strategy": self.strategy, "pipeline": self.pipeline,
            "plan_hash": self.plan_hash, "plan_column": self.plan_column,
            "verified": self.verified, "oracle_exact": self.oracle_exact,
        }

    @classmethod
    def from_json_dict(cls, d: Dict) -> "DesignPoint":
        return cls(
            alphas={k: int(v) for k, v in d["alphas"].items()},
            betas={k: int(v) for k, v in d["betas"].items()},
            signed={k: bool(v) for k, v in d["signed"].items()},
            psnr=float(d["psnr"]), max_abs_err=float(d["max_abs_err"]),
            power=float(d["power"]), lut_bits=float(d["lut_bits"]),
            dsp_bits=float(d["dsp_bits"]), bram_bits=float(d["bram_bits"]),
            total_bits=int(d["total_bits"]),
            meets_budget=bool(d["meets_budget"]),
            strategy=d.get("strategy", ""), pipeline=d.get("pipeline", ""),
            plan_hash=d.get("plan_hash", ""),
            plan_column=d.get("plan_column", ""),
            verified=bool(d.get("verified", False)),
            oracle_exact=bool(d.get("oracle_exact", True)))


class Frontier:
    """Budget-gated Pareto frontier over (error, power, area).

    `add` returns the disposition: ``"accepted"`` (kept, dominated
    incumbents evicted), ``"dominated"`` (an incumbent dominates it), or
    ``"budget"`` (error budget violated — never kept).  Duplicate
    configurations resolve to ``"dominated"`` (a point never strictly
    dominates its own copy, and the copy adds nothing).
    """

    def __init__(self, budget: ErrorBudget):
        self.budget = budget
        self._points: List[DesignPoint] = []

    def __len__(self) -> int:
        return len(self._points)

    def add(self, p: DesignPoint) -> str:
        if not p.meets_budget:
            return "budget"
        if any(q.key() == p.key() for q in self._points):
            return "dominated"
        if any(q.dominates(p) for q in self._points):
            return "dominated"
        self._points = [q for q in self._points if not p.dominates(q)]
        self._points.append(p)
        return "accepted"

    def points(self) -> List[DesignPoint]:
        """Frontier points in a stable order: power ascending, then error
        descending — the natural left-to-right Pareto walk."""
        return sorted(self._points,
                      key=lambda p: (p.power, -p.psnr, p.area,
                                     p.total_bits, p.key()))

    def best(self, objective: str = "power") -> Optional[DesignPoint]:
        """Cheapest frontier point by one scalar objective (the "chosen"
        design of the benchmark report); ties break toward better error."""
        pts = self.points()
        if not pts:
            return None
        keyf = {"power": lambda p: (p.power, p.area, -p.psnr),
                "area": lambda p: (p.area, p.power, -p.psnr),
                "psnr": lambda p: (-p.psnr, p.power, p.area)}[objective]
        return min(pts, key=keyf)

    def check_invariants(self) -> bool:
        """The two frontier guarantees, re-checked explicitly (tests)."""
        pts = self._points
        for i, a in enumerate(pts):
            if not a.meets_budget:
                raise AssertionError(f"frontier point violates budget: {a}")
            for j, b in enumerate(pts):
                if i != j and a.dominates(b):
                    raise AssertionError(
                        f"frontier point {i} dominates point {j}")
        return True

    # -- serialization -------------------------------------------------------
    def to_json_dict(self) -> Dict:
        return {
            "version": 1,
            "budget": self.budget.to_json_dict(),
            "points": [p.to_json_dict() for p in self.points()],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=1)

    @classmethod
    def from_json_dict(cls, d: Dict) -> "Frontier":
        fr = cls(ErrorBudget.from_json_dict(d["budget"]))
        fr._points = [DesignPoint.from_json_dict(p) for p in d["points"]]
        return fr

    @classmethod
    def from_json(cls, text: str) -> "Frontier":
        return cls.from_json_dict(json.loads(text))
