"""`BitwidthPlan` — the artifact every analysis pass emits into.

The port's own copy of `repro.analysis.plan.BitwidthPlan`: one
`StageRange` column per analysis pass (`analysis.driver.run_plan` adds
them), each pass's provenance, optional per-stage phase columns keyed by
sampling-lattice residue, the beta assignment, the soundness-nesting
check across columns, and the stable JSON form.  `from_json` reads the
reference's `to_json` text unchanged and `to_json` writes it back
unchanged, so a design moves from the reference to the port as
``BitwidthPlan.from_json(reference_plan.to_json())``.

`types(column, betas)` and `phase_types(column, betas)` are the
interface `lowering.ir.lower` and `dsl.exec.run_fixed` read; a
`pipelines.types.DesignTypes` is the one-column form of the same.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange

Residue = Tuple[int, int]
# per-column phase data: stage -> (lattice (My, Mx), residue -> StageRange)
PhaseColumn = Dict[str, Tuple[Tuple[int, int], Dict[Residue, StageRange]]]


@dataclasses.dataclass
class Provenance:
    """Where a plan column came from."""
    pass_name: str            # registry name of the producing pass
    spec: str                 # the pass's content key (parameters included)
    notes: List[str] = dataclasses.field(default_factory=list)


def _sr_to_json(sr: StageRange) -> Dict:
    return {"lo": sr.range.lo, "hi": sr.range.hi,
            "alpha": sr.alpha, "signed": sr.signed}


def _sr_from_json(d: Dict) -> StageRange:
    return StageRange(range=Interval(float(d["lo"]), float(d["hi"])),
                      alpha=int(d["alpha"]), signed=bool(d["signed"]))


class PlanNestingError(AssertionError):
    """A plan-level soundness-nesting check failed (see `check_nesting`)."""


@dataclasses.dataclass
class BitwidthPlan:
    """Per-pipeline bit-width plan (columns + provenance)."""

    pipeline: str
    content_hash: str = ""
    columns: Dict[str, Dict[str, StageRange]] = \
        dataclasses.field(default_factory=dict)
    provenance: Dict[str, Provenance] = dataclasses.field(default_factory=dict)
    phases: Dict[str, PhaseColumn] = dataclasses.field(default_factory=dict)
    betas: Dict[str, int] = dataclasses.field(default_factory=dict)
    default_column: str = ""

    # -- construction -------------------------------------------------------
    def add_column(self, name: str, ranges: Dict[str, StageRange],
                   provenance: Provenance,
                   phases: Optional[PhaseColumn] = None) -> None:
        if name in self.columns:
            raise ValueError(f"duplicate plan column {name!r}")
        self.columns[name] = dict(ranges)
        self.provenance[name] = provenance
        if phases:
            self.phases[name] = phases
        if not self.default_column:
            self.default_column = name

    # -- queries ------------------------------------------------------------
    def _col(self, column: Optional[str]) -> str:
        name = column or self.default_column
        if name not in self.columns:
            raise KeyError(f"plan has no column {name!r}; "
                           f"columns: {sorted(self.columns)}")
        return name

    def stage_ranges(self, column: Optional[str] = None) -> Dict[str, StageRange]:
        return dict(self.columns[self._col(column)])

    def alphas(self, column: Optional[str] = None) -> Dict[str, int]:
        return {n: r.alpha for n, r in self.columns[self._col(column)].items()}

    def signed(self, column: Optional[str] = None) -> Dict[str, bool]:
        return {n: r.signed for n, r in self.columns[self._col(column)].items()}

    def stages(self) -> List[str]:
        return list(self.columns[self._col(None)])

    def record_election(self, column: Optional[str],
                        notes: List[str]) -> None:
        """Append datapath-election provenance: `lowering.ir.lower(...,
        datapath="narrow")` records its per-stage census and one line per
        retained 64-bit datapath here."""
        col = self._col(column)
        for note in notes:
            if note not in self.provenance[col].notes:
                self.provenance[col].notes.append(note)

    def _clamp_note(self, col: str, note: str) -> None:
        if note not in self.provenance[col].notes:
            self.provenance[col].notes.append(note)
        warnings.warn(f"plan column {col!r}: {note}", RuntimeWarning,
                      stacklevel=3)

    # -- consumption --------------------------------------------------------
    def types(self, column: Optional[str] = None,
              betas: Optional[Dict[str, int]] = None,
              ) -> Dict[str, FixedPointType]:
        """Fixed-point type map of one column (the executor's input).

        Zero or negative alphas are clamped to 1 bit (a `FixedPointType`
        needs a field bit); each clamp is noted in the column's
        provenance and raised as a `RuntimeWarning`."""
        col = self._col(column)
        bmap = self.betas if betas is None else betas
        out: Dict[str, FixedPointType] = {}
        clamped: List[str] = []
        for n, r in self.columns[col].items():
            if r.alpha < 1:
                clamped.append(n)
            out[n] = FixedPointType(alpha=max(r.alpha, 1),
                                    beta=bmap.get(n, 0), signed=r.signed)
        if clamped:
            self._clamp_note(col, f"alpha clamped to 1 on zero-range "
                                  f"stage(s): {', '.join(clamped)}")
        return out

    def phase_types(self, column: Optional[str] = None,
                    betas: Optional[Dict[str, int]] = None,
                    ) -> Dict[str, Tuple[Tuple[int, int],
                                         Dict[Residue, FixedPointType]]]:
        """Per-phase type maps: stage -> (lattice, residue -> type).

        Only stages with phase sub-columns appear; the union-column type
        holds everywhere else."""
        col = self._col(column)
        bmap = self.betas if betas is None else betas
        out = {}
        clamped: List[str] = []
        for stage, (lat, rmap) in self.phases.get(col, {}).items():
            if any(sr.alpha < 1 for sr in rmap.values()):
                clamped.append(stage)
            out[stage] = (lat, {
                res: FixedPointType(alpha=max(sr.alpha, 1),
                                    beta=bmap.get(stage, 0), signed=sr.signed)
                for res, sr in rmap.items()})
        if clamped:
            self._clamp_note(col, f"alpha clamped to 1 on zero-range "
                                  f"phase(s) of: {', '.join(clamped)}")
        return out

    # -- plan-level checks ---------------------------------------------------
    def check_nesting(self, columns: List[str]) -> bool:
        """Soundness-nesting invariant across columns, tightest first.

        ``check_nesting(["profile", "smt", "meet(interval,affine)"])``
        asserts per stage that each column's range is enclosed by the next
        one's and that alphas are non-decreasing —
        the plan-level form of the paper's profile ⊆ solver ⊆ static
        ordering.  Raises `PlanNestingError` listing every violation.
        """
        bad: List[str] = []
        for tight, loose in zip(columns, columns[1:]):
            a, b = self.columns[self._col(tight)], self.columns[self._col(loose)]
            for n in a:
                if n not in b:
                    continue
                if not b[n].range.encloses(a[n].range):
                    bad.append(f"{n}: {tight} {a[n].range} ⊄ "
                               f"{loose} {b[n].range}")
                elif a[n].alpha > b[n].alpha:
                    bad.append(f"{n}: alpha({tight})={a[n].alpha} > "
                               f"alpha({loose})={b[n].alpha}")
        if bad:
            raise PlanNestingError(
                f"plan {self.pipeline!r} nesting {' ⊆ '.join(columns)} "
                f"violated:\n  " + "\n  ".join(bad))
        return True

    # -- serialization -------------------------------------------------------
    def to_json_dict(self) -> Dict:
        return {
            "version": 1,
            "pipeline": self.pipeline,
            "content_hash": self.content_hash,
            "default_column": self.default_column,
            "columns": {c: {n: _sr_to_json(r) for n, r in col.items()}
                        for c, col in self.columns.items()},
            "provenance": {c: {"pass": p.pass_name, "spec": p.spec,
                               "notes": list(p.notes)}
                           for c, p in self.provenance.items()},
            "phases": {c: {stage: {
                "lattice": list(lat),
                "ranges": {f"{ry},{rx}": _sr_to_json(sr)
                           for (ry, rx), sr in rmap.items()}}
                for stage, (lat, rmap) in pc.items()}
                for c, pc in self.phases.items()},
            "betas": dict(self.betas),
        }

    def to_json(self) -> str:
        """Stable text form: sorted keys, fixed indent (the executor
        memo's key, as in the reference)."""
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=1)

    @classmethod
    def from_json_dict(cls, d: Dict) -> "BitwidthPlan":
        plan = cls(pipeline=d["pipeline"],
                   content_hash=d.get("content_hash", ""),
                   default_column=d.get("default_column", ""))
        for c, col in d.get("columns", {}).items():
            plan.columns[c] = {n: _sr_from_json(v) for n, v in col.items()}
        for c, p in d.get("provenance", {}).items():
            plan.provenance[c] = Provenance(pass_name=p["pass"],
                                            spec=p["spec"],
                                            notes=list(p.get("notes", [])))
        for c, pc in d.get("phases", {}).items():
            plan.phases[c] = {}
            for stage, entry in pc.items():
                rmap = {}
                for key, v in entry["ranges"].items():
                    ry, rx = key.split(",")
                    rmap[(int(ry), int(rx))] = _sr_from_json(v)
                plan.phases[c][stage] = (tuple(entry["lattice"]), rmap)
        plan.betas = {n: int(b) for n, b in d.get("betas", {}).items()}
        if not plan.default_column and plan.columns:
            plan.default_column = next(iter(plan.columns))
        return plan

    @classmethod
    def from_json(cls, text: str) -> "BitwidthPlan":
        return cls.from_json_dict(json.loads(text))
