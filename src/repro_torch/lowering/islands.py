"""Rate-island partitioning of a lowered DAG.

The port's own copy of `repro.lowering.islands` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

A *rate island* is a maximal rate-uniform subgraph of the
`LoweredPipeline` DAG that admits one lattice-aligned row-band schedule
(`build_island_schedule`).  Each island fuses through one launch of
the band kernel (`kernels/stencil/kernel.py:fused_pipeline`); islands
are stitched with materialized device-memory boundary buffers holding each boundary stage's *stored* representation — the
smallest legalized container (`core.policy.legalize` via
`backends.store_dtype`: int8/uint8/int16/uint16/int32, int64 for 33–52
exact-integer bits, f64 for float-stored stages).  Narrow stitching
preserves the bit-for-bit differential contract against the numpy
oracle: the stored value was clipped into the container's range before
the narrowing astype, loads widen losslessly, so the downstream
island's clamped gathers over a materialized boundary read exactly the
values the oracle's padded geometry reads — in a quarter of the bytes
where the plan proves 8-bit ranges.

This is the Rigel / heterogeneous-systems-DSL composition (PAPERS.md):
multi-rate pipelines are built from rate-uniform fused segments joined
at rate boundaries.  The partitioner is greedy over the topological
order: it grows the current island one stage at a time, accepting a
stage iff the extended island still schedules; on failure it closes the
island and starts a new one.  A stage that cannot be banded even alone
(rate-inexact height, halo deeper than every aligned tile) becomes a
single-stage island on the degenerate one-tile schedule
(`single_tile_schedule`) — so partitioning is *total*: every DAG lowers
to fused band-kernel islands.

For a fully schedulable DAG the fast path returns one island whose
schedule is identical to `build_schedule`'s (pinned by
`tests/test_islands.py`).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.lowering.backends import needed_stages, store_dtype
from repro_torch.lowering.ir import LoweredPipeline, LoweringError
from repro_torch.lowering.schedule import (Schedule, build_island_schedule,
                                           single_tile_schedule,
                                           stage_shapes)


@dataclasses.dataclass
class Island:
    """One fused segment: `stages` (topo) + its materialized boundary."""
    idx: int
    stages: List[str]          # compute stages, topo order
    inputs: List[str]          # external inputs (materialized upstream)
    outputs: List[str]         # stages stored back to device memory
    rate: Fraction             # first stage's rows per root-image row
    schedule: Schedule
    single_tile: bool          # True when on the one-tile escape hatch

    def carrier_mix(self, lp: LoweredPipeline) -> str:
        """Compact datapath census for telemetry, e.g. 'int32x3,f64x1'."""
        counts: Dict[str, int] = {}
        for n in self.stages:
            ls = lp.stages[n]
            label = ls.carrier if ls.kind == "intlinear" else ls.expr_dtype
            counts[label] = counts.get(label, 0) + 1
        return ",".join(f"{k}x{v}" for k, v in sorted(counts.items()))

    def stored_mix(self, lp: LoweredPipeline) -> str:
        """Stored-container census (legalized tile dtypes), e.g.
        'int16x3,uint8x1' — the storage-side twin of `carrier_mix`."""
        counts: Dict[str, int] = {}
        for n in self.stages:
            label = str(store_dtype(lp.stages[n])).split(".")[-1]
            counts[label] = counts.get(label, 0) + 1
        return ",".join(f"{k}x{v}" for k, v in sorted(counts.items()))

    def boundary_bytes(self, lp: LoweredPipeline) -> Tuple[int, int]:
        """(stored, saved) bytes of this island's materialized outputs per
        image — `saved` relative to a uniform int32 baseline (negative
        for f64-stored boundaries)."""
        stored = saved = 0
        for n in self.outputs:
            ss = self.schedule.stages[n]
            nb = store_dtype(lp.stages[n]).itemsize
            stored += ss.H * ss.W * nb
            saved += ss.H * ss.W * (4 - nb)
        return stored, saved


@dataclasses.dataclass
class IslandPlan:
    islands: List[Island]
    order: List[str]           # all needed stages (inputs + compute), topo
    inputs: List[str]          # pipeline input stages
    outputs: List[str]         # pipeline outputs requested

    @property
    def fully_fused(self) -> bool:
        return len(self.islands) == 1 and not self.islands[0].single_tile


def _ext_inputs(lp: LoweredPipeline, stages: Sequence[str]) -> List[str]:
    inside = set(stages)
    seen, out = set(), []
    for n in stages:
        for i in lp.stages[n].stage.inputs:
            if i not in inside and i not in seen:
                seen.add(i)
                out.append(i)
    return out


def partition_islands(lp: LoweredPipeline, in_shape: Tuple[int, int],
                      outputs: Optional[Sequence[str]] = None) -> IslandPlan:
    """Cut the lowered DAG into scheduled rate islands (always succeeds).

    `outputs` (default: the pipeline's outputs) are the stages stored
    back to device memory; any stage may be one, and only its ancestors
    are scheduled."""
    outs = list(outputs or lp.pipeline.outputs)
    order = needed_stages(lp, outs)
    shapes = stage_shapes(lp, in_shape)
    inputs = [n for n in order if lp.stages[n].stage.is_input]
    compute = [n for n in order if not lp.stages[n].stage.is_input]
    outs_set = set(outs)
    consumers: Dict[str, List[str]] = {n: [] for n in order}
    for n in compute:
        for i in lp.stages[n].stage.inputs:
            if i in consumers:
                consumers[i].append(n)

    def boundary_outputs(stages: Sequence[str]) -> List[str]:
        inside = set(stages)
        return [n for n in stages
                if n in outs_set
                or any(c not in inside for c in consumers[n])]

    def try_build(stages: List[str]) -> Optional[Schedule]:
        try:
            return build_island_schedule(
                lp, shapes, stages, _ext_inputs(lp, stages),
                boundary_outputs(stages))
        except LoweringError:
            return None

    def rate_of(stages: Sequence[str]) -> Fraction:
        return Fraction(shapes[stages[0]][0], in_shape[0])

    # fast path: the whole DAG as one island (the historical case)
    whole = try_build(compute)
    if whole is not None:
        isl = Island(0, compute, inputs, outs, rate_of(compute), whole,
                     single_tile=False)
        return IslandPlan([isl], order, inputs, outs)

    islands: List[Island] = []

    def close(stages: List[str], sched: Optional[Schedule]) -> None:
        ext = _ext_inputs(lp, stages)
        bout = boundary_outputs(stages)
        single = sched is None
        if single:
            sched = single_tile_schedule(lp, shapes, stages, ext, bout)
        islands.append(Island(len(islands), list(stages), ext, bout,
                              rate_of(stages), sched, single))

    cur: List[str] = []
    cur_sched: Optional[Schedule] = None
    for name in compute:
        cand = cur + [name]
        sched = try_build(cand)
        if sched is not None:
            cur, cur_sched = cand, sched
            continue
        if cur:
            close(cur, cur_sched)
        solo = try_build([name])
        if solo is not None:
            cur, cur_sched = [name], solo
        else:
            close([name], None)
            cur, cur_sched = [], None
    if cur:
        close(cur, cur_sched)
    return IslandPlan(islands, order, inputs, outs)
