"""Row-band tile schedules for the fused band-kernel backend.

The port's own copy of `repro.lowering.schedule` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

The fused kernel walks a stage subgraph once per band of output rows,
keeping every intermediate stage's band in a per-block workspace (the
GPU analogue of the paper's FPGA line buffers).  For that to be a static
program, every stage's per-tile row window must be a *translation* of the
same window: tile `i` of stage `s` covers rows

    [i * step_s + lo_s,  i * step_s + hi_s)        (clamped at the edges)

which works exactly when every per-stage row rate `r_s` (output rows per
*base* row, an exact rational through stride/upsample chains) times the
base tile height `T` is an integer.  The core solver picks the smallest
such `T` dividing the base height, then runs one backward span pass
computing (lo, hi) per stage from its consumers' needs — the tap-shifted,
rate-scaled union:

    lo_p = min over consumer taps  floor((sy*lo_c + dy) / uy)
    hi_p = max over consumer taps  floor((sy*(hi_c - 1) + dy) / uy) + 1

`floor((i*step_c*sy + k) / uy) == i*step_p + floor(k / uy)` holds because
`step_c * sy / uy = step_p` is an integer by construction — the whole
point of the lattice-aligned tile height (the same divisibility argument
`smt.encoder.sampling_lattice` makes for phase-split CSPs).

Two entry points share the core:

* `build_schedule` — whole-DAG schedule anchored at the pipeline input
  (the historical interface; raises `LoweringError` on rate conflicts or
  rate-inexact heights).
* `build_island_schedule` — schedule for a *rate island*: an arbitrary
  rate-uniform stage subgraph whose external inputs are materialized
  arrays (pipeline inputs or upstream islands' stored outputs).  Rates
  are anchored at the tallest external input, so a coarse pyramid level
  schedules at rate 1 relative to itself.

`single_tile_schedule` is the universal escape hatch: one grid step whose
band is each stage's full height.  It is always valid (the kernel's
clamped gathers degenerate to whole-array gathers), so islands that
cannot be banded — rate-inexact heights, halos deeper than any aligned
tile — still fuse.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from math import gcd
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.lowering.ir import LoweredPipeline, LoweringError


@dataclasses.dataclass
class StageSched:
    step: int          # output rows this stage advances per grid tile
    lo: int            # row-span start, relative to i*step
    hi: int            # row-span end (exclusive), relative to i*step
    H: int             # full stage height
    W: int             # full stage width

    @property
    def L(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass
class Schedule:
    grid: int                         # number of row tiles
    tile_rows: int                    # T: base rows per tile
    stages: Dict[str, StageSched]     # materialized stages only (topo order)
    order: List[str]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def stage_shapes(lp: LoweredPipeline, in_shape: Tuple[int, int]
                 ) -> Dict[str, Tuple[int, int]]:
    """Exact executor shapes: expand by upsample, then `[::s]` decimation."""
    shapes: Dict[str, Tuple[int, int]] = {}
    for name in lp.order:
        st = lp.stages[name].stage
        if st.is_input:
            shapes[name] = in_shape
            continue
        h, w = shapes[st.inputs[0]]
        h, w = h * st.upsample[0], w * st.upsample[1]
        shapes[name] = (_ceil_div(h, st.stride[0]),
                        _ceil_div(w, st.stride[1]))
    return shapes


def row_rates(lp: LoweredPipeline) -> Dict[str, Fraction]:
    """Output rows per root row, per stage; LoweringError on rate conflicts."""
    rates: Dict[str, Fraction] = {}
    for name in lp.order:
        st = lp.stages[name].stage
        if st.is_input:
            rates[name] = Fraction(1)
            continue
        rs = {rates[i] for i in st.inputs}
        if len(rs) != 1:
            raise LoweringError(
                f"stage {name!r} mixes inputs at different row rates "
                f"{sorted(map(str, rs))}; no uniform band schedule exists")
        rates[name] = rs.pop() * st.upsample[0] / st.stride[0]
    return rates


def island_rates(lp: LoweredPipeline, compute: List[str],
                 ext_inputs: List[str],
                 shapes: Dict[str, Tuple[int, int]]
                 ) -> Tuple[str, Dict[str, Fraction]]:
    """Row rates for an island, anchored at its tallest external input.

    External inputs get the *definitional* rate `H_ext / H_base`; compute
    stages propagate through stride/upsample with the same conflict and
    rate-exactness checks `build_schedule` makes globally.  Returns
    `(base_name, rates)`.
    """
    if not ext_inputs:
        raise LoweringError("island has no external inputs")
    base = max(ext_inputs, key=lambda n: shapes[n][0])
    Hb = shapes[base][0]
    rates: Dict[str, Fraction] = {
        n: Fraction(shapes[n][0], Hb) for n in ext_inputs}
    for name in compute:
        st = lp.stages[name].stage
        rs = {rates[i] for i in st.inputs}
        if len(rs) != 1:
            raise LoweringError(
                f"stage {name!r} mixes inputs at different row rates "
                f"{sorted(map(str, rs))}; no uniform band schedule exists")
        r = rs.pop() * st.upsample[0] / st.stride[0]
        if r * Hb != shapes[name][0]:
            raise LoweringError(
                f"stage {name!r}: height {shapes[name][0]} is not "
                f"rate-exact ({r * Hb}); pad the image so every "
                f"stride divides its stage height")
        rates[name] = r
    return base, rates


def _schedule_core(lp: LoweredPipeline, shapes: Dict[str, Tuple[int, int]],
                   order: List[str], outputs: List[str],
                   H_base: int, rates: Dict[str, Fraction],
                   ext: Set[str],
                   tile_rows: Optional[int], min_tile: int) -> Schedule:
    """Shared tile search + backward span pass over `order` (topo).

    `ext` marks stages treated as materialized inputs (no tap recursion
    past them); `H_base` / `rates` anchor the step arithmetic.
    """
    base = 1
    for name in order:
        d = rates[name].denominator
        base = base * d // gcd(base, d)

    def try_tile(T: int) -> Optional[Schedule]:
        steps = {n: int(rates[n] * T) for n in order}
        lo: Dict[str, Optional[int]] = {
            n: 0 if n in outputs else None for n in order}
        hi: Dict[str, Optional[int]] = {
            n: steps[n] if n in outputs else None for n in order}
        for c in reversed(order):
            if lo[c] is None:        # dead stage w.r.t. outputs: skip
                continue
            if c in ext:
                continue
            st = lp.stages[c].stage
            if st.is_input:
                continue
            sy, uy = st.stride[0], st.upsample[0]
            for r in st.refs():
                a = (sy * lo[c] + r.dy) // uy
                b = (sy * (hi[c] - 1) + r.dy) // uy + 1
                p = r.stage
                lo[p] = a if lo[p] is None else min(lo[p], a)
                hi[p] = b if hi[p] is None else max(hi[p], b)
        stages = {}
        for n in order:
            if lo[n] is None:
                continue
            s = StageSched(step=steps[n], lo=lo[n], hi=hi[n],
                           H=shapes[n][0], W=shapes[n][1])
            if s.step < 1 or s.L > s.H:
                return None
            stages[n] = s
        return Schedule(grid=H_base // T, tile_rows=T, stages=stages,
                        order=[n for n in order if n in stages])

    if tile_rows is not None:
        if tile_rows % base or H_base % tile_rows:
            raise LoweringError(
                f"tile_rows={tile_rows} must be a multiple of {base} "
                f"and divide H={H_base}")
        sched = try_tile(tile_rows)
        if sched is None:
            raise LoweringError(
                f"tile_rows={tile_rows}: a stage's band would exceed its "
                f"full height; use a larger tile")
        return sched

    candidates = sorted(T for T in range(base, H_base + 1, base)
                        if H_base % T == 0)
    best = None
    for T in candidates:
        sched = try_tile(T)
        if sched is None:
            continue
        best = sched
        if T >= min(min_tile, H_base):
            break
    if best is None:
        raise LoweringError(
            f"no lattice-aligned tile height divides H={H_base} "
            f"(phase modulus {base}, halos too deep for every candidate)")
    return best


def build_schedule(lp: LoweredPipeline, in_shape: Tuple[int, int],
                   order: Optional[List[str]] = None,
                   outputs: Optional[List[str]] = None,
                   tile_rows: Optional[int] = None,
                   min_tile: int = 8) -> Schedule:
    """Static whole-DAG band schedule for `in_shape` images.

    `order` defaults to every stage (callers prune to output ancestors);
    `outputs` to the pipeline outputs.  Raises `LoweringError` when the
    DAG mixes rates, a height is rate-inexact, or no lattice-aligned tile
    height exists — callers that want totality partition into rate
    islands instead (`repro_torch.lowering.islands.partition_islands`).
    """
    order = list(order or lp.order)
    outputs = list(outputs or lp.pipeline.outputs)
    H0, _ = in_shape
    shapes = stage_shapes(lp, in_shape)
    rates = row_rates(lp)
    for name in order:
        st = lp.stages[name].stage
        if not st.is_input:
            exp = rates[name] * H0
            if exp != shapes[name][0]:
                raise LoweringError(
                    f"stage {name!r}: height {shapes[name][0]} is not "
                    f"rate-exact ({exp}); pad the image so every "
                    f"stride divides its stage height")
    ext = {n for n in order if lp.stages[n].stage.is_input}
    return _schedule_core(lp, shapes, order, outputs, H0, rates, ext,
                          tile_rows, min_tile)


def build_island_schedule(lp: LoweredPipeline,
                          shapes: Dict[str, Tuple[int, int]],
                          compute: List[str], ext_inputs: List[str],
                          outputs: List[str],
                          tile_rows: Optional[int] = None,
                          min_tile: int = 8) -> Schedule:
    """Band schedule for one rate island.

    `compute` is the island's stages in topo order; `ext_inputs` the
    materialized arrays it reads (pipeline inputs and/or upstream island
    outputs); `outputs` the island stages materialized back to memory.
    Raises `LoweringError` when the island cannot be banded (callers fall
    back to `single_tile_schedule`).
    """
    base, rates = island_rates(lp, compute, ext_inputs, shapes)
    order = list(ext_inputs) + list(compute)
    return _schedule_core(lp, shapes, order, outputs, shapes[base][0],
                          rates, set(ext_inputs), tile_rows, min_tile)


def single_tile_schedule(lp: LoweredPipeline,
                         shapes: Dict[str, Tuple[int, int]],
                         compute: List[str], ext_inputs: List[str],
                         outputs: List[str]) -> Schedule:
    """Degenerate one-tile schedule: every band is the full stage height.

    Always valid: with `grid=1`, `step=H`, `lo=0`, `hi=H` the fused
    kernel's clamped band copies and tap gathers read exactly the rows
    the oracle's padded geometry reads, for any stride/upsample/height
    combination — including rate-inexact (ceil-divided) heights.
    """
    order = list(ext_inputs) + list(compute)
    stages = {n: StageSched(step=shapes[n][0], lo=0, hi=shapes[n][0],
                            H=shapes[n][0], W=shapes[n][1])
              for n in order}
    tile = max(shapes[n][0] for n in ext_inputs) if ext_inputs else \
        max(shapes[n][0] for n in order)
    return Schedule(grid=1, tile_rows=tile, stages=stages, order=order)
