"""FPGA power/area cost model + GPU byte model.

The port's own copy of `repro.core.cost_model`: host arithmetic, the same
operations in the same order, so every number equals the reference's
(`tests/test_torch_dse.py` holds them equal).

Power/area cannot come from Vivado P&R here (the paper's Tables
III/VI/VII/X are post-P&R measurements on a Zynq XC7Z020), so they are
*modeled* from the same quantity the paper's analysis controls:
per-stage operator bit-widths.  The model is deliberately simple and is
used only for *relative* comparisons (fixed vs float), which is how the
paper reports its wins (3.8x power, 6.2x area on HCD).

Proxies (per output pixel):
  ripple add / sub / cmp / select of width w  ->  w     bit-ops,  w   LUT-bits
  multiplier  wa x wb                         ->  wa*wb/8 bit-ops, wa*wb/8 DSP-bits
  divider / sqrt of width w                   ->  w*w/4 bit-ops (iterative array)
  line buffer of a stage with halo h          ->  2h rows x W pixels x width bits (BRAM)

Float32 op costs use the classic FPGA soft-float factors: a float adder
(align + add + normalize) ~ 4x a 32-bit int adder; float multiply ~ a 24x24
mantissa multiplier (+ exponent adder).  These land the model's float/fixed
ratios in the same regime the paper measures; model numbers are reported
as modeled, never as measured watts.

Byte side: bytes/pixel/stage after container legalization (`core.policy`),
the quantity that drives device-memory traffic (`bytes_per_pixel_tpu`
keeps the reference's field name).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                              Pipeline, Pow, Ref, Select)
from repro_torch.core.policy import container_bytes

FLOAT_ADD_FACTOR = 4.0          # soft-float adder vs int adder of same width
FLOAT_MANTISSA = 24             # f32 mantissa incl. hidden bit
F64_MANTISSA = 53               # f64 mantissa incl. hidden bit
CARRIER_BITS = {"int32": 32, "int32pair": 32, "int64": 64}


@dataclasses.dataclass
class StageCost:
    bit_ops: float          # dynamic-power proxy (switched bits per output pixel)
    lut_bits: float         # area proxy: adder/logic bits
    dsp_bits: float         # area proxy: multiplier array bits
    bram_bits: float        # line-buffer storage bits
    storage_bits: int       # stage output element width


def _w(t: Optional[FixedPointType]) -> int:
    return 32 if t is None else t.width


def _expr_cost(e: Expr, w_in: Dict[str, int], w_out: int, is_float: bool,
               params_width: int = 32,
               mantissa: int = FLOAT_MANTISSA) -> Tuple[float, float, float]:
    """(bit_ops, lut_bits, dsp_bits) for one evaluation of `e`.

    Width discipline: each op computes at the max of its operand widths
    (the HLS datapath the paper's generated code produces); the final result
    is stored at `w_out`.  `mantissa` sets the float significand width when
    `is_float` (24 for f32, 53 for an f64 lowered-expr datapath).
    Returns cost and implicitly the width via closure recursion.
    """
    bit_ops = lut = dsp = 0.0
    FLOAT_MANTISSA = mantissa       # shadows the module default below

    def go(n: Expr) -> int:           # returns value width of subtree
        nonlocal bit_ops, lut, dsp
        if isinstance(n, Const):
            return FLOAT_MANTISSA if is_float else max(int(abs(n.value)).bit_length(), 8)
        if isinstance(n, Ref):
            return w_in[n.stage]
        if isinstance(n, ParamRef):
            return params_width if is_float else 16
        if isinstance(n, BinOp):
            wl, wr = go(n.left), go(n.right)
            if n.op in "+-":
                w = max(wl, wr) + 1
                c = w * (FLOAT_ADD_FACTOR if is_float else 1.0)
                bit_ops += c; lut += c
                return min(w, 64)
            if n.op == "*":
                # constant multiplies fold to shift-adds: charge an adder
                if isinstance(n.left, Const) and abs(n.left.value) in (0.0, 1.0):
                    return wr
                wa, wb = (FLOAT_MANTISSA, FLOAT_MANTISSA) if is_float else (wl, wr)
                c = wa * wb / 8.0
                bit_ops += c; dsp += c
                return min(wl + wr, 64) if not is_float else 32
            if n.op == "/":
                w = max(wl, wr) if not is_float else FLOAT_MANTISSA
                c = w * w / 4.0
                bit_ops += c; lut += c
                return w
        if isinstance(n, Pow):
            wb = go(n.base)
            wa = FLOAT_MANTISSA if is_float else wb
            c = wa * wa / 8.0 * max(n.n - 1, 1)
            bit_ops += c; dsp += c
            return min(wb * n.n, 64) if not is_float else 32
        if isinstance(n, Call):
            ws = [go(a) for a in n.args]
            w = max(ws)
            if n.fn == "sqrt":
                c = w * w / 4.0
            else:  # abs/min/max ~ one compare-select
                c = w * (FLOAT_ADD_FACTOR if is_float else 1.0)
            bit_ops += c; lut += c
            return w
        if isinstance(n, Cmp):
            wl, wr = go(n.left), go(n.right)
            w = max(wl, wr)
            c = w * (FLOAT_ADD_FACTOR if is_float else 1.0)
            bit_ops += c; lut += c
            return 1
        if isinstance(n, Select):
            go(n.cond)
            wt, wo = go(n.then), go(n.other)
            w = max(wt, wo)
            bit_ops += w; lut += w
            return w
        raise TypeError(type(n))

    go(e)
    return bit_ops, lut, dsp


def phase_mean_width(phase_entry, union_width: float) -> float:
    """Duty-cycle-weighted datapath width of a phase-split stage.

    `phase_entry` is one `BitwidthPlan.phase_types` value —
    ``((My, Mx), residue -> FixedPointType)``.  A phase-split streaming
    design synthesizes one datapath per sampling-lattice residue (the
    paper §IV homogeneity clusters in silicon); each handles exactly
    1/(My*Mx) of the pixels, so both the switched bits (power) and the
    polyphase-folded structure (area) track the residue *mean* width, with
    residues missing from the map falling back to the union width.
    """
    (my, mx), tmap = phase_entry
    n_res = max(my * mx, 1)
    total = sum(_w(t) for t in tmap.values())
    total += union_width * (n_res - len(tmap))
    return total / n_res


def _intlinear_cost(dp: Dict, w_in_max: float, w_out: int,
                    ) -> Tuple[float, float, float]:
    """(bit_ops, lut_bits, dsp_bits) of a lowered integer MAC datapath.

    Priced from the election's structure instead of the HLS max-width
    walk: constant-weight multiplies are shift-add arrays (weight bits x
    operand bits), the accumulate chain runs at the *carrier* register
    width — 32 for int32 and each half of an int32pair, 64 for int64 —
    and an int32pair pays one widening 64-bit combine adder.  The finish
    is a round+shift at carrier width when dyadic, else one f64 multiply.
    """
    A = CARRIER_BITS[dp["carrier"]]
    dsp = dp.get("wbits", 8 * dp["taps"]) * w_in_max / 8.0
    adders = dp["taps"] * A
    if dp["carrier"] == "int32pair":
        adders += 64                           # the widening combine
    if dp.get("dyadic", True):
        finish_ops, finish_dsp = float(A), 0.0  # round add + shift
    else:
        finish_ops, finish_dsp = 0.0, F64_MANTISSA * F64_MANTISSA / 8.0
    # (the output register + saturate clamp are charged by stage_cost's
    # common tail, like every other datapath)
    bit_ops = dsp + adders + finish_ops + finish_dsp
    return bit_ops, adders + finish_ops, dsp + finish_dsp


def stage_cost(pipeline: Pipeline, name: str,
               types: Dict[str, Optional[FixedPointType]],
               image_width: int = 1920,
               eff_widths: Optional[Dict[str, float]] = None,
               datapath: Optional[Dict] = None) -> StageCost:
    """Cost of one stage's datapath.

    `eff_widths` (optional) overrides the *operand* width of named
    producer stages — the hook `design_cost` uses to price per-phase
    datapaths: a phase-split producer feeds this stage's operators (and
    its line buffers) at the residue-mean width instead of the union
    width (`phase_mean_width`).

    `datapath` (optional) is one `lowered_datapaths` entry: the stage's
    operators are then priced from the lowering's actual election — the
    integer MAC at its carrier width (`_intlinear_cost`), or the expr
    tree as float at the elected mantissa (24 for f32, 53 for f64) —
    instead of the HLS max-width model.  Storage and line buffers still
    follow `types` (the stored representation is unchanged by election).
    """
    st = pipeline.stages[name]
    w_out = _w(types.get(name))
    if st.is_input or st.expr is None:
        return StageCost(0.0, 0.0, 0.0, 0.0, w_out)
    is_float = types.get(name) is None
    eff = eff_widths or {}
    w_in = {i: eff.get(i, _w(types.get(i))) for i in st.inputs}
    if datapath is not None and datapath.get("kind") == "intlinear":
        bit_ops, lut, dsp = _intlinear_cost(
            datapath, max(w_in.values(), default=8.0), w_out)
    elif datapath is not None and datapath.get("kind") == "expr":
        mant = FLOAT_MANTISSA if datapath.get("dtype") == "f32" \
            else F64_MANTISSA
        bit_ops, lut, dsp = _expr_cost(st.expr, w_in, w_out, True,
                                       mantissa=mant)
    else:
        bit_ops, lut, dsp = _expr_cost(st.expr, w_in, w_out, is_float)
    # output stage: every stream stage ends in a register (switches w_out
    # bits per pixel) and, in fixed point, a quantize/saturate clamp
    # (compare-select of width w_out).  Priced at the residue-mean width
    # for phase-split stages — this is where one-datapath-per-residue
    # narrows the silicon even on pipeline outputs.
    w_store = eff.get(name, w_out)
    bit_ops += w_store
    if not is_float:
        lut += w_store
    hy, _hx = st.halo_yx()
    # line buffers: 2*hy full image rows per input, at the input's width —
    # per-axis: a horizontal-only stencil (hy = 0) streams with no BRAM
    bram = sum(2 * hy * image_width * w_in[i] for i in st.inputs) if hy else 0.0
    return StageCost(bit_ops=bit_ops, lut_bits=lut, dsp_bits=dsp,
                     bram_bits=float(bram), storage_bits=w_out)


@dataclasses.dataclass
class DesignCost:
    power_proxy: float       # sum of per-pixel switched bit-ops (dynamic power ~)
    lut_bits: float
    dsp_bits: float
    bram_bits: float
    bytes_per_pixel_tpu: float   # after container legalization

    def ratios_vs(self, other: "DesignCost") -> Dict[str, float]:
        def r(a, b):
            return b / a if a > 0 else float("inf")
        return {
            "power": r(self.power_proxy, other.power_proxy),
            "area_lut": r(self.lut_bits, other.lut_bits),
            "area_dsp": r(self.dsp_bits, other.dsp_bits),
            "bram": r(self.bram_bits, other.bram_bits),
            "tpu_bytes": r(self.bytes_per_pixel_tpu, other.bytes_per_pixel_tpu),
        }


def lowered_datapaths(lp) -> Dict[str, Dict]:
    """Datapath descriptors for `design_cost(..., datapaths=...)`.

    `lp` is a `repro_torch.lowering.LoweredPipeline`; each non-input
    stage maps to the structure its election actually synthesizes — the
    quantity the narrow re-election (`lower(..., datapath="narrow")`) changes and the
    type-map-only model cannot see:

      intlinear: {"kind", "carrier", "taps", "wbits", "dyadic"}
      expr:      {"kind", "dtype"}           # "f64" | "f32"
    """
    out: Dict[str, Dict] = {}
    for n, ls in lp.stages.items():
        if ls.stage.is_input:
            continue
        if ls.kind == "intlinear":
            out[n] = {"kind": "intlinear", "carrier": ls.carrier,
                      "taps": len(ls.int_taps),
                      "wbits": sum(max(abs(tp.W).bit_length(), 1)
                                   for tp in ls.int_taps),
                      "dyadic": ls.dyadic}
        elif ls.kind == "expr":
            out[n] = {"kind": "expr", "dtype": ls.expr_dtype}
    return out


def design_cost(pipeline: Pipeline,
                types: Dict[str, Optional[FixedPointType]],
                image_width: int = 1920,
                phase_types: Optional[Dict] = None,
                datapaths: Optional[Dict[str, Dict]] = None) -> DesignCost:
    """Whole-design cost.  `phase_types` (the `BitwidthPlan.phase_types`
    shape, ``stage -> ((My, Mx), residue -> type)``) prices per-phase
    datapaths: a phase-split stage feeds its consumers (operators and line
    buffers) at the residue-mean width, and its storage traffic is the
    residue mean of the per-residue container bytes — the quantity the
    union-width model erases (closing the ROADMAP per-phase cost item).

    `datapaths` (a `lowered_datapaths` map) prices each stage's operators
    from the lowering's carrier/dtype election instead of the HLS
    max-width walk, so exact vs narrow lowerings of the same type map get
    different costs.  Omitted -> byte-identical to the historical model.
    """
    phase_types = phase_types or {}
    datapaths = datapaths or {}
    eff: Dict[str, float] = {
        n: phase_mean_width(entry, _w(types.get(n)))
        for n, entry in phase_types.items() if types.get(n) is not None}
    power = lut = dsp = bram = tbytes = 0.0
    for name in pipeline.topo_order():
        c = stage_cost(pipeline, name, types, image_width, eff_widths=eff,
                       datapath=datapaths.get(name))
        power += c.bit_ops
        lut += c.lut_bits
        dsp += c.dsp_bits
        bram += c.bram_bits
        entry = phase_types.get(name)
        if entry is not None and types.get(name) is not None:
            (my, mx), tmap = entry
            n_res = max(my * mx, 1)
            b = sum(container_bytes(t) for t in tmap.values())
            b += container_bytes(types.get(name)) * (n_res - len(tmap))
            tbytes += b / n_res
        else:
            tbytes += container_bytes(types.get(name))
    return DesignCost(power_proxy=power, lut_bits=lut, dsp_bits=dsp,
                      bram_bits=bram, bytes_per_pixel_tpu=tbytes)


def float_design(pipeline: Pipeline) -> Dict[str, Optional[FixedPointType]]:
    """The float32 reference design: every stage typed None."""
    return {n: None for n in pipeline.stages}
