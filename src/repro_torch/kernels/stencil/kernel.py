"""The stencil kernels: the fused rate-island band kernel (encoder,
plain version, wrapper) and the single-stage fixed-point stencil.

The band kernel replaces the TPU kernel
`repro/kernels/stencil/kernel.py:fused_pipeline` (`_fused_kernel`,
`_fused_kernel_prefetch`, `eval_band`, `band_output`; `pallas_call` at
line 321).  One call runs one rate island over every (image, band) of
its schedule: it loads each input's rows of the band with edge-replicate
clamps, evaluates every compute stage of the island on the band through
clamped tap gathers, and writes rows ``[-lo, -lo + step)`` of the
island's output stages in their legalized containers.

The island is not compiled into code.  `encode_program` flattens the
island's stage descriptors (`lowering.cuda_backend.island_program`) into
int64 / f64 tables, and one CUDA source, `csrc/fused_band.cu`,
interprets them.  The encoder also cuts each band into column tiles (a
backward column-span pass, the counterpart of the row pass of
`lowering.schedule`) and lays out one block's shared memory: the tables,
per-item index maps, every stage tile in its container, and two slots
for the input bands.  The same tables drive `fused_pipeline_reference`,
the plain PyTorch version, whole-width or tile by tile, so the CPU tests
check the encoder, the column geometry and every datapath rule, and only
the CUDA transcription is left for the card.

`fused_pipeline` is the wrapper: on CPU tensors it runs the plain
version, on CUDA tensors it launches the kernel or raises, and it counts
its launches in `LAUNCHES`.

`fixedpoint_stencil` (end of the file) replaces the TPU kernel
`repro/kernels/stencil/kernel.py:fixedpoint_stencil` with
`csrc/stencil.cu`, beside its plain version
`fixedpoint_stencil_reference`, under the same wrapper rule.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from fractions import Fraction
from math import lcm
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import npops
from repro_torch.lowering import backends as B
from repro_torch.lowering.ir import LoweringError

# Columns of the per-stage table; `csrc/fused_band.cu` declares the same
# names in the same order (tests/test_torch_kernels.py checks it).
FIELDS = ("kind", "step", "lo", "L", "H", "W", "sy", "sx", "uy", "ux",
          "code", "in_slot", "out_slot", "is_float",
          "tap_begin", "tap_count", "dyadic", "sm", "t_shift",
          "int_min", "int_max", "ph_begin", "ph_count", "my", "mx",
          "prog_begin", "prog_len", "snap", "fbase",
          "cstep", "clo", "CW", "place", "tile_off", "pitch", "esize",
          "res_begin", "rres", "cres", "acc32", "f32")
NF = len(FIELDS)
# the launch's scalars, in the order of the kernel's `Layout` enum
LAYOUT = ("n_meta", "o_stages", "o_taps", "o_phases", "o_prog", "o_rmaps",
          "o_cmaps", "o_resmap", "o_fconst", "n_stages", "n_rmaps",
          "n_cmaps", "s_sbase", "s_rowmaps", "s_colmaps", "in_stride",
          "smem_bytes", "ntiles", "f32")

KIND_INPUT, KIND_INTLINEAR, KIND_EXPR = 0, 1, 2
# where a stage's tile lives: shared memory; a per-block global slot (a
# compute stage) or the input tensor itself (an input); nowhere (an
# output that no stage of the island reads)
PLACE_SHARED, PLACE_GLOBAL, PLACE_NONE = 0, 1, 2

# container codes, in the order of the kernel's load/store switch
CONTAINERS = (torch.uint8, torch.int8, torch.uint16, torch.int16,
              torch.uint32, torch.int32, torch.int64, torch.float64)
CODE = {dt: k for k, dt in enumerate(CONTAINERS)}

# postfix opcodes of an expression stage's program
(OP_REF, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SQR, OP_ABS, OP_SQRT,
 OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE, OP_SELECT) = range(16)
MAX_STACK = 4       # the kernel's operand stack, in registers
MAX_IO = 32         # input and output tensors per launch, each
THREADS = 256
# taps rows: parent, dy, dx, weight, row-map offset, column-map offset,
# the parent's container code, 0; program rows: opcode, a, b, c, 0 and,
# for OP_REF, the two map offsets and the code — so an OP_REF row from
# its second column reads as a taps row
TAPW = 8
# the widest column tile the encoder considers, and what one work item
# costs beyond its stages, in block-wide passes (see `_item_passes`)
MAX_COL_TILE = 256
ITEM_PASSES = 4
# dynamic shared memory of one block such that three blocks fit on an SM
# (232,448 bytes a block at most, 233,472 an SM, 1 KB reserved a block),
# as many as the kernel's registers allow (`__launch_bounds__`)
SMEM_LIMIT = 233472 // 3 - 1024
SMEM_MAX = 232448
_I32_MAX = (1 << 31) - 1

# Per-stage block of `fconst`: 2^beta, 2^-beta, int_min and int_max as
# doubles, the non-dyadic finishing multiplier.  Per-residue blocks hold
# the first four.
FC_STEP, FC_INV_STEP, FC_MIN, FC_MAX, FC_CSCALE = range(5)

LAUNCHES: Dict[str, int] = {"fused_band": 0, "stencil": 0}
_LAUNCH_LOCK = threading.Lock()


@dataclasses.dataclass
class EncodedProgram:
    """One island's band program as flat tables (see `encode_program`)."""
    stages: np.ndarray          # int64 (n_stages, NF)
    taps: np.ndarray            # int64 (n_taps, TAPW)
    phases: np.ndarray          # int64 (n_res, 5): ry, rx, qmin, qmax, fbase
    prog: np.ndarray            # int64 (n_ops, TAPW)
    fconst: np.ndarray          # f64 constants
    rmaps: np.ndarray           # int64 (n, 4): consumer, parent, dy, offset
    cmaps: np.ndarray           # int64 (n, 4): consumer, parent, dx, offset
    resmap: np.ndarray          # int64: phase row per lattice residue, or -1
    names: List[str]            # stage name per table row
    col_tile: int               # base columns per tile; 0: one whole tile
    ntiles: int                 # column tiles per band
    layout: Dict[str, int]      # the launch's scalars (LAYOUT)
    ws_per_block: int           # bytes of global tiles one block needs
    _dev: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def smem_bytes(self) -> int:
        return self.layout["smem_bytes"]

    def rows(self) -> List[Dict[str, int]]:
        return [dict(zip(FIELDS, r)) for r in self.stages.tolist()]

    def slots(self, key: str) -> List[Tuple[int, Dict[str, int]]]:
        """(table row, stage fields) of the inputs (``key="in_slot"``) or
        outputs (``key="out_slot"``), in slot order."""
        return sorted(((s, r) for s, r in enumerate(self.rows())
                       if r[key] >= 0), key=lambda sr: sr[1][key])

    def meta(self) -> np.ndarray:
        """Every table in one int64 array (f64 constants as their bits),
        at the `LAYOUT` offsets: what a block copies to shared memory."""
        return np.concatenate([
            a.reshape(-1) for a in (self.stages, self.taps, self.phases,
                                    self.prog, self.rmaps, self.cmaps,
                                    self.resmap,
                                    self.fconst.view(np.int64))])

    def device_meta(self, device: torch.device) -> torch.Tensor:
        """`meta()` on `device`, copied once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.meta()).to(device)
        return self._dev[key]




# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class _Sym:
    """A symbolic f64 value: the postfix code that computes it.  A tap of
    an integer-stored stage also carries its grid ``(qabs, beta)``: the
    value is ``q * 2^-beta`` with ``|q| <= qabs``."""
    __slots__ = ("code", "pool", "grid")

    def __init__(self, code, pool, grid=None):
        self.code = code
        self.pool = pool
        self.grid = grid

    def __add__(self, o): return _emit(self.pool, OP_ADD, self, o)
    def __radd__(self, o): return _emit(self.pool, OP_ADD, o, self)
    def __sub__(self, o): return _emit(self.pool, OP_SUB, self, o)
    def __rsub__(self, o): return _emit(self.pool, OP_SUB, o, self)
    def __mul__(self, o): return _emit(self.pool, OP_MUL, self, o)
    def __rmul__(self, o): return _emit(self.pool, OP_MUL, o, self)
    def __truediv__(self, o): return _emit(self.pool, OP_DIV, self, o)
    def __rtruediv__(self, o): return _emit(self.pool, OP_DIV, o, self)
    # a reflected comparison (``2.0 < s``) arrives as ``s > 2.0``: the
    # same truth value, NaN included
    def __lt__(self, o): return _emit(self.pool, OP_LT, self, o)
    def __le__(self, o): return _emit(self.pool, OP_LE, self, o)
    def __gt__(self, o): return _emit(self.pool, OP_GT, self, o)
    def __ge__(self, o): return _emit(self.pool, OP_GE, self, o)

    def __pow__(self, n):
        # numpy's ``x ** n``: 1 for n = 0, x for n = 1, ``x * x`` for 2;
        # other powers are the C library's `pow`, which the kernel matches
        # only where the product is exact (`_exact_power`)
        if n == 0:
            return _lift(1.0, self.pool)
        if n == 1:
            return self
        if n == 2:
            return _emit(self.pool, OP_SQR, self)
        reason = _exact_power(self, n)
        if reason is not None:
            raise LoweringError(f"the band kernel cannot encode x ** {n} "
                                f"bit-equal to numpy's pow: {reason}")
        out = self
        for _ in range(n - 1):
            out = _emit(self.pool, OP_MUL, out, self)
        return out


def _exact_power(x: _Sym, n: int) -> Optional[str]:
    """Why ``x ** n`` (n >= 3 or n < 0) has no exact product form, or
    None where it has one.

    numpy's power of a float array is the C library's `pow`, accurate to
    about half an ulp but not correctly rounded in general.  Where the
    exact power is a double, though, `pow` returns it, and so does every
    order of products: x is a tap of an integer-stored stage, ``q *
    2^-beta`` with ``|q| <= qabs``, and ``qabs^n <= 2^53`` bounds every
    partial product's significand, with the exponent kept inside the
    double's range.  A negative power is a quotient that `pow` need not
    round as a division does."""
    if n < 0:
        return "a negative power is a rounded quotient"
    if x.grid is None:
        return ("the base is not a tap of an integer-stored stage, so its "
                "value has no proven grid")
    qabs, beta = x.grid
    if qabs ** n > 1 << 53:
        return (f"the base's grid needs {qabs.bit_length()} bits, and "
                f"{qabs.bit_length()} x {n} exceeds the double's 53")
    if not -971 <= beta * n <= 1074:
        return f"2^-{beta} to the power {n} leaves the double's range"
    return None


def _lift(v, pool) -> _Sym:
    if isinstance(v, _Sym):
        return v
    # a Python number: eval_expr already folded constant subtrees with
    # Python's own double arithmetic, exactly as the oracle does
    pool.append(float(v))
    return _Sym([(OP_CONST, len(pool) - 1, 0, 0)], pool)


def _emit(pool, op, *args) -> _Sym:
    """Postfix code of `op` applied to `args` (symbols or numbers)."""
    code = [c for a in args for c in _lift(a, pool).code]
    return _Sym(code + [(op, 0, 0, 0)], pool)


class _EmitXP:
    """The `xp` namespace (and `where`) `eval_expr` calls, emitting ops."""

    def __init__(self, pool):
        self.pool = pool

    def abs(self, x): return _emit(self.pool, OP_ABS, x)
    def sqrt(self, x): return _emit(self.pool, OP_SQRT, x)
    def minimum(self, a, b): return _emit(self.pool, OP_MIN, a, b)
    def maximum(self, a, b): return _emit(self.pool, OP_MAX, a, b)
    def where(self, c, a, b): return _emit(self.pool, OP_SELECT, c, a, b)


def _stack_depth(code) -> int:
    depth = peak = 0
    for op, *_ in code:
        if op in (OP_REF, OP_CONST):
            depth += 1
        elif op == OP_SELECT:
            depth -= 2
        elif op not in (OP_SQR, OP_ABS, OP_SQRT):
            depth -= 1
        peak = max(peak, depth)
    return peak


def _type_block(t) -> List[float]:
    if t is None:
        return [1.0, 1.0, 0.0, 0.0]
    return [2.0 ** t.beta, 2.0 ** -t.beta, float(t.int_min),
            float(t.int_max)]


def _int64(v: int, what: str) -> int:
    if not -(1 << 63) <= v < (1 << 63):
        raise LoweringError(f"{what} {v} does not fit the kernel's int64 "
                            f"tables")
    return v


def _refs(d: Dict[str, int], taps: List[List[int]], prog: List[List[int]]
          ) -> List[Tuple[int, int, int]]:
    """(parent, dy, dx) of every integer tap and every OP_REF of a stage."""
    if d["kind"] == KIND_INTLINEAR:
        return [tuple(t[:3]) for t in
                taps[d["tap_begin"]:d["tap_begin"] + d["tap_count"]]]
    if d["kind"] == KIND_EXPR:
        return [tuple(c[1:4]) for c in
                prog[d["prog_begin"]:d["prog_begin"] + d["prog_len"]]
                if c[0] == OP_REF]
    return []


def _column_lattice(rows: List[Dict[str, int]],
                    refs: List[List[Tuple[int, int, int]]]
                    ) -> Tuple[int, Optional[int]]:
    """(W_base, lattice): the widest input's width and the lcm of the
    stages' column-rate denominators, or None where some width is not
    rate-exact (then only one whole-width tile is exact)."""
    wb = max(d["W"] for d in rows if d["kind"] == KIND_INPUT)
    for c, d in enumerate(rows):
        for p, _, _ in refs[c]:
            if d["W"] * d["sx"] != rows[p]["W"] * d["ux"]:
                return wb, None
    return wb, lcm(*(Fraction(d["W"], wb).denominator for d in rows))


def _column_spans(rows: List[Dict[str, int]],
                  refs: List[List[Tuple[int, int, int]]], wb: int,
                  tw: int) -> Tuple[int, List[Tuple[int, int, int]]]:
    """Column tiles of `tw` base columns: (ntiles, [(cstep, clo, CW)]).

    The backward span pass of `lowering.schedule._schedule_core`, on
    columns: tile j of stage s covers columns
    ``[j * cstep + clo, j * cstep + clo + CW)``, clamped at the edges,
    where cstep = tw * W_s / W_base is exact on the column lattice.
    Each span is widened, where needed, so that every tile's span meets
    the stage's columns: a tap at a clamped edge column then lands
    inside its parent's tile, and the tile holds exactly the values of
    the whole-width band."""
    nt = -(-wb // tw)
    cs = [d["W"] * tw // wb for d in rows]
    lo: List[Optional[int]] = [0 if d["out_slot"] >= 0 else None
                               for d in rows]
    hi: List[Optional[int]] = [cs[s] if d["out_slot"] >= 0 else None
                               for s, d in enumerate(rows)]
    for c in reversed(range(len(rows))):
        d = rows[c]
        if lo[c] is None:
            lo[c], hi[c] = 0, cs[c]
        hi[c] = max(hi[c], 1)
        lo[c] = min(lo[c], d["W"] - 1 - (nt - 1) * cs[c])
        for p, _, dx in refs[c]:
            a = (d["sx"] * lo[c] + dx) // d["ux"]
            b = (d["sx"] * (hi[c] - 1) + dx) // d["ux"] + 1
            lo[p] = a if lo[p] is None else min(lo[p], a)
            hi[p] = b if hi[p] is None else max(hi[p], b)
    return nt, [(cs[s], lo[s], hi[s] - lo[s]) for s in range(len(rows))]


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def _item_passes(rows: List[Dict[str, int]],
                 refs: List[List[Tuple[int, int, int]]], wb: int,
                 tw: Optional[int]) -> int:
    """Block-wide passes the kernel takes for one band at column tiles
    of `tw` (None: one whole-width tile): per tile, each compute stage's
    quads of 4 columns over THREADS threads, plus ITEM_PASSES for the
    item's maps, copies and barriers.  The kernel's time goes as this
    count: a pass is one walk of the stage's program."""
    if tw is None:
        nt, spans = 1, [(d["W"], 0, d["W"]) for d in rows]
    else:
        nt, spans = _column_spans(rows, refs, wb, tw)
    per = sum(-(-d["L"] * (_align4(cw) // 4) // THREADS)
              for d, (_, _, cw) in zip(rows, spans)
              if d["kind"] != KIND_INPUT)
    return nt * (per + ITEM_PASSES)


def _box_pitch(cw: int, w: int, esize: int) -> int:
    """Bytes of one input-band row in shared memory: the box of
    ``min(CW, W)`` columns, copied as the 16-byte chunks that cover it
    at any alignment."""
    return _align16(min(cw, w) * esize + 15)


def _layout(rows: List[Dict[str, int]], n_meta: int, n_rows: int,
            n_cols: int, smem_limit: int) -> Tuple[Dict[str, int], int]:
    """Place every stage tile and lay out one block's shared memory.

    Fills each row's place, tile_off and pitch.  Shared memory holds the
    tables, a base pointer per stage, the index maps, every read compute
    tile in its container, and the input bands twice (the slot being
    read and the slot being filled).  While that exceeds `smem_limit`,
    the largest shared tile moves out: a compute tile to a per-block
    global slot, an input to reads in place (``smem_limit=0`` moves
    every tile out).  Returns the shared-memory
    offsets and the bytes of global slots one block needs."""
    consumed = {p for d in rows for p in d["_parents"]}
    for s, d in enumerate(rows):
        if d["kind"] == KIND_INPUT:
            d["place"] = PLACE_SHARED
            d["pitch"] = _box_pitch(d["CW"], d["W"], d["esize"])
        else:
            d["place"] = PLACE_SHARED if s in consumed else PLACE_NONE
            d["pitch"] = d["CW"] * d["esize"]
    head = {"s_sbase": _align16(8 * n_meta)}
    head["s_rowmaps"] = head["s_sbase"] + _align16(8 * len(rows))
    head["s_colmaps"] = head["s_rowmaps"] + _align16(4 * n_rows)
    tiles_at = head["s_colmaps"] + _align16(4 * n_cols)

    def cost(d):        # shared bytes a tile takes (inputs twice)
        return _align16(d["L"] * d["pitch"]) * (
            2 if d["kind"] == KIND_INPUT else 1)

    while True:
        shared = [d for d in rows if d["place"] == PLACE_SHARED]
        total = tiles_at + sum(cost(d) for d in shared)
        if total <= smem_limit or not shared:
            break
        max(shared, key=cost)["place"] = PLACE_GLOBAL
    if tiles_at > SMEM_MAX:
        raise LoweringError(f"the island's tables and index maps take "
                            f"{tiles_at} bytes of shared memory, more "
                            f"than a block has ({SMEM_MAX})")
    at, ws = tiles_at, 0
    for d in rows:
        d["tile_off"] = -1
        if d["kind"] == KIND_INPUT:
            if d["place"] == PLACE_GLOBAL:
                d["pitch"] = d["W"] * d["esize"]
        elif d["place"] == PLACE_SHARED:
            d["tile_off"], at = at, at + cost(d)
        elif d["place"] == PLACE_GLOBAL:
            d["tile_off"], ws = ws, ws + _align16(d["L"] * d["pitch"])
    in_stride = 0
    for d in rows:
        if d["kind"] == KIND_INPUT and d["place"] == PLACE_SHARED:
            d["tile_off"] = at + in_stride
            in_stride += _align16(d["L"] * d["pitch"])
    head.update(in_stride=in_stride, smem_bytes=at + 2 * in_stride)
    return head, ws


def encode_program(program: Sequence[Dict], col_tile: Optional[int] = None,
                   smem_limit: int = SMEM_LIMIT) -> EncodedProgram:
    """Flatten one island's stage descriptors into the kernel's tables.

    `program` is `lowering.cuda_backend.island_program`'s list: inputs
    first, then compute stages in topological order.  Per stage it
    records the band geometry (step, lo, L, H, W), the sampling rates,
    the container code and the input/output slots; for an ``intlinear``
    stage its integer taps, finishing rule and saturation bounds (per
    residue where the plan has phases); for an ``expr`` stage a postfix
    program emitted by running `eval_expr` on symbolic values — so the
    kernel issues the oracle's floating ops in the oracle's order, with
    constants and parameters baked in — plus its snap rule.

    It then cuts the band into column tiles of `col_tile` base columns
    — by default the width on the column lattice, up to MAX_COL_TILE,
    with the fewest block-wide passes (`_item_passes`) whose block fits
    `smem_limit` bytes of shared memory; one whole-width tile where no
    width is rate-exact — builds the index maps a block fills per work
    item, and places each tile (`_layout`).
    """
    index = {d["name"]: k for k, d in enumerate(program)}
    rows, taps, phases, prog, fconst = [], [], [], [], []
    for d in program:
        ls = d["ls"]
        row = dict.fromkeys(FIELDS, 0)
        row.update(step=d["step"], lo=d["lo"], L=d["L"], H=d["H"],
                   W=d["W"], code=CODE[d["dtype"]], in_slot=-1,
                   out_slot=d.get("out_slot", -1),
                   is_float=int(d["dtype"] == torch.float64),
                   esize=d["dtype"].itemsize, rres=-1, cres=-1,
                   sy=1, sx=1, uy=1, ux=1, my=1, mx=1, dyadic=1, sm=1)
        row["fbase"] = len(fconst)
        fconst += _type_block(ls.t) + [float(ls.cscale)]
        if ls.t is not None and not ls.store_float:
            row["int_min"] = _int64(ls.t.int_min, "int_min")
            row["int_max"] = _int64(ls.t.int_max, "int_max")
        if _I32_MAX < d["H"] * d["W"] * row["esize"]:
            raise LoweringError(
                f"stage {d['name']!r}: a {d['H']}x{d['W']} image "
                f"overflows the kernel's int32 coordinates")
        rows.append(row)
        if d["kind"] == "input":
            row.update(kind=KIND_INPUT, in_slot=d["in_slot"])
            continue
        st = ls.stage
        (row["sy"], row["sx"]), (row["uy"], row["ux"]) = st.stride, st.upsample
        if ls.phase is not None:
            my, mx = ls.phase.lattice
            row.update(my=my, mx=mx, ph_begin=len(phases),
                       ph_count=len(ls.phase.types))
            for (ry, rx), t_ph in sorted(ls.phase.types.items()):
                fb = len(fconst)
                fconst += _type_block(t_ph)
                qmin = qmax = 0
                if ls.phase.int_ok:
                    qmin = _int64(t_ph.int_min, "phase int_min")
                    qmax = _int64(t_ph.int_max, "phase int_max")
                phases.append([ry, rx, qmin, qmax, fb])
        if ls.kind == "intlinear":
            # acc32: the lowering proved every partial sum (and a dyadic
            # finish) fits int32 (`lowering.ir._plan_intlinear`), so the
            # kernel may accumulate in int32, bit-equal to int64.  An
            # "int32pair" carrier (two int32 partial sums, narrow mode)
            # accumulates in int64 here: its combined sum was proved
            # below 2^53, so one int64 sum holds the same integer
            row.update(kind=KIND_INTLINEAR, tap_begin=len(taps),
                       tap_count=len(ls.int_taps), dyadic=int(ls.dyadic),
                       sm=ls.sm, t_shift=ls.t_shift,
                       acc32=int(ls.carrier == "int32"))
            taps += [[index[tp.stage], tp.dy, tp.dx, tp.W, 0, 0, 0, 0]
                     for tp in ls.int_taps]
            continue
        if ls.expr_dtype not in ("f64", "f32"):
            raise LoweringError(
                f"stage {d['name']!r}: the band kernel encodes f64 and f32 "
                f"expression stages, not {ls.expr_dtype!r}")
        xp = _EmitXP(fconst)

        def ref(stage, dy, dx):
            src = program[index[stage]]
            t = src["ls"].t
            grid = None
            if t is not None and src["dtype"] != torch.float64:
                grid = (max(abs(t.int_min), t.int_max), t.beta)
            return _Sym([(OP_REF, index[stage], dy, dx)], fconst, grid)

        first_const = len(fconst)
        code = _lift(B.eval_expr(st.expr, ref, d["params"], xp, xp.where),
                     fconst).code
        if _stack_depth(code) > MAX_STACK:
            raise LoweringError(
                f"stage {d['name']!r}: expression needs a stack deeper "
                f"than {MAX_STACK}")
        if ls.expr_dtype == "f32":
            # narrow mode proved f32 evaluation exact
            # (`lowering.ir._expr_fits_f32`): the reference's Pallas
            # kernel reads each tap as `dequant_f32` (f32(q) * f32(2^-b))
            # and meets each Python constant of `eval_expr` as a weak
            # scalar, i.e. rounded to f32.  The constants this stage
            # emitted are baked rounded so (still f64 words in `fconst`,
            # which the kernel converts exactly).
            for k in range(first_const, len(fconst)):
                fconst[k] = float(np.float32(fconst[k]))
            if any(c[0] == OP_REF and program[c[1]]["dtype"] ==
                   torch.float64 for c in code) or ls.t is None \
                    or ls.store_float or ls.phase is not None:
                raise LoweringError(
                    f"stage {d['name']!r}: an f32 stage reads only "
                    f"integer-stored taps and snaps onto one integer grid")
            row["f32"] = 1
        if ls.t is None:
            snap = B.SNAP_RAW
        elif ls.phase is not None and not ls.phase.int_ok:
            snap = B.SNAP_MIXED
        elif ls.store_float:
            snap = B.SNAP_FLOAT
        else:
            snap = B.SNAP_INT
        row.update(kind=KIND_EXPR, prog_begin=len(prog),
                   prog_len=len(code), snap=snap)
        prog += [list(c) + [0, 0, 0, 0] for c in code]

    refs = [_refs(d, taps, prog) for d in rows]
    for d, r in zip(rows, refs):
        d["_parents"] = {p for p, _, _ in r}

    # per-residue phase rows: the last entry naming a residue wins
    resmap: List[int] = []
    for d in rows:
        if d["ph_count"]:
            d["res_begin"] = len(resmap)
            look = [-1] * (d["my"] * d["mx"])
            for e in range(d["ph_begin"], d["ph_begin"] + d["ph_count"]):
                ry, rx = phases[e][:2]
                look[(ry % d["my"]) * d["mx"] + rx % d["mx"]] = e
            resmap += look

    def build(tw: Optional[int], limit: int):
        """Column spans, index maps and layout for tiles of `tw` base
        columns (None: one whole-width tile)."""
        if tw is None:
            nt, spans = 1, [(d["W"], 0, d["W"]) for d in rows]
        else:
            nt, spans = _column_spans(rows, refs, wb, tw)
        for d, (cs, clo, cw) in zip(rows, spans):
            d.update(cstep=cs, clo=clo, CW=cw)
        rkeys: Dict[Tuple[int, int, int], int] = {}
        ckeys: Dict[Tuple[int, int, int], int] = {}
        rlen, clen = [0], [0]

        def rmap(c, p, dy):
            if (c, p, dy) not in rkeys:
                rkeys[(c, p, dy)] = rlen[0]
                rlen[0] += rows[c]["L"]
            return rkeys[(c, p, dy)]

        def cmap(c, p, dx):
            if (c, p, dx) not in ckeys:
                ckeys[(c, p, dx)] = clen[0]
                clen[0] += _align4(rows[c]["CW"])
            return ckeys[(c, p, dx)]

        for c, d in enumerate(rows):
            table, first = ((taps, d["tap_begin"]) if d["kind"] ==
                            KIND_INTLINEAR else (prog, d["prog_begin"]))
            n = d["tap_count"] if d["kind"] == KIND_INTLINEAR else \
                d["prog_len"]
            for t in table[first:first + n]:
                if d["kind"] == KIND_INTLINEAR:
                    p, dy, dx = t[:3]
                    t[4:7] = rmap(c, p, dy), cmap(c, p, dx), rows[p]["code"]
                elif t[0] == OP_REF:
                    p, dy, dx = t[1:4]
                    t[5:8] = rmap(c, p, dy), cmap(c, p, dx), rows[p]["code"]
            if d["ph_count"]:
                d["rres"], d["cres"] = rmap(c, -1, 0), cmap(c, -1, 0)
        n_meta = (NF * len(rows) + TAPW * (len(taps) + len(prog))
                  + 5 * len(phases) + 4 * (len(rkeys) + len(ckeys))
                  + len(resmap) + len(fconst))
        head, ws = _layout(rows, n_meta, rlen[0], clen[0], limit)
        for d in rows:
            if _I32_MAX < d["L"] * max(d["pitch"], d["CW"] * d["esize"]):
                raise LoweringError("a tile overflows the kernel's int32 "
                                    "coordinates")
        return (tw or 0, nt, rkeys, ckeys, n_meta, head, ws)

    wb, lattice = _column_lattice(rows, refs)
    if col_tile is not None:
        if lattice is None or col_tile % lattice:
            raise LoweringError(
                f"col_tile={col_tile} is not a multiple of the island's "
                f"column lattice {lattice}")
        built = build(col_tile if col_tile < wb else None, smem_limit)
    else:
        # every width on the lattice (and one whole-width tile), cheapest
        # first, wider on ties, until one keeps every tile on chip; else
        # the cheapest whose tables fit, with some tiles in global memory
        tws: List[Optional[int]] = [None] + (
            [] if lattice is None else
            list(range(lattice, min(MAX_COL_TILE, wb - 1) + 1, lattice)))
        cost = {tw: _item_passes(rows, refs, wb, tw) for tw in tws}
        tws.sort(key=lambda t: (cost[t], -(t or wb)))
        built, fits, error = None, [], None
        for tw in tws:
            try:
                built = build(tw, smem_limit)
            except LoweringError as exc:
                error = exc
                continue
            fits.append(tw)
            if all(d["place"] != PLACE_GLOBAL for d in rows):
                break
        else:
            if not fits:
                raise error
            built = build(fits[0], smem_limit)
    tw, nt, rkeys, ckeys, n_meta, head, ws = built
    if ws > _I32_MAX:
        raise LoweringError("the island's global tiles overflow the "
                            "kernel's int32 coordinates")

    def table(data, width):
        return np.asarray(data, dtype=np.int64).reshape(-1, width)

    maps = [table([[c, p, dy, off] for (c, p, dy), off in keys.items()], 4)
            for keys in (rkeys, ckeys)]
    parts = [table([[d[f] for f in FIELDS] for d in rows], NF),
             table(taps, TAPW), table(phases, 5), table(prog, TAPW), *maps,
             np.asarray(resmap, dtype=np.int64)]
    offs = np.cumsum([0] + [a.size for a in parts]).tolist()
    layout = dict(zip(("o_stages", "o_taps", "o_phases", "o_prog",
                       "o_rmaps", "o_cmaps", "o_resmap", "o_fconst"), offs))
    # f32: the program has f32 stages and takes the kernel's
    # instantiation with a float stack
    layout.update(head, n_meta=n_meta, n_stages=len(rows),
                  n_rmaps=len(rkeys), n_cmaps=len(ckeys), ntiles=nt,
                  f32=int(any(d["f32"] for d in rows)))
    return EncodedProgram(
        stages=parts[0], taps=parts[1], phases=parts[2], prog=parts[3],
        fconst=np.asarray(fconst, dtype=np.float64), rmaps=maps[0],
        cmaps=maps[1], resmap=parts[6], names=[d["name"] for d in program],
        col_tile=tw, ntiles=nt, layout=layout, ws_per_block=ws)


# ---------------------------------------------------------------------------
# plain version: the same tables, whole-tile torch ops
# ---------------------------------------------------------------------------

def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _cols(d: Dict[str, int], j: Optional[int]) -> Tuple[int, int]:
    """(first column, width) of stage `d`'s tile j; the whole width for
    ``j=None``."""
    if j is None:
        return 0, d["W"]
    return j * d["cstep"] + d["clo"], d["CW"]


def eval_band_reference(enc: EncodedProgram, inputs: Sequence[torch.Tensor],
                        i: int, j: Optional[int] = None
                        ) -> Dict[int, torch.Tensor]:
    """Band step `i` of every image: stage row -> (B, L, columns) tile.

    `inputs` are (B, H, W) container tensors by input slot.  Integer
    tiles come back in int64, float-stored ones in f64.  With ``j=None``
    a tile spans the whole width: this is the reference's `eval_band`,
    walking the encoded tables instead of closures.  With a column tile
    `j`, tile column c of a stage holds column
    ``clip(j * cstep + clo + c, 0, W - 1)`` and a tap reads its parent
    through the band-relative clamp
    ``clip(clip(floor((x * sx + dx) / ux), 0, pW - 1) - pc_start, 0,
    pCW - 1)`` — the kernel's geometry, rows and columns alike.
    """
    rows = enc.rows()
    taps = enc.taps.tolist()
    phases = enc.phases.tolist()
    prog = enc.prog.tolist()
    fc = enc.fconst.tolist()
    dev = inputs[0].device
    nb = inputs[0].shape[0]
    tiles: Dict[int, torch.Tensor] = {}

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=dev)

    for s, d in enumerate(rows):
        start = i * d["step"] + d["lo"]
        L, H, W = d["L"], d["H"], d["W"]
        c0, CW = _cols(d, j)
        wide = torch.float64 if d["is_float"] else torch.int64
        rows_abs = torch.clamp(start + arange(L), 0, H - 1)
        cols_abs = torch.clamp(c0 + arange(CW), 0, W - 1)
        if d["kind"] == KIND_INPUT:
            # contiguous band at the clamped start, widened before any
            # indexing (uint16/uint32 are storage-only), then the rows
            # reordered for the edge-replicate clamp
            b = min(max(start, 0), H - L)
            band = inputs[d["in_slot"]][:, b:b + L].to(wide)
            tiles[s] = band.index_select(1, rows_abs - b).index_select(
                2, cols_abs)
            continue

        def gather(p, dy, dx):
            pd = rows[p]
            p_start = i * pd["step"] + pd["lo"]
            pc0, pcw = _cols(pd, j)
            src = torch.clamp(
                _floordiv(rows_abs * d["sy"] + dy, d["uy"]) - p_start,
                0, pd["L"] - 1)
            cols = torch.clamp(
                torch.clamp(_floordiv(cols_abs * d["sx"] + dx, d["ux"]),
                            0, pd["W"] - 1) - pc0, 0, pcw - 1)
            return tiles[p].index_select(1, src).index_select(2, cols)

        fb = d["fbase"]
        res = phases[d["ph_begin"]:d["ph_begin"] + d["ph_count"]]
        if d["kind"] == KIND_INTLINEAR:
            acc = B.accumulate_intlinear(
                [(t[3], gather(*t[:3])) for t in
                 taps[d["tap_begin"]:d["tap_begin"] + d["tap_count"]]],
                lambda: torch.zeros((nb, L, CW), dtype=torch.int64,
                                    device=dev))
            qmin, qmax = d["int_min"], d["int_max"]
            if res:
                qmin, qmax = B.residue_bounds(
                    (d["my"], d["mx"]), [r[:4] for r in res], rows_abs,
                    cols_abs, qmin, qmax)
            tiles[s] = B.finish_intlinear(acc, bool(d["dyadic"]), d["sm"],
                                          d["t_shift"], fc[fb + FC_CSCALE],
                                          qmin, qmax)
            continue
        # an f32 stage runs every op in f32: taps dequantized as
        # f32(q) * f32(2^-beta), f32 constants, the snap on the f32 raw
        # value (`backends.snap_expr`), as the reference's `dequant_f32`
        # path; the rest in f64
        fdt = torch.float32 if d["f32"] else torch.float64
        stack: List[torch.Tensor] = []
        for op, a, b_, c, *_ in prog[d["prog_begin"]:d["prog_begin"]
                                     + d["prog_len"]]:
            if op == OP_REF:
                v = gather(a, b_, c)
                if not rows[a]["is_float"]:
                    v = v.to(fdt) * torch.tensor(
                        fc[rows[a]["fbase"] + FC_INV_STEP], dtype=fdt,
                        device=dev)
                stack.append(v)
            elif op == OP_CONST:
                stack.append(torch.tensor(fc[a], dtype=fdt, device=dev))
            elif op in (OP_SQR, OP_ABS, OP_SQRT):
                x = stack.pop()
                stack.append(x * x if op == OP_SQR else
                             torch.abs(x) if op == OP_ABS else npops.sqrt(x))
            elif op == OP_SELECT:
                y, x, cond = stack.pop(), stack.pop(), stack.pop()
                if cond.dtype != torch.bool:
                    cond = cond != 0
                stack.append(torch.where(cond, x, y))
            else:
                y, x = stack.pop(), stack.pop()
                stack.append(_BINARY[op](x, y))
        raw = stack.pop().to(fdt).expand(nb, L, CW)
        entries = [(ry, rx, lo, hi, fc[f]) for ry, rx, lo, hi, f in res]
        if d["snap"] == B.SNAP_MIXED:
            entries = [(ry, rx, fc[f + FC_MIN], fc[f + FC_MAX], fc[f])
                       for ry, rx, _, _, f in res]
        tiles[s] = B.snap_expr(raw, d["snap"], fc[fb + FC_STEP],
                               fc[fb + FC_MIN] if d["is_float"]
                               else d["int_min"],
                               fc[fb + FC_MAX] if d["is_float"]
                               else d["int_max"],
                               (d["my"], d["mx"]), entries, rows_abs,
                               cols_abs)
    return tiles


_BINARY: Dict[int, Callable] = {
    OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
    OP_DIV: torch.div,
    # numpy's operand rules for NaN and +-0 (`core.npops`), as the kernel's
    OP_MIN: npops.minimum, OP_MAX: npops.maximum,
    OP_LT: torch.lt, OP_LE: torch.le, OP_GT: torch.gt, OP_GE: torch.ge,
}


def band_outputs_reference(enc: EncodedProgram,
                           inputs: Sequence[torch.Tensor], i: int,
                           j: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """Band `i`'s output rows ``[-lo, -lo + step)`` per output stage,
    cast into the stage's container: the reference's `band_output`.
    With a column tile `j`, its columns ``[-clo, -clo + cstep)``."""
    tiles = eval_band_reference(enc, inputs, i, j)
    out = {}
    for s, d in enumerate(enc.rows()):
        if d["out_slot"] >= 0:
            t = tiles[s][:, -d["lo"]:-d["lo"] + d["step"]]
            if j is not None:
                t = t[:, :, -d["clo"]:-d["clo"] + d["cstep"]]
            out[enc.names[s]] = t.to(CONTAINERS[d["code"]])
    return out


Bands = Tuple[int, int]          # (first band step, number of band steps)


def band_range(grid: int, bands: Optional[Bands]) -> Bands:
    """`bands` checked against the island's `grid`; ``None`` is the
    whole grid, ``(0, grid)``."""
    if bands is None:
        return 0, grid
    b0, k = (int(v) for v in bands)
    if b0 < 0 or k < 1 or b0 + k > grid:
        raise ValueError(f"fused_pipeline: bands {tuple(bands)} do not lie "
                         f"in the grid of {grid} band steps")
    return b0, k


def _alloc_outputs(enc: EncodedProgram, nb: int, device,
                   bands: Bands) -> List[torch.Tensor]:
    """Each output stage's rows that band steps ``[b0, b0 + k)`` write:
    image rows ``[b0 * step, min((b0 + k) * step, H))``."""
    b0, k = bands
    return [torch.empty((nb, min((b0 + k) * d["step"], d["H"])
                         - b0 * d["step"], d["W"]),
                        dtype=CONTAINERS[d["code"]], device=device)
            for _, d in enc.slots("out_slot")]


def fused_pipeline_reference(enc: EncodedProgram, grid: int,
                             batch: Optional[int] = None,
                             col_tiles: bool = False,
                             bands: Optional[Bands] = None) -> Callable:
    """Plain PyTorch version of the band kernel, band by band.

    Returns ``f(*inputs) -> tuple(outputs)`` with the `fused_pipeline`
    contract: inputs (H, W), or (B, H, W) with `batch`, in their
    containers; outputs the island's output stages in theirs.  With
    `col_tiles` it walks the kernel's work items, (band, column tile),
    and stitches their outputs, masking the ragged last band and tile;
    else whole-width bands.  `bands=(b0, k)` walks band steps ``[b0, b0
    + k)`` only (a shard of the grid, `lowering.sharded`): the inputs
    are still the whole images, the outputs hold those bands' rows."""
    b0, k = band_range(grid, bands)

    def run(*arrays):
        xs = [a if batch is not None else a.unsqueeze(0) for a in arrays]
        outs = _alloc_outputs(enc, xs[0].shape[0], xs[0].device, (b0, k))
        for i in range(b0, b0 + k):
            for j in (range(enc.ntiles) if col_tiles else (None,)):
                band = band_outputs_reference(enc, xs, i, j)
                for o, (s, d) in zip(outs, enc.slots("out_slot")):
                    r0, c0 = (i - b0) * d["step"], 0 if j is None else \
                        j * d["cstep"]
                    kr = min(d["step"], o.shape[1] - r0)  # ragged last band
                    kc = d["W"] - c0 if j is None else \
                        min(d["cstep"], d["W"] - c0)    # ragged last tile
                    if kr > 0 and kc > 0:
                        o[:, r0:r0 + kr, c0:c0 + kc] = \
                            band[enc.names[s]][:, :kr, :kc]
        return tuple(o if batch is not None else o[0] for o in outs)

    return run


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def fused_pipeline(enc: EncodedProgram, grid: int,
                   batch: Optional[int] = None,
                   bands: Optional[Bands] = None) -> Callable:
    """Band-kernel wrapper: ``f(*inputs) -> tuple(outputs)``.

    CPU tensors run `fused_pipeline_reference`.  CUDA tensors launch
    `csrc/fused_band.cu` on the current stream or raise; there is no
    fallback.  The launch allocates the outputs (and the global tiles,
    where the encoder placed any) here, and does not synchronize.
    `bands=(b0, k)` runs band steps ``[b0, b0 + k)`` of the `grid`
    (default: all of them) into outputs of those bands' rows."""
    rng = band_range(grid, bands)

    def run(*arrays):
        dev = arrays[0].device
        if dev.type == "cpu":
            return fused_pipeline_reference(enc, grid, batch,
                                            bands=rng)(*arrays)
        if dev.type != "cuda":
            raise RuntimeError(f"fused_pipeline: unsupported device {dev}")
        return _launch(enc, rng, batch, arrays)

    return run


_OCCUPANCY: Dict[Tuple[int, int], Dict[str, int]] = {}


def occupancy(enc: EncodedProgram, device) -> Dict[str, int]:
    """The kernel's resources on `device` at `enc`'s shared memory, for
    the instantiation `enc` launches (with or without f32 stages):
    blocks an SM runs at once, SMs, registers and local bytes a thread
    (from the compiled kernel)."""
    from repro_torch.kernels import _build
    dev = torch.device(device)
    f32 = enc.layout["f32"]
    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(), enc.smem_bytes, f32)
    if key not in _OCCUPANCY:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            rc = _build.load("fused_band").fused_band_occupancy(
                enc.smem_bytes, THREADS, f32, out)
        if rc != 0:
            raise RuntimeError(f"fused_band occupancy query failed: CUDA "
                               f"error {rc}")
        _OCCUPANCY[key] = dict(zip(("blocks_per_sm", "sms", "registers",
                                    "local_bytes"), out))
        if out[0] < 1:
            raise RuntimeError(f"fused_band: a block of {THREADS} threads "
                               f"and {enc.smem_bytes} bytes of shared "
                               f"memory does not fit an SM")
    return _OCCUPANCY[key]


def launch_grid(enc: EncodedProgram, nbands: int, nb: int, device) -> int:
    """Blocks of the persistent grid over `nbands` band steps of `nb`
    images: every SM full, at most one block a work item."""
    occ = occupancy(enc, device)
    return min(nb * nbands * enc.ntiles, occ["sms"] * occ["blocks_per_sm"])


def _launch(enc: EncodedProgram, bands: Bands, batch: Optional[int],
            arrays: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    from repro_torch.kernels import _build

    ins = [d for _, d in enc.slots("in_slot")]
    outs_desc = enc.slots("out_slot")
    if len(arrays) != len(ins):
        raise ValueError(f"fused_pipeline: {len(ins)} inputs expected, got "
                         f"{len(arrays)}")
    if len(ins) > MAX_IO or len(outs_desc) > MAX_IO:
        raise ValueError(f"fused_pipeline: more than {MAX_IO} inputs or "
                         f"outputs in one island")
    dev = arrays[0].device
    nb = arrays[0].shape[0] if batch is not None else 1
    for a, d in zip(arrays, ins):
        want = ((nb, d["H"], d["W"]) if batch is not None
                else (d["H"], d["W"]))
        if a.device != dev or tuple(a.shape) != want \
                or a.dtype != CONTAINERS[d["code"]] or not a.is_contiguous():
            raise ValueError(
                f"fused_pipeline: input slot {d['in_slot']} must be a "
                f"contiguous {CONTAINERS[d['code']]} tensor of shape {want} "
                f"on {dev}; got {a.dtype} {tuple(a.shape)} on {a.device}")
    band0, nbands = bands
    outs = _alloc_outputs(enc, nb, dev, bands)
    blocks = launch_grid(enc, nbands, nb, dev)
    ws = torch.empty(blocks * enc.ws_per_block, dtype=torch.uint8,
                     device=dev)
    layout = (ctypes.c_int * len(LAYOUT))(*[enc.layout[k] for k in LAYOUT])
    in_ptrs = (ctypes.c_void_p * MAX_IO)(*[a.data_ptr() for a in arrays])
    out_ptrs = (ctypes.c_void_p * MAX_IO)(*[o.data_ptr() for o in outs])
    lib = _build.load("fused_band")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_band_launch(
            enc.device_meta(dev).data_ptr(), layout, in_ptrs, len(arrays),
            out_ptrs, len(outs), ws.data_ptr(), enc.ws_per_block, nb, band0,
            nbands, blocks, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"fused_band launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        LAUNCHES["fused_band"] += 1
    return tuple(o if batch is not None else o[0] for o in outs)


# ---------------------------------------------------------------------------
# the single-stage fixed-point stencil
# ---------------------------------------------------------------------------

Tap = Tuple[int, int, int]      # (dy, dx, w_q)
Halo = Union[int, Tuple[int, int]]
MAX_TAPS = 128                  # the taps table of `csrc/stencil.cu`
_MAX_SMEM = 232448 - 16 * MAX_TAPS  # dynamic shared memory of one block
_INT32 = (-(1 << 31), (1 << 31) - 1)


def _stencil_smem_bytes(hy: int, hx: int) -> int:
    """One block's dynamic shared memory in `csrc/stencil.cu`, a copy of
    its `smem_bytes` (the card tests hold both to one halo limit): a
    ring of 3 steps of 32 rows plus 2hy rows, each slot a 128-column
    strip's padded row in whole 16-byte chunks, and two tables of the
    32 + 2hy rows of a step's window."""
    pitch = 4 * ((128 + 2 * hx + 6) // 4)
    return 4 * ((3 * 32 + 2 * hy) * pitch + 2 * (32 + 2 * hy))


def _stencil_args(x_q: torch.Tensor, taps: Sequence[Tap], halo: Halo,
                  shift: int, qmin: int, qmax: int
                  ) -> Tuple[List[Tap], int, int, int, int]:
    """Checked arguments: the non-zero taps, the halo (hy, hx) and the
    output (H, W).  `halo` is one int for both axes or (hy, hx)."""
    hy, hx = (halo, halo) if isinstance(halo, int) else halo
    if x_q.dtype != torch.int32 or x_q.dim() != 2:
        raise ValueError(f"fixedpoint_stencil: x_q must be a 2-D int32 "
                         f"tensor, got {x_q.dtype} {tuple(x_q.shape)}")
    H, W = x_q.shape[0] - 2 * hy, x_q.shape[1] - 2 * hx
    if hy < 0 or hx < 0 or H <= 0 or W <= 0:
        raise ValueError(f"fixedpoint_stencil: halo {halo} does not fit "
                         f"x_q of shape {tuple(x_q.shape)}")
    taps = [(int(dy), int(dx), int(w)) for dy, dx, w in taps if w != 0]
    for dy, dx, w in taps:
        if abs(dy) > hy or abs(dx) > hx or not _INT32[0] <= w <= _INT32[1]:
            raise ValueError(f"fixedpoint_stencil: tap {(dy, dx, w)} "
                             f"outside halo {halo} or int32")
    if shift > 31 or not (_INT32[0] <= qmin <= _INT32[1]
                          and _INT32[0] <= qmax <= _INT32[1]):
        raise ValueError(f"fixedpoint_stencil: shift {shift} above 31 or "
                         f"bounds ({qmin}, {qmax}) outside int32")
    return taps, hy, hx, H, W


def fixedpoint_stencil_reference(x_q: torch.Tensor, taps: Sequence[Tap],
                                 halo: Halo, shift: int,
                                 qmin: int, qmax: int) -> torch.Tensor:
    """Plain version: int32 shifted slices, as the reference's `ref.py`.

    int32 adds and multiplies wrap as the reference's do; `>>` on int32
    is the arithmetic shift (a floor), so the bias makes the rounding
    half-UP; the clip follows the shift."""
    taps, hy, hx, H, W = _stencil_args(x_q, taps, halo, shift, qmin, qmax)
    acc = torch.zeros((H, W), dtype=torch.int32, device=x_q.device)
    for dy, dx, w in taps:
        acc = acc + w * x_q[hy + dy:hy + dy + H, hx + dx:hx + dx + W]
    if shift > 0:
        acc = (acc + (1 << (shift - 1))) >> shift
    return torch.clamp(acc, qmin, qmax)


def fixedpoint_stencil(x_q: torch.Tensor, taps: Sequence[Tap],
                       halo: Halo, shift: int, qmin: int,
                       qmax: int) -> torch.Tensor:
    """Apply the quantized stencil to a pre-padded scaled-int image.

    x_q: int32 (H + 2hy, W + 2hx), edge-padded per axis; returns int32
    (H, W).  CPU tensors run `fixedpoint_stencil_reference`; CUDA tensors
    launch `csrc/stencil.cu` on the current stream or raise."""
    if x_q.device.type == "cpu":
        return fixedpoint_stencil_reference(x_q, taps, halo, shift, qmin,
                                            qmax)
    from repro_torch.kernels import _build
    taps, hy, hx, H, W = _stencil_args(x_q, taps, halo, shift, qmin, qmax)
    if len(taps) > MAX_TAPS:
        raise ValueError(f"fixedpoint_stencil: {len(taps)} taps, the kernel "
                         f"takes at most {MAX_TAPS}")
    if _stencil_smem_bytes(hy, hx) > _MAX_SMEM:
        raise ValueError(f"fixedpoint_stencil: halo {(hy, hx)} too large "
                         f"for one block's shared memory")
    out = torch.empty((H, W), dtype=torch.int32, device=x_q.device)
    table = (ctypes.c_int32 * (3 * len(taps) or 1))(
        *[v for tap in taps for v in tap])
    _build.launch("stencil", "stencil_launch", (x_q, out), H, W, table,
                  len(taps), hy, hx, shift, qmin, qmax)
    with _LAUNCH_LOCK:
        LAUNCHES["stencil"] += 1
    return out
