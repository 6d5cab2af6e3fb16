"""The stencil kernels: the fused rate-island band kernel (encoder,
plain version, wrapper) and the single-stage fixed-point stencil.

The band kernel replaces the TPU kernel
`repro/kernels/stencil/kernel.py:fused_pipeline` (`_fused_kernel`,
`eval_band`, `band_output`; `pallas_call` at line 321).  One call runs one rate island over every (image, band) of its
schedule: it loads each input's rows of the band with edge-replicate
clamps, evaluates every compute stage of the island on the band through
clamped tap gathers, and writes rows ``[-lo, -lo + step)`` of the
island's output stages in their legalized containers.

The island is not compiled into code.  `encode_program` flattens the
island's stage descriptors (`lowering.cuda_backend.island_program`) into
int64 / f64 tables, and one CUDA source, `csrc/fused_band.cu`,
interprets them.  The same tables drive `fused_pipeline_reference`, the
plain PyTorch version, so the CPU tests check the encoder and every
datapath rule and only the CUDA transcription is left for the card.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.lowering import backends as B
from repro_torch.lowering.ir import LoweringError

# Columns of the per-stage table; `csrc/fused_band.cu` declares the same
# names in the same order (tests/test_torch_kernels.py checks it).
FIELDS = ("kind", "step", "lo", "L", "H", "W", "sy", "sx", "uy", "ux",
          "code", "in_slot", "out_slot", "ws_off", "is_float",
          "tap_begin", "tap_count", "dyadic", "sm", "t_shift",
          "int_min", "int_max", "ph_begin", "ph_count", "my", "mx",
          "prog_begin", "prog_len", "snap", "fbase")
NF = len(FIELDS)

KIND_INPUT, KIND_INTLINEAR, KIND_EXPR = 0, 1, 2

# container codes, in the order of the kernel's load/store switch
CONTAINERS = (torch.uint8, torch.int8, torch.uint16, torch.int16,
              torch.uint32, torch.int32, torch.int64, torch.float64)
CODE = {dt: k for k, dt in enumerate(CONTAINERS)}

# postfix opcodes of an expression stage's program
(OP_REF, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SQR, OP_ABS, OP_SQRT,
 OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE, OP_SELECT) = range(16)
MAX_STACK = 32      # the kernel's per-thread operand stack
MAX_IO = 32         # input and output tensors per launch, each
THREADS = 256

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
    taps: np.ndarray            # int64 (n_taps, 4): parent, dy, dx, weight
    phases: np.ndarray          # int64 (n_res, 5): ry, rx, qmin, qmax, fbase
    prog: np.ndarray            # int64 (n_ops, 4): opcode, a, b, c
    fconst: np.ndarray          # f64 constants
    names: List[str]            # stage name per table row
    ws_per_block: int           # workspace slots (8 bytes) one band needs
    _dev: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False)

    def rows(self) -> List[Dict[str, int]]:
        return [dict(zip(FIELDS, r)) for r in self.stages.tolist()]

    def slots(self, key: str) -> List[Tuple[int, Dict[str, int]]]:
        """(table row, stage fields) of the inputs (``key="in_slot"``) or
        outputs (``key="out_slot"``), in slot order."""
        return sorted(((s, r) for s, r in enumerate(self.rows())
                       if r[key] >= 0), key=lambda sr: sr[1][key])

    def device_tables(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The tables as tensors on `device`, copied once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.stages, self.taps, self.phases, self.prog,
                          self.fconst))
        return self._dev[key]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class _Sym:
    """A symbolic f64 value: the postfix code that computes it."""
    __slots__ = ("code", "pool")

    def __init__(self, code, pool):
        self.code = code
        self.pool = pool

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
        # numpy evaluates ``x ** 2`` on f64 as ``x * x``; no pipeline
        # uses another power, so none is encoded until a test pins it
        if n != 2:
            raise LoweringError(f"the band kernel encodes only x ** 2, "
                                f"not x ** {n}")
        return _emit(self.pool, OP_SQR, self)


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


def encode_program(program: Sequence[Dict]) -> EncodedProgram:
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
    """
    index = {d["name"]: k for k, d in enumerate(program)}
    stages, taps, phases, prog, fconst = [], [], [], [], []
    ws_off = 0
    for d in program:
        ls = d["ls"]
        row = dict.fromkeys(FIELDS, 0)
        row.update(step=d["step"], lo=d["lo"], L=d["L"], H=d["H"],
                   W=d["W"], code=CODE[d["dtype"]], in_slot=-1,
                   out_slot=d.get("out_slot", -1), ws_off=-1,
                   is_float=int(d["dtype"] == torch.float64),
                   sy=1, sx=1, uy=1, ux=1, my=1, mx=1, dyadic=1, sm=1)
        row["fbase"] = len(fconst)
        fconst += _type_block(ls.t) + [float(ls.cscale)]
        if ls.t is not None and not ls.store_float:
            row["int_min"] = _int64(ls.t.int_min, "int_min")
            row["int_max"] = _int64(ls.t.int_max, "int_max")
        if d["kind"] == "input":
            row.update(kind=KIND_INPUT, in_slot=d["in_slot"])
            stages.append([row[f] for f in FIELDS])
            continue
        st = ls.stage
        (row["sy"], row["sx"]), (row["uy"], row["ux"]) = st.stride, st.upsample
        row["ws_off"] = ws_off
        ws_off += d["L"] * d["W"]
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
            row.update(kind=KIND_INTLINEAR, tap_begin=len(taps),
                       tap_count=len(ls.int_taps), dyadic=int(ls.dyadic),
                       sm=ls.sm, t_shift=ls.t_shift)
            taps += [[index[tp.stage], tp.dy, tp.dx, tp.W]
                     for tp in ls.int_taps]
        else:
            if ls.expr_dtype != "f64":
                # narrow-mode f32 replay is a later slice of the port
                raise LoweringError(
                    f"stage {d['name']!r}: the band kernel encodes f64 "
                    f"expression stages only, not {ls.expr_dtype!r}")
            xp = _EmitXP(fconst)

            def ref(stage, dy, dx):
                return _Sym([(OP_REF, index[stage], dy, dx)], fconst)

            code = _lift(B.eval_expr(st.expr, ref, d["params"], xp,
                                     xp.where), fconst).code
            if _stack_depth(code) > MAX_STACK:
                raise LoweringError(
                    f"stage {d['name']!r}: expression needs a stack deeper "
                    f"than {MAX_STACK}")
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
            prog += [list(c) for c in code]
        stages.append([row[f] for f in FIELDS])

    def table(rows, width):
        return np.asarray(rows, dtype=np.int64).reshape(-1, width)

    return EncodedProgram(stages=table(stages, NF), taps=table(taps, 4),
                          phases=table(phases, 5), prog=table(prog, 4),
                          fconst=np.asarray(fconst, dtype=np.float64),
                          names=[d["name"] for d in program],
                          ws_per_block=ws_off)


# ---------------------------------------------------------------------------
# plain version: the same tables, whole-tile torch ops
# ---------------------------------------------------------------------------

def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def eval_band_reference(enc: EncodedProgram, inputs: Sequence[torch.Tensor],
                        i: int) -> Dict[int, torch.Tensor]:
    """Band step `i` of every image: stage row -> (B, L, W) tile.

    `inputs` are (B, H, W) container tensors by input slot.  Integer
    tiles come back in int64, float-stored ones in f64 — the kernel's
    8-byte workspace slots.  This is the reference's `eval_band`,
    walking the encoded tables instead of closures.
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
        wide = torch.float64 if d["is_float"] else torch.int64
        rows_abs = torch.clamp(start + arange(L), 0, H - 1)
        if d["kind"] == KIND_INPUT:
            # contiguous band at the clamped start, widened before any
            # indexing (uint16/uint32 are storage-only), then the rows
            # reordered for the edge-replicate clamp
            b = min(max(start, 0), H - L)
            band = inputs[d["in_slot"]][:, b:b + L].to(wide)
            tiles[s] = band.index_select(1, rows_abs - b)
            continue

        def gather(p, dy, dx):
            pd = rows[p]
            p_start = i * pd["step"] + pd["lo"]
            src = torch.clamp(
                _floordiv(rows_abs * d["sy"] + dy, d["uy"]) - p_start,
                0, pd["L"] - 1)
            cols = torch.clamp(_floordiv(arange(W) * d["sx"] + dx, d["ux"]),
                               0, pd["W"] - 1)
            return tiles[p].index_select(1, src).index_select(2, cols)

        fb = d["fbase"]
        res = phases[d["ph_begin"]:d["ph_begin"] + d["ph_count"]]
        if d["kind"] == KIND_INTLINEAR:
            acc = B.accumulate_intlinear(
                [(w, gather(p, dy, dx))
                 for p, dy, dx, w in
                 taps[d["tap_begin"]:d["tap_begin"] + d["tap_count"]]],
                lambda: torch.zeros((nb, L, W), dtype=torch.int64,
                                    device=dev))
            qmin, qmax = d["int_min"], d["int_max"]
            if res:
                qmin, qmax = B.residue_bounds(
                    (d["my"], d["mx"]), [r[:4] for r in res], rows_abs, W,
                    qmin, qmax)
            tiles[s] = B.finish_intlinear(acc, bool(d["dyadic"]), d["sm"],
                                          d["t_shift"], fc[fb + FC_CSCALE],
                                          qmin, qmax)
            continue
        stack: List[torch.Tensor] = []
        for op, a, b_, c in prog[d["prog_begin"]:d["prog_begin"]
                                  + d["prog_len"]]:
            if op == OP_REF:
                v = gather(a, b_, c)
                if not rows[a]["is_float"]:
                    v = v.to(torch.float64) * fc[rows[a]["fbase"]
                                                 + FC_INV_STEP]
                stack.append(v)
            elif op == OP_CONST:
                stack.append(torch.tensor(fc[a], dtype=torch.float64,
                                          device=dev))
            elif op in (OP_SQR, OP_ABS, OP_SQRT):
                x = stack.pop()
                stack.append(x * x if op == OP_SQR else
                             torch.abs(x) if op == OP_ABS else torch.sqrt(x))
            elif op == OP_SELECT:
                y, x, cond = stack.pop(), stack.pop(), stack.pop()
                if cond.dtype != torch.bool:
                    cond = cond != 0
                stack.append(torch.where(cond, x, y))
            else:
                y, x = stack.pop(), stack.pop()
                stack.append(_BINARY[op](x, y))
        raw = stack.pop().to(torch.float64).expand(nb, L, W)
        entries = [(ry, rx, lo, hi, fc[f]) for ry, rx, lo, hi, f in res]
        if d["snap"] == B.SNAP_MIXED:
            entries = [(ry, rx, fc[f + FC_MIN], fc[f + FC_MAX], fc[f])
                       for ry, rx, _, _, f in res]
        tiles[s] = B.snap_expr(raw, d["snap"], fc[fb + FC_STEP],
                               fc[fb + FC_MIN] if d["is_float"]
                               else d["int_min"],
                               fc[fb + FC_MAX] if d["is_float"]
                               else d["int_max"],
                               (d["my"], d["mx"]), entries, rows_abs)
    return tiles


_BINARY: Dict[int, Callable] = {
    OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
    OP_DIV: torch.div,
    # numpy's minimum/maximum propagate NaN, and so do torch's
    OP_MIN: torch.minimum, OP_MAX: torch.maximum,
    OP_LT: torch.lt, OP_LE: torch.le, OP_GT: torch.gt, OP_GE: torch.ge,
}


def band_outputs_reference(enc: EncodedProgram,
                           inputs: Sequence[torch.Tensor], i: int
                           ) -> Dict[str, torch.Tensor]:
    """Band `i`'s output rows ``[-lo, -lo + step)`` per output stage,
    cast into the stage's container: the reference's `band_output`."""
    tiles = eval_band_reference(enc, inputs, i)
    out = {}
    for s, d in enumerate(enc.rows()):
        if d["out_slot"] >= 0:
            rows = tiles[s][:, -d["lo"]:-d["lo"] + d["step"]]
            out[enc.names[s]] = rows.to(CONTAINERS[d["code"]])
    return out


def _alloc_outputs(enc: EncodedProgram, nb: int, device) -> List[torch.Tensor]:
    return [torch.empty((nb, d["H"], d["W"]), dtype=CONTAINERS[d["code"]],
                        device=device) for _, d in enc.slots("out_slot")]


def fused_pipeline_reference(enc: EncodedProgram, grid: int,
                             batch: Optional[int] = None) -> Callable:
    """Plain PyTorch version of the band kernel, band by band.

    Returns ``f(*inputs) -> tuple(outputs)`` with the `fused_pipeline`
    contract: inputs (H, W), or (B, H, W) with `batch`, in their
    containers; outputs the island's output stages in theirs."""

    def run(*arrays):
        xs = [a if batch is not None else a.unsqueeze(0) for a in arrays]
        outs = _alloc_outputs(enc, xs[0].shape[0], xs[0].device)
        for i in range(grid):
            band = band_outputs_reference(enc, xs, i)
            for o, (s, d) in zip(outs, enc.slots("out_slot")):
                r0 = i * d["step"]
                k = min(d["step"], d["H"] - r0)     # ragged last band
                if k > 0:
                    o[:, r0:r0 + k] = band[enc.names[s]][:, :k]
        return tuple(o if batch is not None else o[0] for o in outs)

    return run


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def fused_pipeline(enc: EncodedProgram, grid: int,
                   batch: Optional[int] = None) -> Callable:
    """Band-kernel wrapper: ``f(*inputs) -> tuple(outputs)``.

    CPU tensors run `fused_pipeline_reference`.  CUDA tensors launch
    `csrc/fused_band.cu` on the current stream or raise; there is no
    fallback.  The launch allocates the outputs and the per-block
    workspace here, and does not synchronize."""

    def run(*arrays):
        dev = arrays[0].device
        if dev.type == "cpu":
            return fused_pipeline_reference(enc, grid, batch)(*arrays)
        if dev.type != "cuda":
            raise RuntimeError(f"fused_pipeline: unsupported device {dev}")
        return _launch(enc, grid, batch, arrays)

    return run


def _launch(enc: EncodedProgram, grid: int, batch: Optional[int],
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
    outs = _alloc_outputs(enc, nb, dev)
    blocks = min(nb * grid, 4 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    ws = torch.empty(blocks * enc.ws_per_block, dtype=torch.int64,
                     device=dev)
    t_stages, t_taps, t_phases, t_prog, t_fc = enc.device_tables(dev)
    in_ptrs = (ctypes.c_void_p * MAX_IO)(*[a.data_ptr() for a in arrays])
    out_ptrs = (ctypes.c_void_p * MAX_IO)(*[o.data_ptr() for o in outs])
    lib = _build.load("fused_band")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_band_launch(
            t_stages.data_ptr(), enc.stages.shape[0], t_taps.data_ptr(),
            t_phases.data_ptr(), t_prog.data_ptr(), t_fc.data_ptr(),
            in_ptrs, len(arrays), out_ptrs, len(outs), ws.data_ptr(),
            enc.ws_per_block, nb, grid, blocks, THREADS, stream)
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
_STENCIL_TILE = (16, 64)        # output rows, columns of one CUDA block
_MAX_SMEM = 232448 - 16 * MAX_TAPS  # dynamic shared memory of one block
_INT32 = (-(1 << 31), (1 << 31) - 1)


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
    th, tw = _STENCIL_TILE
    if 4 * (th + 2 * hy) * (tw + 2 * hx) > _MAX_SMEM:
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
