"""The SMT engine's walk kernels (`repro_torch/smt/csrc/smt_walk.cu`)
against their plain versions, on the CPU.

The kernels run only on the card (`tests/test_torch_cuda.py` holds them
to the plain versions there).  Here a per-box walker written in Python,
`Walker`, follows the kernels' contract step by step: one box at a time,
the IEEE operations of the transfer functions with numpy's rules, every
`_any` branch a per-box `if`, the rounds stopped over the whole frontier
by one flag, and `_b_mul`'s NaN check replayed by sites (a first pass
records which calls saw a NaN on any row; replays fix those calls on
every row until a replay records what it used).  It must give the bits
of the port's plain `_hc4_rows` and `_gradients_rows` and of the JAX
package's numpy engine (`repro.smt.solver`) on every row, the dead ones
included, with the sign of every zero.
"""
import math

import numpy as np
import pytest
import torch

from repro.core.range_analysis import analyze as ref_analyze
from repro.pipelines import dus, hcd, optical_flow, usm
from repro.smt import encoder as REnc
from repro.smt import solver as RS
from repro_torch.core.range_analysis import analyze
from repro_torch.kernels import _build
from repro_torch.pipelines import dus as tdus
from repro_torch.pipelines import hcd as thcd
from repro_torch.pipelines import optical_flow as tof
from repro_torch.pipelines import usm as tusm
from repro_torch.smt import encoder as PEnc
from repro_torch.smt import solver as PS
from repro_torch.smt import walk as W
from _torch_threads import one_torch_thread  # noqa: F401
# the frontiers the card tests use: even rows mostly live, odd rows
# mostly die, with infinite, zero, straddling and point intervals
from test_torch_cuda import _smt_frontier as frontier

INF = math.inf

# stages of every benchmark the engine serves: usm, hcd, dus, dus_ext and
# optical flow (its single-level and pyramid forms)
STAGES = [
    ("usm", usm.build, tusm.build, "sharpen"),
    ("usm", usm.build, tusm.build, "masked"),
    ("hcd", hcd.build, thcd.build, "Ixy"),
    ("hcd", hcd.build, thcd.build, "trace"),
    ("hcd", hcd.build, thcd.build, "det"),
    ("dus", dus.build, tdus.build, "Uy"),
    ("dus_ext", dus.build_extended, tdus.build_extended, "res"),
    ("of", lambda: optical_flow.build(n_iters=1),
     lambda: tof.build(n_iters=1), "Denom"),
    ("of", lambda: optical_flow.build(n_iters=1),
     lambda: tof.build(n_iters=1), "Vx1"),
    ("of_pyr", lambda: optical_flow.build_pyramid(n_iters=1),
     lambda: tof.build_pyramid(n_iters=1), "cVx0"),
]
IDS = [f"{p}-{s}" for p, _, _, s in STAGES]

_CSPS = {}


def _csps(ref_make, port_make, stage):
    """The reference's and the port's blind CSP of `stage` (cached)."""
    key = (ref_make, stage)
    if key not in _CSPS:
        rp, pp = ref_make(), port_make()
        rb = {n: r.range for n, r in ref_analyze(rp).items()}
        pb = {n: r.range for n, r in analyze(pp).items()}
        _CSPS[key] = (REnc.encode_stage(rp, stage, rb),
                      PEnc.encode_stage(pp, stage, pb))
    return _CSPS[key]


# ---------------------------------------------------------------------------
# the kernels' contract, one box at a time
# ---------------------------------------------------------------------------

def np_max(a, b):
    return a if (a > b or a != a) else b


def np_min(a, b):
    return a if (a < b or a != a) else b


def np_fmax(a, b):
    return a if (a > b or b != b) else b


def np_fmin(a, b):
    return a if (a < b or b != b) else b


def div(a, b):
    """IEEE a / b (Python raises on a zero divisor)."""
    if b == 0.0:
        if a != a or a == 0.0:
            return math.nan
        return math.copysign(INF, a) * math.copysign(1.0, b)
    return a / b


def npow(x, n):
    """numpy's x ** n, as the engine takes it on the CPU."""
    with np.errstate(all="ignore"):
        return float((np.array([x]) ** int(n))[0])


def power(x, p):
    with np.errstate(all="ignore"):
        return float((np.array([x]) ** float(p))[0])


def odd(n):
    return n % 2 == 1


class Sites:
    """`_b_mul`'s NaN check by call: `used` fixed on every row, `rec`
    the calls that saw a NaN; a call is (round, def, which)."""

    def __init__(self, used, rec):
        self.used, self.rec, self.base = used, rec, None


class Walker:
    def __init__(self, prog):
        self.nd = prog.ndefs
        self.def_var = [int(i) for i in prog.def_var]
        self.opcode = [int(o) for o in prog.opcode]
        self.argv = [[int(a) for a in row] for row in prog.argv]
        self.argc = [[float(c) for c in row] for row in prog.argc]
        self.pow_n = [int(n) for n in prog.pow_n]
        self.cmp = [int(c) for c in prog.cmp]

    # -- transfer functions ------------------------------------------------
    @staticmethod
    def mul(alo, ahi, blo, bhi, s=None, which=0):
        p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
        s_ = ((p1 + p2) + p3) + p4
        fix = s_ != s_
        if s is not None:
            site = (s.base, which)
            if fix:
                s.rec.add(site)
            fix = fix or site in s.used
        if fix:
            p1 = 0.0 if (alo == 0.0 or blo == 0.0) else p1
            p2 = 0.0 if (alo == 0.0 or bhi == 0.0) else p2
            p3 = 0.0 if (ahi == 0.0 or blo == 0.0) else p3
            p4 = 0.0 if (ahi == 0.0 or bhi == 0.0) else p4
        return (np_min(np_min(p1, p2), np_min(p3, p4)),
                np_max(np_max(p1, p2), np_max(p3, p4)))

    def div_(self, alo, ahi, blo, bhi, s, which):
        straddle = blo <= 0.0 <= bhi
        lo, hi = self.mul(alo, ahi, div(1.0, bhi), div(1.0, blo), s, which)
        return (-INF, INF) if straddle else (lo, hi)

    @staticmethod
    def pow_(alo, ahi, n):
        if n == 0:
            return 1.0, 1.0
        l, h = npow(alo, n), npow(ahi, n)
        if odd(n):
            return l, h
        return (l if alo >= 0 else (h if ahi < 0 else 0.0),
                h if alo >= 0 else (l if ahi < 0 else np_max(l, h)))

    @staticmethod
    def cmp_(code, llo, lhi, rlo, rhi):
        if code == 0:
            return lhi < rlo, llo >= rhi
        if code == 1:
            return lhi <= rlo, llo > rhi
        if code == 2:
            return llo > rhi, lhi <= rlo
        return llo >= rhi, lhi < rlo

    def ext_div(self, vlo, vhi, blo, bhi, s, which):
        nz = blo > 0 or bhi < 0
        dlo, dhi = self.div_(vlo, vhi, blo, bhi, s, which)
        if nz:
            return dlo, dhi
        rlo, rhi = -INF, INF
        if blo == 0.0 and bhi > 0:
            if vlo > 0:
                rlo, rhi = div(vlo, bhi), INF
            if vhi < 0:
                rlo, rhi = -INF, div(vhi, bhi)
        if bhi == 0.0 and blo < 0:
            if vlo > 0:
                rlo, rhi = -INF, div(vlo, blo)
            if vhi < 0:
                rlo, rhi = div(vhi, blo), INF
        return rlo, rhi

    @staticmethod
    def root(x, n):
        ax = abs(x)
        r = ax if n == 1 else (math.sqrt(ax) if n == 2
                               else power(ax, 1.0 / n))
        return r if x > 0 else 0.0

    def arg(self, k, j, lo, hi):
        ix = self.argv[k][j]
        if ix >= 0:
            return lo[ix], hi[ix]
        c = self.argc[k][j]
        return c, c

    @staticmethod
    def meet(lo, hi, i, nlo, nhi, st):
        lo_c, hi_c = lo[i], hi[i]
        mlo, mhi = np_fmax(lo_c, nlo), np_fmin(hi_c, nhi)
        gap = mlo - mhi
        if gap > 0.0:
            slack = 1e-9 * np_max(1.0, np_max(abs(mlo), abs(mhi)))
            if gap <= slack and math.isfinite(mlo) and math.isfinite(mhi):
                mlo = mhi = 0.5 * (mlo + mhi)
            else:
                st[0] = False
        if mlo != lo_c or mhi != hi_c:
            st[1] = True
        lo[i], hi[i] = mlo, mhi

    # -- hc4 -----------------------------------------------------------------
    def forward(self, k, lo, hi, s):
        op = self.opcode[k]
        alo, ahi = self.arg(k, 0, lo, hi)
        if op == PEnc.OP_POW:
            return self.pow_(alo, ahi, self.pow_n[k])
        if op == PEnc.OP_ABS:
            return (alo if alo >= 0 else (-ahi if ahi <= 0 else 0.0),
                    ahi if alo >= 0 else (-alo if ahi <= 0
                                          else np_max(-alo, ahi)))
        if op == PEnc.OP_SQRT:
            return (math.sqrt(np_max(alo, 0.0)),
                    math.sqrt(np_max(ahi, 0.0)))
        blo, bhi = self.arg(k, 1, lo, hi)
        if op == PEnc.OP_ADD:
            return alo + blo, ahi + bhi
        if op == PEnc.OP_SUB:
            return alo - bhi, ahi - blo
        if op == PEnc.OP_MUL:
            return self.mul(alo, ahi, blo, bhi, s, 0)
        if op == PEnc.OP_DIV:
            return self.div_(alo, ahi, blo, bhi, s, 0)
        if op == PEnc.OP_MIN:
            return np_min(alo, blo), np_min(ahi, bhi)
        if op == PEnc.OP_MAX:
            return np_max(alo, blo), np_max(ahi, bhi)
        t, f = self.cmp_(self.cmp[k], alo, ahi, blo, bhi)
        tlo, thi = self.arg(k, 2, lo, hi)
        olo, ohi = self.arg(k, 3, lo, hi)
        return (tlo if t else (olo if f else np_min(tlo, olo)),
                thi if t else (ohi if f else np_max(thi, ohi)))

    def backward(self, k, lo, hi, s, st):
        i, op, argv = self.def_var[k], self.opcode[k], self.argv[k]
        vlo, vhi = lo[i], hi[i]
        alo, ahi = self.arg(k, 0, lo, hi)
        outs = []
        if op == PEnc.OP_POW:
            n = self.pow_n[k]
            if odd(n):
                rl = math.copysign(self.root(abs(vlo), n), vlo)
                rh = math.copysign(self.root(abs(vhi), n), vhi)
                outs = [(0, np_min(rl, rh), np_max(rl, rh))]
            elif n > 0:
                r = self.root(np_max(vhi, 0.0), n)
                rp = self.root(np_max(vlo, 0.0), n)
                outs = [(0, rp if alo >= 0 else -r,
                         r if alo >= 0 else (-rp if ahi <= 0 else r))]
        elif op == PEnc.OP_ABS:
            outs = [(0, np_max(vlo, 0.0) if alo >= 0 else -vhi,
                     vhi if alo >= 0 else
                     (-np_max(vlo, 0.0) if ahi <= 0 else vhi))]
        elif op == PEnc.OP_SQRT:
            outs = [(0, vlo * vlo if vlo > 0 else -INF, vhi * vhi)]
        else:
            blo, bhi = self.arg(k, 1, lo, hi)
            if op == PEnc.OP_SELECT:
                t, f = self.cmp_(self.cmp[k], alo, ahi, blo, bhi)
                outs = [(2, vlo if t else -INF, vhi if t else INF),
                        (3, vlo if f else -INF, vhi if f else INF)]
            elif op in (PEnc.OP_MIN, PEnc.OP_MAX):
                for slot, (xlo, xhi, ylo, yhi) in enumerate(
                        ((alo, ahi, blo, bhi), (blo, bhi, alo, ahi))):
                    if op == PEnc.OP_MIN:
                        l = vlo + 0.0
                        h = xhi if ylo <= vhi else np_min(xhi, vhi)
                    else:
                        h = vhi + 0.0
                        l = xlo if yhi >= vlo else np_max(xlo, vlo)
                    if l > h:
                        st[0] = False
                        l, h = -INF, INF
                    outs.append((slot, l, h))
            else:
                if argv[0] >= 0:
                    if op == PEnc.OP_ADD:
                        outs.append((0, vlo - bhi, vhi - blo))
                    elif op == PEnc.OP_SUB:
                        outs.append((0, vlo + blo, vhi + bhi))
                    elif op == PEnc.OP_MUL:
                        outs.append((0,) + self.ext_div(vlo, vhi, blo, bhi,
                                                        s, 1))
                    else:
                        outs.append((0,) + self.mul(vlo, vhi, blo, bhi,
                                                    s, 1))
                if argv[1] >= 0:
                    if op == PEnc.OP_ADD:
                        outs.append((1, vlo - ahi, vhi - alo))
                    elif op == PEnc.OP_SUB:
                        outs.append((1, alo - vhi, ahi - vlo))
                    elif op == PEnc.OP_MUL:
                        outs.append((1,) + self.ext_div(vlo, vhi, alo, ahi,
                                                        s, 2))
                    else:
                        outs.append((1,) + self.ext_div(alo, ahi, vlo, vhi,
                                                        s, 2))
        for slot, clo, chi in outs:
            ix = argv[slot]
            if ix >= 0:
                self.meet(lo, hi, ix, clo, chi, st)

    def round(self, lo, hi, r, s, st):
        for k in range(self.nd):
            s.base = (r, k)
            flo, fhi = self.forward(k, lo, hi, s)
            self.meet(lo, hi, self.def_var[k], flo, fhi, st)
        for k in range(self.nd - 1, -1, -1):
            s.base = (r, k)
            self.backward(k, lo, hi, s, st)

    def hc4(self, lo, hi, alive, rounds):
        """`smt_hc4_launch` on numpy (N, nvars) lo, hi in place: returns
        (alive, number of passes)."""
        back = (lo.tolist(), hi.tolist())
        rows = (lo.tolist(), hi.tolist())
        al = [bool(a) for a in alive]
        rec, ran = set(), 0
        for r in range(rounds):          # first pass: the stopping rule
            live_changed = False
            for b in range(len(al)):
                st = [al[b], False]
                self.round(rows[0][b], rows[1][b], r, Sites(set(), rec), st)
                al[b] = st[0]
                live_changed |= st[0] and st[1]
            ran = r + 1
            if not live_changed:
                break
        used, passes = set(), 1
        while rec != used:               # replays until the sites agree
            used, rec = rec, set()
            rows = ([list(x) for x in back[0]], [list(x) for x in back[1]])
            al = [bool(a) for a in alive]
            for b in range(len(al)):
                st = [al[b], False]
                for r in range(ran):
                    self.round(rows[0][b], rows[1][b], r, Sites(used, rec),
                               st)
                al[b] = st[0]
            passes += 1
        lo[...] = np.array(rows[0], np.float64).reshape(lo.shape)
        hi[...] = np.array(rows[1], np.float64).reshape(hi.shape)
        return np.array(al, bool), passes

    # -- gradients -----------------------------------------------------------
    def gradients(self, lo, hi, root):
        """`smt_grad_launch`: a box skips a def where its own adjoint is
        zero."""
        N, nv = lo.shape
        glo, ghi = np.zeros((N, nv)), np.zeros((N, nv))
        for b in range(N):
            L, H = lo[b].tolist(), hi[b].tolist()
            gl_, gh_ = [0.0] * nv, [0.0] * nv
            gl_[root] = gh_[root] = 1.0
            for k in range(self.nd - 1, -1, -1):
                i, op, argv = self.def_var[k], self.opcode[k], self.argv[k]
                gl, gh = gl_[i], gh_[i]
                if gl == 0.0 and gh == 0.0:
                    continue
                alo, ahi = self.arg(k, 0, L, H)
                if op == PEnc.OP_POW:
                    n = self.pow_n[k]
                    if n == 0:
                        parts = [(0.0, 0.0)]
                    else:
                        pl, ph = self.pow_(alo, ahi, n - 1)
                        parts = [(n * pl, n * ph)]
                elif op == PEnc.OP_ABS:
                    parts = [(1.0 if alo >= 0 else -1.0,
                              1.0 if alo >= 0 else
                              (-1.0 if ahi <= 0 else 1.0))]
                elif op == PEnc.OP_SQRT:
                    pos = alo > 0
                    parts = [(0.5 * div(1.0, math.sqrt(np_max(ahi, 1e-300)))
                              if pos else 0.0,
                              0.5 * div(1.0, math.sqrt(alo)) if pos
                              else INF)]
                elif op == PEnc.OP_ADD:
                    parts = [(1.0, 1.0), (1.0, 1.0)]
                elif op == PEnc.OP_SUB:
                    parts = [(1.0, 1.0), (-1.0, -1.0)]
                elif op in (PEnc.OP_MIN, PEnc.OP_MAX):
                    parts = [(0.0, 1.0), (0.0, 1.0)]
                else:
                    blo, bhi = self.arg(k, 1, L, H)
                    if op == PEnc.OP_MUL:
                        parts = [(blo, bhi), (alo, ahi)]
                    elif op == PEnc.OP_DIV:
                        nz = blo > 0 or bhi < 0
                        ivlo = div(1.0, bhi if nz else 1.0)
                        ivhi = div(1.0, blo if nz else 1.0)
                        i2 = self.pow_(ivlo, ivhi, 2)
                        q0 = self.mul(-ahi, -alo, *i2)
                        parts = [(ivlo, ivhi) if nz else (-INF, INF),
                                 q0 if nz else (-INF, INF)]
                    else:
                        t, f = self.cmp_(self.cmp[k], alo, ahi, blo, bhi)
                        und = not t and not f
                        z = (-INF, INF) if und else (0.0, 0.0)
                        parts = [z, z, (1.0 if t else 0.0,
                                        1.0 if t or und else 0.0),
                                 (1.0 if f else 0.0,
                                  1.0 if f or und else 0.0)]
                for slot, (pl, ph) in enumerate(parts):
                    ix = argv[slot]
                    if ix < 0:
                        continue
                    dlo, dhi = self.mul(gl, gh, pl, ph)
                    nlo, nhi = gl_[ix] + dlo, gh_[ix] + dhi
                    gl_[ix] = -INF if nlo != nlo else nlo
                    gh_[ix] = INF if nhi != nhi else nhi
            glo[b], ghi[b] = gl_, gh_
        return glo, ghi


# ---------------------------------------------------------------------------
# frontiers and comparisons
# ---------------------------------------------------------------------------

def _same_bits(want, got, label):
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    assert w.shape == g.shape, label
    wn, gn = np.isnan(w), np.isnan(g)
    assert np.array_equal(wn, gn), label
    assert np.array_equal(w[~wn].view(np.int64), g[~gn].view(np.int64)), \
        label


def _plain_hc4(prog, lo, hi, alive, rounds):
    dp = PEnc.device_program(prog, "cpu")
    tlo, thi = torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())
    a = PS._hc4_rows(dp, tlo, thi, torch.from_numpy(alive.copy()), rounds)
    return tlo.numpy(), thi.numpy(), a.numpy()


def _reference_hc4(rprog, lo, hi, alive, rounds):
    rlo, rhi = lo.copy(), hi.copy()
    a = RS.hc4_batch(rprog, rlo, rhi, alive.copy(), rounds)
    return rlo, rhi, np.asarray(a)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pid,ref_make,port_make,stage", STAGES, ids=IDS)
def test_packed_table_is_the_program(pid, ref_make, port_make, stage):
    """The walk kernels' op table on the device: the `Program`'s arrays
    field by field, integers as int32, contiguous."""
    _, (csp, _) = _csps(ref_make, port_make, stage)
    prog = PEnc.compile_csp(csp)
    dp = PEnc.device_program(prog, "cpu")
    for name in ("def_var", "opcode", "argv", "pow_n", "cmp"):
        t = getattr(dp, name)
        assert t.dtype == torch.int32 and t.is_contiguous(), name
        assert np.array_equal(t.numpy(), getattr(prog, name)), name
    assert dp.argc.dtype == torch.float64 and dp.argc.is_contiguous()
    _same_bits(prog.argc, dp.argc.numpy(), "argc")
    assert dp.argv.shape == (prog.ndefs, 4)
    assert dp.frozen_mask.dtype == torch.bool
    assert np.array_equal(dp.frozen_mask.numpy(), prog.frozen)
    assert np.array_equal(dp.base.numpy(), prog.base)
    # the Python rows the plain versions walk are the same table
    assert [r[:2] for r in dp.rows] == list(zip(prog.def_var.tolist(),
                                                prog.opcode.tolist()))


# frontiers of 24 boxes; hcd det (259 variables) with 8, as the walker is
# Python; 6 rounds as `_group_step` runs them, and the 2 after the affine
# sweep
CASES = [(pid, rm, pm, st, seed, rounds)
         for (pid, rm, pm, st) in STAGES for seed, rounds in ((0, 6), (1, 2))]
CASE_IDS = [f"{p}-{s}-seed{seed}-r{r}" for p, _, _, s, seed, r in CASES]


@pytest.mark.parametrize("pid,ref_make,port_make,stage,seed,rounds", CASES,
                         ids=CASE_IDS)
def test_hc4_walker_equals_the_plain_version_and_the_reference(
        pid, ref_make, port_make, stage, seed, rounds):
    """Every row, dead ones included, every bit, and the alive mask; the
    JAX package's numpy engine on its own CSP gives the same bits."""
    (rcsp, _), (csp, _) = _csps(ref_make, port_make, stage)
    prog, rprog = PEnc.compile_csp(csp), REnc.compile_csp(rcsp)
    n = 8 if stage == "det" else 24
    lo, hi = frontier(prog, seed, n)
    alive = np.random.default_rng(seed + 100).random(n) < 0.9
    plo, phi, palive = _plain_hc4(prog, lo, hi, alive, rounds)
    rlo, rhi, ralive = _reference_hc4(rprog, lo, hi, alive, rounds)
    wlo, whi = lo.copy(), hi.copy()
    walive, _ = Walker(prog).hc4(wlo, whi, alive, rounds)
    assert np.array_equal(walive, palive) and np.array_equal(walive, ralive)
    for label, w, p, r in (("lo", wlo, plo, rlo), ("hi", whi, phi, rhi)):
        _same_bits(p, w, label)
        _same_bits(r, w, label)


@pytest.mark.parametrize("pid,ref_make,port_make,stage", STAGES, ids=IDS)
def test_grad_walker_equals_the_plain_version_and_the_reference(
        pid, ref_make, port_make, stage):
    (rcsp, rroot), (csp, root) = _csps(ref_make, port_make, stage)
    prog, rprog = PEnc.compile_csp(csp), REnc.compile_csp(rcsp)
    lo, hi = frontier(prog, 3, 8 if stage == "det" else 24)
    dp = PEnc.device_program(prog, "cpu")
    plo, phi = PS._gradients_rows(dp, prog.nvars, torch.from_numpy(lo),
                                  torch.from_numpy(hi), root)
    rlo, rhi = RS.gradients_batch(rprog, lo.copy(), hi.copy(), rroot)
    wlo, whi = Walker(prog).gradients(lo, hi, root)
    for label, w, p, r in (("glo", wlo, plo.numpy(), rlo),
                           ("ghi", whi, phi.numpy(), rhi)):
        _same_bits(p, w, label)
        _same_bits(r, w, label)
    # every gradient entry that is zero is +0: the sign of a zero term
    # never reaches a sum, which is why the kernel may skip a def on its
    # own box's zero adjoint
    assert not np.signbit(wlo[wlo == 0.0]).any()
    assert not np.signbit(whi[whi == 0.0]).any()


def _two_box_mul():
    """x2 = x0 * x1 as a one-def CSP: box A gives x2's upper bound -0
    alone, and +0 beside box B, whose product holds 0 * inf."""
    from repro_torch.core.interval import Interval
    from repro_torch.smt.encoder import CSP, Def, VAR
    csp = CSP()
    top = Interval(-INF, INF)
    csp.new_var("x0", top, "input")
    csp.new_var("x1", top, "input")
    csp.new_var("x2", top, "aux", Def("*", ((VAR, 0), (VAR, 1))))
    prog = PEnc.compile_csp(csp)
    a = ([0.0, -3.0, -5.0], [2.0, -1.0, 5.0])     # [0, 2] * [-3, -1]
    b = ([0.0, 1.0, -5.0], [2.0, INF, 5.0])       # 0 * inf
    return prog, a, b


def test_the_nan_check_changes_rows_without_a_nan_and_the_walk_copies_it():
    """`_b_mul`'s NaN check fixes every row once one row's products hold
    a NaN: box A's product bound is -0 alone and +0 beside box B.  The
    walk replays the call with the NaN check fixed on every row, and
    gives both bits."""
    prog, a, b = _two_box_mul()
    got = {}
    for rows in ((a,), (a, b)):
        lo = np.array([r[0] for r in rows])
        hi = np.array([r[1] for r in rows])
        alive = np.ones(len(rows), bool)
        plo, phi, palive = _plain_hc4(prog, lo, hi, alive, 1)
        wlo, whi = lo.copy(), hi.copy()
        walive, passes = Walker(prog).hc4(wlo, whi, alive, 1)
        assert np.array_equal(walive, palive)
        _same_bits(plo, wlo, "lo")
        _same_bits(phi, whi, "hi")
        got[len(rows)] = (whi[0, 2], passes)
    assert got[1][0] == 0.0 and np.signbit(got[1][0])
    assert got[2][0] == 0.0 and not np.signbit(got[2][0])
    assert got[2][1] == 2           # recorded, then replayed once


def test_dead_rows_are_the_plain_versions_too():
    """Boxes that die in the first round beside boxes that keep changing:
    the plain version walks the dead ones on, round after round, and the
    walk does the same, so every bound of a dead row is equal too."""
    _, (csp, _) = _csps(hcd.build, thcd.build, "trace")
    prog = PEnc.compile_csp(csp)
    lo, hi = frontier(prog, 11, 24)
    alive = np.ones(24, bool)
    plo, phi, palive = _plain_hc4(prog, lo, hi, alive, 6)
    wlo, whi = lo.copy(), hi.copy()
    walive, _ = Walker(prog).hc4(wlo, whi, alive, 6)
    assert np.array_equal(walive, palive)
    assert 0 < (~palive).sum() < 24             # dead and live rows both
    dead = ~palive
    _same_bits(plo[dead], wlo[dead], "dead lo")
    _same_bits(phi[dead], whi[dead], "dead hi")
    # the rows that died in the first round kept changing after it, as
    # the plain version walks them on
    lo1, hi1 = lo.copy(), hi.copy()
    a1, _ = Walker(prog).hc4(lo1, hi1, alive, 1)
    moved = [not (np.array_equal(lo1[r], wlo[r], equal_nan=True) and
                  np.array_equal(hi1[r], whi[r], equal_nan=True))
             for r in np.nonzero(~a1)[0]]
    assert any(moved)


def test_hc4_rows_and_gradients_rows_dispatch_by_device():
    """CPU tensors take the plain version and launch nothing; any other
    device goes to the kernel, which raises where it cannot run: there is
    no fallback to the plain version."""
    _, (csp, root) = _csps(usm.build, tusm.build, "sharpen")
    prog = PEnc.compile_csp(csp)
    lo, hi = frontier(prog, 0, 16)
    before = dict(W.LAUNCHES)
    _plain_hc4(prog, lo, hi, np.ones(16, bool), 6)
    PS.gradients_batch(prog, torch.from_numpy(lo), torch.from_numpy(hi),
                       root)
    assert W.LAUNCHES == before
    dp = PEnc.device_program(prog, "cpu")
    meta = torch.empty((16, prog.nvars), dtype=torch.float64, device="meta")
    alive = torch.ones(16, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS._hc4_rows(dp, meta, meta.clone(), alive, 6)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS._gradients_rows(dp, prog.nvars, meta, meta.clone(), root)
    assert W.LAUNCHES == before


def test_the_walk_source_builds_with_the_kernels():
    """`smt_walk.cu` is one of the sources `_build` compiles, for sm_90a
    with no fma contraction, and names each C entry point it binds."""
    src = _build.SOURCES["smt_walk"]
    assert src.name == "smt_walk.cu" and src.exists()
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    text = src.read_text()
    for fn in _build.SIGNATURES["smt_walk"]:
        assert f'extern "C" int {fn}(' in text, fn
    assert "__fma" not in text and "fma(" not in text
    assert _build.library_path("smt_walk").parent == _build.BUILD_DIR
