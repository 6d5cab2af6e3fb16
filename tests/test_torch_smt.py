"""The port's SMT range analysis against the JAX package's.

`repro_torch.smt` (the encoder, the scalar and the batched engines, the
dichotomic tightening, `analyze_smt`), its two domains and the three SMT
analysis passes must give the reference's answers on the CPU: the same
CSPs and op tables, the same verdicts, witnesses and node counts, and
the same ranges, bit for bit.  Tolerance 0 throughout.  Every run is
deadline-free (``time_budget_s=math.inf``, deadlines of ``math.inf``)
under node budgets small enough to finish, so no case depends on how
long anything takes; the one zero-budget case is deterministic (every
stage keeps its seed).  Random inputs come from
`numpy.random.default_rng` seeds; tests that count memo hits clear the
port's memo first.  Cases that need a reference run of whole `hcd` or
`of` (tens of seconds on the CPU) are left to `chip_smoke.py`.
"""
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

import repro.analysis as RA
import repro.smt as RSMT
import repro_torch.analysis as PA
import repro_torch.smt as PSMT
from repro.core.range_analysis import analyze as ref_analyze
from repro.pipelines import dus, hcd, optical_flow, usm
from repro.smt import encoder as REnc
from repro.smt import optimize as ROpt
from repro.smt import solver as RS
from repro_torch import obs
from repro_torch.core import absval
from repro_torch.core.range_analysis import analyze
from repro_torch.pipelines import dus as tdus
from repro_torch.pipelines import hcd as thcd
from repro_torch.pipelines import optical_flow as tof
from repro_torch.pipelines import usm as tusm
from repro_torch.smt import encoder as PEnc
from repro_torch.smt import optimize as POpt
from repro_torch.smt import solver as PS
from _torch_threads import one_torch_thread  # noqa: F401

INF = math.inf
CPU = torch.device("cpu")

# the reference's differential stages (tests/test_smt.py `_DIFF_STAGES`):
# (id, reference builder, port builder, stage)
DIFF = [
    ("usm", usm.build, tusm.build, "sharpen"),
    ("usm", usm.build, tusm.build, "masked"),
    ("dus", dus.build, tdus.build, "Uy"),
    ("dus", dus.build, tdus.build, "Dy"),
    ("dus_ext", dus.build_extended, tdus.build_extended, "band"),
    ("hcd", hcd.build, thcd.build, "Ixy"),
    ("hcd", hcd.build, thcd.build, "trace"),
    ("of", lambda: optical_flow.build(n_iters=1),
     lambda: tof.build(n_iters=1), "Denom"),
    ("of_pyr", lambda: optical_flow.build_pyramid(n_iters=1),
     lambda: tof.build_pyramid(n_iters=1), "cVx0"),
    ("of_pyr", lambda: optical_flow.build_pyramid(n_iters=1),
     lambda: tof.build_pyramid(n_iters=1), "Vx1"),
]
DIFF_IDS = [f"{p}-{s}" for p, _, _, s in DIFF]

# the reference's phase-split differential stages (tests/test_phase_split.py)
PHASE = [
    ("dus", dus.build, tdus.build, "Uy"),
    ("dus_ext", dus.build_extended, tdus.build_extended, "res"),
    ("of_pyr", lambda: optical_flow.build_pyramid(n_iters=1),
     lambda: tof.build_pyramid(n_iters=1), "cDenom"),
]
PHASE_IDS = [f"{p}-{s}" for p, _, _, s in PHASE]

WHOLE = {"usm": (usm.build, tusm.build), "dus": (dus.build, tdus.build),
         "dus_ext": (dus.build_extended, tdus.build_extended)}
QUERIES = ((1.5, "ge"), (0.5, "ge"), (1.5, "le"), (0.5, "le"))


@pytest.fixture
def fresh():
    PA.clear_memo()
    RA.clear_memo()
    obs.reset_warn_once()
    yield
    PA.clear_memo()


def _bounds(pipe, analyze_fn):
    return {n: r.range for n, r in analyze_fn(pipe).items()}


def _pair(ref_make, port_make, stage):
    """The reference's and the port's blind CSP of `stage`, and its seed."""
    rp, pp = ref_make(), port_make()
    rb, pb = _bounds(rp, ref_analyze), _bounds(pp, analyze)
    rcsp, rroot = REnc.encode_stage(rp, stage, rb)
    pcsp, proot = PEnc.encode_stage(pp, stage, pb)
    return (rcsp, rroot), (pcsp, proot), rb[stage]


def _phase_pair(ref_make, port_make, stage):
    rp, pp = ref_make(), port_make()
    rb, pb = _bounds(rp, ref_analyze), _bounds(pp, analyze)
    return (REnc.encode_stage_phases(rp, stage, rb),
            PEnc.encode_stage_phases(pp, stage, pb), rb[stage])


def _csp_fields(csp):
    return (csp.names, csp.kinds, [(iv.lo, iv.hi) for iv in csp.init],
            [None if d is None else dataclasses.astuple(d)
             for d in csp.defs],
            csp.is_linear(), sorted(csp.cond_dependent_vars()),
            csp.base_vars())


def _same_program(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _verdict(v):
    return (v.status, v.witness, v.nodes)


def _ranges(res):
    return {n: (r.range.lo, r.range.hi, r.alpha, r.signed)
            for n, r in res.items()}


def _bits(x):
    """f64 values as comparable bits: the sign of a zero counts, the
    payload of a NaN does not."""
    a = np.asarray(x, np.float64)
    return np.where(np.isnan(a), 0x7ff8000000000000, a.view(np.int64)), \
        np.isnan(a)


def _same_bits(want, got):
    w, wn = _bits(want)
    g, gn = _bits(got)
    assert np.array_equal(wn, gn) and np.array_equal(w, g)


# ---------------------------------------------------------------------------
# the numpy semantics the batched engine reproduces
# ---------------------------------------------------------------------------

SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5,
                    -3.75, 1e-310, -1e-310, 1e300, -1e300, 7.0])


def _specials(rng, n):
    return np.where(rng.random(n) < 0.6, rng.choice(SPECIAL, n),
                    rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))


@pytest.mark.parametrize("n", [1, 3, 17, 100])
def test_numpy_minmax_rules(n):
    rng = np.random.default_rng(n)
    a, b = _specials(rng, n), _specials(rng, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for ref, port in ((np.maximum, PS._maximum), (np.minimum, PS._minimum),
                      (np.fmax, PS._fmax), (np.fmin, PS._fmin)):
        _same_bits(ref(a, b), port(ta, tb).numpy())
        _same_bits(ref(a, 0.0), port(ta, 0.0).numpy())
        _same_bits(ref(a, -0.0), port(ta, -0.0).numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 16, 63, 128, 129, 200, 300,
                               1000])
def test_pairwise_rowsum_is_numpy_s(n):
    rng = np.random.default_rng(n)
    for rows in (1, 5, 64):
        x = np.abs(rng.standard_normal((rows, n))
                   * 10.0 ** rng.integers(-8, 8, (rows, n)))
        x[rng.random((rows, n)) < 0.1] = 0.0
        _same_bits(x.sum(axis=1), PS._pw_rowsum(torch.from_numpy(x)).numpy())
        # a column of an (N, nvars, nbase) coefficient tensor, as the
        # affine sweep reads it
        k3 = np.abs(rng.standard_normal((rows, 3, n)))
        _same_bits(np.abs(k3[:, 1]).sum(axis=1),
                   PS._pw_rowsum(torch.from_numpy(k3)[:, 1].abs()).numpy())


def test_argmax_rows_is_numpy_s():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (200, 9)).astype(np.float64)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[rng.random(x.shape) < 0.05] = np.inf
    assert np.array_equal(np.argmax(x, axis=1),
                          PS._argmax_rows(torch.from_numpy(x)).numpy())


def test_transfer_functions_are_numpy_s():
    """Each batched transfer function against the reference's, on columns
    full of zeros of both signs, infinities, NaNs and subnormals."""
    rng = np.random.default_rng(7)
    n = 400
    c = [_specials(rng, n) for _ in range(4)]
    lo = [np.minimum(c[0], c[1]), np.minimum(c[2], c[3])]
    hi = [np.maximum(c[0], c[1]), np.maximum(c[2], c[3])]
    t = [torch.from_numpy(a) for a in lo + hi]
    tlo, thi = t[:2], t[2:]
    with np.errstate(all="ignore"):
        pairs = [
            (RS._b_mul(lo[0], hi[0], lo[1], hi[1]),
             PS._b_mul(tlo[0], thi[0], tlo[1], thi[1])),
            (RS._b_div(lo[0], hi[0], lo[1], hi[1]),
             PS._b_div(tlo[0], thi[0], tlo[1], thi[1])),
            (RS._b_ext_div(lo[0], hi[0], lo[1], hi[1]),
             PS._b_ext_div(tlo[0], thi[0], tlo[1], thi[1])),
            (RS._b_pow(lo[0], hi[0], 2), PS._b_pow(tlo[0], thi[0], 2)),
            (RS._b_pow(lo[0], hi[0], 1), PS._b_pow(tlo[0], thi[0], 1)),
            (RS._b_pow(lo[0], hi[0], 0), PS._b_pow(tlo[0], thi[0], 0)),
            (RS._b_abs(lo[0], hi[0]), PS._b_abs(tlo[0], thi[0])),
            (RS._b_sqrt(lo[0], hi[0]), PS._b_sqrt(tlo[0], thi[0])),
            ((RS._b_root(c[0], 2), RS._b_root(c[0], 1)),
             (PS._b_root(torch.from_numpy(c[0]), 2),
              PS._b_root(torch.from_numpy(c[0]), 1))),
            (RS._b_meet(lo[0], hi[0], lo[1], hi[1]),
             PS._b_meet(tlo[0], thi[0], tlo[1], thi[1])),
            (RS._b_mid(lo[0], hi[0]), (PS._b_mid(tlo[0], thi[0]),)),
        ]
    for want, got in pairs:
        if not isinstance(want, tuple):
            want = (want,)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _same_bits(w, g.numpy())


# ---------------------------------------------------------------------------
# encoder: CSPs and op tables field by field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pid,ref_make,port_make,stage", DIFF, ids=DIFF_IDS)
def test_csp_and_program_equal_the_reference(pid, ref_make, port_make,
                                             stage):
    (rcsp, rroot), (pcsp, proot), _ = _pair(ref_make, port_make, stage)
    assert proot == rroot
    assert _csp_fields(pcsp) == _csp_fields(rcsp)
    prog = PEnc.compile_csp(pcsp)
    assert PEnc.compile_csp(pcsp) is prog          # cached on the CSP
    _same_program(REnc.compile_csp(rcsp), prog)
    dp = PEnc.device_program(prog, "cpu")
    assert PEnc.device_program(prog, CPU) is dp    # cached per device
    assert dp.base_list == dp.base.tolist() == prog.base.tolist()
    assert [r[0] for r in dp.rows] == prog.def_var.tolist()


@pytest.mark.parametrize("pid,ref_make,port_make,stage", PHASE,
                         ids=PHASE_IDS)
def test_phase_csps_equal_the_reference(pid, ref_make, port_make, stage):
    rp, pp = ref_make(), port_make()
    assert PEnc.sampling_lattice(pp, stage) == REnc.sampling_lattice(rp,
                                                                     stage)
    assert PEnc.closure_is_sampled(pp, stage) == \
        REnc.closure_is_sampled(rp, stage)
    want, got, _ = _phase_pair(ref_make, port_make, stage)
    assert len(got) == len(want) >= 1
    for (rc, rr), (pc, pr) in zip(want, got):
        assert pr == rr and _csp_fields(pc) == _csp_fields(rc)
        _same_program(REnc.compile_csp(rc), PEnc.compile_csp(pc))


# ---------------------------------------------------------------------------
# solvers: verdicts, witnesses and node counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pid,ref_make,port_make,stage", DIFF, ids=DIFF_IDS)
def test_decide_equals_the_reference(pid, ref_make, port_make, stage):
    (rcsp, rroot), (pcsp, proot), seed = _pair(ref_make, port_make, stage)
    for frac, sense in QUERIES:
        t = (seed.hi if sense == "ge" else seed.lo) * frac
        want = RS.decide_scalar(rcsp, rroot, sense, t, RS.BPBudget(48, 6))
        got = PS.decide_scalar(pcsp, proot, sense, t, PS.BPBudget(48, 6))
        assert _verdict(got) == _verdict(want), ("scalar", sense, t)
        want = RS.decide(rcsp, rroot, sense, t, RS.BPBudget(48, 6))
        got = PS.decide(pcsp, proot, sense, t, PS.BPBudget(48, 6),
                        device="cpu")
        assert _verdict(got) == _verdict(want), ("batched", sense, t)


@pytest.mark.parametrize("pid,ref_make,port_make,stage", PHASE,
                         ids=PHASE_IDS)
def test_decide_multi_equals_the_reference(pid, ref_make, port_make, stage):
    want_e, got_e, seed = _phase_pair(ref_make, port_make, stage)
    for frac, sense in QUERIES:
        t = (seed.hi if sense == "ge" else seed.lo) * frac
        want = RS.decide_scalar_multi(want_e, sense, t, RS.BPBudget(48, 6))
        got = PS.decide_scalar_multi(got_e, sense, t, PS.BPBudget(48, 6))
        assert _verdict(got) == _verdict(want), ("scalar", sense, t)
        want = RS.decide_multi(want_e, sense, t, RS.BPBudget(48, 6))
        got = PS.decide_multi(got_e, sense, t, PS.BPBudget(48, 6),
                              device="cpu")
        assert _verdict(got) == _verdict(want), ("batched", sense, t)


def test_a_spent_budget_equals_the_reference():
    """A hard query that spends the whole node budget through wide
    batches (not the narrow scalar path): UNKNOWN, the same best
    witness, every node counted."""
    (rcsp, rroot), (pcsp, proot), _ = _pair(hcd.build, thcd.build, "det")
    want = RS.decide(rcsp, rroot, "ge", 2.0 ** 30, RS.BPBudget(96, 6))
    got = PS.decide(pcsp, proot, "ge", 2.0 ** 30, PS.BPBudget(96, 6),
                    device="cpu")
    assert want.status == RS.UNKNOWN and want.nodes == 96
    assert _verdict(got) == _verdict(want)


@pytest.mark.parametrize("pid,ref_make,port_make,stage",
                         [DIFF[6], DIFF[8]], ids=[DIFF_IDS[6], DIFF_IDS[8]])
def test_batched_sweeps_equal_the_reference_bit_for_bit(pid, ref_make,
                                                        port_make, stage):
    """hc4, the affine sweep, the gradients, the witness points and the
    monotone fix on a seeded frontier of random sub-boxes, every bit of
    every bound (the sign of a zero included)."""
    (rcsp, rroot), (pcsp, proot), _ = _pair(ref_make, port_make, stage)
    rprog, pprog = REnc.compile_csp(rcsp), PEnc.compile_csp(pcsp)
    rng = np.random.default_rng(11)
    N = 40
    lo0 = np.where(np.isfinite(rprog.init_lo), rprog.init_lo, -1e3)
    hi0 = np.where(np.isfinite(rprog.init_hi), rprog.init_hi, 1e3)
    u = np.sort(rng.random((2, N, rprog.nvars)), axis=0)
    lo = lo0 + (hi0 - lo0) * u[0]
    hi = lo0 + (hi0 - lo0) * u[1]
    lo[:, :] = np.where(np.isfinite(rprog.init_lo), lo, rprog.init_lo)
    hi[:, :] = np.where(np.isfinite(rprog.init_hi), hi, rprog.init_hi)
    tlo, thi = torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())
    alive = RS.hc4_batch(rprog, lo, hi, np.ones(N, bool), 6)
    talive = PS.hc4_batch(pprog, tlo, thi, torch.ones(N, dtype=torch.bool), 6)
    assert np.array_equal(alive, talive.numpy())
    _same_bits(lo, tlo.numpy())
    _same_bits(hi, thi.numpy())
    alive = RS.affine_batch(rprog, lo, hi, alive)
    talive = PS.affine_batch(pprog, tlo, thi, talive)
    assert np.array_equal(alive, talive.numpy())
    _same_bits(lo, tlo.numpy())
    _same_bits(hi, thi.numpy())
    glo, ghi = RS.gradients_batch(rprog, lo, hi, rroot)
    tglo, tghi = PS.gradients_batch(pprog, tlo, thi, proot)
    _same_bits(glo, tglo.numpy())
    _same_bits(ghi, tghi.numpy())
    dp = PEnc.device_program(pprog, CPU)
    for maximize in (True, False):
        with np.errstate(all="ignore"):
            want = RS._witness_batch(rprog, lo, hi, alive, rroot, maximize,
                                     0.0, glo, ghi, None)
        got = PS._witness_batch(dp, pprog.nvars, tlo, thi, talive, proot,
                                maximize, 0.0, tglo, tghi, None)
        assert got == want
    want = RS._split_batch(rprog, lo, hi, glo, ghi, alive)
    got = PS._split_batch(dp, tlo, thi, tglo, tghi, talive)
    for w, g in zip(want, got):
        _same_bits(w.astype(np.float64), g.double().numpy())
    fixed = RS._monotone_fix_batch(rprog, lo, hi, glo, ghi, True, alive)
    tfixed = PS._monotone_fix_batch(dp, tlo, thi, tglo, tghi, True, talive)
    assert np.array_equal(fixed, tfixed.numpy())
    _same_bits(lo, tlo.numpy())
    _same_bits(hi, thi.numpy())
    pts = np.zeros((N, rprog.nvars))
    pts[:, rprog.base] = 0.5 * (lo + hi)[:, rprog.base]
    tpts = torch.from_numpy(pts.copy())
    _same_bits(RS.concrete_batch(rprog, pts),
               PS.concrete_batch(pprog, tpts).numpy())


# ---------------------------------------------------------------------------
# dichotomic tightening and the whole-pipeline analysis
# ---------------------------------------------------------------------------

SMALL = dict(max_nodes=64, work_budget=4096)


def _configs(engine, **kw):
    return (RSMT.SMTConfig(engine=engine, time_budget_s=INF, **kw),
            PSMT.SMTConfig(engine=engine, time_budget_s=INF, **kw))


@pytest.mark.parametrize("engine", ["batched", "scalar"])
@pytest.mark.parametrize("name", ["usm", "dus", "dus_ext"])
def test_analyze_smt_equals_the_reference(name, engine):
    ref_make, port_make = WHOLE[name]
    # usm's batched search at the default node budgets takes seconds;
    # the others run at the defaults
    kw = SMALL if (name, engine) == ("usm", "batched") else {}
    rcfg, pcfg = _configs(engine, **kw)
    rdiag, pdiag = {}, {}
    want = RSMT.analyze_smt(ref_make(), config=rcfg, diagnostics=rdiag)
    got = PSMT.analyze_smt(port_make(), config=pcfg, diagnostics=pdiag,
                           device="cpu")
    assert _ranges(got) == _ranges(want)
    assert pdiag == rdiag == {"budget_exhausted": []}


TIGHTEN = [
    ("batched", "hcd", hcd.build, thcd.build, "Ixy", {}),
    ("scalar", "hcd", hcd.build, thcd.build, "Ixy", {}),
    ("batched", "of", optical_flow.build, tof.build, "Denom", {}),
    ("scalar", "of", optical_flow.build, tof.build, "Denom", {}),
    # of_pyramid's cVx0 through the batched engine takes the reference
    # 6-9 s here, so the card tests hold the port's batched engine on it
    # (card against CPU); the scalar engine at half its work budget (9
    # nodes a query on this 226-variable CSP) takes the reference about
    # 1.5 s and still tightens [-216.75, 216.75] to [-16, 16]
    ("scalar", "of_pyramid", optical_flow.build_pyramid,
     tof.build_pyramid, "cVx0", {"scalar_work_budget": 2048}),
]


@pytest.mark.parametrize("engine,pid,ref_make,port_make,stage,extra",
                         TIGHTEN, ids=[f"{e}-{p}-{s}" for e, p, _, _, s, _
                                       in TIGHTEN])
def test_tighten_stage_phases_equals_the_reference(engine, pid, ref_make,
                                                   port_make, stage, extra):
    """One stage's tightening as `analyze_smt` encodes it (phase-split
    where its closure is sampled), deadline-free."""
    rp, pp = ref_make(), port_make()
    rb, pb = _bounds(rp, ref_analyze), _bounds(pp, analyze)
    want_e = (REnc.encode_stage_phases(rp, stage, rb)
              if REnc.closure_is_sampled(rp, stage) else None) or \
        [REnc.encode_stage(rp, stage, rb)]
    got_e = (PEnc.encode_stage_phases(pp, stage, pb)
             if PEnc.closure_is_sampled(pp, stage) else None) or \
        [PEnc.encode_stage(pp, stage, pb)]
    assert len(got_e) == len(want_e)
    rcfg, pcfg = _configs(engine, **SMALL, **extra)
    want = ROpt.tighten_stage_phases(want_e, rb[stage], rcfg, INF)
    got = POpt.tighten_stage_phases(got_e, pb[stage], pcfg, INF,
                                    device="cpu")
    assert (got.lo, got.hi) == (want.lo, want.hi)


def test_phase_split_sub_ranges_equal_the_reference():
    rcfg, pcfg = _configs("batched")
    want, got = {}, {}
    wres = RSMT.analyze_smt(dus.build(), config=rcfg, collect_phases=want)
    gres = PSMT.analyze_smt(tdus.build(), config=pcfg, collect_phases=got,
                            device="cpu")
    assert _ranges(gres) == _ranges(wres)
    assert set(got) == set(want) and want
    for stage, (lat, rmap) in want.items():
        glat, gmap = got[stage]
        assert glat == lat
        assert {r: (iv.lo, iv.hi) for r, iv in gmap.items()} == \
            {r: (iv.lo, iv.hi) for r, iv in rmap.items()}


def test_zero_budget_keeps_every_seed_as_the_reference(fresh):
    rcfg = RSMT.SMTConfig(time_budget_s=0.0)
    pcfg = PSMT.SMTConfig(time_budget_s=0.0)
    rdiag, pdiag = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RSMT.BudgetExhaustedWarning)
        want = RSMT.analyze_smt(usm.build(), config=rcfg, diagnostics=rdiag)
    with obs.tracing() as tr:
        with pytest.warns(PSMT.BudgetExhaustedWarning,
                          match="kept its interval seed"):
            got = PSMT.analyze_smt(tusm.build(), config=pcfg,
                                   diagnostics=pdiag, device="cpu")
    assert _ranges(got) == _ranges(want) == _ranges(analyze(tusm.build()))
    assert pdiag == rdiag and pdiag["budget_exhausted"]
    assert [e["attrs"]["stage"] for e in tr.events()
            if e["name"] == "smt.budget_exhausted"] == \
        pdiag["budget_exhausted"]
    # the provenance note of the pass, in the plan's JSON
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RSMT.BudgetExhaustedWarning)
        warnings.simplefilter("ignore", PSMT.BudgetExhaustedWarning)
        wplan = RA.run_plan(usm.build(), [RA.make_pass("smt", config=rcfg)])
        gplan = PA.run_plan(tusm.build(), [PA.make_pass(
            "smt", config=pcfg, device="cpu")])
    assert gplan.to_json() == wplan.to_json()
    assert "budget-exhausted (seed kept)" in gplan.to_json()


# ---------------------------------------------------------------------------
# registry, passes and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smt", "smt-scalar", "smt-phase-split"])
def test_pass_keys_and_columns_equal_the_reference(name):
    for kw in ({}, {"config": "small"}):
        rkw = {"config": RSMT.SMTConfig(**SMALL)} if kw else {}
        pkw = {"config": PSMT.SMTConfig(**SMALL)} if kw else {}
        want = RA.make_pass(name, **rkw)
        got = PA.make_pass(name, **pkw)
        assert isinstance(got, PA.SmtPass)
        assert (got.key(), got.column, got.phases, got.engine) == \
            (want.key(), want.column, want.phases, want.engine)
        assert PA.make_pass(name, device="cpu", **pkw).key() == got.key()
    assert repr(PSMT.SMTConfig()) == repr(RSMT.SMTConfig())
    assert PA.cluster().key() == RA.cluster().key()


def test_smt_domains_resolve_lazily():
    dom = absval.get_domain("smt")
    assert dom.whole_dag and dom.config.engine == "batched"
    assert dom.device is None
    dom = absval.get_domain("smt-scalar")
    assert dom.whole_dag and dom.config.engine == "scalar"
    with pytest.raises(KeyError, match=r"registered: \['affine', "
                       r"'intersect', 'interval', 'smt', 'smt-scalar'\]"):
        absval.get_domain("nope")


def test_analyze_smt_scalar_through_the_shim_equals_the_reference(fresh):
    """`analyze(pipe, "smt-scalar")`: the one-pass plan of the scalar
    engine, at its default 30 s budget, on dus (done in well under a
    second, so no stage reaches the deadline)."""
    want = ref_analyze(dus.build(), "smt-scalar")
    got = analyze(tdus.build(), "smt-scalar")
    assert _ranges(got) == _ranges(want)
    got = PSMT.domain.SMTDomain(PSMT.SMTConfig(time_budget_s=INF),
                                device="cpu").analyze_pipeline(tdus.build())
    assert _ranges(got) == _ranges(want)


def test_run_plan_with_smt_columns_equals_the_reference(fresh):
    rcfg, pcfg = _configs("batched")
    wplan = RA.run_plan(dus.build_extended(), [
        "interval", RA.make_pass("smt", config=rcfg),
        RA.make_pass("smt-phase-split", config=rcfg),
        RA.cluster(RA.make_pass("smt", config=rcfg))],
        betas={n: 4 for n in dus.build_extended().stages})
    gplan = PA.run_plan(tdus.build_extended(), [
        "interval", PA.make_pass("smt", config=pcfg, device="cpu"),
        PA.make_pass("smt-phase-split", config=pcfg, device="cpu"),
        PA.cluster(PA.make_pass("smt", config=pcfg, device="cpu"))],
        betas={n: 4 for n in tdus.build_extended().stages})
    assert gplan.to_json() == wplan.to_json()
    gplan.check_nesting(["smt", "interval"])
    assert gplan.phases["smt-phase-split"]


def test_default_cluster_equals_the_reference(fresh):
    """`cluster()` with its default sub-pass ("smt", default config) on
    dus; the port's sub-pass is given the CPU, which its key leaves
    out."""
    want = RA.run_plan(dus.build(), [RA.cluster()])
    sub = PA.cluster().sub
    assert isinstance(sub, PA.SmtPass) and sub.device is None
    sub.device = "cpu"
    got = PA.run_plan(tdus.build(), [PA.cluster(sub)])
    assert got.to_json() == want.to_json()


def test_smt_without_a_device_runs_on_the_card_and_raises_without_one(
        fresh):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSMT.analyze_smt(tdus.build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.run_plan(tdus.build(), [PA.make_pass("smt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        absval.get_domain("smt").analyze_pipeline(tdus.build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.run_plan(tdus.build(), [PA.cluster()])
    (_, _), (pcsp, proot), seed = _pair(dus.build, tdus.build, "Uy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.decide(pcsp, proot, "ge", seed.hi)
    # the scalar engine takes no device
    PSMT.analyze_smt(tdus.build(), config=PSMT.SMTConfig(engine="scalar"))


def test_stats_is_a_counter_group_counting_boxes():
    assert isinstance(PS.STATS, obs.CounterGroup)
    assert PS.STATS.name == RS.STATS.name == "smt.solver"
    assert set(PS.STATS) == set(RS.STATS) == {"boxes", "secs"}
    (_, _), (pcsp, proot), seed = _pair(hcd.build, thcd.build, "trace")
    PS.STATS.reset()
    v = PS.decide(pcsp, proot, "ge", 0.5 * seed.hi, PS.BPBudget(48, 6),
                  device="cpu")
    assert PS.STATS["boxes"] == v.nodes > 0
