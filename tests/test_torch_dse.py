"""The port's design search against the JAX package's, on the CPU.

`repro_torch.pipelines.{data,metrics}`, `repro_torch.core.{cost_model,
beta_search}` and `repro_torch.dse` must give the reference's answers:
data bit for bit, metrics to a relative 1e-12 (maxima exact), costs
exactly (the same host arithmetic in the same order), and the same
searches.  The port's `Evaluator` and `run_design_search` score through
``"interp"`` (the oracle) and ``"torch"`` (the band kernel's plain
version) and are held to the reference's ``backend="numpy"`` scoring:
max_abs_err, costs and every discrete field exact, PSNR within 1e-9
relative.

Every plan is built once per module in the JAX package with
``run_plan(pipe, ["interval", ProfilePass(images, params=...)])`` (no
SMT pass: its time budget makes a plan depend on the wall clock) and
carried to the port as ``BitwidthPlan.from_json(ref_plan.to_json())``.
Cases come from `numpy.random.default_rng` seeds; tests that count
clear the port's counters, memo and executor cache first.
"""
import json
import math
import warnings

import numpy as np
import pytest
import torch

import repro_torch.pipelines as tp
from repro.analysis import ProfilePass as RefProfilePass
from repro.analysis import run_plan as ref_run_plan
from repro.core import beta_search as ref_bs
from repro.core import cost_model as ref_cm
from repro.core.fixedpoint import FixedPointType as RefFP
from repro.dse import DesignPoint as RefPoint
from repro.dse import ErrorBudget as RefBudget
from repro.dse import Evaluator as RefEvaluator
from repro.dse import Frontier as RefFrontier
from repro.dse import output_stages as ref_output_stages
from repro.dse import psnr_of as ref_psnr_of
from repro.dse import run_design_search as ref_search
from repro.dse import search_betas as ref_search_betas
from repro.dse import seed_alphas as ref_seed_alphas
from repro.lowering.ir import lower as ref_lower
from repro.pipelines import data as ref_data
from repro.pipelines import dus, hcd, optical_flow, usm
from repro.pipelines import metrics as ref_metrics
from repro_torch.analysis import clear_memo
from repro_torch.analysis.plan import BitwidthPlan
from repro_torch.core import beta_search as bs
from repro_torch.core import cost_model as cm
from repro_torch.core.fixedpoint import alpha_for_range
from repro_torch.dse import (DSE_STATS, PSNR_CAP, DesignPoint, ErrorBudget,
                             Evaluator, Frontier, output_stages, psnr_of,
                             run_design_search, search_betas, seed_alphas)
from repro_torch.dsl.exec import EXEC_CACHE_STATS, clear_executor_cache
from repro_torch.lowering.ir import lower
from repro_torch.pipelines import data, metrics
from repro_torch.pipelines.types import load_types, types_from_data
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (24, 24)
# (reference builder, port builder, params, image seed, budget in dB):
# the seeds of the reference's benchmark constructors
# (pipelines/workflows.py) and the budgets of benchmarks/run.py:473
SEARCHED = {
    "usm": (usm.build, tp.usm.build, dict(usm.DEFAULT_PARAMS), 23, 50.0),
    "hcd": (hcd.build, tp.hcd.build, {}, 11, 40.0),
    "dus_ext": (dus.build_extended, tp.dus.build_extended, {}, 37, 45.0),
}
COMMITTED = ["usm", "hcd", "dus", "dus_ext", "of", "of_pyramid"]
REF_BUILD = {"usm": usm.build, "hcd": hcd.build, "dus": dus.build,
             "dus_ext": dus.build_extended, "of": optical_flow.build,
             "of_pyramid": optical_flow.build_pyramid}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def to_ref(t):
    """A port fixed-point type (or None) as the reference's."""
    return None if t is None else RefFP(t.alpha, t.beta, t.signed)


def ref_phases(phase_types):
    return {s: (lat, {r: to_ref(t) for r, t in rmap.items()})
            for s, (lat, rmap) in phase_types.items()}


def fresh():
    """The port's process-wide search state, cleared."""
    DSE_STATS.reset()
    EXEC_CACHE_STATS.reset()
    clear_memo()
    clear_executor_cache()


class Setup:
    """One benchmark at `shape`: both pipelines, 2 calibration images and
    the reference's plan (interval + profile) with its port copy."""

    def __init__(self, name, shape=SHAPE):
        ref_build, port_build, params, seed, budget = SEARCHED[name]
        self.name, self.params, self.budget = name, params, budget
        self.ref_pipe, self.pipe = ref_build(), port_build()
        self.images = ref_data.image_set(2, shape, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self.ref_plan = ref_run_plan(
                self.ref_pipe,
                ["interval", RefProfilePass(self.images, params=params)])
        self.plan = BitwidthPlan.from_json(self.ref_plan.to_json())


@pytest.fixture(scope="module")
def setups():
    return {n: Setup(n) for n in SEARCHED}


# ---------------------------------------------------------------------------
# pipelines.data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 23])
def test_data_is_bit_equal(seed):
    for shape in [(24, 24), (17, 31)]:
        a, b = data.natural_image(shape, seed), \
            ref_data.natural_image(shape, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(data.image_set(3, (20, 22), seed),
                    ref_data.image_set(3, (20, 22), seed)):
        assert np.array_equal(a, b)
    for a, b in zip(data.shifted_pair((16, 18), seed, (1, 2)),
                    ref_data.shifted_pair((16, 18), seed, (1, 2))):
        assert np.array_equal(a, b)
    for xs, ys in zip(data.train_test_split(4, (16, 16), seed),
                      ref_data.train_test_split(4, (16, 16), seed)):
        assert all(np.array_equal(a, b) for a, b in zip(xs, ys))


# ---------------------------------------------------------------------------
# pipelines.metrics
# ---------------------------------------------------------------------------

def _fields(seed):
    rng = np.random.default_rng(seed)
    ref = rng.normal(0.0, 40.0, (2, 19, 23))
    test = ref + rng.normal(0.0, 0.5, ref.shape) * (rng.random(ref.shape)
                                                     < 0.3)
    return ref, test


METRICS = ["hcd_accuracy", "hcd_accuracy_threshold",
           "usm_classification_error", "usm_branch", "rms_correct", "psnr",
           "aae_degrees"]


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_equal_the_reference(metric):
    for seed in range(3):
        ref, test = _fields(seed)
        T = torch.from_numpy
        if metric == "hcd_accuracy":
            got = metrics.hcd_accuracy(T(ref), T(test))
            want = ref_metrics.hcd_accuracy(ref, test)
        elif metric == "hcd_accuracy_threshold":
            got = metrics.hcd_accuracy(T(ref), T(test), 3.5)
            want = ref_metrics.hcd_accuracy(ref, test, 3.5)
        elif metric == "usm_classification_error":
            got = metrics.usm_classification_error(T(ref > 1), T(test > 1))
            want = ref_metrics.usm_classification_error(ref > 1, test > 1)
        elif metric == "usm_branch":
            env = {"img": ref, "blury": test}
            got = metrics.usm_branch({k: T(v) for k, v in env.items()},
                                     {"thresh": 0.25})
            want = ref_metrics.usm_branch(env, {"thresh": 0.25})
            assert np.array_equal(got.numpy(), want)
            continue
        elif metric == "rms_correct":
            got = metrics.rms_correct(T(ref), T(test), T(ref > 1),
                                      T(test > 1))
            want = ref_metrics.rms_correct(ref, test, ref > 1, test > 1)
            assert metrics.rms_correct(T(ref), T(test), T(ref > 0),
                                       T(ref <= 0)) == float("inf")
        elif metric == "psnr":
            got = metrics.psnr(T(ref), T(test), 99.0)
            want = ref_metrics.psnr(ref, test, 99.0)
            assert metrics.psnr(T(ref), T(ref)) == float("inf") \
                == ref_metrics.psnr(ref, ref)
        else:
            u, v = ref[0] / 40.0, ref[1] / 40.0
            got = metrics.aae_degrees(T(u), T(v), T(test[0] / 40.0),
                                      T(test[1] / 40.0))
            want = ref_metrics.aae_degrees(u, v, test[0] / 40.0,
                                           test[1] / 40.0)
        assert isinstance(got, float)
        assert rel(got, float(want)) <= 1e-12, (metric, seed, got, want)


def test_psnr_of_and_the_maximum_equal_the_reference(setups):
    ref, test = _fields(7)
    peak = float(np.max(np.abs(ref)))
    assert float(torch.from_numpy(ref).abs().max()) == peak
    got = psnr_of(torch.from_numpy(ref), torch.from_numpy(test), peak)
    assert rel(got, ref_psnr_of(ref, test, peak)) <= 1e-12
    assert psnr_of(torch.from_numpy(ref), torch.from_numpy(ref), peak) \
        == PSNR_CAP == ref_psnr_of(ref, ref, peak)
    assert psnr_of(torch.from_numpy(ref), torch.from_numpy(test), 0.0) \
        == ref_psnr_of(ref, test, 0.0) == 0.0
    for s in setups.values():
        assert output_stages(s.pipe) == ref_output_stages(s.ref_pipe)


# ---------------------------------------------------------------------------
# core.cost_model
# ---------------------------------------------------------------------------

def _cost_tuple(c):
    return (c.power_proxy, c.lut_bits, c.dsp_bits, c.bram_bits,
            c.bytes_per_pixel_tpu)


@pytest.mark.parametrize("name", COMMITTED)
def test_design_cost_of_the_committed_designs(name):
    design = load_types(name)
    pipe = tp.ALL[name]()
    ref_pipe = REF_BUILD[name]()
    types, phases = design.types(), design.phase_types()
    rtypes = {n: to_ref(t) for n, t in types.items()}
    for width in (1920, 64):
        got = cm.design_cost(pipe, types, width, phase_types=phases or None)
        want = ref_cm.design_cost(ref_pipe, rtypes, width,
                                  phase_types=ref_phases(phases) or None)
        assert _cost_tuple(got) == _cost_tuple(want)
        flt = cm.design_cost(pipe, cm.float_design(pipe), width)
        rflt = ref_cm.design_cost(ref_pipe, ref_cm.float_design(ref_pipe),
                                  width)
        assert _cost_tuple(flt) == _cost_tuple(rflt)
        assert got.ratios_vs(flt) == want.ratios_vs(rflt)
    for n in pipe.topo_order():
        a = cm.stage_cost(pipe, n, types)
        b = ref_cm.stage_cost(ref_pipe, n, rtypes)
        assert (a.bit_ops, a.lut_bits, a.dsp_bits, a.bram_bits,
                a.storage_bits) == (b.bit_ops, b.lut_bits, b.dsp_bits,
                                    b.bram_bits, b.storage_bits), n
    # exact and narrow lowerings: the datapaths and their prices
    for mode in ("exact", "narrow"):
        dps = cm.lowered_datapaths(lower(pipe, types, datapath=mode))
        rdps = ref_cm.lowered_datapaths(ref_lower(ref_pipe, rtypes,
                                                  datapath=mode))
        assert dps == rdps
        assert _cost_tuple(cm.design_cost(pipe, types, datapaths=dps)) == \
            _cost_tuple(ref_cm.design_cost(ref_pipe, rtypes,
                                           datapaths=rdps))


def phase_design():
    """dus_ext's serving design with per-residue bounds on three stages
    (the two-phase plan `chip_smoke.py:phase_design` runs)."""
    d = load_types("dus_ext").to_data()
    ranges = {"resS": ((2, 1), {"0,0": (-50, 50)}),
              "UyS": ((2, 1), {"0,0": (0, 150), "1,0": (0, 250)}),
              "band": ((2, 2), {"0,0": (-30, 30)})}
    d["phases"] = {
        s: {"lattice": list(lat),
            "ranges": {k: {"alpha": alpha_for_range(lo, hi),
                           "signed": lo < 0} for k, (lo, hi) in r.items()}}
        for s, (lat, r) in ranges.items()}
    return types_from_data(d)


def test_design_cost_with_phase_types():
    design = phase_design()
    types, phases = design.types(), design.phase_types()
    assert len(phases) == 3
    pipe, ref_pipe = tp.dus.build_extended(), dus.build_extended()
    rtypes = {n: to_ref(t) for n, t in types.items()}
    got = cm.design_cost(pipe, types, phase_types=phases)
    want = ref_cm.design_cost(ref_pipe, rtypes,
                              phase_types=ref_phases(phases))
    assert _cost_tuple(got) == _cost_tuple(want)
    assert _cost_tuple(got) != _cost_tuple(cm.design_cost(pipe, types))
    for s, entry in phases.items():
        w = types[s].width
        assert cm.phase_mean_width(entry, w) == ref_cm.phase_mean_width(
            ref_phases({s: entry})[s], w)


# ---------------------------------------------------------------------------
# core.beta_search on a deterministic synthetic quality function
# ---------------------------------------------------------------------------

def _synthetic_quality(names, seed):
    """Monotone in every beta: each stage past its own knee adds a
    seeded weight."""
    rng = np.random.default_rng(seed)
    knee = {n: int(k) for n, k in zip(names, rng.integers(0, 12, len(names)))}
    weight = {n: float(w) for n, w in zip(names, rng.random(len(names)))}

    def q(betas):
        return sum(weight[n] * min(betas.get(n, 0), knee[n]) / 12.0
                   for n in names)

    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beta_search_equals_the_reference(seed):
    pipe, ref_pipe = tp.hcd.build(), hcd.build()
    names = pipe.topo_order()
    q = _synthetic_quality(names, seed)
    target = 0.6 * q({n: 16 for n in names})
    assert bs.uniform_beta_search(names, q, target) == \
        ref_bs.uniform_beta_search(names, q, target)
    start = {n: 9 for n in names}
    assert bs.refine_sequence(names, start, q, target, beta_lo=1) == \
        ref_bs.refine_sequence(names, start, q, target, beta_lo=1)
    assert bs.reverse_topo_refine(pipe, start, q, target, frozen=["img"]) \
        == ref_bs.reverse_topo_refine(ref_pipe, start, q, target,
                                      frozen=["img"])
    got = bs.search(pipe, q, target, beta_hi=12, frozen=["img"],
                    fixed_betas={"img": 0})
    want = ref_bs.search(ref_pipe, q, target, beta_hi=12, frozen=["img"],
                         fixed_betas={"img": 0})
    assert (got.betas, got.uniform_beta, got.quality,
            got.profile_passes) == (want.betas, want.uniform_beta,
                                    want.quality, want.profile_passes)


# ---------------------------------------------------------------------------
# dse.frontier
# ---------------------------------------------------------------------------

def _points(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(alphas={"a": int(rng.integers(1, 9)), "b": 3},
                  betas={"a": int(rng.integers(0, 4)), "b": i % 3},
                  signed={"a": True, "b": False},
                  psnr=float(rng.choice([30.0, 45.5, 60.25, PSNR_CAP])),
                  max_abs_err=float(rng.random()),
                  power=float(rng.integers(10, 20)),
                  lut_bits=float(rng.integers(5, 15)),
                  dsp_bits=float(rng.integers(0, 3)), bram_bits=4.0,
                  total_bits=int(rng.integers(8, 30)),
                  meets_budget=bool(rng.random() < 0.8),
                  strategy=f"s{i}", pipeline="p", plan_hash="h",
                  plan_column="interval", verified=bool(i % 2),
                  oracle_exact=bool(i % 3))
        out.append((DesignPoint(**kw), RefPoint(**kw)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_equals_the_reference(seed):
    budget = dict(min_psnr=40.0, max_abs_err=0.9)
    fr, rfr = Frontier(ErrorBudget(**budget)), RefFrontier(RefBudget(**budget))
    for p, q in _points(seed):
        assert fr.add(p) == rfr.add(q)
        fr.check_invariants()
    assert fr.to_json() == rfr.to_json()
    assert Frontier.from_json(fr.to_json()).to_json() == fr.to_json()
    for obj in ("power", "area", "psnr"):
        b, rb = fr.best(obj), rfr.best(obj)
        assert (b is None) == (rb is None)
        if b is not None:
            assert json.dumps(b.to_json_dict()) == \
                json.dumps(rb.to_json_dict())
    assert "Infinity" not in fr.to_json()
    assert ErrorBudget(**budget).met_by(45.0, 0.5) \
        and not ErrorBudget(**budget).met_by(45.0, 1.0)


def test_frontier_add_and_evict():
    def pt(psnr, power, area, beta, meets=True):
        return DesignPoint(alphas={"s": 8}, betas={"s": beta},
                           signed={"s": False}, psnr=psnr, max_abs_err=0.1,
                           power=power, lut_bits=area, dsp_bits=0.0,
                           bram_bits=0.0, total_bits=8, meets_budget=meets,
                           strategy=f"b{beta}")

    fr = Frontier(ErrorBudget(min_psnr=40.0))
    assert fr.add(pt(30, 5, 5, 0, meets=False)) == "budget"
    assert fr.add(pt(50, 10, 10, 1)) == "accepted"
    assert fr.add(pt(50, 12, 12, 2)) == "dominated"
    cheaper = pt(50, 8, 8, 3)
    assert fr.add(cheaper) == "accepted"
    assert [p.strategy for p in fr.points()] == ["b3"]
    assert fr.add(cheaper) == "dominated"       # a copy never re-enters
    assert fr.add(pt(60, 9, 9, 4)) == "accepted"  # a trade-off: both kept
    assert len(fr) == 2 and fr.check_invariants()
    assert not cheaper.dominates(cheaper)


# ---------------------------------------------------------------------------
# dse.evaluate: the Evaluator against the reference's numpy scoring
# ---------------------------------------------------------------------------

def _candidates(plan, seed, n=8):
    rng = np.random.default_rng(seed)
    sound = plan.alphas()
    names = sorted(sound)
    out = []
    for _ in range(n):
        a = {k: max(int(sound[k] + rng.integers(-3, 2)), 0) for k in names}
        b = {k: int(rng.integers(0, 9)) for k in names}
        out.append((a, b))
    return out


@pytest.mark.parametrize("backend", ["interp", "torch"])
@pytest.mark.parametrize("name", list(SEARCHED))
def test_evaluator_equals_the_reference(setups, name, backend):
    s = setups[name]
    fresh()
    budget = dict(min_psnr=s.budget, max_abs_err=40.0)
    ev = Evaluator(s.pipe, s.plan.signed(), s.images, ErrorBudget(**budget),
                   params=s.params, backend=backend, device="cpu")
    ref = RefEvaluator(s.ref_pipe, s.ref_plan.signed(), s.images,
                       RefBudget(**budget), params=s.params,
                       backend="numpy")
    assert ev.peaks == ref.peaks
    for a, b in _candidates(s.plan, 100 + len(name)):
        p, q = ev.evaluate(a, b, "t"), ref.evaluate(a, b, "t")
        assert (p.alphas, p.betas, p.signed) == (q.alphas, q.betas, q.signed)
        assert p.max_abs_err == q.max_abs_err
        assert rel(p.psnr, q.psnr) <= 1e-9, (a, b, p.psnr, q.psnr)
        assert (p.power, p.lut_bits, p.dsp_bits, p.bram_bits,
                p.total_bits) == (q.power, q.lut_bits, q.dsp_bits,
                                  q.bram_bits, q.total_bits)
        assert p.meets_budget == q.meets_budget, (a, b, p.psnr, q.psnr)
    assert DSE_STATS["evaluated"] == 8


def test_evaluator_memoizes_and_shares_executors(setups):
    s = setups["usm"]
    fresh()
    (a, b), = _candidates(s.plan, 3, n=1)
    ev = Evaluator(s.pipe, s.plan.signed(), s.images,
                   ErrorBudget(min_psnr=40.0), params=s.params,
                   backend="torch", device="cpu")
    p = ev.evaluate(a, b)
    assert ev.evaluate(dict(a), dict(b)) is p
    assert (DSE_STATS["evaluated"], DSE_STATS["cached"]) == (1, 1)
    assert EXEC_CACHE_STATS["misses"] == 1
    # a second evaluator on the same type map compiles nothing new
    ev2 = Evaluator(s.pipe, s.plan.signed(), s.images,
                    ErrorBudget(min_psnr=40.0), params=s.params,
                    backend="torch", device="cpu")
    q = ev2.evaluate(a, b)
    assert (q.psnr, q.max_abs_err) == (p.psnr, p.max_abs_err)
    assert EXEC_CACHE_STATS["misses"] == 1 and EXEC_CACHE_STATS["hits"] == 1


def test_verify_raises_on_a_tampered_point(setups):
    s = setups["usm"]
    fresh()
    ev = Evaluator(s.pipe, s.plan.signed(), s.images,
                   ErrorBudget(min_psnr=40.0), params=s.params,
                   backend="interp", device="cpu")
    for a, b in _candidates(s.plan, 11, n=2):
        p = ev.evaluate(a, b)
        assert ev.verify(p).verified and p.oracle_exact
    p = ev.evaluate(*_candidates(s.plan, 12, n=1)[0])
    p.psnr += 0.5
    with pytest.raises(AssertionError, match="re-score drifted"):
        ev.verify(p)
    assert not p.verified


def test_the_card_is_the_default_and_raises_without_one(setups,
                                                         monkeypatch):
    s = setups["usm"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(s.pipe, s.plan.signed(), s.images,
                  ErrorBudget(min_psnr=40.0), params=s.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_design_search(s.pipe, s.plan, s.images,
                          ErrorBudget(min_psnr=40.0), params=s.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search_betas(s.pipe, s.plan, images=s.images, target=40.0,
                     params=s.params)
    with pytest.raises(ValueError, match="unknown scoring backend"):
        Evaluator(s.pipe, s.plan.signed(), s.images,
                  ErrorBudget(min_psnr=40.0), backend="lowered",
                  device="cpu")


# ---------------------------------------------------------------------------
# dse.betas and dse.driver
# ---------------------------------------------------------------------------

def test_seed_alphas_and_search_betas_equal_the_reference(setups):
    s = setups["usm"]
    assert seed_alphas(s.plan) == ref_seed_alphas(s.ref_plan)
    assert seed_alphas(s.plan, "interval") == \
        ref_seed_alphas(s.ref_plan, "interval")
    got = search_betas(s.pipe, s.plan, images=s.images, target=50.0,
                       params=s.params, backend="interp", device="cpu")
    want = ref_search_betas(s.ref_pipe, s.ref_plan, images=s.images,
                            target=50.0, params=s.params, backend="numpy")
    assert (got.betas, got.uniform_beta, got.profile_passes) == \
        (want.betas, want.uniform_beta, want.profile_passes)
    assert rel(got.quality, want.quality) <= 1e-9


def _strip(d):
    """A search's JSON without its measured error and verify flags."""
    d = json.loads(json.dumps(d))
    for p in d["frontier"]["points"] + [d["chosen"] or {}]:
        for k in ("psnr", "max_abs_err", "verified", "oracle_exact"):
            p.pop(k, None)
    return d


def _same_search(res, ref):
    assert _strip(res.to_json_dict()) == _strip(ref.to_json_dict())
    assert res.evaluations == ref.evaluations
    assert res.clusters == ref.clusters
    for p, q in zip(res.frontier.points(), ref.frontier.points()):
        assert p.max_abs_err == q.max_abs_err
        assert rel(p.psnr, q.psnr) <= 1e-9
        assert p.verified and p.oracle_exact


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["usm", "dus_ext"])
def test_design_search_equals_the_reference(setups, name, seed):
    s = setups[name]
    fresh()
    kw = dict(params=s.params, seed=seed, anneal_iters=24)
    ref = ref_search(s.ref_pipe, s.ref_plan, s.images,
                     RefBudget(min_psnr=s.budget), backend="numpy", **kw)
    res = run_design_search(s.pipe, s.plan, s.images,
                            ErrorBudget(min_psnr=s.budget), backend="interp",
                            device="cpu", verify=True, **kw)
    _same_search(res, ref)
    assert DSE_STATS["evaluated"] == res.evaluations
    assert DSE_STATS["accepted"] + DSE_STATS["rejected"] == res.evaluations
    if res.chosen is not None:
        assert res.chosen.meets_budget


def test_design_search_through_the_plain_kernel_equals_the_reference():
    s = Setup("dus_ext", shape=(16, 16))
    fresh()
    kw = dict(params=s.params, seed=0, anneal_iters=24)
    ref = ref_search(s.ref_pipe, s.ref_plan, s.images,
                     RefBudget(min_psnr=s.budget), backend="numpy", **kw)
    res = run_design_search(s.pipe, s.plan, s.images,
                            ErrorBudget(min_psnr=s.budget), backend="torch",
                            device="cpu", verify=True, **kw)
    _same_search(res, ref)
    assert math.isfinite(sum(p.psnr for p in res.frontier.points()))
