"""The port's synthesis workflows against the JAX package's.

`repro_torch.pipelines.workflows` — `types_from_alpha`, the alpha-column
shims, the benchmark setups and `design_report` — must give the
reference's answers on the CPU at small sizes: the same images bit for
bit, the same types, profiles, beta-search results and cost reports.
The port's setups execute through ``"interp"`` (the per-stage oracle),
``"torch"`` (the band kernel's plain version) and ``"cuda"`` on
``device="cpu"`` (the same plain version through the kernel wrapper);
the reference's through its numpy oracle.  Tolerance 0, except quality
values, which reduce per-pixel metrics in torch and in numpy: relative
1e-12.  SMT columns run deadline-free at small node budgets.
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
from repro.pipelines import workflows as RW
from repro_torch import obs
from repro_torch.analysis import BitwidthPlan
from repro_torch.core.graph import pipeline_content_hash
from repro_torch.dse import search_betas
from repro_torch.pipelines import workflows as W
from test_torch_types import phase_plan
from _torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(time_budget_s=math.inf, max_nodes=64, work_budget=4096)
MAKERS = ["hcd", "usm", "dus", "optical_flow", "dus_ext", "of_pyramid"]
PAIRS = ("optical_flow", "of_pyramid")


def _make(name, lib, **kw):
    """Both packages' setups at a small size (2 + 2 images or pairs)."""
    if name in PAIRS:
        return lib.ALL_BENCHMARKS[name](n_pairs=2, shape=(16, 16), **kw)
    return lib.ALL_BENCHMARKS[name](n_train=2, n_test=2, shape=(16, 16),
                                    **kw)


def _pair(name):
    """The reference's setup and the port's on the CPU."""
    return _make(name, RW), _make(name, W, device="cpu")


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _types_equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        g, w = got[n], want[n]
        assert (g is None) == (w is None), n
        if w is not None:
            assert (g.alpha, g.beta, g.signed) == (w.alpha, w.beta,
                                                   w.signed), n


def _images_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, tuple):
            assert isinstance(x, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", MAKERS)
def test_benchmark_setups_equal_the_reference(name):
    """Each `make_*`: the reference's seeds and sizes, images bit-equal,
    the same pipeline, params, target and metric inputs."""
    ref, got = _pair(name)
    assert (got.name, got.params, got.quality_target, got.two_input) == \
        (ref.name, ref.params, ref.quality_target, ref.two_input)
    assert pipeline_content_hash(got.pipeline) == \
        RA.pipeline_content_hash(ref.pipeline)
    _images_equal(got.train_images, ref.train_images)
    _images_equal(got.test_images, ref.test_images)
    assert got.device == "cpu"
    assert set(W.ALL_BENCHMARKS) == set(RW.ALL_BENCHMARKS)


def test_types_from_alpha_warns_on_clamped_alphas():
    ref, got = _pair("usm")
    alphas = {n: a for n, a in zip(ref.pipeline.topo_order(),
                                   [8, 0, -2, 10, 9])}
    signed = {n: n == "sharpen" for n in alphas}
    betas = {"img": 1, "blury": 3}
    with pytest.warns(RuntimeWarning, match="blurx, blury"):
        want = RW.types_from_alpha(ref.pipeline, alphas, signed, betas)
    with pytest.warns(RuntimeWarning, match="blurx, blury"):
        types = W.types_from_alpha(got.pipeline, alphas, signed, betas)
    _types_equal(types, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        W.types_from_alpha(got.pipeline, {n: 3 for n in alphas}, signed, {})


@pytest.mark.parametrize("domain", ["interval", "affine", "intersect"])
def test_static_alphas_equal_the_reference(domain):
    ref, got = _pair("hcd")
    assert W.static_alphas(got.pipeline, domain) == \
        RW.static_alphas(ref.pipeline, domain)


def test_smt_alphas_and_alpha_columns_equal_the_reference():
    PA.clear_memo()
    RA.clear_memo()
    ref, got = _pair("usm")
    want = RW.smt_alphas(ref.pipeline, config=RSMT.SMTConfig(**SMALL))
    assert W.smt_alphas(got.pipeline, config=PSMT.SMTConfig(**SMALL),
                        device="cpu") == want
    want = RW.alpha_columns(ref, smt_config=RSMT.SMTConfig(**SMALL))
    cols = W.alpha_columns(got, smt_config=PSMT.SMTConfig(**SMALL))
    prof = got.profile()
    given = W.alpha_columns(got, smt_config=PSMT.SMTConfig(**SMALL),
                            profile=prof)
    for c in (cols, given):
        assert list(c) == list(want)
        for n, row in want.items():
            for k, v in row.items():
                g = c[n][k]
                if k.endswith("_range"):
                    assert (g.lo, g.hi) == (v.lo, v.hi), (n, k)
                else:
                    assert g == v, (n, k)
    PA.clear_memo()


@pytest.mark.parametrize("name", MAKERS)
def test_profile_equals_the_reference(name):
    ref, got = _pair(name)
    want, prof = ref.profile(), got.profile()
    assert prof.alpha_max == want.alpha_max
    assert prof.alpha_avg == want.alpha_avg
    for n, iv in want.observed_range.items():
        assert (prof.observed_range[n].lo, prof.observed_range[n].hi) == \
            (iv.lo, iv.hi)
    for n, (bits, cum) in want.cdf.items():
        assert np.array_equal(prof.cdf[n][0], bits)
        assert np.array_equal(prof.cdf[n][1], cum)
    assert got.profile_pass().key() == ref.profile_pass().key()


def _design(ref):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        alphas, signed = RW.static_alphas(ref.pipeline)
        return alphas, signed, RW.types_from_alpha(
            ref.pipeline, alphas, signed, {n: 3 for n in ref.pipeline.stages})


def _port_types(types):
    from repro_torch.core.fixedpoint import FixedPointType
    return {n: FixedPointType(t.alpha, t.beta, t.signed)
            for n, t in types.items()}


@pytest.mark.parametrize("backend", ["interp", "torch", "cuda"])
@pytest.mark.parametrize("name", MAKERS)
def test_mean_quality_equals_the_reference(name, backend):
    ref, got = _pair(name)
    _, _, types = _design(ref)
    want = ref.mean_quality(types)
    envs = got.fixed_envs(_port_types(types), backend=backend)
    if backend == "cuda":
        q = got.mean_quality(_port_types(types))
    else:
        refs = got.ref_envs()
        q = float(np.mean([got.quality_of(r, f, got.params)
                           for r, f in zip(refs, envs)]))
    assert rel(q, want) <= 1e-12, (q, want)
    keep = set(got.scored_outputs() or got.pipeline.outputs)
    assert keep <= set(envs[0])
    if backend != "interp":
        assert set(envs[0]) == keep


@pytest.mark.parametrize("backend", ["interp", "torch", "cuda"])
@pytest.mark.parametrize("name", ["usm", "hcd", "dus_ext"])
def test_run_beta_search_equals_the_reference(name, backend):
    ref, got = _pair(name)
    prof = ref.profile()
    alphas, signed = RW.static_alphas(ref.pipeline)
    with pytest.warns(DeprecationWarning, match="search_betas"):
        want = ref.run_beta_search(prof.alpha_max, signed, beta_hi=8)
    if backend == "cuda":
        with pytest.warns(DeprecationWarning, match="search_betas"):
            res = got.run_beta_search(prof.alpha_max, signed, beta_hi=8)
    else:
        # the shim's search through another executor
        res = search_betas(got.pipeline, prof.alpha_max, signed=signed,
                           images=got.train_images, target=got.quality_target,
                           params=got.params, metric=got.quality_of,
                           backend=backend, beta_hi=8, device="cpu",
                           outputs=got.scored_outputs())
    assert (res.betas, res.uniform_beta, res.profile_passes) == \
        (want.betas, want.uniform_beta, want.profile_passes)
    assert rel(res.quality, want.quality) <= 1e-12
    # the quality callback the search drives, on one beta map
    qf = got.beta_quality_fn(prof.alpha_max, signed)
    rqf = ref.beta_quality_fn(prof.alpha_max, signed)
    assert rel(qf(want.betas), rqf(want.betas)) <= 1e-12


def test_executor_equals_the_oracle():
    ref, got = _pair("dus_ext")
    _, _, types = _design(ref)
    run = got.executor(_port_types(types), outputs=["res", "Uy"])
    from repro.dsl.exec import run_fixed as ref_run_fixed
    for im in ref.test_images:
        want = ref_run_fixed(ref.pipeline, im, types)
        out = run(im)
        assert sorted(out) == ["Uy", "res"]
        for k, v in out.items():
            assert np.array_equal(v.numpy(), want[k]), k
    assert torch.equal(got.executor(_port_types(types),
                                    backend="interp")(im)["res"],
                       run(im)["res"])


def _cost(c):
    return dataclasses.asdict(c)


def _report_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if k in ("fixed", "float", "fixed_phase"):
            assert _cost(g) == _cost(v), k
        else:
            assert g == v, k


@pytest.mark.parametrize("phases", [False, True], ids=["types", "phases"])
def test_design_report_equals_the_reference(phases):
    """A type map, and a plan with per-residue sub-columns (the
    phase-split costs), priced as the reference prices them."""
    ref, got = _pair("dus_ext")
    if phases:
        rplan = phase_plan(ref.pipeline)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = RW.design_report(ref.pipeline, rplan, image_width=640)
            rep = W.design_report(got.pipeline,
                                  BitwidthPlan.from_json(rplan.to_json()),
                                  image_width=640)
        assert "phase_improvement" in want
    else:
        _, _, types = _design(ref)
        want = RW.design_report(ref.pipeline, types)
        rep = W.design_report(got.pipeline, _port_types(types))
        assert "fixed_phase" not in want
    _report_equal(rep, want)


def test_setups_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = W.make_usm(1, 1, (8, 8))
    assert b.device is None
    obs.reset_warn_once()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.profile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.ref_envs()
