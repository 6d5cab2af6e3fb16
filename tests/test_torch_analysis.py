"""The port's range analysis and analysis passes against the JAX package's.

`repro_torch.core.range_analysis`, `core.profile`, `dsl.exec.run_abstract`
and `repro_torch.analysis` (passes, combinators, clustering, the plan
driver with its memo and disk cache) must give the reference's answers
on the six benchmarks: the same ranges, alphas and signedness, and the
same `BitwidthPlan.to_json()` text, content hash included.  Tolerance 0
throughout.  Inputs come from `numpy.random.default_rng` seeds; tests
that count memo or disk-cache hits clear the port's memo first, and
tests that expect a warning reset the port's warning registry first.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import repro.analysis as RA
import repro_torch.analysis as PA
from repro import obs as ref_obs
from repro.core.profile import np_alpha_bits as ref_np_alpha_bits
from repro.core.profile import profile_pipeline as ref_profile_pipeline
from repro.core.range_analysis import alpha_table as ref_alpha_table
from repro.core.range_analysis import analyze_direct as ref_analyze_direct
from repro.dsl.exec import make_profile_runner as ref_profile_runner
from repro.dsl.exec import run_abstract as ref_run_abstract
from repro_torch import obs
from repro_torch.core import absval
from repro_torch.core.profile import alpha_bits, np_alpha_bits
from repro_torch.core.profile import profile_pipeline
from repro_torch.core.range_analysis import alpha_table, analyze, \
    analyze_direct
from repro_torch.dsl import exec as E
from repro_torch.pipelines.types import design_from_plan, load_types
from test_torch_types import BENCHES, IDS, N_IN
from _torch_threads import one_torch_thread  # noqa: F401

DOMAINS = ["interval", "affine", "intersect"]


@pytest.fixture
def fresh():
    """The port's process-wide analysis state, cleared: the memo and its
    counters, and the warn-once registry."""
    PA.clear_memo()
    obs.reset_warn_once()
    yield
    PA.clear_memo()


def samples(name, shape, seed, n=4):
    """`n` seeded frames (frame pairs for optical flow) as numpy arrays."""
    rng = np.random.default_rng(seed)
    k = N_IN.get(name, 1)
    out = []
    for _ in range(n):
        fr = [rng.integers(0, 256, shape).astype(np.float64)
              for _ in range(k)]
        out.append(fr[0] if k == 1 else tuple(fr))
    return out


def to_torch(imgs):
    return [tuple(torch.from_numpy(a) for a in im) if isinstance(im, tuple)
            else torch.from_numpy(im) for im in imgs]


def betas_of(pipe):
    return {n: 4 for n in pipe.stages}


def sr_tuple(sr):
    return (sr.range.lo, sr.range.hi, sr.alpha, sr.signed)


# ---------------------------------------------------------------------------
# Algorithm 1 in each domain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_analyze_direct_equals_the_reference(bench, domain):
    name, ref_build, port_build, params = bench
    want = ref_analyze_direct(ref_build(), domain)
    got = analyze_direct(port_build(), domain)
    assert list(got) == list(want)
    for n in want:
        assert sr_tuple(got[n]) == sr_tuple(want[n]), n


@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_analyze_shim_and_alpha_table_equal_the_reference(bench):
    name, ref_build, port_build, params = bench
    got = analyze(port_build(), "affine")
    want = analyze_direct(port_build(), "affine")
    assert {n: sr_tuple(v) for n, v in got.items()} == \
        {n: sr_tuple(v) for n, v in want.items()}
    assert alpha_table(port_build()) == ref_alpha_table(ref_build())


def test_analyze_with_input_ranges_equals_the_reference():
    name, ref_build, port_build, params = BENCHES[0]
    from repro.core.interval import Interval as RefInterval
    from repro_torch.core.interval import Interval
    want = ref_analyze_direct(ref_build(), "intersect",
                              input_ranges={"img": RefInterval(10.0, 90.0)})
    got = analyze(port_build(), "intersect",
                  input_ranges={"img": Interval(10.0, 90.0)})
    assert {n: sr_tuple(v) for n, v in got.items()} == \
        {n: sr_tuple(v) for n, v in want.items()}


def test_unknown_domain_and_smt_are_refused():
    with pytest.raises(KeyError, match=r"unknown analysis domain 'smt'; "
                       r"registered: \['affine', 'intersect', 'interval'\]"):
        absval.get_domain("smt")
    with pytest.raises(KeyError, match="unknown analysis pass 'smt'"):
        PA.make_pass("smt")
    with pytest.raises(KeyError, match="unknown analysis pass 'smt'"):
        PA.cluster()                     # the default sub-pass is "smt"
    with pytest.raises(KeyError, match="unknown analysis domain 'smt'"):
        analyze(BENCHES[0][2](), "smt")


# ---------------------------------------------------------------------------
# per-pixel abstract execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain", ["interval", "affine"])
@pytest.mark.parametrize("bench", BENCHES[:2], ids=IDS[:2])
def test_run_abstract_equals_the_reference(bench, domain):
    name, ref_build, port_build, params = bench
    want = ref_run_abstract(ref_build(), (6, 6), domain)
    got = E.run_abstract(port_build(), (6, 6), domain)
    assert list(got) == list(want)
    for n in want:
        r, g = want[n]["range"], got[n]["range"]
        assert (g.lo, g.hi) == (r.lo, r.hi), n
        assert got[n]["values"].shape == want[n]["values"].shape
    # the combined analysis encloses the per-pixel one
    combined = analyze_direct(port_build(), domain)
    for n in got:
        assert combined[n].range.encloses(got[n]["range"]), n


# ---------------------------------------------------------------------------
# profile statistics
# ---------------------------------------------------------------------------

EDGES = [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 1e300, -1e300,
         np.finfo(np.float64).max, -np.finfo(np.float64).max,
         np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny]
EDGES += [s * (2.0 ** k + d) for k in range(61) for d in (-1, 0, 1)
          for s in (1, -1)]


def test_alpha_bits_on_the_tensor_equals_the_plain_version():
    x = np.array(EDGES)
    want = np_alpha_bits(x)
    got = alpha_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a few by hand: [0, 1) needs 1 bit, [-1, 0) a sign bit and none more
    assert list(np_alpha_bits(np.array([0.0, 0.5, 1.0, 255.0, 256.0, -0.5,
                                        -1.0, -2.0, -3.0, 2.0 ** 60])
                              )) == [1, 1, 1, 8, 9, 1, 1, 2, 3, 61]


def test_np_alpha_bits_equals_the_reference_below_2_to_the_49():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.uniform(-300.0, 300.0, 4000),
        rng.uniform(-2.0 ** 48, 2.0 ** 48, 4000),
        np.array([s * (2.0 ** k + d) for k in range(49) for d in (-1, 0, 1)
                  for s in (1, -1)] + [0.0, 0.5, -0.5])])
    np.testing.assert_array_equal(np_alpha_bits(x), ref_np_alpha_bits(x))
    # from 2^49 on the reference's log2 rounds down: one bit too few
    assert ref_np_alpha_bits(np.array([2.0 ** 49]))[0] == 49
    assert np_alpha_bits(np.array([2.0 ** 49]))[0] == 50


@pytest.mark.parametrize("bench", [BENCHES[0], BENCHES[4]],
                         ids=[IDS[0], IDS[4]])
def test_profile_pipeline_equals_the_reference(bench):
    name, ref_build, port_build, params = bench
    imgs = samples(name, (24, 32), 3, n=3)
    want = ref_profile_pipeline(ref_build(), imgs,
                                ref_profile_runner(ref_build()), params)
    runner = E.make_profile_runner(port_build(), device="cpu")
    got = profile_pipeline(port_build(), to_torch(imgs), runner, params)

    def host_runner(img, p):       # numpy stages: the plain version
        return {k: v.numpy() for k, v in runner(img, p).items()}

    plain = profile_pipeline(port_build(), to_torch(imgs), host_runner,
                             params)
    for res in (got, plain):
        assert res.alpha_max == want.alpha_max
        assert res.alpha_avg == want.alpha_avg
        assert {n: (iv.lo, iv.hi) for n, iv in res.observed_range.items()} \
            == {n: (iv.lo, iv.hi) for n, iv in want.observed_range.items()}
        for n, (bits, cum) in want.cdf.items():
            np.testing.assert_array_equal(res.cdf[n][0], bits)
            np.testing.assert_array_equal(res.cdf[n][1], cum)


def test_profile_refuses_non_finite_stages():
    name, ref_build, port_build, params = BENCHES[0]
    pipe = port_build()

    def runner(img, p):
        return {n: torch.tensor([[1.0, float("inf")]]) for n in pipe.stages}

    with pytest.raises(ValueError, match="non-finite"):
        profile_pipeline(pipe, [None], runner)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
def test_profile_pass_key_equals_the_reference(as_tensor):
    name, ref_build, port_build, params = BENCHES[4]
    imgs = samples(name, (8, 8), 2, n=2)
    want = RA.ProfilePass(imgs, params={"a": 1.0})
    got = PA.ProfilePass(to_torch(imgs) if as_tensor else imgs,
                         params={"a": 1.0}, device="cpu")
    assert got.key() == want.key()
    assert got.column == want.column == "profile"


# ---------------------------------------------------------------------------
# run_plan: the whole plan, text for text
# ---------------------------------------------------------------------------

def phase5_passes(mod, prof):
    """The pass list `chip_smoke.py` phase 5 runs, for either package."""
    return ["interval", "affine", "intersect", prof,
            mod.refine("interval", prof), mod.cluster("interval")]


@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_run_plan_json_equals_the_reference(bench):
    name, ref_build, port_build, params = bench
    imgs = samples(name, (40, 40), 11)
    rpipe, ppipe = ref_build(), port_build()
    want = RA.run_plan(rpipe, phase5_passes(
        RA, RA.ProfilePass(imgs, params=params)), betas=betas_of(rpipe))
    got = PA.run_plan(ppipe, phase5_passes(
        PA, PA.ProfilePass(to_torch(imgs), params=params, device="cpu")),
        betas=betas_of(ppipe))
    assert got.to_json() == want.to_json()
    assert got.content_hash == PA.pipeline_content_hash(ppipe) \
        == RA.pipeline_content_hash(rpipe)
    # the plan-level orders the paper states
    got.check_nesting(["profile", "interval"])
    got.check_nesting(["interval", "cluster(interval)"])
    got.check_nesting(["intersect", "interval"])
    for col in got.columns:
        assert got.alphas(col) == want.alphas(col)
        assert got.signed(col) == want.signed(col)
        assert {n: sr_tuple(v) for n, v in got.stage_ranges(col).items()} \
            == {n: sr_tuple(v) for n, v in want.stage_ranges(col).items()}
    assert got.stages() == want.stages()


@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_interval_design_equals_the_committed_types(bench):
    name, ref_build, port_build, params = bench
    pipe = port_build()
    plan = PA.run_plan(pipe, ["interval"], betas=betas_of(pipe))
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no alpha clamp on the way
        assert design_from_plan(plan) == load_types(name)
        assert design_from_plan(plan, "interval", betas={}) != \
            load_types(name)


def test_meet_and_widen_equal_the_reference():
    name, ref_build, port_build, params = BENCHES[3]
    want = RA.run_plan(ref_build(), [
        RA.meet("interval", "affine"), RA.widen_to("intersect", 8),
        RA.widen_to(RA.meet("affine", "intersect"), 40)])
    got = PA.run_plan(port_build(), [
        PA.meet("interval", "affine"), PA.widen_to("intersect", 8),
        PA.widen_to(PA.meet("affine", "intersect"), 40)])
    assert got.to_json() == want.to_json()
    assert any("alpha budget 8 exceeded" in note
               for note in got.provenance["widen(intersect,8)"].notes)


def test_homogeneity_clusters_equal_the_reference():
    for name, ref_build, port_build, params in BENCHES:
        rp, pp = ref_build(), port_build()
        assert PA.stage_rates(pp) == RA.stage_rates(rp)
        assert PA.homogeneity_clusters(pp, analyze_direct(pp)) == \
            RA.homogeneity_clusters(rp, ref_analyze_direct(rp))


def test_nesting_violation_raises():
    name, ref_build, port_build, params = BENCHES[0]
    pipe = port_build()
    imgs = samples(name, (16, 16), 1, n=1)
    plan = PA.run_plan(pipe, ["interval", PA.ProfilePass(
        imgs, params=params, device="cpu")])
    plan.check_nesting(["profile", "interval"])
    with pytest.raises(PA.PlanNestingError, match="interval .* ⊄ profile"):
        plan.check_nesting(["interval", "profile"])
    with pytest.raises(ValueError, match="duplicate plan column"):
        plan.add_column("interval", plan.stage_ranges("interval"),
                        plan.provenance["interval"])


# ---------------------------------------------------------------------------
# run_plan: memo, disk cache, tracing
# ---------------------------------------------------------------------------

def test_run_plan_memoizes_and_shares_sub_passes(fresh):
    pipe = BENCHES[0][2]()
    PA.run_plan(pipe, ["interval", "affine"])
    assert dict(PA.MEMO_STATS) == {"hits": 0, "misses": 2}
    PA.run_plan(pipe, ["interval", PA.meet("interval", "affine")])
    # the meet's two sub-passes and the standalone interval all hit
    assert dict(PA.MEMO_STATS) == {"hits": 3, "misses": 3}
    PA.clear_memo()
    assert dict(PA.MEMO_STATS) == {"hits": 0, "misses": 0}


def _disk_cache_sequence(mod, pipe, path):
    """The reference's disk-cache round trip: miss and write, hit, then
    other passes / betas miss."""
    plans = [mod.run_plan(pipe, ["interval"], betas={"blurx": 2},
                          cache_dir=str(path)),
             mod.run_plan(pipe, ["interval"], betas={"blurx": 2},
                          cache_dir=str(path)),
             mod.run_plan(pipe, ["affine"], cache_dir=str(path)),
             mod.run_plan(pipe, ["interval"], betas={"blurx": 3},
                          cache_dir=str(path))]
    return plans, sorted(p.name for p in path.iterdir())


def test_disk_cache_round_trips_as_the_reference(fresh, tmp_path):
    name, ref_build, port_build, params = BENCHES[0]
    before = dict(RA.DISK_CACHE_STATS)
    want, want_files = _disk_cache_sequence(RA, ref_build(),
                                            tmp_path / "ref")
    ref_delta = {k: RA.DISK_CACHE_STATS[k] - before[k] for k in before}
    got, got_files = _disk_cache_sequence(PA, port_build(),
                                          tmp_path / "port")
    assert dict(PA.DISK_CACHE_STATS) == ref_delta == \
        {"hits": 1, "misses": 3, "writes": 3, "skips": 0}
    assert got_files == want_files and len(got_files) == 3
    assert [p.to_json() for p in got] == [p.to_json() for p in want]
    for f in got_files:
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "ref" / f).read_text()


def test_disk_cache_rewrites_a_corrupt_entry(fresh, tmp_path):
    pipe = BENCHES[0][2]()
    PA.run_plan(pipe, ["interval"], cache_dir=str(tmp_path))
    (entry,) = tmp_path.iterdir()
    entry.write_text("{not json")
    plan = PA.run_plan(pipe, ["interval"], cache_dir=str(tmp_path))
    assert dict(PA.DISK_CACHE_STATS) == {"hits": 0, "misses": 2,
                                         "writes": 2, "skips": 0}
    assert json.loads(entry.read_text()) == json.loads(plan.to_json())


def test_disk_cache_skips_process_local_runners_and_warns_once(fresh,
                                                               tmp_path):
    name, ref_build, port_build, params = BENCHES[0]
    pipe = port_build()
    imgs = samples(name, (8, 8), 4, n=1)
    runner = E.make_profile_runner(pipe, device="cpu")
    prof = PA.ProfilePass(imgs, runner=runner, params=params)
    with pytest.warns(RuntimeWarning, match="process-local"):
        PA.run_plan(pipe, [prof], cache_dir=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the second skip is silent
        PA.run_plan(pipe, [prof], cache_dir=str(tmp_path))
    assert PA.DISK_CACHE_STATS["skips"] == 2
    # the reference counts the same for the same two calls
    before = dict(RA.DISK_CACHE_STATS)
    ref_prof = RA.ProfilePass(imgs, runner=ref_profile_runner(ref_build()),
                              params=params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(2):
            RA.run_plan(ref_build(), [ref_prof],
                        cache_dir=str(tmp_path / "ref"))
    assert {k: RA.DISK_CACHE_STATS[k] - before[k] for k in before} == \
        {"hits": 0, "misses": 0, "writes": 0, "skips": 2}
    assert PA.MEMO_STATS["hits"] == 1
    assert list(tmp_path.iterdir()) == []
    # two instances with custom runners never share a memo entry
    other = PA.ProfilePass(imgs, runner=runner, params=params)
    assert other.key() != prof.key()
    # a stable key_suffix makes the same pass cacheable on disk
    named = PA.ProfilePass(imgs, runner=runner, params=params,
                           key_suffix=":cpu-runner")
    PA.run_plan(pipe, [named], cache_dir=str(tmp_path))
    assert PA.DISK_CACHE_STATS["writes"] == 1


def _span_shape(tr):
    return [(s.name, {k: v for k, v in s.attrs.items() if k != "hash"})
            for s in tr.spans()]


def test_traced_run_plan_records_the_reference_spans(fresh):
    name, ref_build, port_build, params = BENCHES[1]
    with obs.tracing() as tr:
        PA.run_plan(port_build(), ["interval", PA.meet("interval",
                                                       "intersect")])
        obs.event("after.plan", n=1)
    RA.clear_memo()
    with ref_obs.tracing() as ref_tr:
        RA.run_plan(ref_build(), ["interval", RA.meet("interval",
                                                      "intersect")])
    assert _span_shape(tr) == _span_shape(ref_tr)
    (plan_span,) = tr.spans("analysis.run_plan")
    assert all(s.parent_id is not None for s in tr.spans("analysis.pass"))
    assert [e["name"] for e in tr.events()] == ["after.plan"]
    assert plan_span.t1 >= plan_span.t0
    # off outside `tracing()`: spans are a shared no-op
    with obs.span("x") as sp:
        assert sp.set(a=1) is sp
    assert not tr.spans("x")


def test_public_names_are_the_reference_s_but_smt():
    import repro.core as RC
    import repro_torch.core as PC
    assert set(PA.__all__) == set(RA.__all__) - {"SmtPass"}
    assert set(PC.__all__) == set(RC.__all__)
    for name in PA.__all__:
        assert hasattr(PA, name), name


def test_exec_cache_stats_is_a_counter_group():
    assert isinstance(E.EXEC_CACHE_STATS, obs.CounterGroup)
    assert E.EXEC_CACHE_STATS.name == "lowering.executor_cache"
    assert set(E.EXEC_CACHE_STATS) == {"hits", "misses", "evictions"}
