"""The port's `obs` against the JAX package's: tracer API, exporters,
runtime range telemetry and the report.

Tolerance 0 throughout.  Exported records are compared in structure
(names, kinds, attributes, parent links), never in times or thread ids.
`rt.range` records of the port's executors on the CPU are held equal to
the reference's numpy-oracle records for the same pipeline, image and
types, single and batched (a batch joins min/max and sums rail counts
over the per-image records).  Every test scopes tracing with `with` or
ends it with `disable()` in a `finally`.
"""
import json
import math

import numpy as np
import pytest
import torch

import repro.obs as RO
import repro_torch.obs as PO
from repro.dsl.exec import run_fixed as ref_run_fixed
from repro.obs import report as rreport
from repro_torch.dsl import exec as E
from repro_torch.obs import report as preport
from test_torch_types import (BENCHES, bench_frames, phase_plan,
                              plan_design, ref_types, to_data)
from repro_torch.pipelines.types import types_from_data
from _torch_threads import one_torch_thread  # noqa: F401

_TIMES = ("ts_us", "dur_us", "thread", "wall_t0")


def _strip(recs):
    """JSONL records without times, thread ids and the counter snapshot
    (each package registers its own counter groups)."""
    return [{k: v for k, v in r.items() if k not in _TIMES}
            for r in recs if r["kind"] != "counters"]


def _emit(obs, tensor_attrs):
    """The same instrumentation sequence through either package's API."""
    with obs.span("outer", pipeline="p", n=3) as sp:
        obs.event("mark", stage="a", value=1.5)
        with obs.span("inner", stage="b"):
            obs.gauge("depth", 2, unit="levels")
            obs.event("inner.mark", x=float("inf"), arr=tensor_attrs)
        sp.set(result="ok", count=np.int64(7), f=np.float32(0.25))
    obs.gauge("after", 0.5)


def test_tracer_api_and_exporters_equal_the_reference():
    """enable/disable/active_tracer/is_enabled/runtime_ranges_enabled,
    gauges, and the JSONL / Chrome records field for field; a 0-dim or
    small tensor exports as the same numbers as the reference's numpy
    value."""
    for obs in (RO, PO):
        assert not obs.is_enabled() and obs.active_tracer() is None
        assert not obs.runtime_ranges_enabled()
    recs, chrome = {}, {}
    for key, obs, attr in ((0, RO, np.array([1.0, 2.5, -0.0])),
                           (1, PO, torch.tensor([1.0, 2.5, -0.0]))):
        tr = obs.enable(runtime_ranges=True)
        try:
            assert obs.is_enabled() and obs.active_tracer() is tr
            assert obs.runtime_ranges_enabled()
            _emit(obs, attr)
        finally:
            assert obs.disable() is tr
        assert not obs.is_enabled() and obs.disable() is None
        recs[key] = obs.to_jsonl_records(tr)
        chrome[key] = obs.to_chrome_trace(tr, process_name="x")
        assert [e["name"] for e in tr.events()] == \
            ["mark", "depth", "inner.mark", "after"]
        assert [e["value"] for e in tr.events() if e["kind"] == "gauge"] \
            == [2, 0.5]
    assert _strip(recs[1]) == _strip(recs[0])
    assert recs[1][0]["runtime_ranges"] is True
    strip_c = [[{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
                for e in c["traceEvents"]] for c in (chrome[0], chrome[1])]
    assert strip_c[1] == strip_c[0]
    # a 0-dim tensor is one number; a CUDA tensor would be copied first
    from repro_torch.obs.exporters import _jsonable
    assert _jsonable(torch.tensor(3.5)) == 3.5 == RO.exporters._jsonable(
        np.float64(3.5))
    assert _jsonable(torch.tensor(-math.inf)) == "-inf"
    with PO.tracing() as tr:
        assert not PO.runtime_ranges_enabled()
    assert PO.active_tracer() is None


def test_counter_groups_register_and_export(tmp_path):
    import repro_torch.analysis  # noqa: F401  (registers analysis.memo)
    import repro_torch.smt.solver  # noqa: F401  (registers smt.solver)
    g = PO.CounterGroup("test.obs.group", hits=0, secs=0.0)
    g.add("hits", 2)
    g.set("secs", 1.25)
    assert PO.all_counters()["test.obs.group"] == {"hits": 2, "secs": 1.25}
    with PO.tracing() as tr:
        PO.event("x")
    path = tmp_path / "t.jsonl"
    PO.write_jsonl(tr, path)
    recs = PO.load_jsonl(path)
    assert recs[0]["kind"] == "meta" and recs[-1]["kind"] == "counters"
    assert recs[-1]["values"]["test.obs.group"] == {"hits": 2, "secs": 1.25}
    assert {"analysis.memo", "lowering.executor_cache", "smt.solver"} <= \
        set(recs[-1]["values"])
    PO.write_chrome_trace(tr, tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    g.reset()
    assert dict(g) == {"hits": 0, "secs": 0.0}


# ---------------------------------------------------------------------------
# runtime range telemetry
# ---------------------------------------------------------------------------

def _rt(tr):
    return [dict(e["attrs"]) for e in tr.events("rt.range")]


def _ref_records(rpipe, img, types, params):
    with RO.tracing(runtime_ranges=True) as tr:
        out = ref_run_fixed(rpipe, img, types, params)
    return _rt(tr), out


def _port_records(pipe, img, design, params, backend):
    with PO.tracing(runtime_ranges=True) as tr:
        out = E.run_fixed(pipe, img, design, params, backend=backend,
                          device="cpu")
    return _rt(tr), out


def _join(records, backend):
    """Per-image records of one stage joined into one batched record:
    min/max join, counts sum, observed alpha of the joined range."""
    from repro_torch.core.fixedpoint import alpha_for_range
    out = dict(records[0], backend=backend)
    out["n"] = sum(r["n"] for r in records)
    if "min" in out:
        out["min"] = min(r["min"] for r in records)
        out["max"] = max(r["max"] for r in records)
        out["alpha_obs"] = int(alpha_for_range(out["min"], out["max"]))
        if "alpha_plan" in out:
            out["headroom"] = out["alpha_plan"] - out["alpha_obs"]
    for k in ("sat_lo", "sat_hi", "sat"):
        if k in out:
            out[k] = sum(r[k] for r in records)
    if "sat_phases" in out:
        ph = {}
        for r in records:
            for res, c in r["sat_phases"].items():
                ph[res] = ph.get(res, 0) + c
        out["sat_phases"] = ph
    return out


CASES = [(BENCHES[0], None), (BENCHES[1], None), (BENCHES[3], "phase"),
         (BENCHES[4], None)]


@pytest.mark.parametrize("backend", ["interp", "lowered", "torch"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("bench,plan", CASES,
                         ids=[f"{b[0]}-{p or 'types'}" for b, p in CASES])
def test_rt_range_records_equal_the_reference(bench, plan, batched,
                                              backend):
    """The port's records, stage by stage, equal the reference's numpy
    oracle's (backend names aside); the band-kernel executor records the
    outputs only; a batch's records are the per-image records joined.
    The outputs with telemetry on equal those with it off."""
    name, ref_build, port_build, params = bench
    rpipe = ref_build()
    if plan is None:
        types = ref_types(rpipe)
        design = types_from_data(to_data(types))
    else:
        types = phase_plan(rpipe)
        design = plan_design(types)
    shape = (2, 20, 24) if batched else (20, 24)
    img = bench_frames(name, shape, 11)
    want, _ = _ref_records(rpipe, img, types, params)
    got, out = _port_records(port_build(), img, design, params, backend)
    off = E.run_fixed(port_build(), img, design, params, backend=backend,
                      device="cpu")
    assert sorted(off) == sorted(out)
    for k in out:
        assert torch.equal(out[k], off[k]), k
    if plan == "phase":
        assert any(r.get("sat_phases") for r in want)
    assert all(r["backend"] == "interp" for r in want)
    assert got and all(r["backend"] == backend for r in got)
    stages = [r["stage"] for r in want]
    if backend == "interp":
        assert got == want
        return
    # a batched reference run records one image after the other
    per = {}
    for r in want:
        per.setdefault(r["stage"], []).append(r)
    order = list(dict.fromkeys(stages))
    if backend == "torch":
        order = [s for s in order if s in rpipe.outputs]
    assert got == [_join(per[s], backend) for s in order]


def test_rt_range_counts_rails_and_skips_nonfinite():
    """`record_stage` on its own: rails per type and per residue, NaN and
    infinities left out of the range, against the reference's numpy."""
    from repro.core.fixedpoint import FixedPointType as RT
    from repro_torch.core.fixedpoint import FixedPointType as PT
    rng = np.random.default_rng(3)
    v = np.round(rng.uniform(-10, 10, (2, 9, 11)) * 4) / 4
    v[0, 0, :3] = [np.nan, np.inf, -np.inf]
    v[1, 2, 4] = 7.75                     # the s3.2 upper rail
    v[1, 3, 3] = -8.0                     # its lower rail
    for t, pt, phase in (
            (RT(3, 2, True), PT(3, 2, True), None),
            (RT(4, 0, False), PT(4, 0, False), None),
            (RT(3, 2, True), PT(3, 2, True),
             ((2, 1), {(0, 0): "lo", (1, 0): "hi"}))):
        rph = pph = None
        if phase is not None:
            lat, m = phase
            rph = (lat, {k: RT(2, 2, True) if s == "lo" else t
                         for k, s in m.items()})
            pph = (lat, {k: PT(2, 2, True) if s == "lo" else pt
                         for k, s in m.items()})
        with RO.tracing(runtime_ranges=True):
            want = RO.runtime.record_stage("s", v, t, rph, "b")
        with PO.tracing(runtime_ranges=True):
            got = PO.runtime.record_stage("s", torch.from_numpy(v), pt, pph,
                                          "b")
        assert got == want
    assert PO.runtime.record_stage("s", v) is None     # telemetry off
    with PO.tracing(runtime_ranges=True):
        assert "min" not in PO.runtime.record_stage(
            "s", np.full((2, 2), np.nan))


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _reference_trace():
    """A reference trace with every kind the report reads: analysis
    passes, runtime telemetry and stage spans, synthetic SMT stage,
    island and design-search records."""
    from repro.analysis import run_plan
    rpipe = BENCHES[0][1]()
    with RO.tracing(runtime_ranges=True) as tr:
        plan = run_plan(rpipe, ["interval", "affine"])
        ref_run_fixed(rpipe, bench_frames("usm", (16, 16), 2), plan,
                      BENCHES[0][3])
        with RO.span("smt.stage", stage="det", boxes=120, budget_s=3.0,
                     consumed_s=1.5, verdict="tight",
                     deadline_exhausted=True):
            pass
        for isl in (1, 0, 1):
            with RO.span("exec.pallas.island", island=isl, rate="1",
                         stages=3, grid=4, single_tile=False,
                         carriers="int64x3", containers="uint8x3",
                         out_mb=0.01, saved_mb=0.02):
                pass
        with RO.span("dse.evaluate", pipeline="usm", strategy="anneal",
                     psnr=51.5):
            pass
        RO.event("dse.evaluate", pipeline="usm", strategy="anneal",
                 result="cached")
        RO.event("dse.accept", pipeline="usm", strategy="anneal",
                 psnr=51.5, power=400.0, area=300.0, total_bits=40)
    return RO.to_jsonl_records(tr)


def test_report_summarize_and_render_equal_the_reference(tmp_path, capsys):
    recs = json.loads(json.dumps(_reference_trace()))
    want = rreport.summarize(recs)
    got = preport.summarize(recs)
    assert got == want
    assert got["runtime"] and got["islands"] and got["dse_frontier"]
    for md in (False, True):
        assert preport.render(got, markdown=md) == rreport.render(
            want, markdown=md).replace("pallas islands", "islands")
    path = tmp_path / "trace.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert preport.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "== runtime stages ==" in out and "== islands ==" in out
    assert preport.render({k: [] for k in got}) == \
        "(trace contains no summarizable spans)\n"
