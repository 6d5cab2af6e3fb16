"""The port's paper tables and `alpha_delta` against the reference's.

`repro_torch.benchmarks.paper_tables` on ``device="cpu"`` (every design
through the band kernel's plain version) must print the reference's
rows: Table II and Figure 6 whole, the bit-width and power/area helpers
on small setups, Table 11's plans (deadline-free, small node budgets)
and Table 12's frontier (the reference's search through its numpy
oracle, since its ``"lowered"`` path cannot run under this JAX).
Tolerance 0: the rows are the reference's formatted strings.  No test
writes under `benchmarks/results/`: the committed goldens are read only,
and the module checks their bytes before and after.
"""
import hashlib
import json
import math
import warnings
from pathlib import Path

import pytest

import repro.analysis as RA
import repro.smt as RSMT
import repro_torch.analysis as PA
import repro_torch.smt as PSMT
from benchmarks import paper_tables as T
from repro.dse import ErrorBudget as RefBudget
from repro.dse import run_design_search as ref_search
from repro.pipelines import workflows as RW
from repro_torch.analysis import BitwidthPlan
from repro_torch.benchmarks import alpha_delta as AD
from repro_torch.benchmarks import paper_tables as P
from repro_torch.pipelines import workflows as W
from _torch_threads import one_torch_thread  # noqa: F401

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
SMALL = dict(time_budget_s=math.inf, max_nodes=64, work_budget=4096)


def _digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(RESULTS.iterdir())}


@pytest.fixture(autouse=True, scope="module")
def goldens_untouched():
    before = _digest()
    yield
    assert _digest() == before


def _rows(rows):
    return [list(map(str, r)) for r in rows]


@pytest.mark.parametrize("name", ["table2_hcd_ranges", "fig6_beta_sweep"])
def test_whole_tables_equal_the_reference(name):
    rows, derived = getattr(P, name)("cpu")
    want_rows, want = getattr(T, name)()
    assert _rows(rows) == _rows(want_rows)
    assert derived == want


def _setups(name):
    kw = dict(n_train=2, n_test=2, shape=(16, 16))
    return (RW.ALL_BENCHMARKS[name](**kw),
            W.ALL_BENCHMARKS[name](device="cpu", **kw))


@pytest.mark.parametrize("name", ["usm", "hcd", "dus"])
def test_bitwidth_table_helper_equals_the_reference(name):
    ref, got = _setups(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = T._bitwidth_table(ref, beta_hi=6)
    assert P._bitwidth_table(got, beta_hi=6) == want


@pytest.mark.parametrize("name", ["usm", "dus_ext"])
def test_power_area_table_helper_equals_the_reference(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want_rows, want = T._power_area_table(lambda: _setups(name)[0],
                                              name, 1.0, 2.0)
    rows, derived = P._power_area_table(lambda: _setups(name)[1], name,
                                        1.0, 2.0)
    assert _rows(rows) == _rows(want_rows)
    assert derived == want


def test_table11_plans_and_alpha_delta(tmp_path, capsys):
    """Table 11 cut to three groups at small deadline-free budgets: the
    plans' JSON equals the reference's text for text, `alpha_delta`
    reports no move against them and exits 0, a golden with a smaller
    smt alpha makes it exit 1, and the committed golden is only read."""
    PA.clear_memo()
    RA.clear_memo()
    groups = ["usm", "dus", "dus_ext"]
    rows, derived = P.table11_smt_alphas(
        "cpu", out_dir=str(tmp_path),
        smt_configs={g: PSMT.SMTConfig(**SMALL) for g in groups},
        groups=groups)
    assert derived.startswith("profile<=smt<=interval nesting holds: True")
    port = json.loads((tmp_path / "table11_plans.json").read_text())
    assert port["device"] == "cpu" and sorted(port["groups"]) == \
        sorted(groups)
    makers = {"usm": RW.make_usm, "dus": RW.make_dus,
              "dus_ext": RW.make_dus_ext}
    golden = {"version": 1, "groups": {}}
    for g in groups:
        plan = makers[g](3, 3, (32, 32)).plan(
            smt_config=RSMT.SMTConfig(**SMALL), phases=True)
        golden["groups"][g] = plan.to_json_dict()
        assert json.dumps(port["groups"][g], sort_keys=True) == \
            json.dumps(golden["groups"][g], sort_keys=True)
        assert BitwidthPlan.from_json(json.dumps(port["groups"][g])
                                      ).to_json() == plan.to_json()
    gpath = tmp_path / "golden.json"
    gpath.write_text(json.dumps(golden))
    plans = str(tmp_path / "table11_plans.json")
    assert AD.main(["--plans", plans, "--golden", str(gpath)]) == 0
    out = capsys.readouterr().out
    assert "usm: delta +0 bits (none; 0 new stages); alpha sums" in out
    # a golden that proved a smaller smt alpha: the port's grew
    stage = next(iter(golden["groups"]["usm"]["columns"]["smt"]))
    golden["groups"]["usm"]["columns"]["smt"][stage]["alpha"] -= 1
    gpath.write_text(json.dumps(golden))
    assert AD.main(["--plans", plans, "--golden", str(gpath),
                    "--markdown"]) == 1
    cap = capsys.readouterr()
    assert "ALPHA REGRESSION" in cap.err and "| usm | +1 |" in cap.out
    # the committed golden (all six groups): three are missing here
    lines, regressed, dropped = AD.report(plans, AD.GOLDEN)
    assert AD.GOLDEN == str(RESULTS / "table11_plans.json")
    assert {g for g, _ in dropped} == {"hcd", "optical_flow", "of_pyramid"}
    PA.clear_memo()


def test_table12_frontier_equals_the_reference():
    """The design search on a small USM setup with an interval + profile
    plan: the port's Table XII rows (band-kernel plain version, every
    point verified) equal the reference's search through its oracle."""
    from repro.analysis import ProfilePass
    PA.clear_memo()
    RA.clear_memo()
    ref, got = _setups("usm")
    rplan = RA.run_plan(ref.pipeline,
                        ["interval", ProfilePass(ref.train_images,
                                                 params=ref.params)],
                        default_column="interval")
    plan = BitwidthPlan.from_json(rplan.to_json())
    assert plan.default_column == "interval"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = ref_search(ref.pipeline, rplan, ref.train_images,
                         RefBudget(min_psnr=50.0), params=ref.params,
                         seed=0, anneal_iters=16, backend="numpy")
        rows, derived = P.design_frontier(got, plan)
    want = [(p.strategy, f"{p.psnr:.2f}", f"{p.power:.0f}",
             f"{p.lut_bits:.0f}", f"{p.dsp_bits:.0f}", p.total_bits)
            for p in res.frontier.points()]
    assert _rows(rows) == _rows(want)
    assert derived.startswith(f"USM frontier: {len(want)} verified points")
    PA.clear_memo()


def test_main_runs_named_tables_on_a_named_device(tmp_path, capsys):
    assert P.main(["--only", "table2_hcd_ranges,fig5_cdf", "--device",
                   "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    assert out[2].startswith("table2_hcd_ranges,cpu,")
    rec = json.loads((tmp_path / "fig5_cdf.json").read_text())
    want_rows, want = T.fig5_cdf()
    assert rec["rows"] == _rows(want_rows) and rec["derived"] == want
    assert rec["device"] == "cpu"
    with pytest.raises(SystemExit):
        P.main(["--only", "table13"])
    assert set(P.TABLES) == set(T.__dict__) & set(P.TABLES)
