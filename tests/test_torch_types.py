"""Bit-width designs carried into the PyTorch port as data.

The committed type files under `src/repro_torch/pipelines/types/` must
equal what the JAX package computes for the serving benchmark (static
interval alphas, beta 4 on every stage), and `types_from_data` must read
the plan's JSON shape back exactly.  The helpers here also serve the
other `test_torch_*` files: the benchmark list and the conversion of the
reference's designs into port data.
"""
import warnings

import numpy as np
import pytest

import repro_torch.pipelines as tp
from repro.analysis import run_plan
from repro.core.interval import Interval
from repro.core.range_analysis import StageRange
from repro.pipelines import dus, hcd, optical_flow, usm
from repro.pipelines import workflows as W
from repro_torch.pipelines.types import (DesignTypes, load_types,
                                         types_from_data)
from _torch_threads import one_torch_thread  # noqa: F401

# (name, reference builder, port builder, params)
BENCHES = [
    ("usm", usm.build, tp.usm.build, dict(usm.DEFAULT_PARAMS)),
    ("hcd", hcd.build, tp.hcd.build, {}),
    ("dus", dus.build, tp.dus.build, {}),
    ("dus_ext", dus.build_extended, tp.dus.build_extended, {}),
    ("of", optical_flow.build, tp.optical_flow.build, {}),
    ("of_pyramid", optical_flow.build_pyramid,
     tp.optical_flow.build_pyramid, {}),
]
IDS = [b[0] for b in BENCHES]
# input stages per benchmark: optical flow takes two frames
N_IN = {"of": 2, "of_pyramid": 2}


def ref_types(pipe, beta=4):
    """The reference's design: static interval alphas, one beta."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        alphas, signed = W.static_alphas(pipe)
        return W.types_from_alpha(pipe, alphas, signed,
                                  {n: beta for n in pipe.stages})


def to_data(types, phase_types=None):
    """Reference type map (+ per-residue types) -> port design data."""
    def entry(t):
        return {"alpha": t.alpha, "beta": t.beta, "signed": t.signed}

    data = {"types": {n: entry(t) for n, t in types.items()}}
    if phase_types:
        data["phases"] = {
            s: {"lattice": list(lat),
                "ranges": {f"{ry},{rx}": entry(t)
                           for (ry, rx), t in rmap.items()}}
            for s, (lat, rmap) in phase_types.items()}
    return data


def phase_plan(pipe, betas=3):
    """Interval plan with per-residue ranges tighter than true, so
    per-residue saturation engages on random data (the dus_ext plan of
    tests/test_lowering.py)."""
    plan = run_plan(pipe, ["interval"],
                    betas={n: betas for n in pipe.stages})

    def sr(lo, hi):
        return StageRange.from_interval(Interval(lo, hi))

    plan.phases["interval"] = {
        "resS": ((2, 1), {(0, 0): sr(-50.0, 50.0)}),
        "UyS": ((2, 1), {(0, 0): sr(0.0, 150.0), (1, 0): sr(0.0, 250.0)}),
        "band": ((2, 2), {(0, 0): sr(-30.0, 30.0)}),
    }
    return plan


def plan_design(plan):
    """A reference `BitwidthPlan` -> port `DesignTypes`."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return types_from_data(to_data(plan.types(), plan.phase_types()))


def frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float64)


def bench_frames(name, shape, seed):
    """A benchmark's input: one frame, or a tuple of frames (seeds
    `seed`, `seed + 1`, ...) for a pipeline with several inputs."""
    n = N_IN.get(name, 1)
    if n == 1:
        return frames(shape, seed)
    return tuple(frames(shape, seed + k) for k in range(n))


def _fields(t):
    return (t.alpha, t.beta, t.signed)


@pytest.mark.parametrize("name,ref_build,port_build,params", BENCHES,
                         ids=IDS)
def test_committed_types_equal_the_reference(name, ref_build, port_build,
                                             params):
    want = ref_types(ref_build())
    got = load_types(name)
    assert got.phase_types() == {}
    assert sorted(got.types()) == sorted(want) == sorted(port_build().stages)
    for n, t in want.items():
        assert _fields(got.types()[n]) == _fields(t), n


def test_types_from_data_round_trips():
    design = plan_design(phase_plan(dus.build_extended()))
    again = types_from_data(design.to_data())
    assert again == design
    assert again.to_json() == design.to_json()
    assert isinstance(again, DesignTypes)


def test_plan_json_phases_read_back_as_the_plan_types():
    """The "phases" entry of `BitwidthPlan.to_json` (ranges with lo/hi and
    no beta) reads back as `BitwidthPlan.phase_types`."""
    plan = phase_plan(dus.build_extended())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        data = {"types": to_data(plan.types())["types"],
                "phases": plan.to_json_dict()["phases"]["interval"]}
        want = plan.phase_types()
    got = types_from_data(data).phase_types()
    assert sorted(got) == sorted(want)
    for stage, (lat, rmap) in want.items():
        assert got[stage][0] == tuple(lat)
        assert {r: _fields(t) for r, t in got[stage][1].items()} == \
            {r: _fields(t) for r, t in rmap.items()}
