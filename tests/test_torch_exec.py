"""The port's `run_fixed` against the reference's numpy oracle, bit for bit.

`repro_torch.dsl.exec.run_fixed(backend="torch", device="cpu")` runs the
rate-island executor with the band kernel's plain version; it must equal
`repro.dsl.exec.run_fixed(backend="numpy")` on every benchmark, single
and batched, on a saturating phase plan, on a mixed-beta phase map, and
with pre-quantized uint8 frames.  ``backend="cuda"`` on CPU tensors runs
the same plain version and launches nothing.
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.lowering as pl_
from repro.core.fixedpoint import FixedPointType as RefType
from repro.dsl.exec import _run_concrete
from repro.dsl.exec import run_fixed as ref_run_fixed
from repro_torch.dsl import exec as E
from repro_torch.kernels.stencil import kernel as K
from repro_torch.lowering import backends as pb
from repro_torch.pipelines.types import types_from_data
from test_torch_types import (BENCHES, IDS, bench_frames, frames,
                              phase_plan, plan_design, ref_types, to_data)
from _torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(48, 48), (47, 48), (3, 48, 48)]


def _assert_outputs_equal(oracle, got, names):
    assert sorted(got) == sorted(names)
    for k in names:
        want = np.asarray(oracle[k])
        assert got[k].dtype == torch.float64
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


# of_pyramid decimates and re-expands both frames, so the reference
# defines it on even heights and widths only (at 47 rows its upsampled
# flow has 48): `test_of_pyramid_at_an_odd_size_raises_on_every_backend`
# holds that
ORACLE_CASES = [(b, s) for b in BENCHES for s in SHAPES
                if not (b[0] == "of_pyramid" and (s[-2] % 2 or s[-1] % 2))]
ODD = [(47, 48), (2, 47, 48), (48, 47), (2, 48, 47)]


@pytest.mark.parametrize("bench,shape", ORACLE_CASES,
                         ids=[f"{b[0]}-{'x'.join(map(str, s))}"
                              for b, s in ORACLE_CASES])
def test_torch_backend_equals_the_oracle(bench, shape):
    name, ref_build, port_build, params = bench
    rpipe = ref_build()
    types = ref_types(rpipe)
    img = bench_frames(name, shape, 7)
    oracle = ref_run_fixed(rpipe, img, types, params)
    got = E.run_fixed(port_build(), img, types_from_data(to_data(types)),
                      params, backend="torch", device="cpu")
    _assert_outputs_equal(oracle, got, rpipe.outputs)


@pytest.mark.parametrize("shape", ODD,
                         ids=["x".join(map(str, s)) for s in ODD])
@pytest.mark.parametrize("backend", E.BACKENDS)
def test_of_pyramid_at_an_odd_size_raises_on_every_backend(backend, shape):
    """Where the oracle fails on a broadcast, every backend refuses the
    shape with a `LoweringError` naming the stage and both shapes."""
    name, ref_build, port_build, params = BENCHES[5]
    img = bench_frames(name, shape, 7)
    with pytest.raises(ValueError):
        ref_run_fixed(ref_build(), img, ref_types(ref_build()), params)
    design = types_from_data(to_data(ref_types(ref_build())))
    h, w = shape[-2:]
    with pytest.raises(pl_.LoweringError,
                       match=rf"stage 'Vx1'.* 'Avgx1' gives \(48, 48\), "
                             rf"'Ix' gives \({h}, {w}\)"):
        E.run_fixed(port_build(), img, design, params, backend=backend,
                    device="cpu")


@pytest.mark.parametrize("shape", [(48, 48), (3, 48, 48)],
                         ids=["single", "batched"])
def test_saturating_phase_plan_equals_the_oracle(shape):
    name, ref_build, port_build, params = BENCHES[3]
    rpipe = ref_build()
    plan = phase_plan(rpipe)
    img = frames(shape, 3)
    oracle = ref_run_fixed(rpipe, img, plan)
    got = E.run_fixed(port_build(), img, plan_design(plan), backend="torch",
                      device="cpu")
    _assert_outputs_equal(oracle, got, rpipe.outputs)
    # the per-residue bounds must actually saturate on this data
    union = ref_run_fixed(rpipe, img, plan.types())
    assert not np.array_equal(np.asarray(union["resS"]),
                              got["resS"].numpy())


def test_mixed_beta_phase_map_takes_the_float_store():
    """A residue type with another beta than its union type: the stage
    is stored as oracle floats, per-residue re-snapped."""
    name, ref_build, port_build, params = BENCHES[3]
    rpipe = ref_build()
    types = phase_plan(rpipe).types()
    phases = {"resS": ((2, 1), {(0, 0): RefType(8, 1, True)})}
    img = frames((48, 48), 5)
    oracle = _run_concrete(rpipe, img, {}, types, xp=np,
                           phase_types=phases)
    design = types_from_data(to_data(types, phases))
    lp = pl_.lower(port_build(), design)
    assert lp.stages["resS"].store_float
    got = E.run_fixed(port_build(), img, design, backend="torch",
                      device="cpu")
    _assert_outputs_equal(oracle, got, rpipe.outputs)


def test_uint8_frames_are_ingested_zero_copy():
    name, ref_build, port_build, params = BENCHES[0]
    types = ref_types(ref_build(), beta=0)
    design = types_from_data(to_data(types))
    lp = pl_.lower(port_build(), design, params=params)
    assert pb.store_dtype(lp.stages["img"]) == torch.uint8
    f64 = frames((3, 48, 48), 9)
    u8 = torch.from_numpy(f64.astype(np.uint8))
    assert pb.ingest_input(u8, lp.stages["img"]) is u8
    oracle = ref_run_fixed(ref_build(), f64, types, params)
    got = E.run_fixed(port_build(), u8, design, params, backend="torch",
                      device="cpu")
    _assert_outputs_equal(oracle, got, ["masked"])


def test_cuda_backend_on_the_cpu_runs_the_plain_version():
    name, ref_build, port_build, params = BENCHES[1]
    design = types_from_data(to_data(ref_types(ref_build())))
    img = frames((2, 48, 48), 4)
    before = dict(K.LAUNCHES)
    got = E.run_fixed(port_build(), img, design, params, backend="cuda",
                      device="cpu")
    want = E.run_fixed(port_build(), img, design, params, backend="torch",
                       device="cpu")
    assert K.LAUNCHES == before
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="unknown backend"):
        E.run_fixed(port_build(), img, design, params, backend="pallas",
                    device="cpu")


def test_concurrent_calls_compile_one_executor():
    name, ref_build, port_build, params = BENCHES[0]
    design = types_from_data(to_data(ref_types(ref_build())))
    pipe = port_build()
    img = frames((32, 32), 1)
    E.clear_executor_cache()
    misses = E.EXEC_CACHE_STATS["misses"]
    outs = [None] * 8

    def go(k):
        outs[k] = E.run_fixed(pipe, img, design, params, backend="torch",
                              device="cpu")

    threads = [threading.Thread(target=go, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert E.EXEC_CACHE_STATS["misses"] == misses + 1
    for o in outs[1:]:
        assert torch.equal(o["masked"], outs[0]["masked"])
