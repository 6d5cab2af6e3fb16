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


# ---------------------------------------------------------------------------
# numpy's elementwise rules: sqrt, min/max of +-0, x ** n (`core.npops`)
# ---------------------------------------------------------------------------

def _bits(x):
    """f64 values as comparable bits: the sign of a zero counts."""
    return np.asarray(x, np.float64).view(np.int64)


def _sqrt_case(lib, T):
    p = lib.PipelineBuilder("sqrt")
    a = p.image("a", 0, 1 << 20)
    p.define("s", lib.sqrtv(a))
    return p.build(), {"a": T(21, 12, False), "s": None}


def _signed_zero_case(lib, T):
    # z1 and z2 are zeros of opposite signs wherever a != 8, so 1 / min
    # and 1 / max are infinities whose signs say which operand was taken
    p = lib.PipelineBuilder("zeros")
    a = p.image("a", 0, 15)
    z1 = p.define("z1", (a - 8.0) * 0.0)
    z2 = p.define("z2", (8.0 - a) * 0.0)
    p.define("inv_min", 1.0 / lib.minv(z1, z2))
    p.define("inv_max", 1.0 / lib.maxv(z1, z2))
    return p.build(), {"a": T(4, 0, False), "z1": None, "z2": None,
                       "inv_min": None, "inv_max": None}


def _cube_case(lib, T):
    # c: a cube the band kernel encodes (4-bit base); w: a cube of a
    # 31-bit grid, which only the per-stage and whole-frame programs run
    p = lib.PipelineBuilder("cube")
    a = p.image("a", 0, 15)
    b = p.define("b", a * 0.37 + 1.3)
    p.define("c", a ** 3)
    p.define("w", b ** 3)
    return p.build(), {"a": T(4, 0, False), "b": T(5, 26, False),
                       "c": T(13, 0, False), "w": None}


NUMPY_RULES = {"sqrt": (_sqrt_case, 1 << 20),
               "signed_zero": (_signed_zero_case, 16),
               "cube": (_cube_case, 16)}


def _rule_inputs(case):
    rng = np.random.default_rng(sorted(NUMPY_RULES).index(case))
    hi = NUMPY_RULES[case][1]
    return np.round(rng.uniform(0, hi, (24, 23)) * 4096) / 4096 \
        if case == "sqrt" else rng.integers(0, hi, (24, 23)).astype(float)


@pytest.mark.parametrize("backend", ["torch", "interp", "lowered"])
@pytest.mark.parametrize("case", list(NUMPY_RULES))
def test_numpy_elementwise_rules_equal_the_oracle(case, backend):
    """Tolerance 0, the sign of a zero included, against the reference's
    numpy oracle; the inputs split torch's own rules from numpy's."""
    import repro.dsl.builder as RB
    import repro_torch.dsl.builder as PB
    from repro_torch.core.fixedpoint import FixedPointType
    make = NUMPY_RULES[case][0]
    rpipe, rtypes = make(RB, RefType)
    pipe, types = make(PB, FixedPointType)
    img = _rule_inputs(case)
    oracle = ref_run_fixed(rpipe, img, rtypes)
    t = torch.from_numpy(oracle["a"])
    if case == "sqrt":       # torch's CPU sqrt is off on some of these
        assert not np.array_equal(torch.sqrt(t).numpy(), oracle["s"])
    elif case == "signed_zero":
        # torch's CPU minimum takes the first of +0 and -0 outside its
        # vector lanes (rows of 3 here), numpy the second
        z1, z2 = oracle["z1"][:, :3], oracle["z2"][:, :3]
        assert not np.array_equal(
            _bits(torch.minimum(torch.from_numpy(z1),
                                torch.from_numpy(z2))),
            _bits(np.minimum(z1, z2)))
    else:
        b = torch.from_numpy(oracle["b"])
        assert not np.array_equal(torch.pow(b, 3.0).numpy(), oracle["w"])
    if backend == "torch" and case == "cube":
        with pytest.raises(pl_.LoweringError, match=r"x \*\* 3.*53"):
            E.run_fixed(pipe, img, types, backend="torch", device="cpu")
        pipe.outputs.remove("w")
        rpipe.outputs.remove("w")
    got = E.run_fixed(pipe, img, types, backend=backend, device="cpu")
    names = sorted(set(got) & set(oracle))
    assert set(rpipe.outputs) <= set(names)
    for k in names:
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(oracle[k]), err_msg=k)


def test_smt_csp_with_a_cube_equals_the_reference():
    """The SMT engines on a CSP with cubes: numpy's `x ** 3` and
    `x ** (1/3)` in the batched transfer functions, hc4 sweeps and
    concrete evaluation on seeded sub-boxes, every bit; and
    `analyze_smt` deadline-free, both engines, against `repro.smt`."""
    import math

    import repro.dsl.builder as RB
    import repro.smt as RSMT
    import repro_torch.dsl.builder as PB
    import repro_torch.smt as PSMT
    from repro.core.range_analysis import analyze as ref_analyze
    from repro.smt import encoder as REnc
    from repro.smt import solver as RS
    from repro_torch.core.range_analysis import analyze
    from repro_torch.smt import encoder as PEnc
    from repro_torch.smt import solver as PS

    def make(lib):
        p = lib.PipelineBuilder("cube_csp")
        a = p.image("a", 0, 255)
        b = p.define("b", a * 0.37 + 1.3)
        c = p.define("c", b ** 3 - a * 2.1)
        p.define("d", c - b ** 3 + lib.absv(b - 40.0) ** 3)
        return p.build()

    rng = np.random.default_rng(5)
    x = rng.uniform(-1e3, 1e3, 4096)
    t = torch.from_numpy(x)
    # torch's own cube differs from numpy's on these
    assert not np.array_equal(torch.pow(t, 3.0).numpy(), x ** 3)
    lo, hi = np.minimum(x[::2], x[1::2]), np.maximum(x[::2], x[1::2])
    for w, g in zip(RS._b_pow(lo, hi, 3), PS._b_pow(torch.from_numpy(lo),
                                                    torch.from_numpy(hi), 3)):
        assert np.array_equal(_bits(g.numpy()), _bits(w))
    assert np.array_equal(_bits(PS._b_root(t, 3).numpy()),
                          _bits(RS._b_root(x, 3)))
    rp, pp = make(RB), make(PB)
    rcsp, _ = REnc.encode_stage(rp, "d", {n: r.range for n, r in
                                          ref_analyze(rp).items()})
    pcsp, _ = PEnc.encode_stage(pp, "d", {n: r.range for n, r in
                                          analyze(pp).items()})
    rprog, pprog = REnc.compile_csp(rcsp), PEnc.compile_csp(pcsp)
    u = np.sort(rng.random((2, 40, rprog.nvars)), axis=0)
    blo = rprog.init_lo + (rprog.init_hi - rprog.init_lo) * u[0]
    bhi = rprog.init_lo + (rprog.init_hi - rprog.init_lo) * u[1]
    tlo, thi = torch.from_numpy(blo.copy()), torch.from_numpy(bhi.copy())
    alive = RS.hc4_batch(rprog, blo, bhi, np.ones(40, bool), 6)
    talive = PS.hc4_batch(pprog, tlo, thi, torch.ones(40, dtype=torch.bool),
                          6)
    assert np.array_equal(alive, talive.numpy())
    assert np.array_equal(_bits(tlo.numpy()), _bits(blo))
    assert np.array_equal(_bits(thi.numpy()), _bits(bhi))
    pts = 0.5 * (blo + bhi)
    assert np.array_equal(
        _bits(PS.concrete_batch(pprog, torch.from_numpy(pts)).numpy()),
        _bits(RS.concrete_batch(rprog, pts)))
    for engine in ("batched", "scalar"):
        want = RSMT.analyze_smt(rp, config=RSMT.SMTConfig(
            engine=engine, time_budget_s=math.inf))
        got = PSMT.analyze_smt(pp, config=PSMT.SMTConfig(
            engine=engine, time_budget_s=math.inf), device="cpu")
        assert {n: (r.range.lo, r.range.hi, r.alpha) for n, r in
                got.items()} == {n: (r.range.lo, r.range.hi, r.alpha)
                                 for n, r in want.items()}, engine
