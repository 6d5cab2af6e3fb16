"""The per-stage f32 walk against the reference's ``backend="jax"``.

`run_fixed(backend="f32")` and `run_float(backend="f32")` run the
per-stage walk in f32 tensors under XLA's f32 rules
(`repro_torch.core.xla_f32`); they must equal the reference's legacy
jnp walk (`repro.dsl.exec.run_fixed(..., backend="jax")`, eager XLA on
the CPU at JAX's default x32) at tolerance 0: every value, its sign bit
and its dtype, on the six benchmarks with types from the port's interval
analysis, batched and single, on the saturating phase-split plan, on
inputs holding subnormals, and in the runtime telemetry.  The XLA rules
themselves are held to jnp on special values.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as RO
from repro.core.fixedpoint import FixedPointType as RefType
from repro.core.fixedpoint import fix_round as ref_fix_round
from repro.dsl.exec import run_fixed as ref_run_fixed
from repro.dsl.exec import run_float as ref_run_float
from repro_torch import obs as PO
from repro_torch.core import xla_f32 as X
from repro_torch.core.fixedpoint import FixedPointType, fix_round_f32
from repro_torch.dsl import exec as E
from repro_torch.lowering import LoweringError
from repro_torch.pipelines import workflows as PW
from test_torch_types import (BENCHES, IDS, N_IN, bench_frames, frames,
                              phase_plan, plan_design)
from _torch_threads import one_torch_thread  # noqa: F401


def _same(want, got, what=""):
    """Tolerance 0: equal values (NaN equal to NaN), equal sign bits,
    equal dtype."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype == np.float32, (what, got.dtype)
    assert got.shape == want.shape, what
    both_nan = np.isnan(want) & np.isnan(got)
    same = (want == got) & (np.signbit(want) == np.signbit(got))
    bad = ~(same | both_nan)
    assert not bad.any(), (f"{what}: {int(bad.sum())} values differ, e.g. "
                           f"{want[bad][:4]} vs {got[bad][:4]}")


def _port_types(pipe, beta):
    """The port's interval design (its own analysis), and the same
    types as the reference's objects."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        alphas, signed = PW.static_alphas(pipe)
        types = PW.types_from_alpha(pipe, alphas, signed,
                                    {n: beta for n in pipe.stages})
    return types, {n: RefType(t.alpha, t.beta, t.signed)
                   for n, t in types.items()}


CASES = [(b, s, beta) for b in BENCHES
         for s, beta in (((24, 32), 4), ((2, 20, 24), 7))]


@pytest.mark.parametrize("bench,shape,beta", CASES,
                         ids=[f"{b[0]}-{'x'.join(map(str, s))}-b{beta}"
                              for b, s, beta in CASES])
def test_f32_fixed_equals_the_reference_jax_walk(bench, shape, beta):
    name, ref_build, port_build, params = bench
    types, rtypes = _port_types(port_build(), beta)
    img = bench_frames(name, shape, 41)
    want = ref_run_fixed(ref_build(), img, rtypes, params, backend="jax")
    got = E.run_fixed(port_build(), img, types, params, backend="f32",
                      device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        _same(want[k], got[k], k)


@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_f32_float_equals_the_reference_jax_walk(bench):
    name, ref_build, port_build, params = bench
    img = bench_frames(name, (24, 32), 43)
    want = ref_run_float(ref_build(), img, params, backend="jax")
    got = E.run_float(port_build(), img, params, device="cpu",
                      backend="f32")
    assert sorted(got) == sorted(want)
    for k in want:
        _same(want[k], got[k], k)
    # the batched float walk is the per-image loop
    both = E.run_float(port_build(), bench_frames(name, (2, 24, 32), 43),
                       params, device="cpu", backend="f32")
    first = E.run_float(port_build(), bench_frames(name, (24, 32), 43),
                        params, device="cpu", backend="f32")
    for k in first:
        assert torch.equal(both[k][0], first[k])


def test_f32_walk_on_the_saturating_phase_plan():
    name, ref_build, port_build, params = BENCHES[3]         # dus_ext
    plan = phase_plan(ref_build())
    img = frames((48, 48), 3)
    want = ref_run_fixed(ref_build(), img, plan, backend="jax")
    got = E.run_fixed(port_build(), img, plan_design(plan), backend="f32",
                      device="cpu")
    for k in want:
        _same(want[k], got[k], k)
    union = E.run_fixed(port_build(), img, plan.types(), backend="f32",
                        device="cpu")
    assert not torch.equal(union["resS"], got["resS"])   # residues clipped


def _tiny_frames(rng, shape, n):
    """Fractional pixels with subnormal, tiny and zero values planted:
    the walk must read and write them as XLA does."""
    def one():
        x = rng.uniform(0, 255, shape)
        idx = rng.integers(0, x.size, 24)
        x.flat[idx] = rng.choice([0.0, 1e-40, 3e-39, 1e-42, 1e-30, 255.0], 24)
        return x
    return tuple(one() for _ in range(n)) if n > 1 else one()


@pytest.mark.parametrize("bench", BENCHES, ids=IDS)
def test_f32_walk_on_subnormal_and_fractional_pixels(bench):
    name, ref_build, port_build, params = bench
    rng = np.random.default_rng(47)
    img = _tiny_frames(rng, (20, 24), N_IN.get(name, 1))
    types, rtypes = _port_types(port_build(), 6)
    want = ref_run_fixed(ref_build(), img, rtypes, params, backend="jax")
    got = E.run_fixed(port_build(), img, types, params, backend="f32",
                      device="cpu")
    for k in want:
        _same(want[k], got[k], k)
    want = ref_run_float(ref_build(), img, params, backend="jax")
    got = E.run_float(port_build(), img, params, device="cpu",
                      backend="f32")
    for k in want:
        _same(want[k], got[k], k)


def test_f32_walk_telemetry_equals_the_reference():
    name, ref_build, port_build, params = BENCHES[1]         # hcd
    types, rtypes = _port_types(port_build(), 4)
    img = frames((24, 24), 5)
    with RO.tracing(runtime_ranges=True) as rtr:
        ref_run_fixed(ref_build(), img, rtypes, params, backend="jax")
    with PO.tracing(runtime_ranges=True) as ptr:
        E.run_fixed(port_build(), img, types, params, backend="f32",
                    device="cpu")
    want = [dict(e["attrs"]) for e in rtr.events("rt.range")]
    got = [dict(e["attrs"]) for e in ptr.events("rt.range")]
    assert [w.pop("backend") for w in want] == ["jax"] * len(want)
    assert [g.pop("backend") for g in got] == ["f32"] * len(got)
    assert got == want


def test_f32_walk_refuses_an_odd_pyramid_as_every_backend_does():
    name, ref_build, port_build, params = BENCHES[5]
    types, _ = _port_types(port_build(), 4)
    img = bench_frames(name, (47, 48), 7)
    with pytest.raises(LoweringError, match=r"stage 'Vx1'.* 'Avgx1' gives "
                                            r"\(48, 48\), 'Ix' gives "
                                            r"\(47, 48\)"):
        E.run_fixed(port_build(), img, types, params, backend="f32",
                    device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        E.run_float(port_build(), img, params, device="cpu",
                    backend="cuda")


# ---------------------------------------------------------------------------
# XLA's f32 rules, held to jnp on special values
# ---------------------------------------------------------------------------

SPECIAL = np.array([0.0, -0.0, 1e-40, -1e-40, 3e-39, -1.2e-38, 1.17549435e-38,
                    1e-30, -1e-20, 0.5, -1.5, 2.5, 3.0, 1e20, -3e38, np.inf,
                    -np.inf, np.nan, 7.0, -7.0], dtype=np.float32)


def _pairs():
    a = np.repeat(SPECIAL, len(SPECIAL))
    b = np.tile(SPECIAL, len(SPECIAL))
    rng = np.random.default_rng(3)
    r = rng.uniform(-4, 4, 4096).astype(np.float32)
    return np.concatenate([a, r]), np.concatenate([b, r[::-1].copy()])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "max", "min",
                                "lt", "ge", "sqrt", "abs"])
def test_xla_f32_ops_equal_jnp(op):
    a, b = _pairs()
    xp = X.F32XP(torch.device("cpu"))
    A, Bv = X.F32(torch.from_numpy(a), False), X.F32(torch.from_numpy(b),
                                                      False)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    port = {"add": lambda: A + Bv, "sub": lambda: A - Bv,
            "mul": lambda: A * Bv, "div": lambda: A / Bv,
            "max": lambda: xp.maximum(A, Bv), "min": lambda: xp.minimum(A, Bv),
            "lt": lambda: A < Bv, "ge": lambda: A >= Bv,
            "sqrt": lambda: xp.sqrt(A), "abs": lambda: xp.abs(A)}[op]()
    ref = {"add": lambda: ja + jb, "sub": lambda: ja - jb,
           "mul": lambda: ja * jb, "div": lambda: ja / jb,
           "max": lambda: jnp.maximum(ja, jb),
           "min": lambda: jnp.minimum(ja, jb),
           "lt": lambda: ja < jb, "ge": lambda: ja >= jb,
           "sqrt": lambda: jnp.sqrt(ja), "abs": lambda: jnp.abs(ja)}[op]()
    if op in ("lt", "ge"):
        np.testing.assert_array_equal(port.t.numpy(), np.asarray(ref))
    else:
        _same(ref, port.t, op)


@pytest.mark.parametrize("n", [-3, -2, -1, 0, 1, 2, 3, 4, 5, 7])
def test_integer_pow_equals_jnp(n):
    a, _ = _pairs()
    _same(jnp.asarray(a) ** n, (X.F32(torch.from_numpy(a), False) ** n).t,
          f"x ** {n}")


@pytest.mark.parametrize("number", [0.1, 1 / 3, 2.0 ** -130, 1e39, 255.0])
def test_python_numbers_meet_f32_as_weak_scalars(number):
    a, _ = _pairs()
    A = X.F32(torch.from_numpy(a), False)
    for port, ref in ((A * number, jnp.asarray(a) * number),
                      (number / A, number / jnp.asarray(a)),
                      (number - A, number - jnp.asarray(a))):
        _same(ref, port.t, str(number))


TYPES = [(4, 4, True), (8, 0, False), (40, 3, True), (26, 6, False),
         (31, 2, True), (3, 9, True)]


@pytest.mark.parametrize("alpha,beta,signed", TYPES)
def test_fix_round_f32_equals_the_reference(alpha, beta, signed):
    """The clip bounds are f32: above 2^24 `float(t.int_max)` rounds."""
    a, b = _pairs()
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.concatenate([a, a * b, a * np.float32(2.0 ** 26)]).astype(
            np.float32)
    want = ref_fix_round(jnp.asarray(x), RefType(alpha, beta, signed))
    got = fix_round_f32(torch.from_numpy(x),
                        FixedPointType(alpha, beta, signed))
    _same(want, got, f"{alpha}.{beta}")
    assert math.isfinite(float(got[0]))
