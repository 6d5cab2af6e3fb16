"""The rest of the port's `run_fixed` surface against the JAX package.

Bit for bit, on the CPU: the whole-stage-env backends ``"lowered"`` and
``"interp"`` on every stage of the six benchmarks, `run_float`, a
reference `BitwidthPlan` with two columns and phases carried across by
JSON under each ``column=``, `make_jitted_fixed(outputs=...)`,
`partition_islands(outputs=...)`, and the `core.fixedpoint` array ops
(the reference under ``jax.enable_x64(True)``, and `np_quantize`).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lowering as rl
import repro_torch.lowering as pl_
from repro.analysis import run_plan
from repro.analysis.plan import Provenance as RefProvenance
from repro.core import fixedpoint as rfx
from repro.core.interval import Interval as RefInterval
from repro.core.range_analysis import StageRange as RefStageRange
from repro.dsl.exec import run_fixed as ref_run_fixed
from repro.dsl.exec import run_float as ref_run_float
from repro.pipelines import dus
from repro_torch.analysis.plan import BitwidthPlan
from repro_torch.core import fixedpoint as pfx
from repro_torch.dsl import exec as E
from repro_torch.pipelines.types import types_from_data
from test_torch_lowering import _sched_fields
from test_torch_types import (BENCHES, IDS, bench_frames, ref_types,
                              to_data)
from _torch_threads import one_torch_thread  # noqa: F401


def _env_equal(oracle, got, names):
    for k in names:
        assert got[k].dtype == torch.float64, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(oracle[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["lowered", "interp"])
@pytest.mark.parametrize("shape", [(40, 40), (2, 40, 40)],
                         ids=["single", "batched"])
@pytest.mark.parametrize("name,ref_build,port_build,params", BENCHES,
                         ids=IDS)
def test_whole_env_backends_equal_the_oracle_on_every_stage(
        name, ref_build, port_build, params, shape, backend):
    rpipe = ref_build()
    types = ref_types(rpipe)
    img = bench_frames(name, shape, 31)
    oracle = ref_run_fixed(rpipe, img, types, params)
    for datapath in ("exact", "narrow"):
        got = E.run_fixed(port_build(), img, types_from_data(to_data(types)),
                          params, backend=backend, datapath=datapath,
                          device="cpu")
        assert sorted(got) == sorted(rpipe.stages)
        _env_equal(oracle, got, rpipe.stages)


@pytest.mark.parametrize("name,ref_build,port_build,params", BENCHES,
                         ids=IDS)
def test_run_float_equals_the_reference(name, ref_build, port_build, params):
    img = bench_frames(name, (40, 40), 41)
    want = ref_run_float(ref_build(), img, params)
    got = E.run_float(port_build(), img, params, device="cpu")
    assert sorted(got) == sorted(want)
    _env_equal(want, got, want)
    runner = E.make_profile_runner(port_build(), device="cpu")
    again = runner(img, params)
    for k in got:
        assert torch.equal(again[k], got[k])
    # a batch runs image by image
    batch = bench_frames(name, (2, 40, 40), 41)
    stacked = E.run_float(port_build(), batch, params, device="cpu")
    one = E.run_float(port_build(), tuple(b[1] for b in batch)
                      if isinstance(batch, tuple) else batch[1], params,
                      device="cpu")
    for k in one:
        assert torch.equal(stacked[k][1], one[k])


def _two_column_plan():
    """dus_ext: the interval column with its betas, plus a "tight"
    column whose ranges are narrower than the true ones on a few stages
    (so the columns saturate differently), each with its own phases."""
    pipe = dus.build_extended()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plan = run_plan(pipe, ["interval"],
                        betas={n: 3 for n in pipe.stages})

    def sr(lo, hi):
        return RefStageRange.from_interval(RefInterval(lo, hi))

    tight = plan.stage_ranges("interval")
    tight.update(band=sr(-20.0, 20.0), res=sr(-40.0, 40.0),
                 Uy=sr(0.0, 200.0))
    plan.add_column("tight", tight, RefProvenance("manual", "tight"),
                    phases={"resS": ((2, 1), {(0, 0): sr(-30.0, 30.0)})})
    plan.phases["interval"] = {
        "UyS": ((2, 1), {(0, 0): sr(0.0, 150.0), (1, 0): sr(0.0, 250.0)}),
        "band": ((2, 2), {(0, 0): sr(-30.0, 30.0)})}
    return plan


def test_plan_json_reads_and_writes_the_reference_text():
    ref = _two_column_plan()
    plan = BitwidthPlan.from_json(ref.to_json())
    assert plan.to_json() == ref.to_json()
    assert plan.columns.keys() == ref.columns.keys()
    assert plan.default_column == ref.default_column == "interval"
    for col in ("interval", "tight", None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want_t, want_p = ref.types(col), ref.phase_types(col)
            got_t, got_p = plan.types(col), plan.phase_types(col)
        assert {n: str(t) for n, t in got_t.items()} == \
            {n: str(t) for n, t in want_t.items()}
        assert {s: (lat, {r: str(t) for r, t in m.items()})
                for s, (lat, m) in got_p.items()} == \
            {s: (tuple(lat), {r: str(t) for r, t in m.items()})
             for s, (lat, m) in want_p.items()}
    with pytest.raises(KeyError, match="no column"):
        plan.types("affine")


def test_plan_alpha_clamp_warns_and_notes_as_the_reference():
    ref = _two_column_plan()
    ref.columns["tight"]["band"] = RefStageRange(RefInterval(0.0, 0.0), 0,
                                                 False)
    plan = BitwidthPlan.from_json(ref.to_json())
    with pytest.warns(RuntimeWarning, match="alpha clamped to 1"):
        want = ref.types("tight")
    with pytest.warns(RuntimeWarning, match="alpha clamped to 1"):
        got = plan.types("tight")
    assert str(got["band"]) == str(want["band"]) == "u1.3"
    assert plan.to_json() == ref.to_json()      # the same provenance note


@pytest.mark.parametrize("backend", ["torch", "lowered", "interp"])
def test_plan_columns_carried_by_json_equal_the_oracle(backend):
    ref = _two_column_plan()
    plan = BitwidthPlan.from_json(ref.to_json())
    pipe = BENCHES[3][2]()
    img = bench_frames("dus_ext", (2, 48, 48), 13)
    outs = {}
    for col in ("interval", "tight"):
        want = ref_run_fixed(dus.build_extended(), img, ref, column=col)
        for datapath in ("exact", "narrow"):
            got = E.run_fixed(pipe, img, plan, backend=backend, column=col,
                              datapath=datapath, device="cpu")
            _env_equal(want, got, got)
        outs[col] = got
    # the columns differ where the tight ranges saturate
    assert any(not torch.equal(outs["interval"][k], outs["tight"][k])
               for k in outs["tight"])


def test_column_and_datapath_key_the_executor_memo():
    plan = BitwidthPlan.from_json(_two_column_plan().to_json())
    pipe = BENCHES[3][2]()
    keys = {E.executor_cache_key(pipe, plan, {}, "torch", col, dp, "cpu")
            for col in (None, "interval", "tight")
            for dp in ("exact", "narrow")}
    assert len(keys) == 6
    img = bench_frames("dus_ext", (32, 32), 2)
    E.clear_executor_cache()
    misses = E.EXEC_CACHE_STATS["misses"]
    for col in ("interval", "tight", "interval"):
        E.run_fixed(pipe, img, plan, backend="torch", column=col,
                    device="cpu")
    assert E.EXEC_CACHE_STATS["misses"] == misses + 2
    prev = E.set_executor_cache_cap(1)
    try:
        assert len(E._MEMO) == 1
        with pytest.raises(ValueError):
            E.set_executor_cache_cap(0)
    finally:
        E.set_executor_cache_cap(prev)


# (benchmark index, requested stages): intermediates, an input, stages of
# several rate islands
OUTPUTS = [(1, ["Ixx", "trace"]), (2, ["Dy", "img"]), (3, ["band", "Ux"]),
           (4, ["Denom", "Common2", "Vy1"]), (5, ["cVx0", "UVy", "It"])]


@pytest.mark.parametrize("k,outputs", OUTPUTS,
                         ids=[f"{BENCHES[k][0]}-{'-'.join(o)}"
                              for k, o in OUTPUTS])
def test_partition_islands_with_outputs_equals_the_reference(k, outputs):
    name, ref_build, port_build, params = BENCHES[k]
    types = ref_types(ref_build())
    rlp = rl.lower(ref_build(), types, params=params)
    plp = pl_.lower(port_build(), types_from_data(to_data(types)),
                    params=params)
    for shape in ((48, 48), (47, 48), (1080, 1920)):
        want = rl.partition_islands(rlp, shape, outputs=outputs)
        got = pl_.partition_islands(plp, shape, outputs=outputs)
        assert (got.order, got.inputs, got.outputs) == \
            (want.order, want.inputs, want.outputs)
        assert len(got.islands) == len(want.islands)
        for g, w in zip(got.islands, want.islands):
            assert (g.idx, g.stages, g.inputs, g.outputs, g.rate,
                    g.single_tile) == (w.idx, w.stages, w.inputs,
                                       w.outputs, w.rate, w.single_tile)
            assert _sched_fields(g.schedule) == _sched_fields(w.schedule)
    # make_jitted_fixed: the band-kernel executor of those stages (its
    # plain version on CPU tensors)
    img = bench_frames(name, (2, 48, 48), 5)
    oracle = ref_run_fixed(ref_build(), img, types, params)
    run = E.make_jitted_fixed(port_build(), types_from_data(to_data(types)),
                              params, outputs=outputs, device="cpu")
    got = run(img)
    assert sorted(got) == sorted(outputs)
    _env_equal(oracle, got, outputs)


# ---------------------------------------------------------------------------
# core.fixedpoint's array ops
# ---------------------------------------------------------------------------

TYPES = [(8, 4, False), (9, 4, True), (1, 0, True), (12, 10, True),
         (20, 12, False), (33, 8, True)]


def _qvalues(t, rng, n=512):
    q = rng.integers(t.int_min, t.int_max, n, endpoint=True)
    q[:4] = [t.int_min, t.int_max, 0, t.int_max - 1]
    return q.astype(np.int64)


@pytest.mark.parametrize("a,b,s", TYPES, ids=[f"{'s' if s else 'u'}{a}.{b}"
                                               for a, b, s in TYPES])
def test_fixedpoint_ops_equal_the_reference(a, b, s):
    rng = np.random.default_rng(a * 100 + b)
    t, rt = pfx.FixedPointType(a, b, s), rfx.FixedPointType(a, b, s)
    span = 2.0 ** (a - 1 if s else a)
    x = rng.uniform(-1.5 * span, 1.5 * span, 2048)
    x[:6] = [0.5 / 2 ** b, 1.5 / 2 ** b, -2.5 / 2 ** b, span, -span, 0.0]
    qa, qb = _qvalues(t, rng), _qvalues(t, rng)
    tx = torch.from_numpy(x)
    with jax.enable_x64(True):
        jx = jnp.asarray(x)
        pairs = [
            (pfx.quantize(tx, t), rfx.quantize(jx, rt)),
            (pfx.dequantize(torch.from_numpy(qa), t),
             rfx.dequantize(jnp.asarray(qa), rt)),
            (pfx.dequantize(torch.from_numpy(qa.astype(np.int32)), t),
             rfx.dequantize(jnp.asarray(qa.astype(np.int32)), rt)),
            (pfx.fix_round(tx, t), rfx.fix_round(jx, rt)),
            (pfx.fix_round(tx.float(), t),
             rfx.fix_round(jx.astype(jnp.float32), rt)),
            (pfx.apply_fixed(tx, t), rfx.apply_fixed(jx, rt)),
            (pfx.apply_fixed(tx, None), rfx.apply_fixed(jx, None)),
            (pfx.saturating_add(torch.from_numpy(qa), torch.from_numpy(qb),
                                t),
             rfx.saturating_add(jnp.asarray(qa), jnp.asarray(qb), rt)),
            (pfx.saturating_sub(torch.from_numpy(qa), torch.from_numpy(qb),
                                t),
             rfx.saturating_sub(jnp.asarray(qa), jnp.asarray(qb), rt)),
        ]
        # products of qvalues up to 2^31 stay exact in int64
        for tout in ((a, b, s), (a + 4, max(b - 3, 0), True),
                     (a, b + 2, s))[:3 if t.width <= 31 else 0]:
            po, ro = pfx.FixedPointType(*tout), rfx.FixedPointType(*tout)
            pairs.append((pfx.saturating_mul(torch.from_numpy(qa),
                                             torch.from_numpy(qb), t, t, po),
                          rfx.saturating_mul(jnp.asarray(qa), jnp.asarray(qb),
                                             rt, rt, ro)))
        pairs = [(g, np.asarray(w)) for g, w in pairs]
    for k, (got, want) in enumerate(pairs):
        assert got.numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(k))
    np.testing.assert_array_equal(pfx.np_quantize(x, t),
                                  rfx.np_quantize(x, rt))
    np.testing.assert_array_equal(pfx.quantize(tx, t).numpy(),
                                  rfx.np_quantize(x, rt))
    assert pfx.quant_error_bound(t) == rfx.quant_error_bound(rt)
    assert pfx.storage_bits(t) == rfx.storage_bits(rt)
    assert pfx.storage_bits(None) == rfx.storage_bits(None)


def test_quantize_scales_in_f64():
    """The reference's `quantize` at JAX's default x32 takes x to f32
    before the scaling and rounds this x to 262766 where the numpy
    oracle gives 262767 (ROADMAP, the reference's standing failures);
    the port scales in f64 and gives the oracle's value."""
    t, rt = pfx.FixedPointType(10, 10, True), rfx.FixedPointType(10, 10, True)
    x = np.array([256.6079219558196])
    got = pfx.quantize(torch.from_numpy(x), t)
    assert got.dtype == torch.int64
    assert int(got[0]) == int(rfx.np_quantize(x, rt)[0]) == 262767
    assert int(np.asarray(rfx.quantize(jnp.asarray(x), rt))[0]) == 262766
