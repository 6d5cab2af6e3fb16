"""The band-sharded executor on the CPU against the reference.

`run_fixed(backend="sharded")` and `compile_backend(lp, "sharded",
mesh=make_band_mesh(n, device="cpu"))` (every shard the one CPU device,
each running the band kernel's plain version over its band range) must
equal the reference's numpy oracle bit for bit: on the serving
benchmarks of tests/test_serving.py, batched and single, on a saturating
phase-split plan and on the warned serial fallback.  The plain
version's band ranges, joined, must equal the whole walk and, range by
range, the reference's shard body `repro.lowering.sharded._band_walk`
(run eagerly under a scoped ``jax.enable_x64(True)``).  `tile_rows` in
the island partition and the band-row rule `spec_for` must equal the
reference's.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lowering as rl
import repro_torch.lowering as pl_
import repro_torch.pipelines as tp
from repro.dsl.exec import run_fixed as ref_run_fixed
from repro.launch.sharding import spec_for as ref_spec_for
from repro.lowering import backends as rb
from repro.lowering.pallas_backend import island_program as ref_program
from repro.lowering.sharded import _band_walk
from repro.pipelines import dus, hcd, optical_flow, usm
from repro_torch import obs
from repro_torch.dsl import exec as E
from repro_torch.kernels.stencil import kernel as K
from repro_torch.launch import BASE_RULES, make_band_mesh, spec_for
from repro_torch.lowering import backends as pb
from repro_torch.lowering.cuda_backend import island_program
from repro_torch.pipelines.types import types_from_data
from test_torch_types import (BENCHES as ALL, frames, phase_plan,
                              plan_design, ref_types, to_data)
from _torch_threads import one_torch_thread  # noqa: F401

# tests/test_serving.py's BENCHES: (name, the reference's pipeline
# constructor, the port's, params, inputs, shape)
SERVING = [
    ("usm", usm.build, tp.usm.build, dict(usm.DEFAULT_PARAMS), 1, (48, 48)),
    ("hcd", hcd.build, tp.hcd.build, {}, 1, (48, 48)),
    ("dus_ext", dus.build_extended, tp.dus.build_extended, {}, 1, (48, 48)),
    ("of_pyramid", lambda: optical_flow.build_pyramid(1),
     lambda: tp.optical_flow.build_pyramid(1), {}, 2, (40, 40)),
]


def _batch(n_in, B, shape, seed):
    rng = np.random.default_rng(seed)
    arrs = tuple(rng.integers(0, 256, (B,) + shape).astype(np.float64)
                 for _ in range(n_in))
    return arrs if n_in > 1 else arrs[0]


def _single(arg, n_in):
    return tuple(a[0] for a in arg) if n_in > 1 else arg[0]


def _equal(oracle, got, names, index=None):
    assert sorted(got) == sorted(names)
    for k in names:
        want = np.asarray(oracle[k])
        want = want if index is None else want[index]
        assert got[k].dtype == torch.float64, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


def _port_lowered(port_build, types, params):
    return pl_.lower(port_build(), types_from_data(to_data(types)),
                     params=params)


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name,ref_build,port_build,params,n_in,shape",
                         SERVING, ids=[b[0] for b in SERVING])
def test_sharded_equals_the_oracle(name, ref_build, port_build, params,
                                   n_in, shape, shards):
    """Batched and then single images through one executor; every
    island splits over the mesh (the grid of 6 or 5 bands divides, or
    the island falls back and says so)."""
    rpipe = ref_build()
    types = ref_types(rpipe)
    arg = _batch(n_in, 3, shape, seed=5)
    oracle = ref_run_fixed(rpipe, arg, types, params)
    lp = _port_lowered(port_build, types, params)
    run = pl_.compile_backend(lp, "sharded", device="cpu",
                              mesh=make_band_mesh(shards, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with obs.tracing() as tr:
            got = run(arg)
        _equal(oracle, got, rpipe.outputs)
        _equal(oracle, run(_single(arg, n_in)), rpipe.outputs, index=0)
    (span,) = tr.spans("exec.sharded")
    grid = shape[0] // 8
    assert span.attrs["shards"] == shards
    assert span.attrs["sharded_islands"] == (1 if grid % shards == 0
                                             else 0)


@pytest.mark.parametrize("name,ref_build,port_build,params,n_in,shape",
                         SERVING, ids=[b[0] for b in SERVING])
def test_run_fixed_sharded_on_the_cpu_mesh(name, ref_build, port_build,
                                           params, n_in, shape):
    rpipe = ref_build()
    types = ref_types(rpipe)
    arg = _batch(n_in, 2, shape, seed=7)
    oracle = ref_run_fixed(rpipe, arg, types, params)
    design = types_from_data(to_data(types))
    got = E.run_fixed(port_build(), arg, design, params, backend="sharded",
                      device="cpu")
    _equal(oracle, got, rpipe.outputs)
    one = E.run_fixed(port_build(), _single(arg, n_in), design, params,
                      backend="sharded", device="cpu")
    _equal(oracle, one, rpipe.outputs, index=0)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("shape", [(48, 48), (3, 48, 48)],
                         ids=["single", "batched"])
def test_sharded_saturating_phase_plan(shape, shards):
    """Per-residue saturation through the band ranges: the (0, 0)
    residue rail of `resS` must clip somewhere, else this proved
    nothing."""
    rpipe = dus.build_extended()
    plan = phase_plan(rpipe)
    imgs = frames(shape, 9)
    oracle = ref_run_fixed(rpipe, imgs, plan)
    lp = pl_.lower(tp.dus.build_extended(), plan_design(plan))
    assert lp.stages["resS"].phase is not None
    got = pl_.compile_backend(lp, "sharded", device="cpu",
                              mesh=make_band_mesh(shards, device="cpu"))(imgs)
    _equal(oracle, got, rpipe.outputs)
    t_res = lp.stages["resS"].phase.types[(0, 0)]
    q = np.rint(np.asarray(oracle["resS"])[..., 0::2, :] * 2.0 ** t_res.beta)
    assert (np.count_nonzero(q >= t_res.int_max)
            + np.count_nonzero(q <= t_res.int_min)) > 0


def test_non_dividing_and_single_tile_islands_fall_back_and_warn_once():
    """dus at 47 rows: islands of 1 and 3 bands over 2 shards, and a
    single-tile island, run the serial band walk, warned once each in
    the reference's words, and still equal the oracle."""
    rpipe = dus.build()
    types = ref_types(rpipe)
    img = _batch(1, 2, (47, 48), seed=14)
    oracle = ref_run_fixed(rpipe, img, types, {})
    lp = _port_lowered(tp.dus.build, types, {})
    run = pl_.compile_backend(lp, "sharded", device="cpu",
                              mesh=make_band_mesh(2, device="cpu"))
    obs.reset_warn_once()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with obs.tracing() as tr:
            got = run(img)
            again = run(img)
    _equal(oracle, got, rpipe.outputs)
    _equal(oracle, again, rpipe.outputs)
    msgs = [str(w.message) for w in rec if "serial band walk" in
            str(w.message)]
    assert sorted(msgs) == sorted(set(msgs)) and len(msgs) == 3, msgs
    assert any("(single-tile island)" in m for m in msgs)
    assert any("grid 3 does not divide over 2 shards" in m for m in msgs)
    assert all("pad the image or shrink the mesh" in m for m in msgs)
    islands = [s.attrs for s in tr.spans("exec.sharded.island")]
    assert [a["sharded"] for a in islands] == [False] * 6


# ---------------------------------------------------------------------------
# band ranges of the plain version
# ---------------------------------------------------------------------------

RANGE_CASES = [(b, s) for b in ALL for s in (2, 3, 4)]


@pytest.mark.parametrize("bench,shards", RANGE_CASES,
                         ids=[f"{b[0]}-S{s}" for b, s in RANGE_CASES])
def test_band_ranges_join_to_the_whole_walk_and_equal_band_walk(bench,
                                                                shards):
    """At 96 x 40 every island is one grid of 12 bands: the ranges
    [d*k, (d+1)*k) of the plain version, joined along rows, equal one
    whole walk, and each equals the reference's shard body."""
    name, ref_build, port_build, params = bench
    types = ref_types(ref_build())
    n_in = 2 if name.startswith("of") else 1
    img = {n: frames((96, 40), 31 + k) for k, n in
           enumerate(ref_build().input_stages())}
    with jax.enable_x64(True):
        rlp = rl.lower(ref_build(), types, params=params)
        plp = _port_lowered(port_build, types, params)
        (risl,) = rl.partition_islands(rlp, (96, 40)).islands
        (pisl,) = pl_.partition_islands(plp, (96, 40)).islands
        grid = pisl.schedule.grid
        assert grid == 12 and len(img) == n_in
        k = grid // shards
        ins = [pb.ingest_input(torch.from_numpy(img[n]), plp.stages[n])
               for n in pisl.inputs]
        ref_ins = [jnp.asarray(rb.ingest_input(jnp.asarray(img[n]),
                                               rlp.stages[n], jnp))
                   for n in risl.inputs]
        enc = K.encode_program(island_program(plp, pisl))
        whole = K.fused_pipeline_reference(enc, grid)(*ins)
        parts = []
        for d in range(shards):
            got = K.fused_pipeline_reference(enc, grid,
                                             bands=(d * k, k))(*ins)
            want = _band_walk(ref_program(rlp, risl), k,
                              lambda: d * k)(*ref_ins)
            for n, g, w in zip(pisl.outputs, got, want):
                w = np.asarray(w)
                assert g.numpy().dtype == w.dtype, n
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"{n} shard {d}")
            parts.append(got)
    for o, w in enumerate(whole):
        assert torch.equal(torch.cat([p[o] for p in parts]), w)


def test_band_range_outputs_hold_the_range_rows_only():
    """A batched range allocates its own rows; a range outside the grid
    is refused."""
    name, ref_build, port_build, params = ALL[0]
    plp = _port_lowered(port_build, ref_types(ref_build()), params)
    (isl,) = pl_.partition_islands(plp, (96, 40)).islands
    enc = K.encode_program(island_program(plp, isl))
    x = pb.ingest_input(torch.from_numpy(frames((2, 96, 40), 3)),
                        plp.stages["img"])
    whole = K.fused_pipeline(enc, 12, batch=2)(x)
    (part,) = K.fused_pipeline(enc, 12, batch=2, bands=(9, 3))(x)
    assert part.shape == (2, 24, 40)
    assert torch.equal(part, whole[0][:, 72:])
    for bad in [(-1, 2), (0, 0), (10, 3)]:
        with pytest.raises(ValueError, match="do not lie in the grid"):
            K.fused_pipeline(enc, 12, bands=bad)


# ---------------------------------------------------------------------------
# the island partition's tile_rows, the mesh and the band-row rule
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return (plan.order, plan.inputs, plan.outputs,
            [(i.idx, i.stages, i.inputs, i.outputs, i.rate, i.single_tile,
              i.schedule.grid, i.schedule.tile_rows, i.schedule.order,
              {n: (s.step, s.lo, s.hi, s.H, s.W)
               for n, s in i.schedule.stages.items()})
             for i in plan.islands])


TILES = [(b, t) for b in ALL for t in (8, 16, 24, 48, 5, 96)]


@pytest.mark.parametrize("bench,tile", TILES,
                         ids=[f"{b[0]}-T{t}" for b, t in TILES])
def test_tile_rows_partition_equals_the_reference(bench, tile):
    name, ref_build, port_build, params = bench
    types = ref_types(ref_build())
    rlp = rl.lower(ref_build(), types, params=params)
    plp = _port_lowered(port_build, types, params)
    try:
        want = _plan_fields(rl.partition_islands(rlp, (48, 48),
                                                 tile_rows=tile))
    except rl.LoweringError as e:
        with pytest.raises(pl_.LoweringError) as got:
            pl_.partition_islands(plp, (48, 48), tile_rows=tile)
        assert str(got.value) == str(e)
    else:
        got = pl_.partition_islands(plp, (48, 48), tile_rows=tile)
        assert _plan_fields(got) == want


def test_compile_cuda_forces_the_tile_rows():
    name, ref_build, port_build, params = ALL[1]
    types = ref_types(ref_build())
    plp = _port_lowered(port_build, types, params)
    img = frames((48, 48), 4)
    oracle = ref_run_fixed(ref_build(), img, types, params)
    for backend in ("torch", "sharded"):
        with obs.tracing() as tr:
            got = pl_.compile_backend(plp, backend, device="cpu",
                                      tile_rows=16)(img)
        _equal(oracle, got, ref_build().outputs)
        grids = [s.attrs["grid"] for s in tr.spans()
                 if s.name.endswith(".island")]
        assert grids == [3], backend
    with pytest.raises(pl_.LoweringError, match="tile_rows=5"):
        pl_.compile_backend(plp, "torch", device="cpu", tile_rows=5)(img)


def test_band_mesh_on_the_cpu():
    m = make_band_mesh(device="cpu")
    assert m.shape == {"band": 1} and m.axis_names == ("band",)
    assert m.devices == (torch.device("cpu"),)
    assert make_band_mesh(3, device="cpu").devices == \
        (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_band_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_band_mesh()


SPECS = [((48, 40), ("band_rows", None)), ((3, 48, 40), (None, "band_rows",
                                                         None)),
         ((45, 40), ("band_rows", None)), ((48, 48), ("band_rows",
                                                      "band_rows")),
         ((48, 40), (None, "embed"))]


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,axes", SPECS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(map(str, a))}"
                              for s, a in SPECS])
def test_spec_for_equals_the_reference(shape, axes, shards):
    from jax.sharding import AbstractMesh
    ref = ref_spec_for(shape, axes, AbstractMesh((shards,), ("band",)))
    got = spec_for(shape, axes, make_band_mesh(shards, device="cpu"))
    assert got == tuple(ref)
    assert BASE_RULES["band_rows"] == "band"


def test_unknown_backends_are_refused():
    name, ref_build, port_build, params = ALL[0]
    design = types_from_data(to_data(ref_types(ref_build())))
    with pytest.raises(ValueError, match="unknown backend 'f32' for a "
                                         "compiled executor"):
        E.lowered_executor(port_build(), design, params, "f32",
                           device="cpu")
    with pytest.raises(pl_.LoweringError, match="unknown lowering backend"):
        pl_.compile_pipeline(port_build(), design, params, backend="pallas",
                             device="cpu")


def test_pipeline_server_serves_through_the_sharded_executor():
    from repro_torch.serve import PipelineServer, serve_offline
    name, ref_build, port_build, params = ALL[0]                # usm
    types = ref_types(ref_build())
    imgs = [frames((32, 40), 70 + i) for i in range(5)]
    with PipelineServer(port_build(), types_from_data(to_data(types)),
                        params, backend="sharded", batch_size=4,
                        device="cpu") as srv:
        outs = serve_offline(srv, imgs)
    for img, out in zip(imgs, outs):
        want = ref_run_fixed(ref_build(), img, types, params)
        np.testing.assert_array_equal(out["masked"].numpy(),
                                      np.asarray(want["masked"]))


def test_evaluator_scores_through_the_sharded_executor():
    """`Evaluator(backend="sharded")` gives the kernel path's scores."""
    from repro_torch.dse import ErrorBudget, Evaluator
    name, ref_build, port_build, params = ALL[1]                # hcd
    pipe = port_build()
    imgs = [frames((24, 32), 80 + i) for i in range(2)]
    signed = {n: True for n in pipe.stages}
    alphas = {n: 12 for n in pipe.stages}
    scores = {}
    for backend in ("sharded", "torch", "interp"):
        ev = Evaluator(pipe, signed, imgs, ErrorBudget(min_psnr=30.0),
                       params, backend=backend, device="cpu")
        p = ev.evaluate(alphas, {n: 4 for n in pipe.stages})
        scores[backend] = (p.psnr, p.max_abs_err)
    assert scores["sharded"] == scores["torch"] == scores["interp"]
