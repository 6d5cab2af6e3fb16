"""The band kernel's plain version against the TPU kernel's band geometry.

`fused_pipeline_reference` walks the encoded tables the CUDA kernel
walks; here it must equal the reference's `eval_band` + `band_output`
(`repro/kernels/stencil/kernel.py`), band by band and image by image,
dtype included, on every rate island of the benchmarks and on a
saturating phase plan.  The reference runs eagerly under a scoped
``jax.enable_x64(True)``.  The column-tiled walk of the plain version
(the kernel's work items) must equal the whole-width walk.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lowering as rl
import repro_torch.lowering as pl_
from repro.core.fixedpoint import FixedPointType as RefType
from repro.dsl.builder import PipelineBuilder as RefBuilder
from repro.dsl.exec import _run_concrete
from repro.kernels.stencil.kernel import band_output, eval_band
from repro.lowering import backends as rb
from repro.lowering.pallas_backend import island_program as ref_program
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.dsl.builder import PipelineBuilder
from repro_torch.kernels.stencil import kernel as K
from repro_torch.lowering import backends as pb
from repro_torch.lowering.cuda_backend import island_program
from repro_torch.pipelines.types import types_from_data
from test_torch_types import (BENCHES, bench_frames, frames, phase_plan,
                              plan_design, ref_types, to_data)
from _torch_threads import one_torch_thread  # noqa: F401

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "stencil" / "csrc" / "fused_band.cu"


def _images(plp, image):
    """Input stage -> its (B, H, W) frames: one array feeds the sole
    input, a tuple the inputs in order."""
    imgs = image if isinstance(image, tuple) else (image,)
    return dict(zip(plp.pipeline.input_stages(), imgs))


def _bands_equal(rlp, plp, image):
    """Every island, every band, every image: plain version == eval_band.
    Island inputs are the port's buffers (pipeline inputs ingested by
    both sides and compared first)."""
    img_of = _images(plp, image)
    first = next(iter(img_of.values()))
    shape = first.shape[-2:]
    rplan = rl.partition_islands(rlp, shape)
    pplan = pl_.partition_islands(plp, shape)
    nb = first.shape[0]
    buffers = {}
    for n in pplan.inputs:
        buffers[n] = pb.ingest_input(torch.from_numpy(img_of[n]),
                                     plp.stages[n])
        want = np.asarray(rb.ingest_input(jnp.asarray(img_of[n]),
                                          rlp.stages[n], jnp))
        np.testing.assert_array_equal(buffers[n].numpy(), want)
        assert buffers[n].numpy().dtype == want.dtype
    checked = 0
    for risl, pisl in zip(rplan.islands, pplan.islands):
        enc = K.encode_program(island_program(plp, pisl))
        program = ref_program(rlp, risl)
        ins = [buffers[n] for n in pisl.inputs]
        ref_ins = [jnp.asarray(a.numpy()) for a in ins]
        for i in range(pisl.schedule.grid):
            got = K.band_outputs_reference(enc, ins, i)
            for b in range(nb):
                tiles = eval_band(
                    program, i,
                    lambda d, start, b=b: jax.lax.dynamic_slice_in_dim(
                        ref_ins[d["in_slot"]][b], start, d["L"], 0))
                for d in program:
                    if d.get("out_slot") is None:
                        continue
                    want = np.asarray(band_output(d, tiles[d["name"]]))
                    have = got[d["name"]][b].numpy()
                    assert have.dtype == want.dtype, d["name"]
                    np.testing.assert_array_equal(
                        have, want, err_msg=f"island {pisl.idx} band {i} "
                        f"image {b} stage {d['name']}")
                    checked += 1
        outs = K.fused_pipeline_reference(enc, pisl.schedule.grid,
                                          batch=nb)(*ins)
        buffers.update(zip(pisl.outputs, outs))
    assert checked > 0


CASES = [(b, (2, 48, 48)) for b in BENCHES] + \
    [(BENCHES[2], (1, 47, 48)), (BENCHES[3], (1, 47, 48))]


@pytest.mark.parametrize("bench,shape", CASES,
                         ids=[f"{b[0]}-{'x'.join(map(str, s))}"
                              for b, s in CASES])
def test_plain_version_equals_eval_band(bench, shape):
    name, ref_build, port_build, params = bench
    rpipe = ref_build()
    types = ref_types(rpipe)
    with jax.enable_x64(True):
        rlp = rl.lower(rpipe, types, params=params)
        plp = pl_.lower(port_build(), types_from_data(to_data(types)),
                        params=params)
        _bands_equal(rlp, plp, bench_frames(name, shape, 21))


@pytest.mark.parametrize("bench", BENCHES, ids=[b[0] for b in BENCHES])
def test_plain_version_equals_eval_band_narrow(bench):
    """``datapath="narrow"``: int32 and int32-pair carriers and f32
    expression stages, the reference's Pallas band geometry with its
    `dequant_f32` path."""
    name, ref_build, port_build, params = bench
    rpipe = ref_build()
    types = ref_types(rpipe)
    with jax.enable_x64(True):
        rlp = rl.lower(rpipe, types, params=params, datapath="narrow")
        plp = pl_.lower(port_build(), types_from_data(to_data(types)),
                        params=params, datapath="narrow")
        _bands_equal(rlp, plp, bench_frames(name, (2, 40, 40), 23))


def test_plain_version_equals_eval_band_on_a_saturating_phase_plan():
    name, ref_build, port_build, params = BENCHES[3]
    plan = phase_plan(ref_build())
    with jax.enable_x64(True):
        rlp = rl.lower(ref_build(), plan)
        plp = pl_.lower(port_build(), plan_design(plan))
        assert plp.stages["resS"].phase is not None
        _bands_equal(rlp, plp, frames((2, 48, 48), 3))


def test_tables_and_codes_match_the_cuda_source():
    src = CU.read_text()
    for begin, prefix, names in (("FIELDS", "F", K.FIELDS),
                                 ("LAYOUT", "L", K.LAYOUT)):
        block = src[src.index(f"// {begin}-BEGIN"):
                    src.index(f"// {begin}-END")]
        found = re.findall(r"\b%s_([A-Z0-9_]+)" % prefix, block)
        assert [n.lower() for n in found] == [f.lower() for f in names]

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return re.findall(r"\b([A-Z][A-Z_]+)\b", body)

    def py(prefix, module=K):
        return [k for _, k in sorted((v, k) for k, v in vars(module).items()
                                     if k.startswith(prefix))]

    assert enum("Op") == py("OP_")
    assert enum("FConst") == py("FC_")
    assert enum("Snap") == py("SNAP_", pb)
    assert enum("Kind") == py("KIND_")
    assert enum("Place") == py("PLACE_")
    assert re.search(r"TAPW = (\d+);", src).group(1) == str(K.TAPW)
    assert re.search(r"THREADS = (\d+);", src).group(1) == str(K.THREADS)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    name, ref_build, port_build, params = BENCHES[0]
    lp = pl_.lower(port_build(), types_from_data(to_data(
        ref_types(ref_build()))), params=params)
    isl = pl_.partition_islands(lp, (48, 48)).islands[0]
    enc = K.encode_program(island_program(lp, isl))
    x = pb.ingest_input(torch.from_numpy(frames((3, 48, 48), 2)),
                        lp.stages["img"])
    before = dict(K.LAUNCHES)
    got = K.fused_pipeline(enc, isl.schedule.grid, batch=3)(x)
    want = K.fused_pipeline_reference(enc, isl.schedule.grid, batch=3)(x)
    assert K.LAUNCHES == before            # the CPU path launches nothing
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    one = K.fused_pipeline(enc, isl.schedule.grid)(x[1])
    assert torch.equal(one[0], want[0][1])


def test_rhe_shift_equals_the_reference():
    rng = np.random.default_rng(0)
    p = rng.integers(-(1 << 40), 1 << 40, 4096)
    p[:8] = [-6, -5, -3, -2, 2, 3, 5, 6]      # exact ties
    for t in range(-3, 9):
        got = pb.rhe_shift(torch.from_numpy(p), t).numpy()
        with jax.enable_x64(True):
            want = np.asarray(rb.rhe_shift(jnp.asarray(p), t))
        np.testing.assert_array_equal(got, want, err_msg=f"t={t}")


def test_encoder_rejects_what_the_kernel_does_not_run():
    p = PipelineBuilder("cube")
    a = p.image("a", 0, 15)
    p.define("c", a ** 3)
    pipe = p.build()
    types = {"a": FixedPointType(4, 0, False),
             "c": FixedPointType(12, 0, False)}
    lp = pl_.lower(pipe, types)
    isl = pl_.partition_islands(lp, (8, 8)).islands[0]
    with pytest.raises(pl_.LoweringError, match=r"x \*\* 3"):
        K.encode_program(island_program(lp, isl))
    # a narrow-mode f32 expression stage is encoded, flagged, and its
    # plain version equals the reference's oracle
    p = PipelineBuilder("sq")
    a = p.image("a", 0, 15)
    p.define("s", a * a + a)
    pipe = p.build()
    types = {"a": FixedPointType(4, 0, False),
             "s": FixedPointType(8, 0, False)}
    lp = pl_.lower(pipe, types, datapath="narrow")
    assert lp.stages["s"].expr_dtype == "f32"
    isl = pl_.partition_islands(lp, (8, 8)).islands[0]
    enc = K.encode_program(island_program(lp, isl))
    assert [d["f32"] for d in enc.rows()] == [0, 1]
    img = np.random.default_rng(4).integers(0, 16, (8, 8)).astype(np.float64)
    x = pb.ingest_input(torch.from_numpy(img), lp.stages["a"])
    got, = K.fused_pipeline_reference(enc, isl.schedule.grid)(x)
    rpipe = RefBuilder("sq")         # the same pipeline, the reference's
    ra = rpipe.image("a", 0, 15)
    rpipe.define("s", ra * ra + ra)
    want = _run_concrete(rpipe.build(), img, {}, {
        "a": RefType(4, 0, False), "s": RefType(8, 0, False)}, xp=np)["s"]
    np.testing.assert_array_equal(got.numpy(), want)
    # every coordinate is int32 in the kernel: a 40000 x 40000 uint16
    # image (3.2 GB of byte offsets) is refused
    name, ref_build, port_build, params = BENCHES[0]
    lp = pl_.lower(port_build(), types_from_data(to_data(
        ref_types(ref_build()))), params=params)
    isl = pl_.partition_islands(lp, (40000, 40000)).islands[0]
    with pytest.raises(pl_.LoweringError, match="int32"):
        K.encode_program(island_program(lp, isl))
    # a column tile off the island's column lattice (dus_ext: 2)
    name, ref_build, port_build, params = BENCHES[3]
    lp = pl_.lower(port_build(), types_from_data(to_data(
        ref_types(ref_build()))), params=params)
    isl = pl_.partition_islands(lp, (48, 48)).islands[0]
    with pytest.raises(pl_.LoweringError, match="lattice"):
        K.encode_program(island_program(lp, isl), col_tile=7)


# ---------------------------------------------------------------------------
# the column-tiled walk: the kernel's work items
# ---------------------------------------------------------------------------

def _port_lowered(bench, plan=None):
    name, ref_build, port_build, params = bench
    if plan is not None:
        return pl_.lower(port_build(), plan_design(plan))
    return pl_.lower(port_build(), types_from_data(to_data(
        ref_types(ref_build()))), params=params)


def _tiled_equals_whole(plp, image, col_tiles):
    """Island by island: the column-tiled plain walk at every width in
    `col_tiles` == the whole-width walk, dtype included.  Returns the
    column-tile counts seen."""
    img_of = _images(plp, image)
    first = next(iter(img_of.values()))
    plan = pl_.partition_islands(plp, first.shape[-2:])
    buffers = {n: pb.ingest_input(torch.from_numpy(img_of[n]),
                                  plp.stages[n]) for n in plan.inputs}
    nb, seen = first.shape[0], set()
    for isl in plan.islands:
        program = island_program(plp, isl)
        ins = [buffers[n] for n in isl.inputs]
        want = K.fused_pipeline_reference(
            K.encode_program(program), isl.schedule.grid, batch=nb)(*ins)
        for tw in col_tiles:
            enc = K.encode_program(program, col_tile=tw)
            seen.add(enc.ntiles)
            got = K.fused_pipeline_reference(enc, isl.schedule.grid,
                                             batch=nb, col_tiles=True)(*ins)
            for n, g, w in zip(isl.outputs, got, want):
                assert g.dtype == w.dtype, n
                assert torch.equal(g, w), (f"island {isl.idx} stage {n} "
                                           f"col_tile {tw}")
        buffers.update(zip(isl.outputs, want))
    return seen


TILED = [(b, (2, 48, 48), (8, 16, 32, 64)) for b in BENCHES] + \
    [(BENCHES[2], (1, 47, 48), (8, 16, 64)),
     (BENCHES[3], (1, 47, 48), (8, 16, 64)),
     (BENCHES[0], (2, 40, 56), (16, 24, 64)),
     (BENCHES[1], (2, 40, 56), (16, 64))]


@pytest.mark.parametrize("bench,shape,col_tiles", TILED,
                         ids=[f"{b[0]}-{'x'.join(map(str, s))}"
                              for b, s, _ in TILED])
def test_column_tiled_walk_equals_whole_width(bench, shape, col_tiles):
    seen = _tiled_equals_whole(_port_lowered(bench),
                               bench_frames(bench[0], shape, 17), col_tiles)
    assert 1 in seen and max(seen) > 2      # one tile, and several


def test_column_tiled_walk_on_a_saturating_phase_plan():
    bench = BENCHES[3]
    plp = _port_lowered(bench, phase_plan(bench[1]()))
    assert plp.stages["resS"].phase is not None
    _tiled_equals_whole(plp, frames((2, 48, 48), 3), (8, 16, 64))


def test_encoder_places_every_1080p_tile_on_chip():
    """At 1080x1920 every island of usm, hcd, dus_ext, of and of_pyramid
    gets column tiles whose block fits three to an SM with no tile in
    global memory;
    ``smem_limit=0`` moves every tile out (compute tiles to per-block
    global slots, inputs to reads in place); outputs nothing reads take
    no tile."""
    for bench in (BENCHES[0], BENCHES[1], BENCHES[3], BENCHES[4],
                  BENCHES[5]):
        plp = _port_lowered(bench)
        for isl in pl_.partition_islands(plp, (1080, 1920)).islands:
            program = island_program(plp, isl)
            enc = K.encode_program(program)
            rows = enc.rows()
            assert enc.col_tile > 0 and enc.ntiles > 1
            assert enc.ws_per_block == 0
            assert enc.smem_bytes <= K.SMEM_LIMIT
            read = {t[0] for t in enc.taps.tolist()} | {
                c[1] for c in enc.prog.tolist() if c[0] == K.OP_REF}
            for s, d in enumerate(rows):
                assert d["place"] == (K.PLACE_SHARED if s in read
                                      or d["kind"] == K.KIND_INPUT
                                      else K.PLACE_NONE), enc.names[s]
            out = K.encode_program(program, smem_limit=0)
            assert out.ws_per_block > 0
            assert all(d["place"] != K.PLACE_SHARED for d in out.rows())
