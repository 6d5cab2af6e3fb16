"""Optical flow (`of`, `of_pyramid`) on the port, against the JAX package.

Bit for bit, on the CPU: the port's copies of the two pipelines, their
committed designs, and `run_fixed` under ``"torch"`` (the band kernel's
plain version), ``"lowered"`` and ``"interp"`` against the reference's
numpy oracle, on single, batched and pre-quantized frame pairs, in the
exact and the narrow datapath; the narrow lowering's f32 stages run in
f32; two equal flat frames give zero flow; and the pipeline server takes
frame pairs.
"""
import numpy as np
import pytest
import torch

from repro.dsl.exec import run_fixed as ref_run_fixed
from repro.pipelines import optical_flow as rof
from repro_torch.dsl import exec as E
from repro_torch.kernels.stencil import kernel as K
from repro_torch.lowering import backends as pb
from repro_torch.lowering import lower
from repro_torch.pipelines import optical_flow as pof
from repro_torch.pipelines.types import load_types, types_from_data
from repro_torch.serve import PipelineServer, serve_offline
from test_torch_types import bench_frames, ref_types, to_data
from _torch_threads import one_torch_thread  # noqa: F401

OF = [("of", rof.build, pof.build), ("of_pyramid", rof.build_pyramid,
                                     pof.build_pyramid)]
OF_IDS = [o[0] for o in OF]


def _structure(pipe):
    return (pipe.name, list(pipe.outputs), {
        n: (st.inputs, st.stride, st.upsample, st.is_input,
            repr(st.input_range), repr(st.expr))
        for n, st in pipe.stages.items()})


def test_pipelines_equal_the_reference():
    assert (pof.ALPHA2, pof.HS_AVG, pof.N_ITERS) == \
        (rof.ALPHA2, rof.HS_AVG, rof.N_ITERS)
    for n in (1, 2, 4):
        assert _structure(pof.build(n)) == _structure(rof.build(n))
        assert _structure(pof.build_pyramid(n)) == \
            _structure(rof.build_pyramid(n))
        assert pof.stage_families(n) == rof.stage_families(n)
    assert len(pof.build().stages) == 32        # 30 stages and two inputs


def _prequantized(img, design):
    """Frames already in their input stages' containers (u8.4: uint16)."""
    lp = lower(pof.build(), design)
    dt = pb.store_dtype(lp.stages["img1"])
    assert dt == torch.uint16
    return tuple(torch.from_numpy(np.rint(f * 16.0).astype(np.int64)).to(dt)
                 for f in img)


@pytest.mark.parametrize("backend", ["torch", "lowered", "interp"])
@pytest.mark.parametrize("form", ["single", "batched", "prequantized"])
@pytest.mark.parametrize("name,ref_build,port_build", OF, ids=OF_IDS)
def test_run_fixed_equals_the_oracle(name, ref_build, port_build, form,
                                     backend):
    rpipe = ref_build()
    types = ref_types(rpipe)
    design = types_from_data(to_data(types))
    img = bench_frames(name, (40, 40) if form == "single" else (3, 40, 40),
                       61)
    oracle = ref_run_fixed(rpipe, img, types)
    feed = _prequantized(img, design) if form == "prequantized" else img
    want = sorted(rpipe.outputs if backend == "torch" else rpipe.stages)
    for datapath in ("exact", "narrow"):
        got = E.run_fixed(port_build(), feed, design, backend=backend,
                          datapath=datapath, device="cpu")
        assert sorted(got) == want
        for k in want:
            assert got[k].dtype == torch.float64
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(oracle[k]), err_msg=k)
    # a dict by input stage is the same request
    by_name = dict(zip(rpipe.input_stages(), feed))
    again = E.run_fixed(port_build(), by_name, design, backend=backend,
                        device="cpu")
    for k in want:
        assert torch.equal(again[k], got[k])


def test_committed_designs_are_the_reference_designs():
    for name, ref_build, port_build in OF:
        want = types_from_data(to_data(ref_types(ref_build())))
        assert load_types(name) == want


def test_narrow_f32_stages_evaluate_in_f32(monkeypatch):
    """Under ``datapath="narrow"`` the plain version and the whole-frame
    program snap an f32 stage's raw values in f32, every other
    expression stage's in f64 (the dtype of the intermediate values
    reaching `snap_expr`, recorded per call)."""
    seen = []
    snap = pb.snap_expr

    def recording(raw, *args, **kw):
        seen.append(raw.dtype)
        return snap(raw, *args, **kw)

    monkeypatch.setattr(pb, "snap_expr", recording)
    design = load_types("of")
    lp = lower(pof.build(), design, datapath="narrow")
    f32 = {n for n, ls in lp.stages.items() if ls.expr_dtype == "f32"}
    assert f32 == {"Ixx", "Iyy", "Denom", "Vx0", "Vy0"}
    exprs = [n for n in lp.order if lp.stages[n].kind == "expr"]
    want = [torch.float32 if n in f32 else torch.float64 for n in exprs]
    img = bench_frames("of", (1, 24, 24), 3)
    for backend in ("torch", "lowered"):
        seen.clear()
        E.run_fixed(pof.build(), img, design, backend=backend,
                    datapath="narrow", device="cpu")
        # the plain version snaps once per stage per band, in stage order
        assert len(seen) % len(exprs) == 0 and seen
        for k in range(0, len(seen), len(exprs)):
            assert seen[k:k + len(exprs)] == want, backend
    seen.clear()
    E.run_fixed(pof.build(), img, design, backend="torch", datapath="exact",
                device="cpu")
    assert set(seen) == {torch.float64}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_equal_flat_frames_give_zero_flow(backend):
    flat = np.full((2, 64, 72), 117.0)
    for name, _, port_build in OF:
        before = dict(K.LAUNCHES)
        out = E.run_fixed(port_build(), (flat, flat), load_types(name),
                          backend=backend, device="cpu")
        assert K.LAUNCHES == before            # CPU tensors: plain version
        for v in out.values():
            assert v.shape == (2, 64, 72) and torch.all(v == 0)


def test_server_takes_frame_pairs():
    rpipe = rof.build()
    types = ref_types(rpipe)
    pairs = [bench_frames("of", (32, 40), 300 + 2 * i) for i in range(5)]
    with PipelineServer(pof.build(), types_from_data(to_data(types)),
                        backend="torch", batch_size=4, datapath="narrow",
                        device="cpu") as srv:
        outs = serve_offline(srv, pairs[:3] + [
            dict(zip(rpipe.input_stages(), p)) for p in pairs[3:]])
        with pytest.raises(ValueError, match="takes 2 inputs"):
            srv.submit(pairs[0][0])
    assert srv.stats["frames"] == 5
    for pair, out in zip(pairs, outs):
        want = ref_run_fixed(rpipe, pair, types)
        assert sorted(out) == ["Vx4", "Vy4"]
        for k in out:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(want[k]))
