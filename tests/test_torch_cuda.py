"""The port's kernels on the card against their plain versions, bit for
bit: the band kernel, and the kernel library (stencil, qmatmul, qdq).

Needs a CUDA card: every test here skips without one.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the plain version, which the CPU tests hold equal to the
JAX package, is the reference on the card.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import analysis as A
from repro_torch.core.fixedpoint import FixedPointType, alpha_for_range
from repro_torch.core.profile import profile_pipeline
from repro_torch.dse import ErrorBudget, Evaluator, run_design_search
from repro_torch.dsl.exec import (clear_executor_cache, make_jitted_fixed,
                                  make_profile_runner, run_fixed)
from repro_torch.kernels.qdq import kernel as QD
from repro_torch.kernels.qdq import ops as qdq_ops
from repro_torch.kernels.qmatmul import kernel as QM
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.stencil import kernel as K
from repro_torch.kernels.stencil import ops as st_ops
from repro_torch.lowering import backends as B
from repro_torch.lowering import LoweringError, lower, partition_islands
from repro_torch.lowering.cuda_backend import island_program
from repro_torch.pipelines import ALL, usm
from repro_torch.pipelines.data import image_set
from repro_torch.pipelines.types import (design_from_plan, load_types,
                                         types_from_data)

pytestmark = pytest.mark.cuda

PARAMS = {"usm": dict(usm.DEFAULT_PARAMS)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float64)


def _inputs(name, shape, seed):
    """One frame, or a pair for optical flow (seeds `seed`, `seed + 1`)."""
    if name in ("of", "of_pyramid"):
        return (_frames(shape, seed), _frames(shape, seed + 1))
    return _frames(shape, seed)


def _check(pipe, img, types, params, dev, datapath="exact"):
    before = K.LAUNCHES["fused_band"]
    got = run_fixed(pipe, img, types, params, backend="cuda",
                    datapath=datapath, device=dev)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_band"] > before
    want = run_fixed(pipe, img, types, params, backend="torch",
                     datapath=datapath, device=dev)
    assert sorted(got) == sorted(pipe.outputs)
    for k in got:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


CASES = [("usm", (48, 48)), ("hcd", (48, 48)), ("dus", (47, 48)),
         ("dus_ext", (48, 48)), ("usm", (3, 47, 48)), ("hcd", (2, 40, 56)),
         ("dus_ext", (3, 47, 48)), ("usm", (2, 1080, 1920)),
         # two column tiles, the last one ragged
         ("usm", (2, 64, 200)),
         # tall single-tile islands whose inputs are read in place
         ("dus_ext", (1, 601, 640)),
         # optical flow: two inputs, divisions, 30 and 19 stages in one
         # island; odd shapes (of_pyramid at an odd half-size width; at an
         # odd height or width it raises, see below)
         ("of", (2, 48, 48)), ("of", (1, 47, 53)),
         ("of_pyramid", (2, 48, 48)), ("of_pyramid", (1, 46, 62))]


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s in CASES])
def test_kernel_equals_plain_version(cuda, name, shape):
    _check(ALL[name](), _inputs(name, shape, 5), load_types(name),
           PARAMS.get(name, {}), cuda)


@pytest.mark.parametrize("shape", [(47, 48), (1, 46, 61)],
                         ids=["47x48", "1x46x61"])
def test_of_pyramid_at_an_odd_size_raises_on_the_card(cuda, shape):
    """Where the reference's oracle fails on a broadcast, the kernel's
    executor raises before it launches anything."""
    before = K.LAUNCHES["fused_band"]
    for backend in ("cuda", "torch"):
        with pytest.raises(LoweringError, match="inputs do not meet"):
            run_fixed(ALL["of_pyramid"](), _inputs("of_pyramid", shape, 5),
                      load_types("of_pyramid"), backend=backend,
                      device=cuda)
    assert K.LAUNCHES["fused_band"] == before


def _to(img, dev):
    if isinstance(img, tuple):
        return tuple(torch.from_numpy(a).to(dev) for a in img)
    return torch.from_numpy(img).to(dev)


@pytest.mark.parametrize("name", ["usm", "of"])
def test_profile_pass_on_the_card_equals_the_cpu(cuda, name):
    """`ProfilePass` reduces each stage on the card; its plan column,
    and every statistic of `profile_pipeline`, equal the same pass on
    CPU tensors."""
    pipe, params = ALL[name](), PARAMS.get(name, {})
    imgs = [_inputs(name, (120, 176), 40 + 2 * i) for i in range(3)]
    passes = {dev.type: A.ProfilePass([_to(im, dev) for im in imgs],
                                      params=params, device=dev)
              for dev in (cuda, torch.device("cpu"))}
    # the device is not part of the pass's key: clear the memo between
    plans = {}
    for dev, prof in passes.items():
        A.clear_memo()
        plans[dev] = A.run_plan(pipe, ["interval", prof,
                                       A.refine("interval", prof)])
    A.clear_memo()
    assert plans["cuda"].to_json() == plans["cpu"].to_json()
    plans["cuda"].check_nesting(["profile", "interval"])
    got, want = (profile_pipeline(pipe, passes[d].images,
                                  make_profile_runner(pipe, device=dev),
                                  params)
                 for d, dev in (("cuda", cuda), ("cpu", "cpu")))
    assert got.alpha_max == want.alpha_max
    assert got.alpha_avg == want.alpha_avg
    for n in want.cdf:
        assert np.array_equal(got.cdf[n][1], want.cdf[n][1]), n


@pytest.mark.parametrize("name", ["usm", "of"])
def test_profile_design_kernel_equals_plain_version(cuda, name):
    """The profile column's design, the narrowest, saturates on frames
    outside the profiled ones; the kernel equals its plain version."""
    pipe, params = ALL[name](), PARAMS.get(name, {})
    imgs = [_to(_inputs(name, (64, 96), 60 + 2 * i), cuda)
            for i in range(2)]
    plan = A.run_plan(pipe, [A.ProfilePass(imgs, params=params,
                                           device=cuda)],
                      betas={n: 4 for n in pipe.stages})
    design = design_from_plan(plan, "profile")
    _check(pipe, _inputs(name, (2, 200, 264), 70), design, params, cuda)


@pytest.mark.parametrize("name", list(ALL))
def test_narrow_lowering_kernel_equals_plain_version(cuda, name):
    """``datapath="narrow"``: f32 expression stages (hcd, of,
    of_pyramid), int32 and int32-pair carriers, two column tiles."""
    lp = lower(ALL[name](), load_types(name), params=PARAMS.get(name, {}),
               datapath="narrow")
    assert (name in ("hcd", "of", "of_pyramid")) == any(
        ls.expr_dtype == "f32" for ls in lp.stages.values())
    _check(ALL[name](), _inputs(name, (2, 64, 200), 9), load_types(name),
           PARAMS.get(name, {}), cuda, datapath="narrow")


def test_make_jitted_fixed_outputs_on_the_card(cuda):
    """Intermediate stages as island outputs, on the kernel: equal to
    the per-stage walk on the card."""
    img = _inputs("of", (2, 56, 72), 11)
    outs = ["Denom", "Common2", "Vy1", "Vx4"]
    run = make_jitted_fixed(ALL["of"](), load_types("of"), {},
                            outputs=outs, device=cuda)
    before = K.LAUNCHES["fused_band"]
    got = run(img)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_band"] > before
    want = run_fixed(ALL["of"](), img, load_types("of"), backend="interp",
                     device=cuda)
    assert sorted(got) == sorted(outs)
    for k in outs:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


def test_saturating_phase_plan(cuda):
    """Residue bounds tighter than the true ranges, so per-residue
    saturation engages on random frames."""
    data = load_types("dus_ext").to_data()
    ranges = {"resS": ((2, 1), {"0,0": (-50, 50)}),
              "UyS": ((2, 1), {"0,0": (0, 150), "1,0": (0, 250)}),
              "band": ((2, 2), {"0,0": (-30, 30)})}
    data["phases"] = {
        s: {"lattice": list(lat),
            "ranges": {k: {"alpha": alpha_for_range(lo, hi),
                           "signed": lo < 0} for k, (lo, hi) in r.items()}}
        for s, (lat, r) in ranges.items()}
    _check(ALL["dus_ext"](), _frames((2, 96, 96), 3), types_from_data(data),
           {}, cuda)


# (name, shape, encoder options): several and ragged column tiles at a
# forced width, and every tile in global memory
ENCODED = [("usm", (2, 64, 200), {"col_tile": 32}),
           ("hcd", (2, 40, 56), {"col_tile": 16}),
           ("dus_ext", (2, 96, 96), {"col_tile": 32}),
           ("hcd", (2, 64, 200), {"smem_limit": 0}),
           ("dus_ext", (1, 97, 130), {"smem_limit": 0})]


@pytest.mark.parametrize("name,shape,opts", ENCODED,
                         ids=[f"{n}-{'x'.join(map(str, s))}-"
                              f"{'-'.join(f'{k}{v}' for k, v in o.items())}"
                              for n, s, o in ENCODED])
def test_kernel_equals_plain_version_at_encoder_options(cuda, name, shape,
                                                        opts):
    lp = lower(ALL[name](), load_types(name), params=PARAMS.get(name, {}))
    plan = partition_islands(lp, shape[-2:])
    x = torch.from_numpy(_frames(shape, 7)).to(cuda)
    buffers = {n: B.ingest_input(x, lp.stages[n]) for n in plan.inputs}
    for isl in plan.islands:
        enc = K.encode_program(island_program(lp, isl), **opts)
        if "smem_limit" in opts:
            assert all(d["place"] != K.PLACE_SHARED for d in enc.rows())
        ins = [buffers[n] for n in isl.inputs]
        got = _launched(K.LAUNCHES, "fused_band", lambda: K.fused_pipeline(
            enc, isl.schedule.grid, shape[0])(*ins))
        want = K.fused_pipeline_reference(enc, isl.schedule.grid,
                                          shape[0])(*ins)
        for g, w in zip(got, want):
            _same(g, w)
        buffers.update(zip(isl.outputs, got))


# ---------------------------------------------------------------------------
# the kernel library: stencil.cu, qmatmul.cu, qdq.cu
# ---------------------------------------------------------------------------

SOBEL = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]


def _same(got, want):
    """Equal values, dtype and shape; NaN where the other has NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        assert torch.equal(got.isnan(), want.isnan())
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    assert torch.equal(got, want)


def _launched(counters, name, fn):
    before = counters[name]
    out = fn()
    torch.cuda.synchronize()
    assert counters[name] == before + 1, name
    return out


# (name, H, W, hy, hx, shift, taps): taps "random" (9 random taps in
# the halo), "dense" (every position, so a template's whole weight
# grid), "separable" (an outer product of integer vectors, with a zero
# row, which the host factors), "many" (128 taps), "wrap" and
# "separable_wrap" (sums that overflow int32), "swap" (qmin > qmax).
# Halos (1, 1), (2, 2), (0, 1), (0, 2), (0, 3), (1, 0), (2, 0), (3, 0)
# take the templates, every other halo the generic loop.
STENCILS = [("sobel", 37, 70, 1, 1, 3, "random"),
            ("blur5x5", 48, 129, 2, 2, 8, "random"),
            ("ties", 20, 64, 0, 1, 2, "random"),
            ("shift0", 17, 17, 1, 1, 0, "random"),
            ("wide_halo", 40, 90, 40, 40, 5, "random"),
            # W % 4 != 0 and an odd padded width: rows 4 bytes apart mod 16
            ("odd_pitch", 45, 101, 1, 1, 4, "dense"),
            ("odd_pitch_generic", 45, 97, 3, 3, 4, "random"),
            # smaller than one step or one strip, 1 row, 1 column
            ("tiny", 5, 7, 1, 1, 2, "dense"),
            ("one_row", 1, 300, 2, 2, 6, "dense"),
            ("one_column", 300, 1, 1, 1, 3, "dense"),
            ("one_pixel", 1, 1, 2, 2, 1, "random"),
            # every template footprint, dense
            ("t1x3", 33, 200, 0, 1, 2, "dense"),
            ("t1x5", 33, 200, 0, 2, 2, "dense"),
            ("t1x7", 70, 257, 0, 3, 3, "dense"),
            ("t3x1", 70, 257, 1, 0, 2, "dense"),
            ("t5x1", 70, 257, 2, 0, 2, "dense"),
            ("t7x1", 70, 257, 3, 0, 3, "dense"),
            ("t3x3", 70, 257, 1, 1, 3, "dense"),
            ("t5x5", 70, 257, 2, 2, 6, "dense"),
            # the generic loop: a 7x7 footprint with 9 taps, 128 taps,
            # horizontal-only and vertical-only footprints
            ("g7x7", 130, 300, 3, 3, 5, "random"),
            ("g128", 64, 131, 5, 5, 9, "many"),
            ("g1x11", 50, 150, 0, 5, 4, "random"),
            ("g9x1", 50, 150, 4, 0, 4, "random"),
            ("s3x3", 70, 257, 1, 1, 3, "separable"),
            ("s5x5", 70, 257, 2, 2, 6, "separable"),
            ("s1x7", 70, 257, 0, 3, 3, "separable"),
            ("s7x1", 70, 257, 3, 0, 3, "separable"),
            ("s5x5_wrap", 40, 96, 2, 2, 0, "separable_wrap"),
            ("wrap", 40, 96, 2, 2, 0, "wrap"),
            ("wrap_generic", 40, 96, 3, 2, 0, "wrap"),
            ("swap", 30, 64, 1, 1, 2, "swap"),
            ("shift31", 30, 64, 1, 1, 31, "wrap"),
            # 1080p: each block walks several steps and runs into the
            # next strip, carrying its row ring from step to step
            ("frame_sobel", 1080, 1920, 1, 1, 3, "dense"),
            ("frame_blur", 1080, 1920, 2, 2, 8, "separable"),
            ("frame_generic", 1080, 1920, 3, 3, 5, "random")]


def _stencil_operands(dev, H, W, hy, hx, kind, seed, offset=0):
    """(xq, taps, qmin, qmax); with `offset`, xq is a contiguous view that
    many int32 into a larger buffer (its rows then start elsewhere mod
    16 bytes)."""
    g = np.random.default_rng(seed)
    cells = [(dy, dx) for dy in range(-hy, hy + 1)
             for dx in range(-hx, hx + 1)]
    if kind == "dense":
        taps = [(dy, dx, int(g.integers(-64, 65)) or 1) for dy, dx in cells]
    elif kind.startswith("separable"):
        big = 2 ** 10 if kind.endswith("wrap") else 9
        a = g.integers(-big, big + 1, 2 * hy + 1)
        b = g.integers(-big, big + 1, 2 * hx + 1)
        a[0], b[0] = a[0] or 5, b[0] or 3
        if hy:
            a[-1] = 0
        taps = [(dy, dx, int(a[dy + hy] * b[dx + hx])) for dy, dx in cells
                if a[dy + hy] * b[dx + hx]]
    elif kind == "many":
        taps = [cells[int(i)] + (int(g.integers(-64, 65)),)
                for i in g.integers(0, len(cells), 128)]
    else:
        n = 9 if kind != "wrap" else 2 * len(cells)
        taps = [cells[int(i)] + (int(g.integers(-64, 65)),)
                for i in g.integers(0, len(cells), n)]
    lo, hi = -300, 300
    if kind == "wrap":
        taps = [(dy, dx, int(g.integers(-(2 ** 20), 2 ** 20)))
                for dy, dx, _ in taps]
    if kind.endswith("wrap"):
        lo, hi = -(2 ** 20), 2 ** 20
    shape = (H + 2 * hy, W + 2 * hx)
    x = g.integers(lo, hi, (offset + shape[0] * shape[1],)).astype(np.int32)
    xq = torch.from_numpy(x).to(dev)[offset:].view(shape)
    qmin, qmax = -(2 ** 11), 2 ** 11 - 1
    if kind.endswith("wrap"):
        qmin, qmax = -(2 ** 31), 2 ** 31 - 1
    if kind == "swap":
        qmin, qmax = 100, -100
    return xq, taps, qmin, qmax


@pytest.mark.parametrize("name,H,W,hy,hx,shift,kind", STENCILS,
                         ids=[c[0] for c in STENCILS])
def test_stencil_kernel_equals_plain_version(cuda, name, H, W, hy, hx, shift,
                                             kind):
    xq, taps, qmin, qmax = _stencil_operands(cuda, H, W, hy, hx, kind, H * W)
    args = (taps, (hy, hx), shift, qmin, qmax)
    got = _launched(K.LAUNCHES, "stencil",
                    lambda: K.fixedpoint_stencil(xq, *args))
    want = K.fixedpoint_stencil_reference(xq, *args)
    _same(got, want)
    if kind.endswith("wrap"):   # the int32 sums did wrap
        acc = sum(w * xq[hy + dy:hy + dy + H, hx + dx:hx + dx + W].double()
                  for dy, dx, w in taps)
        assert bool((acc.abs() >= 2 ** 31).any())
    if kind == "swap":
        assert bool((got == qmax).all())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_stencil_kernel_on_an_input_off_16_bytes(cuda, offset):
    """xq 4, 8 or 12 bytes into its buffer: every row's offset in its
    ring slot moves, on the template and the generic path."""
    for hy, hx, kind in ((1, 1, "dense"), (3, 3, "random")):
        xq, taps, qmin, qmax = _stencil_operands(cuda, 50, 131, hy, hx, kind,
                                                 offset, offset=offset)
        assert xq.data_ptr() % 16 and xq.is_contiguous()
        args = (taps, (hy, hx), 3, qmin, qmax)
        _same(_launched(K.LAUNCHES, "stencil",
                        lambda: K.fixedpoint_stencil(xq, *args)),
              K.fixedpoint_stencil_reference(xq, *args))


# the largest halos one block's shared memory takes, each with the next
# halo up, which it does not: the wrapper's `_stencil_smem_bytes` and the
# launcher's `smem_bytes` in `stencil.cu` must draw the same line
HALO_LIMITS = [((62, 62), (63, 63)), ((161, 1), (162, 1)),
               ((0, 232), (0, 233))]


@pytest.mark.parametrize("fits,too_big", HALO_LIMITS,
                         ids=[f"{a}x{b}" for (a, b), _ in HALO_LIMITS])
def test_stencil_halo_limit_is_the_launchers(cuda, fits, too_big):
    from repro_torch.kernels import _build
    hy, hx = fits
    xq, _, qmin, qmax = _stencil_operands(cuda, 3, 5, hy, hx, "random", hy)
    taps = [(hy, -hx, 3), (-hy, hx, -2), (0, 0, 7)]
    args = (taps, fits, 2, qmin, qmax)
    _same(_launched(K.LAUNCHES, "stencil",
                    lambda: K.fixedpoint_stencil(xq, *args)),
          K.fixedpoint_stencil_reference(xq, *args))
    hy, hx = too_big
    xq, _, qmin, qmax = _stencil_operands(cuda, 3, 5, hy, hx, "random", hy)
    with pytest.raises(ValueError, match="too large"):
        K.fixedpoint_stencil(xq, [(hy, hx, 1)], too_big, 2, qmin, qmax)
    out = torch.empty((3, 5), dtype=torch.int32, device=cuda)
    table = (ctypes.c_int32 * 3)(hy, hx, 1)
    rc = _build.load("stencil").stencil_launch(
        xq.data_ptr(), out.data_ptr(), 3, 5, table, 1, hy, hx, 2, qmin, qmax,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0, "the launcher took a halo the wrapper refuses"


# (M, K, N): ragged M, N and K across several 128 x 256 tiles; a K that
# crosses the 128-byte swizzle atom and turns the 4-stage ring over;
# K % 16 != 0 (a copied to a padded scratch) at a size that runs the
# GEMM; K = 0 (the epilogue over zero accumulators); small cases; and
# more tiles than the card has SMs (153 on 132), ragged on every axis,
# with 9 tile rows (a partial group of 8), so that blocks carry the
# ring's phase, the column scales and the staging buffers from tile to
# tile.  N % 4 != 0 (53, 1, 4098) stores the output straight from the
# registers; the others store it with TMA.
QMM = [(256, 512, 384), (37, 70, 53), (64, 40, 64), (1, 1, 1), (130, 48, 20),
       (300, 1000, 520), (257, 4160, 264), (200, 70, 300), (4, 0, 5),
       (1100, 520, 4098), (1100, 300, 4100)]


def _qmm_operands(dev, M, K, N, seed, offset=0):
    """Random int8 a (M, K), b (K, N) and f32 scales; with `offset`, a
    and b are contiguous views that many bytes into larger buffers."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a, b = (torch.randint(-128, 128, (offset + r * c,), dtype=torch.int8,
                          device=dev, generator=g)[offset:].view(r, c)
            for r, c in ((M, K), (K, N)))
    sa = torch.rand((M, 1), device=dev, generator=g)
    sb = torch.rand((1, N), device=dev, generator=g)
    return a, b, sa, sb


def _qmm_check(a, b, sa, sb):
    _same(_launched(QM.LAUNCHES, "qmatmul_i32",
                    lambda: QM.qmatmul_i32(a, b)),
          QM.qmatmul_i32_reference(a, b))
    _same(_launched(QM.LAUNCHES, "qmatmul_dequant",
                    lambda: QM.qmatmul_dequant(a, b, sa, sb)),
          QM.qmatmul_dequant_reference(a, b, sa, sb))


@pytest.mark.parametrize("M,K,N", QMM, ids=["x".join(map(str, s))
                                             for s in QMM])
def test_qmatmul_kernels_equal_plain_versions(cuda, M, K, N):
    _qmm_check(*_qmm_operands(cuda, M, K, N, M + K + N))


def test_qmatmul_kernels_on_operands_at_a_1_byte_offset(cuda):
    """a and b 1 byte into their buffers: TMA cannot read a in place, so
    the pre-pass copies it, and b packs byte by byte."""
    a, b, sa, sb = _qmm_operands(cuda, 200, 320, 130, 3, offset=1)
    assert a.data_ptr() % 16 and a.is_contiguous() and b.is_contiguous()
    _qmm_check(a, b, sa, sb)


def test_qmatmul_kernels_at_the_largest_accumulators(cuda):
    """Every operand -128 at K = 8192: acc = 2^27 everywhere, exact in
    int32 and in f32."""
    M, K, N = 130, 8192, 260
    a = torch.full((M, K), -128, dtype=torch.int8, device=cuda)
    b = torch.full((K, N), -128, dtype=torch.int8, device=cuda)
    acc = _launched(QM.LAUNCHES, "qmatmul_i32", lambda: QM.qmatmul_i32(a, b))
    assert bool((acc == 2 ** 27).all())
    _qmm_check(a, b, torch.ones((M, 1), device=cuda),
               torch.full((1, N), 0.5, device=cuda))


# (K, N): byte-wise loads (N % 16 != 0) and 16-byte loads, K % 16 != 0,
# several pack tiles each way
PACKS = [(53, 70), (520, 1000), (264, 4160), (300, 64), (1, 1)]


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (300, 1000, 520),
                                   (1100, 520, 4098)])
def test_qmatmul_dequant_flushes_subnormal_products(cuda, M, K, N):
    """The epilogue where (f32(acc) * sa) * sb is subnormal: sa = 1e-20
    and sb = 1e-19 (products below FLT_MIN for small |acc|), subnormal
    row and column scales of both signs (read as 0) and a row whose
    first product is below FLT_MIN; both epilogues (TMA and direct
    stores, N % 4 != 0)."""
    a, b, _, _ = _qmm_operands(cuda, M, K, N, M + N)
    sa = torch.full((M, 1), 1e-20, device=cuda)
    sb = torch.full((1, N), 1e-19, device=cuda)
    sa[1], sa[2], sb[0, 3], sb[0, 4] = 1e-39, -2e-39, 5e-40, -1e-38
    sa[5] = 1e-37
    sb[0, 6] = 1e30
    got = _launched(QM.LAUNCHES, "qmatmul_dequant",
                    lambda: QM.qmatmul_dequant(a, b, sa, sb))
    want = QM.qmatmul_dequant_reference(a, b, sa, sb)
    _same(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    tiny = torch.finfo(torch.float32).tiny
    assert not ((got.abs() < tiny) & (got != 0)).any()


@pytest.mark.parametrize("K,N", PACKS, ids=[f"{k}x{n}" for k, n in PACKS])
def test_pack_pre_pass_alone(cuda, K, N):
    """bT == b.t() zero-padded to K16: tells a wrong transpose from a
    wrong wgmma descriptor."""
    b = _qmm_operands(cuda, 1, K, N, K + N, offset=int(N % 16 != 0))[1]
    bt = QM.pack_b(b)
    torch.cuda.synchronize()
    assert bt.shape == (N, -(-K // 16) * 16)
    assert torch.equal(bt[:, :K], b.t()) and not bt[:, K:].any()
    _same(bt, QM.pack_b_reference(b))


# (NB, BS, offset): the register path (chunks of 8 elements, at most 32
# bytes a lane where the row is longer) at 256 (f32: 32 lanes a row;
# bf16 and f16: 16 lanes of 2 chunks, 2 rows a warp), 64 (8 or 4 lanes,
# 4 or 8 rows a warp), 40 (5 chunks on 8 lanes, or on 4 lanes of 1 or 2
# chunks), 8 (1 lane, 32 rows a warp), 520 (3 chunks a lane on 32 lanes)
# and 1024 (4 chunks a lane); the loop path at 8192 and 4104 (an odd
# number of chunks); the general path at BS % 8 != 0 (33, 1, 6) and with
# x 1, 3 or 7 elements into a larger buffer (2, 6, 14 bytes off 16 in
# bf16 and f16; 4, 12, 28 in f32)
BLOCKS = [(1000, 256, 0), (37, 33, 0), (5, 1, 0), (40, 6, 0), (300, 64, 0),
          (33, 40, 0), (70, 8, 0), (20, 520, 0), (50, 1024, 0),
          (9, 8192, 0), (12, 4104, 0), (100, 256, 1), (100, 256, 3),
          (30, 64, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("NB,BS,offset", BLOCKS)
def test_block_kernels_equal_plain_versions(cuda, NB, BS, offset, dtype):
    """Each instantiation and path of block_quantize, on rows holding
    NaN or inf and, from NB = 9 up, rows of subnormals and of tiny
    normals (the flush rules)."""
    g = torch.Generator(device=cuda).manual_seed(NB)
    x = (torch.randn((offset + NB * BS,), device=cuda, generator=g)
         * 100).to(dtype)[offset:].view(NB, BS)
    x.mul_(torch.rand((NB, 1), device=cuda, generator=g).to(dtype))
    x[0] = 0.0
    x[1, 0], x[2, -1] = float("nan"), float("inf")
    if NB >= 9:
        tiny = torch.finfo(torch.float32).tiny
        for r, k in ((3, 1e-37), (4, 1e-38), (5, 1e-39)):
            x[r] = (torch.randn(BS, device=cuda, generator=g) * k).to(dtype)
        x[6] = torch.tensor([152.0, 0.9, -0.9, 0.5] * BS, device=cuda
                            )[:BS].mul(tiny).to(dtype)
        x[7, ::2] = 0.7 * tiny
        x[8] = x[8].float().mul(1e-5).to(dtype)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
    q, s = _launched(QD.LAUNCHES, "block_quantize",
                     lambda: QD.block_quantize(x))
    wq, ws = QD.block_quantize_reference(x)
    _same(q, wq)
    _same(s, ws)
    _same(_launched(QD.LAUNCHES, "block_dequantize",
                    lambda: QD.block_dequantize(q, s)),
          QD.block_dequantize_reference(q, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_block_quantize_fast_quotient_is_exact(cuda, dtype):
    """The codes that bf16 and f16 rows compute from the scale's
    reciprocal equal the exact path's on every (scale, element) pair
    such a row can hold."""
    assert QD.quotient_mismatches(dtype, cuda) == 0


def test_front_ends_on_the_card_equal_the_cpu(cuda):
    """The card's front ends against the same front ends on the CPU,
    which the CPU tests hold equal to the JAX package."""
    g = np.random.default_rng(2)
    img = g.integers(0, 256, (72, 130)).astype(np.float32)
    tin, tout = FixedPointType(8, 0, False), FixedPointType(9, 4, True)
    _same(st_ops.stencil_fixed(img, SOBEL, 1 / 12, tin, tout).cpu(),
          st_ops.stencil_fixed(img, SOBEL, 1 / 12, tin, tout, device="cpu"))
    a = g.normal(size=(100, 300)).astype(np.float32)
    b = g.normal(size=(300, 70)).astype(np.float32)
    _same(qmm_ops.matmul_quantized(a, b).cpu(),
          qmm_ops.matmul_quantized(a, b, device="cpu"))
    x = g.normal(size=(3, 1000)).astype(np.float32)
    _same(qdq_ops.fake_quant(x).cpu(), qdq_ops.fake_quant(x, device="cpu"))
    q, s, pad = qdq_ops.compress(x)
    _same(qdq_ops.decompress(q, s, pad, x.shape).cpu(),
          qdq_ops.fake_quant(x, device="cpu"))
    for dtype in (torch.bfloat16, torch.float16):
        xn = torch.from_numpy(x * 30).to(dtype)
        _same(qdq_ops.fake_quant(xn).cpu(),
              qdq_ops.fake_quant(xn, device="cpu"))
        _same(qmm_ops.matmul_quantized(a_n := torch.from_numpy(a).to(dtype),
                                       b_n := torch.from_numpy(b).to(dtype)
                                       ).cpu(),
              qmm_ops.matmul_quantized(a_n, b_n, device="cpu"))
    for img in (g.integers(0, 256, (72, 130)).astype(np.uint8),
                g.integers(-3000, 3000, (72, 130)).astype(np.int16)):
        tin2 = FixedPointType(10, 2, False)
        _same(st_ops.stencil_fixed(img, SOBEL, 1 / 12, tin2, tout).cpu(),
              st_ops.stencil_fixed(img, SOBEL, 1 / 12, tin2, tout,
                                   device="cpu"))


# ---------------------------------------------------------------------------
# the design search on the card
# ---------------------------------------------------------------------------

# (pipeline, calibration-image seed, budget in dB), as chip_smoke.py's
# phase 6 at 32x32
SEARCHES = [("usm", 23, 50.0), ("dus_ext", 37, 45.0), ("hcd", 11, 40.0)]


def _dse_setup(name, seed, shape=(32, 32)):
    """A pipeline, its params, 2 calibration images and a plan of the
    interval column and a CPU profile of those images."""
    pipe, params = ALL[name](), PARAMS.get(name, {})
    images = image_set(2, shape, seed)
    A.clear_memo()
    plan = A.run_plan(pipe, ["interval", A.ProfilePass(
        images, params=params, device="cpu")])
    return pipe, params, images, plan


def _discrete(res):
    """A search's JSON without its measured error."""
    d = res.to_json_dict()
    for p in d["frontier"]["points"] + [d["chosen"] or {}]:
        p.pop("psnr", None)
        p.pop("max_abs_err", None)
    return d


@pytest.mark.parametrize("name,seed,min_psnr", SEARCHES[:2],
                         ids=[c[0] for c in SEARCHES[:2]])
def test_design_search_on_the_card_equals_the_cpu_oracle(cuda, name, seed,
                                                         min_psnr):
    """Every candidate scored by the band kernel on the card: the search
    equals the one through the oracle on the CPU in every field but the
    measured error, and every frontier point is verified (the kernel
    re-score bit for bit, the oracle cross-check exact)."""
    pipe, params, images, plan = _dse_setup(name, seed)
    kw = dict(params=params, seed=0, anneal_iters=24, verify=True)
    card = run_design_search(pipe, plan, images, ErrorBudget(min_psnr),
                             backend="cuda", device=cuda, **kw)
    cpu = run_design_search(pipe, plan, images, ErrorBudget(min_psnr),
                            backend="interp", device="cpu", **kw)
    assert _discrete(card) == _discrete(cpu)
    pts = card.frontier.points()
    assert pts and all(p.verified and p.oracle_exact for p in pts)
    for p, q in zip(pts, cpu.frontier.points()):
        assert abs(p.psnr - q.psnr) <= 1e-9 * abs(q.psnr)


@pytest.mark.parametrize("name,seed,min_psnr", SEARCHES,
                         ids=[c[0] for c in SEARCHES])
def test_one_band_launch_per_island_per_fresh_candidate(cuda, name, seed,
                                                        min_psnr):
    """A candidate scores all calibration images in one batch: one
    `fused_band` launch per rate island, counted from 0; a candidate
    already scored launches nothing."""
    pipe, params, images, plan = _dse_setup(name, seed)
    ev = Evaluator(pipe, plan.signed(), images, ErrorBudget(min_psnr),
                   params=params, device=cuda)
    rng = np.random.default_rng(seed)
    sound = plan.alphas()
    for _ in range(3):
        a = {n: max(int(v + rng.integers(-2, 1)), 1)
             for n, v in sound.items()}
        b = {n: int(rng.integers(0, 9)) for n in sound}
        islands = partition_islands(lower(pipe, ev.types_of(a, b),
                                          params=params), (32, 32)).islands
        clear_executor_cache()
        torch.cuda.synchronize()
        K.LAUNCHES["fused_band"] = 0
        ev.evaluate(a, b)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fused_band"] == len(islands)
        K.LAUNCHES["fused_band"] = 0
        ev.evaluate(a, b)
        assert K.LAUNCHES["fused_band"] == 0


# ---------------------------------------------------------------------------
# the SMT range analysis: its batched engine on the card
# ---------------------------------------------------------------------------

SMT_SMALL = dict(max_nodes=64, work_budget=4096)

# the JAX package's differential stages (tests/test_smt.py `_DIFF_STAGES`)
SMT_STAGES = [("usm", "sharpen"), ("usm", "masked"), ("dus", "Uy"),
              ("dus", "Dy"), ("dus_ext", "band"), ("hcd", "Ixy"),
              ("hcd", "trace"), ("of1", "Denom"), ("of_pyr1", "cVx0"),
              ("of_pyr1", "Vx1")]


def _smt_pipe(name):
    from repro_torch.pipelines import optical_flow
    if name == "of1":
        return optical_flow.build(n_iters=1)
    if name == "of_pyr1":
        return optical_flow.build_pyramid(n_iters=1)
    return ALL[name]()


def _smt_entries(pipe, stage):
    """`stage` encoded as `analyze_smt` encodes it, and its seed."""
    from repro_torch.core.range_analysis import analyze
    from repro_torch.smt import encoder as E
    bounds = {n: r.range for n, r in analyze(pipe).items()}
    entries = (E.encode_stage_phases(pipe, stage, bounds)
               if E.closure_is_sampled(pipe, stage) else None)
    return entries or [E.encode_stage(pipe, stage, bounds)], bounds[stage]


def _ranges(res):
    return {n: (r.range.lo, r.range.hi) for n, r in res.items()}


def test_sqrt_on_the_card_is_correctly_rounded(cuda):
    """The engine's square roots on the card are IEEE (numpy's); on the
    CPU it takes numpy's, since torch's CPU `sqrt` is not."""
    x = np.abs(np.random.default_rng(0).standard_normal(1 << 20)
               * 10.0 ** np.random.default_rng(1).integers(-300, 300,
                                                            1 << 20))
    got = torch.sqrt(torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert np.array_equal(got, np.sqrt(x))


@pytest.mark.parametrize("name", ["usm", "dus", "dus_ext"])
def test_smt_on_the_card_equals_the_cpu(cuda, name):
    """`analyze_smt` deadline-free at the default node budgets: every
    stage's range is the same on the card and on the CPU."""
    from repro_torch.smt import SMTConfig, analyze_smt
    cfg = SMTConfig(time_budget_s=float("inf"))
    got = analyze_smt(ALL[name](), config=cfg, device=cuda)
    want = analyze_smt(ALL[name](), config=cfg, device="cpu")
    assert _ranges(got) == _ranges(want)


@pytest.mark.parametrize("name,stage", SMT_STAGES,
                         ids=[f"{n}-{s}" for n, s in SMT_STAGES])
def test_smt_decide_on_the_card_equals_the_cpu(cuda, name, stage):
    from repro_torch.smt import solver as S
    entries, seed = _smt_entries(_smt_pipe(name), stage)
    for frac, sense in ((1.5, "ge"), (0.5, "ge"), (1.5, "le"),
                        (0.5, "le")):
        t = (seed.hi if sense == "ge" else seed.lo) * frac
        got = S.decide_multi(entries, sense, t, S.BPBudget(48, 6),
                             device=cuda)
        want = S.decide_multi(entries, sense, t, S.BPBudget(48, 6),
                              device="cpu")
        assert (got.status, got.witness, got.nodes) == \
            (want.status, want.witness, want.nodes), (sense, t)


def test_smt_tightening_of_the_pyramid_on_the_card_equals_the_cpu(cuda):
    """of_pyramid's cVx0 through the batched engine at 64 nodes (the
    case the CPU tests leave to the card: the JAX package takes 6-9 s
    on it)."""
    from repro_torch.smt import SMTConfig
    from repro_torch.smt.optimize import tighten_stage_phases
    entries, seed = _smt_entries(ALL["of_pyramid"](), "cVx0")
    cfg = SMTConfig(time_budget_s=float("inf"), **SMT_SMALL)
    got = tighten_stage_phases(entries, seed, cfg, float("inf"), cuda)
    want = tighten_stage_phases(entries, seed, cfg, float("inf"), "cpu")
    assert (got.lo, got.hi) == (want.lo, want.hi)


@pytest.mark.parametrize("name,stage", [("hcd", "trace"),
                                        ("of_pyr1", "cVx0")])
def test_smt_sweeps_on_the_card_equal_the_cpu_bit_for_bit(cuda, name,
                                                          stage):
    """hc4, the affine sweep, the gradients and the split choice on a
    seeded frontier of random sub-boxes, every bit (the sign of a zero
    included)."""
    from repro_torch.smt import encoder as E
    from repro_torch.smt import solver as S
    (entries, _) = _smt_entries(_smt_pipe(name), stage)
    csp, root = entries[0]
    prog = E.compile_csp(csp)
    rng = np.random.default_rng(5)
    N = 200
    lo0 = np.where(np.isfinite(prog.init_lo), prog.init_lo, -1e3)
    hi0 = np.where(np.isfinite(prog.init_hi), prog.init_hi, 1e3)
    u = np.sort(rng.random((2, N, prog.nvars)), axis=0)
    lo = np.where(np.isfinite(prog.init_lo), lo0 + (hi0 - lo0) * u[0],
                  prog.init_lo)
    hi = np.where(np.isfinite(prog.init_hi), lo0 + (hi0 - lo0) * u[1],
                  prog.init_hi)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tlo = torch.from_numpy(lo).to(dev)
        thi = torch.from_numpy(hi).to(dev)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        alive = S.hc4_batch(prog, tlo, thi, alive, 6)
        alive = S.affine_batch(prog, tlo, thi, alive)
        glo, ghi = S.gradients_batch(prog, tlo, thi, root)
        dp = E.device_program(prog, dev)
        split = S._split_batch(dp, tlo, thi, glo, ghi, alive)
        out[dev.type] = [t.cpu().numpy() for t in
                         (alive, tlo, thi, glo, ghi) + split]
    for got, want in zip(out["cuda"], out["cpu"]):
        if got.dtype == np.float64:
            assert np.array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            assert np.array_equal(got[ok].view(np.int64),
                                  want[ok].view(np.int64))
        else:
            assert np.array_equal(got, want)


def _smt_frontier(prog, seed, n):
    """A seeded frontier of n boxes.  Even rows are random sub-boxes of
    the CSP's box on its base variables, so most of them live; odd rows
    are random sub-boxes on every variable, so most of them die in
    contraction.  Both have infinite bounds, zero bounds of both signs,
    zero-straddling intervals and point intervals sprinkled in."""
    rng = np.random.default_rng(seed)
    nv = prog.nvars
    ilo = np.broadcast_to(prog.init_lo, (n, nv))
    ihi = np.broadcast_to(prog.init_hi, (n, nv))
    flo = np.where(np.isfinite(ilo), ilo, -1e3)
    fhi = np.where(np.isfinite(ihi), ihi, 1e3)
    u = np.sort(rng.random((2, n, nv)), axis=0)
    lo = flo + (fhi - flo) * u[0]
    hi = flo + (fhi - flo) * u[1]
    base = np.zeros(nv, bool)
    base[prog.base] = True
    wild = (np.arange(n) % 2 == 1)[:, None]
    keep = (rng.random((n, nv)) < 0.5) | (~wild & ~base)
    lo = np.where(keep, ilo, lo)
    hi = np.where(keep, ihi, hi)
    m = rng.random((n, nv))
    lo = np.where(m < 0.04, -np.inf, lo)
    hi = np.where((m > 0.04) & (m < 0.08), np.inf, hi)
    zero = rng.choice([0.0, -0.0], (n, nv))
    z = (m > 0.08) & (m < 0.12) & (wild | ((lo <= 0.0) & (hi >= 0.0)))
    lo = np.where(z, zero, lo)
    hi = np.where(z, np.abs(hi), hi)
    z = (m > 0.12) & (m < 0.15) & (wild | ((lo <= 0.0) & (hi >= 0.0)))
    hi = np.where(z, zero, hi)
    lo = np.where(z, -np.abs(lo), lo)
    z = (m > 0.15) & (m < 0.18)
    lo = np.where(z, -np.abs(lo) - 1.0, lo)
    hi = np.where(z, np.abs(hi) + 1.0, hi)
    point = (m > 0.18) & (m < 0.22) & np.isfinite(lo) & (wild | base)
    hi = np.where(point, lo, hi)
    return np.ascontiguousarray(lo), np.ascontiguousarray(hi)


def _same_f64_bits(got, want, label):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)), label
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.int64), want[ok].view(np.int64)), \
        label


def _smt_walks_both_ways(prog, root, lo, hi, alive, dev, rounds=6):
    """hc4 and the gradients through the walk kernels and through their
    plain versions, all on the card; no host sync in the kernels' calls."""
    from repro_torch.smt import encoder as E
    from repro_torch.smt import solver as S
    dp = E.device_program(prog, dev)
    out = {}
    for way in ("kernel", "plain"):
        tlo, thi = (torch.from_numpy(lo).to(dev),
                    torch.from_numpy(hi).to(dev))
        a = torch.from_numpy(alive).to(dev)
        if way == "kernel":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                a2 = S._hc4_rows(dp, tlo, thi, a, rounds)
                g = S._gradients_rows(dp, prog.nvars, tlo, thi, root)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            a2 = S._hc4_plain(dp, tlo, thi, a, rounds)
            g = S._gradients_plain(dp, prog.nvars, tlo, thi, root)
        torch.cuda.synchronize()
        out[way] = (a2, tlo, thi) + tuple(g)
    return out


@pytest.mark.parametrize("n", [12, 100, 512, 4096])
@pytest.mark.parametrize("name,stage", SMT_STAGES,
                         ids=[f"{n}-{s}" for n, s in SMT_STAGES])
def test_smt_walk_kernels_equal_their_plain_versions(cuda, name, stage, n):
    """`smt_hc4` and `smt_grad` against `_hc4_plain` and
    `_gradients_plain` on the card, every row (dead ones included) and
    every bit, the sign of a zero too; the gradients over the frontier
    hc4 left."""
    from repro_torch.smt import encoder as E
    entries, _ = _smt_entries(_smt_pipe(name), stage)
    csp, root = entries[0]
    prog = E.compile_csp(csp)
    lo, hi = _smt_frontier(prog, n, n)
    alive = np.random.default_rng(n + 1).random(n) < 0.9
    out = _smt_walks_both_ways(prog, root, lo, hi, alive, cuda)
    got, want = out["kernel"], out["plain"]
    assert torch.equal(got[0], want[0])
    assert int(want[0].sum()) < n                 # dead rows present
    for label, g, w in zip(("lo", "hi", "glo", "ghi"), got[1:], want[1:]):
        _same_f64_bits(g, w, label)


def test_smt_walk_kernels_take_torch_pow_on_the_card(cuda):
    """x ** n for n = 3, 4, 5 and odd and even roots (no benchmark has
    them): the kernels compute them as the plain version does on the
    card, through torch's `pow`."""
    from repro_torch.core.interval import Interval
    from repro_torch.smt import encoder as E
    csp = E.CSP()
    x = csp.new_var("x", Interval(-4.0, 5.0), "input")
    y = csp.new_var("y", Interval(0.5, 3.0), "input")
    ops = [csp.new_var(f"p{n}", Interval(-1e4, 1e4), "aux",
                       E.Def("pow", ((E.VAR, v),), n=n))
           for n in (3, 4, 5) for v in (x, y)]
    s = csp.new_var("s", Interval(-1e5, 1e5), "aux",
                    E.Def("+", ((E.VAR, ops[0]), (E.VAR, ops[3]))))
    root = csp.new_var("r", Interval(-1e5, 1e5), "aux",
                       E.Def("*", ((E.VAR, s), (E.VAR, ops[5]))))
    prog = E.compile_csp(csp)
    lo, hi = _smt_frontier(prog, 3, 512)
    out = _smt_walks_both_ways(prog, root, lo, hi,
                               np.ones(512, bool), cuda)
    for label, g, w in zip(("alive", "lo", "hi", "glo", "ghi"),
                           out["kernel"], out["plain"]):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            _same_f64_bits(g, w, label)


def test_smt_walks_launch_once_a_call(cuda, monkeypatch):
    """Counts from 0: one `smt_hc4` launch a `_hc4_rows` call and one
    `smt_grad` launch a `_gradients_rows` call, alone and through a
    `decide_multi` run on the card."""
    from repro_torch.smt import encoder as E
    from repro_torch.smt import solver as S
    from repro_torch.smt import walk as W
    entries, seed = _smt_entries(_smt_pipe("hcd"), "trace")
    csp, root = entries[0]
    prog = E.compile_csp(csp)
    lo, hi = _smt_frontier(prog, 0, 64)
    dp = E.device_program(prog, cuda)
    tlo, thi = torch.from_numpy(lo).to(cuda), torch.from_numpy(hi).to(cuda)
    W.LAUNCHES.update(smt_hc4=0, smt_grad=0)
    S._hc4_rows(dp, tlo, thi, torch.ones(64, dtype=torch.bool, device=cuda),
                6)
    assert W.LAUNCHES == {"smt_hc4": 1, "smt_grad": 0}
    S._gradients_rows(dp, prog.nvars, tlo, thi, root)
    assert W.LAUNCHES == {"smt_hc4": 1, "smt_grad": 1}
    calls = {"smt_hc4": 0, "smt_grad": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(S, "_hc4_rows", counted("smt_hc4", S._hc4_rows))
    monkeypatch.setattr(S, "_gradients_rows",
                        counted("smt_grad", S._gradients_rows))
    W.LAUNCHES.update(smt_hc4=0, smt_grad=0)
    S.decide_multi(entries, "ge", seed.hi * 0.5, S.BPBudget(256, 6),
                   device=cuda)
    torch.cuda.synchronize()
    assert calls["smt_hc4"] > 0 and calls["smt_grad"] > 0
    assert W.LAUNCHES == calls


@pytest.mark.parametrize("name", ["usm", "dus", "dus_ext"])
def test_smt_designs_kernel_equals_plain_version(cuda, name):
    """The SMT column's design (and the phase-split one, whose residue
    types run through `BitwidthPlan.phase_types`) through the band
    kernel equals its plain version."""
    from repro_torch.smt import SMTConfig
    pipe, params = ALL[name](), PARAMS.get(name, {})
    cfg = SMTConfig(time_budget_s=float("inf"), **SMT_SMALL)
    A.clear_memo()
    plan = A.run_plan(pipe, [A.make_pass("smt", config=cfg, device=cuda),
                             A.make_pass("smt-phase-split", config=cfg,
                                         device=cuda)],
                      betas={n: 4 for n in pipe.stages})
    A.clear_memo()
    for col in ("smt", "smt-phase-split"):
        design = design_from_plan(plan, col)
        if col == "smt-phase-split" and name != "usm":
            assert design.phases, name
        _check(pipe, _inputs(name, (2, 96, 128), 80), design, params, cuda)


# ---------------------------------------------------------------------------
# numpy's elementwise rules in the band kernel; telemetry and Table 12
# ---------------------------------------------------------------------------

def _rule_pipes():
    """(name, pipeline, types, input range): a sqrt stage, 1 / min and
    1 / max of zeros of both signs, and an exact cube (the chain of
    products the encoder emits)."""
    from repro_torch.dsl.builder import PipelineBuilder, maxv, minv, sqrtv
    out = []
    p = PipelineBuilder("sqrt")
    a = p.image("a", 0, 1 << 20)
    p.define("s", sqrtv(a))
    out.append(("sqrt", p.build(),
                {"a": FixedPointType(21, 12, False), "s": None}, 1 << 20))
    p = PipelineBuilder("zeros")
    a = p.image("a", 0, 15)
    z1 = p.define("z1", (a - 8.0) * 0.0)
    z2 = p.define("z2", (8.0 - a) * 0.0)
    p.define("inv_min", 1.0 / minv(z1, z2))
    p.define("inv_max", 1.0 / maxv(z1, z2))
    out.append(("signed_zero", p.build(),
                {"a": FixedPointType(4, 0, False), "z1": None, "z2": None,
                 "inv_min": None, "inv_max": None}, 16))
    p = PipelineBuilder("cube")
    a = p.image("a", 0, 15)
    b = p.define("b", a * 0.37 + 1.3)
    p.define("c", a ** 3)
    p.define("f", b ** 5 - b ** 1 + b ** 0)
    out.append(("cube", p.build(),
                {"a": FixedPointType(4, 0, False),
                 "b": FixedPointType(5, 5, False),
                 "c": FixedPointType(13, 0, False), "f": None}, 16))
    return out


@pytest.mark.parametrize("case", ["sqrt", "signed_zero", "cube"])
def test_numpy_rules_through_the_band_kernel(cuda, case):
    """The band kernel, its plain version on the card and the per-stage
    oracle on the CPU (held to the reference's numpy by the CPU tests),
    bit for bit, the sign of a zero included."""
    name, pipe, types, hi = next(r for r in _rule_pipes() if r[0] == case)
    rng = np.random.default_rng(len(case))
    img = rng.integers(0, hi, (2, 37, 45)).astype(np.float64)
    if case == "sqrt":
        img = img + np.round(rng.random(img.shape) * 4096) / 4096
    outs = list(pipe.outputs) + [n for n in pipe.stages
                                 if n not in pipe.outputs
                                 and n != "a"]
    before = K.LAUNCHES["fused_band"]
    got = run_fixed(pipe, img, types, backend="cuda", device=cuda,
                    outputs=outs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_band"] > before
    plain = run_fixed(pipe, img, types, backend="torch", device=cuda,
                      outputs=outs)
    oracle = run_fixed(pipe, img, types, backend="interp", device="cpu")
    assert sorted(got) == sorted(outs)
    for k in outs:
        g = got[k].cpu().numpy()
        assert np.array_equal(g.view(np.int64),
                              plain[k].cpu().numpy().view(np.int64)), k
        assert np.array_equal(g.view(np.int64),
                              oracle[k].numpy().view(np.int64)), k


def _rt_records(fn):
    from repro_torch import obs
    with obs.tracing(runtime_ranges=True) as tr:
        fn()
    return [dict(e["attrs"]) for e in tr.events("rt.range")]


@pytest.mark.parametrize("name", ["usm", "dus_ext"])
def test_rt_range_on_the_card_equals_the_cpu(cuda, name):
    """`rt.range` records reduced on the card (one small copy a stage)
    equal the CPU's, for the band kernel against its plain version and
    for the per-stage walk; the outputs with telemetry on equal those
    with it off."""
    pipe, params = ALL[name](), PARAMS.get(name, {})
    design = load_types(name)
    img = _frames((3, 64, 80), 21)
    for backend, ref_backend in (("cuda", "torch"), ("interp", "interp")):
        got = _rt_records(lambda: run_fixed(pipe, img, design, params,
                                            backend=backend, device=cuda))
        want = _rt_records(lambda: run_fixed(pipe, img, design, params,
                                             backend=ref_backend,
                                             device="cpu"))
        assert got and [dict(r, backend=ref_backend) for r in got] == want
    from repro_torch import obs
    with obs.tracing(runtime_ranges=True):
        on = run_fixed(pipe, img, design, params, backend="cuda",
                       device=cuda)
    off = run_fixed(pipe, img, design, params, backend="cuda", device=cuda)
    assert all(torch.equal(on[k], off[k]) for k in off)


def test_table12_search_on_the_card_equals_the_cpu(cuda):
    """Table XII's design search on a small USM setup (interval +
    profile plan) through the band kernel equals the CPU's rows."""
    from repro_torch.benchmarks import paper_tables as PT
    from repro_torch.pipelines import workflows as W
    A.clear_memo()
    cpu = W.make_usm(2, 2, (32, 32), device="cpu")
    plan = A.run_plan(cpu.pipeline,
                      ["interval", A.ProfilePass(cpu.train_images,
                                                 params=cpu.params,
                                                 device="cpu")],
                      default_column="interval")
    before = K.LAUNCHES["fused_band"]
    got = PT.design_frontier(W.make_usm(2, 2, (32, 32), device=cuda), plan)
    assert K.LAUNCHES["fused_band"] > before
    assert got == PT.design_frontier(cpu, plan)
    A.clear_memo()


# ---------------------------------------------------------------------------
# band ranges, the sharded executor and the f32 walk
# ---------------------------------------------------------------------------

# (rows, shard counts): 1080 rows are 135 bands of 8 (3^3 * 5), 1088 are
# 136 (2^3 * 17)
RANGES = [(1080, (3, 5)), (1088, (2, 4))]
RANGE_CASES = [(n, h, s) for n in ALL for h, s in RANGES]


@pytest.mark.parametrize("name,rows,shards", RANGE_CASES,
                         ids=[f"{n}-{h}" for n, h, _ in RANGE_CASES])
def test_band_ranges_equal_plain_version_and_whole_launch(cuda, name, rows,
                                                          shards):
    """`fused_pipeline(..., bands=(d*k, k))` == its plain version, and
    the ranges joined along rows == one whole launch, on every island."""
    shape = (2, rows, 96)
    lp = lower(ALL[name](), load_types(name), params=PARAMS.get(name, {}))
    img = _inputs(name, shape, 17)
    imgs = img if isinstance(img, tuple) else (img,)
    bufs = {n: B.ingest_input(torch.from_numpy(x).to(cuda), lp.stages[n])
            for n, x in zip(lp.pipeline.input_stages(), imgs)}
    for isl in partition_islands(lp, shape[1:]).islands:
        enc = K.encode_program(island_program(lp, isl))
        grid = isl.schedule.grid
        ins = [bufs[n] for n in isl.inputs]
        whole = K.fused_pipeline(enc, grid, 2)(*ins)
        for S in shards:
            assert grid % S == 0, (name, rows, S)
            k = grid // S
            parts = []
            for d in range(S):
                got = K.fused_pipeline(enc, grid, 2, bands=(d * k, k))(*ins)
                want = K.fused_pipeline_reference(enc, grid, 2,
                                                  bands=(d * k, k))(*ins)
                for n, g, w in zip(isl.outputs, got, want):
                    assert g.shape == w.shape and g.dtype == w.dtype
                    assert torch.equal(g, w), (n, S, d)
                parts.append(got)
            for o, w in enumerate(whole):
                assert torch.equal(torch.cat([p[o] for p in parts], dim=1),
                                   w), (S, isl.outputs[o])
        bufs.update(zip(isl.outputs, whole))


SHARDED = [("usm", (2, 48, 48)), ("hcd", (48, 48)), ("dus_ext", (2, 48, 48)),
           ("dus", (2, 47, 48)), ("of_pyramid", (2, 40, 40))]


@pytest.mark.parametrize("name,shape", SHARDED,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s in SHARDED])
def test_run_fixed_sharded_on_the_card_equals_interp(cuda, name, shape):
    import warnings
    pipe, params = ALL[name](), PARAMS.get(name, {})
    img = _inputs(name, shape, 19)
    before = K.LAUNCHES["fused_band"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = run_fixed(pipe, img, load_types(name), params,
                        backend="sharded", device=cuda)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_band"] > before
    want = run_fixed(pipe, img, load_types(name), params, backend="interp",
                     device=cuda)
    assert sorted(got) == sorted(pipe.outputs)
    for k in got:
        assert got[k].device == torch.device("cuda", 0)
        assert torch.equal(got[k], want[k]), k


def test_pipeline_server_sharded_returns_what_cuda_returns(cuda):
    from repro_torch.serve import PipelineServer, serve_offline
    pipe, params = ALL["usm"](), PARAMS["usm"]
    imgs = [_frames((64, 80), 60 + i) for i in range(6)]
    outs = {}
    for backend in ("sharded", "cuda"):
        with PipelineServer(pipe, load_types("usm"), params,
                            backend=backend, batch_size=4,
                            device=cuda) as srv:
            outs[backend] = serve_offline(srv, imgs)
    for a, b in zip(outs["sharded"], outs["cuda"]):
        assert torch.equal(a["masked"], b["masked"])


def test_sharded_over_every_card_equals_one_card(cuda):
    from repro_torch.launch import make_band_mesh
    from repro_torch.lowering import compile_backend
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("one card present: the split over cards needs two")
    lp = lower(ALL["hcd"](), load_types("hcd"))
    img = _frames((2, 8 * n * 3, 96), 23)
    one = compile_backend(lp, "sharded", mesh=make_band_mesh(1))(img)
    every = compile_backend(lp, "sharded", mesh=make_band_mesh(n))(img)
    for k in one:
        assert torch.equal(one[k], every[k]), k


@pytest.mark.parametrize("name", list(ALL))
def test_f32_walk_on_the_card_equals_the_cpu(cuda, name):
    """The f32 walk's torch ops under XLA's rules give the CPU's bits on
    the card: values and sign bits, fixed and float."""
    from repro_torch.dsl.exec import run_float
    pipe, params = ALL[name](), PARAMS.get(name, {})
    img = _inputs(name, (40, 56), 29)
    for got, want in (
            (run_fixed(pipe, img, load_types(name), params, backend="f32",
                       device=cuda),
             run_fixed(pipe, img, load_types(name), params, backend="f32",
                       device="cpu")),
            (run_float(pipe, img, params, device=cuda, backend="f32"),
             run_float(pipe, img, params, device="cpu", backend="f32"))):
        assert sorted(got) == sorted(want)
        for k in want:
            g = got[k].cpu()
            assert g.dtype == torch.float32
            assert torch.equal(g, want[k]) or torch.equal(
                torch.nan_to_num(g), torch.nan_to_num(want[k])), k
            assert torch.equal(torch.signbit(g), torch.signbit(want[k])), k


# ---------------------------------------------------------------------------
# the dense LM at smoke size: the card against the CPU
# ---------------------------------------------------------------------------

LM_ATOL = 0.02          # logits within +-2; cuBLAS sums in another order


def _lm(arch, kv="bf16"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    cfg = dataclasses.replace(get_smoke_config(arch), kv_cache_dtype=kv)
    m = get_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0))
    return cfg, m, params


def _tree_to(tree, dev):
    """A pytree of tensors on `dev` (`_to` moves numpy images)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _close_logits(got, want, atol):
    """Within atol, the top-1 token equal wherever the CPU's top-2 margin
    exceeds twice the tolerance."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.allclose(got, want, atol=atol, rtol=0), \
        float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "minicpm-2b"])
def test_lm_forward_and_decode_on_the_card_equal_the_cpu(cuda, arch, kv):
    """cuBLAS's bf16 products summed in f32 against the CPU's f32 sums of
    the same products: logits within LM_ATOL; the caches after 4 steps
    within one bf16 unit (int8 codes within one step)."""
    from repro_torch.data.batches import make_batch
    cfg, m, params = _lm(arch, kv)
    gp = _tree_to(params, cuda)
    batch = make_batch(cfg, 2, 16, seed=4, device="cpu")
    _close_logits(m.forward(gp, _tree_to(batch, cuda)),
                  m.forward(params, batch), LM_ATOL)
    s_cpu = m.init_decode_state(2, 16, device="cpu")
    s_gpu = m.init_decode_state(2, 16, device=cuda)
    for t in range(4):
        tok = batch["tokens"][:, t]
        want, s_cpu = m.decode_step(params, tok, s_cpu)
        got, s_gpu = m.decode_step(gp, tok.to(cuda), s_gpu)
        _close_logits(got, want, LM_ATOL)
    assert int(s_gpu["length"]) == int(s_cpu["length"]) == 4
    for k in ("k", "v"):
        g, w = s_gpu[k].float().cpu(), s_cpu[k].float()
        tol = 1 if kv == "int8" else 2.0 ** -7 * w.abs() + 3e-5
        assert ((g - w).abs() <= tol).all(), k


def test_lm_prefill_on_the_card_equals_stepwise_decode(cuda):
    """The reference test's check on the card: atol 0.15 / rtol 0.05, the
    next token's argmax equal after one more step from either state."""
    cfg, m, params = _lm("qwen3-4b")
    gp = _tree_to(params, cuda)
    from repro_torch.serve.prefill import prefill
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)).to(cuda)
    state = m.init_decode_state(1, 16, device=cuda)
    for t in range(8):
        ref, state = m.decode_step(gp, toks[:, t], state)
    pf, pstate = prefill(gp, toks, cfg, 16)
    assert torch.allclose(pf, ref, atol=0.15, rtol=0.05)
    nxt = ref.argmax(-1).to(torch.int32)
    l1, _ = m.decode_step(gp, nxt, state)
    l2, _ = m.decode_step(gp, nxt, pstate)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lm_batcher_tokens_on_the_card_equal_the_cpu(cuda, kv):
    """The example's setup (4 requests, 2 slots, max_new 8, max_len 64):
    every generated token equal."""
    from repro_torch.launch.serve import (ContinuousBatcher, Request,
                                          serve_requests)
    cfg, m, params = _lm("qwen3-4b", kv)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=4))
               for _ in range(4)]
    out = []
    for p in (params, _tree_to(params, cuda)):
        reqs = [Request(i, q, 8) for i, q in enumerate(prompts)]
        assert serve_requests(ContinuousBatcher(m, p, 2, 64), reqs) == 22
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]


@pytest.mark.parametrize("bits", [8, 4, 2, 12])
def test_lm_fake_quant_params_on_the_card_equal_the_cpu(cuda, bits):
    """Per-channel absmax scales, true division, half-even codes: the card
    gives the CPU's values at tolerance 0."""
    from repro_torch.models.common import tree_items
    from repro_torch.quant.autoquant import fake_quant_params
    from repro_torch.quant.calibrate import REVERSE_TOPO_CLASSES
    _, _, params = _lm("qwen3-4b")
    chosen = {c: bits for c in REVERSE_TOPO_CLASSES}
    want = dict(tree_items(fake_quant_params(params, chosen)))
    got = dict(tree_items(fake_quant_params(_tree_to(params, cuda), chosen)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].is_cuda and torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lm_graphed_decode_step_equals_the_plain_step(cuda, kv):
    """The batcher's CUDA graph of `decode_step` replays the plain step's
    kernels: 5 steps, logits and state equal at tolerance 0, from a fresh
    state and from a state handed in again."""
    from repro_torch.launch.serve import GraphedDecodeStep
    cfg, m, params = _lm("qwen3-4b", kv)
    gp = _tree_to(params, cuda)
    step = GraphedDecodeStep(m.decode_step)
    s_plain = m.init_decode_state(2, 16, device=cuda)
    s_graph = m.init_decode_state(2, 16, device=cuda)
    toks = torch.arange(10, dtype=torch.int32, device=cuda).reshape(5, 2)
    for t in range(5):
        want, s_plain = m.decode_step(gp, toks[t], s_plain)
        got, s_graph = step(gp, toks[t], s_graph)
        assert torch.equal(got, want)
        assert all(torch.equal(s_graph[k], v) for k, v in s_plain.items())
    fresh = m.init_decode_state(2, 16, device=cuda)
    got, _ = step(gp, toks[0], fresh)
    want, _ = m.decode_step(gp, toks[0], fresh)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the MoE feed-forward and the MoE decoders: the card against the CPU
# ---------------------------------------------------------------------------

# two bf16 units at the largest output: the card's softmax rounds a
# router weight to another bf16 value now and then, and each output is
# rounded to bf16 after a sum over k of f32 products
MOE_RTOL_OF_MAX = 2.0 ** -6


def _moe_layer(cfg, seed):
    """One layer's MoE parameters (not stacked), drawn as `init_params`
    draws them, on the CPU."""
    from repro_torch.models.common import init_tree
    from repro_torch.models.moe import moe_param_specs
    return init_tree(torch.Generator().manual_seed(seed),
                     moe_param_specs(cfg))


@pytest.mark.parametrize("arch,tokens", [
    ("qwen2-moe-a2.7b", (2, 16)), ("mixtral-8x7b", (2, 16)),
    ("qwen2-moe-a2.7b-full", (4, 1)), ("qwen2-moe-a2.7b-full", (1, 128))])
def test_moe_ffn_on_the_card_equals_the_cpu(cuda, arch, tokens):
    """cuBLAS's bf16 expert products summed in f32 against the CPU's:
    tokens routed to the same experts on both (at least 95% of them)
    give outputs within MOE_RTOL_OF_MAX of the largest output; the
    smoke configs and qwen2-moe's full width at decode (4 tokens) and
    prefill (128) sizes."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import moe
    name = arch.removesuffix("-full")
    cfg = get_config(name) if arch.endswith("-full") else \
        get_smoke_config(name)
    p = _moe_layer(cfg, 3)
    gp = _tree_to(p, cuda)
    x = torch.randn(tokens + (cfg.d_model,), generator=torch.Generator(
        ).manual_seed(4)).to(torch.bfloat16)
    want = moe.moe_ffn(x, p, cfg)
    got = moe.moe_ffn(x.to(cuda), gp, cfg)
    assert got.is_cuda and got.dtype == torch.bfloat16
    xt = x.reshape(-1, cfg.d_model)
    _, _, e_cpu = moe.route(xt, p["router"], cfg)
    _, _, e_gpu = moe.route(xt.to(cuda), gp["router"], cfg)
    same = (e_gpu.cpu() == e_cpu).all(-1)
    assert same.float().mean() >= 0.95, float(same.float().mean())
    diff = (got.cpu().float() - want.float()).abs().reshape(-1, cfg.d_model)
    tol = MOE_RTOL_OF_MAX * float(want.float().abs().max())
    assert float(diff[same].max()) <= tol, (float(diff[same].max()), tol)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_moe_graphed_decode_step_equals_the_plain_step(cuda, arch):
    """The batcher's CUDA graph of the MoE `decode_step` (routing,
    dispatch and combine with fixed shapes, no host sync) replays the
    plain step's kernels: 5 steps, logits and state equal at tolerance
    0."""
    from repro_torch.launch.serve import GraphedDecodeStep
    cfg, m, params = _lm(arch)
    gp = _tree_to(params, cuda)
    step = GraphedDecodeStep(m.decode_step)
    s_plain = m.init_decode_state(4, 16, device=cuda)
    s_graph = m.init_decode_state(4, 16, device=cuda)
    toks = torch.arange(20, dtype=torch.int32, device=cuda).reshape(5, 4)
    for t in range(5):
        want, s_plain = m.decode_step(gp, toks[t], s_plain)
        got, s_graph = step(gp, toks[t], s_graph)
        assert torch.equal(got, want)
        assert all(torch.equal(s_graph[k], v) for k, v in s_plain.items())


def test_graphed_decode_step_refuses_other_parameters(cuda):
    """A graph captured for one parameter tree raises `ValueError` when
    called with another (it would read the captured tensors), also under
    `python -O`; the captured tree still replays."""
    from repro_torch.launch.serve import GraphedDecodeStep
    cfg, m, params = _lm("qwen2-moe-a2.7b")
    gp = _tree_to(params, cuda)
    other = _tree_to(params, cuda)
    step = GraphedDecodeStep(m.decode_step)
    state = m.init_decode_state(2, 16, device=cuda)
    tok = torch.zeros(2, dtype=torch.int32, device=cuda)
    step(gp, tok, state)
    with pytest.raises(ValueError, match="other parameters"):
        step(other, tok, state)
    fresh = m.init_decode_state(2, 16, device=cuda)
    got, _ = step(gp, tok, fresh)
    want, _ = m.decode_step(gp, tok, fresh)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the VLM and the encoder-decoder at smoke size: the card against the CPU
# ---------------------------------------------------------------------------

def test_vlm_forward_and_decode_on_the_card_equal_the_cpu(cuda):
    """paligemma-smoke: the forward with the image prefix (8 patch
    embeddings) and without, and 4 text decode steps; logits within
    LM_ATOL with the top-1 rule, the caches within one bf16 unit."""
    from repro_torch.data.batches import make_batch
    cfg, m, params = _lm("paligemma-3b")
    gp = _tree_to(params, cuda)
    batch = make_batch(cfg, 2, 16, seed=4, device="cpu")
    text = {"tokens": batch["tokens"]}
    for b in (batch, text):
        _close_logits(m.forward(gp, _tree_to(b, cuda)), m.forward(params, b),
                      LM_ATOL)
    s_cpu = m.init_decode_state(2, 16, device="cpu")
    s_gpu = m.init_decode_state(2, 16, device=cuda)
    for t in range(4):
        tok = batch["tokens"][:, t]
        want, s_cpu = m.decode_step(params, tok, s_cpu)
        got, s_gpu = m.decode_step(gp, tok.to(cuda), s_gpu)
        _close_logits(got, want, LM_ATOL)
    for k in ("k", "v"):
        g, w = s_gpu[k].float().cpu(), s_cpu[k].float()
        assert ((g - w).abs() <= 2.0 ** -7 * w.abs() + 3e-5).all(), k


def _whisper_smoke_state(m, params, batch, dev):
    """whisper-smoke's decode state for `batch` on `dev`: the cross K/V
    of its frames' encoder output."""
    from repro_torch.models import encdec
    enc = encdec.encode(params, batch["frames"].to(dev), m.cfg)
    ck, cv = encdec.cross_kv(params, enc, m.cfg)
    return enc, dict(m.init_decode_state(2, 16, device=dev), cross_k=ck,
                     cross_v=cv)


def test_encdec_forward_and_decode_on_the_card_equal_the_cpu(cuda):
    """whisper-smoke: the encoder output within one bf16 unit of the
    largest output, the forward's logits and those of 4 decode steps over
    each device's own cross K/V within LM_ATOL with the top-1 rule."""
    from repro_torch.data.batches import make_batch
    cfg, m, params = _lm("whisper-medium")
    gp = _tree_to(params, cuda)
    batch = make_batch(cfg, 2, 16, seed=4, device="cpu")
    _close_logits(m.forward(gp, _tree_to(batch, cuda)),
                  m.forward(params, batch), LM_ATOL)
    enc_cpu, s_cpu = _whisper_smoke_state(m, params, batch, "cpu")
    enc_gpu, s_gpu = _whisper_smoke_state(m, gp, batch, cuda)
    w = enc_cpu.float()
    assert torch.allclose(enc_gpu.float().cpu(), w, rtol=2.0 ** -7,
                          atol=2.0 ** -7 * float(w.abs().max()))
    for t in range(4):
        tok = batch["tokens"][:, t]
        want, s_cpu = m.decode_step(params, tok, s_cpu)
        got, s_gpu = m.decode_step(gp, tok.to(cuda), s_gpu)
        _close_logits(got, want, LM_ATOL)


def test_encdec_graphed_decode_step_equals_the_plain_step(cuda):
    """The batcher's CUDA graph of whisper's `decode_step` replays the
    plain step's kernels: 5 steps over the encoder's cross K/V, logits
    and state equal at tolerance 0; the graph's state keeps its cross
    K/V (passed through, not copied onto themselves)."""
    from repro_torch.data.batches import make_batch
    from repro_torch.launch.serve import GraphedDecodeStep
    cfg, m, params = _lm("whisper-medium")
    gp = _tree_to(params, cuda)
    batch = make_batch(cfg, 2, 16, seed=5, device="cpu")
    _, s_plain = _whisper_smoke_state(m, gp, batch, cuda)
    s_graph = {k: v.clone() for k, v in s_plain.items()}
    cross = s_plain["cross_k"].clone()
    step = GraphedDecodeStep(m.decode_step)
    toks = batch["tokens"][:, :5].T.contiguous().to(cuda)
    for t in range(5):
        want, s_plain = m.decode_step(gp, toks[t], s_plain)
        got, s_graph = step(gp, toks[t], s_graph)
        assert torch.equal(got, want)
        assert all(torch.equal(s_graph[k], v) for k, v in s_plain.items())
    assert torch.equal(s_graph["cross_k"], cross)


# ---------------------------------------------------------------------------
# RWKV6: the WKV at full width and the decoder at smoke size, the card
# against the CPU
# ---------------------------------------------------------------------------

# the card's f32 sums run in another order than the CPU's, and a bf16
# projection (r, k, v) may round a unit apart: states and carried tokens
# within four bf16 units of their largest magnitude
RWKV_STATE_TOL = 2.0 ** -6


def _rwkv_states_close(got, want):
    for k in ("s", "x_att", "x_ffn"):
        g, w = got[k].float().cpu(), want[k].float()
        tol = RWKV_STATE_TOL * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, (k, float(
            (g - w).abs().max()), tol)
    assert int(got["length"]) == int(want["length"])


@pytest.mark.parametrize("chunked", [False, True], ids=["scan", "chunked"])
def test_rwkv_wkv6_on_the_card_equals_the_cpu(cuda, chunked):
    """rwkv6-3b's heads (40 of 64) over 128 tokens from a nonzero state,
    decays of an initialised model (exp(-exp(z)), z of spread 0.11):
    outputs and final state within 2^-14 of their largest value (the
    CPU tests hold the CPU's to the reference at 2^-16 and 2^-20)."""
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(9)
    r, k, v = (torch.randn(1, 128, 40, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.11 * torch.randn(1, 128, 40, 64,
                                                generator=g)))
    u = 0.3 * torch.randn(40, 64, generator=g)
    s0 = torch.randn(1, 40, 64, 64, generator=g)
    fn = ssm.wkv6_chunked if chunked else ssm.wkv6_scan
    want = fn(r, k, v, w, u, s0)
    got = fn(*(t.to(cuda) for t in (r, k, v, w, u, s0)))
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == torch.float32
        tol = 2.0 ** -14 * float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= tol


def test_rwkv_forward_decode_and_prefill_on_the_card_equal_the_cpu(cuda):
    """rwkv6-smoke: the forward's logits, those of 4 decode steps and of
    an 8-token prefill within LM_ATOL with the top-1 rule; the decode and
    prefill states within RWKV_STATE_TOL of their largest magnitude."""
    from repro_torch.data.batches import make_batch
    from repro_torch.serve.prefill import prefill
    cfg, m, params = _lm("rwkv6-3b")
    gp = _tree_to(params, cuda)
    batch = make_batch(cfg, 2, 16, seed=4, device="cpu")
    _close_logits(m.forward(gp, _tree_to(batch, cuda)),
                  m.forward(params, batch), LM_ATOL)
    s_cpu = m.init_decode_state(2, 16, device="cpu")
    s_gpu = m.init_decode_state(2, 16, device=cuda)
    for t in range(4):
        tok = batch["tokens"][:, t]
        want, s_cpu = m.decode_step(params, tok, s_cpu)
        got, s_gpu = m.decode_step(gp, tok.to(cuda), s_gpu)
        _close_logits(got, want, LM_ATOL)
    _rwkv_states_close(s_gpu, s_cpu)
    toks = batch["tokens"][:, :8]
    want, p_cpu = prefill(params, toks, cfg, 16)
    got, p_gpu = prefill(gp, toks.to(cuda), cfg, 16)
    _close_logits(got, want, LM_ATOL)
    _rwkv_states_close(p_gpu, p_cpu)


def test_rwkv_graphed_decode_step_equals_the_plain_step(cuda):
    """The batcher's CUDA graph of rwkv's `decode_step` (the WKV state and
    carried tokens copied back into the graph's state) replays the plain
    step's kernels: 5 steps at 4 slots, logits and state equal at
    tolerance 0, from a fresh state and from a state handed in again."""
    from repro_torch.launch.serve import GraphedDecodeStep
    cfg, m, params = _lm("rwkv6-3b")
    gp = _tree_to(params, cuda)
    step = GraphedDecodeStep(m.decode_step)
    s_plain = m.init_decode_state(4, 16, device=cuda)
    s_graph = m.init_decode_state(4, 16, device=cuda)
    toks = torch.arange(20, dtype=torch.int32, device=cuda).reshape(5, 4)
    for t in range(5):
        want, s_plain = m.decode_step(gp, toks[t], s_plain)
        got, s_graph = step(gp, toks[t], s_graph)
        assert torch.equal(got, want)
        assert all(torch.equal(s_graph[k], v) for k, v in s_plain.items())
    fresh = m.init_decode_state(4, 16, device=cuda)
    got, _ = step(gp, toks[0], fresh)
    want, _ = m.decode_step(gp, toks[0], fresh)
    assert torch.equal(got, want)
