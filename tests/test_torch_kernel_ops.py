"""The kernel library of the port against the JAX package, bit for bit.

`fixedpoint_stencil`, `qmatmul_i32`, `qmatmul_dequant`, `block_quantize`
and `block_dequantize` (the wrappers, which run their plain versions on
CPU tensors) against the Pallas kernels in interpret mode, and the front
ends `stencil_fixed`, `matmul_quantized`, `fake_quant`, `compress` and
`decompress` against the reference's.  Tolerance 0 everywhere, dtype
included: all of it is exact integer arithmetic or the same f32, bf16
and f16 operations in the same order.  The reference runs at JAX's
default x32; its front ends are jitted, so the port follows XLA's
compiled forms, which differ by dtype (`qdq.kernel.absmax_scale`).
"""
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.fixedpoint import FixedPointType as RefType
from repro.kernels.qdq import kernel as rqdq
from repro.kernels.qdq import ops as rqdq_ops
from repro.kernels.qmatmul import kernel as rqmm
from repro.kernels.qmatmul import ops as rqmm_ops
from repro.kernels.stencil import kernel as rst
from repro.kernels.stencil import ops as rst_ops
from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.kernels.qdq import kernel as qdq
from repro_torch.kernels.qdq import ops as qdq_ops
from repro_torch.kernels.qmatmul import kernel as qmm
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.stencil import kernel as st
from repro_torch.kernels.stencil import ops as st_ops
from _torch_threads import one_torch_thread  # noqa: F401

SOBEL = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
BLUR5 = [[a * b for b in (1, 4, 6, 4, 1)] for a in (1, 4, 6, 4, 1)]


def _np(t):
    """A CPU tensor as numpy, bf16 as ml_dtypes' bfloat16 (same bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _narrow(x32: np.ndarray, dtype: torch.dtype):
    """f32 values rounded into `dtype`: (torch tensor, the same bits as
    a numpy array for JAX)."""
    t = torch.from_numpy(x32).to(dtype)
    return t, _np(t)


NARROW = [torch.bfloat16, torch.float16]


def _equal(got, want):
    got = _np(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# fixedpoint_stencil
# ---------------------------------------------------------------------------

def _stencil_case(name):
    """(x_q padded int32, taps, halo, shift, qmin, qmax)."""
    rng = np.random.default_rng(7)
    if name == "sobel3x3":
        taps, w_beta = st_ops.quantize_weights(SOBEL, 1 / 12)
        lo, hi, shift, qb = 0, 256, w_beta - 4, (-(2 ** 12), 2 ** 12 - 1)
    elif name == "blur5x5":
        taps, w_beta = st_ops.quantize_weights(BLUR5, 1 / 256)
        lo, hi, shift, qb = 0, 1024, w_beta, (0, 1023)
    elif name == "horizontal":
        taps, w_beta = st_ops.quantize_weights([[1, 4, 6, 4, 1]], 1 / 16)
        lo, hi, shift, qb = 0, 256, w_beta, (0, 255)
    elif name == "saturating":
        taps, w_beta = st_ops.quantize_weights(SOBEL, 1.0)
        lo, hi, shift, qb = 0, 256, 0, (-8, 7)
    elif name == "negative_ties":
        # acc = 2a - b on [-50, 50], shift 2: every acc = 2 mod 4 is a tie,
        # and half-up sends -1.5 to -1, not -2
        taps = [(0, 0, 2), (0, 1, -1)]
        lo, hi, shift, qb = -50, 51, 2, (-(2 ** 15), 2 ** 15 - 1)
    elif name == "shift0":
        taps = [(-1, 0, 3), (0, 0, -5), (1, 1, 7)]
        lo, hi, shift, qb = -100, 100, 0, (-(2 ** 15), 2 ** 15 - 1)
    hy, hx = st_ops.tap_halo(taps)
    x = rng.integers(lo, hi, (16, 24)).astype(np.int32)
    return np.pad(x, ((hy, hy), (hx, hx)), mode="edge"), taps, (hy, hx), \
        shift, *qb


@pytest.mark.parametrize("name", ["sobel3x3", "blur5x5", "horizontal",
                                  "saturating", "negative_ties", "shift0"])
def test_fixedpoint_stencil_equals_the_pallas_kernel(name):
    xq, taps, halo, shift, qmin, qmax = _stencil_case(name)
    if name == "horizontal":
        assert halo[0] == 0
    want = rst.fixedpoint_stencil(jnp.asarray(xq), taps, halo, shift, qmin,
                                  qmax, tile_h=8, interpret=True)
    got = st.fixedpoint_stencil(torch.from_numpy(xq), taps, halo, shift,
                                qmin, qmax)
    _equal(got, want)
    if name == "saturating":
        assert got.min() == qmin and got.max() == qmax
    if name == "negative_ties":
        acc = 2 * xq[:, :-2].astype(np.int64) - xq[:, 1:-1]
        assert ((acc < 0) & (acc % 4 == 2)).any()


# ---------------------------------------------------------------------------
# stencil_fixed
# ---------------------------------------------------------------------------

STENCIL_FRONT = {
    # benchmarks/run.py:44-46: Sobel / 12 (lossy w_beta = 12), u8.0 -> s9.4
    "sobel_bench": (SOBEL, 1 / 12, (8, 0, False), (9, 4, True), "int"),
    "dyadic_blur": (BLUR5, 1 / 256, (8, 2, False), (9, 3, True), "int"),
    "random_f32": (SOBEL, 1 / 8, (8, 3, False), (10, 2, True), "float"),
}


@pytest.mark.parametrize("name", sorted(STENCIL_FRONT))
def test_stencil_fixed_equals_the_reference(name):
    weights, scale, tin, tout, kind = STENCIL_FRONT[name]
    rng = np.random.default_rng(11)
    if kind == "int":
        img = rng.integers(0, 256, (64, 64)).astype(np.float32)
    else:
        img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    want = rst_ops.stencil_fixed(jnp.asarray(img), weights, scale,
                                 RefType(*tin), RefType(*tout))
    got = st_ops.stencil_fixed(img, weights, scale, FixedPointType(*tin),
                               FixedPointType(*tout), device="cpu")
    _equal(got, want)


def test_stencil_fixed_width_budget_raises():
    img = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="int32"):
        rst_ops.stencil_fixed(jnp.asarray(img), SOBEL, 1 / 12,
                              RefType(16, 12), RefType(9, 4))
    with pytest.raises(ValueError, match="int32"):
        st_ops.stencil_fixed(img, SOBEL, 1 / 12, FixedPointType(16, 12),
                             FixedPointType(9, 4), device="cpu")


def _image(dtype: str, rng) -> np.ndarray:
    """A 24x40 image of `dtype` whose values reach the wrap, overflow
    and rounding cases of `quantize_image` at beta_in 2."""
    shape = (24, 40)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("float16", "bfloat16", "float32", "float64"):
        x = rng.uniform(0, 255, shape)
        x[0, :4] = [60000.0, 4095.4, 1023.5, 2.5]     # f16 inf at 4x; ties
        return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -(2 ** 40)), min(info.max, 2 ** 40)
    x = rng.integers(lo, hi, shape, dtype=np.int64 if lo < 0 else np.uint64)
    x[1, :6] = [0, 1, 2, 63, 64, 255] if lo >= 0 or hi > 255 else 0
    return x.astype(dtype)


IMAGE_DTYPES = ["uint8", "int8", "int16", "uint16", "int32", "uint32",
                "int64", "bool", "float16", "bfloat16", "float32",
                "float64", "uint64"]


@pytest.mark.parametrize("beta", [0, 2])
@pytest.mark.parametrize("dtype", IMAGE_DTYPES)
def test_stencil_fixed_on_image_dtypes_equals_the_reference(dtype, beta):
    """Each image dtype is quantized as the reference's jit quantizes
    it: integers scaled and wrapped in their own dtype (a uint8 image
    times 4 keeps its low 8 bits), floats scaled, rounded and clipped in
    their own dtype against bounds rounded into it (f16(4095) = 4096),
    f64 taken as f32, the int32 cast saturating."""
    img = _image(dtype, np.random.default_rng(IMAGE_DTYPES.index(dtype)))
    tin = RefType(10, beta, False)
    tout = RefType(9, 4, True)
    want = rst_ops.stencil_fixed(jnp.asarray(img), SOBEL, 1 / 12, tin, tout)
    port_img = (torch.from_numpy(img.view(np.int16)).view(torch.bfloat16)
                if dtype == "bfloat16" else img)
    got = st_ops.stencil_fixed(port_img, SOBEL, 1 / 12,
                               FixedPointType(10, beta, False),
                               FixedPointType(9, 4, True), device="cpu")
    _equal(got, want)


def test_quantize_image_wraps_integers_and_rounds_bounds_as_the_reference():
    """The cases the dtype test relies on, stated outright."""
    tin = FixedPointType(10, 2, False)
    u8 = st_ops.quantize_image(np.array([[63, 64, 200]], np.uint8), tin,
                               device="cpu")
    assert u8.tolist() == [[252, 0, 32]]            # 4x, mod 256
    f16 = st_ops.quantize_image(np.array([[1023.75, 60000]], np.float16),
                                tin, device="cpu")
    assert f16.tolist() == [[4096, 4096]]           # f16(4095) = 4096; inf
    i64 = st_ops.quantize_image(np.array([[2 ** 40 + 5]]), tin,
                                device="cpu")
    assert i64.tolist() == [[20]]                   # int64 -> int32 first


def test_stencil_fixed_f16_image_past_its_range_equals_the_reference():
    """beta_in 16: 2^16 is inf in f16, so 0 * 2^16 is NaN (code 0) and
    every other pixel inf, clipped against an f16 bound that is inf too
    and saturated by the int32 cast."""
    img = np.array([[0, 1e-3, 1, 7]] * 4, np.float16)
    tin, tout = (2, 16, False), (9, 4, True)
    want = rst_ops.stencil_fixed(jnp.asarray(img), SOBEL, 1 / 12,
                                 RefType(*tin), RefType(*tout))
    got = st_ops.stencil_fixed(img, SOBEL, 1 / 12, FixedPointType(*tin),
                               FixedPointType(*tout), device="cpu")
    _equal(got, want)
    q = st_ops.quantize_image(img, FixedPointType(*tin), device="cpu")
    assert q[0].tolist() == [0] + [2 ** 31 - 1] * 3


def test_stencil_fixed_raises_on_images_it_cannot_match():
    with pytest.raises(TypeError, match="complex"):
        st_ops.stencil_fixed(np.ones((8, 8), np.complex64), SOBEL, 1 / 12,
                             FixedPointType(8, 0, False),
                             FixedPointType(9, 4), device="cpu")


# ---------------------------------------------------------------------------
# qmatmul
# ---------------------------------------------------------------------------

def _codes(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("M,K,N,blk", [(64, 96, 32, 32), (128, 128, 128, 128)])
def test_qmatmul_kernels_equal_the_pallas_kernels(M, K, N, blk):
    rng = np.random.default_rng(M + K + N)
    a, b = _codes(rng, M, K), _codes(rng, K, N)
    sa = rng.uniform(1e-3, 1, (M, 1)).astype(np.float32)
    sb = rng.uniform(1e-3, 1, (1, N)).astype(np.float32)
    blocks = dict(block_m=blk, block_n=blk, block_k=blk, interpret=True)
    _equal(qmm.qmatmul_i32(torch.from_numpy(a), torch.from_numpy(b)),
           rqmm.qmatmul_i32(jnp.asarray(a), jnp.asarray(b), **blocks))
    _equal(qmm.qmatmul_dequant(*map(torch.from_numpy, (a, b, sa, sb))),
           rqmm.qmatmul_dequant(*map(jnp.asarray, (a, b, sa, sb)), **blocks))


@pytest.mark.parametrize("K,N", [(70, 53), (64, 8), (1, 3), (0, 4)])
def test_pack_b_plain_version_is_the_zero_padded_transpose(K, N):
    """The plain version of the CUDA kernels' pack pre-pass: bT (N, K16)
    = b.T with K rounded up to 16 and zero-filled; the card test holds
    the pre-pass equal to it."""
    b = _codes(np.random.default_rng(K + N), K, N)
    want = np.zeros((N, -(-K // 16) * 16), np.int8)
    want[:, :K] = b.T
    _equal(qmm.pack_b(torch.from_numpy(b)), want)


@pytest.mark.parametrize("M,K,N", [(37, 70, 53), (5, 300, 7), (130, 64, 129)])
def test_matmul_quantized_equals_the_reference(M, K, N):
    rng = np.random.default_rng(3 * M + K)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) * 10).astype(np.float32)
    a[1] = 0.0                                    # a zero row: scale 1
    want = rqmm_ops.matmul_quantized(jnp.asarray(a), jnp.asarray(b))
    _equal(qmm_ops.matmul_quantized(a, b, device="cpu"), want)


@pytest.mark.parametrize("M,K,N", [(64, 96, 32), (37, 70, 53)])
@pytest.mark.parametrize("dtype", NARROW, ids=str)
def test_matmul_quantized_narrow_equals_the_reference(dtype, M, K, N):
    """bf16 and f16 operands are quantized in their own dtype: absmax,
    the scale rule of that dtype, ``a / s`` rounded to it, rint."""
    rng = np.random.default_rng(0)
    a, a_np = _narrow(rng.normal(size=(M, K)).astype(np.float32), dtype)
    b, b_np = _narrow(rng.normal(size=(K, N)).astype(np.float32), dtype)
    want = rqmm_ops.matmul_quantized(jnp.asarray(a_np), jnp.asarray(b_np),
                                     block=32)
    got = qmm_ops.matmul_quantized(a, b, device="cpu")
    _equal(got, want)
    # the f32 route (upcast first) is not the reference's
    up = qmm_ops.matmul_quantized(a.float(), b.float(), device="cpu")
    assert not torch.equal(up, got)


def _helper_input(dtype):
    """Queue 3's 2000x64 normal rows, in `dtype`."""
    x = np.random.default_rng(0).normal(size=(2000, 64)).astype(np.float32)
    return _narrow(x, dtype)


HELPERS = {
    "absmax_scale_rows": (functools.partial(qmm_ops.absmax_scale, axis=1),
                          functools.partial(rqmm_ops.absmax_scale, axis=1)),
    "absmax_scale_cols": (functools.partial(qmm_ops.absmax_scale, axis=0),
                          functools.partial(rqmm_ops.absmax_scale, axis=0)),
    "quantize_rows": (qmm_ops.quantize_rows, rqmm_ops.quantize_rows),
    "quantize_cols": (qmm_ops.quantize_cols, rqmm_ops.quantize_cols),
}


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW, ids=str)
@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_quantize_helpers_follow_the_jitted_reference(helper, dtype):
    """`absmax_scale`, `quantize_rows` and `quantize_cols` called alone
    equal the reference's same helpers under `jax.jit` (XLA's compiled
    scale rule), not an eager call of them."""
    port, ref = HELPERS[helper]
    x, x_np = _helper_input(dtype)
    want = jax.jit(ref)(jnp.asarray(x_np))
    got = port(x)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        _equal(g, w)


# ---------------------------------------------------------------------------
# qdq
# ---------------------------------------------------------------------------

def _qdq_rows(name):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(24, 64))
         * rng.uniform(1e-3, 1e3, (24, 1))).astype(np.float32)
    if name == "zero_row":
        x[3] = 0.0
    elif name == "ties":
        # absmax 127 gives s = 1: the codes are rint(x), half to even
        x[2] = np.resize(np.float32([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                     -126.5]), 64)
    elif name == "nan_inf":
        x[4, 7], x[9, 0] = np.nan, np.inf
    elif name == "recip_scale":
        # absmax 9: 9 / 127 and 9 * f32(1 / 127) are an ulp apart, and the
        # Pallas kernel, compiled by XLA, computes the second
        x[6] = np.resize(np.float32([9, -3.25, 0.5]), 64)
    return x


@pytest.mark.parametrize("name", ["random", "zero_row", "ties", "nan_inf",
                                  "recip_scale"])
def test_block_kernels_equal_the_pallas_kernels(name):
    x = _qdq_rows(name)
    wq, ws = rqdq.block_quantize(jnp.asarray(x), interpret=True)
    q, s = qdq.block_quantize(torch.from_numpy(x))
    _equal(q, wq)
    _equal(s, ws)
    if name == "zero_row":
        assert s[3, 0] == 1.0 and not q[3].any()
    if name == "ties":
        assert s[2, 0] == 1.0
        assert q[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, -126]
    if name == "nan_inf":
        assert torch.isnan(s[4, 0]) and torch.isinf(s[9, 0])
    if name == "recip_scale":
        nine = np.float32(9)
        assert s[6, 0] == nine * (np.float32(1) / np.float32(127))
        assert s[6, 0] != nine / np.float32(127)
    _equal(qdq.block_dequantize(q, s),
           rqdq.block_dequantize(wq, ws, interpret=True))


def _probe_rows() -> np.ndarray:
    """4096 rows of 64 normals, each row scaled by uniform(0.01, 100):
    the scale rules of bf16 and f16 differ on dozens of these rows."""
    rng = np.random.default_rng(2)
    return (rng.normal(size=(4096, 64))
            * rng.uniform(0.01, 100, (4096, 1))).astype(np.float32)


def _other_rule(x_np: np.ndarray, dtype) -> np.ndarray:
    """The scale by the other dtype's rule: a product with the narrow
    1/127 for bf16, a true division for f16."""
    m = np.abs(x_np.astype(np.float32)).max(1, keepdims=True)
    if dtype == torch.bfloat16:
        s = (m * np.float32(ml_dtypes.bfloat16(1 / 127))).astype(
            ml_dtypes.bfloat16)
    else:
        s = (m / np.float32(127)).astype(np.float16)
    return s.astype(np.float32)


@pytest.mark.parametrize("case", ["probe", "zero_row", "nan_inf"])
@pytest.mark.parametrize("dtype", NARROW, ids=str)
def test_block_kernels_narrow_equal_the_pallas_kernels(dtype, case):
    x32 = _probe_rows()
    if case == "zero_row":
        x32 = x32[:64].copy()
        x32[3] = 0.0
    elif case == "nan_inf":
        x32 = x32[:64].copy()
        x32[4, 7], x32[9, 0] = np.nan, np.inf
    x, x_np = _narrow(x32, dtype)
    wq, ws = rqdq.block_quantize(jnp.asarray(x_np), interpret=True)
    q, s = qdq.block_quantize(x)
    _equal(q, wq)
    _equal(s, ws)
    if case == "probe":
        # the rule matters on this data: the other dtype's differs
        assert (_other_rule(x_np, dtype) != s.numpy()).sum() > 10
    if case == "zero_row":
        assert s[3, 0] == 1.0 and not q[3].any()
    if case == "nan_inf":
        assert torch.isnan(s[4, 0]) and torch.isinf(s[9, 0])
        assert not q[4].any() and not q[9].any()
    _equal(qdq.block_dequantize(q, s),
           rqdq.block_dequantize(wq, ws, interpret=True))


@pytest.mark.parametrize("shape,block", [((3, 100), 64), ((5, 300), 256)])
@pytest.mark.parametrize("dtype", NARROW, ids=str)
def test_fake_quant_compress_narrow_equal_the_reference(dtype, shape, block):
    """bf16 and f16: `fake_quant` returns x's dtype, `compress` quantizes
    in it, `decompress` returns f32; both lengths need padding."""
    x32 = (np.random.default_rng(block).normal(size=shape) * 30).astype(
        np.float32)
    x, x_np = _narrow(x32, dtype)
    got = qdq_ops.fake_quant(x, block_size=block, device="cpu")
    assert got.dtype == dtype and tuple(got.shape) == shape
    _equal(got, rqdq_ops.fake_quant(jnp.asarray(x_np), block_size=block))
    wq, ws, wpad = rqdq_ops.compress(jnp.asarray(x_np), block_size=block)
    q, s, pad = qdq_ops.compress(x, block_size=block, device="cpu")
    assert pad == wpad > 0
    _equal(q, wq)
    _equal(s, ws)
    _equal(qdq_ops.decompress(q, s, pad, shape, device="cpu"),
           rqdq_ops.decompress(wq, ws, wpad, shape))


@pytest.mark.parametrize("shape,block", [((3, 100), 64), ((2, 5, 7), 16),
                                         ((512,), 256)])
def test_fake_quant_equals_the_reference(shape, block):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    want = rqdq_ops.fake_quant(jnp.asarray(x), block_size=block)
    got = qdq_ops.fake_quant(x, block_size=block, device="cpu")
    assert tuple(got.shape) == shape
    _equal(got, want)


def test_compress_decompress_round_trip_equals_the_reference():
    x = np.random.default_rng(9).normal(size=(7, 33)).astype(np.float32)
    wq, ws, wpad = rqdq_ops.compress(jnp.asarray(x), block_size=32)
    q, s, pad = qdq_ops.compress(x, block_size=32, device="cpu")
    assert pad == wpad == 25
    _equal(q, wq)
    _equal(s, ws)
    _equal(qdq_ops.decompress(q, s, pad, x.shape, device="cpu"),
           rqdq_ops.decompress(wq, ws, wpad, x.shape))


# ---------------------------------------------------------------------------
# subnormals: XLA's compiled code on the CPU reads a subnormal f32 operand
# as zero and flushes a subnormal f32 result; the port flushes the same
# values one by one (f16 never holds an f32 subnormal)
# ---------------------------------------------------------------------------

DTYPES = [torch.float32] + NARROW
TINY = np.float32(np.finfo(np.float32).tiny)


def _tiny_rows() -> np.ndarray:
    """(9, 256) f32 rows: normals scaled by 1e-37, 1e-38 and 1e-39 (an
    f32 scale below FLT_MIN; all-subnormal rows); a normal row; a row of
    maximum 152 FLT_MIN, whose scale is about 1.2 FLT_MIN, holding
    subnormals of 0.9 FLT_MIN, which divide to about 0.75 unless read
    as 0; a normal row holding subnormals; a row of maximum 1e-36; a row
    scaled by 1e-5, whose f16 scale is f16-subnormal (7.9e-8); and a row
    of maximum 127 FLT_MIN, whose f32 scale is the least normal one."""
    rng = np.random.default_rng(19)
    x = rng.normal(size=(9, 256)).astype(np.float32)
    for r, k in enumerate((1e-37, 1e-38, 1e-39)):
        x[r] *= np.float32(k)
    x[4] = np.resize(np.float32([152, 0.9, -0.9, 0.5, -0.25]), 256) * TINY
    x[5, ::3] = np.float32(0.7) * TINY
    x[6] *= np.float32(1e-36) / np.abs(x[6]).max()
    x[7] *= np.float32(1e-5)
    x[8] = np.resize(np.float32([127, -3, 0.6, -0.6]), 256) * TINY
    return x


def _check_blocks(x: torch.Tensor, x_np) -> tuple:
    wq, ws = rqdq.block_quantize(jnp.asarray(x_np), interpret=True)
    q, s = qdq.block_quantize(x)
    _equal(q, wq)
    _equal(s, ws)
    _equal(qdq.block_dequantize(q, s),
           rqdq.block_dequantize(wq, ws, interpret=True))
    return q, s


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_block_kernels_flush_subnormals_as_the_pallas_kernels(dtype):
    """Rows at 1e-37, 1e-38 and 1e-39 get scale 1 and zero codes in f32
    and bf16, as in the Pallas kernel (an unflushed port gave scales of
    2.4e-39 to 3.1e-41 and codes up to 127); subnormals beside a tiny
    normal maximum quantize to 0; f16, which holds no f32 subnormal,
    keeps its f16-subnormal scale."""
    x, x_np = _narrow(_tiny_rows(), dtype)
    q, s = _check_blocks(x, x_np)
    if dtype != torch.float16:
        assert (s[:3] == 1.0).all() and not q[:3].any()
        assert (s[6] == 1.0).all() and not q[6].any()
        assert 0 < s[4, 0] < 2 * TINY and not q[4, 1:3].any()
    else:
        s7 = np.float32(s[7, 0])
        assert 0 < s7 < np.finfo(np.float16).tiny
    # the f32 scale of row 8 is the least normal one, and stays
    if dtype == torch.float32:
        assert s[8, 0] == TINY and q[8, :2].tolist() == [127, -3]


def test_bf16_scale_flushes_as_the_jitted_reference_on_every_maximum():
    """Every non-negative bf16 value but NaN (the NaN rows are above) as
    a row's maximum: the port's bf16 scale (the f32 quotient flushed,
    then rounded to bf16) equals the reference's jitted `absmax_scale`.
    At qmax = 127 flushing before or after the rounding gives the same
    scale on each of them."""
    x_np = np.zeros((0x7f81, 8), ml_dtypes.bfloat16)
    x_np[:, 0] = np.arange(0x7f81, dtype=np.uint16).view(ml_dtypes.bfloat16)
    x = torch.from_numpy(x_np.view(np.int16)).view(torch.bfloat16)
    want = jax.jit(functools.partial(rqmm_ops.absmax_scale, axis=1))(
        jnp.asarray(x_np))
    _equal(qmm_ops.absmax_scale(x, axis=1), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_block_dequantize_reads_a_subnormal_scale_as_zero(dtype):
    """Scales below FLT_MIN, as `decompress` may be handed them, read as
    a zero of their sign."""
    x, x_np = _narrow(_tiny_rows()[3:5], dtype)
    q, _ = qdq.block_quantize(x)
    s = np.float32([[1e-39], [-2e-38]])
    want = rqdq.block_dequantize(jnp.asarray(_np(q)), jnp.asarray(s),
                                 interpret=True)
    got = qdq.block_dequantize(q, torch.from_numpy(s))
    _equal(got, want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))
    _equal(qdq_ops.decompress(q, torch.from_numpy(s), 0, (512,),
                              device="cpu"),
           rqdq_ops.decompress(jnp.asarray(_np(q)), jnp.asarray(s), 0,
                               (512,)))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_front_ends_flush_subnormals_as_the_reference(dtype):
    """`fake_quant` (jitted), `compress` and `decompress` on the tiny
    rows, flat, in blocks of 256 and (padded) of 100."""
    x, x_np = _narrow(_tiny_rows().reshape(-1), dtype)
    for block in (256, 100):
        _equal(qdq_ops.fake_quant(x, block_size=block, device="cpu"),
               rqdq_ops.fake_quant(jnp.asarray(x_np), block_size=block))
        wq, ws, wpad = rqdq_ops.compress(jnp.asarray(x_np), block_size=block)
        q, s, pad = qdq_ops.compress(x, block_size=block, device="cpu")
        assert pad == wpad
        _equal(q, wq)
        _equal(s, ws)
        _equal(qdq_ops.decompress(q, s, pad, x.shape, device="cpu"),
               rqdq_ops.decompress(wq, ws, wpad, x.shape))


def _tiny_operands(dtype):
    """a (37, 70) with rows at 1e-37, 1e-38, 1e-39 and one of 0.9
    FLT_MIN subnormals beside a 152 FLT_MIN maximum; b (70, 53) with
    such columns."""
    rng = np.random.default_rng(23)
    a = rng.normal(size=(37, 70)).astype(np.float32)
    b = rng.normal(size=(70, 53)).astype(np.float32)
    for r, k in enumerate((1e-37, 1e-38, 1e-39)):
        a[r] *= np.float32(k)
        b[:, 2 * r] *= np.float32(k)
    a[5] = np.resize(np.float32([152, 0.9, -0.9]), 70) * TINY
    b[:, 7] = np.resize(np.float32([-152, 0.9, -0.9]), 70) * TINY
    return _narrow(a, dtype), _narrow(b, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_quantize_helpers_flush_subnormals_as_the_jitted_reference(dtype):
    """`quantize_rows` and `quantize_cols` (through `absmax_scale`) and
    `matmul_quantized` on operands with tiny rows and columns."""
    (a, a_np), (b, b_np) = _tiny_operands(dtype)
    for port, ref, v, v_np in ((qmm_ops.quantize_rows,
                                rqmm_ops.quantize_rows, a, a_np),
                               (qmm_ops.quantize_cols,
                                rqmm_ops.quantize_cols, b, b_np)):
        for g, w in zip(port(v), jax.jit(ref)(jnp.asarray(v_np))):
            _equal(g, w)
    _equal(qmm_ops.matmul_quantized(a, b, device="cpu"),
           rqmm_ops.matmul_quantized(jnp.asarray(a_np), jnp.asarray(b_np)))


@pytest.mark.parametrize("sa,sb", [(1e-20, 1e-19), (1e-39, 1e30),
                                   (1e30, -1e-39), (1e-30, 1e-9)])
def test_qmatmul_dequant_flushes_subnormal_products(sa, sb):
    """(f32(acc) * sa) * sb on 128^3 int8 codes: each product below
    FLT_MIN becomes 0 (the Pallas kernel gives 16,381 nonzero outputs
    at sa = 1e-20, sb = 1e-19, an unflushed epilogue 16,384), and a
    subnormal scale reads as 0."""
    rng = np.random.default_rng(128)
    a, b = _codes(rng, 128, 128), _codes(rng, 128, 128)
    sa = np.full((128, 1), sa, np.float32)
    sb = np.full((1, 128), sb, np.float32)
    want = rqmm.qmatmul_dequant(*map(jnp.asarray, (a, b, sa, sb)),
                                interpret=True)
    got = qmm.qmatmul_dequant(*map(torch.from_numpy, (a, b, sa, sb)))
    _equal(got, want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))
    assert not ((np.abs(got.numpy()) < TINY) & (got.numpy() != 0)).any()


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

FRONT_ENDS = {
    "stencil_fixed": lambda: st_ops.stencil_fixed(
        np.zeros((8, 8), np.float32), SOBEL, 1 / 12,
        FixedPointType(8, 0, False), FixedPointType(9, 4)),
    "matmul_quantized": lambda: qmm_ops.matmul_quantized(
        np.ones((4, 4), np.float32), np.ones((4, 4), np.float32)),
    "fake_quant": lambda: qdq_ops.fake_quant(np.ones(8, np.float32)),
    "compress": lambda: qdq_ops.compress(np.ones(8, np.float32)),
    "decompress": lambda: qdq_ops.decompress(
        np.zeros((1, 256), np.int8), np.ones((1, 1), np.float32), 248, (8,)),
}


@pytest.mark.parametrize("name", sorted(FRONT_ENDS))
def test_front_end_defaults_to_the_card_and_raises_without_one(name,
                                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FRONT_ENDS[name]()


def test_wrappers_on_cpu_tensors_launch_nothing():
    counters = (st.LAUNCHES, qmm.LAUNCHES, qdq.LAUNCHES)
    before = [dict(c) for c in counters]
    rng = np.random.default_rng(1)
    xq, taps, halo, shift, qmin, qmax = _stencil_case("sobel3x3")
    st.fixedpoint_stencil(torch.from_numpy(xq), taps, halo, shift, qmin, qmax)
    a, b = (torch.from_numpy(_codes(rng, 8, 8)) for _ in range(2))
    qmm.qmatmul_i32(a, b)
    qmm.qmatmul_dequant(a, b, torch.ones(8, 1), torch.ones(1, 8))
    q, s = qdq.block_quantize(torch.ones(4, 8))
    qdq.block_dequantize(q, s)
    assert [dict(c) for c in counters] == before
