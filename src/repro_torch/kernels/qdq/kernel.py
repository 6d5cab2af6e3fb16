"""Block quantize / dequantize: per-row absmax int8 codes and f32 scales.

Replaces the TPU kernels `repro/kernels/qdq/kernel.py:block_quantize`
and `block_dequantize` with one CUDA source, `csrc/qdq.cu`.
`block_quantize` takes f32, bf16 or f16 and computes in that dtype, as
the reference's compiled kernel does (`absmax_scale`, `quantize_codes`);
the scales come out f32 either way.  XLA runs its compiled code on the
CPU with subnormal f32 inputs read as zero and subnormal f32 results
flushed to zero; the port flushes the same values, one by one
(`flush_subnormal`), and sets no floating-point mode.  The plain
versions sit beside the wrappers: the wrappers run them for CPU tensors,
and on CUDA tensors launch the kernel or raise, counting launches in
`LAUNCHES`.  The reference's `rows_per_tile` has no meaning for the
CUDA kernels and is not carried over.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

# FLT_MIN: the least normal f32 (and bf16) magnitude, 2^-126;
# flush_subnormal: values below it made zeros of their sign, as XLA's
# compiled code on the CPU reads a subnormal f32 operand and writes a
# subnormal f32 result
from repro_torch.core.xla_f32 import FLT_MIN
from repro_torch.core.xla_f32 import ftz as flush_subnormal

LAUNCHES: Dict[str, int] = {"block_quantize": 0, "block_dequantize": 0}
_LAUNCH_LOCK = threading.Lock()
QMAX = 127


# the dtypes `block_quantize` takes, by the code its CUDA entry point takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def inv_qmax(qmax: int = QMAX) -> float:
    """f32(1 / qmax).  The reference writes the scale as ``max|x| /
    qmax``, but XLA compiles that division by a constant as a product
    with the f32-rounded reciprocal, in the Pallas kernel (interpret
    mode) and in every jitted caller alike; only an eager call of its
    `ref.py` divides.  The two differ by an ulp on some rows, and the
    port computes what the reference's kernel computes."""
    return float(np.float32(1) / np.float32(qmax))


def absmax_scale(x: torch.Tensor, dim: int, qmax: int = QMAX
                 ) -> torch.Tensor:
    """``max|x| / qmax`` along `dim` (kept), 1 where that is 0, in x's
    dtype, as XLA compiles the reference's ``jnp.max(jnp.abs(x)) /
    qmax`` for that dtype (the Pallas kernel and every jitted caller
    alike; an eager call may differ):

    * f32: a product with f32(1 / qmax) (`inv_qmax`);
    * bf16: a true division, f32(max) / qmax rounded to bf16;
    * f16: a product with f16(1 / qmax), rounded to f16.

    Each narrow operation is one f32 operation rounded to the narrow
    type, which is the correctly rounded narrow result (f32 carries more
    than twice the narrow significand and two bits).  The maximum
    propagates NaN, as `jnp.max` does.

    Subnormals, as XLA's compiled code on the CPU treats them: an f32 or
    bf16 input below `FLT_MIN` counts as 0 in the maximum, and an f32
    scale below it becomes 0, so 1.  For bf16 the f32 quotient is
    flushed before it is rounded to bf16, as the compiled code does (an
    f32 multiply, then a convert); at qmax = 127 no bf16 maximum tells
    that from flushing after the rounding (126.5 * FLT_MIN / 127 lies
    below the midpoint under FLT_MIN).  f16 flushes nothing: every f16
    value and every f16 scale is normal in f32, and the f32 -> f16
    rounding does not flush."""
    m = torch.amax(flush_subnormal(torch.abs(x)), dim=dim, keepdim=True)
    if x.dtype == torch.float32:
        s = flush_subnormal(m * inv_qmax(qmax))
    elif x.dtype == torch.bfloat16:
        # a tensor divisor: torch turns a division by a Python number on
        # the card into a product with its reciprocal
        s = flush_subnormal(m.float() / torch.full_like(
            m, qmax, dtype=torch.float32)).to(torch.bfloat16)
    elif x.dtype == torch.float16:
        s = (m.float() * float(np.float16(1 / qmax))).to(torch.float16)
    else:
        raise TypeError(f"absmax_scale: want float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    return torch.where(s == 0.0, torch.ones_like(s), s)


def int8_codes(v: torch.Tensor, qmax: int = QMAX) -> torch.Tensor:
    """``clip(rint(v), -qmax - 1, qmax)`` as int8; `torch.round` is half
    to even, as `jnp.rint`.  NaN (which the clip passes through) becomes
    0, as XLA's float-to-int conversion makes it."""
    r = torch.clamp(torch.round(v), -qmax - 1, qmax)
    return torch.where(torch.isnan(r), 0.0, r).to(torch.int8)


def quantize_codes(x: torch.Tensor, s: torch.Tensor, qmax: int = QMAX
                   ) -> torch.Tensor:
    """int8 codes of ``x / s`` in x's dtype: a true division (never a
    product with 1 / s), rounded to x's dtype before `rint` where that
    is bf16 or f16, as the reference's compiled kernel rounds it.  An
    f32 or bf16 x below `FLT_MIN` divides as 0, as in the compiled
    code; a subnormal quotient needs no flush, as it rounds to code 0
    either way."""
    x = flush_subnormal(x)
    q = x / s if x.dtype == torch.float32 else (x.float() / s.float()).to(
        x.dtype)
    return int8_codes(q, qmax)


def block_quantize_reference(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (NB, BS) f32, bf16 or f16 -> (codes int8 (NB,
    BS), scales f32 (NB, 1)); per row ``s = absmax_scale(x)`` and codes
    ``quantize_codes(x, s)``, in x's dtype."""
    s = absmax_scale(x, -1)
    return quantize_codes(x, s), s.to(torch.float32)


def block_dequantize_reference(q: torch.Tensor, s: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version: ``f32(q) * s`` per row, with a subnormal s read as
    0, as the reference's compiled code reads it; the product of a
    normal s and a nonzero code is normal, so it needs no flush."""
    return q.to(torch.float32) * flush_subnormal(s)


def _launch(name: str, operands, outs, *scalars) -> None:
    from repro_torch.kernels import _build
    NB, BS = operands[0].shape
    _build.launch("qdq", f"{name}_launch", (*operands, *outs), NB, BS,
                  *scalars)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def block_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (NB, BS) f32, bf16 or f16 -> (codes int8 (NB, BS), scales f32
    (NB, 1)).  On a CUDA tensor the kernel's instantiation for x's dtype
    runs."""
    if x.dtype not in DTYPES or x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"block_quantize: want f32, bf16 or f16 (NB, BS) "
                         f"with BS > 0, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return block_quantize_reference(x)
    NB, BS = x.shape
    q = torch.empty((NB, BS), dtype=torch.int8, device=x.device)
    s = torch.empty((NB, 1), dtype=torch.float32, device=x.device)
    _launch("block_quantize", (x,), (q, s), DTYPES[x.dtype])
    return q, s


def quotient_mismatches(dtype: torch.dtype, device) -> int:
    """On the card: how many (scale, element) pairs of bf16 or f16, of
    the rows whose codes `qdq.cu` computes from the scale's reciprocal
    (finite scales of at least 2 FLT_MIN, |x| <= 256 s), get another
    code than the exact path's (``__fdiv_rn``, rounding, ``rintf``).
    Every such pair is tried; 0 is the proof that the two agree."""
    from repro_torch.kernels import _build
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"quotient_mismatches: want bf16 or f16, got "
                         f"{dtype}")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _build.launch("qdq", "block_quantize_check", (bad,), DTYPES[dtype])
    return int(bad.item())


def block_dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """codes int8 (NB, BS), scales f32 (NB, 1) -> f32 (NB, BS)."""
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] == 0 \
            or s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0], 1):
        raise ValueError(f"block_dequantize: want int8 (NB, BS) with BS > 0 "
                         f"and f32 (NB, 1), got {q.dtype} {tuple(q.shape)}, "
                         f"{s.dtype} {tuple(s.shape)}")
    if q.device.type == "cpu":
        return block_dequantize_reference(q, s)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("block_dequantize", (q, s), (out,))
    return out
