"""Public wrapper: image -> fixed-point stencil -> float image.

The port's copy of `repro/kernels/stencil/ops.py`: weight quantization
(exact where the weights are dyadic, else rounded at the beta cap),
input/output (alpha, beta) scaling, per-axis edge padding and the int32
width budget, around `kernel.fixedpoint_stencil`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.fixedpoint import FixedPointType
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stencil.kernel import fixedpoint_stencil
from repro_torch.lowering.ir import dyadic_weights


def quantize_weights(weights: Sequence[Sequence[float]], scale: float,
                     max_beta: int = 12):
    """(taps, w_beta): smallest w_beta that represents scale*weights exactly,
    else max_beta.  Returns taps [(dy, dx, w_q)] centered on the kernel."""
    rows = len(weights)
    cols = max(len(r) for r in weights)
    cy, cx = rows // 2, cols // 2
    vals = [scale * w for r in weights for w in r]
    exact = dyadic_weights(vals, max_beta=max_beta)
    w_beta = exact[1] if exact is not None else max_beta
    taps = []
    for r, row in enumerate(weights):
        for c, w in enumerate(row):
            # Python's round on a Python float: half to even, as the
            # reference
            wq = int(round(scale * w * (1 << w_beta)))
            if wq != 0:
                taps.append((r - cy, c - cx, wq))
    return taps, w_beta


def tap_halo(taps) -> tuple:
    """Per-axis (hy, hx) halo of a tap list."""
    if not taps:
        return (0, 0)
    return (max(abs(dy) for dy, _, _ in taps),
            max(abs(dx) for _, dx, _ in taps))


def check_width_budget(t_in: FixedPointType, taps, w_beta: int) -> None:
    """Exactness requires the accumulator to fit int32."""
    wsum = sum(abs(w) for _, _, w in taps)
    max_abs = max(abs(t_in.int_min), t_in.int_max) * wsum
    if max_abs >= 2 ** 31:
        raise ValueError(
            f"stencil accumulator needs "
            f"{math.ceil(math.log2(max_abs)) + 1} bits > int32; reduce "
            f"beta_in ({t_in}) or w_beta ({w_beta})")


def _edge_pad(q: torch.Tensor, hy: int, hx: int) -> torch.Tensor:
    """Edge-replicate padding by clamped indexing (any dtype, any device)."""
    H, W = q.shape
    rows = torch.clamp(torch.arange(-hy, H + hy, device=q.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-hx, W + hx, device=q.device), 0, W - 1)
    return q.index_select(0, rows).index_select(1, cols)


# integer image dtypes: (bits, signed) of the dtype the reference's jit
# computes in without x64 (int64 and uint64 arrays become int32 and
# uint32 there, bool times a Python int becomes int32)
_INT_IMAGES = {torch.bool: (32, True), torch.uint8: (8, False),
               torch.int8: (8, True), torch.int16: (16, True),
               torch.uint16: (16, False), torch.int32: (32, True),
               torch.uint32: (32, False), torch.int64: (32, True),
               torch.uint64: (32, False)}
_FLOAT_IMAGES = (torch.float16, torch.bfloat16, torch.float32)


def _wrap(v: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """int64 `v` reduced to `bits` bits, two's complement if signed."""
    v = v & ((1 << bits) - 1)
    return v - ((v >> (bits - 1)) << bits) if signed else v


def quantize_image(img, t_in: FixedPointType,
                   device: DeviceLike = None) -> torch.Tensor:
    """``clip(rint(img * 2^beta_in), int_min, int_max)`` as int32, on
    `device` (default ``"cuda"``; it raises without a card), computed
    as the reference's jit computes it for the image's dtype:

    * an f64 image is taken as f32 (the reference runs without x64);
      f16, bf16 and f32 images are scaled, rounded (half to even) and
      clipped in their own dtype, against bounds rounded into it, so the
      product can overflow to inf and a bound can move (f16(4095) is
      4096);
    * an integer image is scaled in its own dtype and wraps there
      (``uint8 * 4`` keeps the low 8 bits), then `rint` takes it to f32
      (correctly rounded) and the clip runs in f32;
    * the cast to int32 saturates and sends NaN to 0, as XLA's does.

    Other dtypes raise `TypeError`."""
    x = torch.as_tensor(img, device=resolve_device(device))
    beta = t_in.beta
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    if x.dtype in _FLOAT_IMAGES:
        # 2^beta as the reference's weak-typed Python int, rounded into
        # x's dtype (inf in f16 from 2^16 on); the product of two values
        # of x's dtype, rounded to it
        v = torch.round(x * float(torch.tensor(float(1 << beta),
                                               dtype=x.dtype)))
    elif x.dtype in _INT_IMAGES:
        bits, signed = _INT_IMAGES[x.dtype]
        v = _wrap(x.to(torch.int64) * ((1 << beta) & ((1 << bits) - 1)),
                  bits, signed).to(torch.float32)
    else:
        raise TypeError(f"stencil_fixed: images of dtype {x.dtype} are not "
                        f"supported")
    lo, hi = (torch.tensor(b, dtype=v.dtype).item()
              for b in (t_in.int_min, t_in.int_max))
    v = torch.clamp(v, lo, hi)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return torch.clamp(v.to(torch.float64), -(1 << 31),
                       (1 << 31) - 1).to(torch.int32)


def stencil_operands(img, weights, scale: float, t_in: FixedPointType,
                     t_out: FixedPointType, device: DeviceLike = None):
    """The kernel's operands for `stencil_fixed`: ``(x_q, taps, (hy, hx),
    shift, qmin, qmax)``, with x_q the edge-padded int32 image
    (`quantize_image`) on `device` (default ``"cuda"``; it raises
    without a card)."""
    taps, w_beta = quantize_weights(weights, scale)
    check_width_budget(t_in, taps, w_beta)
    shift = t_in.beta + w_beta - t_out.beta
    if shift < 0:
        raise ValueError("negative shift: raise w_beta or lower beta_out")
    hy, hx = tap_halo(taps)
    q = quantize_image(img, t_in, device)
    return (_edge_pad(q, hy, hx), taps, (hy, hx), shift, t_out.int_min,
            t_out.int_max)


def stencil_fixed(img, weights, scale: float, t_in: FixedPointType,
                  t_out: FixedPointType,
                  device: DeviceLike = None) -> torch.Tensor:
    """(H, W) image -> fixed-point stencil -> f32 (H, W) on `device`
    (default ``"cuda"``; it raises without a card).  Float and integer
    images are quantized as the reference quantizes them
    (`quantize_image`); then the kernel on
    `stencil_operands`, then ``f32(out_q) * 2^-beta_out``."""
    out_q = fixedpoint_stencil(*stencil_operands(img, weights, scale, t_in,
                                                 t_out, device))
    return out_q.to(torch.float32) * (2.0 ** -t_out.beta)
