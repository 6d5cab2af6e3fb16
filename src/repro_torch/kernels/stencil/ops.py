"""Public wrapper: float image -> fixed-point stencil -> float image.

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


def stencil_operands(img, weights, scale: float, t_in: FixedPointType,
                     t_out: FixedPointType, device: DeviceLike = None):
    """The kernel's operands for `stencil_fixed`: ``(x_q, taps, (hy, hx),
    shift, qmin, qmax)``, with x_q the edge-padded int32 image on
    `device` (default ``"cuda"``; it raises without a card).

    The reference's jitted function computes in f32, JAX's default, and
    so does this one: the image is taken as f32 and quantized in f32,
    ``clip(rint(img * 2^beta_in))`` with `torch.round` half to even."""
    taps, w_beta = quantize_weights(weights, scale)
    check_width_budget(t_in, taps, w_beta)
    shift = t_in.beta + w_beta - t_out.beta
    if shift < 0:
        raise ValueError("negative shift: raise w_beta or lower beta_out")
    hy, hx = tap_halo(taps)
    x = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    q = torch.clamp(torch.round(x * (1 << t_in.beta)), t_in.int_min,
                    t_in.int_max).to(torch.int32)
    return (_edge_pad(q, hy, hx), taps, (hy, hx), shift, t_out.int_min,
            t_out.int_max)


def stencil_fixed(img, weights, scale: float, t_in: FixedPointType,
                  t_out: FixedPointType,
                  device: DeviceLike = None) -> torch.Tensor:
    """Float (H, W) image -> fixed-point stencil -> f32 (H, W) on `device`
    (default ``"cuda"``; it raises without a card): the kernel on
    `stencil_operands`, then ``f32(out_q) * 2^-beta_out``."""
    out_q = fixedpoint_stencil(*stencil_operands(img, weights, scale, t_in,
                                                 t_out, device))
    return out_q.to(torch.float32) * (2.0 ** -t_out.beta)
