"""Public quantized-matmul API: f32 in, int8 internally, f32 out.

The port's copy of `repro/kernels/qmatmul/ops.py`: `matmul_quantized(a,
b)` = rowwise-absmax-quantize(a) @ colwise(b), the symmetric per-channel
scheme.  The quantizers stay torch ops, as they stay `jnp` outside
Pallas in the reference; the product is `kernel.qmatmul_dequant`, which
masks ragged edges itself, so nothing is padded to a block.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.qdq.kernel import int8_codes, inv_qmax
from repro_torch.kernels.qmatmul.kernel import qmatmul_dequant


def absmax_scale(x: torch.Tensor, axis: int, qmax: int = 127
                 ) -> torch.Tensor:
    # amax propagates NaN, as jnp.max; the reference's `/ qmax` compiles
    # to a product with f32(1 / qmax) (see `qdq.kernel.inv_qmax`)
    s = torch.amax(torch.abs(x), dim=axis, keepdim=True) * inv_qmax(qmax)
    return torch.where(s == 0.0, 1.0, s)


def quantize_rows(a: torch.Tensor, qmax: int = 127):
    s = absmax_scale(a, axis=1, qmax=qmax)                    # (M, 1)
    return int8_codes(a / s, qmax), s.to(torch.float32)


def quantize_cols(b: torch.Tensor, qmax: int = 127):
    s = absmax_scale(b, axis=0, qmax=qmax)                    # (1, N)
    return int8_codes(b / s, qmax), s.to(torch.float32)


def matmul_quantized(a, b, device: DeviceLike = None) -> torch.Tensor:
    """f32 (M, K) @ (K, N) via per-channel int8 quantization, on `device`
    (default ``"cuda"``; it raises without a card).  Inputs are taken as
    f32, the reference's default."""
    dev = resolve_device(device)
    a = torch.as_tensor(a, device=dev).to(torch.float32)
    b = torch.as_tensor(b, device=dev).to(torch.float32)
    a_q, sa = quantize_rows(a)
    b_q, sb = quantize_cols(b)
    return qmatmul_dequant(a_q, b_q, sa, sb)
