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
from repro_torch.kernels.qdq import kernel as qdq
from repro_torch.kernels.qmatmul.kernel import qmatmul_dequant


def absmax_scale(x: torch.Tensor, axis: int, qmax: int = 127
                 ) -> torch.Tensor:
    """``max|x| / qmax`` along `axis` (kept), 1 where it is 0, in x's
    dtype (f32, bf16 or f16).  It follows the reference's jitted
    `absmax_scale`, which XLA compiles per dtype (`qdq.kernel.
    absmax_scale`), not an eager call of it."""
    return qdq.absmax_scale(x, axis, qmax)


def quantize_rows(a: torch.Tensor, qmax: int = 127):
    """(int8 codes, f32 scales (M, 1)) of a (M, K), quantized in a's
    dtype; follows the reference's jitted `quantize_rows`."""
    s = absmax_scale(a, axis=1, qmax=qmax)                    # (M, 1)
    return qdq.quantize_codes(a, s, qmax), s.to(torch.float32)


def quantize_cols(b: torch.Tensor, qmax: int = 127):
    """(int8 codes, f32 scales (1, N)) of b (K, N), quantized in b's
    dtype; follows the reference's jitted `quantize_cols`."""
    s = absmax_scale(b, axis=0, qmax=qmax)                    # (1, N)
    return qdq.quantize_codes(b, s, qmax), s.to(torch.float32)


def _operand(x, dev) -> torch.Tensor:
    """bf16 and f16 stay as they are; anything else is taken as f32,
    as the reference's jit takes an f64 array without x64."""
    x = torch.as_tensor(x, device=dev)
    return x if x.dtype in qdq.DTYPES else x.to(torch.float32)


def matmul_quantized(a, b, device: DeviceLike = None) -> torch.Tensor:
    """(M, K) @ (K, N) via per-channel int8 quantization -> f32, on
    `device` (default ``"cuda"``; it raises without a card).  Each
    operand is quantized in its own dtype (f32, bf16 or f16), as the
    reference does; only the scales become f32."""
    dev = resolve_device(device)
    a_q, sa = quantize_rows(_operand(a, dev))
    b_q, sb = quantize_cols(_operand(b, dev))
    return qmatmul_dequant(a_q, b_q, sa, sb)
