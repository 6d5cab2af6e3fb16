"""Public API: tensor-shaped fake-quant and flat compress/decompress.

The port's copy of `repro/kernels/qdq/ops.py`, over `kernel.
block_quantize` and `kernel.block_dequantize`.  They take f32, bf16 or
f16 tensors and quantize in that dtype, as the reference does; other
dtypes raise `TypeError`.  Scales are f32; `fake_quant` returns x's
dtype and `decompress` f32, as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.qdq.kernel import (DTYPES, block_dequantize,
                                            block_quantize)


def _to_blocks(x, block_size: int, device: DeviceLike):
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dtype not in DTYPES:
        raise TypeError(f"qdq: the kernels take float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block_size
    return F.pad(flat, (0, pad)).reshape(-1, block_size), pad, x


def _unpad(flat: torch.Tensor, pad: int, shape) -> torch.Tensor:
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def fake_quant(x, block_size: int = 256,
               device: DeviceLike = None) -> torch.Tensor:
    """Quantize-dequantize round trip preserving shape and dtype (STE
    forward), on `device` (default ``"cuda"``; it raises without a
    card).  The flattened tensor is zero-padded to whole blocks, then
    unpadded; the f32 round trip is cast back to x's dtype."""
    blocks, pad, x = _to_blocks(x, block_size, device)
    q, s = block_quantize(blocks)
    return _unpad(block_dequantize(q, s).reshape(-1), pad, x.shape).to(
        x.dtype)


def compress(x, block_size: int = 256, device: DeviceLike = None):
    """-> (codes int8 (NB, block_size), scales f32 (NB, 1), pad): 4x
    fewer bytes on the wire than f32."""
    blocks, pad, _ = _to_blocks(x, block_size, device)
    q, s = block_quantize(blocks)
    return q, s, pad


def decompress(q, s, pad: int, shape,
               device: DeviceLike = None) -> torch.Tensor:
    """The f32 tensor of `shape` that `compress` encoded."""
    dev = resolve_device(device)
    out = block_dequantize(torch.as_tensor(q, device=dev),
                           torch.as_tensor(s, device=dev))
    return _unpad(out.reshape(-1), pad, shape)
