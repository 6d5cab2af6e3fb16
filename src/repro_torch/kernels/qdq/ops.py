"""Public API: tensor-shaped fake-quant and flat compress/decompress.

The port's copy of `repro/kernels/qdq/ops.py`, over `kernel.
block_quantize` and `kernel.block_dequantize`.  The kernels compute in
f32, so these take f32 tensors (the reference's default dtype); others
raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.qdq.kernel import block_dequantize, block_quantize


def _to_blocks(x, block_size: int, device: DeviceLike):
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dtype != torch.float32:
        raise TypeError(f"qdq: the kernels take float32, got {x.dtype}")
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block_size
    return F.pad(flat, (0, pad)).reshape(-1, block_size), pad, x.shape


def _unpad(flat: torch.Tensor, pad: int, shape) -> torch.Tensor:
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def fake_quant(x, block_size: int = 256,
               device: DeviceLike = None) -> torch.Tensor:
    """Quantize-dequantize round trip preserving shape (STE forward), on
    `device` (default ``"cuda"``; it raises without a card).  The
    flattened tensor is zero-padded to whole blocks, then unpadded."""
    blocks, pad, shape = _to_blocks(x, block_size, device)
    q, s = block_quantize(blocks)
    return _unpad(block_dequantize(q, s).reshape(-1), pad, shape)


def compress(x, block_size: int = 256, device: DeviceLike = None):
    """-> (codes int8 (NB, block_size), scales f32 (NB, 1), pad): 4x
    fewer bytes on the wire."""
    blocks, pad, _ = _to_blocks(x, block_size, device)
    q, s = block_quantize(blocks)
    return q, s, pad


def decompress(q, s, pad: int, shape,
               device: DeviceLike = None) -> torch.Tensor:
    dev = resolve_device(device)
    out = block_dequantize(torch.as_tensor(q, device=dev),
                           torch.as_tensor(s, device=dev))
    return _unpad(out.reshape(-1), pad, shape)
