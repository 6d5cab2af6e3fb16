"""Block quantize / dequantize: per-row absmax int8 codes and f32 scales.

Replaces the TPU kernels `repro/kernels/qdq/kernel.py:block_quantize`
and `block_dequantize` with one CUDA source, `csrc/qdq.cu`.  The plain
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

LAUNCHES: Dict[str, int] = {"block_quantize": 0, "block_dequantize": 0}
_LAUNCH_LOCK = threading.Lock()
QMAX = 127


def inv_qmax(qmax: int = QMAX) -> float:
    """f32(1 / qmax).  The reference writes the scale as ``max|x| /
    qmax``, but XLA compiles that division by a constant as a product
    with the f32-rounded reciprocal, in the Pallas kernel (interpret
    mode) and in every jitted caller alike; only an eager call of its
    `ref.py` divides.  The two differ by an ulp on some rows, and the
    port computes what the reference's kernel computes."""
    return float(np.float32(1) / np.float32(qmax))


def int8_codes(v: torch.Tensor, qmax: int = QMAX) -> torch.Tensor:
    """``clip(rint(v), -qmax - 1, qmax)`` as int8; `torch.round` is half
    to even, as `jnp.rint`.  NaN (which the clip passes through) becomes
    0, as XLA's float-to-int conversion makes it."""
    r = torch.clamp(torch.round(v), -qmax - 1, qmax)
    return torch.where(torch.isnan(r), 0.0, r).to(torch.int8)


def block_quantize_reference(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (NB, BS) f32 -> (codes int8 (NB, BS), scales f32
    (NB, 1)); ``s = max|x| * f32(1/127)`` per row (NaN-propagating, 1
    where it is 0), codes ``clip(rint(x / s))`` by a true division."""
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True) * inv_qmax()
    s = torch.where(s == 0.0, 1.0, s)
    return int8_codes(x / s), s.to(torch.float32)


def block_dequantize_reference(q: torch.Tensor, s: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version: ``f32(q) * s`` per row."""
    return q.to(torch.float32) * s


def _launch(name: str, operands, outs) -> None:
    from repro_torch.kernels import _build
    NB, BS = operands[0].shape
    _build.launch("qdq", f"{name}_launch", (*operands, *outs), NB, BS)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def block_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (NB, BS) f32 -> (codes int8 (NB, BS), scales f32 (NB, 1))."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"block_quantize: want f32 (NB, BS) with BS > 0, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return block_quantize_reference(x)
    NB, BS = x.shape
    q = torch.empty((NB, BS), dtype=torch.int8, device=x.device)
    s = torch.empty((NB, 1), dtype=torch.float32, device=x.device)
    _launch("block_quantize", (x,), (q, s))
    return q, s


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
