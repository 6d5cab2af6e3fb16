"""Quantized tensor container + per-tensor precision assignment.

The port's own copy of `repro.quant.qtypes`.  The LM realization of the
paper's (alpha, beta) stage types: each named tensor class gets a
*TensorPrecision* — either a float format or a fixed-point/integer
container with a static scale derived from range analysis + calibration,
mirroring how each pipeline stage's buffer is typed in the FPGA design.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointType, alpha_for_range
from repro_torch.core.interval import Interval
from repro_torch.core.policy import LegalizedType, legalize


@dataclasses.dataclass(frozen=True)
class TensorPrecision:
    """Precision assignment for one tensor class."""
    name: str
    range: Interval                   # analyzed/calibrated value range
    fp: Optional[FixedPointType]      # None = keep bf16/f32
    legal: LegalizedType              # container after legalization

    @property
    def container(self) -> str:
        return self.legal.container

    @property
    def bits(self) -> int:
        return self.legal.bits if self.fp is not None else 16

    @staticmethod
    def from_range(name: str, rng: Interval, beta: int) -> "TensorPrecision":
        alpha = max(alpha_for_range(rng.lo, rng.hi), 1)
        fp = FixedPointType(alpha=alpha, beta=beta, signed=rng.lo < 0)
        return TensorPrecision(name=name, range=rng, fp=fp, legal=legalize(fp))

    @staticmethod
    def float_ref(name: str, rng: Interval) -> "TensorPrecision":
        return TensorPrecision(name=name, range=rng, fp=None,
                               legal=legalize(None))


def quantize_symmetric(x: torch.Tensor, bits: int = 8, axis=None):
    """Symmetric absmax quantization -> (codes, scale).

    The scale is ``where(s == 0, 1, s) / qmax`` in x's dtype (a true
    division), the codes ``rint(x / s)`` half-even, clipped, in int8 (int16
    above 8 bits); the scale comes back in f32."""
    qmax = 2 ** (bits - 1) - 1
    a = x.abs()
    s = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s) / torch.full_like(s, qmax)
    dt = torch.int8 if bits <= 8 else torch.int16
    q = torch.round(x / s).clamp(-qmax - 1, qmax).to(dt)
    return q, s.float()


def dequantize_symmetric(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


class _FakeQuantSTE(torch.autograd.Function):
    """Quantize-dequantize forward, identity backward."""

    @staticmethod
    def forward(ctx, v, bits, axis):
        q, s = quantize_symmetric(v, bits, axis)
        return dequantize_symmetric(q, s).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None     # straight-through estimator


def fake_quant_ste(x: torch.Tensor, bits: int = 8, axis=None) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients (training path)."""
    return _FakeQuantSTE.apply(x, bits, axis)


def bytes_per_element(p: TensorPrecision) -> float:
    return p.legal.bytes if p.fp is not None else 2.0   # bf16 reference
