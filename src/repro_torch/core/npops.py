"""numpy's elementwise rules on torch tensors.

The reference evaluates every expression with numpy on f64 arrays; three
of numpy's rules differ from torch's own operations:

  * **max / min** — `np.maximum(a, b)` propagates a NaN operand and, of
    two equal operands (+0 and -0), returns the second; `torch.maximum`
    returns the first.  `maximum`, `minimum`, `fmax` and `fmin` follow
    numpy on every device (so does `csrc/fused_band.cu`).
  * **sqrt** — `np.sqrt` is correctly rounded; torch's CPU `sqrt` is not
    (about 0.7% of uniform f64 inputs come out one ulp away).  `sqrt` of
    a CPU tensor takes numpy's; a CUDA tensor keeps the card's IEEE
    `sqrt`, which is correctly rounded.
  * **x ** n** — numpy's float power is the C library's `pow` (and a
    product only for n = 2), while torch computes small integer powers
    as products (``x * x * x`` for n = 3) and others with its own `pow`.
    `npow` and `power` of a CPU tensor take numpy's result; a CUDA tensor
    takes torch's `pow`, which is not numpy's (`PERF.md` names how often
    they differ on the card).  The band kernel encodes a power only where
    every order of products is exact (`kernels/stencil/kernel.py`).

The SMT engine (`smt/solver.py`), the whole-frame and per-stage executors
(`lowering/backends.py`) and the band kernel's plain version
(`kernels/stencil/kernel.py`) all call these.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fmax", "fmin", "maximum", "minimum", "npow", "power", "sqrt"]


def _isnan(x):
    return torch.isnan(x) if isinstance(x, torch.Tensor) else math.isnan(x)


def maximum(a, b):
    """`np.maximum` of a tensor `a` and a tensor or number `b`: a NaN
    operand propagates; of two equal operands (+0 and -0) the second."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def minimum(a, b):
    """`np.minimum`, with `maximum`'s rules."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def fmax(a, b):
    """`np.fmax`: a NaN operand is ignored; of two equal ones the second."""
    return torch.where((a > b) | _isnan(b), a, b)


def fmin(a, b):
    """`np.fmin`, with `fmax`'s rules."""
    return torch.where((a < b) | _isnan(b), a, b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root (numpy's `np.sqrt`, CUDA's `sqrt`)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def npow(x: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``x ** n`` for a Python integer n (``x * x`` for n = 2)."""
    n = int(n)
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(x.numpy() ** n))
    if n == 0:
        return torch.ones_like(x)
    if n == 1:
        return x
    if n == 2:
        return x * x
    return torch.pow(x, float(n))


def power(x: torch.Tensor, p: float) -> torch.Tensor:
    """numpy's ``x ** p`` for a float exponent p."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(x.numpy() ** float(p)))
    return torch.pow(x, float(p))
