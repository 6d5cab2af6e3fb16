"""XLA's f32 elementwise rules on torch tensors.

The reference's per-stage f32 walk (`repro.dsl.exec.run_fixed(...,
backend="jax")`) dispatches every op eagerly to XLA on the CPU, on f32
arrays.  Its rules, found by testing XLA:CPU, differ from torch's own
in four places:

  * **subnormals** — arithmetic and comparisons read a subnormal operand
    as a zero of its sign and write a subnormal result as a zero of its
    sign; data movement (pad, slices, select, abs) keeps a subnormal as
    it is.  `ftz` makes that zero, value by value; no floating-point
    mode is set.
  * **max / min** — a NaN operand propagates, and -0 < +0: max(-0, +0)
    is +0 and min(-0, +0) is -0 in either order (numpy returns its
    second operand).
  * **x ** n** — `lax.integer_pow`: products by repeated squaring
    (x**4 is (x*x)*(x*x), x**3 is x*(x*x)), each rounded; a negative n
    is 1 / x**|n|, and x**1 is x.  Neither numpy's `pow` nor torch's.
  * **numbers** — a Python number meets an f32 array rounded to f32 (a
    weak-typed scalar); numbers combine among themselves in Python's
    doubles first (`lowering.backends.eval_expr` keeps them Python
    numbers).

+, -, *, / (by a constant too: no reciprocal), sqrt and rint are
IEEE-rounded on both sides.  `F32` carries a tensor through
`eval_expr` with these rules and `F32XP` is its `xp` namespace; both
work on any device, so the card runs the same ops as the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import npops

__all__ = ["FLT_MIN", "F32", "F32XP", "ftz", "maximum", "minimum",
           "integer_pow"]

FLT_MIN = 2.0 ** -126


def ftz(t: torch.Tensor) -> torch.Tensor:
    """`t` with every value below `FLT_MIN` in magnitude made a zero of
    its sign, value by value (no floating-point mode is set).  f16 holds
    no value that is subnormal in f32, so it passes unchanged."""
    return torch.where(t.abs() < FLT_MIN, t * 0.0, t)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's max of two flushed f32 tensors: NaN propagates, -0 < +0."""
    eq = torch.where(torch.signbit(a), b, a)          # of equal operands
    out = torch.where(a > b, a, torch.where(b > a, b, eq))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b,
                                                      out))


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's min of two flushed f32 tensors: NaN propagates, -0 < +0."""
    eq = torch.where(torch.signbit(a), a, b)
    out = torch.where(a < b, a, torch.where(b < a, b, eq))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b,
                                                      out))


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """`lax.integer_pow(x, n)` of a flushed f32 tensor, each product
    flushed."""
    n = int(n)
    if n == 0:
        return torch.ones_like(x)
    y, acc = abs(n), None
    while y > 0:
        if y & 1:
            acc = x if acc is None else ftz(acc * x)
        y >>= 1
        if y > 0:
            x = ftz(x * x)
    return ftz(torch.div(torch.ones_like(acc), acc)) if n < 0 else acc


class F32:
    """An f32 tensor as `eval_expr` sees it under XLA's rules.  `clean`
    says it holds no subnormal (every arithmetic result, every
    constant), so it is not flushed again when read."""
    __slots__ = ("t", "clean")

    def __init__(self, t: torch.Tensor, clean: bool = True):
        self.t, self.clean = t, clean

    def read(self) -> torch.Tensor:
        """The tensor as an arithmetic op reads it."""
        return self.t if self.clean else ftz(self.t)

    def _o(self, o) -> torch.Tensor:
        return (o if isinstance(o, F32) else const(o, self.t.device)).read()

    def _op(self, fn, a, b) -> "F32":
        return F32(ftz(fn(a, b)))

    def __add__(self, o): return self._op(torch.add, self.read(), self._o(o))
    def __radd__(self, o): return self._op(torch.add, self._o(o), self.read())
    def __sub__(self, o): return self._op(torch.sub, self.read(), self._o(o))
    def __rsub__(self, o): return self._op(torch.sub, self._o(o), self.read())
    def __mul__(self, o): return self._op(torch.mul, self.read(), self._o(o))
    def __rmul__(self, o): return self._op(torch.mul, self._o(o), self.read())
    def __truediv__(self, o):
        return self._op(torch.div, self.read(), self._o(o))
    def __rtruediv__(self, o):
        return self._op(torch.div, self._o(o), self.read())
    # a reflected comparison (``2.0 < v``) arrives as ``v > 2.0``
    def __lt__(self, o): return F32(torch.lt(self.read(), self._o(o)))
    def __le__(self, o): return F32(torch.le(self.read(), self._o(o)))
    def __gt__(self, o): return F32(torch.gt(self.read(), self._o(o)))
    def __ge__(self, o): return F32(torch.ge(self.read(), self._o(o)))

    def __pow__(self, n):
        # x ** 1 is x itself, no product: a subnormal stays
        if int(n) == 1:
            return self
        return F32(integer_pow(self.read(), n))


def const(v, device) -> F32:
    """A Python number as XLA reads it beside an f32 array: rounded to
    f32, flushed."""
    return F32(ftz(torch.tensor(v, dtype=torch.float32, device=device)))


class F32XP:
    """The `xp` namespace (and `where`) `eval_expr` calls on `F32`s."""

    def __init__(self, device: torch.device):
        self.device = device

    def val(self, x) -> F32:
        return x if isinstance(x, F32) else const(x, self.device)

    def abs(self, x):
        x = self.val(x)
        return F32(torch.abs(x.t), x.clean)

    def sqrt(self, x):
        # numpy's f32 sqrt on the CPU (correctly rounded; torch's CPU
        # sqrt is not), the card's IEEE sqrt on CUDA
        return F32(npops.sqrt(self.val(x).read()))

    def minimum(self, a, b):
        return F32(minimum(self.val(a).read(), self.val(b).read()))

    def maximum(self, a, b):
        return F32(maximum(self.val(a).read(), self.val(b).read()))

    def where(self, c, a, b):
        cond = c.t if isinstance(c, F32) else torch.tensor(
            bool(c), device=self.device)
        if cond.dtype != torch.bool:
            cond = cond != 0
        a, b = self.val(a), self.val(b)
        return F32(torch.where(cond, a.t, b.t), a.clean and b.clean)
