"""The batched SMT engine's op-table walks on the card: one CUDA kernel
launch a call (`csrc/smt_walk.cu`).

`hc4_walk` is `solver._hc4_rows` and `grad_walk` is
`solver._gradients_rows` for a frontier on the card; those functions
call them for CUDA tensors and run their plain bodies for CPU tensors.
Each gives the plain version's bits on every row, dead rows and the
sign of every zero included (the comment that opens the source says
how).  Launches are counted in `LAUNCHES`.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.smt.encoder import DeviceProgram

LAUNCHES: Dict[str, int] = {"smt_hc4": 0, "smt_grad": 0}
_LAUNCH_LOCK = threading.Lock()


def _check_frontier(fn: str, lo: torch.Tensor, hi: torch.Tensor) -> None:
    if lo.device.type != "cuda":
        raise RuntimeError(f"{fn}: the walk kernels take CUDA tensors, "
                           f"got {lo.device}")
    if (lo.dtype != torch.float64 or hi.dtype != torch.float64
            or lo.dim() != 2 or lo.shape != hi.shape):
        raise ValueError(f"{fn}: want lo, hi (N, nvars) float64, got "
                         f"{lo.dtype} {tuple(lo.shape)} and {hi.dtype} "
                         f"{tuple(hi.shape)}")


def _table(dp: DeviceProgram):
    return (dp.def_var, dp.opcode, dp.argv, dp.argc, dp.pow_n, dp.cmp)


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def hc4_walk(dp: DeviceProgram, lo: torch.Tensor, hi: torch.Tensor,
             alive: torch.Tensor, rounds: int,
             stats: Optional[dict] = None) -> torch.Tensor:
    """hc4 over the frontier (lo, hi) on the card, in place; returns the
    new alive mask (`alive` is left as it was).  Where `stats` is given,
    ``stats["rounds"]`` and ``stats["passes"]`` become 0-dim tensors on
    the card holding the rounds the call ran and its passes (the first
    and its replays of `_b_mul`'s NaN check), for measurements."""
    from repro_torch.kernels import _build
    _check_frontier("hc4_walk", lo, hi)
    N, nvars = lo.shape
    if alive.dtype != torch.bool or alive.shape != (N,):
        raise ValueError(f"hc4_walk: want alive ({N},) bool, got "
                         f"{alive.dtype} {tuple(alive.shape)}")
    out = torch.empty_like(alive)
    if N == 0:
        return out
    nd = int(dp.def_var.shape[0])
    n_ints = _build.load("smt_walk").smt_hc4_scratch_ints(nd, int(rounds))
    back = torch.empty((2, N, nvars), dtype=torch.float64, device=lo.device)
    scratch = torch.empty(n_ints, dtype=torch.int32, device=lo.device)
    _build.launch("smt_walk", "smt_hc4_launch",
                  (lo, hi, alive, out, back[0], back[1], scratch,
                   *_table(dp)), N, nvars, nd, int(rounds))
    _count("smt_hc4")
    if stats is not None:
        stats.update(rounds=scratch[1], passes=scratch[2])
    return out


def grad_walk(dp: DeviceProgram, lo: torch.Tensor, hi: torch.Tensor,
              root: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(glo, ghi), each (N, nvars) f64 on the card: the interval gradient
    of variable `root` over each box."""
    from repro_torch.kernels import _build
    _check_frontier("grad_walk", lo, hi)
    N, nvars = lo.shape
    glo = torch.empty_like(lo)
    ghi = torch.empty_like(hi)
    if N == 0:
        return glo, ghi
    _build.launch("smt_walk", "smt_grad_launch",
                  (lo, hi, glo, ghi, *_table(dp)), N, nvars,
                  int(dp.def_var.shape[0]), int(root))
    _count("smt_grad")
    return glo, ghi
