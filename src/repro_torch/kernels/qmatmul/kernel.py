"""Exact int8 x int8 -> int32 matmul, plain and fused with dequantization.

Replaces the TPU kernels `repro/kernels/qmatmul/kernel.py:qmatmul_i32`
and `qmatmul_dequant` with one CUDA source, `csrc/qmatmul.cu` (s8
`wgmma` from a TMA/mbarrier ring of shared-memory stages, warp
specialised, on a persistent grid; ragged edges zero-filled by TMA and
masked on store, so no block padding).  The s8 `wgmma` reads b K-major,
so a pre-pass packs b (K, N) into bT (N, K16), K rounded up to 16 and
zero-filled, and copies a to an (M, K16) scratch where TMA cannot read
it in place; the wrappers allocate that scratch.  The plain versions
sit beside the wrappers: the wrappers run them for CPU tensors, and on
CUDA tensors launch the kernel or raise, counting launches in
`LAUNCHES`.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from repro_torch.kernels.qdq.kernel import flush_subnormal

LAUNCHES: Dict[str, int] = {"qmatmul_i32": 0, "qmatmul_dequant": 0}
_LAUNCH_LOCK = threading.Lock()


def qmatmul_i32_reference(a_q: torch.Tensor, b_q: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    CUDA has no integer GEMM in torch, so the product is an f64 matmul
    of the int8 values, exact in any summation order while |acc| <
    2^53, then cast to int32.  |acc| <= 2^14 K stays below 2^31 while
    K < 131072; only above that would the reference and the kernel wrap
    in int32 where this cast does not, and no caller goes there."""
    return torch.matmul(a_q.to(torch.float64),
                        b_q.to(torch.float64)).to(torch.int32)


def qmatmul_dequant_reference(a_q: torch.Tensor, b_q: torch.Tensor,
                              a_scale: torch.Tensor, b_scale: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of the fused epilogue: ``(f32(acc) * sa) * sb``, in
    the reference's order; a_scale (M, 1), b_scale (1, N) f32.  As the
    reference's compiled code on the CPU, a subnormal scale reads as 0
    and each subnormal product becomes 0 (`qdq.kernel.flush_subnormal`)."""
    acc = qmatmul_i32_reference(a_q, b_q).to(torch.float32)
    return flush_subnormal(flush_subnormal(acc * flush_subnormal(a_scale))
                           * flush_subnormal(b_scale))


def _check(name: str, a_q: torch.Tensor, b_q: torch.Tensor,
           *scales: torch.Tensor) -> None:
    ok = (a_q.dtype == b_q.dtype == torch.int8 and a_q.dim() == b_q.dim() == 2
          and a_q.shape[1] == b_q.shape[0])
    if ok and scales:
        sa, sb = scales
        ok = (sa.dtype == sb.dtype == torch.float32
              and tuple(sa.shape) == (a_q.shape[0], 1)
              and tuple(sb.shape) == (1, b_q.shape[1]))
    if not ok:
        got = ", ".join(f"{t.dtype} {tuple(t.shape)}"
                        for t in (a_q, b_q, *scales))
        raise ValueError(f"{name}: want int8 (M, K) and (K, N)"
                         + (", f32 (M, 1) and (1, N)" if scales else "")
                         + f"; got {got}")


def _k16(K: int) -> int:
    """K rounded up to 16: the packed operands' row length in bytes."""
    return -(-K // 16) * 16


def pack_b_reference(b_q: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack pre-pass: (K, N) -> bT (N, K16), the
    transpose zero-padded along K."""
    K, N = b_q.shape
    bt = torch.zeros((N, _k16(K)), dtype=torch.int8, device=b_q.device)
    bt[:, :K] = b_q.t()
    return bt


def pack_b(b_q: torch.Tensor) -> torch.Tensor:
    """The pack pre-pass alone, as the kernels run it before the product:
    bT (N, K16) from int8 (K, N).  CPU tensors run the plain version."""
    if b_q.dtype != torch.int8 or b_q.dim() != 2:
        raise ValueError(f"pack_b: want int8 (K, N); got {b_q.dtype} "
                         f"{tuple(b_q.shape)}")
    if b_q.device.type == "cpu":
        return pack_b_reference(b_q)
    from repro_torch.kernels import _build
    K, N = b_q.shape
    bt = torch.empty((N, _k16(K)), dtype=torch.int8, device=b_q.device)
    _build.launch("qmatmul", "qmatmul_pack_b_launch", (b_q, bt), K, N)
    return bt


def gemm_config() -> Dict[str, int]:
    """The compiled GEMM's configuration on the current card: tile
    (BM, BN, BK bytes of K), ring stages, threads, dynamic shared bytes a
    block, registers and local bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build
    info = (ctypes.c_int * 8)()
    rc = _build.load("qmatmul").qmatmul_config(info)
    if rc != 0:
        raise RuntimeError(f"qmatmul_config failed: CUDA error {rc}")
    keys = ("BM", "BN", "BK", "stages", "threads", "smem_bytes",
            "registers", "local_bytes")
    return dict(zip(keys, info))


def _launch(name: str, out_dtype: torch.dtype, a_q: torch.Tensor,
            b_q: torch.Tensor, *scales: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import _build
    (M, K), N = a_q.shape, b_q.shape[1]
    dev = a_q.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    # the GEMM's scratch: bT always, a padded copy where TMA cannot read
    # a in place (16-byte base and row stride)
    bt = torch.empty((N, _k16(K)), dtype=torch.int8, device=dev)
    a_pad = (torch.empty((M, _k16(K)), dtype=torch.int8, device=dev)
             if K % 16 or a_q.data_ptr() % 16 else None)
    _build.launch("qmatmul", f"{name}_launch",
                  (a_q, b_q, a_pad, bt, *scales, out), M, N, K)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    return out


def qmatmul_i32(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.  CPU tensors
    run the plain version; CUDA tensors launch `csrc/qmatmul.cu`."""
    _check("qmatmul_i32", a_q, b_q)
    if a_q.device.type == "cpu":
        return qmatmul_i32_reference(a_q, b_q)
    return _launch("qmatmul_i32", torch.int32, a_q, b_q)


def qmatmul_dequant(a_q: torch.Tensor, b_q: torch.Tensor,
                    a_scale: torch.Tensor, b_scale: torch.Tensor
                    ) -> torch.Tensor:
    """Fused int8 matmul + dequant: f32 (M, N) = (acc * sa) * sb, with
    a_scale (M, 1) per row and b_scale (1, N) per column."""
    _check("qmatmul_dequant", a_q, b_q, a_scale, b_scale)
    if a_q.device.type == "cpu":
        return qmatmul_dequant_reference(a_q, b_q, a_scale, b_scale)
    return _launch("qmatmul_dequant", torch.float32, a_q, b_q, a_scale,
                   b_scale)
