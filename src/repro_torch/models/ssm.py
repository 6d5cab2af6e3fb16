"""Linear-recurrence token mixer: RWKV6 (Finch).

The port's own copy of `repro.models.ssm`, its RWKV6 half.  The Mamba2
SSD recurrence (`ssd_scan`, `ssd_chunked`) and `causal_conv1d` come
with the hybrid slice (ROADMAP Queue 1 item 5d).

The recurrence is implemented twice:
  * `wkv6_scan`    — per-token loop: the correctness oracle, and the
                     O(1)-state decode path.
  * `wkv6_chunked` — chunk-parallel form used for prefill: intra-chunk
                     work becomes dense (C x C) matmuls, states propagate
                     across chunks in a loop over T/C steps.  Every
                     per-chunk tensor (decays, scores) is made inside the
                     loop, so peak memory is O(B*H*C^2), not O(B*H*T*C).
                     Decay ratios are computed in log space, in f32.

RWKV6 recurrence (per head; K=V=head_dim):
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          w_t in (0,1)^K data-dependent
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pick_chunk(T: int, chunk: int) -> int:
    """Largest divisor of T that is <= requested chunk."""
    c = min(chunk, T)
    while T % c != 0:
        c -= 1
    return c


def _zero_state(r: torch.Tensor, V: int) -> torch.Tensor:
    B, _, H, K = r.shape
    return torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)


def wkv6_scan(r, k, v, w, u, s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive oracle / decode path.

    r,k,w: (B, T, H, K); v: (B, T, H, V); u: (H, K) f32; s0: (B, H, K, V)
    f32 or None (zeros).  Returns (out (B, T, H, V) f32, sT f32).
    """
    s = _zero_state(r, v.shape[-1]) if s0 is None else s0
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uu * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_chunked(r, k, v, w, u, s0: Optional[torch.Tensor] = None,
                 chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6 (log-space decays).  Same signature as
    `wkv6_scan`.  r/k/v stay in their input dtype and are cast to f32 a
    chunk at a time; w is cast to f32 first (its log and cumsum chain
    wants the precision)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = _pick_chunk(T, chunk)
    s = _zero_state(r, V) if s0 is None else s0

    def to_chunks(x):          # (NC, B, H, C, dim): a view, no compute
        return x.reshape(B, T // C, C, H, -1).permute(1, 0, 3, 2, 4)
    rc, kc, vc = map(to_chunks, (r, k, v))
    wc = to_chunks(w.float())
    tri = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    ru = u[None, :, None, :]
    outs = []
    for r_c, k_c, v_c, w_c in zip(rc, kc, vc, wc):   # (B, H, C, K/V)
        r_c, k_c, v_c = r_c.float(), k_c.float(), v_c.float()
        logw = torch.log(torch.clamp(w_c, 1e-12, 1.0))
        logA = torch.cumsum(logw, dim=-2)            # A_t = prod_{s<=t} w_s
        logA_prev = logA - logw                      # A_{t-1}
        r_dec = r_c * torch.exp(logA_prev)           # r~_t = r_t A_{t-1}
        k_inc = k_c * torch.exp(-logA)               # k~_s = k_s / A_s
        logA_C = logA[..., -1:, :]
        k_end = k_c * torch.exp(logA_C - logA)       # k^_s = k_s A_C/A_s

        # intra-chunk: strictly-lower-triangular scores + u-weighted diagonal
        scores = torch.einsum("bhck,bhsk->bhcs", r_dec, k_inc)
        scores = torch.where(tri, scores, torch.zeros_like(scores))
        diag = torch.einsum("bhck,bhck->bhc", r_c * ru, k_c)
        intra = (torch.einsum("bhcs,bhsv->bhcv", scores, v_c)
                 + diag[..., None] * v_c)
        outs.append(intra + torch.einsum("bhck,bhkv->bhcv", r_dec, s))
        s = (torch.exp(logA_C[..., 0, :])[..., None] * s
             + torch.einsum("bhsk,bhsv->bhkv", k_end, v_c))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return out, s
