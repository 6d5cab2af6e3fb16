"""Mixture-of-Experts FFN: capacity-based top-k with scatter dispatch.

The port's own copy of `repro.models.moe`: Mixtral (8 routed, top-2) and
Qwen2-MoE (60 routed top-4 plus shared experts that see every token).

Dispatch scatters each (token, choice) into its expert's capacity
buffer and the combine gathers it back, so memory is O(T*E) for the
position cumsum plus O(E*C*D) for the buffers.  Tokens beyond an
expert's capacity are dropped (they contribute zero through the
residual).  Every shape is fixed by the config and the token count:
an overflowed choice lands on one extra buffer row an expert, held at
zero and discarded, so the step has no host sync and replays as a CUDA
graph (`launch.serve.GraphedDecodeStep`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.attention import _softmax_f32
from repro_torch.models.common import ModelConfig, ParamSpec, dense, silu_f32


def moe_param_specs(cfg: ModelConfig, stacked: int | None = None) -> Dict:
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    L = (stacked,) if stacked else ()
    Lx = ("layers",) if stacked else ()
    specs = {
        "router": ParamSpec(L + (D, E), Lx + ("embed", "experts")),
        "w_gate": ParamSpec(L + (E, D, F), Lx + ("experts", "embed", "expert_ff")),
        "w_up": ParamSpec(L + (E, D, F), Lx + ("experts", "embed", "expert_ff")),
        "w_down": ParamSpec(L + (E, F, D), Lx + ("experts", "expert_ff", "embed")),
    }
    if cfg.shared_expert_d_ff:
        Fs = cfg.shared_expert_d_ff
        specs.update({
            "shared_gate": ParamSpec(L + (D, Fs), Lx + ("embed", "mlp")),
            "shared_up": ParamSpec(L + (D, Fs), Lx + ("embed", "mlp")),
            "shared_down": ParamSpec(L + (Fs, D), Lx + ("mlp", "embed")),
            # qwen2-moe gates the shared expert per token
            "shared_gate_proj": ParamSpec(L + (D, 1), Lx + ("embed", None)),
        })
    return specs


def _constrain(x, spec_dims, cfg: ModelConfig):
    """The reference's sharding constraint; one card has no layout."""
    return x


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert for `tokens` tokens: the reference's rounding, from
    Python numbers on the host."""
    cap = max(int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts),
              8)
    return (cap + 255) // 256 * 256 if cap >= 256 else (cap + 7) // 8 * 8


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, D) -> (router probabilities (T, E) f32, the top-k's
    renormalized probabilities (T, k) f32, their experts (T, k) int64).

    A stable descending sort picks the top k: tied probabilities take the
    lowest expert first, as `jax.lax.top_k` does (`torch.topk` promises
    no order among ties)."""
    logits = dense(xt, router).float()
    probs = _softmax_f32(logits)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_p = top_p / (_sum_k(top_p) + 1e-9)[:, None]
    return probs, top_p, top_e


def _sum_k(a: torch.Tensor) -> torch.Tensor:
    """The sum over axis 1 (the k choices) in order, first to last."""
    out = a[:, 0]
    for i in range(1, a.shape[1]):
        out = out + a[:, i]
    return out


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) of bf16 operands summed in f32, an f32
    result: `common.matmul_f32`'s rule, batched over experts."""
    b = b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _positions(top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, choice)'s slot in its expert's buffer: the count of
    earlier assignments to the same expert, in (token, choice) order (an
    exclusive int32 cumsum over the flattened (T*k, E) one-hot)."""
    experts = torch.arange(E, device=top_e.device)
    assign = (top_e.reshape(-1, 1) == experts).to(torch.int32)
    pos_flat = torch.cumsum(assign, dim=0, dtype=torch.int32) - assign
    return (pos_flat * assign).sum(-1, dtype=torch.int32)


def moe_ffn(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) bf16 -> (B, S, D) bf16."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    cap = capacity(cfg, T)

    xt = _constrain(x.reshape(T, D), ("cap", None), cfg)
    _, top_p, top_e = route(xt, p["router"], cfg)

    # scatter tokens into (E, cap + 1, D); a choice past its expert's
    # capacity lands on row `cap`, which is zeroed before the experts run
    # and never read back as a token's output
    flat_e = top_e.reshape(-1)
    slot = _positions(top_e, E).clamp_(max=cap).long()
    xe = torch.zeros((E, cap + 1, D), dtype=x.dtype, device=x.device)
    xe[flat_e, slot] = xt[:, None].expand(T, k, D).reshape(T * k, D)
    xe[:, cap] = 0

    # the expert FFN on bf16 operands, f32 sums; the zero row stays zero.
    # The reference's compiled code feeds silu the gate's unrounded f32
    # sums (its bf16 rounding and the f32 conversion fold away) and rounds
    # the up and down products to bf16
    g = _bmm_f32(xe, p["w_gate"])
    u = _bmm_f32(xe, p["w_up"]).to(x.dtype)
    h = silu_f32(g).to(x.dtype) * u
    ye = _bmm_f32(h, p["w_down"]).to(x.dtype)

    # combine: each (token, choice)'s output times its bf16 weight, the
    # products and their sum over k in f32, rounded once; a dropped choice
    # reads zero
    gathered = ye[flat_e, slot].reshape(T, k, D).float()
    weight = top_p.to(x.dtype).float()[..., None]
    out = _sum_k(gathered * weight).to(x.dtype)

    if cfg.shared_expert_d_ff:
        gs = dense(xt, p["shared_gate"])
        us = dense(xt, p["shared_up"])
        hs = (silu_f32(gs.float()) * us.float()).to(x.dtype)
        shared = dense(hs, p["shared_down"])
        gate = torch.sigmoid(dense(xt, p["shared_gate_proj"]).float()
                             ).to(x.dtype)
        out = out + gate * shared

    return out.reshape(B, S, D)


def aux_load_balance_loss(router_probs: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean prob x mean
    dispatch)."""
    mask = torch.nn.functional.one_hot(top_e, n_experts).float().sum(1)
    density = torch.minimum(mask, torch.ones_like(mask)).mean(0)
    prob_mass = router_probs.mean(0)
    return n_experts * (density * prob_mass).sum()
