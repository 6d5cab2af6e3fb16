"""Per-layer blocks: the dense and MoE transformer, RWKV6.

The port's own copy of `repro.models.blocks`: the transformer block with
the dense or the MoE feed-forward, and the RWKV6 (Finch) block.  The
Mamba2 block comes with the hybrid slice (ROADMAP Queue 1 item 5d).
Every block type provides
  * `<kind>_specs(cfg, stacked)` — ParamSpec tree (stacked on the layer axis)
  * `<kind>_fwd(x, p, cfg, ...)` — full-sequence forward (train / prefill)
  * `<kind>_step(x, p, cfg, state)` — one-token decode with carried state
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import ssm
from repro_torch.models.attention import (KVCache, _attend_decode_into,
                                          attend_train, attn_param_specs)
from repro_torch.models.common import (ModelConfig, ParamSpec, _scalar,
                                       dense, rms_norm, silu_f32, swiglu)
from repro_torch.models.moe import moe_ffn, moe_param_specs


def transformer_specs(cfg: ModelConfig, stacked: int | None) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    L = (stacked,) if stacked else ()
    Lx = ("layers",) if stacked else ()
    specs = {
        "ln_attn": ParamSpec(L + (D,), Lx + ("embed",), init="ones"),
        "ln_mlp": ParamSpec(L + (D,), Lx + ("embed",), init="ones"),
        "attn": attn_param_specs(cfg, stacked),
    }
    if cfg.is_moe:
        specs["moe"] = moe_param_specs(cfg, stacked)
    else:
        specs["mlp"] = {
            "w_gate": ParamSpec(L + (D, F), Lx + ("embed", "mlp")),
            "w_up": ParamSpec(L + (D, F), Lx + ("embed", "mlp")),
            "w_down": ParamSpec(L + (F, D), Lx + ("mlp", "embed")),
        }
    return specs


def _residual(x: torch.Tensor, h: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x + residual_scale * h: bf16 arithmetic, the sum in f32 (unrounded).

    The reference writes bf16 arithmetic, which XLA computes in f32.  On
    the CPU it keeps the f32 sum for a use that converts it to f32 (its
    excess precision): the norm before the MLP reads the unrounded sum,
    the next residual add the rounded one (`_mlp_residual`)."""
    sh = _scalar(cfg.residual_scale, h.dtype) * h
    return x.float() + sh.float()


def _mlp_residual(x, p, cfg: ModelConfig) -> torch.Tensor:
    """x (the unrounded f32 sum after attention) + the feed-forward's
    output (dense or MoE), bf16."""
    hin = rms_norm(x, p["ln_mlp"], cfg.norm_eps, dtype=torch.bfloat16)
    if cfg.is_moe:
        h = moe_ffn(hin, p["moe"], cfg)
    else:
        h = swiglu(hin, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                   p["mlp"]["w_down"])
    return _residual(x.to(torch.bfloat16), h, cfg).to(torch.bfloat16)


def transformer_fwd(x, p, cfg: ModelConfig, positions=None,
                    prefix_len: int = 0, rope=None):
    h = attend_train(rms_norm(x, p["ln_attn"], cfg.norm_eps), p["attn"], cfg,
                     positions=positions, prefix_len=prefix_len, rope=rope)
    return _mlp_residual(_residual(x, h, cfg), p, cfg)


def _transformer_step_into(x, p, cfg: ModelConfig, cache: KVCache,
                           rope=None) -> torch.Tensor:
    """`transformer_step` writing the new K/V into `cache`'s tensors."""
    h = _attend_decode_into(rms_norm(x, p["ln_attn"], cfg.norm_eps),
                            p["attn"], cfg, cache, rope)
    return _mlp_residual(_residual(x, h, cfg), p, cfg)


def transformer_step(x, p, cfg: ModelConfig, cache: KVCache
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode through one block; `cache` is left as it was."""
    new = KVCache(*(None if t is None else t.clone() for t in cache))
    out = _transformer_step_into(x, p, cfg, new)
    return out, new._replace(length=cache.length + 1)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) block
# ---------------------------------------------------------------------------

RWKV_LORA = 64


def rwkv_specs(cfg: ModelConfig, stacked: int | None) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    H = D // cfg.rwkv_head_dim
    K = cfg.rwkv_head_dim
    L = (stacked,) if stacked else ()
    Lx = ("layers",) if stacked else ()
    return {
        "ln1": ParamSpec(L + (D,), Lx + ("embed",), init="ones"),
        "ln2": ParamSpec(L + (D,), Lx + ("embed",), init="ones"),
        "tmix": {
            # static token-shift interpolators (data-dependent decay keeps
            # its LoRA below — the Finch signature feature)
            "mu_r": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "mu_k": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "mu_v": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "mu_g": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "mu_w": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "w_r": ParamSpec(L + (D, D), Lx + ("embed", "heads_joined")),
            "w_k": ParamSpec(L + (D, D), Lx + ("embed", "heads_joined")),
            "w_v": ParamSpec(L + (D, D), Lx + ("embed", "heads_joined")),
            "w_g": ParamSpec(L + (D, D), Lx + ("embed", "heads_joined")),
            "w_o": ParamSpec(L + (D, D), Lx + ("heads_joined", "embed")),
            "w0": ParamSpec(L + (D,), Lx + (None,), init="small"),
            "w_lora_a": ParamSpec(L + (D, RWKV_LORA), Lx + ("embed", None)),
            "w_lora_b": ParamSpec(L + (RWKV_LORA, D), Lx + (None, None)),
            "u": ParamSpec(L + (H, K), Lx + (None, None), init="small"),
            "ln_x": ParamSpec(L + (D,), Lx + ("embed",), init="ones"),
        },
        "cmix": {
            "mu_k": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "mu_r": ParamSpec(L + (D,), Lx + ("embed",), init="small"),
            "w_k": ParamSpec(L + (D, F), Lx + ("embed", "mlp")),
            "w_v": ParamSpec(L + (F, D), Lx + ("mlp", "embed")),
            "w_r": ParamSpec(L + (D, D), Lx + ("embed", "heads_joined")),
        },
    }


def _token_shift(x, x_prev_last):
    """x_{t-1} along seq; position 0 takes the carried last token."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_decay(xw, p):
    """Data-dependent per-channel decay in (0, 1), in f32."""
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float())
    lora = lora @ p["w_lora_b"].float()
    return torch.exp(-torch.exp(p["w0"].float() + lora))


def rwkv_tmix(x, p, cfg: ModelConfig, x_last, s0, chunked: bool):
    """The time mix on the normed stream x (B, T, D) bf16: (output bf16,
    x's last token, the WKV state).  bf16 arithmetic rounds op by op, as
    XLA computes it, except the decay's mix: the reference casts it to
    f32 at once, and XLA hands the LoRA the unrounded f32 sum."""
    B, T, D = x.shape
    K = cfg.rwkv_head_dim
    H = D // K
    dx = _token_shift(x, x_last) - x

    def shifted(mu):
        return dx * mu.to(x.dtype)

    def mix(mu):
        return x + shifted(mu)

    r = dense(mix(p["mu_r"]), p["w_r"]).reshape(B, T, H, K)
    k = dense(mix(p["mu_k"]), p["w_k"]).reshape(B, T, H, K)
    v = dense(mix(p["mu_v"]), p["w_v"]).reshape(B, T, H, K)
    g = dense(mix(p["mu_g"]), p["w_g"])
    xw = x.float() + shifted(p["mu_w"]).float()
    w = _rwkv_decay(xw, p).reshape(B, T, H, K)

    fn = ssm.wkv6_chunked if chunked else ssm.wkv6_scan
    out, sT = fn(r, k, v, w, p["u"].float(), s0)
    # per-head group norm (ln_x, biased variance), then gate
    mu = out.mean(-1, keepdim=True)
    var = (out - mu).square().mean(-1, keepdim=True)
    out = (out - mu) * torch.rsqrt(var + _scalar(64e-5, torch.float32))
    out = out.reshape(B, T, D) * p["ln_x"].float()
    out = out.to(x.dtype) * silu_f32(g.float()).to(x.dtype)
    return dense(out, p["w_o"]), x[:, -1, :], sT


def rwkv_cmix(x, p, x_last):
    dx = _token_shift(x, x_last) - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = dense(xk, p["w_k"])
    k = torch.relu(k.float()).square().to(x.dtype)
    r = torch.sigmoid(dense(xr, p["w_r"]).float()).to(x.dtype)
    return r * dense(k, p["w_v"]), x[:, -1, :]


def rwkv_fwd(x, p, cfg: ModelConfig, state=None, chunked: bool = True):
    """state = dict(s, x_att, x_ffn) or None (zeros). Returns (x, new
    state).  The norm before the channel mix reads the first residual
    sum unrounded in f32, the second residual add its bf16 rounding, as
    the jitted reference computes them (`_residual`)."""
    B, T, D = x.shape
    K = cfg.rwkv_head_dim
    H = D // K
    if state is None:
        state = {
            "s": torch.zeros((B, H, K, K), dtype=torch.float32,
                             device=x.device),
            "x_att": torch.zeros((B, D), dtype=x.dtype, device=x.device),
            "x_ffn": torch.zeros((B, D), dtype=x.dtype, device=x.device),
        }
    h, x_att, sT = rwkv_tmix(rms_norm(x, p["ln1"], cfg.norm_eps), p["tmix"],
                             cfg, state["x_att"], state["s"], chunked)
    x = x.float() + h.float()
    h, x_ffn = rwkv_cmix(rms_norm(x, p["ln2"], cfg.norm_eps,
                                  dtype=torch.bfloat16),
                         p["cmix"], state["x_ffn"])
    return x.to(h.dtype) + h, {"s": sT, "x_att": x_att, "x_ffn": x_ffn}
