"""Per-layer blocks: the dense and MoE transformer.

The port's own copy of `repro.models.blocks`, its transformer block with
the dense or the MoE feed-forward.  The RWKV6 and Mamba2 blocks come
with a later slice (ROADMAP Queue 1 item 5d).  Every block type provides
  * `<kind>_specs(cfg, stacked)` — ParamSpec tree (stacked on the layer axis)
  * `<kind>_fwd(x, p, cfg, ...)` — full-sequence forward (train / prefill)
  * `<kind>_step(x, p, cfg, state)` — one-token decode with carried state
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.attention import (KVCache, _attend_decode_into,
                                          attend_train, attn_param_specs)
from repro_torch.models.common import (ModelConfig, ParamSpec, _scalar,
                                       rms_norm, swiglu)
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
