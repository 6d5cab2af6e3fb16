"""Encoder-decoder LM (whisper-medium backbone).

The port's own copy of `repro.models.encdec`.  The modality frontend is
a stub: the encoder takes precomputed conv-frontend frame embeddings
(B, T_enc, D).  The backbone (24L enc + 24L dec, d=1024, 16H, ff=4096)
uses RMSNorm and SwiGLU, as the reference does.

Encoder: bidirectional self-attention over frames.
Decoder: causal self-attention + cross-attention over encoder output.

The reference consumes the layer-stacked parameters with `jax.lax.scan`;
the port loops over the layer axis.  Its residual adds are bf16
arithmetic, which XLA computes in f32; the port follows the compiled
reference as the dense block does (`blocks._residual`, with whisper's
residual scale of 1): a norm reads the unrounded f32 sum, the next add
the sum rounded to bf16.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (KVCache, _attend_decode_into,
                                          attend_train, attn_param_specs,
                                          cross_attend, rope_tables)
from repro_torch.models.blocks import _mlp_residual, _residual
from repro_torch.models.common import (ModelConfig, ParamSpec, _scalar,
                                       axes_tree, constrain_act, dense,
                                       init_tree, rms_norm)
from repro_torch.models.lm import _xent_chunked, layer_params


def _mlp_specs(cfg: ModelConfig, stacked: int):
    D, F = cfg.d_model, cfg.d_ff
    L, Lx = (stacked,), ("layers",)
    return {
        "w_gate": ParamSpec(L + (D, F), Lx + ("embed", "mlp")),
        "w_up": ParamSpec(L + (D, F), Lx + ("embed", "mlp")),
        "w_down": ParamSpec(L + (F, D), Lx + ("mlp", "embed")),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    D, Vp = cfg.d_model, cfg.vocab_padded
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    return {
        "embed": ParamSpec((Vp, D), ("vocab", "embed")),
        "enc_blocks": {
            "ln_attn": ParamSpec((Le, D), ("layers", "embed"), init="ones"),
            "ln_mlp": ParamSpec((Le, D), ("layers", "embed"), init="ones"),
            "attn": attn_param_specs(cfg, stacked=Le),
            "mlp": _mlp_specs(cfg, Le),
        },
        "enc_norm": ParamSpec((D,), ("embed",), init="ones"),
        "dec_blocks": {
            "ln_attn": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
            "ln_cross": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
            "ln_mlp": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
            "attn": attn_param_specs(cfg, stacked=Ld),
            "cross": attn_param_specs(cfg, stacked=Ld),
            "mlp": _mlp_specs(cfg, Ld),
        },
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        "unembed": ParamSpec((D, Vp), ("embed", "vocab")),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """f32 parameters drawn from `generator`, on its device."""
    return init_tree(generator, param_specs(cfg))


def param_axes(cfg: ModelConfig) -> Dict:
    return axes_tree(param_specs(cfg))


def _cross(s: torch.Tensor, lp: Dict, cfg: ModelConfig, ek, ev
           ) -> torch.Tensor:
    """The cross-attention sublayer on the unrounded f32 sum `s`: the new
    unrounded sum bf16(s) + cross_attend(norm(s))."""
    c = cross_attend(rms_norm(s, lp["ln_cross"], cfg.norm_eps,
                              dtype=torch.bfloat16), lp["cross"], cfg, ek, ev)
    return _residual(s.to(torch.bfloat16), c, cfg)


def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T_enc, D) [conv-frontend stub output] -> (B, T_enc, D)."""
    x = frames.to(torch.bfloat16)
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    for layer in range(cfg.n_encoder_layers):
        lp = layer_params(params["enc_blocks"], layer)
        a = attend_train(rms_norm(x, lp["ln_attn"], cfg.norm_eps), lp["attn"],
                         cfg, positions=positions, causal=False, rope=rope)
        x = constrain_act(_mlp_residual(_residual(x, a, cfg), lp, cfg), cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_kv(enc_out, p, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K/V, (B, KV, T, hd) bf16."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    Bsz, T, _ = enc_out.shape
    k = dense(enc_out, p["wk"]).reshape(Bsz, T, KV, hd)
    v = dense(enc_out, p["wv"]).reshape(Bsz, T, KV, hd)
    return k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def cross_kv(params, enc_out, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute per-decoder-layer cross-attention KV: (L, B, KV, T, hd)."""
    kvs = [_enc_kv(enc_out, layer_params(params["dec_blocks"],
                                         layer)["cross"], cfg)
           for layer in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _decode_backbone(params, tokens, enc_out, cfg: ModelConfig
                     ) -> torch.Tensor:
    """Decoder blocks on embedded tokens — everything before the unembed."""
    x = params["embed"][tokens].to(torch.bfloat16)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    x = constrain_act(x, cfg)
    for layer in range(cfg.n_layers):
        lp = layer_params(params["dec_blocks"], layer)
        a = attend_train(rms_norm(x, lp["ln_attn"], cfg.norm_eps), lp["attn"],
                         cfg, positions=positions, causal=True, rope=rope)
        ek, ev = _enc_kv(enc_out, lp["cross"], cfg)
        s = _cross(_residual(x, a, cfg), lp, cfg, ek, ev)
        x = constrain_act(_mlp_residual(s, lp, cfg), cfg)
    return x


def decode_train(params, tokens, enc_out, cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, S), enc_out (B, T, D) -> logits (B, S, Vp), f32."""
    x = _decode_backbone(params, tokens, enc_out, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dense(x, params["unembed"]).float()


def forward(params, batch: Dict, cfg: ModelConfig) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg)
    return decode_train(params, batch["tokens"], enc_out, cfg)


def loss_fn(params, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ z-loss stabilizer), vocab-chunked.

    The forward value; gradients come with the training slice."""
    enc_out = encode(params, batch["frames"], cfg)
    x = _decode_backbone(params, batch["tokens"], enc_out, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    Bsz, S, D = x.shape
    nll_sum, z_sum = _xent_chunked(x.reshape(Bsz * S, D), params["unembed"],
                                   batch["labels"].reshape(-1), 1.0)
    denom = torch.tensor(Bsz * S, dtype=torch.float32, device=x.device)
    zloss = _scalar(1e-4, torch.float32) * z_sum / denom
    loss = nll_sum / denom + zloss
    return loss, {"loss": nll_sum / denom, "zloss": zloss, "tokens": denom}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefill_len: int = 0, device=None) -> Dict:
    """State for one-token decode on `device` (None: the card): the
    self-attention caches and zeroed cross-attention K/V of
    `cfg.encoder_seq` positions (fill them from `cross_kv`)."""
    dev = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    T = cfg.encoder_seq

    def zeros(n):
        return torch.zeros((L, batch, KV, n, hd), dtype=torch.bfloat16,
                           device=dev)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(T), "cross_v": zeros(T),
            "length": torch.tensor(prefill_len, dtype=torch.int32,
                                   device=dev)}


def decode_step(params, token, state: Dict, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token against self-KV cache + precomputed cross KV.

    `state` is left as it was: the new state's self-attention caches are
    copies, and its cross K/V are `state`'s own tensors (read only)."""
    x = params["embed"][token[:, None]].to(torch.bfloat16)
    length = state["length"]
    new_state = dict(state, k=state["k"].clone(), v=state["v"].clone())
    rope = rope_tables(length.to(torch.int32).expand(x.shape[0], 1), cfg.hd,
                       cfg.rope_theta)
    for layer in range(cfg.n_layers):
        lp = layer_params(params["dec_blocks"], layer)
        cache = KVCache(k=new_state["k"][layer], v=new_state["v"][layer],
                        length=length)
        a = _attend_decode_into(rms_norm(x, lp["ln_attn"], cfg.norm_eps),
                                lp["attn"], cfg, cache, rope)
        s = _cross(_residual(x, a, cfg), lp, cfg, state["cross_k"][layer],
                   state["cross_v"][layer])
        x = _mlp_residual(s, lp, cfg)
    new_state["length"] = length + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0, :], params["unembed"]).float()
    return logits, new_state
