"""Fused prefill: populate a decode state from a whole prompt in one pass.

The port's own copy of `repro.serve.prefill`.  The continuous batcher's
slot-local fallback feeds prompts token-by-token (correct, O(prompt)
decode steps); production serving prefills the KV cache (dense, MoE and
VLM) or the recurrent state (rwkv) with one full-sequence forward.

As in the reference, the VLM's prefill embeds text only: no patch
embeddings and no prefix-LM mask (ROADMAP, "Reference defects"); an
encoder-decoder or hybrid config goes to `prefill_dense` and fails its
first assertion.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.attention import _project_qkv, rope_tables
from repro_torch.models.common import ModelConfig, _scalar, matmul_f32, rms_norm


def prefill_dense(params, tokens, cfg: ModelConfig, max_len: int
                  ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> (next-token logits (B, Vp) f32, decode state at S).

    Runs the train-style forward but also captures each layer's K/V for
    the cache.  bf16 cache only (int8 prefill would quantize at the end).
    """
    assert cfg.arch_class in ("dense", "moe", "vlm")
    assert cfg.kv_cache_dtype == "bf16", "int8 prefill: quantize post-hoc"
    Bsz, S = tokens.shape
    x = lm._embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    shape = (cfg.n_layers, Bsz, cfg.n_kv_heads, max_len, cfg.hd)
    ks = torch.zeros(shape, dtype=torch.bfloat16, device=x.device)
    vs = torch.zeros(shape, dtype=torch.bfloat16, device=x.device)

    for layer in range(cfg.n_layers):
        layer_p = lm.layer_params(params["blocks"], layer)
        # capture K/V exactly as attend_train computes them
        hin = rms_norm(x, layer_p["ln_attn"], cfg.norm_eps)
        _, k, v = _project_qkv(hin, layer_p["attn"], cfg, positions, rope)
        ks[layer, :, :, :S] = k.permute(0, 2, 1, 3)
        vs[layer, :, :, :S] = v.permute(0, 2, 1, 3)
        x = B.transformer_fwd(x, layer_p, cfg, positions=positions, rope=rope)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = matmul_f32(x[:, -1, :], params["unembed"])
    logits = logits * _scalar(cfg.logit_scale, torch.float32)
    state = {"k": ks, "v": vs,
             "length": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits, state


def prefill_recurrent(params, tokens, cfg: ModelConfig, max_len: int
                      ) -> Tuple[torch.Tensor, Dict]:
    """Prefill for rwkv: the chunked forward, carrying each layer's
    state out.  tokens (B, S) -> (next-token logits (B, Vp) f32, decode
    state at S); `max_len` is unused (the state's size does not grow)."""
    assert cfg.arch_class == "rwkv"
    x, state = lm.rwkv_layers(params, lm._embed(params, tokens, cfg), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = matmul_f32(x[:, -1, :], params["unembed"])
    logits = logits * _scalar(cfg.logit_scale, torch.float32)
    state["length"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                   device=x.device)
    return logits, state


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    if cfg.arch_class == "rwkv":
        return prefill_recurrent(params, tokens, cfg, max_len)
    return prefill_dense(params, tokens, cfg, max_len)
