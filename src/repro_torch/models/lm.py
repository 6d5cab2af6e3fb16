"""Decoder LM assembly: embed -> stacked blocks -> norm -> unembed.

The port's own copy of `repro.models.lm`, its dense, MoE, VLM
(prefix-LM over patch embeddings) and RWKV6 branches; whisper's
encoder-decoder lives in `repro_torch.models.encdec`.  The reference
consumes the layer-stacked parameters with `jax.lax.scan`; the port
loops over the layer axis, one block at a time.  The Mamba2 hybrid
comes with a later slice (`_check_ported` names its ROADMAP item).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache, rope_tables
from repro_torch.models.common import (ModelConfig, ParamSpec, _scalar,
                                       axes_tree, constrain_act, dense,
                                       init_tree, rms_norm, shape_tree,
                                       tree_map)

# the ROADMAP Queue 1 item that ports each architecture class not ported yet
NOT_PORTED = {
    "hybrid": "5d (the mamba2 hybrid)",
}


def _check_ported(cfg: ModelConfig) -> None:
    """The dense, MoE, VLM and rwkv classes pass; hybrid raises
    `NotImplementedError`, any other class (encdec) `ValueError`, as the
    reference's branches do."""
    if cfg.arch_class in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: arch_class {cfg.arch_class!r} is not ported yet "
            f"(ROADMAP Queue 1 item {NOT_PORTED[cfg.arch_class]})")
    if cfg.arch_class not in ("dense", "moe", "vlm", "rwkv"):
        raise ValueError(cfg.arch_class)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> Dict:
    _check_ported(cfg)
    D, Vp, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    specs: Dict[str, Any] = {
        "embed": ParamSpec((Vp, D), ("vocab", "embed")),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        "unembed": ParamSpec((D, Vp), ("embed", "vocab")),
    }
    if cfg.arch_class == "rwkv":
        specs["blocks"] = B.rwkv_specs(cfg, stacked=L)
    else:
        specs["blocks"] = B.transformer_specs(cfg, stacked=L)
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """f32 parameters drawn from `generator`, on its device."""
    return init_tree(generator, param_specs(cfg))


def param_axes(cfg: ModelConfig) -> Dict:
    return axes_tree(param_specs(cfg))


def abstract_params(cfg: ModelConfig) -> Dict:
    return shape_tree(param_specs(cfg))


def layer_params(blocks: Dict, layer: int) -> Dict:
    """One layer's slice of the stacked block parameters (views)."""
    return tree_map(lambda a: a[layer], blocks)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg: ModelConfig,
           patch_embeds=None) -> torch.Tensor:
    """Token embeddings in bf16, times `emb_scale`; for the VLM, the
    patch embeddings (B, P, D) in bf16 over positions 0..P-1 (the
    reference's `dynamic_update_slice_in_dim` at 0, unscaled)."""
    x = params["embed"][tokens].to(torch.bfloat16)
    x = x * _scalar(cfg.emb_scale, torch.bfloat16)
    if cfg.arch_class == "vlm" and patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    return x


def _run_blocks(params, x, cfg: ModelConfig) -> torch.Tensor:
    """The layer stack on an embedded stream x (B, S, D).  The VLM's
    first `n_image_tokens` positions attend bidirectionally (prefix-LM),
    with or without patch embeddings; rwkv runs each layer from a zero
    state, the WKV chunked."""
    _check_ported(cfg)
    x = constrain_act(x, cfg)
    if cfg.arch_class == "rwkv":
        return rwkv_layers(params, x, cfg)[0]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    prefix = cfg.n_image_tokens if cfg.arch_class == "vlm" else 0
    for layer in range(cfg.n_layers):
        x = B.transformer_fwd(x, layer_params(params["blocks"], layer), cfg,
                              positions=positions, prefix_len=prefix,
                              rope=rope)
        x = constrain_act(x, cfg)
    return x


def forward(params, tokens, cfg: ModelConfig,
            patch_embeds=None) -> torch.Tensor:
    """tokens (B, S) [and, for the VLM, patch_embeds (B, P, D)] -> logits
    (B, S, vocab_padded), f32."""
    x = _embed(params, tokens, cfg, patch_embeds)
    x = _run_blocks(params, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x, params["unembed"]).float()
    return logits * _scalar(cfg.logit_scale, torch.float32)


# token-chunked softmax cross entropy: the (T, vocab) logits are never
# materialized at once (the reference recomputes each chunk in backward)
XENT_CHUNKS = 16


def _logsumexp(a: torch.Tensor) -> torch.Tensor:
    """jax.scipy.special.logsumexp over the last axis: the max, replaced
    by 0 where not finite, taken out before the exponentials."""
    amax = a.amax(-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(a - amax).sum(-1)) + amax[..., 0]


def _xent_chunked(x, unembed, targets, logit_scale: float):
    T, D = x.shape
    n = XENT_CHUNKS
    while T % n != 0:
        n //= 2
    scale = _scalar(logit_scale, torch.float32)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for xb, tb in zip(x.reshape(n, T // n, D), targets.reshape(n, T // n)):
        logits = dense(xb, unembed).float() * scale
        lse = _logsumexp(logits)
        picked = torch.gather(logits, -1, tb[:, None].long())[:, 0]
        nll_sum = nll_sum + (lse - picked).sum()
        z_sum = z_sum + lse.square().sum()
    return nll_sum, z_sum


def loss_fn(params, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ z-loss stabilizer), vocab-chunked.

    The forward value; gradients come with the training slice."""
    x = _embed(params, batch["tokens"], cfg, batch.get("patch_embeds"))
    x = _run_blocks(params, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    Bsz, S, D = x.shape
    targets = batch["labels"].reshape(-1)
    nll_sum, z_sum = _xent_chunked(x.reshape(Bsz * S, D), params["unembed"],
                                   targets, cfg.logit_scale)
    denom = torch.tensor(Bsz * S, dtype=torch.float32, device=x.device)
    loss = nll_sum / denom
    zloss = _scalar(1e-4, torch.float32) * z_sum / denom
    return loss + zloss, {"loss": loss, "zloss": zloss, "tokens": denom}


# ---------------------------------------------------------------------------
# decode (serve_step): one token against carried state
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefill_len: int = 0, device=None) -> Dict:
    """State for one-token decode on `device` (None: the card).
    `prefill_len` marks the cache as already holding that many tokens.
    rwkv's state is the f32 WKV state (L, B, H, K, K) and each layer's
    last normed token before its time and channel mix, bf16."""
    _check_ported(cfg)
    dev = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    length = torch.tensor(prefill_len, dtype=torch.int32, device=dev)
    if cfg.arch_class == "rwkv":
        D, K = cfg.d_model, cfg.rwkv_head_dim
        return {
            "s": torch.zeros((L, batch, D // K, K, K), dtype=torch.float32,
                             device=dev),
            "x_att": torch.zeros((L, batch, D), dtype=torch.bfloat16,
                                 device=dev),
            "x_ffn": torch.zeros((L, batch, D), dtype=torch.bfloat16,
                                 device=dev),
            "length": length,
        }
    shape = (L, batch, KV, max_len, hd)
    if cfg.kv_cache_dtype == "int8":
        # paper technique on the decode working set: int8 codes +
        # per-(pos, head) scales => ~2x fewer cache bytes per step
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=dev),
            "length": length,
        }
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "length": length,
    }


def decode_step(params, token, state: Dict, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """token (B,) int -> (logits (B, vocab_padded) f32, new state).

    `state` is left as it was: the new state's caches are copies."""
    _check_ported(cfg)
    x = _embed(params, token[:, None], cfg)
    length = state["length"]
    if cfg.arch_class == "rwkv":
        x, new_state = rwkv_layers(params, x, cfg, state)
    else:
        x, new_state = _transformer_step(params, x, state, cfg)
    new_state["length"] = length + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0, :], params["unembed"]).float()
    return (logits * _scalar(cfg.logit_scale, torch.float32),
            new_state)


def rwkv_layers(params, x, cfg: ModelConfig, state=None):
    """Every rwkv layer on x (B, T, D): from zero states with the WKV
    chunked where `state` is None (the forward, prefill), else from the
    carried per-layer state a token at a time (decode).  (x, each
    layer's new s, x_att and x_ffn stacked on the layer axis)."""
    new = {"s": [], "x_att": [], "x_ffn": []}
    for layer in range(cfg.n_layers):
        st = None if state is None else {k: state[k][layer] for k in new}
        x, st = B.rwkv_fwd(x, layer_params(params["blocks"], layer), cfg,
                           state=st, chunked=state is None)
        x = constrain_act(x, cfg)
        for k in new:
            new[k].append(st[k])
    return x, {k: torch.stack(v) for k, v in new.items()}


def _transformer_step(params, x, state: Dict, cfg: ModelConfig):
    """Every layer's block on one token, its K/V written into copies of
    the caches at the shared position."""
    length = state["length"]
    new_state = {k: v.clone() for k, v in state.items() if k != "length"}
    scales = cfg.kv_cache_dtype == "int8"
    rope = rope_tables(length.to(torch.int32).expand(x.shape[0], 1), cfg.hd,
                       cfg.rope_theta)
    for layer in range(cfg.n_layers):
        cache = KVCache(
            k=new_state["k"][layer], v=new_state["v"][layer], length=length,
            k_scale=new_state["k_scale"][layer] if scales else None,
            v_scale=new_state["v_scale"][layer] if scales else None)
        x = B._transformer_step_into(
            x, layer_params(params["blocks"], layer), cfg, cache, rope)
    return x, new_state
