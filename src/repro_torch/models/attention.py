"""Attention: GQA/MQA with RoPE, optional qk-norm and sliding window.

The port's own copy of `repro.models.attention`.  Three entry points:
  * `attend_train`  — full-sequence causal attention (training / prefill)
  * `attend_decode` — one new token against a KV cache (serve_step)
  * `cross_attend`  — decoder queries over precomputed encoder K/V

Layouts: activations (B, S, D); q (B, S, H, hd); kv (B, S, KV, hd);
cache (B, KV, S_max, hd).

The arithmetic is the reference's, written out: f32 logits of bf16
operands times the scalar ``hd ** -0.5`` in f32, masking with
``NEG_INF = -1e9``, softmax in f32 (``exp(x - max) / sum``), probabilities
cast to the value dtype, and the second product summed in f32.  No
``scaled_dot_product_attention``: its arithmetic differs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import (ModelConfig, ParamSpec, _scalar,
                                       dense, rms_norm)

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta ** (2i / hd) in f32, as the compiled reference has it:
    XLA folds the constant into theta ** -(2i / hd), correctly rounded, so
    the power is taken in f64 and rounded once."""
    ex = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    ex = ex / torch.full_like(ex, hd)
    base = float(torch.tensor(theta, dtype=torch.float32))   # theta in f32
    return torch.pow(base, -ex.double()).float()


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the f32 angles positions * freqs, shaped
    positions.shape + (1, hd/2); taken in f64 and rounded once.  A block
    stack computes them once and hands them to every layer."""
    freqs = rope_freqs(hd, theta, positions.device)       # (hd/2,)
    ang = (positions[..., None].float() * freqs).double()  # (B, S, hd/2)
    return (torch.cos(ang).float()[..., None, :],
            torch.sin(ang).float()[..., None, :])


def _rotate(x: torch.Tensor, rope) -> torch.Tensor:
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def attn_param_specs(cfg: ModelConfig, stacked: int | None = None) -> Dict:
    """Projection params for one attention block (optionally layer-stacked)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = (stacked,) if stacked else ()
    Lx = ("layers",) if stacked else ()
    specs = {
        "wq": ParamSpec(L + (D, H * hd), Lx + ("embed", "heads_joined")),
        "wk": ParamSpec(L + (D, KV * hd), Lx + ("embed", "kv_joined")),
        "wv": ParamSpec(L + (D, KV * hd), Lx + ("embed", "kv_joined")),
        "wo": ParamSpec(L + (H * hd, D), Lx + ("heads_joined", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(L + (hd,), Lx + (None,), init="ones")
        specs["k_norm"] = ParamSpec(L + (hd,), Lx + (None,), init="ones")
    return specs


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, KV, S_max, hd) — bf16, or int8 codes
    v: torch.Tensor        # (B, KV, S_max, hd)
    length: torch.Tensor   # () int32 — tokens already cached
    # int8 cache (paper technique on decode bytes): per-(pos, head) absmax
    # scales; None for the bf16 cache
    k_scale: Optional[torch.Tensor] = None   # (B, KV, S_max, 1) f32
    v_scale: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _split_heads(x, n, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def _causal_mask(S: int, window: int, prefix: int = 0,
                 device=None) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = j <= i
    if window > 0:
        mask &= (i - j) < window
    if prefix > 0:
        # prefix-LM (PaliGemma): the image/prompt prefix attends bidirectionally
        mask |= j < prefix
    return mask                                          # (S, S) bool


def _project_qkv(x, p, cfg: ModelConfig, positions, rope=None):
    """q, k, v; `rope` (from `rope_tables`) saves computing the tables."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(dense(x, p["wq"]), H, hd)
    k = _split_heads(dense(x, p["wk"]), KV, hd)
    v = _split_heads(dense(x, p["wv"]), KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is None:
        rope = rope_tables(positions, hd, cfg.rope_theta)
    return _rotate(q, rope), _rotate(k, rope), v


# above this many tokens, attention runs query-chunked (memory O(Cq * S)
# per step instead of O(S^2)) — mandatory for the 32k prefill shapes
QUERY_CHUNK = 1024


def _softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax: exp(x - max) / sum, in f32."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _scores(q, k, hd: int) -> torch.Tensor:
    """f32 q k^T of (.., Sq, hd) and (B, KV, Sk, hd) operands, times
    hd ** -0.5 as an f32 scalar."""
    k = k[:, :, None]                                    # (B, KV, 1, Sk, hd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return logits * _scalar(hd ** -0.5, torch.float32)


def _attend_block(q, k, v, q_pos, k_pos, cfg: ModelConfig, causal: bool,
                  prefix_len: int):
    """Attention for one query block against full K/V.

    q: (B, KV, G, Cq, hd); k, v: (B, KV, S, hd); *_pos: absolute positions.
    Exact softmax — each query row sees its whole key range.
    """
    logits = _scores(q, k, cfg.hd)
    if causal:
        i = q_pos[:, None]
        j = k_pos[None, :]
        mask = j <= i
        if cfg.sliding_window > 0:
            mask &= (i - j) < cfg.sliding_window
        if prefix_len > 0:
            mask |= j < prefix_len
        logits = torch.where(mask, logits, NEG_INF)
    probs = _softmax_f32(logits).to(v.dtype)
    return torch.matmul(probs.float(), v[:, :, None].float())


def attend_train(x, p, cfg: ModelConfig, positions=None,
                 causal: bool = True, prefix_len: int = 0,
                 rope=None) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    groups = H // KV
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions, rope)

    # (B, KV, G, S, hd) grouped query layout
    q = q.reshape(B, S, KV, groups, hd).permute(0, 2, 3, 1, 4)
    k = k.permute(0, 2, 1, 3)                            # (B, KV, S, hd)
    v = v.permute(0, 2, 1, 3)
    pos = torch.arange(S, device=x.device)

    if S <= QUERY_CHUNK or S % QUERY_CHUNK != 0:
        out = _attend_block(q, k, v, pos, pos, cfg, causal, prefix_len)
    else:
        # query chunks: peak live logits are (.., Cq, S), not (S, S)
        out = torch.cat([
            _attend_block(q[:, :, :, c:c + QUERY_CHUNK], k, v,
                          pos[c:c + QUERY_CHUNK], pos, cfg, causal,
                          prefix_len)
            for c in range(0, S, QUERY_CHUNK)], dim=3)

    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(x.dtype)
    return dense(out, p["wo"])


def _qvec(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of x along its last axis: absmax / 127 in x's dtype, 0
    mapped to 1, f32 quotient rounded half-even, clipped to [-128, 127]."""
    m = x.abs().amax(-1, keepdim=True).float()
    # a tensor divisor: a scalar one is a reciprocal multiply on the card
    sc = (m / torch.full_like(m, 127.0)).to(x.dtype)
    sc = torch.where(sc == 0, 1.0, sc).float()
    q = torch.round(x.float() / sc).clamp(-128, 127).to(torch.int8)
    return q, sc


def _write_at(buf: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> None:
    """buf[:, :, pos] = new, in place, with the start clamped so that the
    update fits, as ``jax.lax.dynamic_update_slice_in_dim`` clamps it: from
    ``pos >= S_max`` on, the write lands on position S_max - 1."""
    at = pos.clamp(0, buf.shape[2] - new.shape[2]).reshape(1).long()
    buf.index_copy_(2, at, new)


def _attend_decode_into(x, p, cfg: ModelConfig, cache: KVCache,
                        rope=None) -> torch.Tensor:
    """`attend_decode` writing the new K/V into `cache`'s tensors."""
    B, S1, D = x.shape
    assert S1 == 1
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    groups = H // KV
    pos = cache.length                                    # () int32
    positions = pos.to(torch.int32).expand(B, 1)
    q, k, v = _project_qkv(x, p, cfg, positions, rope)

    k_new = k.permute(0, 2, 1, 3)                         # (B, KV, 1, hd)
    v_new = v.permute(0, 2, 1, 3)
    if cache.k_scale is not None:
        kq, ks = _qvec(k_new)
        vq, vs = _qvec(v_new)
        _write_at(cache.k, kq, pos)
        _write_at(cache.v, vq, pos)
        _write_at(cache.k_scale, ks, pos)
        _write_at(cache.v_scale, vs, pos)
        # fused dequant on read: int8 codes * f32 scale -> bf16
        k_eff = (cache.k.float() * cache.k_scale).to(torch.bfloat16)
        v_eff = (cache.v.float() * cache.v_scale).to(torch.bfloat16)
    else:
        _write_at(cache.k, k_new.to(cache.k.dtype), pos)
        _write_at(cache.v, v_new.to(cache.v.dtype), pos)
        k_eff, v_eff = cache.k, cache.v

    q = q.reshape(B, 1, KV, groups, hd).permute(0, 2, 3, 1, 4)  # (B,KV,G,1,hd)
    logits = _scores(q, k_eff.to(q.dtype), hd)
    S_max = cache.k.shape[2]
    idx = torch.arange(S_max, device=x.device)
    valid = idx <= pos
    if cfg.sliding_window > 0:
        valid &= (pos - idx) < cfg.sliding_window
    logits = torch.where(valid, logits, NEG_INF)
    probs = _softmax_f32(logits).to(v_eff.dtype)
    out = torch.matmul(probs.float(), v_eff[:, :, None].float())
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * hd).to(x.dtype)
    return dense(out, p["wo"])


def attend_decode(x, p, cfg: ModelConfig, cache: KVCache
                  ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, D); returns (out (B, 1, D), new cache).

    `cache` is left as it was: the new cache is a copy."""
    new = KVCache(*(None if t is None else t.clone() for t in cache))
    out = _attend_decode_into(x, p, cfg, new)
    return out, new._replace(length=cache.length + 1)


def cross_attend(x, p, cfg: ModelConfig, enc_k, enc_v) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, KV, T, hd).

    x: (B, S, D) -> (B, S, D).  No rope and no mask; query-chunked like
    `attend_train` (peak live logits (.., Cq, T), not (S, T))."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    groups = H // KV
    q = _split_heads(dense(x, p["wq"]), H, hd)
    q = q.reshape(B, S, KV, groups, hd).permute(0, 2, 3, 1, 4)
    k = enc_k.to(q.dtype)

    def block(qc):
        probs = _softmax_f32(_scores(qc, k, hd)).to(enc_v.dtype)
        return torch.matmul(probs.float(), enc_v[:, :, None].float())

    if S <= QUERY_CHUNK or S % QUERY_CHUNK != 0:
        out = block(q)
    else:
        out = torch.cat([block(q[:, :, :, c:c + QUERY_CHUNK])
                         for c in range(0, S, QUERY_CHUNK)], dim=3)

    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(x.dtype)
    return dense(out, p["wo"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    dev = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, KV, max_len, hd), dtype=dtype, device=dev),
        v=torch.zeros((batch, KV, max_len, hd), dtype=dtype, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )
