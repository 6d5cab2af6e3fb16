"""Static alpha-analysis for transformer stages — the paper's Algorithm 1
applied to an LM's tensor-class DAG.

The port's own copy of `repro.quant.range_lm`.  Every token's activation
at a given tensor class (block input, qkv out, mlp hidden, ...) shares
range statistics, and every layer of the same class is pooled (max over
the stacked-layer weight statistics), so ONE combined interval per class
suffices — exactly the per-stage pooling the paper does for pixels.

Transfer functions:
  rmsnorm   : |out_i| <= gamma_i * sqrt(D)             (since |x_i/rms| <= sqrt(D))
  matmul    : |y_i|  <= max_i sum_j |W_ji| * max|x|    (L1 column norm)
  softmax   : probs in [0, 1] -> attn out bounded by value range
  silu(g)*u : |.| <= max(|g|) * |u| and silu >= -0.2785
  residual  : interval sum

The static estimates are sound but loosen with depth (the residual
stream's bound grows linearly in L); profile calibration
(`repro_torch.quant.calibrate`) tightens them — Table IX's
static-vs-profile gap, reproduced on transformers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.fixedpoint import alpha_for_range
from repro_torch.core.interval import Interval
from repro_torch.models.common import ModelConfig


def _absmax(x) -> float:
    return float(x.abs().amax())


def _l1_col_max(w) -> float:
    """max_i sum_j |W[j, i]| over the last two dims (pooled over layers)."""
    col = w.float().abs().sum(dim=-2)          # sum over input dim
    return float(col.amax())


def static_ranges(params, cfg: ModelConfig) -> Dict[str, Interval]:
    """Per-tensor-class value ranges from weights alone (no data)."""
    D = cfg.d_model
    sq = float(np.sqrt(D))
    out: Dict[str, Interval] = {}

    emb = _absmax(params["embed"]) * cfg.emb_scale
    out["embed_out"] = Interval(-emb, emb)
    resid = out["embed_out"]

    blocks = params["blocks"]
    if cfg.arch_class in ("dense", "moe", "vlm"):
        g_attn = _absmax(blocks["ln_attn"]) * sq
        norm1 = Interval(-g_attn, g_attn)
        qkv = norm1 * _l1_col_max(blocks["attn"]["wq"])
        out["attn_qkv"] = qkv
        # softmax-weighted values stay within the value range; wo expands
        attn_out = (norm1 * _l1_col_max(blocks["attn"]["wv"])) \
            * _l1_col_max(blocks["attn"]["wo"])
        out["attn_out"] = attn_out
        g_mlp = _absmax(blocks["ln_mlp"]) * sq
        key = "moe" if cfg.is_moe else "mlp"
        gate_b = _l1_col_max(blocks[key]["w_gate"]) * g_mlp
        up_b = _l1_col_max(blocks[key]["w_up"]) * g_mlp
        h = Interval(-gate_b * up_b, gate_b * up_b)     # silu(g)*u bound
        out["mlp_hidden"] = h
        mlp_out = h * _l1_col_max(blocks[key]["w_down"])
        out["mlp_out"] = mlp_out
        per_layer = attn_out.abs().hi + mlp_out.abs().hi
    elif cfg.arch_class == "rwkv":
        g1 = _absmax(blocks["ln1"]) * sq
        n1 = Interval(-g1, g1)
        out["attn_qkv"] = n1 * _l1_col_max(blocks["tmix"]["w_k"])
        attn_out = n1 * _l1_col_max(blocks["tmix"]["w_o"])
        out["attn_out"] = attn_out
        g2 = _absmax(blocks["ln2"]) * sq
        kk = Interval(0.0, (_l1_col_max(blocks["cmix"]["w_k"]) * g2) ** 2)
        out["mlp_hidden"] = kk
        mlp_out = kk * _l1_col_max(blocks["cmix"]["w_v"])
        out["mlp_out"] = mlp_out
        per_layer = attn_out.abs().hi + mlp_out.abs().hi
    elif cfg.arch_class == "hybrid":
        g1 = _absmax(blocks["ln"]) * sq
        n1 = Interval(-g1, g1)
        proj = n1 * _l1_col_max(blocks["in_proj"])
        out["attn_qkv"] = proj
        mlp_out = Interval(-sq, sq) * _l1_col_max(blocks["out_proj"])
        out["mlp_out"] = mlp_out
        out["attn_out"] = mlp_out
        out["mlp_hidden"] = proj
        per_layer = mlp_out.abs().hi
    else:
        raise ValueError(cfg.arch_class)

    # residual stream after L layers: embed + L per-layer contributions
    # (the deep-pipeline blow-up, cf. paper Table IX)
    total = resid.abs().hi + cfg.n_layers * cfg.residual_scale * per_layer
    out["resid_final"] = Interval(-total, total)
    logit_b = total * _l1_col_max(params["unembed"]) * cfg.logit_scale
    out["logits"] = Interval(-logit_b, logit_b)
    return out


def static_alpha_table(params, cfg: ModelConfig) -> Dict[str, int]:
    return {k: alpha_for_range(v.lo, v.hi)
            for k, v in static_ranges(params, cfg).items()}
