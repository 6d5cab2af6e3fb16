"""MiniCPM-2B — llama-like with mu-parametrization scales + WSD schedule
[arXiv:2404.06395].

40L d_model=2304, 36H (kv=36), d_ff=5760, vocab=122753.
Scales: emb x12, residual x1.4/sqrt(L), logits x(256/d_model).
The WSD (warmup-stable-decay) schedule comes with the training slice.
"""
import math

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    L = 40
    return ModelConfig(
        name="minicpm-2b", arch_class="dense", n_layers=L, d_model=2304,
        n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753,
        emb_scale=12.0, residual_scale=1.4 / math.sqrt(L),
        logit_scale=256.0 / 2304.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", arch_class="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=513,
        emb_scale=12.0, residual_scale=1.4 / math.sqrt(2),
        logit_scale=0.25, remat=False,
    )
