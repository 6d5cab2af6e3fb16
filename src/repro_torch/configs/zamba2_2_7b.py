"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, ssm_state=64 (d_inner=5120, 80 ssm-heads of
dim 64); ONE shared transformer block (32H, d_ff=10240) applied every 6
layers with shared weights.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", arch_class="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, shared_attn_period=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", arch_class="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, shared_attn_period=2,
        remat=False,
    )
