"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

32L d_model=4096, 32H (kv=8), expert d_ff=14336, vocab=32000, SWA 4096.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", arch_class="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2, moe_d_ff=14336, sliding_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", arch_class="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
        n_experts=4, top_k=2, moe_d_ff=128, sliding_window=16, remat=False,
    )
