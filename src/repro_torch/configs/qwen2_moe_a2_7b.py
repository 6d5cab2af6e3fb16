"""Qwen1.5/2-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048, 16H (kv=16), expert d_ff=1408, shared-expert ff=5632
(= 4 x 1408), vocab=151936.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", arch_class="moe", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408,
        vocab_size=151936, n_experts=60, top_k=4, moe_d_ff=1408,
        shared_expert_d_ff=5632,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2moe-smoke", arch_class="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512,
        n_experts=6, top_k=2, moe_d_ff=64, shared_expert_d_ff=128,
        remat=False,
    )
