"""Qwen3-4B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family].

36L d_model=2560, 32 q-heads / 8 kv-heads, head_dim=128, d_ff=9728,
vocab=151936.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", arch_class="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
        vocab_size=151936, qk_norm=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", arch_class="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
        qk_norm=True, remat=False,
    )
