"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 (heads = 2560/64 = 40), d_ff=8960 (3.5x), vocab=65536.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", arch_class="rwkv", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=8960, vocab_size=65536,
        rwkv_head_dim=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", arch_class="rwkv", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=224, vocab_size=512, rwkv_head_dim=32,
        remat=False,
    )
