"""Phi-3-medium 14B — RoPE + SwiGLU + GQA [arXiv:2404.14219].

40L d_model=5120, 40H (kv=10), d_ff=17920, vocab=100352.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", arch_class="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab_size=100352,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", arch_class="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=224, vocab_size=512, remat=False,
    )
