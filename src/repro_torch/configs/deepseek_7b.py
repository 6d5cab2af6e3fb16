"""DeepSeek-LLM 7B — llama-architecture dense [arXiv:2401.02954].

30L d_model=4096, 32H (kv=32, i.e. MHA), d_ff=11008, vocab=102400.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", arch_class="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", arch_class="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=192, vocab_size=512, remat=False,
    )
