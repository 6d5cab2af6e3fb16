"""Whisper-medium — encoder-decoder, conv frontend STUB [arXiv:2212.04356].

24L encoder + 24L decoder, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=51865; encoder input = precomputed frame embeddings (B, 1500, 1024).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", arch_class="encdec", n_layers=24,
        n_encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865, encoder_seq=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", arch_class="encdec", n_layers=2,
        n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, encoder_seq=16, remat=False,
    )
