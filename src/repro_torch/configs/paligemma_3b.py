"""PaliGemma-3B — SigLIP vision frontend (STUB) + Gemma decoder
[arXiv:2407.07726].

18L d_model=2048, 8H (kv=1, MQA), head_dim=256, d_ff=16384, vocab=257216.
The image prefix (256 patch embeddings, precomputed by the stubbed SigLIP)
attends bidirectionally (prefix-LM mask).
"""
import math

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", arch_class="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=257216, n_image_tokens=256,
        emb_scale=math.sqrt(2048.0),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", arch_class="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=256, vocab_size=512,
        n_image_tokens=8, emb_scale=8.0, remat=False,
    )
