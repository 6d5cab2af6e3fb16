"""Synthetic batch construction + (shape, dtype) input specs per arch.

The port's own copy of `repro.data.batches`.  `make_batch` draws from
`numpy.random.default_rng(seed)` exactly as the reference does, so both
packages see the same tokens, and puts them on `device` (None: the card);
`batch_shapes` returns (shape, dtype) pairs only (nothing allocated).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


def batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    shapes: Dict = {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }
    if cfg.arch_class == "vlm":
        shapes["patch_embeds"] = (
            (batch, cfg.n_image_tokens, cfg.d_model), torch.float32)
    if cfg.arch_class == "encdec":
        shapes["frames"] = ((batch, cfg.encoder_seq, cfg.d_model),
                            torch.float32)
    return shapes


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device=None) -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    out: Dict = {
        "tokens": put(rng.integers(0, cfg.vocab_size, (batch, seq)),
                      np.int32),
        "labels": put(rng.integers(0, cfg.vocab_size, (batch, seq)),
                      np.int32),
    }
    if cfg.arch_class == "vlm":
        out["patch_embeds"] = put(
            rng.normal(size=(batch, cfg.n_image_tokens, cfg.d_model)) * 0.02,
            np.float32)
    if cfg.arch_class == "encdec":
        out["frames"] = put(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.02,
            np.float32)
    return out


class TokenStream:
    """Deterministic sharded synthetic token pipeline.

    Each data shard draws from a seed derived from (epoch, step, shard), so
    restarts and elastic re-sharding reproduce the same global batch order.
    """

    def __init__(self, cfg: ModelConfig, global_batch: int, seq: int,
                 n_shards: int = 1, shard_id: int = 0, seed: int = 1234,
                 device=None):
        assert global_batch % n_shards == 0
        self.cfg = cfg
        self.local_batch = global_batch // n_shards
        self.seq = seq
        self.shard_id = shard_id
        self.seed = seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict:
        return make_batch(self.cfg, self.local_batch, self.seq,
                          seed=hash((self.seed, step, self.shard_id)) % (2**31),
                          device=self.device)
