"""Uniform model interface (port of `repro.models.registry`).

`get_model` builds the dense, MoE, VLM and RWKV6 decoders and whisper's
encoder-decoder; the hybrid raises `NotImplementedError` naming the
ROADMAP item that ports it.
`params_from_numpy` carries parameters (or a decode state) made by the
JAX package, as numpy arrays in the same nested dict, into the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.common import ModelConfig, tree_map


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    param_specs: Callable[[], Dict]
    init_params: Callable[[torch.Generator], Dict]
    param_axes: Callable[[], Dict]
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    forward: Callable  # (params, batch) -> logits
    # (batch, max_len, prefill_len=0, device=None) -> state
    init_decode_state: Callable
    decode_step: Callable  # (params, token, state) -> (logits, state)


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.arch_class == "encdec":
        return ModelBundle(
            cfg=cfg,
            param_specs=lambda: encdec.param_specs(cfg),
            init_params=lambda generator: encdec.init_params(cfg, generator),
            param_axes=lambda: encdec.param_axes(cfg),
            loss_fn=lambda p, b: encdec.loss_fn(p, b, cfg),
            forward=lambda p, b: encdec.forward(p, b, cfg),
            init_decode_state=lambda bs, ml, pl=0, device=None:
                encdec.init_decode_state(cfg, bs, ml, pl, device=device),
            decode_step=lambda p, t, s: encdec.decode_step(p, t, s, cfg),
        )
    lm._check_ported(cfg)
    return ModelBundle(
        cfg=cfg,
        param_specs=lambda: lm.param_specs(cfg),
        init_params=lambda generator: lm.init_params(cfg, generator),
        param_axes=lambda: lm.param_axes(cfg),
        loss_fn=lambda p, b: lm.loss_fn(p, b, cfg),
        forward=lambda p, b: lm.forward(
            p, b["tokens"], cfg, patch_embeds=b.get("patch_embeds")),
        init_decode_state=lambda bs, ml, pl=0, device=None:
            lm.init_decode_state(cfg, bs, ml, pl, device=device),
        decode_step=lambda p, t, s: lm.decode_step(p, t, s, cfg),
    )


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(arr, copy=True).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The same nested dict with every array (numpy, or anything
    `np.asarray` takes, bf16 included) as a tensor of its dtype and shape
    on `device` (None: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)
