"""AutoQuant: the paper's bit-width synthesis loop applied to LM weights.

The port's own copy of `repro.quant.autoquant`.  Pipeline (mirrors paper
Fig. 4):
  1. static alpha-analysis of tensor classes (`range_lm`)          — §IV-B
  2. profile calibration over probe batches (`calibrate`)          — §V-A
  3. bit-width search against a quality target, reusing the SAME
     `core.beta_search.uniform_beta_search` + a reverse-topological
     per-class refinement                                          — §V-B
  4. legalization to integer containers + quantized parameter store

Quality metric = top-1 token agreement with the bf16 reference (the LM
analogue of HCD's "% correctly classified corners").  Search space is
weight bits in [2, 8] per class ("beta" = bits here: more bits = more
fractional resolution at fixed range, exactly the paper's knob).
The forward passes run where the parameters are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.beta_search import refine_sequence, uniform_beta_search
from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.registry import ModelBundle
from repro_torch.quant.calibrate import (REVERSE_TOPO_CLASSES, classify_path,
                                         _path_str)
from repro_torch.quant.qtypes import dequantize_symmetric, quantize_symmetric

MAX_BITS = 8          # int8 container ceiling
MIN_BITS = 2


def fake_quant_params(params, bits_per_class: Dict[str, int]):
    """Per-channel symmetric fake-quant of every weight in a chosen class."""

    def one(path, leaf):
        cls = classify_path(_path_str(path))
        if cls is None or cls not in bits_per_class or leaf.ndim < 2:
            return leaf
        bits = bits_per_class[cls]
        if bits >= 16:
            return leaf
        q, s = quantize_symmetric(leaf, bits=bits, axis=-1)
        return dequantize_symmetric(q, s).to(leaf.dtype)

    return tree_map(one, params, with_path=True)


def quantize_params_store(params, bits_per_class: Dict[str, int]):
    """True quantized store: {path: ("quant", (codes, scales))} or
    {path: ("raw", leaf)}.

    This is what serving would keep in device memory (4x fewer bytes for
    int8 than f32, the paper's memory win)."""
    store = {}
    for path, leaf in tree_items(params):
        p = _path_str(path)
        cls = classify_path(p)
        if cls is None or cls not in bits_per_class or leaf.ndim < 2:
            store[p] = ("raw", leaf)
        else:
            store[p] = ("quant", quantize_symmetric(
                leaf, bits=bits_per_class[cls], axis=-1))
    return store


def token_agreement(ref_logits, test_logits) -> float:
    a = ref_logits.argmax(-1)
    b = test_logits.argmax(-1)
    return float((a == b).double().mean())


@dataclasses.dataclass
class AutoQuantResult:
    bits: Dict[str, int]
    quality: float                 # final token agreement
    profile_passes: int
    uniform_bits: int
    bytes_ratio: float             # quantized bytes / bf16 bytes


def autoquant(bundle: ModelBundle, params, probe_batches: Sequence[Dict],
              target_agreement: float = 0.98,
              classes: Optional[List[str]] = None) -> AutoQuantResult:
    classes = classes or list(REVERSE_TOPO_CLASSES)
    fwd = bundle.forward
    refs = [fwd(params, b) for b in probe_batches]
    passes = 0

    def quality(bits_map: Dict[str, int]) -> float:
        nonlocal passes
        passes += 1
        qp = fake_quant_params(params, bits_map)
        agree = [token_agreement(r, fwd(qp, b))
                 for r, b in zip(refs, probe_batches)]
        return float(np.mean(agree))

    # phase 1: uniform bit search (binary, few passes — paper §V-B)
    # quality is monotone in bits; search bits in [MIN_BITS, MAX_BITS]
    def q_of_uniform(m: Dict[str, int]) -> float:
        b = next(iter(m.values()))
        return quality({c: MIN_BITS + b for c in classes})

    span = MAX_BITS - MIN_BITS
    offset, p1 = uniform_beta_search(classes, q_of_uniform,
                                     target_agreement, beta_hi=span)
    uniform_bits = MIN_BITS + offset
    bits = {c: uniform_bits for c in classes}

    # phase 2: reverse-topological per-class refinement — the same §V-B
    # kernel the pipeline beta search uses (`core.beta_search`), with the
    # int8-container floor as the search's lower bound
    bits, _ = refine_sequence(classes, bits, quality, target_agreement,
                              beta_lo=MIN_BITS)

    final_q = quality(bits)
    # bytes: bits/16 per quantized class, uniform-weighted approximation
    ratio = float(np.mean([bits[c] / 16.0 for c in classes]))
    return AutoQuantResult(bits=bits, quality=final_q,
                           profile_passes=passes + p1,
                           uniform_bits=uniform_bits, bytes_ratio=ratio)
