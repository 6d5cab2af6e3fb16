"""Profile-driven calibration — the paper's §V-A on LM tensor classes.

The port's own copy of `repro.quant.calibrate`.  Runs forward passes over
calibration batches and collects per-class absmax (activations) and
per-tensor absmax (weights).  Like the Oxford-Buildings profiling run,
the calibrated ranges are usually FAR tighter than the static interval
analysis, especially for the deep residual stream
(`repro_torch.quant.range_lm` mirrors Table IX's blow-up).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.interval import Interval
from repro_torch.models.common import tree_items
from repro_torch.models.registry import ModelBundle

# tree-path substrings defining the weight classes (the paper's "stages")
WEIGHT_CLASSES = {
    "embed": ("embed",),
    "attn": ("attn", "tmix", "cross", "in_proj", "out_proj", "shared_attn"),
    "mlp": ("mlp", "cmix", "moe", "shared_gate", "shared_up", "shared_down"),
    "unembed": ("unembed",),
}

# classes eligible for quantization, in reverse-topological order
# (output -> input), the order the paper's refinement pass visits stages
REVERSE_TOPO_CLASSES = ["unembed", "mlp", "attn", "embed"]


def classify_path(path: str) -> str | None:
    segs = path.split("/")
    # exact segment match first ("unembed" must not hit the "embed" pattern)
    for cls, pats in WEIGHT_CLASSES.items():
        if any(p in segs for p in pats):
            return cls
    for cls, pats in WEIGHT_CLASSES.items():
        if any(p in path for p in pats):
            return cls
    return None


def _path_str(path) -> str:
    """A tree path as the reference writes it: keys joined by '/'."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def weight_stats(params) -> Dict[str, Dict[str, float]]:
    """Per-class weight absmax + rms (profile analysis of the weights)."""
    stats: Dict[str, Dict[str, float]] = {}
    for path, leaf in tree_items(params):
        cls = classify_path(_path_str(path))
        if cls is None or leaf.ndim < 2:
            continue
        s = stats.setdefault(cls, {"absmax": 0.0, "rms": 0.0, "n": 0})
        s["absmax"] = max(s["absmax"], float(leaf.abs().amax()))
        # the f32 mean's square root in f32, correctly rounded
        s["rms"] += float(np.sqrt(np.float32(float(leaf.square().mean()))))
        s["n"] += 1
    for s in stats.values():
        s["rms"] /= max(s["n"], 1)
    return stats


def activation_stats(bundle: ModelBundle, params,
                     batches: Sequence[Dict]) -> Dict[str, Interval]:
    """Calibrated activation ranges: logits + residual stream absmax."""
    lo: Dict[str, float] = {}
    hi: Dict[str, float] = {}

    def upd(name, arr):
        a = arr.float()
        lo[name] = min(lo.get(name, float("inf")), float(a.amin()))
        hi[name] = max(hi.get(name, float("-inf")), float(a.amax()))

    for b in batches:
        upd("logits", bundle.forward(params, b))
    return {k: Interval(lo[k], hi[k]) for k in lo}


def calibrated_ranges(bundle: ModelBundle, params,
                      batches: Sequence[Dict]) -> Dict[str, Interval]:
    """Static weight-based ranges refined by activation probes."""
    from repro_torch.quant.range_lm import static_ranges
    ranges = dict(static_ranges(params, bundle.cfg))
    ranges.update(activation_stats(bundle, params, batches))
    return ranges
