"""The port's front door: `run_fixed` over the fused band-kernel executor.

Port of `repro.dsl.exec.run_fixed` (its lowered backends) and of the
locked-LRU executor memo.  Backends:

  * ``"cuda"``  — the band kernel, `kernels/stencil/csrc/fused_band.cu`,
    one launch per rate island (on a CPU device the kernel wrapper runs
    its plain version);
  * ``"torch"`` — the same executor with the kernel's plain PyTorch
    version, the CPU tests' path and the card's check of the kernel.

Both are bit-identical to the reference's numpy oracle
`repro.dsl.exec.run_fixed(backend="numpy")` and return the pipeline's
output stages as f64 tensors on the device.  A leading batch dimension,
``(B, H, W)``, runs as one batched program.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict

import torch

from repro_torch.core.graph import Pipeline
from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("cuda", "torch")

# Compiled executors, keyed on content (pipeline, types, params,
# backend, device) so mutated pipelines or type maps never hit stale
# entries.  LRU with a small cap.  Every access holds the
# lock, the compile included: concurrent `run_fixed` calls on one key
# (the pipeline server's worker and its callers) compile exactly once.
_MEMO: "OrderedDict[tuple, Callable]" = OrderedDict()
_MEMO_LOCK = threading.RLock()
_MEMO_CAP = 16
EXEC_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def pipeline_content_hash(pipeline: Pipeline) -> str:
    """Stable content hash over stages, params and outputs (the port's
    copy of `repro.analysis.driver.pipeline_content_hash`)."""
    h = hashlib.sha256()
    for name in sorted(pipeline.stages):
        st = pipeline.stages[name]
        h.update(repr((st.name, st.inputs, st.stride, st.upsample,
                       st.is_input, st.input_range, st.expr)).encode())
    h.update(repr(sorted(pipeline.params.items(),
                         key=lambda kv: kv[0])).encode())
    h.update(repr(list(pipeline.outputs)).encode())
    return h.hexdigest()[:16]


def executor_cache_key(pipeline: Pipeline, types, params: Dict[str, float],
                       backend: str, device: torch.device) -> tuple:
    if hasattr(types, "to_json"):          # DesignTypes / plan: serialized
        types_key = types.to_json()
    else:
        types_key = repr(sorted((k, str(v)) for k, v in types.items()))
    return (pipeline_content_hash(pipeline), types_key,
            repr(sorted(params.items())), backend, str(device))


def clear_executor_cache() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


def lowered_executor(pipeline: Pipeline, types, params: Dict[str, float],
                     backend: str = "cuda",
                     device: DeviceLike = None) -> Callable:
    """The memoized compiled executor for this content key."""
    from repro_torch.lowering.cuda_backend import compile_cuda
    from repro_torch.lowering.ir import lower
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    key = executor_cache_key(pipeline, types, params, backend, dev)
    with _MEMO_LOCK:
        fn = _MEMO.get(key)
        if fn is not None:
            _MEMO.move_to_end(key)           # LRU: a hit is a use
            EXEC_CACHE_STATS["hits"] += 1
            return fn
        EXEC_CACHE_STATS["misses"] += 1
        lp = lower(pipeline, types, params=params)
        fn = compile_cuda(lp, device=dev, plain=backend == "torch")
        while len(_MEMO) >= _MEMO_CAP:
            _MEMO.popitem(last=False)
            EXEC_CACHE_STATS["evictions"] += 1
        _MEMO[key] = fn
        return fn


def run_fixed(pipeline: Pipeline, image, types,
              params: Dict[str, float] | None = None,
              backend: str = "cuda",
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Bit-accurate fixed-point design (saturating, round-half-even).

    `types` is a per-stage type map or a design with per-residue phase
    types (`pipelines.types.DesignTypes`).  `image` is an array or
    tensor, a tuple, or a dict by input stage; (H, W) or (B, H, W); f64
    pixel values, or tensors already in the input stage's container
    (pre-quantized, used as they are).  Returns ``{output: f64 tensor}``
    on `device` (default ``"cuda"``; it raises without a card)."""
    run = lowered_executor(pipeline, types, dict(params or {}), backend,
                           device)
    return run(image)
