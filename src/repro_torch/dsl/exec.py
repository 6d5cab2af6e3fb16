"""The port's front door: pipeline executors (paper §IV-C).

Port of `repro.dsl.exec`: the concrete executors and the locked-LRU
executor memo.

  * `run_float`    — the f64 float design (the paper's `typ = float`);
  * `run_fixed`    — bit-accurate (alpha, beta) fixed point with
                     saturation, through one of four backends:

    - ``"cuda"``    the band kernel, `kernels/stencil/csrc/fused_band.cu`,
      one launch per rate island (on a CPU device the kernel wrapper
      runs its plain version);
    - ``"torch"``   the same executor with the kernel's plain PyTorch
      version, the CPU tests' path and the card's check of the kernel;
    - ``"lowered"`` one whole-frame torch program
      (`lowering.backends.compile_lowered`, the reference's
      ``"lowered"``), returning every stage;
    - ``"interp"``  the per-stage f64 walk (`lowering.backends.
      compile_interp` over `_run_concrete`), the port of the reference's
      numpy oracle, returning every stage;

  * `make_jitted_fixed` — the band-kernel executor of chosen stages;
  * `make_profile_runner` — ``(image, params) -> float env``.

Every backend is bit-identical to the reference's numpy oracle
`repro.dsl.exec.run_fixed(backend="numpy")` and returns f64 tensors on
the device.  A leading batch dimension, ``(B, H, W)``, is accepted
everywhere.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import Pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.lowering import backends as B

BACKENDS = ("cuda", "torch", "lowered", "interp")

# Compiled executors, keyed on content (pipeline, types, params,
# backend, column, datapath, device) so mutated pipelines or type maps
# never hit stale entries.  LRU with a small cap.  Every access holds
# the lock, the compile included: concurrent `run_fixed` calls on one
# key (the pipeline server's worker and its callers) compile exactly
# once.
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
                       backend: str, column: Optional[str], datapath: str,
                       device: torch.device) -> tuple:
    """Content key of one compiled executor: (pipeline content hash,
    plan or type-map serialization, params, backend, column, datapath,
    device)."""
    if hasattr(types, "to_json"):      # DesignTypes / BitwidthPlan
        types_key = types.to_json()
    else:
        types_key = repr(sorted((k, str(v)) for k, v in types.items()))
    return (pipeline_content_hash(pipeline), types_key,
            repr(sorted(params.items())), backend, column, datapath,
            str(device))


def set_executor_cache_cap(cap: int) -> int:
    """Set the executor memo's capacity (default 16); returns the
    previous one.  Shrinking evicts least recently used entries now."""
    global _MEMO_CAP
    if cap < 1:
        raise ValueError(f"executor cache cap must be >= 1, got {cap}")
    with _MEMO_LOCK:
        prev, _MEMO_CAP = _MEMO_CAP, cap
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)
            EXEC_CACHE_STATS["evictions"] += 1
    return prev


def clear_executor_cache() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


def lowered_executor(pipeline: Pipeline, types, params: Dict[str, float],
                     backend: str = "cuda", device: DeviceLike = None,
                     column: Optional[str] = None,
                     datapath: str = "exact") -> Callable:
    """The memoized compiled executor for this content key."""
    from repro_torch.lowering.cuda_backend import compile_cuda
    from repro_torch.lowering.ir import lower
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    key = executor_cache_key(pipeline, types, params, backend, column,
                             datapath, dev)
    with _MEMO_LOCK:
        fn = _MEMO.get(key)
        if fn is not None:
            _MEMO.move_to_end(key)           # LRU: a hit is a use
            EXEC_CACHE_STATS["hits"] += 1
            return fn
        EXEC_CACHE_STATS["misses"] += 1
        lp = lower(pipeline, types, params=params, column=column,
                   datapath=datapath)
        if backend in ("cuda", "torch"):
            fn = compile_cuda(lp, device=dev, plain=backend == "torch")
        else:
            compile_ = (B.compile_lowered if backend == "lowered"
                        else B.compile_interp)
            fn = compile_(lp, outputs=list(pipeline.stages), device=dev)
        while len(_MEMO) >= _MEMO_CAP:
            _MEMO.popitem(last=False)
            EXEC_CACHE_STATS["evictions"] += 1
        _MEMO[key] = fn
        return fn


def run_fixed(pipeline: Pipeline, image, types,
              params: Dict[str, float] | None = None,
              backend: str = "cuda", column: Optional[str] = None,
              datapath: str = "exact",
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Bit-accurate fixed-point design (saturating, round-half-even).

    `types` is a per-stage type map, a design with per-residue phase
    types (`pipelines.types.DesignTypes`) or a `BitwidthPlan`
    (`analysis.plan`), whose `column` (default: its default column)
    gives the types.  `datapath` is ``"exact"`` or ``"narrow"`` (int32 /
    f32 datapaths where the lowering proves them exact); both give the
    same values.  `image` is an array or tensor, a tuple, or a dict by
    input stage; (H, W) or (B, H, W); f64 pixel values, or tensors
    already in the input stage's container (pre-quantized, used as they
    are).  Returns ``{stage: f64 tensor}`` on `device` (default
    ``"cuda"``; it raises without a card): the pipeline's outputs for
    ``"cuda"``/``"torch"``, every stage for ``"lowered"``/``"interp"``."""
    run = lowered_executor(pipeline, types, dict(params or {}), backend,
                           device, column, datapath)
    return run(image)


def make_jitted_fixed(pipeline: Pipeline, types, params: Dict[str, float],
                      outputs: Optional[Sequence[str]] = None,
                      device: DeviceLike = None) -> Callable:
    """The band-kernel executor of `outputs` (default: the pipeline's),
    each stored back from its rate island; the reference's name for its
    compiled executor.  Not memoized: each call compiles anew."""
    from repro_torch.lowering.cuda_backend import compile_cuda
    from repro_torch.lowering.ir import lower
    return compile_cuda(lower(pipeline, types, params=params),
                        device=device, outputs=outputs or None)


# ---------------------------------------------------------------------------
# the per-stage walk (float and fixed), on f64 tensors
# ---------------------------------------------------------------------------

def _snap(out: torch.Tensor, t) -> torch.Tensor:
    """The oracle's snap: rint, clip, rescale, in f64."""
    step = 2.0 ** t.beta
    return torch.clamp(torch.round(out * step), float(t.int_min),
                       float(t.int_max)) / step


def _run_concrete(pipeline: Pipeline, image, params: Dict[str, float],
                  types=None, phase_types=None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Every stage of one (H, W) image, stage by stage in f64: edge-clamp
    padding, upsampling by nearest expansion, decimation after the
    stage; with `types`, each stage snapped onto its grid (each residue
    of `phase_types` on its own).  The port of
    `repro.dsl.exec._run_concrete` on the numpy backend."""
    dev = resolve_device(device)
    env: Dict[str, torch.Tensor] = {}
    input_names = pipeline.input_stages()
    if isinstance(image, dict):
        inputs = image
    elif isinstance(image, (tuple, list)):
        inputs = dict(zip(input_names, image))
    else:
        inputs = {input_names[0]: image}
    for name in pipeline.topo_order():
        st = pipeline.stages[name]
        if st.is_input:
            x = inputs[name]
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.asarray(x))
            out = x.to(dev, torch.float64)
        else:
            H, W = env[st.inputs[0]].shape
            H, W = H * st.upsample[0], W * st.upsample[1]
            hy, hx = st.halo_yx()
            padded = {i: B.upsample_pad(env[i], st.upsample, (hy, hx))
                      for i in st.inputs}
            out = B.eval_tensor_expr(
                st.expr, lambda s, dy, dx: padded[s][
                    hy + dy:hy + dy + H, hx + dx:hx + dx + W],
                params, torch.float64, (H, W), dev)
            sy, sx = st.stride
            out = out[::sy, ::sx]
        if types is not None:
            t = types.get(name)
            raw = out
            if t is not None:
                out = _snap(raw, t)
            if phase_types is not None and name in phase_types:
                # one datapath type per sampling-lattice residue; residues
                # missing from the map keep the union type applied above
                (my, mx), tmap = phase_types[name]
                out = out.clone()
                for (ry, rx), t_ph in sorted(tmap.items()):
                    out[ry::my, rx::mx] = _snap(raw[ry::my, rx::mx], t_ph)
        env[name] = out.contiguous()
    return env


def run_float(pipeline: Pipeline, image,
              params: Dict[str, float] | None = None,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The float design in f64: every stage unsnapped, ``{stage: f64
    tensor}`` on `device`.  A (B, H, W) batch runs image by image."""
    names = pipeline.input_stages()
    if isinstance(image, dict):
        arrs = [image[n] for n in names]
    elif isinstance(image, (tuple, list)):
        arrs = list(image)
    else:
        arrs = [image]
    if all(a.ndim == 3 for a in arrs):
        per = [_run_concrete(pipeline, [a[b] for a in arrs], params or {},
                             device=device)
               for b in range(len(arrs[0]))]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return _run_concrete(pipeline, arrs, params or {}, device=device)


def make_profile_runner(pipeline: Pipeline,
                        device: DeviceLike = None) -> Callable:
    """``(image, params) -> float env``: the profiling executor's
    interface (`run_float` on `device`)."""

    def runner(image, params):
        return run_float(pipeline, image, params, device=device)

    return runner
