"""The port's front door: pipeline executors (paper §IV-C).

Port of `repro.dsl.exec`: the concrete executors, the per-pixel
abstract executor and the locked-LRU executor memo.

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

  * `run_abstract` — object arrays of Interval / AffineForm per pixel,
                     on the host (the paper's `typ = Easyval /
                     yalaa::aff_e_d` switch), the per-pixel analysis that
                     validates the combined one in `core.range_analysis`;
  * `make_jitted_fixed` — the band-kernel executor of chosen stages;
  * `make_profile_runner` — ``(image, params) -> float env`` on a
    device, the profile pass's default runner.

Every backend is bit-identical to the reference's numpy oracle
`repro.dsl.exec.run_fixed(backend="numpy")` and returns f64 tensors on
the device.  A leading batch dimension, ``(B, H, W)``, is accepted
everywhere.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.absval import Domain, get_domain
from repro_torch.core.graph import (BinOp, Call, Cmp, Const, Expr, ParamRef,
                                    Pipeline, Pow, Ref, Select,
                                    pipeline_content_hash)
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import static_cmp
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
# executor-memo disposition (an obs counter group: locked, resettable, a
# dict for its readers), named as the reference's
EXEC_CACHE_STATS = obs.CounterGroup("lowering.executor_cache",
                                    hits=0, misses=0, evictions=0)


def executor_cache_key(pipeline: Pipeline, types, params: Dict[str, float],
                       backend: str, column: Optional[str], datapath: str,
                       device: torch.device,
                       outputs: Optional[Sequence[str]] = None) -> tuple:
    """Content key of one compiled executor: (pipeline content hash,
    plan or type-map serialization, params, backend, column, datapath,
    device, outputs)."""
    if hasattr(types, "to_json"):      # DesignTypes / BitwidthPlan
        types_key = types.to_json()
    else:
        types_key = repr(sorted((k, str(v)) for k, v in types.items()))
    return (pipeline_content_hash(pipeline), types_key,
            repr(sorted(params.items())), backend, column, datapath,
            str(device), tuple(outputs) if outputs else None)


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
            EXEC_CACHE_STATS.add("evictions")
    return prev


def clear_executor_cache() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


def lowered_executor(pipeline: Pipeline, types, params: Dict[str, float],
                     backend: str = "cuda", device: DeviceLike = None,
                     column: Optional[str] = None,
                     datapath: str = "exact",
                     outputs: Optional[Sequence[str]] = None) -> Callable:
    """The memoized compiled executor for this content key."""
    from repro_torch.lowering.ir import lower
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    banded = backend in ("cuda", "torch")
    outputs = list(outputs) if outputs and banded else None
    key = executor_cache_key(pipeline, types, params, backend, column,
                             datapath, dev, outputs)
    with _MEMO_LOCK:
        fn = _MEMO.get(key)
        if fn is not None:
            _MEMO.move_to_end(key)           # LRU: a hit is a use
            EXEC_CACHE_STATS.add("hits")
            return fn
        EXEC_CACHE_STATS.add("misses")
        with obs.span("lowering.lower", pipeline=pipeline.name,
                      column=column, n_stages=len(pipeline.stages),
                      datapath=datapath):
            lp = lower(pipeline, types, params=params, column=column,
                       datapath=datapath)
        fn = B.compile_backend(
            lp, backend, device=dev,
            outputs=outputs if banded else list(pipeline.stages))
        while len(_MEMO) >= _MEMO_CAP:
            _MEMO.popitem(last=False)
            EXEC_CACHE_STATS.add("evictions")
        _MEMO[key] = fn
        return fn


def run_fixed(pipeline: Pipeline, image, types,
              params: Dict[str, float] | None = None,
              backend: str = "cuda", column: Optional[str] = None,
              datapath: str = "exact",
              device: DeviceLike = None,
              outputs: Optional[Sequence[str]] = None
              ) -> Dict[str, torch.Tensor]:
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
    ``"cuda"``; it raises without a card): for ``"cuda"``/``"torch"`` the
    pipeline's outputs, or the stages named in `outputs` (each stored
    back from its rate island); every stage for ``"lowered"`` and
    ``"interp"``."""
    run = lowered_executor(pipeline, types, dict(params or {}), backend,
                           device, column, datapath, outputs)
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
        with obs.span("exec.stage", stage=name, input=st.is_input):
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
                    # one datapath type per sampling-lattice residue;
                    # residues missing from the map keep the union type
                    (my, mx), tmap = phase_types[name]
                    out = out.clone()
                    for (ry, rx), t_ph in sorted(tmap.items()):
                        out[ry::my, rx::mx] = _snap(raw[ry::my, rx::mx],
                                                    t_ph)
        env[name] = out.contiguous()
        if obs.runtime_ranges_enabled():
            # read-only: measures the already-snapped stage value, never
            # feeds back into the computation
            obs.runtime.record_stage(
                name, env[name],
                types.get(name) if types is not None else None,
                (phase_types or {}).get(name), backend="interp")
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


# ---------------------------------------------------------------------------
# per-pixel abstract execution (§IV-C framework path), on the host
# ---------------------------------------------------------------------------

def _pad_objects(env: Dict[str, np.ndarray], stage) -> Dict[str, np.ndarray]:
    """Edge-pad each input (an object array) of `stage` by its per-axis
    halo, upsample-expanding first: the oracle's geometry."""
    hy, hx = stage.halo_yx()
    uy, ux = stage.upsample
    padded = {}
    for name in stage.inputs:
        a = env[name]
        if uy > 1 or ux > 1:
            a = np.repeat(np.repeat(a, uy, axis=0), ux, axis=1)
        if hy > 0 or hx > 0:
            a = np.pad(a, ((hy, hy), (hx, hx)), mode="edge")
        padded[name] = a
    return padded


def run_abstract(pipeline: Pipeline, image_shape, domain: str | Domain = "interval",
                 input_ranges: Optional[Dict[str, Interval]] = None,
                 ) -> Dict[str, Dict[str, Any]]:
    """Run the pipeline with per-pixel abstract values (object arrays).

    Every input pixel is a *fresh* abstract signal over the input range, so
    affine forms share noise symbols only through genuine reuse of the same
    pixel — the cancellation-aware analysis the paper gets from YalAA.

    Returns {stage: {"values": object-array, "range": Interval}} where range
    is the join over all pixels (the per-stage combined range).  Runs on
    the host by nature (abstract values are Python objects): the port of
    `repro.dsl.exec.run_abstract`.
    """
    dom = get_domain(domain) if isinstance(domain, str) else domain
    H, W = image_shape
    env: Dict[str, np.ndarray] = {}
    ranges: Dict[str, Interval] = {}
    param_cache: Dict[str, Any] = {}   # one shared signal per scalar parameter

    def abs_u(a): return np.frompyfunc(lambda v: v.abs(), 1, 1)(a)
    def sqrt_u(a): return np.frompyfunc(lambda v: v.sqrt(), 1, 1)(a)
    def min_u(a, b): return np.frompyfunc(lambda x, y: x.min_(y), 2, 1)(a, b)
    def max_u(a, b): return np.frompyfunc(lambda x, y: x.max_(y), 2, 1)(a, b)

    for name in pipeline.topo_order():
        st = pipeline.stages[name]
        if st.is_input:
            rng = (input_ranges or {}).get(name, st.input_range)
            vals = np.empty((H, W), dtype=object)
            for i in range(H):
                for j in range(W):
                    vals[i, j] = dom.fresh_signal(rng)
        else:
            shp = env[st.inputs[0]].shape
            oh = shp[0] * st.upsample[0]
            ow = shp[1] * st.upsample[1]
            padded = _pad_objects(env, st)
            hy, hx = st.halo_yx()

            def go(n: Expr):
                if isinstance(n, Const):
                    return dom.const(n.value)
                if isinstance(n, ParamRef):
                    if n.name not in param_cache:
                        param_cache[n.name] = dom.fresh_signal(pipeline.params[n.name])
                    return param_cache[n.name]
                if isinstance(n, Ref):
                    a = padded[n.stage]
                    return a[hy + n.dy: hy + n.dy + oh,
                             hx + n.dx: hx + n.dx + ow]
                if isinstance(n, BinOp):
                    l, r = go(n.left), go(n.right)
                    if n.op == "+":
                        return l + r
                    if n.op == "-":
                        return l - r
                    if n.op == "*":
                        return l * r
                    return l / r
                if isinstance(n, Pow):
                    return go(n.base) ** n.n
                if isinstance(n, Call):
                    args = [go(a) for a in n.args]
                    if n.fn == "abs":
                        return abs_u(args[0])
                    if n.fn == "sqrt":
                        return sqrt_u(args[0])
                    if n.fn == "min":
                        return min_u(args[0], args[1])
                    return max_u(args[0], args[1])
                if isinstance(n, Select):
                    # abstract select: decide the guard pixel-wise where the
                    # operand ranges separate, join both branches otherwise
                    # (mirrors range_analysis.eval_expr_abstract, so the
                    # combined analysis stays an enclosure of this one)
                    op = n.cond.op

                    def pick(lv, rv, tv, ov):
                        taken = static_cmp(op, dom.to_interval(lv),
                                           dom.to_interval(rv))
                        if taken is True:
                            return tv
                        if taken is False:
                            return ov
                        # legacy domains: select() hook without join()
                        return tv.join(ov) if hasattr(tv, "join") \
                            else tv.select(tv, ov)

                    return np.frompyfunc(pick, 4, 1)(
                        go(n.cond.left), go(n.cond.right),
                        go(n.then), go(n.other))
                if isinstance(n, Cmp):
                    raise ValueError("bare Cmp in abstract eval")
                raise TypeError(type(n))

            vals = go(st.expr)
            vals = np.asarray(vals, dtype=object)
            sy, sx = st.stride
            if sy > 1 or sx > 1:
                vals = vals[::sy, ::sx]

        # join over pixels -> combined stage range
        lo = min(dom.to_interval(v).lo for v in vals.ravel())
        hi = max(dom.to_interval(v).hi for v in vals.ravel())
        env[name] = vals
        ranges[name] = Interval(lo, hi)

    return {n: {"values": env[n], "range": ranges[n]} for n in env}


def make_profile_runner(pipeline: Pipeline,
                        device: DeviceLike = None) -> Callable:
    """``(image, params) -> float env``: the profiling executor's
    interface (`run_float` on `device`)."""

    def runner(image, params):
        return run_float(pipeline, image, params, device=device)

    return runner
