"""Fused band-kernel executor over the lowered IR.

Port of `repro.lowering.pallas_backend` (`island_program`,
`compile_pallas`).  A `LoweredPipeline` and an image shape compile into
a chain of band-kernel launches, one per rate island
(`lowering.islands.partition_islands`).  Islands hand off through
boundary buffers kept on the device in each boundary stage's legalized
container (`backends.store_dtype`), and the requested outputs (the
pipeline's, or any stages named) are dequantized to f64 on return.
Everything is bit-identical to the reference's numpy oracle
`repro.dsl.exec.run_fixed(backend="numpy")`.

`compile_cuda(..., plain=False)` launches `kernels/stencil/csrc/
fused_band.cu` on a CUDA device; ``plain=True`` runs the kernel's plain
PyTorch version on the same encoded tables instead (the ``"torch"``
backend of `dsl.exec.run_fixed`).  On a CPU device both run the plain
version, because the kernel wrapper dispatches on the tensors' device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stencil.kernel import (EncodedProgram,
                                                encode_program,
                                                fused_pipeline,
                                                fused_pipeline_reference)
from repro_torch.lowering import backends as B
from repro_torch.lowering.ir import LoweredPipeline, LoweringError
from repro_torch.lowering.islands import Island, partition_islands


def island_program(lp: LoweredPipeline, isl: Island) -> List[Dict]:
    """Stage descriptors for one island, in the reference's order.

    The same dicts as `repro.lowering.pallas_backend.island_program`
    (geometry, stored container, input/output slots), with the
    `LoweredStage` and the baked parameters in place of jnp closures:
    `kernels.stencil.kernel.encode_program` turns them into tables."""
    program = []
    slot = {n: i for i, n in enumerate(isl.inputs)}
    for n in isl.schedule.order:
        ss = isl.schedule.stages[n]
        ls = lp.stages[n]
        d = dict(name=n, step=ss.step, lo=ss.lo, L=ss.L, H=ss.H, W=ss.W,
                 dtype=B.store_dtype(ls), ls=ls)
        if n in slot:
            d.update(kind="input", in_slot=slot[n])
        else:
            d.update(kind="compute", params=lp.params)
        program.append(d)
    # an input stage asked for as an output is stored already: the kernel
    # writes only compute stages
    for out_slot, n in enumerate(_written(lp, isl)):
        for d in program:
            if d["name"] == n:
                d["out_slot"] = out_slot
    return program


def _island_attrs(lp: LoweredPipeline, isl: Island) -> Dict:
    """The `exec.cuda.island` span's attributes (the reference's
    `exec.pallas.island`): geometry, datapath and container census, and
    the boundary bytes one image stores."""
    out_b, saved_b = isl.boundary_bytes(lp)
    return dict(island=isl.idx, rate=str(isl.rate), stages=len(isl.stages),
                grid=isl.schedule.grid, single_tile=isl.single_tile,
                carriers=isl.carrier_mix(lp), containers=isl.stored_mix(lp),
                out_mb=round(out_b / 1e6, 4), saved_mb=round(saved_b / 1e6, 4))


def _written(lp: LoweredPipeline, isl: Island) -> List[str]:
    """The island's outputs the kernel writes, in its output slots."""
    return [n for n in isl.outputs if not lp.stages[n].stage.is_input]


def ingest_images(lp: LoweredPipeline, image, input_names: Sequence[str],
                  dev: torch.device) -> Tuple[Dict[str, torch.Tensor],
                                              Tuple[int, ...]]:
    """`image` (run_fixed's conventions: array, tuple or dict; numpy or
    torch; (H, W) or (B, H, W)) as the input stages' stored tiles on
    `dev`, and the frames' common shape.  Container-dtype frames are
    pre-quantized stored tiles (zero-copy); others quantize from f64 on
    the device."""
    imgs, names = B.normalize_images(lp, image)
    img_of = dict(zip(names, imgs))
    buffers: Dict[str, torch.Tensor] = {}
    shape = None
    for n in input_names:
        x = img_of[n]
        x = torch.from_numpy(np.asarray(x)) \
            if not isinstance(x, torch.Tensor) else x
        if x.ndim not in (2, 3):
            raise LoweringError(f"images must be (H, W) or (B, H, W); "
                                f"got {tuple(x.shape)}")
        if shape is None:
            shape = tuple(x.shape)
        elif tuple(x.shape) != shape:
            raise LoweringError(f"all pipeline inputs must share one "
                                f"shape; got {shape} vs "
                                f"{tuple(x.shape)}")
        x = x.to(dev, non_blocking=True)
        buffers[n] = B.ingest_input(x.contiguous(), lp.stages[n])
    return buffers, shape


def compile_cuda(lp: LoweredPipeline, device: DeviceLike = None,
                 plain: bool = False,
                 outputs: Optional[Sequence[str]] = None,
                 tile_rows: Optional[int] = None) -> B.Executor:
    """Shape-specialized executor: the island plan and its encoded
    programs are built (and cached) per input shape on first call.
    `tile_rows` forces the whole-DAG schedule at that tile height
    (`islands.partition_islands`).

    The executor takes an image as run_fixed does (array, tuple or
    dict; numpy or torch; (H, W) or (B, H, W)) and returns
    ``{stage: f64 tensor on the device}`` for each of `outputs`
    (default: the pipeline's outputs), each an island output."""
    dev = resolve_device(device)
    outs = list(outputs or lp.pipeline.outputs)
    order = B.needed_stages(lp, outs)
    input_names = [n for n in order if lp.stages[n].stage.is_input]
    kernel = fused_pipeline_reference if plain else fused_pipeline
    backend = "torch" if plain else "cuda"
    cache: Dict[tuple, List[Tuple[Island, EncodedProgram, Dict]]] = {}
    lock = threading.Lock()

    def build(shape) -> List[Tuple[Island, EncodedProgram, Dict]]:
        B.check_stage_shapes(lp, shape[-2:])
        plan = partition_islands(lp, tuple(shape[-2:]), outputs=outs,
                                 tile_rows=tile_rows)
        return [(isl, encode_program(island_program(lp, isl)),
                 _island_attrs(lp, isl)) for isl in plan.islands]

    def run(image) -> Dict[str, torch.Tensor]:
        buffers, shape = ingest_images(lp, image, input_names, dev)
        batch = shape[0] if len(shape) == 3 else None
        with obs.span("exec.cuda", backend=backend,
                      pipeline=lp.pipeline.name, outputs=len(outs)) as sp:
            if batch is not None:
                sp.set(batch=batch)
            with lock:
                if shape not in cache:
                    sp.set(kernel_cache="miss")
                    with obs.span("lowering.encode",
                                  pipeline=lp.pipeline.name, shape=shape):
                        cache[shape] = build(shape)
                else:
                    sp.set(kernel_cache="hit")
                compiled = cache[shape]
            sp.set(islands=len(compiled))
            for isl, enc, attrs in compiled:
                call = kernel(enc, isl.schedule.grid, batch)
                with obs.span("exec.cuda.island", **attrs):
                    for n, arr in zip(_written(lp, isl),
                                      call(*[buffers[n]
                                             for n in isl.inputs])):
                        buffers[n] = arr
            res = {n: B.dequant(lp.stages[n], buffers[n]) for n in outs}
        # the band kernel keeps intermediates in its bands, so telemetry
        # covers the island boundaries asked for and the outputs only
        obs.runtime.record_env(res, lp, backend=backend)
        return res

    run.lowered = lp
    return run
