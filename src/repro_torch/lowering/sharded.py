"""Band-sharded execution of the lowered island plan over a device mesh.

Port of `repro.lowering.sharded`.  The ``"cuda"`` backend walks each
rate island's row-band schedule in one launch of the band kernel; this
backend splits the same band walk over the devices of a 1-D mesh
(`launch.mesh.make_band_mesh`, axis ``"band"``): device ``d`` launches
`kernels/stencil/csrc/fused_band.cu` for band steps ``[d*k, (d+1)*k)``
(``k = grid // n_shards``), on its own current stream, with the island's
boundary inputs replicated to it, and the shard outputs are joined
along rows on the mesh's first device, where they are the boundary
buffers of the next island.  Bands are the unit of the split as they
are the unit of the kernel's work.

Bit-exactness is by construction: every shard runs the same encoded
program (`lowering.cuda_backend.island_program`, `encode_program`)
through the same band geometry as the whole launch, and every band's
value depends only on the replicated inputs, so the joined rows are the
whole walk's.  On a CPU mesh each shard runs the kernel's plain
version.

Fallback (one `RuntimeWarning` via `obs.warn_once`, in the reference's
words): an island whose grid the mesh does not divide, or a single-tile
island, runs the whole band walk in one launch on the mesh's first
device; the same kernel, never another datapath and never another
device.  A 1080-row frame is 135 bands of 8 rows, which no mesh of 2 or
4 devices divides.

Images with a leading batch dimension ``(B, H, W)`` run as one launch
per shard, the batch axis replicated.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.device import DeviceLike
from repro_torch.kernels.stencil.kernel import (EncodedProgram,
                                                encode_program,
                                                fused_pipeline)
from repro_torch.launch.mesh import BandMesh, make_band_mesh
from repro_torch.launch.sharding import spec_for
from repro_torch.lowering import backends as B
from repro_torch.lowering.cuda_backend import (_written, ingest_images,
                                               island_program)
from repro_torch.lowering.ir import LoweredPipeline, LoweringError
from repro_torch.lowering.islands import Island, partition_islands

# one island as run: its plan, encoded program, band grid, whether it is
# split over the mesh, and the row axis each written stage joins along
Compiled = Tuple[Island, EncodedProgram, int, bool, List[int]]


def compile_sharded(lp: LoweredPipeline,
                    outputs: Optional[Sequence[str]] = None,
                    mesh: Optional[BandMesh] = None,
                    tile_rows: Optional[int] = None,
                    device: DeviceLike = None) -> B.Executor:
    """Band-sharded executor over `mesh` (default: every device of
    `device`'s kind present, `make_band_mesh(device=device)`, made at
    each call as the reference makes it).

    Shape-specialized like `compile_cuda`: the island plan and its
    encoded programs are built (and cached) per input shape and mesh on
    first call.  Returns ``{output: f64 tensor}`` on the mesh's first
    device for the pipeline's outputs (or `outputs`)."""
    outs = list(outputs or lp.pipeline.outputs)
    order = B.needed_stages(lp, outs)
    input_names = [n for n in order if lp.stages[n].stage.is_input]
    cache: Dict[tuple, List[Compiled]] = {}
    lock = threading.Lock()

    def compile_island(isl: Island, m: BandMesh,
                       batch: Optional[int]) -> Compiled:
        enc = encode_program(island_program(lp, isl))
        grid = isl.schedule.grid
        n_shards = m.size
        if isl.single_tile or grid % n_shards != 0:
            reason = ("single-tile island" if isl.single_tile else
                      f"grid {grid} does not divide over {n_shards} shards")
            obs.warn_once(
                f"sharded: island {isl.idx} of {lp.pipeline.name!r} falls "
                f"back to the serial band walk ({reason}); pad the image "
                f"or shrink the mesh for full band sharding")
            return isl, enc, grid, False, []
        # outputs shard their band-built row axis: spec_for maps the
        # "band_rows" logical axis onto the mesh (grid % S == 0 implies
        # row divisibility: H = grid * step)
        lead = () if batch is None else (None,)
        axes = []
        for d in (d for _, d in enc.slots("out_slot")):
            shape = (d["H"], d["W"]) if batch is None else \
                (batch, d["H"], d["W"])
            spec = spec_for(shape, lead + ("band_rows", None), m)
            if "band" not in spec:
                raise LoweringError(
                    f"sharded: island {isl.idx}: rows of {shape} do not "
                    f"split over {n_shards} shards")
            axes.append(spec.index("band"))
        return isl, enc, grid, True, axes

    def build(shape, m: BandMesh) -> List[Compiled]:
        B.check_stage_shapes(lp, shape[-2:])
        batch = shape[0] if len(shape) == 3 else None
        plan = partition_islands(lp, tuple(shape[-2:]), outputs=outs,
                                 tile_rows=tile_rows)
        return [compile_island(isl, m, batch) for isl in plan.islands]

    def run_island(c: Compiled, m: BandMesh, batch: Optional[int],
                   buffers: Dict[str, torch.Tensor],
                   replicas: Dict[Tuple[int, str], torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
        isl, enc, grid, sharded, axes = c
        dev0 = m.devices[0]
        if not sharded:
            return fused_pipeline(enc, grid, batch)(
                *[buffers[n] for n in isl.inputs])
        k = grid // m.size
        parts = []
        for d, dev in enumerate(m.devices):
            # every boundary input replicated to every device, once a call
            xs = []
            for n in isl.inputs:
                x = buffers[n]
                if dev != dev0:
                    if (d, n) not in replicas:
                        replicas[d, n] = x.to(dev, non_blocking=True)
                    x = replicas[d, n]
                xs.append(x)
            # each launch goes on its device's current stream: the
            # shards run at once, and the joins below wait for them
            parts.append(fused_pipeline(enc, grid, batch,
                                        bands=(d * k, k))(*xs))
        return tuple(torch.cat([p[o].to(dev0, non_blocking=True)
                                for p in parts], dim=axes[o])
                     for o in range(len(axes)))

    def run(image) -> Dict[str, torch.Tensor]:
        m = make_band_mesh(device=device) if mesh is None else mesh
        with obs.span("exec.sharded", backend="sharded",
                      pipeline=lp.pipeline.name, outputs=len(outs),
                      shards=m.size) as sp:
            # the inputs on the mesh's first device, replicated per island
            buffers, shape = ingest_images(lp, image, input_names,
                                           m.devices[0])
            batch = shape[0] if len(shape) == 3 else None
            if batch is not None:
                sp.set(batch=batch)
            key = shape + tuple(str(d) for d in m.devices)
            with lock:
                if key not in cache:
                    sp.set(kernel_cache="miss")
                    with obs.span("lowering.encode",
                                  pipeline=lp.pipeline.name, shape=shape):
                        cache[key] = build(shape, m)
                else:
                    sp.set(kernel_cache="hit")
                compiled = cache[key]
            sp.set(islands=len(compiled),
                   sharded_islands=sum(1 for c in compiled if c[3]))
            replicas: Dict[Tuple[int, str], torch.Tensor] = {}
            for c in compiled:
                isl = c[0]
                with obs.span("exec.sharded.island", island=isl.idx,
                              rate=str(isl.rate), stages=len(isl.stages),
                              grid=c[2], sharded=c[3]):
                    buffers.update(zip(_written(lp, isl),
                                       run_island(c, m, batch, buffers,
                                                  replicas)))
            res = {n: B.dequant(lp.stages[n], buffers[n]) for n in outs}
        # the band kernel keeps intermediates in its bands, so telemetry
        # covers the island boundaries asked for and the outputs only
        obs.runtime.record_env(res, lp, backend="sharded")
        return res

    run.lowered = lp
    return run

