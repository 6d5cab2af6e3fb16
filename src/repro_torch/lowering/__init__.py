"""Plan-driven lowering: `(Pipeline, types)` -> typed program -> executor.

Port of `repro.lowering`:

    from repro_torch.lowering import compile_pipeline
    run = compile_pipeline(pipe, types, params, backend="cuda")
    outs = run(image)          # {output stage: f64 tensor on the card}

Backends: ``"cuda"`` (the band kernel, one launch per rate island),
``"torch"`` (its plain version), ``"lowered"`` (one whole-frame torch
program), ``"interp"`` (the per-stage f64 walk, the port's oracle) and
``"sharded"`` (the band kernel's bands split over a device mesh).

`ir`, `schedule` and `islands` are the port's copies of the reference's
JAX-free layers; `backends` holds the datapath rules in torch,
`cuda_backend` the executor over the band kernel and `sharded` the
executor over a mesh of devices.
"""
from repro_torch.lowering.ir import (IntTap, LoweredPipeline, LoweredStage,
                                     LoweringError, PhaseSnap, Tap, lower,
                                     match_linear)
from repro_torch.lowering.backends import (COMPILE_BACKENDS, compile_backend,
                                           compile_pipeline)
from repro_torch.lowering.islands import Island, IslandPlan, partition_islands
from repro_torch.lowering.schedule import (Schedule, StageSched,
                                           build_island_schedule,
                                           build_schedule,
                                           single_tile_schedule)

__all__ = [
    "IntTap", "LoweredPipeline", "LoweredStage", "LoweringError",
    "PhaseSnap", "Tap", "lower", "match_linear", "COMPILE_BACKENDS",
    "compile_backend", "compile_pipeline", "Island", "IslandPlan",
    "partition_islands", "Schedule", "StageSched", "build_island_schedule",
    "build_schedule", "single_tile_schedule",
]
