"""Plan-driven lowering: `(Pipeline, types)` -> typed program -> executor.

Port of `repro.lowering`:

    from repro_torch.lowering import lower
    from repro_torch.lowering.cuda_backend import compile_cuda
    run = compile_cuda(lower(pipe, types, params), device="cuda")
    outs = run(image)          # {output stage: f64 tensor}

`ir`, `schedule` and `islands` are the port's copies of the reference's
JAX-free layers; `backends` holds the datapath rules in torch and
`cuda_backend` the executor over the band kernel.
"""
from repro_torch.lowering.ir import (IntTap, LoweredPipeline, LoweredStage,
                                     LoweringError, PhaseSnap, Tap, lower,
                                     match_linear)
from repro_torch.lowering.islands import Island, IslandPlan, partition_islands
from repro_torch.lowering.schedule import (Schedule, StageSched,
                                           build_island_schedule,
                                           build_schedule,
                                           single_tile_schedule)

__all__ = [
    "IntTap", "LoweredPipeline", "LoweredStage", "LoweringError",
    "PhaseSnap", "Tap", "lower", "match_linear", "Island", "IslandPlan",
    "partition_islands", "Schedule", "StageSched", "build_island_schedule",
    "build_schedule", "single_tile_schedule",
]
