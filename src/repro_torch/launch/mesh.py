"""The band mesh: the devices a pipeline's row-band grid is split over.

Port of `repro.launch.mesh.make_band_mesh`.  The LM meshes of that
module (`make_production_mesh`, `make_debug_mesh`, `batch_axes`) are not
ported yet.  A mesh is a plain record of devices; making one touches no
device state beyond counting the cards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["BandMesh", "make_band_mesh"]


@dataclasses.dataclass(frozen=True)
class BandMesh:
    """A 1-D mesh with one axis, ``"band"``, over `devices` (one shard
    each, in order)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("band",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"band": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_band_mesh(n: Optional[int] = None,
                   device: DeviceLike = None) -> BandMesh:
    """1-D mesh whose ``"band"`` axis splits a pipeline's row-band grid
    (`lowering.sharded`).

    On the card (`device` ``None`` or ``"cuda"``) it spans the first `n`
    CUDA devices, by default every card present, and raises if `n`
    exceeds `torch.cuda.device_count()`.  With ``device="cpu"`` every
    shard is the one CPU device (`n` defaults to 1): the CPU tests run
    the split geometry there, as the reference's tests do on a host
    platform with several devices."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n is None else int(n)
        if n < 1:
            raise ValueError(f"a band mesh needs at least one shard; got {n}")
        return BandMesh((torch.device("cpu"),) * n)
    if dev.type != "cuda":
        raise ValueError(f"make_band_mesh: unsupported device {dev}")
    count = torch.cuda.device_count()
    n = count if n is None else int(n)
    if not 1 <= n <= count:
        raise ValueError(f"make_band_mesh: {n} devices asked for, "
                         f"{count} present")
    return BandMesh(tuple(torch.device("cuda", i) for i in range(n)))
