"""Logical-axis -> mesh-axis rule for a stage's row axis.

Port of the band part of `repro.launch.sharding`: the ``"band_rows"``
logical axis (a stage's band-built rows) maps onto the mesh's
``"band"`` axis, and `spec_for` replicates a dimension that the mapped
axis does not divide.  The LM rules of that module wait for the LM
slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["BASE_RULES", "spec_for"]

# logical axis -> mesh axis
BASE_RULES: Dict[str, Optional[str]] = {
    "band_rows": "band",   # pipeline row-band grid (lowering.sharded)
}


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh, rules: Optional[Dict] = None
             ) -> Tuple[Optional[str], ...]:
    """The mesh axis each dimension of a tensor is split over, or None
    where it is replicated: a dimension whose size the mapped axis does
    not divide, or whose axis an earlier dimension took, is replicated
    (the reference's `PartitionSpec`, as a tuple)."""
    rules = BASE_RULES if rules is None else rules
    assert len(shape) == len(axes), (shape, axes)
    parts, used = [], set()
    for dim, name in zip(shape, axes):
        mapped = rules.get(name) if name else None
        if mapped is None or mapped not in mesh.axis_names:
            parts.append(None)
            continue
        if dim % mesh.shape[mapped] != 0 or mapped in used:
            parts.append(None)
        else:
            parts.append(mapped)
            used.add(mapped)
    return tuple(parts)
