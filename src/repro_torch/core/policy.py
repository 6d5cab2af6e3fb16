"""Legalization of (alpha, beta) fixed-point types onto torch containers.

Port of `repro.core.policy.legalize` with a torch dtype table.  FPGAs
synthesize a 13-bit datapath for a 13-bit type; a GPU stores it in the
smallest container that holds alpha+beta bits, and that container width
is what the card's memory traffic pays for.

``torch.uint16`` and ``torch.uint32`` are storage-only: casts into and
out of them work, but ``clamp``, ``+`` and indexing may raise.  So the
port computes in a wide carrier (int64 or f64), clips there, and casts
into the container last; loads widen first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointType

# container name -> (bits, torch storage dtype)
CONTAINERS = {
    "int8": (8, torch.int8),
    "uint8": (8, torch.uint8),
    "int16": (16, torch.int16),
    "uint16": (16, torch.uint16),
    "int32": (32, torch.int32),
    "uint32": (32, torch.uint32),
    "float32": (32, torch.float32),
}


@dataclasses.dataclass(frozen=True)
class LegalizedType:
    fp: Optional[FixedPointType]     # None = float reference
    container: str                   # key into CONTAINERS
    shift: int                       # binary point position = fp.beta

    @property
    def bits(self) -> int:
        return CONTAINERS[self.container][0]

    @property
    def dtype(self) -> torch.dtype:
        return CONTAINERS[self.container][1]

    @property
    def bytes(self) -> float:
        return self.bits / 8.0


def legalize(t: Optional[FixedPointType]) -> LegalizedType:
    if t is None:
        return LegalizedType(fp=None, container="float32", shift=0)
    w = t.width
    prefix = "" if t.signed else "u"
    if w <= 8:
        c = f"{prefix}int8"
    elif w <= 16:
        c = f"{prefix}int16"
    elif w <= 32:
        c = f"{prefix}int32"
    else:
        # analysis blew past 32 integer bits (e.g. unbounded division):
        # fall back to float32, as the paper falls back to wider types
        return LegalizedType(fp=None, container="float32", shift=0)
    return LegalizedType(fp=t, container=c, shift=t.beta)


def container_bytes(t: Optional[FixedPointType]) -> float:
    """Bytes a stored element of type `t` takes (the cost model's
    memory-traffic proxy)."""
    return legalize(t).bytes
