"""Benchmark pipelines (port copies) and their committed bit-width designs."""
from repro_torch.pipelines import dus, hcd, usm

ALL = {
    "usm": usm.build,
    "hcd": hcd.build,
    "dus": dus.build,
    "dus_ext": dus.build_extended,
}

__all__ = ["ALL", "dus", "hcd", "usm"]
