"""Benchmark pipelines (port copies) and their committed bit-width designs."""
from repro_torch.pipelines import dus, hcd, optical_flow, usm

ALL = {
    "usm": usm.build,
    "hcd": hcd.build,
    "dus": dus.build,
    "dus_ext": dus.build_extended,
    "of": optical_flow.build,
    "of_pyramid": optical_flow.build_pyramid,
}

__all__ = ["ALL", "dus", "hcd", "optical_flow", "usm"]
