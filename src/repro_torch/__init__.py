"""PyTorch/CUDA port of `repro`, the bit-width-customized image pipeline
system (paper: "Synthesizing Power and Area Efficient Image Processing
Pipelines on FPGAs using Customized Bit-widths").

The port mirrors the module layout of the JAX package `repro`, which
stays in the repository as the reference the port is tested against.
It imports `torch` and numpy only, never `jax` and nothing of `repro`.

Entry points take ``device=None``, meaning ``"cuda"``: they run on the
card and raise when there is none (`repro_torch.device.resolve_device`).
Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.

    from repro_torch.dsl.exec import run_fixed
    from repro_torch.pipelines import usm
    from repro_torch.pipelines.types import load_types
    outs = run_fixed(usm.build(), frame, load_types("usm"),
                     usm.DEFAULT_PARAMS, backend="cuda")
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
