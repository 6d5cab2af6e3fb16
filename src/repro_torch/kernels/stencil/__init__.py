"""Stencil kernels: the fused rate-island band kernel and the
single-stage fixed-point stencil (`kernel.py`, `ops.py`, `csrc/`)."""
