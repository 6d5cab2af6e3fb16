"""Fused rate-island band kernel (`kernel.py`, `csrc/fused_band.cu`)."""
