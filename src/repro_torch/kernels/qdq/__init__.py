"""Block quantize / dequantize kernels (`kernel.py`, `csrc/qdq.cu`)."""
