"""Hand-written CUDA kernels of the port, one per TPU kernel of `repro`.

stencil : `fused_band.cu`, the fused rate-island band kernel
          (replaces `repro/kernels/stencil/kernel.py:fused_pipeline`);
          `stencil.cu`, the single-stage fixed-point stencil
          (replaces `repro/kernels/stencil/kernel.py:fixedpoint_stencil`)
qmatmul : `qmatmul.cu`, the exact int8 x int8 -> int32 matmul and its
          fused f32 dequantization (replaces `repro/kernels/qmatmul/
          kernel.py:qmatmul_i32` and `qmatmul_dequant`)
qdq     : `qdq.cu`, per-row absmax block quantize and dequantize
          (replaces `repro/kernels/qdq/kernel.py:block_quantize` and
          `block_dequantize`)

Sources live in each kernel's `csrc/`; `_build` compiles them with
`nvcc` at first use.  Nothing is built or imported from CUDA when this
package is imported.
"""
