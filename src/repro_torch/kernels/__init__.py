"""Hand-written CUDA kernels of the port, one per TPU kernel of `repro`.

stencil : `fused_band.cu`, the fused rate-island band kernel
          (replaces `repro/kernels/stencil/kernel.py:fused_pipeline`)

Sources live in each kernel's `csrc/`; `_build` compiles them with
`nvcc` at first use.  Nothing is built or imported from CUDA when this
package is imported.
"""
