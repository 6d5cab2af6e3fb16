// The single-stage fixed-point stencil: one linear stencil over a
// pre-padded int32 image.
//
// Replaces the TPU kernel `src/repro/kernels/stencil/kernel.py:
// fixedpoint_stencil` (`_stencil_kernel`, `pallas_call` at line 105):
//
//     out[y, x] = clip((sum_k w_k * xp[y + hy + dy_k, x + hx + dx_k]
//                       + 2^(shift-1)) >> shift, qmin, qmax)
//
// in int32 throughout.  `xp` is the (H + 2hy, W + 2hx) image, already
// edge-padded by the caller; the output is (H, W).
//
// Bit-exactness:
//   * the sum is taken in unsigned 32-bit arithmetic and read back as
//     int32, which is the two's-complement wrap of the reference's int32
//     adds and multiplies (signed overflow is undefined in C++);
//   * `>>` on a negative int32 is the arithmetic shift, the floor of the
//     division, as `jnp.right_shift` on int32;
//   * the rounding is half-UP: the bias 2^(shift-1) is added before the
//     floor shift (unlike `fused_band.cu`'s half-even `rhe_shift`), and
//     there is no bias and no shift when shift <= 0;
//   * the clip comes after the shift: min(max(v, qmin), qmax), as
//     `jnp.clip` (so qmax wins if qmin > qmax).
//
// Design.  One block per TH x TW tile of output rows and columns.  The
// block stages its (TH + 2hy) x (TW + 2hx) int32 window of `xp` in
// shared memory (the line-buffer analogue of the TPU kernel's VMEM
// band), then each thread computes TH / 4 outputs of one column, tap
// by tap.  The taps travel by value as a kernel parameter (a small
// table in the constant parameter bank, at most MAX_TAPS entries; the
// wrapper raises above that), which the block copies into shared memory
// once.
//
// Bound, at one 1080x1920 frame (int32 in, 1082x1922 padded, and int32
// out): 8.32 MB read + 8.29 MB written = 16.6 MB at 3.35 TB/s = 0.0050
// ms.  The operations (a multiply and an add per tap and pixel: 24.9 M
// for Sobel's 6 taps, 0.0004 ms at 67 TOPS) come far below, so the
// bytes bound it.
//
// Left for later: the window is staged with 4-byte loads and no
// cp.async/TMA double buffering, neighbouring tiles re-read their halo
// from L2, and the input is the padded int32 copy the caller made (a
// kernel that clamps its own reads and takes the narrow container would
// move a quarter of the bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 128;   // repro_torch/kernels/stencil/kernel.py
constexpr int TH = 16;          // output rows per block
constexpr int TW = 64;          // output columns per block
constexpr int THREADS = 256;    // TW columns x 4 row groups
// dynamic shared memory left beside the static tap table
constexpr int MAX_SMEM = 232448 - 16 * MAX_TAPS;

struct Taps {
  int n;
  int dy[MAX_TAPS];
  int dx[MAX_TAPS];
  int w[MAX_TAPS];
};

__global__ void __launch_bounds__(THREADS)
stencil_kernel(const int32_t* __restrict__ xp, int32_t* __restrict__ out,
               int H, int W, int hy, int hx, int shift, int qmin, int qmax,
               const Taps taps) {
  extern __shared__ int32_t win[];
  __shared__ int4 tap[MAX_TAPS];        // (dy, dx, w, -) of each tap
  const int Hp = H + 2 * hy, Wp = W + 2 * hx;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int wh = TH + 2 * hy, ww = TW + 2 * hx;

  for (int k = threadIdx.x; k < taps.n; k += THREADS)
    tap[k] = make_int4(taps.dy[k], taps.dx[k], taps.w[k], 0);
  // stage the window; cells past the padded image (ragged last tiles)
  // are zero and feed only outputs that are not stored
  for (int i = threadIdx.x; i < wh * ww; i += THREADS) {
    const int r = r0 + i / ww, c = c0 + i % ww;
    win[i] = (r < Hp && c < Wp) ? xp[(size_t)r * Wp + c] : 0;
  }
  __syncthreads();

  // thread (ty, tx) owns column tx of rows ty, ty + 4, ..., ty + TH - 4
  constexpr int RPT = TH / (THREADS / TW);
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  uint32_t acc[RPT] = {};                // int32 wrap, without UB
  for (int k = 0; k < taps.n; ++k) {
    const int4 t = tap[k];
    const int32_t* p = &win[(ty + hy + t.x) * ww + tx + hx + t.y];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      acc[j] += (uint32_t)t.z * (uint32_t)p[j * (THREADS / TW) * ww];
  }
  const int col = c0 + tx;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = r0 + ty + j * (THREADS / TW);
    if (row >= H || col >= W) continue;
    int32_t v = (int32_t)acc[j];
    if (shift > 0)                       // round half up, arithmetic shift
      v = (int32_t)(acc[j] + (1u << (shift - 1))) >> shift;
    out[(size_t)row * W + col] = min(max(v, qmin), qmax);
  }
}

}  // namespace

// taps: host int32 (n_taps, 3) of (dy, dx, w); copied into the launch's
// parameter table.  Returns a cudaError_t (0 on success).
extern "C" int stencil_launch(const void* xp, void* out, int H, int W,
                              const int32_t* taps, int n_taps, int hy, int hx,
                              int shift, int qmin, int qmax, void* stream) {
  if (n_taps < 0 || n_taps > MAX_TAPS || hy < 0 || hx < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return 0;
  Taps t;
  t.n = n_taps;
  for (int k = 0; k < n_taps; ++k) {
    t.dy[k] = taps[3 * k];
    t.dx[k] = taps[3 * k + 1];
    t.w[k] = taps[3 * k + 2];
  }
  const size_t smem = sizeof(int32_t) * (size_t)(TH + 2 * hy) * (TW + 2 * hx);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem + 16 * MAX_TAPS > 48 * 1024) {   // above the default limit
    cudaError_t e = cudaFuncSetAttribute(
        stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  stencil_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)xp, (int32_t*)out, H, W, hy, hx, shift, qmin, qmax, t);
  return (int)cudaGetLastError();
}
