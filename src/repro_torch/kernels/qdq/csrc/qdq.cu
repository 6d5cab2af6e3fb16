// Block quantize and dequantize: per-row absmax int8 codes and f32
// scales, and back.
//
// Replaces the TPU kernels `src/repro/kernels/qdq/kernel.py:
// block_quantize` (`_quant_kernel`, `pallas_call` at line 38) and
// `block_dequantize` (`_dequant_kernel`, `pallas_call` at line 56):
//
//     s[r]    = max_c |x[r, c]| * f32(1/127), and 1 where that is 0
//     q[r, c] = clip(rint(x[r, c] / s[r]), -128, 127)       int8
//     y[r, c] = f32(q[r, c]) * s[r]
//
// x is (NB, BS) f32, bf16 or f16, y (NB, BS) f32, q (NB, BS) int8, s
// (NB, 1) f32.
//
// Bit-exactness:
//   * the row maximum propagates NaN, as `jnp.max` does: `fmaxf` would
//     drop it, so `nan_max` returns a NaN operand;
//   * the reference writes s = max / 127, but XLA compiles a division by
//     a constant as a product with the f32-rounded reciprocal, in the
//     Pallas kernel and in every jitted caller (an ulp apart on some
//     rows), so s = max * f32(1/127) here too;
//   * the codes use a true IEEE division (`/` without fast math keeps
//     `-prec-div=true`), never x * (1 / s);
//   * `rintf` rounds half to even, as `jnp.rint`;
//   * a NaN quotient (a row whose scale is NaN or infinite) gives code
//     0: XLA's float-to-int conversion sends NaN to 0 after the clip,
//     which passes NaN through;
//   * bf16 and f16 inputs are quantized in their own type, as XLA
//     compiles the reference for them: each operation runs in f32 and
//     is rounded back to the input type (`__float2bfloat16_rn`,
//     `__float2half_rn`), which is the correctly rounded narrow result.
//     The scale rule differs by type: bf16 divides, max / 127 rounded
//     to bf16; f16 multiplies by f16(1/127), rounded to f16; the quotient
//     x / s is rounded to the input type before `rintf`.  The scale is
//     stored as f32 (exact).
//
// Design.  block_quantize: one warp per row, 8 rows a block, one
// instantiation per input type.  The warp reads the row once for its
// absmax (a shuffle reduction), then again, from L1/L2, for the codes.
// Where BS % 4 == 0 each lane moves 4 elements of x (16 bytes of f32,
// 8 of bf16 or f16) and 4 codes at a time.  block_dequantize: one
// thread per 4 consecutive elements (or per element where BS % 4 != 0),
// reading its row's scale.
//
// Bound, at one qwen3-4b up-projection weight (2560 x 9728 f32 in
// blocks of 256, so NB = 97,280): quantize reads 99.6 MB and writes
// 24.9 MB of codes and 0.4 MB of scales, 125.0 MB at 3.35 TB/s =
// 0.0373 ms; dequantize moves the same bytes the other way.  The same
// weight in bf16 reads 49.8 MB: 75.1 MB, 0.0224 ms.  A few operations a
// byte: the bytes bound both.
//
// Left for later: the second read of each row in block_quantize comes
// from cache rather than registers; the two passes of `fake_quant`
// could be one kernel that never writes the codes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;    // block_quantize: one warp per row

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;   // NaN in either operand wins
}

// Per input type: widening to f32, rounding an f32 result back to the
// type (the identity for f32), 4 elements as one aligned load, and the
// scale of a row maximum.
template <class T> struct Elem;

template <> struct Elem<float> {
  using Vec4 = float4;
  static __device__ float widen(float v) { return v; }
  static __device__ float narrow(float v) { return v; }
  static __device__ float scale(float m) {      // max * f32(1/127)
    return __fmul_rn(m, 1.0f / 127.0f);
  }
};

template <> struct Elem<__nv_bfloat16> {
  using Vec4 = uint2;
  static __device__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ float narrow(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ float scale(float m) {      // bf16(max / 127)
    return narrow(__fdiv_rn(m, 127.0f));
  }
};

template <> struct Elem<__half> {
  using Vec4 = uint2;
  static __device__ float widen(__half v) { return __half2float(v); }
  static __device__ float narrow(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ float scale(float m) {      // f16(max * f16(1/127))
    return narrow(__fmul_rn(m, __half2float(__float2half_rn(1.0f / 127.0f))));
  }
};

// the 4 elements of one aligned load, widened
template <class T>
__device__ __forceinline__ float4 load4(const T* p) {
  const typename Elem<T>::Vec4 v = *(const typename Elem<T>::Vec4*)p;
  const T* e = (const T*)&v;
  return make_float4(Elem<T>::widen(e[0]), Elem<T>::widen(e[1]),
                     Elem<T>::widen(e[2]), Elem<T>::widen(e[3]));
}

template <class T>
__device__ __forceinline__ int8_t code(float x, float s) {
  const float r = rintf(Elem<T>::narrow(__fdiv_rn(x, s)));
  if (r != r) return 0;
  return (int8_t)(int)fminf(fmaxf(r, -128.f), 127.f);
}

template <class T, bool V4>
__global__ void __launch_bounds__(THREADS)
block_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s, long long NB, int BS) {
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= NB) return;
  const T* xr = x + row * BS;
  int8_t* qr = q + row * BS;
  float m = 0.f;
  if (V4) {
    for (int c = lane; c < BS / 4; c += 32) {
      const float4 v = load4(xr + 4 * c);
      m = nan_max(nan_max(m, fabsf(v.x)), fabsf(v.y));
      m = nan_max(nan_max(m, fabsf(v.z)), fabsf(v.w));
    }
  } else {
    for (int c = lane; c < BS; c += 32)
      m = nan_max(m, fabsf(Elem<T>::widen(xr[c])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sc = Elem<T>::scale(m);
  if (sc == 0.f) sc = 1.f;
  if (lane == 0) s[row] = sc;
  if (V4) {
    for (int c = lane; c < BS / 4; c += 32) {
      const float4 v = load4(xr + 4 * c);
      char4 o;
      o.x = code<T>(v.x, sc);
      o.y = code<T>(v.y, sc);
      o.z = code<T>(v.z, sc);
      o.w = code<T>(v.w, sc);
      ((char4*)qr)[c] = o;
    }
  } else {
    for (int c = lane; c < BS; c += 32)
      qr[c] = code<T>(Elem<T>::widen(xr[c]), sc);
  }
}

template <class T>
int quantize(const void* x, void* q, void* s, long long NB, int BS,
             cudaStream_t st) {
  const bool v4 = BS % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                  (uintptr_t)q % 4 == 0;
  const unsigned blocks = (unsigned)((NB + ROWS - 1) / ROWS);
  if (v4)
    block_quantize_kernel<T, true><<<blocks, THREADS, 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)s, NB, BS);
  else
    block_quantize_kernel<T, false><<<blocks, THREADS, 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)s, NB, BS);
  return (int)cudaGetLastError();
}

template <bool V4>
__global__ void __launch_bounds__(THREADS)
block_dequantize_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ y,
                        long long n, int BS) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (V4) {
    if (4 * i >= n) return;
    const char4 c = ((const char4*)q)[i];
    const float sc = s[4 * i / BS];    // BS % 4 == 0: one row for all 4
    ((float4*)y)[i] = make_float4(
        __fmul_rn((float)c.x, sc), __fmul_rn((float)c.y, sc),
        __fmul_rn((float)c.z, sc), __fmul_rn((float)c.w, sc));
  } else {
    if (i >= n) return;
    y[i] = __fmul_rn((float)q[i], s[i / BS]);
  }
}

}  // namespace

// Each returns a cudaError_t (0 on success).  dtype: 0 f32, 1 bf16,
// 2 f16 (`kernels/qdq/kernel.py:DTYPES`).
extern "C" int block_quantize_launch(const void* x, void* q, void* s,
                                     long long NB, int BS, int dtype,
                                     void* stream) {
  if (NB < 0 || BS <= 0) return (int)cudaErrorInvalidValue;
  if (NB == 0) return 0;
  auto st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return quantize<float>(x, q, s, NB, BS, st);
    case 1: return quantize<__nv_bfloat16>(x, q, s, NB, BS, st);
    case 2: return quantize<__half>(x, q, s, NB, BS, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int block_dequantize_launch(const void* q, const void* s, void* y,
                                       long long NB, int BS, void* stream) {
  if (NB < 0 || BS <= 0) return (int)cudaErrorInvalidValue;
  if (NB == 0) return 0;
  const long long n = NB * BS;
  const bool v4 = BS % 4 == 0 && (uintptr_t)q % 4 == 0 &&
                  (uintptr_t)y % 16 == 0;
  const long long work = v4 ? n / 4 : n;
  const long long blocks = (work + THREADS - 1) / THREADS;
  auto st = (cudaStream_t)stream;
  if (v4)
    block_dequantize_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)y, n, BS);
  else
    block_dequantize_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)y, n, BS);
  return (int)cudaGetLastError();
}
