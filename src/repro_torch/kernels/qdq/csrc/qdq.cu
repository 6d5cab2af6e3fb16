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
//   * the codes are those of a true IEEE division x / s, never of
//     x * (1 / s): f32 divides (`__fdiv_rn`), and bf16 and f16 take the
//     same quotient from the row's reciprocal and one fma residual step
//     (see Design);
//   * codes round half to even, as `jnp.rint` (`rintf`, or adding
//     1.5 2^23);
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
//     stored as f32 (exact);
//   * subnormals: XLA's compiled code on the CPU reads a subnormal f32
//     operand as 0 and flushes a subnormal f32 result to 0.  Here each
//     value is flushed where that changes a result (`ftz`; no
//     floating-point mode is set and the build keeps `-ftz=false`): the
//     f32 scale, and the bf16 quotient max / 127 before it is rounded
//     to bf16, so a row whose maximum is subnormal gets scale 1 (a
//     subnormal element never is the maximum of a row with a normal
//     one); the elements of a row whose scale is below 2 FLT_MIN (a
//     subnormal element divides to |x / s| < 1/2, code 0, beside any
//     larger scale); the dequantize's scale.  f16 flushes nothing: no
//     f16 value, scale or quotient is subnormal in f32.  f32(q) * s
//     with a normal s is 0 or normal.
//
// Design of block_quantize, one instantiation per input type:
//   * the register path, where BS % 8 == 0, x is 16-byte and q 8-byte
//     aligned and a row fits in the registers of a warp (BS <= 32 x
//     MAX_CHUNKS x 8): each lane holds chunks of 8 consecutive elements
//     as raw words (one 16-byte load of bf16 or f16, two of f32), L
//     lanes a row (the least power of two, up to 32, that gives no
//     lane more than LANE_BYTES = 32 bytes of the row: 2 chunks a lane
//     of bf16 and f16, 1 of f32, where the row is long enough; then up
//     to MAX_CHUNKS chunks a lane), so 32 / L rows a warp.  A row is
//     read from memory once: its maximum is an integer maximum of the
//     elements' magnitude bits (two 16-bit lanes a word for bf16 and
//     f16; NaN's bits sort above inf's, so it propagates), reduced with
//     `__shfl_xor_sync` over the row's L lanes, and its codes come from
//     the same registers, 8 a lane in one 8-byte store;
//   * the codes of a row with a finite scale of at least 2 FLT_MIN (the
//     fast rows: every row of finite data but the tiny ones) take no
//     conversion instruction but the packed rounding to bf16x2 or
//     f16x2: x / s rounded to the input type, clamped to [-128, 127]
//     and rounded half to even by adding 1.5 2^23, whose low byte is
//     then the code (clip(rint(v)) == rint(clip(v)) for integer bounds;
//     |x / s| < 256 in such a row).  For bf16 and f16 the quotient is
//     computed from the row's r = 1/s, correctly rounded: q0 = x r,
//     e = fma(-q0, s, x), q = fma(e, r, q0).  `block_quantize_check`
//     compares its codes with `__fdiv_rn`'s on every pair of a scale
//     of a fast row and an element of such a row (|x| <= 256 s), all
//     2^31 of them per type; f32 keeps `__fdiv_rn`.  The other rows
//     (NaN, inf or tiny scales) take the exact path: flush, `__fdiv_rn`,
//     round to the input type, `rintf`, NaN to 0, clamp;
//   * the loop path, where the row is longer: one warp a row, chunks of
//     8 with 16-byte loads, once for the maximum and once more for the
//     codes (that second read comes from L2 at the sizes users run:
//     a row of 8192 f32 is 32 KB);
//   * the general path (BS % 8 != 0, or x or q misaligned): one warp a
//     row, one element a lane at a time, two reads, the exact path.
// block_dequantize: one thread per 4 consecutive elements (or per
// element where BS % 4 != 0), reading its row's scale.
//
// Bound, at one qwen3-4b up-projection weight (2560 x 9728 f32 in
// blocks of 256, so NB = 97,280): quantize reads 99.6 MB and writes
// 24.9 MB of codes and 0.4 MB of scales, 125.0 MB at 3.35 TB/s =
// 0.0373 ms; dequantize moves the same bytes the other way.  The same
// weight in bf16 reads 49.8 MB: 75.1 MB, 0.0224 ms.  A few operations a
// byte: the bytes bound both, if few of those are conversions (16 an
// SM a clock, against 7.2 bf16 elements an SM a clock at the bytes
// bound).

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;          // elements a lane holds together
constexpr int MAX_CHUNKS = 4;     // chunks a lane holds in registers
constexpr int LANE_BYTES = 32;    // a row takes the fewest lanes (up to
                                  // 32) that hold at most this each
constexpr float ROUND = 12582912.f;   // 1.5 2^23: adding it rounds to
                                      // an integer, half to even

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;   // NaN in either operand wins
}

// a value below FLT_MIN in magnitude becomes a zero of its sign
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {   // low bytes
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the code of a finite quotient already rounded to the input type
__device__ __forceinline__ uint32_t code_bits(float q) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -128.f), 127.f), ROUND));
}

// Per input type: the words of a chunk (16-byte loads), its 8 values,
// the running maximum of magnitude bits, the scale of a row maximum,
// rounding to the type, and the fast rows' quotient.
template <class T> struct Elem;

template <> struct Elem<float> {
  static constexpr bool FLUSH = true;
  static constexpr int WORDS = 2;
  static __device__ float widen(float v) { return v; }
  static __device__ float narrow(float v) { return v; }
  static __device__ float scale(float m) {      // max * f32(1/127)
    return ftz(__fmul_rn(m, 1.0f / 127.0f));
  }
  static __device__ void unpack(const uint4 (&w)[WORDS], float (&v)[CHUNK]) {
    const float* f = (const float*)w;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) v[k] = f[k];
  }
  static __device__ uint32_t absmax(uint32_t acc, const uint4 (&w)[WORDS]) {
    const uint32_t* u = (const uint32_t*)w;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) acc = max(acc, u[k] & 0x7fffffffu);
    return acc;
  }
  static __device__ uint32_t fold(uint32_t acc) { return acc; }
  static __device__ float from_bits(uint32_t b) { return __uint_as_float(b); }
  static __device__ void narrow8(float (&)[CHUNK]) {}
  static __device__ float quotient(float x, float s, float) {
    return __fdiv_rn(x, s);
  }
};

// the two 16-bit types: magnitudes two to a word, the quotient from the
// row's correctly rounded reciprocal and one residual step
struct Elem16 {
  static constexpr int WORDS = 1;
  static __device__ uint32_t absmax(uint32_t acc, const uint4 (&w)[WORDS]) {
    const uint32_t* u = (const uint32_t*)w;
#pragma unroll
    for (int k = 0; k < CHUNK / 2; ++k)
      acc = __vmaxu2(acc, u[k] & 0x7fff7fffu);
    return acc;
  }
  static __device__ uint32_t fold(uint32_t acc) {
    return max(acc & 0xffffu, acc >> 16);
  }
  static __device__ float quotient(float x, float s, float r) {
    const float q0 = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q0, s, x), r, q0);
  }
};

template <> struct Elem<__nv_bfloat16> : Elem16 {
  static constexpr bool FLUSH = true;
  static __device__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ float narrow(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ float scale(float m) {      // bf16(max / 127)
    return narrow(ftz(__fdiv_rn(m, 127.0f)));
  }
  static __device__ void unpack(const uint4 (&w)[WORDS], float (&v)[CHUNK]) {
    const uint32_t* u = (const uint32_t*)w;
#pragma unroll
    for (int k = 0; k < CHUNK / 2; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  static __device__ float from_bits(uint32_t b) {
    return __uint_as_float(b << 16);
  }
  static __device__ void narrow8(float (&q)[CHUNK]) {   // cvt.rn.bf16x2
#pragma unroll
    for (int k = 0; k < CHUNK; k += 2) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(q[k], q[k + 1]));
      q[k] = f.x;
      q[k + 1] = f.y;
    }
  }
};

template <> struct Elem<__half> : Elem16 {
  static constexpr bool FLUSH = false;
  static __device__ float widen(__half v) { return __half2float(v); }
  static __device__ float narrow(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ float scale(float m) {      // f16(max * f16(1/127))
    return narrow(__fmul_rn(m, __half2float(__float2half_rn(1.0f / 127.0f))));
  }
  static __device__ void unpack(const uint4 (&w)[WORDS], float (&v)[CHUNK]) {
    const __half2* h = (const __half2*)w;
#pragma unroll
    for (int k = 0; k < CHUNK / 2; ++k) {
      const float2 f = __half22float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ float from_bits(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  static __device__ void narrow8(float (&q)[CHUNK]) {   // cvt.rn.f16x2
#pragma unroll
    for (int k = 0; k < CHUNK; k += 2) {
      const float2 f = __half22float2(__floats2half2_rn(q[k], q[k + 1]));
      q[k] = f.x;
      q[k + 1] = f.y;
    }
  }
};

// an element as the reference's compiled code reads it
template <class T>
__device__ __forceinline__ float read(float v) {
  return Elem<T>::FLUSH ? ftz(v) : v;
}

// the exact path: the reference's operations one by one
template <class T>
__device__ __forceinline__ int8_t exact_code(float x, float s) {
  const float r = rintf(Elem<T>::narrow(__fdiv_rn(read<T>(x), s)));
  if (r != r) return 0;
  return (int8_t)(int)fminf(fmaxf(r, -128.f), 127.f);
}

template <class T>
__device__ __forceinline__ float row_scale(float m) {
  const float sc = Elem<T>::scale(m);
  return sc == 0.f ? 1.f : sc;
}

// whether a row of scale s takes the fast codes (false for NaN)
__device__ __forceinline__ bool fast_row(float s) {
  return s >= 2.f * FLT_MIN && s <= FLT_MAX;
}

// the 8 codes of a chunk of a fast row (r = 1/s, correctly rounded)
template <class T>
__device__ __forceinline__ uint2 fast_codes(const float (&v)[CHUNK], float s,
                                            float r) {
  float q[CHUNK];
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) q[k] = Elem<T>::quotient(v[k], s, r);
  Elem<T>::narrow8(q);
  uint32_t u[CHUNK];
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) u[k] = code_bits(q[k]);
  return make_uint2(pack4(u[0], u[1], u[2], u[3]),
                    pack4(u[4], u[5], u[6], u[7]));
}

template <class T>
__device__ __forceinline__ uint2 exact_codes(const float (&v)[CHUNK],
                                             float s) {
  union { int8_t c[CHUNK]; uint2 u; } o;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) o.c[k] = exact_code<T>(v[k], s);
  return o.u;
}

template <class T>
__device__ __forceinline__ void load_chunk(const T* p,
                                           uint4 (&w)[Elem<T>::WORDS]) {
#pragma unroll
  for (int i = 0; i < Elem<T>::WORDS; ++i) w[i] = ((const uint4*)p)[i];
}

// the codes of a chunk, 8 bytes at p (8-byte aligned)
template <class T>
__device__ __forceinline__ void store_chunk(int8_t* p,
                                            const uint4 (&w)[Elem<T>::WORDS],
                                            float s, float r, bool fast) {
  float v[CHUNK];
  Elem<T>::unpack(w, v);
  *(uint2*)p = fast ? fast_codes<T>(v, s, r) : exact_codes<T>(v, s);
}

// The register path: L = 1 << lanes_log2 lanes a row, NCH chunks a lane.
template <class T, int NCH>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long NB, int BS,
                     int lanes_log2) {
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & 31, sub = lane & (L - 1);
  const long long row =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / L) +
      (lane >> lanes_log2);
  const bool live = row < NB;
  const int nch = BS / CHUNK;
  const T* xr = x + row * BS;
  uint4 w[NCH][Elem<T>::WORDS];
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = j * L + sub;
    if (live && c < nch) {
      load_chunk(xr + CHUNK * c, w[j]);
      m = Elem<T>::absmax(m, w[j]);
    }
  }
  m = Elem<T>::fold(m);
  // every lane of the warp takes part: the rows' groups are aligned
  for (int off = L >> 1; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!live) return;
  const float sc = row_scale<T>(Elem<T>::from_bits(m));
  if (sub == 0) s[row] = sc;
  const bool fast = fast_row(sc);
  const float r = __frcp_rn(sc);
  int8_t* qr = q + row * BS;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = j * L + sub;
    if (c < nch) store_chunk<T>(qr + CHUNK * c, w[j], sc, r, fast);
  }
}

// The loop path: one warp a row of any length BS % 8 == 0, chunks of 8.
template <class T>
__global__ void __launch_bounds__(THREADS)
quantize_long_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long NB, int BS) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= NB) return;
  const int nch = BS / CHUNK;
  const T* xr = x + row * BS;
  int8_t* qr = q + row * BS;
  uint32_t m = 0;
  int c = lane;
  for (; c + 32 < nch; c += 64) {           // two chunks in flight a lane
    uint4 v[Elem<T>::WORDS], u[Elem<T>::WORDS];
    load_chunk(xr + CHUNK * c, v);
    load_chunk(xr + CHUNK * (c + 32), u);
    m = Elem<T>::absmax(Elem<T>::absmax(m, v), u);
  }
  if (c < nch) {
    uint4 v[Elem<T>::WORDS];
    load_chunk(xr + CHUNK * c, v);
    m = Elem<T>::absmax(m, v);
  }
  m = Elem<T>::fold(m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = row_scale<T>(Elem<T>::from_bits(m));
  if (lane == 0) s[row] = sc;
  const bool fast = fast_row(sc);
  const float r = __frcp_rn(sc);
  for (c = lane; c < nch; c += 32) {
    uint4 v[Elem<T>::WORDS];
    load_chunk(xr + CHUNK * c, v);
    store_chunk<T>(qr + CHUNK * c, v, sc, r, fast);
  }
}

// The general path: one warp a row, one element a lane at a time.
template <class T>
__global__ void __launch_bounds__(THREADS)
quantize_general_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ s, long long NB, int BS) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= NB) return;
  const T* xr = x + row * BS;
  int8_t* qr = q + row * BS;
  float m = 0.f;
  for (int c = lane; c < BS; c += 32)
    m = nan_max(m, fabsf(read<T>(Elem<T>::widen(xr[c]))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = row_scale<T>(m);
  if (lane == 0) s[row] = sc;
  for (int c = lane; c < BS; c += 32)
    qr[c] = exact_code<T>(Elem<T>::widen(xr[c]), sc);
}

template <class T, int NCH>
void launch_rows(const T* x, int8_t* q, float* s, long long NB, int BS,
                 int lanes_log2, cudaStream_t st) {
  const long long rows = (long long)WARPS * (32 >> lanes_log2);
  quantize_rows_kernel<T, NCH><<<(unsigned)((NB + rows - 1) / rows),
                                 THREADS, 0, st>>>(x, q, s, NB, BS,
                                                   lanes_log2);
}

template <class T>
int quantize(const void* xv, void* qv, void* sv, long long NB, int BS,
             cudaStream_t st) {
  const T* x = (const T*)xv;
  int8_t* q = (int8_t*)qv;
  float* s = (float*)sv;
  const unsigned warp_blocks = (unsigned)((NB + WARPS - 1) / WARPS);
  const bool chunks = BS % CHUNK == 0 && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)q % 8 == 0;
  const int nch = BS / CHUNK;
  if (chunks && nch <= 32 * MAX_CHUNKS) {
    // the fewest lanes, a power of two up to 32, that give each lane at
    // most LANE_BYTES of the row: 2 loads in flight a lane where the
    // row is long enough, so 32 / L rows a warp
    const long long row_bytes = (long long)BS * sizeof(T);
    int lanes_log2 = 0;
    while (lanes_log2 < 5 &&
           ((long long)LANE_BYTES << lanes_log2) < row_bytes)
      ++lanes_log2;
    const int per = (nch + (1 << lanes_log2) - 1) >> lanes_log2;
    switch (per) {
      case 1: launch_rows<T, 1>(x, q, s, NB, BS, lanes_log2, st); break;
      case 2: launch_rows<T, 2>(x, q, s, NB, BS, lanes_log2, st); break;
      case 3: launch_rows<T, 3>(x, q, s, NB, BS, lanes_log2, st); break;
      default: launch_rows<T, 4>(x, q, s, NB, BS, lanes_log2, st); break;
    }
  } else if (chunks) {
    quantize_long_kernel<T><<<warp_blocks, THREADS, 0, st>>>(x, q, s, NB, BS);
  } else {
    quantize_general_kernel<T><<<warp_blocks, THREADS, 0, st>>>(x, q, s, NB,
                                                               BS);
  }
  return (int)cudaGetLastError();
}

// Every (scale, element) pair of a fast row of a 16-bit type: the
// blocks walk the positive scales, the threads the elements, 8 at a
// time through `unpack` and `fast_codes` as the kernels run them; each
// code that differs from the exact path's counts in `bad`.  The
// elements are those a row of scale s can hold: finite, |x| <= 256 s
// (a row's maximum is at most 127.5 s; up to 190 s for f16 scales that
// are f16 subnormals), so no infinity.
template <class T>
__global__ void __launch_bounds__(THREADS)
check_kernel(unsigned long long* __restrict__ bad) {
  const float s = Elem<T>::from_bits(blockIdx.x);
  if (!fast_row(s)) return;
  const float r = __frcp_rn(s);
  unsigned long long n = 0;
  for (uint32_t base = CHUNK * threadIdx.x; base < 65536;
       base += CHUNK * THREADS) {
    uint4 w[1];
    uint32_t* u = (uint32_t*)w;
#pragma unroll
    for (int k = 0; k < CHUNK / 2; ++k)
      u[k] = (base + 2 * k) | ((base + 2 * k + 1) << 16);
    float v[CHUNK];
    Elem<T>::unpack(w, v);
    const uint2 got = fast_codes<T>(v, s, r);
    const int8_t* c = (const int8_t*)&got;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      if (isfinite(v[k]) && fabsf(v[k]) <= 256.f * s &&
          c[k] != exact_code<T>(v[k], s))
        ++n;
  }
  if (n) atomicAdd(bad, n);
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
    const float sc = ftz(s[4 * i / BS]);  // BS % 4 == 0: one row for all 4
    ((float4*)y)[i] = make_float4(
        __fmul_rn((float)c.x, sc), __fmul_rn((float)c.y, sc),
        __fmul_rn((float)c.z, sc), __fmul_rn((float)c.w, sc));
  } else {
    if (i >= n) return;
    y[i] = __fmul_rn((float)q[i], ftz(s[i / BS]));
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

// The proof of the fast quotient: adds to *bad (a device counter) the
// number of (scale, element) pairs of a fast row whose fast code is not
// the exact path's; dtype 1 bf16, 2 f16 (f32 divides with __fdiv_rn).
extern "C" int block_quantize_check(void* bad, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  auto b = (unsigned long long*)bad;
  if (dtype == 1)
    check_kernel<__nv_bfloat16><<<32768, THREADS, 0, st>>>(b);
  else if (dtype == 2)
    check_kernel<__half><<<32768, THREADS, 0, st>>>(b);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
