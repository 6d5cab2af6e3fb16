// Exact int8 x int8 -> int32 matrix product, with an optional f32
// dequantization epilogue.
//
// Replaces the TPU kernels `src/repro/kernels/qmatmul/kernel.py:
// qmatmul_i32` (`_qmm_kernel`, `pallas_call` at line 64) and
// `qmatmul_dequant` (`_qmm_fused_kernel`, `pallas_call` at line 88):
//
//     acc[m, n] = sum_k a[m, k] * b[k, n]            int32
//     out[m, n] = acc                                qmatmul_i32
//     out[m, n] = (f32(acc) * sa[m]) * sb[n]         qmatmul_dequant
//
// a is (M, K) int8 row-major, b is (K, N) int8 row-major, sa (M, 1) and
// sb (1, N) f32.  One templated body, two epilogues.
//
// Bit-exactness: the products and sums are exact integers in the
// tensor cores' int32 accumulators (|acc| <= 2^14 K < 2^31 while K <
// 131072; above that the JAX package and this kernel both wrap, and the
// tests stay below).  The epilogue converts with round-to-nearest-even
// (`__int2float_rn`, as XLA's and torch's int32 -> f32 conversion) and
// multiplies with `__fmul_rn` in the reference's order, a-scale first.
//
// Design.  One block of 8 warps per 128 x 128 output tile; each warp
// owns a 64 x 32 sub-tile as 4 x 4 `mma.sync.m16n8k32` s8 tiles with
// int32 accumulators in registers.  K advances in steps of 64: the
// block stages a 128 x 64 tile of a and, transposed to n-major (the s8
// mma takes both operands k-contiguous), a 64 x 128 tile of b in shared
// memory; the next step's tiles are loaded into registers while the
// current one is multiplied.  Rows are padded to 80 bytes so that the
// fragment reads hit 32 distinct banks.  Ragged M, N and K are masked:
// cells past an edge load as 0 and are not stored.  Where K % 16 == 0
// and N % 4 == 0 (and the pointers are aligned) a and b load 16 and 4
// bytes a thread; otherwise byte by byte.
//
// Bound, at M = 4096, K = 2560, N = 9728 (qwen3-4b's MLP up-projection
// over 4096 tokens): 2 M N K = 204.0 G int8 operations at the data
// sheet's 1,979 TOPS = 0.1031 ms; bytes 10.5 + 24.9 MB in, 159.4 MB out
// (int32) = 194.8 MB at 3.35 TB/s = 0.058 ms.  The operations bound it.
//
// Left for later: `mma.sync` reaches only part of Hopper's int8 rate;
// `wgmma` from shared memory fed by TMA through a multi-stage mbarrier
// ring, with warp specialisation and a persistent tile walk, is what
// the full rate needs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;       // one warp's sub-tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int LDS = BK + 16;          // shared row stride in bytes

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack4(const int8_t* p, int valid) {
  uint32_t w = 0;
  for (int j = 0; j < 4; ++j)
    if (j < valid) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

// Registers that carry one K step's tiles from device memory to shared
// memory: two 16-byte chunks of a, two 4 x 4 byte blocks of b.
struct Stage {
  uint4 a[2];
  uint32_t b[2][4];
};

template <bool VEC>
__device__ __forceinline__ void load_tiles(Stage& st, const int8_t* a,
                                           const int8_t* b, int M, int N,
                                           int K, int m0, int n0, int k0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    // a: 128 rows x 4 chunks of 16 bytes
    const int c = tid + it * THREADS;
    const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 16;
    const int8_t* src = a + (size_t)gm * K + gk;
    if (VEC) {
      st.a[it] = (gm < M && gk < K) ? *(const uint4*)src
                                    : make_uint4(0, 0, 0, 0);
    } else {
      const int valid = gm < M ? min(max(K - gk, 0), 16) : 0;
      st.a[it].x = pack4(src, valid);
      st.a[it].y = pack4(src + 4, valid - 4);
      st.a[it].z = pack4(src + 8, valid - 8);
      st.a[it].w = pack4(src + 12, valid - 12);
    }
    // b: 16 x 32 blocks of 4 (k) x 4 (n) bytes; a warp covers 4 k-quads
    // x 8 n-quads, so each of its row loads is one 32-byte sector
    const int g = it * 8 + warp;
    const int kq = (lane >> 3) + 4 * (g & 3), nq = (lane & 7) + 8 * (g >> 2);
    const int gn = n0 + 4 * nq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk2 = k0 + 4 * kq + i;
      const int8_t* row = b + (size_t)gk2 * N + gn;
      if (VEC)
        st.b[it][i] = (gk2 < K && gn < N) ? *(const uint32_t*)row : 0u;
      else
        st.b[it][i] = gk2 < K ? pack4(row, min(max(N - gn, 0), 4)) : 0u;
    }
  }
}

__device__ __forceinline__ void store_tiles(const Stage& st, int8_t* As,
                                            int8_t* Bt) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = tid + it * THREADS;
    *(uint4*)&As[(c >> 2) * LDS + (c & 3) * 16] = st.a[it];
    const int g = it * 8 + warp;
    const int kq = (lane >> 3) + 4 * (g & 3), nq = (lane & 7) + 8 * (g >> 2);
    // transpose the 4 x 4 byte block: word j of the result holds
    // b[k0 + 4kq + 0..3][n = 4nq + j]
    const uint32_t* r = st.b[it];
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    int8_t* dst = &Bt[(4 * nq) * LDS + 4 * kq];
    *(uint32_t*)(dst) = __byte_perm(lo01, lo23, 0x5410);
    *(uint32_t*)(dst + LDS) = __byte_perm(lo01, lo23, 0x7632);
    *(uint32_t*)(dst + 2 * LDS) = __byte_perm(hi01, hi23, 0x5410);
    *(uint32_t*)(dst + 3 * LDS) = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <bool VEC, bool DEQUANT>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               const float* __restrict__ sa, const float* __restrict__ sb,
               void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bt[BN * LDS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // mma group and thread in it
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;

  int32_t acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = (K + BK - 1) / BK;
  Stage st;
  if (nk > 0) {
    load_tiles<VEC>(st, a, b, M, N, K, m0, n0, 0);
    store_tiles(st, As, Bt);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tiles<VEC>(st, a, b, M, N, K, m0, n0, (kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = &As[(wm + 16 * i + g) * LDS + ks + 4 * t];
        af[i][0] = *(const uint32_t*)p;
        af[i][1] = *(const uint32_t*)(p + 8 * LDS);
        af[i][2] = *(const uint32_t*)(p + 16);
        af[i][3] = *(const uint32_t*)(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = &Bt[(wn + 8 * j + g) * LDS + ks + 4 * t];
        bf[j][0] = *(const uint32_t*)p;
        bf[j][1] = *(const uint32_t*)(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store_tiles(st, As, Bt);
      __syncthreads();
    }
  }

  // accumulator r of tile (i, j): row g (+8 for r >= 2), column 2t + r%2
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * i + g + 8 * (r >> 1);
        const int col = n0 + wn + 8 * j + 2 * t + (r & 1);
        if (row >= M || col >= N) continue;
        const size_t o = (size_t)row * N + col;
        if (DEQUANT)
          ((float*)out)[o] =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), sa[row]),
                        sb[col]);
        else
          ((int32_t*)out)[o] = acc[i][j][r];
      }
}

template <bool DEQUANT>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const bool vec = K % 16 == 0 && N % 4 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)b % 4 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto s = (cudaStream_t)stream;
  auto A = (const int8_t*)a;
  auto B = (const int8_t*)b;
  auto SA = (const float*)sa;
  auto SB = (const float*)sb;
  if (vec)
    qmatmul_kernel<true, DEQUANT><<<grid, THREADS, 0, s>>>(A, B, SA, SB, out,
                                                           M, N, K);
  else
    qmatmul_kernel<false, DEQUANT><<<grid, THREADS, 0, s>>>(A, B, SA, SB, out,
                                                            M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 on success).
extern "C" int qmatmul_i32_launch(const void* a, const void* b, void* out,
                                  int M, int N, int K, void* stream) {
  return launch<false>(a, b, nullptr, nullptr, out, M, N, K, stream);
}

extern "C" int qmatmul_dequant_launch(const void* a, const void* b,
                                      const void* sa, const void* sb,
                                      void* out, int M, int N, int K,
                                      void* stream) {
  return launch<true>(a, b, sa, sb, out, M, N, K, stream);
}
