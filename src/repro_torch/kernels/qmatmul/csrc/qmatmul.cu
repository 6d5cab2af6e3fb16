// Exact int8 x int8 -> int32 matrix product, with an optional f32
// dequantization epilogue, for Hopper (sm_90a).
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
// XLA's compiled code on the CPU reads a subnormal f32 scale as 0 and
// flushes each subnormal product to 0; the epilogue flushes the same
// values one by one (`ftz`; no floating-point mode, no flush build flag).
//
// Bound, at M = 4096, K = 2560, N = 9728 (qwen3-4b's MLP up-projection
// over 4096 tokens): 2 M N K = 204.0 G int8 operations at the data
// sheet's 1,979 TOPS = 0.1031 ms; bytes 10.5 + 24.9 MB in, 159.4 MB out
// (int32) = 194.8 MB at 3.35 TB/s = 0.058 ms.  The operations bound it,
// and only `wgmma` reaches the int8 tensor-core rate.
//
// Design.
// - Operands.  The s8 `wgmma` reads both operands K-major from shared
//   memory (PTX allows the transpose only for 16-bit types).  a (M, K)
//   is K-major already; b is not, so a pack pre-pass on the same stream
//   writes bT (N, K16) (K16: K rounded up to 16, zero-filled) through
//   64 x 64-byte tiles in shared memory, 16-byte loads and stores where
//   the shapes allow.  a is read in place unless TMA cannot take it (K
//   % 16 != 0 or a not 16-byte aligned: TMA needs 16-byte bases and
//   strides); then a second pre-pass copies it to a (M, K16) scratch.
//   The caller allocates both scratch buffers; the kernel allocates
//   nothing.
// - Main loop.  A 128 x 256 output tile a block: two consumer
//   warpgroups of 64 x 256 each, 128 int32 accumulators a thread, issue
//   `wgmma.mma_async.m64n256k32.s32.s8.s8` from shared memory.  A
//   producer warp keeps a ring of STAGES shared-memory stages full with
//   TMA 2D loads (128-byte swizzle, so one K step is BK = 128 bytes: an
//   a tile of 16 KB and a bT tile of 32 KB); each stage has a "full"
//   mbarrier (expect_tx of the stage's bytes) and an "empty" one that
//   every consumer warp arrives on once `wgmma.wait_group` says its
//   products have read the stage.  Within a swizzle atom the
//   descriptors advance 32 bytes per k32 step.  `setmaxnreg` moves
//   registers from the producer warpgroup to the consumers.
// - Persistent walk.  One block an SM walks the output tiles in groups
//   of GROUP_M tile rows, so that blocks running at the same time share
//   a rows and bT columns in L2.  The producer runs ahead into the next
//   tile while the consumers store the last one, so the loads of a tile
//   overlap the previous tile's epilogue.
// - Epilogue.  Where N % 4 == 0 (16-byte output rows) each consumer
//   warpgroup writes its 64 x 256 result in 64 x 32 chunks to two
//   shared-memory buffers in the 128-byte swizzle and stores each with
//   TMA, writing the next chunk while the last one drains; otherwise it
//   stores straight from the registers, masked.  The dequant scales are
//   loaded when a tile starts, so the main loop hides their latency;
//   the tile's 256 column scales reach every thread through shared
//   memory.
// - Edges.  TMA zero-fills rows and columns past M, N and K16 on loads
//   and drops them on stores; direct stores are masked.  K = 0 writes
//   the epilogue over zero accumulators; M = 0 or N = 0 launches
//   nothing.
//
// What holds it back (PERF.md): the pack pre-pass, about 14% of the
// time at the shape above; the epilogue, which the two consumer
// warpgroups run between tiles instead of multiplying; and 1,216 tiles
// on 132 SMs, 9.2 rounds run as 10.

#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 256, BK = 128;   // BK: bytes of K a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                  // warpgroups, 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// epilogue staging: 64 rows x 32 columns of 4 bytes, OUT_BUFS buffers a
// consumer warpgroup
constexpr int OUT_COLS = 32, OUT_BYTES = 64 * OUT_COLS * 4, OUT_BUFS = 2;
// the stages, the staging buffers, the tile's column scales, a full and
// an empty barrier a stage, and slack to align it all to the 1,024 bytes
// of a 128-byte swizzle pattern
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES +
                           OUT_BUFS * CONSUMERS * OUT_BYTES + BN * 4 +
                           2 * STAGES * 8 + 1024;
constexpr int ACC = BN / 2;                   // accumulators a thread
constexpr int GROUP_M = 8;
constexpr int PACK = 64;                      // pack tile, bytes a side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One box of `map` at (x = K byte, y = row) into shared memory at `dst`;
// its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
         "r"(y)
      : "memory");
}

// One box of `map` at (x = column, y = row) from shared memory at `src`,
// in the bulk group of the issuing thread.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` among the `count` threads that reach it.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// -- wgmma ------------------------------------------------------------------

// Shared-memory descriptor of a K-major tile in the 128-byte swizzle
// layout TMA writes: rows of 128 bytes, 8-row groups 1,024 bytes apart
// (stride byte offset), leading byte offset unused (1), base offset 0
// since every tile starts on a 1,024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int32_t (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= a (64 x 32, K-major) * b (256 x 32, K-major)^T; d is added to
// unless `accumulate` is 0.  Accumulator i of thread t of the
// warpgroup: row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[ACC], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// -- the GEMM ---------------------------------------------------------------

// Output tile `t` of the walk: GROUP_M tile rows at a time, down the
// rows of a group before moving one tile column on.
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n, g = t / per_group;
  const int first = g * GROUP_M, rows = min(tiles_m - first, GROUP_M);
  const int r = t - g * per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// a value below FLT_MIN in magnitude becomes a zero of its sign
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

// (f32(acc) * sa[m]) * sb[n], rounded and flushed as the reference's
// compiled code rounds and flushes it; the scales come in flushed.
__device__ __forceinline__ float dequant(int32_t acc, float s_row,
                                         float s_col) {
  return ftz(__fmul_rn(ftz(__fmul_rn(__int2float_rn(acc), s_row)), s_col));
}

template <bool DEQUANT>
__device__ __forceinline__ void store_pair(void* out, float s_row,
                                           float2 s_col, int row, int col,
                                           int M, int N, bool pairs,
                                           int32_t v0, int32_t v1) {
  if (row >= M || col >= N) return;
  const size_t o = (size_t)row * N + col;
  const bool both = col + 1 < N;
  if (DEQUANT) {
    float* p = (float*)out + o;
    const float f0 = dequant(v0, s_row, s_col.x);
    if (!both) {
      p[0] = f0;
      return;
    }
    const float f1 = dequant(v1, s_row, s_col.y);
    if (pairs) {
      *(float2*)p = make_float2(f0, f1);
    } else {
      p[0] = f0;
      p[1] = f1;
    }
  } else {
    int32_t* p = (int32_t*)out + o;
    if (both && pairs) {
      *(int2*)p = make_int2(v0, v1);
    } else {
      p[0] = v0;
      if (both) p[1] = v1;
    }
  }
}

template <bool DEQUANT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const __grid_constant__ CUtensorMap tm_a,
           const __grid_constant__ CUtensorMap tm_b,
           const __grid_constant__ CUtensorMap tm_out,
           const float* __restrict__ sa, const float* __restrict__ sb,
           void* __restrict__ out, int M, int N, int nk, int tiles_m,
           int tiles_n, int staged) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t s_a = base, s_b = base + STAGES * A_BYTES;
  const uint32_t s_out = s_b + STAGES * B_BYTES;
  const uint32_t s_scale = s_out + OUT_BUFS * CONSUMERS * OUT_BYTES;
  const uint32_t full = s_scale + BN * 4, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int ntiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<uint64_t>(&tm_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<uint64_t>(&tm_b)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int tm, tn;
        tile_of(t, tiles_m, tiles_n, tm, tn);
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s_a + stage * A_BYTES, &tm_a, bar, ks * BK, tm * BM);
          tma_load(s_b + stage * B_BYTES, &tm_b, bar, ks * BK, tn * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const bool pairs = N % 2 == 0;   // 8-byte stores stay aligned
    int32_t acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int tm, tn;
      tile_of(t, tiles_m, tiles_n, tm, tn);
      const int r0 = tm * BM + 64 * c + 16 * warp + lane / 4;
      const int c0 = tn * BN + 2 * (lane % 4);
      // the epilogue's scales, loaded now so that the main loop hides
      // their latency: this thread's two rows, and one of the tile's
      // columns for the shared row of column scales
      float s_row[2] = {0.f, 0.f}, s_mine = 0.f;
      if (DEQUANT) {
        const int mine = tn * BN + 128 * c + tid;
        if (r0 < M) s_row[0] = ftz(sa[r0]);
        if (r0 + 8 < M) s_row[1] = ftz(sa[r0 + 8]);
        if (mine < N) s_mine = ftz(sb[mine]);
      }
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da = sw128_desc(s_a + stage * A_BYTES + c * 64 * BK);
        const uint64_t db = sw128_desc(s_b + stage * B_BYTES);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)   // 32 bytes = 2 in the field
          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
        wgmma_commit();
        fence_acc(acc);
        // the previous step's products are done: its stage is free
        wgmma_wait<1>();
        fence_acc(acc);
        if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      if (DEQUANT) {
        // both consumer warpgroups are past the last tile's epilogue
        named_barrier(3, 128 * CONSUMERS);
        asm volatile("st.shared.f32 [%0], %1;"
                     :: "r"(s_scale + 4 * (128 * c + tid)), "f"(s_mine)
                     : "memory");
        named_barrier(3, 128 * CONSUMERS);
      }
      // the column scales of the 8 columns a thread holds in each
      // 32-column chunk
      auto col_scales = [&](int j, float2 (&s_col)[OUT_COLS / 8]) {
#pragma unroll
        for (int g = 0; g < OUT_COLS / 8; ++g) {
          const uint32_t at = s_scale + 4 * (OUT_COLS * j + 8 * g) +
                              8 * (lane % 4);
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                       : "=f"(s_col[g].x), "=f"(s_col[g].y)
                       : "r"(at) : "memory");
        }
      };
      if (staged) {
        // 64 x 32 chunks through shared memory, in the 128-byte swizzle
        // of `tm_out`, stored by TMA (which clips at M and N) while the
        // next chunk is written
#pragma unroll
        for (int j = 0; j < BN / OUT_COLS; ++j) {
          float2 s_col[OUT_COLS / 8];
          if (DEQUANT) col_scales(j, s_col);
          const uint32_t buf =
              s_out + (OUT_BUFS * c + j % OUT_BUFS) * OUT_BYTES;
          if (tid == 0) bulk_wait_read<OUT_BUFS - 1>();   // buf is free
          named_barrier(1 + c, 128);
#pragma unroll
          for (int g = 0; g < OUT_COLS / 8; ++g)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * (4 * j + g) + 2 * h;
              uint32_t v0 = acc[i], v1 = acc[i + 1];
              if (DEQUANT) {
                v0 = __float_as_uint(dequant(acc[i], s_row[h], s_col[g].x));
                v1 = __float_as_uint(
                    dequant(acc[i + 1], s_row[h], s_col[g].y));
              }
              const int row = 16 * warp + lane / 4 + 8 * h;
              const int q = 2 * g + (lane % 4) / 2;   // 16-byte chunk
              const uint32_t at =
                  buf + row * 128 + ((q ^ (row % 8)) << 4) + 8 * (lane % 2);
              asm volatile("st.shared.v2.b32 [%0], {%1, %2};"
                           :: "r"(at), "r"(v0), "r"(v1) : "memory");
            }
          fence_async_shared();
          named_barrier(1 + c, 128);
          if (tid == 0) {
            tma_store(&tm_out, buf, tn * BN + OUT_COLS * j,
                      tm * BM + 64 * c);
            bulk_commit();
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / OUT_COLS; ++j) {
          float2 s_col[OUT_COLS / 8];
          if (DEQUANT) col_scales(j, s_col);
#pragma unroll
          for (int g = 0; g < OUT_COLS / 8; ++g)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * (4 * j + g) + 2 * h;
              store_pair<DEQUANT>(out, s_row[h], s_col[g], r0 + 8 * h,
                                  c0 + OUT_COLS * j + 8 * g, M, N, pairs,
                                  acc[i], acc[i + 1]);
            }
        }
      }
    }
    if (tid == 0) bulk_wait_all();   // the last stores have read smem
  }
}

// -- pre-passes ---------------------------------------------------------------

// bT[n][k] = b[k][n] for k < K, 0 for K <= k < K16: a 64 x 64-byte tile
// a block through shared memory, 16 bytes a thread each way (loads
// byte by byte unless N % 16 == 0 and b is 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(256)
pack_bt_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int K,
               int N, int K16) {
  __shared__ __align__(16) uint32_t tile[PACK][PACK / 4 + 1];   // [k][n]
  const int k0 = blockIdx.y * PACK, n0 = blockIdx.x * PACK;
  const int row = threadIdx.x / 4, chunk = (threadIdx.x % 4) * 16;
  {
    const int k = k0 + row, n = n0 + chunk;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const int8_t* src = b + (size_t)k * N + n;
    if (VEC && k < K && n < N) {
      const uint4 v = *(const uint4*)src;
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if (!VEC && k < K) {
      for (int j = 0; j < 16 && n + j < N; ++j)
        w[j / 4] |= (uint32_t)(uint8_t)src[j] << (8 * (j % 4));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[row][chunk / 4 + i] = w[i];
  }
  __syncthreads();
  const int n = n0 + row, k = k0 + chunk;
  if (n >= N || k >= K16) return;   // K16 % 16 == 0: whole chunks
  const uint8_t* t = (const uint8_t*)tile;
  constexpr int LD = 4 * (PACK / 4 + 1);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[i] |= (uint32_t)t[(chunk + 4 * i + j) * LD + row] << (8 * j);
  }
  *(uint4*)(bt + (size_t)n * K16 + k) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ap (M, K16) = a (M, K) zero-padded, 4 bytes a thread.
__global__ void pad_a_kernel(const int8_t* __restrict__ a,
                             int8_t* __restrict__ ap, int M, int K, int K16) {
  const size_t words = (size_t)M * (K16 / 4);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < words;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / (K16 / 4);
    const int k = (int)(i % (K16 / 4)) * 4;
    uint32_t w = 0;
    for (int j = 0; j < 4 && k + j < K; ++j)
      w |= (uint32_t)(uint8_t)a[m * K + k + j] << (8 * j);
    ((uint32_t*)ap)[i] = w;
  }
}

// K = 0: the epilogue over zero accumulators.
template <bool DEQUANT>
__global__ void zero_k_kernel(const float* __restrict__ sa,
                              const float* __restrict__ sb,
                              void* __restrict__ out, int M, int N) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (DEQUANT)
      ((float*)out)[i] =
          __fmul_rn(__fmul_rn(0.0f, sa[i / N]), sb[i % N]);
    else
      ((int32_t*)out)[i] = 0;
  }
}

// -- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) matrix of `esize`-byte elements in boxes of
// box_cols x box_rows in the 128-byte swizzle (box_cols * esize = 128);
// loads past the edges read 0 and stores past them are dropped.
bool encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
            int esize, int rows, int cols, int box_cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

int pack_bt(const int8_t* b, int8_t* bt, int K, int N, int k16,
            cudaStream_t s) {
  if ((uintptr_t)bt % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PACK - 1) / PACK, (k16 + PACK - 1) / PACK);
  if (N % 16 == 0 && (uintptr_t)b % 16 == 0)
    pack_bt_kernel<true><<<grid, 256, 0, s>>>(b, bt, K, N, k16);
  else
    pack_bt_kernel<false><<<grid, 256, 0, s>>>(b, bt, K, N, k16);
  return (int)cudaGetLastError();
}

int grid_for(size_t work, int sms) {
  const size_t blocks = (work + 255) / 256, most = (size_t)sms * 8;
  return (int)(blocks < most ? blocks : most);
}

template <bool DEQUANT>
int launch(const void* a, const void* b, void* a_pad, void* bt,
           const void* sa, const void* sb, void* out, int M, int N, int K,
           void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const auto s = (cudaStream_t)stream;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const auto SA = (const float*)sa;
  const auto SB = (const float*)sb;
  if (K == 0) {
    zero_k_kernel<DEQUANT><<<grid_for((size_t)M * N, sms), 256, 0, s>>>(
        SA, SB, out, M, N);
    return (int)cudaGetLastError();
  }
  const int k16 = (K + 15) / 16 * 16;
  const void* A = a;
  if (a_pad != nullptr) {
    if ((uintptr_t)a_pad % 16) return (int)cudaErrorInvalidValue;
    pad_a_kernel<<<grid_for((size_t)M * (k16 / 4), sms), 256, 0, s>>>(
        (const int8_t*)a, (int8_t*)a_pad, M, K, k16);
    if (int e = (int)cudaGetLastError()) return e;
    A = a_pad;
  } else if (K % 16 || (uintptr_t)a % 16) {
    return (int)cudaErrorInvalidValue;   // TMA cannot read a in place
  }
  if (int e = pack_bt((const int8_t*)b, (int8_t*)bt, K, N, k16, s)) return e;

  // the output goes through TMA where its rows are 16-byte aligned
  const int staged = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  CUtensorMap tm_a, tm_b, tm_out = {};
  const auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!encode(&tm_a, A, U8, 1, M, k16, BK, BM) ||
      !encode(&tm_b, bt, U8, 1, N, k16, BK, BN) ||
      (staged && !encode(&tm_out, out, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, M,
                         N, OUT_COLS, 64)))
    return -1;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int ntiles = tiles_m * tiles_n;
  auto kernel = qmm_kernel<DEQUANT>;
  if (int e = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES))
    return e;
  kernel<<<ntiles < sms ? ntiles : sms, THREADS, SMEM_BYTES, s>>>(
      tm_a, tm_b, tm_out, SA, SB, out, M, N, (k16 + BK - 1) / BK, tiles_m,
      tiles_n, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 on success), or -1 when a TMA descriptor
// could not be encoded.  a_pad is null when a is read in place (K % 16
// == 0 and a 16-byte aligned), else an (M, K16) scratch; bt is an
// (N, K16) scratch; both 16-byte aligned.
extern "C" int qmatmul_i32_launch(const void* a, const void* b, void* a_pad,
                                  void* bt, void* out, int M, int N, int K,
                                  void* stream) {
  return launch<false>(a, b, a_pad, bt, nullptr, nullptr, out, M, N, K,
                       stream);
}

extern "C" int qmatmul_dequant_launch(const void* a, const void* b,
                                      void* a_pad, void* bt, const void* sa,
                                      const void* sb, void* out, int M, int N,
                                      int K, void* stream) {
  return launch<true>(a, b, a_pad, bt, sa, sb, out, M, N, K, stream);
}

// The pack pre-pass alone: bt (N, K16) = b (K, N) transposed and
// zero-padded.
extern "C" int qmatmul_pack_b_launch(const void* b, void* bt, int K, int N,
                                     void* stream) {
  if (K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const int k16 = (K + 15) / 16 * 16;
  if (k16 == 0 || N == 0) return 0;
  return pack_bt((const int8_t*)b, (int8_t*)bt, K, N, k16,
                 (cudaStream_t)stream);
}

// The GEMM's configuration: BM, BN, BK, STAGES, THREADS, dynamic shared
// bytes, and the compiled kernel's registers and local bytes a thread.
extern "C" int qmatmul_config(int* info) {
  cudaFuncAttributes attr;
  if (int e = (int)cudaFuncGetAttributes(&attr, qmm_kernel<false>)) return e;
  const int v[8] = {BM, BN, BK, STAGES, THREADS, SMEM_BYTES, attr.numRegs,
                    (int)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}
