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
//     adds and multiplies (signed overflow is undefined in C++).  That
//     sum is associative and commutative, so any tap order, a tap split
//     or merged, and a zero weight added give the same bits;
//   * `>>` on a negative int32 is the arithmetic shift, the floor of the
//     division, as `jnp.right_shift` on int32;
//   * the rounding is half-UP: the bias 2^(shift-1) is added before the
//     floor shift (unlike `fused_band.cu`'s half-even `rhe_shift`), and
//     there is no bias and no shift when shift <= 0;
//   * the clip comes after the shift: min(max(v, qmin), qmax), as
//     `jnp.clip` (so qmax wins if qmin > qmax).
//
// Bound, at one 1080x1920 frame (int32 in, 1082x1922 padded, and int32
// out): 8.32 MB read + 8.29 MB written = 16.6 MB at 3.35 TB/s = 0.0050
// ms.  The operations (a multiply and an add per tap and pixel: 24.9 M
// for Sobel's 6 taps, 0.0004 ms at 67 TOPS) come far below, so the
// bytes bound it.
//
// Design: a line-buffer walk on a persistent grid.
//   * Work.  The output is cut into column strips of SW = 128 columns;
//     the strips' rows, strip after strip, form one sequence, and each
//     block takes an equal contiguous share of it (to a row).  A share
//     is one or two runs: rows r0..r1 of one strip.  A run walks down
//     in steps of STEP = 32 output rows.
//   * Line buffer.  A run keeps its input rows in a shared-memory ring
//     of DEPTH + 1 steps plus 2hy rows: step k needs padded rows
//     r0 + k STEP .. + STEP + 2hy, of which only STEP are new, so every
//     input row is read once per strip, plus 2hy rows once per run.
//     At 1080p the carry costs 2-4% (the halo rows a step would read
//     again come from L2), but only the carried ring fits wide halos:
//     DEPTH + 1 whole windows take 3 (STEP + 2hy) slots, 284,928 B at
//     a 40x40 halo, where the carried ring takes 149,248 B of the
//     MAX_SMEM = 230,400 B a block may have.
//   * Asynchronous rows.  Rows come in through 16-byte `cp.async`
//     copies, one commit group per step, DEPTH = 2 steps ahead of the
//     step being computed.  The padded pitch is not a multiple of 16
//     bytes (1922 x 4 at 1080p), so each row is copied from its 16-byte
//     aligned-down address and lies 0..3 ints into its ring slot; a
//     table of (slot, offset) per row of the step's window is built in
//     shared memory once a step.
//   * Register tiling.  A warp owns STEP / 8 = 4 rows of a step, each
//     lane 4 adjacent columns of them.  For the footprints built as
//     templates (3x3, 5x5, 1xN and Nx1 for N = 3, 5, 7), a lane reads
//     each of its input rows once as 16-byte loads (a switch on the
//     row's offset keeps every index a constant) and applies every tap
//     that touches that row to every output it feeds, with a dense
//     weight grid from the parameter bank.  Where that grid is an
//     outer product of integer vectors (Sobel, binomial blurs: the host
//     factors it), a lane first sums each input row horizontally, then
//     adds those sums down: exact, as the sums are taken mod 2^32,
//     with fewer multiply-adds (5x5: 15 an output, not 25; 3x3: 7.5,
//     not 9).  Other stencils (up to MAX_TAPS taps and a halo that fits
//     shared memory) take a generic loop over a tap table in shared
//     memory; there a lane's 4 columns are 32 apart, so a warp's loads
//     of one tap and row are 32 consecutive ints, one conflict-free
//     wavefront at any offset.
//   * Stores: the templates store 4 outputs as one 16-byte store where
//     W % 4 == 0 and the output is 16-byte aligned, else masked 4-byte
//     stores; the generic loop 4-byte stores, 32 consecutive a warp.
//   * Taps travel as a kernel parameter; no per-pixel table decoding
//     and no division per element.
//
// Left for later: the input is the padded int32 copy the caller made;
// a kernel that clamps its own reads and takes the narrow container
// would move a quarter of the bytes, and the front end's elementwise
// passes around the kernel (quantize, pad, dequantize) could be fused.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 128;   // repro_torch/kernels/stencil/kernel.py
constexpr int TX = 32;          // lanes across a strip
constexpr int TY = 8;           // warps down a step
constexpr int THREADS = TX * TY;
constexpr int SW = 4 * TX;      // strip width, output columns
constexpr int R = 4;            // output rows a lane computes per step
constexpr int STEP = TY * R;    // output rows a block computes per step
constexpr int DEPTH = 2;        // steps in flight ahead of the one computed
constexpr int BLOCKS_PER_SM = 2;
// dynamic shared memory left beside the generic path's static tap table
constexpr int MAX_SMEM = 232448 - 16 * MAX_TAPS;

// The generic path: n taps (dy, dx, w).  Templates: w is the dense
// (2hy+1) x (2hx+1) grid, and where n is 1 it is the outer product of
// a = dy[0..2hy] and b = dx[0..2hx].
struct Taps {
  int n;
  int dy[MAX_TAPS];
  int dx[MAX_TAPS];
  int w[MAX_TAPS];
};

struct Geo {
  const int32_t* xp;
  int32_t* out;
  long long total;      // strips * H: the rows of the walk
  int H, W, Wp, hy, hx, shift, qmin, qmax;
  int pitch;            // ints per ring slot (a multiple of 4)
  int nslot;            // slots in the ring
  int win;              // rows of a step's window: STEP + 2hy
  int vec;              // 16-byte output stores allowed
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  // every group but the N committed last has landed
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v[k] = p[O + k] for k < N, read as 16-byte loads (p 16-byte aligned)
template <int O, int N>
__device__ __forceinline__ void load_at(const int32_t* p, int (&v)[N]) {
  constexpr int NC = (O + N + 3) / 4;
  int t[4 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int4 q = *(const int4*)(p + 4 * c);
    t[4 * c] = q.x;
    t[4 * c + 1] = q.y;
    t[4 * c + 2] = q.z;
    t[4 * c + 3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = t[O + k];
}

// the same with the offset known only at run time (uniform in a warp)
template <int N>
__device__ __forceinline__ void load_seg(const int32_t* p, int off,
                                         int (&v)[N]) {
  switch (off) {
    case 0: load_at<0>(p, v); break;
    case 1: load_at<1>(p, v); break;
    case 2: load_at<2>(p, v); break;
    default: load_at<3>(p, v); break;
  }
}

__device__ __forceinline__ int32_t finish(uint32_t acc, const Geo& g) {
  int32_t v = (int32_t)acc;
  if (g.shift > 0)                     // round half up, arithmetic shift
    v = (int32_t)(acc + (1u << (g.shift - 1))) >> g.shift;
  return min(max(v, g.qmin), g.qmax);
}

// HY < 0: the generic path (halo and taps at run time); otherwise the
// template of footprint (2HY + 1) x (2HX + 1).
template <int HY, int HX>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
stencil_kernel(const Geo g, const Taps taps) {
  constexpr bool GENERIC = HY < 0;
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int4 tap[GENERIC ? MAX_TAPS : 1];   // (dy+hy, dx+hx, w, -)
  int32_t* ring = smem;
  int* info = smem + g.nslot * g.pitch;          // [2][win]: slot*pitch+off
  const int hy = GENERIC ? g.hy : HY, hx = GENERIC ? g.hx : HX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const unsigned xoff = (unsigned)(((uintptr_t)g.xp >> 2) & 3);

  if (GENERIC)   // visible after the walk's first barrier
    for (int k = threadIdx.x; k < taps.n; k += THREADS)
      tap[k] = make_int4(taps.dy[k] + hy, taps.dx[k] + hx, taps.w[k], 0);

  long long L0 = blockIdx.x * g.total / gridDim.x;
  const long long L1 = (blockIdx.x + 1) * g.total / gridDim.x;
  while (L0 < L1) {
    // one run: output rows r0..r1 of strip `strip`
    const int strip = (int)(L0 / g.H);
    const int r0 = (int)(L0 - (long long)strip * g.H);
    const int r1 = (int)min((long long)g.H, r0 + (L1 - L0));
    L0 += r1 - r0;
    const int c0 = strip * SW;
    const int cols = min(SW, g.W - c0) + 2 * hx;   // padded columns
    const int pend = r1 + 2 * hy;                  // padded rows' end
    const int nsteps = (r1 - r0 + STEP - 1) / STEP;

    // the ring slot of padded row p
    auto slot = [&](int p) { return (p - r0) % g.nslot; };
    // a row is copied in 16-byte chunks from its 16-byte aligned-down
    // address, so it lies offset(p) = 0..3 ints into its slot
    auto offset = [&](int p) {
      return (int)((xoff + (unsigned)((size_t)p * g.Wp + c0)) & 3);
    };
    // start the copies of step k's new rows (one commit group, maybe
    // empty): warp w copies rows w, w + 8, ..., lane l chunks l, l + 32
    auto issue = [&](int k) {
      if (k < nsteps) {
        const int a = k > 0 ? r0 + k * STEP + 2 * hy : r0;
        const int b = min(pend, r0 + (k + 1) * STEP + 2 * hy);
        for (int p = a + ty; p < b; p += TY) {
          const int off = offset(p);
          const int32_t* src = g.xp + (size_t)p * g.Wp + c0 - off;
          int32_t* dst = ring + slot(p) * g.pitch;
          const int nch = (off + cols + 3) >> 2;
          for (int ch = tx; ch < nch; ch += TX)
            cp_async16(dst + 4 * ch, src + 4 * ch);
        }
      }
      cp_async_commit();
    };
    auto set_info = [&](int k) {
      int* inf = info + (k & 1) * g.win;
      for (int i = threadIdx.x; i < g.win; i += THREADS) {
        const int p = r0 + k * STEP + i;
        inf[i] = slot(p) * g.pitch + offset(p);
      }
    };

    for (int k = 0; k < DEPTH; ++k) issue(k);
    set_info(0);
    for (int k = 0; k < nsteps; ++k) {
      cp_async_wait<DEPTH - 1>();  // step k landed
      __syncthreads();
      issue(k + DEPTH);            // into the slots step k - 1 has left
      set_info(k + 1);     // the other table: step k - 1 is done with it

      // this lane: output rows rs .. rs + R - 1, 4 columns (see the stores)
      const int* rin = info + (k & 1) * g.win + ty * R;
      const int rs = r0 + k * STEP + ty * R;
      uint32_t acc[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;
      if constexpr (GENERIC) {
        // the lane's columns are tx + 32c: a warp's 4-byte loads of a
        // tap and row are 32 consecutive ints, one conflict-free
        // wavefront at any offset
        for (int t = 0; t < taps.n; ++t) {
          const int4 tp = tap[t];
          const uint32_t w = (uint32_t)tp.z;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int32_t* p = ring + rin[j + tp.x] + tp.y + tx;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] += w * (uint32_t)p[32 * c];
          }
        }
      } else if (taps.n) {
        // the grid is a[dy] b[dx] (a in taps.dy, b in taps.dx): each
        // input row's 4 horizontal sums once, then a multiply-add per
        // output row it feeds
#pragma unroll
        for (int i = 0; i < R + 2 * HY; ++i) {
          const int e = rin[i];
          int v[4 + 2 * HX];
          load_seg(ring + (e & ~3) + 4 * tx, e & 3, v);
          uint32_t h[4] = {0, 0, 0, 0};
#pragma unroll
          for (int dx = 0; dx <= 2 * HX; ++dx)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              h[c] += (uint32_t)taps.dx[dx] * (uint32_t)v[c + dx];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int dy = i - j;        // tap row (dy + hy) of output j
            if (dy < 0 || dy > 2 * HY) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] += (uint32_t)taps.dy[dy] * h[c];
          }
        }
      } else {
        constexpr int KX = 2 * HX + 1;
#pragma unroll
        for (int i = 0; i < R + 2 * HY; ++i) {
          const int e = rin[i];
          int v[4 + 2 * HX];
          load_seg(ring + (e & ~3) + 4 * tx, e & 3, v);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int dy = i - j;        // tap row (dy + hy) of output j
            if (dy < 0 || dy > 2 * HY) continue;
#pragma unroll
            for (int dx = 0; dx < KX; ++dx) {
              const uint32_t w = (uint32_t)taps.w[dy * KX + dx];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[j][c] += w * (uint32_t)v[c + dx];
            }
          }
        }
      }
      if constexpr (GENERIC) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = rs + j;
          if (row >= r1) break;
          int32_t* o = g.out + (size_t)row * g.W;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = c0 + tx + 32 * c;
            if (col < g.W) o[col] = finish(acc[j][c], g);
          }
        }
      } else if (c0 + 4 * tx < g.W) {
        const int cx = c0 + 4 * tx;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = rs + j;
          if (row >= r1) break;
          int32_t* o = g.out + (size_t)row * g.W + cx;
          if (g.vec) {      // W % 4 == 0: all 4 columns are in the image
            *(int4*)o = make_int4(finish(acc[j][0], g), finish(acc[j][1], g),
                                  finish(acc[j][2], g), finish(acc[j][3], g));
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (cx + c < g.W) o[c] = finish(acc[j][c], g);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();       // the ring is free for the next run
  }
}

using Kernel = void (*)(const Geo, const Taps);

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a < 0 ? -a : a;
}

// Integers a (ky) and b (kx) with w[i][j] == a[i] b[j] exactly, where the
// ky x kx grid w has rank 1; false otherwise (or where w is all 0).
// b is a nonzero row divided by the gcd of its entries, so any rank-1
// integer grid factors over the integers.
bool factor(const int* w, int ky, int kx, int* a, int* b) {
  int r = 0;
  while (r < ky * kx && w[r] == 0) ++r;
  if (r == ky * kx) return false;
  r /= kx;
  long long g = 0;
  for (int j = 0; j < kx; ++j) g = gcd(g, w[r * kx + j]);
  int j0 = 0;
  while (w[r * kx + j0] == 0) ++j0;
  for (int j = 0; j < kx; ++j) b[j] = (int)(w[r * kx + j] / g);
  for (int i = 0; i < ky; ++i) {
    if (w[i * kx + j0] % b[j0] != 0) return false;
    a[i] = w[i * kx + j0] / b[j0];
    for (int j = 0; j < kx; ++j)
      if ((long long)a[i] * b[j] != w[i * kx + j]) return false;
  }
  return true;
}

// ints in a ring slot: a strip's padded row and up to 3 ints of offset,
// in whole 16-byte chunks
int slot_pitch(int hx) { return 4 * ((SW + 2 * hx + 3 + 3) / 4); }

// slots in the ring: DEPTH + 1 steps' new rows and the 2hy carried
int ring_slots(int hy) { return (DEPTH + 1) * STEP + 2 * hy; }

// Dynamic shared memory of one block for halo (hy, hx), in bytes: the
// ring and two tables of a window's rows.  The wrapper mirrors it
// (`kernel.py:_stencil_smem_bytes`).
long long smem_bytes(int hy, int hx) {
  return 4 * ((long long)ring_slots(hy) * slot_pitch(hx) + 2 * (STEP + 2 * hy));
}

// the template for halo (hy, hx), or null
Kernel pick_template(int hy, int hx) {
  switch (hy * 8 + hx) {
    case 1 * 8 + 1: return stencil_kernel<1, 1>;
    case 2 * 8 + 2: return stencil_kernel<2, 2>;
    case 0 * 8 + 1: return stencil_kernel<0, 1>;
    case 0 * 8 + 2: return stencil_kernel<0, 2>;
    case 0 * 8 + 3: return stencil_kernel<0, 3>;
    case 1 * 8 + 0: return stencil_kernel<1, 0>;
    case 2 * 8 + 0: return stencil_kernel<2, 0>;
    case 3 * 8 + 0: return stencil_kernel<3, 0>;
    default: return nullptr;
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
  const long long smem = smem_bytes(hy, hx);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;

  Taps t = {};
  Kernel fn = pick_template(hy, hx);
  if (fn) {   // the dense grid; repeated positions add (mod 2^32)
    const int kx = 2 * hx + 1;
    for (int k = 0; k < n_taps; ++k) {
      int& cell = t.w[(taps[3 * k] + hy) * kx + taps[3 * k + 1] + hx];
      cell = (int)((uint32_t)cell + (uint32_t)taps[3 * k + 2]);
    }
    t.n = factor(t.w, 2 * hy + 1, kx, t.dy, t.dx);
  } else {
    fn = stencil_kernel<-1, -1>;
    t.n = n_taps;
    for (int k = 0; k < n_taps; ++k) {
      t.dy[k] = taps[3 * k];
      t.dx[k] = taps[3 * k + 1];
      t.w[k] = taps[3 * k + 2];
    }
  }

  Geo g;
  g.xp = (const int32_t*)xp;
  g.out = (int32_t*)out;
  g.H = H;
  g.W = W;
  g.Wp = W + 2 * hx;
  g.hy = hy;
  g.hx = hx;
  g.shift = shift;
  g.qmin = qmin;
  g.qmax = qmax;
  g.pitch = slot_pitch(hx);
  g.win = STEP + 2 * hy;
  g.nslot = ring_slots(hy);
  g.vec = W % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int strips = (W + SW - 1) / SW;
  g.total = (long long)strips * H;

  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, fit = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &fit, (const void*)fn, THREADS, (size_t)smem)) != cudaSuccess)
    return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  // one resident wave, each block at least a step's rows
  long long blocks = (long long)sms * (fit < BLOCKS_PER_SM ? fit
                                                           : BLOCKS_PER_SM);
  if (blocks > (g.total + STEP - 1) / STEP) blocks = (g.total + STEP - 1) / STEP;
  void* args[] = {&g, &t};
  e = cudaLaunchKernel((const void*)fn, dim3((unsigned)blocks),
                       dim3(THREADS), args, (size_t)smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
