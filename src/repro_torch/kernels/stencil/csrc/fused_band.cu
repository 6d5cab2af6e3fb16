// fused_band.cu — one rate island of a fixed-point image pipeline, run
// over every (image, band) of its row-band schedule.
//
// Replaces the TPU kernel src/repro/kernels/stencil/kernel.py:
// fused_pipeline (its `_fused_kernel` body, `eval_band` geometry and
// `band_output`; pallas_call at kernel.py:321).  The island is not
// compiled into code: repro_torch/kernels/stencil/kernel.py:encode_program
// flattens it into tables that this one kernel interprets, and
// `fused_pipeline_reference` there walks the same tables with torch ops.
//
// Design.  The grid is min(B * nbands, 4 * SMs) blocks; each block loops
// over (image, band) work items with stride gridDim.x and evaluates the
// island's compute stages one after another, one thread per tile pixel,
// with __syncthreads() between stages.  Input bands are read straight
// from the input tensors (their edge-replicate clamp is an index clamp);
// every compute stage's band tile lives in a per-block GLOBAL-memory
// workspace in 8-byte slots (int64 for integer stages, f64 for
// float-stored ones).  They cannot stay in shared memory at this width:
// at W = 1920 one USM band is 4 stages x 8 rows x 1920 x 8 B = 0.5 MB and
// one HCD band holds 11 stages, against 227 KB of shared memory a block.
//
// Bound.  The least work is reading each input container once and
// writing each output container once: USM at 4 x 1080 x 1920 moves
// 2 B in + 2 B out per pixel, 33 MB, i.e. about 10 us at 3.35 TB/s.
// This kernel moves far more: each stage tile is written to and read
// back from the workspace as 8-byte slots (L2 absorbs part of it), and
// every tap and every postfix op is decoded from the tables per pixel.
// Keeping tiles on chip — column tiling, narrow containers in shared
// memory, cp.async/TMA double buffering of input bands (the Hopper form
// of `_fused_kernel_prefetch`) — is the planned redesign.
//
// Bit-exactness rules (each mirrored in the plain version):
//  * Floor division in the tap algebra: the source row is
//    clip(floor((rows_abs*sy + dy)/uy) - p_start, 0, pL-1) and the column
//    clip(floor((x*sx + dx)/ux), 0, pW-1); rows_abs*sy+dy is negative at
//    the top edge and p_start = i*step + lo is negative at band 0, where
//    C's truncating `/` differs whenever uy > 1.  See floordiv().
//  * Input rows: the band is loaded at b = clip(start, 0, H-L) and
//    reordered by clip(start + r, 0, H-1) - b, i.e. tile row r is input
//    row clip(start + r, 0, H-1).  Compute stages use the same rows_abs.
//  * rhe_shift: a left shift for t <= 0, else round-half-even on
//    p - ((p >> t) << t).  `>>` on a negative int64 is an arithmetic
//    shift on every CUDA target (shr.s64); shifts of negative values are
//    written as multiplies, which C++17 defines.
//  * Carriers: every integer stage accumulates in int64.  That is
//    bit-equal to the int32 and int32-pair carriers the lowering elects,
//    because lowering.ir._plan_intlinear elects them only after proving
//    no partial sum overflows them.  The non-dyadic finish is one
//    rint((double)acc * cscale).
//  * Saturation per lattice residue: bounds are looked up by
//    (rows_abs % my, x % mx); residues missing from the table keep the
//    union bounds; a later entry for the same residue wins.
//  * snap_expr: float-stored stages snap clip(rint(raw*2^b))/2^b; stages
//    whose phases mix betas build the per-residue float composite;
//    otherwise rint(raw*2^b), clip, integer store.
//  * No FMA contraction: built with --fmad=false, so `a*b + c` rounds
//    twice as numpy does (HCD's harris = det - k*trace^2 sits on rint ties).
//  * rint() is round-half-even; numpy's minimum/maximum propagate NaN
//    where fmin/fmax drop it, so they are written out; x**2 is x*x;
//    `/` and sqrt are IEEE-rounded in double.
//  * Containers: loads decode the code-selected container (u8 ... i64,
//    f64); stores cast after the clip.  Output rows >= H are masked.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Columns of the per-stage table; the same names in the same order as
// FIELDS in repro_torch/kernels/stencil/kernel.py.
// FIELDS-BEGIN
enum Field {
  F_KIND, F_STEP, F_LO, F_L, F_H, F_W, F_SY, F_SX, F_UY, F_UX,
  F_CODE, F_IN_SLOT, F_OUT_SLOT, F_WS_OFF, F_IS_FLOAT,
  F_TAP_BEGIN, F_TAP_COUNT, F_DYADIC, F_SM, F_T_SHIFT,
  F_INT_MIN, F_INT_MAX, F_PH_BEGIN, F_PH_COUNT, F_MY, F_MX,
  F_PROG_BEGIN, F_PROG_LEN, F_SNAP, F_FBASE,
  NF
};
// FIELDS-END

enum Kind { KIND_INPUT = 0, KIND_INTLINEAR = 1, KIND_EXPR = 2 };
enum Snap { SNAP_INT = 0, SNAP_FLOAT = 1, SNAP_MIXED = 2, SNAP_RAW = 3 };
enum Op {
  OP_REF, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SQR, OP_ABS, OP_SQRT,
  OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE, OP_SELECT
};
enum FConst { FC_STEP, FC_INV_STEP, FC_MIN, FC_MAX, FC_CSCALE };

constexpr int MAX_STACK = 32;
constexpr int MAX_IO = 32;

struct Params {
  const int64_t* stages;   // (n_stages, NF)
  const int64_t* taps;     // (n_taps, 4): parent, dy, dx, weight
  const int64_t* phases;   // (n_res, 5): ry, rx, qmin, qmax, fbase
  const int64_t* prog;     // (n_ops, 4): opcode, a, b, c
  const double* fconst;
  int64_t* ws;             // blocks x ws_per_block slots of 8 bytes
  int64_t ws_per_block;
  int n_stages;
  int batch;
  int64_t nbands;
  const void* in[MAX_IO];
  void* out[MAX_IO];
};

__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  // b > 0 (a sampling rate); C's `/` truncates toward zero
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ double clampd(double v, double lo, double hi) {
  // jnp.clip / np.clip: max then min, NaN passes through
  v = (v < lo) ? lo : v;
  return (v > hi) ? hi : v;
}

__device__ __forceinline__ int64_t rhe_shift(int64_t p, int64_t t) {
  if (t <= 0) return p * ((int64_t)1 << (-t));
  int64_t base = p >> t;                       // arithmetic: floor(p / 2^t)
  int64_t rem = p - base * ((int64_t)1 << t);
  int64_t half = (int64_t)1 << (t - 1);
  bool inc = rem > half || (rem == half && (base & 1) != 0);
  return base + (inc ? 1 : 0);
}

__device__ __forceinline__ int64_t load_int(const void* p, int64_t code,
                                            int64_t k) {
  switch (code) {
    case 0: return ((const uint8_t*)p)[k];
    case 1: return ((const int8_t*)p)[k];
    case 2: return ((const uint16_t*)p)[k];
    case 3: return ((const int16_t*)p)[k];
    case 4: return ((const uint32_t*)p)[k];
    case 5: return ((const int32_t*)p)[k];
    default: return ((const int64_t*)p)[k];
  }
}

__device__ __forceinline__ void store_int(void* p, int64_t code, int64_t k,
                                          int64_t v) {
  switch (code) {
    case 0: ((uint8_t*)p)[k] = (uint8_t)v; break;
    case 1: ((int8_t*)p)[k] = (int8_t)v; break;
    case 2: ((uint16_t*)p)[k] = (uint16_t)v; break;
    case 3: ((int16_t*)p)[k] = (int16_t)v; break;
    case 4: ((uint32_t*)p)[k] = (uint32_t)v; break;
    case 5: ((int32_t*)p)[k] = (int32_t)v; break;
    default: ((int64_t*)p)[k] = v; break;
  }
}

struct Band {
  const Params& P;
  const int64_t* ws;  // this block's workspace
  int64_t img;
  int64_t i;          // band step

  // the 8-byte slot of parent stage `p` at band-tile row `src`, column `col`
  __device__ __forceinline__ int64_t slot(int p, int64_t src,
                                          int64_t col) const {
    const int64_t* pd = P.stages + (int64_t)p * NF;
    if (pd[F_KIND] == KIND_INPUT) {
      int64_t H = pd[F_H], W = pd[F_W];
      int64_t row = clampi(i * pd[F_STEP] + pd[F_LO] + src, 0, H - 1);
      int64_t k = (img * H + row) * W + col;
      const void* base = P.in[pd[F_IN_SLOT]];
      if (pd[F_CODE] == 7) return ((const int64_t*)base)[k];  // f64 bits
      return load_int(base, pd[F_CODE], k);
    }
    return ws[pd[F_WS_OFF] + src * pd[F_W] + col];
  }

  // tap (parent p, dy, dx) of output pixel (rows_abs, x) of stage d
  __device__ __forceinline__ int64_t tap(const int64_t* d, int p, int64_t dy,
                                         int64_t dx, int64_t rows_abs,
                                         int64_t x) const {
    const int64_t* pd = P.stages + (int64_t)p * NF;
    int64_t p_start = i * pd[F_STEP] + pd[F_LO];
    int64_t src = clampi(floordiv(rows_abs * d[F_SY] + dy, d[F_UY]) - p_start,
                         0, pd[F_L] - 1);
    int64_t col = clampi(floordiv(x * d[F_SX] + dx, d[F_UX]), 0, pd[F_W] - 1);
    return slot(p, src, col);
  }

  // the f64 stage value of a tap (dequantized unless float-stored)
  __device__ __forceinline__ double tap_value(const int64_t* d, int p,
                                              int64_t dy, int64_t dx,
                                              int64_t rows_abs,
                                              int64_t x) const {
    const int64_t* pd = P.stages + (int64_t)p * NF;
    int64_t v = tap(d, p, dy, dx, rows_abs, x);
    if (pd[F_IS_FLOAT]) return __longlong_as_double(v);
    return (double)v * P.fconst[pd[F_FBASE] + FC_INV_STEP];
  }

  // per-residue int saturation bounds (union bounds where none matches)
  __device__ __forceinline__ void bounds(const int64_t* d, int64_t rows_abs,
                                         int64_t x, int64_t* qmin,
                                         int64_t* qmax) const {
    *qmin = d[F_INT_MIN];
    *qmax = d[F_INT_MAX];
    int64_t my = d[F_MY], mx = d[F_MX];
    for (int64_t e = 0; e < d[F_PH_COUNT]; ++e) {
      const int64_t* r = P.phases + (d[F_PH_BEGIN] + e) * 5;
      if (rows_abs % my == r[0] % my && x % mx == r[1] % mx) {
        *qmin = r[2];
        *qmax = r[3];
      }
    }
  }

  __device__ int64_t intlinear(const int64_t* d, int64_t rows_abs,
                               int64_t x) const {
    int64_t acc = 0;
    for (int64_t k = 0; k < d[F_TAP_COUNT]; ++k) {
      const int64_t* t = P.taps + (d[F_TAP_BEGIN] + k) * 4;
      acc += t[3] * tap(d, (int)t[0], t[1], t[2], rows_abs, x);
    }
    int64_t qmin, qmax;
    bounds(d, rows_abs, x, &qmin, &qmax);
    if (d[F_DYADIC]) {
      int64_t q = rhe_shift(d[F_SM] != 1 ? acc * d[F_SM] : acc, d[F_T_SHIFT]);
      return clampi(q, qmin, qmax);
    }
    double q = rint((double)acc * P.fconst[d[F_FBASE] + FC_CSCALE]);
    return (int64_t)clampd(q, (double)qmin, (double)qmax);
  }

  __device__ double snap_float(double raw, const double* fc) const {
    return clampd(rint(raw * fc[FC_STEP]), fc[FC_MIN], fc[FC_MAX]) /
           fc[FC_STEP];
  }

  // evaluate the postfix program; returns the stored 8-byte slot
  __device__ int64_t expr(const int64_t* d, int64_t rows_abs,
                          int64_t x) const {
    double stk[MAX_STACK];
    int sp = 0;
    const int64_t* ins = P.prog + d[F_PROG_BEGIN] * 4;
    for (int64_t k = 0; k < d[F_PROG_LEN]; ++k, ins += 4) {
      double a, b, c;
      switch (ins[0]) {
        case OP_REF:
          stk[sp++] = tap_value(d, (int)ins[1], ins[2], ins[3], rows_abs, x);
          break;
        case OP_CONST: stk[sp++] = P.fconst[ins[1]]; break;
        case OP_SQR: a = stk[sp - 1]; stk[sp - 1] = a * a; break;
        case OP_ABS: stk[sp - 1] = fabs(stk[sp - 1]); break;
        case OP_SQRT: stk[sp - 1] = sqrt(stk[sp - 1]); break;
        case OP_SELECT:
          c = stk[--sp]; b = stk[--sp]; a = stk[sp - 1];
          stk[sp - 1] = (a != 0.0) ? b : c;
          break;
        default:
          b = stk[--sp]; a = stk[sp - 1];
          switch (ins[0]) {
            case OP_ADD: a = a + b; break;
            case OP_SUB: a = a - b; break;
            case OP_MUL: a = a * b; break;
            case OP_DIV: a = a / b; break;
            // NaN-propagating, as numpy.minimum / numpy.maximum
            case OP_MIN: a = (a != a || a < b) ? a : b; break;
            case OP_MAX: a = (a != a || a > b) ? a : b; break;
            case OP_LT: a = (a < b) ? 1.0 : 0.0; break;
            case OP_LE: a = (a <= b) ? 1.0 : 0.0; break;
            case OP_GT: a = (a > b) ? 1.0 : 0.0; break;
            case OP_GE: a = (a >= b) ? 1.0 : 0.0; break;
          }
          stk[sp - 1] = a;
      }
    }
    double raw = stk[0];
    const double* fc = P.fconst + d[F_FBASE];
    switch (d[F_SNAP]) {
      case SNAP_RAW: return __double_as_longlong(raw);
      case SNAP_FLOAT: return __double_as_longlong(snap_float(raw, fc));
      case SNAP_MIXED: {
        double out = snap_float(raw, fc);
        int64_t my = d[F_MY], mx = d[F_MX];
        for (int64_t e = 0; e < d[F_PH_COUNT]; ++e) {
          const int64_t* r = P.phases + (d[F_PH_BEGIN] + e) * 5;
          if (rows_abs % my == r[0] % my && x % mx == r[1] % mx)
            out = snap_float(raw, P.fconst + r[4]);
        }
        return __double_as_longlong(out);
      }
      default: {
        int64_t qmin, qmax;
        bounds(d, rows_abs, x, &qmin, &qmax);
        double q = rint(raw * fc[FC_STEP]);
        return (int64_t)clampd(q, (double)qmin, (double)qmax);
      }
    }
  }
};

// __grid_constant__: Band keeps a reference to P without a local copy
__global__ void fused_band_kernel(const __grid_constant__ Params P) {
  int64_t* ws = P.ws + (int64_t)blockIdx.x * P.ws_per_block;
  int64_t n_items = (int64_t)P.batch * P.nbands;
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    Band band{P, ws, item / P.nbands, item % P.nbands};
    for (int s = 0; s < P.n_stages; ++s) {
      const int64_t* d = P.stages + (int64_t)s * NF;
      if (d[F_KIND] == KIND_INPUT) continue;      // read in place by taps
      int64_t L = d[F_L], H = d[F_H], W = d[F_W];
      int64_t step = d[F_STEP], lo = d[F_LO];
      int64_t start = band.i * step + lo;
      int64_t out_slot = d[F_OUT_SLOT];
      for (int64_t k = threadIdx.x; k < L * W; k += blockDim.x) {
        int64_t r = k / W, x = k - r * W;
        int64_t rows_abs = clampi(start + r, 0, H - 1);
        int64_t v = d[F_KIND] == KIND_INTLINEAR ? band.intlinear(d, rows_abs, x)
                                                : band.expr(d, rows_abs, x);
        ws[d[F_WS_OFF] + k] = v;
        // band_output: tile rows [-lo, -lo + step) are output rows
        // i*step + [0, step); mask the ragged rows past H
        int64_t orow = r + lo;
        int64_t grow = start + r;
        if (out_slot >= 0 && orow >= 0 && orow < step && grow < H) {
          int64_t o = (band.img * H + grow) * W + x;
          if (d[F_CODE] == 7)
            ((int64_t*)P.out[out_slot])[o] = v;   // f64 bits
          else
            store_int(P.out[out_slot], d[F_CODE], o, v);
        }
      }
      __syncthreads();   // the next stage (or work item) reads this tile
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `ins`
// and `outs` are host arrays of device pointers; the kernel allocates
// nothing and does not synchronize.
extern "C" int fused_band_launch(const int64_t* stages, int n_stages,
                                 const int64_t* taps, const int64_t* phases,
                                 const int64_t* prog, const double* fconst,
                                 const void* const* ins, int n_in,
                                 void* const* outs, int n_out, int64_t* ws,
                                 int64_t ws_per_block, int batch,
                                 int64_t nbands, int blocks, int threads,
                                 void* stream) {
  if (n_in > MAX_IO || n_out > MAX_IO || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.stages = stages;
  P.taps = taps;
  P.phases = phases;
  P.prog = prog;
  P.fconst = fconst;
  P.ws = ws;
  P.ws_per_block = ws_per_block;
  P.n_stages = n_stages;
  P.batch = batch;
  P.nbands = nbands;
  for (int k = 0; k < MAX_IO; ++k) {
    P.in[k] = k < n_in ? ins[k] : nullptr;
    P.out[k] = k < n_out ? outs[k] : nullptr;
  }
  (void)cudaGetLastError();   // report this launch's error, not an older one
  fused_band_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
