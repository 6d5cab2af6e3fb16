// fused_band.cu — one rate island of a fixed-point image pipeline, run
// over every (image, band, column tile) of its schedule.
//
// Replaces the TPU kernel src/repro/kernels/stencil/kernel.py:
// fused_pipeline (its `_fused_kernel` / `_fused_kernel_prefetch` bodies,
// `eval_band` geometry and `band_output`; pallas_call at kernel.py:321).
// The island is not compiled into code: repro_torch/kernels/stencil/
// kernel.py:encode_program flattens it into tables that this one kernel
// interprets, and `fused_pipeline_reference` there walks the same tables
// with torch ops.
//
// Bound.  The least work is reading each input container once and
// writing each output container once: USM at 4 x 1080 x 1920 moves
// 2 B in + 2 B out per pixel, 33 MB, about 10 us at 3.35 TB/s.  The
// kernel is an interpreter, so what bounds it is the latency of each
// warp's walk through a stage's program: per tap, a descriptor, two map
// loads, four tile loads and the multiply-adds, one tap after another,
// with a barrier between stages.  The design cuts the walks (one pass
// of a stage per 1,024 pixels, taken once per 4 pixels) and keeps three
// blocks on an SM to hide their latency.
//
// Design (what keeps it near the data instead of the tables):
//  * Work items are (image, band step i, column tile j).  The encoder's
//    column-span pass gives each stage a tile of L rows x CW columns;
//    tile column c of a stage holds column clip(j*cstep + clo + c, 0,
//    W-1), as tile rows hold rows_abs.  Every stage tile that another
//    stage reads lives in shared memory in its container (u8 ... i64,
//    f64), at the encoder's offset; an output no stage reads goes
//    straight to global memory.  A tile too large for shared memory
//    (a tall single-tile island) has a per-block global slot instead,
//    or, for an input, is read in place: the same code path, through
//    a per-stage base pointer.
//  * A persistent grid (SMs x resident blocks) walks contiguous runs of
//    work items, so one block's consecutive items are neighbouring
//    column tiles of one band and the L2 serves their halos.  While a
//    block computes item k, the input bands of item k+1 are in flight
//    into the second shared slot with cp.async (commit / wait groups):
//    the Hopper form of `_fused_kernel_prefetch`.  A band is copied as
//    the 16-byte chunks covering the box rows [b, b+L) x columns
//    [cb, cb+min(CW, W)), with b = clip(start, 0, H-L) as eval_band
//    clamps it and cb the same clamp on columns, so every chunk lies in
//    the image; the edge-replicate clamps and each row's misalignment
//    are folded into the index maps.
//  * The tables are copied into shared memory once per block.  Per work
//    item, each warp fills int32 index maps: for each (stage, parent,
//    dy) the byte offset of the parent row each of the stage's L rows
//    reads, for each (stage, parent, dx) the byte offset of the column
//    each of its CW columns reads, and the lattice residues of stages
//    with per-residue bounds.  No division runs per pixel, and all
//    coordinates are int32 (the encoder rejects images whose byte
//    offsets overflow it).
//  * A thread evaluates a quad: 4 neighbouring columns of one tile row.
//    A tap's descriptor (parent, maps, weight, container) is decoded
//    once for the quad; the quad's row offset is one map load and its 4
//    column offsets one 16-byte load, then 4 tile loads.  Consecutive
//    threads take consecutive quads, so a warp's map, tile and output
//    accesses are consecutive.  Expression programs run once per quad
//    on a 4-entry register stack per pixel; integer stages whose int32
//    carrier the lowering proved accumulate in int32.  The encoder
//    picks the column tile that minimizes block-wide passes (a stage's
//    quads over 256 threads) per band, within the shared memory that
//    keeps three blocks on an SM.
//
// Bit-exactness rules (each mirrored in the plain version):
//  * Floor division in the tap algebra: the source row is
//    clip(floor((rows_abs*sy + dy)/uy) - p_start, 0, pL-1) and the column
//    clip(clip(floor((x*sx + dx)/ux), 0, pW-1) - pc_start, 0, pCW-1);
//    rows_abs*sy+dy is negative at the top edge and p_start = i*step + lo
//    is negative at band 0, where C's truncating `/` differs whenever
//    uy > 1.  See floordiv().
//  * Input rows: the band is loaded at b = clip(start, 0, H-L) and
//    reordered by clip(start + r, 0, H-1) - b, i.e. tile row r is input
//    row clip(start + r, 0, H-1).  Compute stages use the same rows_abs.
//  * rhe_shift: a left shift for t <= 0, else round-half-even on
//    p - ((p >> t) << t).  `>>` on a negative int64 is an arithmetic
//    shift on every CUDA target (shr.s64); shifts of negative values are
//    written as multiplies, which C++17 defines.
//  * Carriers: an integer stage accumulates in int32 where the lowering
//    elected the int32 carrier (F_ACC32), else in int64.  Both are
//    bit-equal to the reference's int32 / int32-pair carriers, because
//    lowering.ir._plan_intlinear elects those only after proving no
//    partial sum (nor a dyadic finish) overflows them.  The finish runs
//    in int64; the non-dyadic one is one rint((double)acc * cscale).
//  * Saturation per lattice residue: bounds are looked up by
//    (rows_abs % my, x % mx); residues missing from the table keep the
//    union bounds; a later entry for the same residue wins (the encoder
//    resolves that into one phase row per residue).
//  * snap_expr: float-stored stages snap clip(rint(raw*2^b))/2^b; stages
//    whose phases mix betas build the per-residue float composite;
//    otherwise rint(raw*2^b), clip, integer store.
//  * f32 expression stages (F_F32: lowering.ir._expr_fits_f32 proved
//    every op exact in f32, under datapath="narrow") run the same
//    program on a float stack, as the reference's `dequant_f32` path
//    does: a tap is (float)q * (float)2^-b, a constant the f32 value the
//    encoder baked, every op in f32, then rintf(raw * (float)2^b) and
//    the clip in f32.  The f64 path is the same template at double.
//    A program with f32 stages (L_F32) launches its own instantiation
//    of the kernel, so the f64-only kernel keeps its registers and its
//    code: with both stacks in one kernel, ptxas spilled at the
//    80-register cap that three blocks an SM set.
//  * No FMA contraction: built with --fmad=false, so `a*b + c` rounds
//    twice as numpy does (HCD's harris = det - k*trace^2 sits on rint ties).
//  * rint() is round-half-even; numpy's minimum/maximum propagate NaN
//    where fmin/fmax drop it, so they are written out; x**2 is x*x;
//    `/` and sqrt are IEEE-rounded in double and in float (no
//    --use_fast_math; -prec-div and -prec-sqrt keep their defaults).
//  * Containers: loads decode the code-selected container (u8 ... i64,
//    f64); stores cast after the clip, into tiles and outputs alike, so
//    a narrow tile is lossless.  Output rows >= H and columns >= W (the
//    ragged last band and tile) are masked.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Columns of the per-stage table; the same names in the same order as
// FIELDS in repro_torch/kernels/stencil/kernel.py.
// FIELDS-BEGIN
enum Field {
  F_KIND, F_STEP, F_LO, F_L, F_H, F_W, F_SY, F_SX, F_UY, F_UX,
  F_CODE, F_IN_SLOT, F_OUT_SLOT, F_IS_FLOAT,
  F_TAP_BEGIN, F_TAP_COUNT, F_DYADIC, F_SM, F_T_SHIFT,
  F_INT_MIN, F_INT_MAX, F_PH_BEGIN, F_PH_COUNT, F_MY, F_MX,
  F_PROG_BEGIN, F_PROG_LEN, F_SNAP, F_FBASE,
  F_CSTEP, F_CLO, F_CW, F_PLACE, F_TILE_OFF, F_PITCH, F_ESIZE,
  F_RES_BEGIN, F_RRES, F_CRES, F_ACC32, F_F32,
  NF
};
// FIELDS-END

// The launch's scalars; the same names in the same order as LAYOUT in
// kernel.py.  o_*: offsets (int64 words) of the tables in `meta`;
// s_*: byte offsets in shared memory.
// LAYOUT-BEGIN
enum Layout {
  L_N_META, L_O_STAGES, L_O_TAPS, L_O_PHASES, L_O_PROG, L_O_RMAPS,
  L_O_CMAPS, L_O_RESMAP, L_O_FCONST, L_N_STAGES, L_N_RMAPS,
  L_N_CMAPS, L_S_SBASE, L_S_ROWMAPS, L_S_COLMAPS, L_IN_STRIDE,
  L_SMEM_BYTES, L_NTILES, L_F32,
  NL
};
// LAYOUT-END

enum Kind { KIND_INPUT = 0, KIND_INTLINEAR = 1, KIND_EXPR = 2 };
enum Place { PLACE_SHARED = 0, PLACE_GLOBAL = 1, PLACE_NONE = 2 };
enum Snap { SNAP_INT = 0, SNAP_FLOAT = 1, SNAP_MIXED = 2, SNAP_RAW = 3 };
enum Op {
  OP_REF, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SQR, OP_ABS, OP_SQRT,
  OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE, OP_SELECT
};
enum FConst { FC_STEP, FC_INV_STEP, FC_MIN, FC_MAX, FC_CSCALE };

constexpr int MAX_STACK = 4;  // the expression stack, in registers
constexpr int PX = 4;         // a quad: the columns a thread evaluates
constexpr int MAX_IO = 32;
constexpr int TAPW = 8;       // see TAPW in kernel.py
constexpr int THREADS = 256;

struct Params {
  const int64_t* meta;        // every table, see EncodedProgram.meta()
  int lay[NL];
  char* ws;                   // blocks x ws_per_block bytes (global tiles)
  int64_t ws_per_block;
  int batch;
  int band0;                  // the first band step of this launch
  int nbands;                 // band steps [band0, band0 + nbands)
  const void* in[MAX_IO];
  void* out[MAX_IO];
};

__device__ __forceinline__ int floordiv(int a, int b) {
  // b > 0 (a sampling rate); C's `/` truncates toward zero
  if (b == 1) return a;
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int64_t clampl(int64_t v, int64_t lo,
                                          int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename F>
__device__ __forceinline__ F clampd(F v, F lo, F hi) {
  // jnp.clip / np.clip: max then min, NaN passes through
  v = (v < lo) ? lo : v;
  return (v > hi) ? hi : v;
}

// the expression ops at each width: the float overloads are the f32
// instructions, correctly rounded
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }

__device__ __forceinline__ int64_t rhe_shift(int64_t p, int64_t t) {
  if (t <= 0) return p * ((int64_t)1 << (-t));
  int64_t base = p >> t;                       // arithmetic: floor(p / 2^t)
  int64_t rem = p - base * ((int64_t)1 << t);
  int64_t half = (int64_t)1 << (t - 1);
  bool inc = rem > half || (rem == half && (base & 1) != 0);
  return base + (inc ? 1 : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  // every group but the one committed last has landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Item {
  int img, i, j;              // image, band step, column tile
};

// The first column of the box an input band is copied as.
__device__ __forceinline__ int box_col(const int64_t* d, int j) {
  int W = (int)d[F_W];
  int bw = min((int)d[F_CW], W);
  return clampi(j * (int)d[F_CSTEP] + (int)d[F_CLO], 0, W - bw);
}

// Everything one block shares: the tables (in shared memory, read
// through pointers and scalars kept in registers) and the per-item state.
struct Block {
  const Params& P;
  unsigned char* smem;
  const int64_t* stages;
  const int64_t* taps;
  const int64_t* phases;
  const int64_t* prog;
  const int64_t* rmaps;
  const int64_t* cmaps;
  const int64_t* resmap;
  const double* fc;
  char** sbase;               // tile base pointer per stage, this item
  int* rowmaps;
  int* colmaps;
  int n_stages, n_rmaps, n_cmaps, ntiles, nbands, in_stride;

  __device__ Block(const Params& P_, unsigned char* smem_)
      : P(P_), smem(smem_) {
    const int64_t* meta = (const int64_t*)smem;
    stages = meta + P.lay[L_O_STAGES];
    taps = meta + P.lay[L_O_TAPS];
    phases = meta + P.lay[L_O_PHASES];
    prog = meta + P.lay[L_O_PROG];
    rmaps = meta + P.lay[L_O_RMAPS];
    cmaps = meta + P.lay[L_O_CMAPS];
    resmap = meta + P.lay[L_O_RESMAP];
    fc = (const double*)(meta + P.lay[L_O_FCONST]);
    sbase = (char**)(smem + P.lay[L_S_SBASE]);
    rowmaps = (int*)(smem + P.lay[L_S_ROWMAPS]);
    colmaps = (int*)(smem + P.lay[L_S_COLMAPS]);
    n_stages = P.lay[L_N_STAGES];
    n_rmaps = P.lay[L_N_RMAPS];
    n_cmaps = P.lay[L_N_CMAPS];
    ntiles = P.lay[L_NTILES];
    nbands = P.nbands;
    in_stride = P.lay[L_IN_STRIDE];
  }

  __device__ const int64_t* stage(int s) const { return stages + s * NF; }

  __device__ Item item(int64_t q) const {
    int64_t band = q / ntiles;
    Item it;
    it.j = (int)(q - band * ntiles);
    it.i = P.band0 + (int)(band % nbands);
    it.img = (int)(band / nbands);
    return it;
  }

  __device__ const char* image(const int64_t* d, int img) const {
    return (const char*)P.in[d[F_IN_SLOT]] +
           (int64_t)img * d[F_H] * d[F_W] * d[F_ESIZE];
  }

  // start the cp.async copies of item q's input bands into slot `slot`
  __device__ void prefetch(int64_t q, int slot) const {
    Item it = item(q);
    for (int s = 0; s < n_stages; ++s) {
      const int64_t* d = stage(s);
      if (d[F_KIND] != KIND_INPUT || d[F_PLACE] != PLACE_SHARED) continue;
      int H = (int)d[F_H], W = (int)d[F_W], L = (int)d[F_L];
      int es = (int)d[F_ESIZE], pitch = (int)d[F_PITCH];
      int b = clampi(it.i * (int)d[F_STEP] + (int)d[F_LO], 0, H - L);
      int cb = box_col(d, it.j);
      int rowbytes = min((int)d[F_CW], W) * es;
      int nch = pitch / 16;
      const char* src = image(d, it.img) + ((int64_t)b * W + cb) * es;
      char* dst = (char*)smem + d[F_TILE_OFF] + slot * in_stride;
      for (int k = threadIdx.x; k < L * nch; k += blockDim.x) {
        int r = k / nch, ch = k - r * nch;
        uintptr_t g = (uintptr_t)(src + (int64_t)r * W * es);
        uintptr_t a = (g & ~(uintptr_t)15) + 16 * ch;
        if (a < g + rowbytes)
          cp_async16(dst + r * pitch + 16 * ch, (const void*)a);
      }
    }
  }

  // stage base pointers and index maps of item `it` (inputs in `slot`)
  __device__ void prepare(const Item& it, int slot) const {
    for (int s = threadIdx.x; s < n_stages; s += blockDim.x) {
      const int64_t* d = stage(s);
      char* base = nullptr;
      if (d[F_KIND] == KIND_INPUT) {
        base = d[F_PLACE] == PLACE_SHARED
                   ? (char*)smem + d[F_TILE_OFF] + slot * in_stride
                   : (char*)image(d, it.img);
      } else if (d[F_PLACE] == PLACE_SHARED) {
        base = (char*)smem + d[F_TILE_OFF];
      } else if (d[F_PLACE] == PLACE_GLOBAL) {
        base = P.ws + blockIdx.x * P.ws_per_block + d[F_TILE_OFF];
      }
      sbase[s] = base;
    }
    // one warp a map; each map's constants are read into registers first
    int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int nwarps = blockDim.x / 32;
    for (int m = warp; m < n_rmaps; m += nwarps) {
      const int64_t* dc = stage((int)rmaps[4 * m]);
      int p = (int)rmaps[4 * m + 1], dy = (int)rmaps[4 * m + 2];
      int* out = rowmaps + rmaps[4 * m + 3];
      int start = it.i * (int)dc[F_STEP] + (int)dc[F_LO];
      int L = (int)dc[F_L], H1 = (int)dc[F_H] - 1;
      int sy = (int)dc[F_SY], uy = (int)dc[F_UY];
      int my = (int)dc[F_MY], mx = (int)dc[F_MX];
      int p_start = 0, pL1 = 0, pH1 = 0, pitch = 0, b = 0;
      int64_t rowbytes = 0;
      bool input = false, shared = false;
      uintptr_t g0 = 0;
      if (p >= 0) {
        const int64_t* dp = stage(p);
        p_start = it.i * (int)dp[F_STEP] + (int)dp[F_LO];
        pL1 = (int)dp[F_L] - 1;
        pitch = (int)dp[F_PITCH];
        input = dp[F_KIND] == KIND_INPUT;
        shared = dp[F_PLACE] == PLACE_SHARED;
        pH1 = (int)dp[F_H] - 1;
        rowbytes = dp[F_W] * dp[F_ESIZE];
        b = clampi(p_start, 0, pH1 + 1 - (int)dp[F_L]);
        if (input && shared)   // where the box's first column lies
          g0 = (uintptr_t)(image(dp, it.img) + box_col(dp, it.j) *
                                                   dp[F_ESIZE]);
      }
      for (int r = lane; r < L; r += 32) {
        int rows_abs = clampi(start + r, 0, H1);
        int v;
        if (p < 0) {          // the stage's own row residue
          v = (rows_abs % my) * mx;
        } else {
          int src = clampi(floordiv(rows_abs * sy + dy, uy) - p_start, 0,
                           pL1);
          int row = clampi(p_start + src, 0, pH1);
          if (!input)
            v = src * pitch;
          else if (!shared)
            v = row * (int)rowbytes;
          else                // box row, plus its chunks' misalignment
            v = (row - b) * pitch + (int)((g0 + row * rowbytes) & 15);
        }
        out[r] = v;
      }
    }
    for (int m = warp; m < n_cmaps; m += nwarps) {
      const int64_t* dc = stage((int)cmaps[4 * m]);
      int p = (int)cmaps[4 * m + 1], dx = (int)cmaps[4 * m + 2];
      int* out = colmaps + cmaps[4 * m + 3];
      int c0 = it.j * (int)dc[F_CSTEP] + (int)dc[F_CLO];
      int n = ((int)dc[F_CW] + PX - 1) / PX * PX, W1 = (int)dc[F_W] - 1;
      int sx = (int)dc[F_SX], ux = (int)dc[F_UX], mx = (int)dc[F_MX];
      int pW1 = 0, es = 0, pc0 = 0, pCW1 = 0, cb = 0;
      bool input = false;
      if (p >= 0) {
        const int64_t* dp = stage(p);
        pW1 = (int)dp[F_W] - 1;
        es = (int)dp[F_ESIZE];
        pc0 = it.j * (int)dp[F_CSTEP] + (int)dp[F_CLO];
        pCW1 = (int)dp[F_CW] - 1;
        input = dp[F_KIND] == KIND_INPUT;
        if (input && dp[F_PLACE] == PLACE_SHARED) cb = box_col(dp, it.j);
      }
      for (int c = lane; c < n; c += 32) {
        int x = clampi(c0 + c, 0, W1);
        int v;
        if (p < 0) {          // the stage's own column residue
          v = x % mx;
        } else {
          int f = clampi(floordiv(x * sx + dx, ux), 0, pW1);
          int src = clampi(f - pc0, 0, pCW1);
          v = input ? (clampi(pc0 + src, 0, pW1) - cb) * es : src * es;
        }
        out[c] = v;
      }
    }
  }

  // the 4 values of a quad's taps at byte offsets cols from `base`,
  // widened to V
  template <typename T, typename V>
  __device__ __forceinline__ void gather_as(const char* base, int4 cols,
                                            V* v) const {
    v[0] = (V)*(const T*)(base + cols.x);
    v[1] = (V)*(const T*)(base + cols.y);
    v[2] = (V)*(const T*)(base + cols.z);
    v[3] = (V)*(const T*)(base + cols.w);
  }

  // tap `t` (a taps row: parent, dy, dx, w, row map, column map, code)
  // at the quad of row r, columns c0 .. c0+3: one row-map load, one
  // 16-byte column-map load and four tile loads (code 7: f64 bits)
  template <typename V>
  __device__ __forceinline__ void gather(const int64_t* t, int r, int c0,
                                         V* v) const {
    const char* base = sbase[t[0]] + rowmaps[t[4] + r];
    int4 cols = *(const int4*)(colmaps + t[5] + c0);
    switch ((int)t[6]) {   // uniform: one container a parent
      case 0: gather_as<uint8_t, V>(base, cols, v); break;
      case 1: gather_as<int8_t, V>(base, cols, v); break;
      case 2: gather_as<uint16_t, V>(base, cols, v); break;
      case 3: gather_as<int16_t, V>(base, cols, v); break;
      case 4: gather_as<uint32_t, V>(base, cols, v); break;
      case 5: gather_as<int32_t, V>(base, cols, v); break;
      default: gather_as<int64_t, V>(base, cols, v); break;
    }
  }

  // the phase row of pixel (r, c) of stage d, or -1
  __device__ __forceinline__ int phase_row(const int64_t* d, int r,
                                           int c) const {
    if (d[F_PH_COUNT] == 0) return -1;
    return (int)resmap[d[F_RES_BEGIN] + rowmaps[d[F_RRES] + r] +
                       colmaps[d[F_CRES] + c]];
  }

  // per-residue int saturation bounds (union bounds where none matches)
  __device__ __forceinline__ void bounds(const int64_t* d, int r, int c,
                                         int64_t* qmin,
                                         int64_t* qmax) const {
    *qmin = d[F_INT_MIN];
    *qmax = d[F_INT_MAX];
    int e = phase_row(d, r, c);
    if (e >= 0) {
      const int64_t* ph = phases + 5 * e;
      *qmin = ph[2];
      *qmax = ph[3];
    }
  }

  // an integer stage at a quad: each tap's descriptor is decoded once
  // for its 4 pixels
  __device__ void intlinear(const int64_t* d, int r, int c0,
                            int64_t* out) const {
    int64_t acc[PX] = {0, 0, 0, 0};
    const int64_t* t = taps + d[F_TAP_BEGIN] * TAPW;
    int n = (int)d[F_TAP_COUNT];
    if (d[F_ACC32]) {         // int32 proved wide enough: bit-equal
      int a32[PX] = {0, 0, 0, 0}, v[PX];
      for (int j = 0; j < n; ++j, t += TAPW) {
        gather(t, r, c0, v);
        int w = (int)t[3];
#pragma unroll
        for (int m = 0; m < PX; ++m) a32[m] += w * v[m];
      }
#pragma unroll
      for (int m = 0; m < PX; ++m) acc[m] = a32[m];
    } else {
      int64_t v[PX];
      for (int j = 0; j < n; ++j, t += TAPW) {
        gather(t, r, c0, v);
        int64_t w = t[3];
#pragma unroll
        for (int m = 0; m < PX; ++m) acc[m] += w * v[m];
      }
    }
    bool dyadic = d[F_DYADIC] != 0;
    int64_t sm = d[F_SM], shift = d[F_T_SHIFT];
    double cscale = fc[d[F_FBASE] + FC_CSCALE];
#pragma unroll
    for (int m = 0; m < PX; ++m) {
      int64_t qmin, qmax;
      bounds(d, r, c0 + m, &qmin, &qmax);
      if (dyadic) {
        out[m] = clampl(rhe_shift(sm != 1 ? acc[m] * sm : acc[m], shift),
                        qmin, qmax);
      } else {
        double q = rint((double)acc[m] * cscale);
        out[m] = (int64_t)clampd<double>(q, (double)qmin, (double)qmax);
      }
    }
  }

  __device__ __forceinline__ double snap_float(double raw,
                                               const double* f) const {
    return clampd<double>(rint(raw * f[FC_STEP]), f[FC_MIN], f[FC_MAX]) /
           f[FC_STEP];
  }

  // an expression stage at a quad: the postfix program runs once on a
  // register stack of MAX_STACK entries per pixel (s[0] the top; a push
  // shifts down, a pop shifts up, so every index is static), in F (double,
  // or float for an f32 stage); returns the stored values (f64 bits for
  // float-stored stages, which are never f32 stages).  Inlined: a call
  // would put the quad's `out` in local memory
  template <typename F>
  __device__ __forceinline__ void expr(const int64_t* d, int r, int c0,
                                       int64_t* out) const {
    F s[MAX_STACK][PX];
    int64_t v[PX];
    const int64_t* ins = prog + d[F_PROG_BEGIN] * TAPW;
    for (int k = 0; k < d[F_PROG_LEN]; ++k, ins += TAPW) {
      int op = (int)ins[0];
      if (op == OP_REF || op == OP_CONST) {
#pragma unroll
        for (int j = MAX_STACK - 1; j > 0; --j)
#pragma unroll
          for (int m = 0; m < PX; ++m) s[j][m] = s[j - 1][m];
        if (op == OP_CONST) {
          F x = (F)fc[ins[1]];
#pragma unroll
          for (int m = 0; m < PX; ++m) s[0][m] = x;
          continue;
        }
        gather(ins + 1, r, c0, v);
        if (ins[7] == 7) {          // a float-stored parent
#pragma unroll
          for (int m = 0; m < PX; ++m)
            s[0][m] = (F)__longlong_as_double(v[m]);
        } else {
          F inv = (F)fc[stage((int)ins[1])[F_FBASE] + FC_INV_STEP];
#pragma unroll
          for (int m = 0; m < PX; ++m) s[0][m] = (F)v[m] * inv;
        }
        continue;
      }
#define EACH(expr_)                                  \
  _Pragma("unroll") for (int m = 0; m < PX; ++m) {   \
    F a = s[1][m], b = s[0][m];                      \
    (void)a;                                         \
    s[0][m] = (expr_);                               \
  }                                                  \
  break;
      switch (op) {
        case OP_SQR: EACH(b * b)
        case OP_ABS: EACH(fabs_(b))
        case OP_SQRT: EACH(sqrt_(b))
        case OP_ADD: EACH(a + b)
        case OP_SUB: EACH(a - b)
        case OP_MUL: EACH(a * b)
        case OP_DIV: EACH(a / b)
        // NaN-propagating, as numpy.minimum / numpy.maximum
        case OP_MIN: EACH((a != a || a < b) ? a : b)
        case OP_MAX: EACH((a != a || a > b) ? a : b)
        case OP_LT: EACH((a < b) ? (F)1 : (F)0)
        case OP_LE: EACH((a <= b) ? (F)1 : (F)0)
        case OP_GT: EACH((a > b) ? (F)1 : (F)0)
        case OP_GE: EACH((a >= b) ? (F)1 : (F)0)
        default: EACH((s[2][m] != (F)0) ? a : b)   // OP_SELECT
      }
#undef EACH
      if (op == OP_SQR || op == OP_ABS || op == OP_SQRT) continue;
      int pops = op == OP_SELECT ? 2 : 1;
#pragma unroll
      for (int j = 1; j < MAX_STACK - 1; ++j)
#pragma unroll
        for (int m = 0; m < PX; ++m)
          s[j][m] = pops == 2 && j + 2 < MAX_STACK ? s[j + 2][m]
                                                    : s[j + 1][m];
    }
    const double* f = fc + d[F_FBASE];
    int snap = (int)d[F_SNAP];
#pragma unroll
    for (int m = 0; m < PX; ++m) {
      F raw = s[0][m];
      switch (snap) {
        case SNAP_RAW: out[m] = __double_as_longlong((double)raw); break;
        case SNAP_FLOAT:
          out[m] = __double_as_longlong(snap_float(raw, f));
          break;
        case SNAP_MIXED: {
          int e = phase_row(d, r, c0 + m);
          out[m] = __double_as_longlong(
              snap_float(raw, e >= 0 ? fc + phases[5 * e + 4] : f));
          break;
        }
        default: {
          int64_t qmin, qmax;
          bounds(d, r, c0 + m, &qmin, &qmax);
          F q = rint_(raw * (F)f[FC_STEP]);
          out[m] = (int64_t)clampd<F>(q, (F)qmin, (F)qmax);
        }
      }
    }
  }

  // a quad's values m in [mb, me) into row `row` at columns c0 + m, cast
  // into the container (code 7: the f64's bits)
  template <typename T>
  __device__ __forceinline__ static void put_as(char* row, int c0, int mb,
                                                int me, const int64_t* v) {
    T* p = (T*)row + c0;
#pragma unroll
    for (int m = 0; m < PX; ++m)
      if (m >= mb && m < me) p[m] = (T)v[m];
  }

  __device__ __forceinline__ static void put(char* row, int code, int c0,
                                             int mb, int me,
                                             const int64_t* v) {
    switch (code) {
      case 0: put_as<uint8_t>(row, c0, mb, me, v); break;
      case 1: put_as<int8_t>(row, c0, mb, me, v); break;
      case 2: put_as<uint16_t>(row, c0, mb, me, v); break;
      case 3: put_as<int16_t>(row, c0, mb, me, v); break;
      case 4: put_as<uint32_t>(row, c0, mb, me, v); break;
      case 5: put_as<int32_t>(row, c0, mb, me, v); break;
      default: put_as<int64_t>(row, c0, mb, me, v); break;
    }
  }

  // every pixel of stage s's tile of item `it`: into its tile, and the
  // output window [-lo, -lo+step) x [-clo, -clo+cstep) into its output.
  // The output holds the launch's rows only, image rows [band0*step,
  // min((band0+nbands)*step, H)): its base is offset back by band0*step
  // rows once, so the store below addresses image row grow as the
  // whole-grid launch does, and the clip keeps the global H.  A thread
  // takes a quad of 4 neighbouring columns of one tile row at a time; a
  // block's threads take consecutive quads.
  template <bool F32>
  __device__ void run_stage(int s, const Item& it) const {
    const int64_t* d = stage(s);
    int L = (int)d[F_L], CW = (int)d[F_CW];
    int H = (int)d[F_H], W = (int)d[F_W];
    int lo = (int)d[F_LO], step = (int)d[F_STEP];
    int clo = (int)d[F_CLO], cstep = (int)d[F_CSTEP];
    int code = (int)d[F_CODE], es = (int)d[F_ESIZE];
    int pitch = (int)d[F_PITCH];
    int row0 = it.i * step + lo, col0 = it.j * cstep + clo;
    int orow0 = P.band0 * step;                   // the output's first row
    int oH = min((P.band0 + nbands) * step, H) - orow0;
    bool lin = d[F_KIND] == KIND_INTLINEAR, f32 = F32 && d[F_F32] != 0;
    char* tile = sbase[s];
    char* out = d[F_OUT_SLOT] < 0
                    ? nullptr
                    : (char*)P.out[d[F_OUT_SLOT]] +
                          ((int64_t)it.img * oH - orow0) * W * es;
    // output columns of this tile: [c_lo, c_hi) of the tile
    int c_lo = max(-clo, 0), c_hi = min(-clo + cstep, W - col0);
    int nq = (CW + PX - 1) / PX;                  // quads a row
    int dr = blockDim.x / nq, dq = blockDim.x % nq;
    int r = threadIdx.x / nq, q = threadIdx.x % nq;
    for (int k = threadIdx.x; k < L * nq; k += blockDim.x) {
      int c0 = q * PX;
      int64_t v[PX];
      if (lin)
        intlinear(d, r, c0, v);
      else if (f32)
        expr<float>(d, r, c0, v);
      else
        expr<double>(d, r, c0, v);
      if (tile) put(tile + r * pitch, code, c0, 0, CW - c0, v);
      int orow = r + lo, grow = row0 + r;
      if (out && orow >= 0 && orow < step && grow < H)
        put(out + (grow * W + col0) * es, code, c0, c_lo - c0, c_hi - c0, v);
      r += dr;
      q += dq;
      if (q >= nq) {
        q -= nq;
        ++r;
      }
    }
  }
};

// three blocks an SM (at most 85 registers a thread; SMEM_LIMIT in
// kernel.py keeps shared memory to match); F32: the program has f32
// expression stages
template <bool F32>
__global__ void __launch_bounds__(THREADS, 3)
    fused_band_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* meta = (int64_t*)smem;
  for (int k = threadIdx.x; k < P.lay[L_N_META]; k += blockDim.x)
    meta[k] = P.meta[k];
  Block blk(P, smem);
  __syncthreads();
  // a contiguous run of work items: neighbouring column tiles of a band
  int64_t n_items = (int64_t)P.batch * P.nbands * P.lay[L_NTILES];
  int64_t first = n_items * blockIdx.x / gridDim.x;
  int64_t last = n_items * (blockIdx.x + 1) / gridDim.x;
  if (first < last) blk.prefetch(first, 0);
  cp_async_commit();
  for (int64_t q = first; q < last; ++q) {
    int slot = (int)((q - first) & 1);
    if (q + 1 < last) blk.prefetch(q + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait_prev();     // this thread's copies of item q landed
    Item it = blk.item(q);
    blk.prepare(it, slot);
    __syncthreads();          // everyone's copies, maps and bases
    for (int s = 0; s < blk.n_stages; ++s) {
      if (blk.stage(s)[F_KIND] == KIND_INPUT) continue;
      blk.run_stage<F32>(s, it);
      __syncthreads();        // the next stage (or item) reads this tile
    }
  }
}

}  // namespace

// The kernel's residency at `smem_bytes` of dynamic shared memory, for
// programs with f32 stages if `f32`: out[0] blocks per SM, out[1] SMs,
// out[2] registers a thread, out[3] local bytes a thread.  Returns a
// CUDA error code (0 on success).
extern "C" int fused_band_occupancy(int smem_bytes, int threads, int f32,
                                    int* out) {
  const void* kernel = f32 ? (const void*)fused_band_kernel<true>
                           : (const void*)fused_band_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                    threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)e;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `ins`
// and `outs` are host arrays of device pointers, `layout` the NL
// scalars (L_F32 picks the instantiation); the kernel allocates nothing
// and does not synchronize.  It runs band steps [band0, band0 + nbands)
// of every image: inputs are the whole images, outputs hold those bands'
// rows only.
extern "C" int fused_band_launch(const int64_t* meta, const int* layout,
                                 const void* const* ins, int n_in,
                                 void* const* outs, int n_out, char* ws,
                                 int64_t ws_per_block, int batch, int band0,
                                 int nbands, int blocks, int threads,
                                 void* stream) {
  if (n_in > MAX_IO || n_out > MAX_IO || blocks < 1 || threads != THREADS ||
      band0 < 0 || nbands < 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.meta = meta;
  for (int k = 0; k < NL; ++k) P.lay[k] = layout[k];
  P.ws = ws;
  P.ws_per_block = ws_per_block;
  P.batch = batch;
  P.band0 = band0;
  P.nbands = nbands;
  for (int k = 0; k < MAX_IO; ++k) {
    P.in[k] = k < n_in ? ins[k] : nullptr;
    P.out[k] = k < n_out ? outs[k] : nullptr;
  }
  (void)cudaGetLastError();   // report this launch's error, not an older one
  int smem = P.lay[L_SMEM_BYTES];
  void (*kernel)(const Params) =
      P.lay[L_F32] ? fused_band_kernel<true> : fused_band_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
