// The batched SMT engine's two op-table walks, one thread a box:
//
//   smt_hc4_launch   hc4 contraction of a frontier, in place
//                    (`repro_torch/smt/solver.py:_hc4_rows`);
//   smt_grad_launch  interval gradients of the root with respect to
//                    every variable (`solver.py:_gradients_rows`).
//
// Replaces no TPU kernel: the reference's SMT engine is numpy on the
// host (`src/repro/smt/solver.py`).  The port's plain versions run the
// same walks as a few elementwise torch operations a def over the whole
// frontier; on the card each of them is a launch on a column of a few
// hundred rows, and each data-dependent branch a host sync, so the
// engine ran slower on the card than on the host's CPU.  Here a call is
// one launch and makes no host sync.
//
// A frontier is lo, hi: (N, nvars) f64, row-major; the op table is the
// `Program`'s arrays on the card (`encoder.DeviceProgram`): def_var,
// opcode, pow_n, cmp (ndefs int32), argv (ndefs x 4 int32, -1 a
// constant slot), argc (ndefs x 4 f64).
//
// Bit-exactness with the plain version, on every row and every bit:
//   * the IEEE f64 operations of the plain transfer functions, in their
//     order (`_b_forward`, `_b_backward`, `_b_meet`, `_b_mul`, `_b_div`,
//     `_b_pow`, `_b_abs`, `_b_sqrt`, `_b_cmp`, `_b_ext_div`, `_b_root`),
//     built with --fmad=false and no fma anywhere; numpy's maximum,
//     minimum, fmax and fmin (`core/npops.py`: a NaN operand propagates
//     or is dropped, of two equal operands the second); IEEE sqrt and
//     division; torch's `pow` on the card for x ** n outside n = 0, 1, 2
//     (`tpow`, torch's own special cases first);
//   * every `if _any(mask)` of the plain version is a per-box `if`: each
//     guards a masked update, but one.  `_b_mul`'s NaN check replaces
//     the products that have a zero operand by +0 on EVERY row once any
//     row's products hold a NaN (0 * inf), which changes the sign of a
//     zero product on rows without a NaN.  hc4 copies it: every call of
//     `_b_mul` in a call of hc4 is a site (round, def, which), and the
//     walk first runs recording which sites saw a NaN on any row, then
//     replays from the frontier it was given with those sites fixed on
//     every row, recording again, until a replay records the sites it
//     used.  The values a live box computes never depend on the fix (it
//     only picks the sign of a zero product; a zero reaches a division
//     only through the straddle masks), so the first pass has the plain
//     version's round count, and a replay changes the flags only where
//     the sign of a zero decides whether a later call sees a NaN: two
//     passes where a NaN occurs, one where none does, a third only in
//     that case.  The gradient walk needs no sites: a zero adjoint is +0
//     (sums of +0 and products never give -0 there), so the sign of a
//     zero term never reaches its result;
//   * rounds: the plain version stops when no live box changed in a
//     round, over the whole frontier, and keeps walking boxes that
//     died.  Here every box walks every round, with a grid-wide barrier
//     at the end of a round that reads one flag set by any box that
//     changed and is alive; so dead rows, and the sign of every zero, are
//     the plain version's too.  The launch is cooperative (every block
//     resident; each thread walks boxes tid, tid + threads, ...), so the
//     barrier cannot hang;
//   * the gradient walk skips a def where the box's own adjoint is zero
//     (the plain version skips it where every box's is): adding a zero
//     term leaves a gradient's bits as they were.
//
// What bounds it on this card: neither bytes nor operations.  A box's
// walk is a chain of dependent loads, compares and f64 operations
// through its own row (2 x 8 x nvars bytes, up to 8 kB), so a thread is
// bound by the latency of that chain; 32 threads a block spread the
// frontier over the SMs, where each block's rows stay in L1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum {
  OP_ADD = 0, OP_SUB, OP_MUL, OP_DIV, OP_POW,
  OP_ABS, OP_SQRT, OP_MIN, OP_MAX, OP_SELECT
};

constexpr int THREADS = 32;
constexpr int SITES_PER_DEF = 3;   // forward, backward slot 0, slot 1
constexpr double INF = __builtin_huge_val();
constexpr double MEET_SLACK = 1e-9;

struct Table {
  const int* def_var;
  const int* opcode;
  const int* argv;
  const double* argc;
  const int* pow_n;
  const int* cmp;
  int ndefs;
};

// ---------------------------------------------------------------------
// numpy's elementwise rules (core/npops.py)
// ---------------------------------------------------------------------

__device__ __forceinline__ bool nan_(double x) { return x != x; }

__device__ __forceinline__ double np_max(double a, double b) {
  return (a > b || nan_(a)) ? a : b;
}
__device__ __forceinline__ double np_min(double a, double b) {
  return (a < b || nan_(a)) ? a : b;
}
__device__ __forceinline__ double np_fmax(double a, double b) {
  return (a > b || nan_(b)) ? a : b;
}
__device__ __forceinline__ double np_fmin(double a, double b) {
  return (a < b || nan_(b)) ? a : b;
}

// torch.pow(x, p) of a tensor and a number on the card: its special
// cases, then CUDA's pow
__device__ double tpow(double x, double p) {
  if (p == 0.0) return 1.0;
  if (p == 1.0) return x;
  if (p == 0.5) return sqrt(x);
  if (p == -0.5) return rsqrt(x);
  if (p == -1.0) return 1.0 / x;
  if (p == 2.0) return x * x;
  if (p == 3.0) return x * x * x;
  if (p == -2.0) return 1.0 / (x * x);
  return pow(x, p);
}

// npops.npow on the card
__device__ double npow(double x, int n) {
  if (n == 0) return 1.0;
  if (n == 1) return x;
  if (n == 2) return x * x;
  return tpow(x, (double)n);
}

__device__ __forceinline__ bool odd(int n) { return ((n % 2) + 2) % 2 == 1; }

// ---------------------------------------------------------------------
// the sites of `_b_mul`'s NaN check (hc4 only)
// ---------------------------------------------------------------------

struct Sites {
  const int* used;   // fix these sites on every row (null: none)
  int* rec;          // record the sites that saw a NaN (null: do not)
  int base;          // this (round, def)'s first site
};

// `_b_mul`: the interval product with 0 * inf = 0
__device__ void b_mul(double alo, double ahi, double blo, double bhi,
                      const Sites* s, int which, double& rlo, double& rhi) {
  double p1 = alo * blo;
  double p2 = alo * bhi;
  double p3 = ahi * blo;
  double p4 = ahi * bhi;
  bool fix = nan_(((p1 + p2) + p3) + p4);
  if (s) {
    const int site = s->base + which;
    if (fix && s->rec) __stcg(s->rec + site, 1);
    if (!fix && s->used) fix = __ldcg(s->used + site) != 0;
  }
  if (fix) {
    if (alo == 0.0 || blo == 0.0) p1 = 0.0;
    if (alo == 0.0 || bhi == 0.0) p2 = 0.0;
    if (ahi == 0.0 || blo == 0.0) p3 = 0.0;
    if (ahi == 0.0 || bhi == 0.0) p4 = 0.0;
  }
  rlo = np_min(np_min(p1, p2), np_min(p3, p4));
  rhi = np_max(np_max(p1, p2), np_max(p3, p4));
}

__device__ void b_div(double alo, double ahi, double blo, double bhi,
                      const Sites* s, int which, double& rlo, double& rhi) {
  const bool straddle = (blo <= 0.0) && (0.0 <= bhi);
  const double ilo = 1.0 / bhi;
  const double ihi = 1.0 / blo;
  b_mul(alo, ahi, ilo, ihi, s, which, rlo, rhi);
  if (straddle) {
    rlo = -INF;
    rhi = INF;
  }
}

__device__ void b_pow(double alo, double ahi, int n, double& lo,
                      double& hi) {
  if (n == 0) {
    lo = hi = 1.0;
    return;
  }
  const double l = npow(alo, n);
  const double h = npow(ahi, n);
  if (odd(n)) {
    lo = l;
    hi = h;
    return;
  }
  lo = alo >= 0.0 ? l : (ahi < 0.0 ? h : 0.0);
  hi = alo >= 0.0 ? h : (ahi < 0.0 ? l : np_max(l, h));
}

// `_b_cmp`: (provably true, provably false)
__device__ __forceinline__ void b_cmp(int code, double llo, double lhi,
                                      double rlo, double rhi, bool& t,
                                      bool& f) {
  switch (code) {
    case 0: t = lhi < rlo; f = llo >= rhi; break;     // <
    case 1: t = lhi <= rlo; f = llo > rhi; break;     // <=
    case 2: t = llo > rhi; f = lhi <= rlo; break;     // >
    default: t = llo >= rhi; f = lhi < rlo; break;    // >=
  }
}

// `_b_ext_div`: the hull of the extended division v / b
__device__ void b_ext_div(double vlo, double vhi, double blo, double bhi,
                          const Sites* s, int which, double& rlo,
                          double& rhi) {
  const bool nz = (blo > 0.0) || (bhi < 0.0);
  double dlo, dhi;
  b_div(vlo, vhi, blo, bhi, s, which, dlo, dhi);
  if (nz) {
    rlo = dlo;
    rhi = dhi;
    return;
  }
  rlo = -INF;
  rhi = INF;
  if (blo == 0.0 && bhi > 0.0) {
    if (vlo > 0.0) { rlo = vlo / bhi; rhi = INF; }
    if (vhi < 0.0) { rlo = -INF; rhi = vhi / bhi; }
  }
  if (bhi == 0.0 && blo < 0.0) {
    if (vlo > 0.0) { rlo = -INF; rhi = vlo / blo; }
    if (vhi < 0.0) { rlo = vhi / blo; rhi = INF; }
  }
}

__device__ double b_root(double x, int n) {
  const double ax = fabs(x);
  const double r = n == 1 ? ax : (n == 2 ? sqrt(ax) : tpow(ax, 1.0 / n));
  return x > 0.0 ? r : 0.0;
}

__device__ __forceinline__ void arg(const Table& t, int k, int j,
                                    const double* lo, const double* hi,
                                    double& l, double& h) {
  const int ix = __ldg(t.argv + 4 * k + j);
  if (ix >= 0) {
    l = lo[ix];
    h = hi[ix];
  } else {
    l = h = __ldg(t.argc + 4 * k + j);
  }
}

// `_b_meet` of (nlo, nhi) into variable i of the box
__device__ void meet(double* lo, double* hi, int i, double nlo, double nhi,
                     bool& alive, bool& changed) {
  const double lo_c = lo[i];
  const double hi_c = hi[i];
  double mlo = np_fmax(lo_c, nlo);
  double mhi = np_fmin(hi_c, nhi);
  const double gap = mlo - mhi;
  if (gap > 0.0) {
    const double slack =
        MEET_SLACK * np_max(1.0, np_max(fabs(mlo), fabs(mhi)));
    const bool near = (gap <= slack) && isfinite(mlo) && isfinite(mhi);
    if (near) {
      const double mid = 0.5 * (mlo + mhi);
      mlo = mid;
      mhi = mid;
    } else {
      alive = false;
    }
  }
  changed |= (mlo != lo_c) || (mhi != hi_c);
  lo[i] = mlo;
  hi[i] = mhi;
}

// ---------------------------------------------------------------------
// hc4
// ---------------------------------------------------------------------

// `_b_forward` of def k
__device__ void forward(const Table& t, int k, const double* lo,
                        const double* hi, const Sites* s, double& flo,
                        double& fhi) {
  const int op = __ldg(t.opcode + k);
  double alo, ahi, blo, bhi;
  arg(t, k, 0, lo, hi, alo, ahi);
  switch (op) {
    case OP_POW:
      b_pow(alo, ahi, __ldg(t.pow_n + k), flo, fhi);
      return;
    case OP_ABS:
      flo = alo >= 0.0 ? alo : (ahi <= 0.0 ? -ahi : 0.0);
      fhi = alo >= 0.0 ? ahi : (ahi <= 0.0 ? -alo : np_max(-alo, ahi));
      return;
    case OP_SQRT:
      flo = sqrt(np_max(alo, 0.0));
      fhi = sqrt(np_max(ahi, 0.0));
      return;
    default:
      break;
  }
  arg(t, k, 1, lo, hi, blo, bhi);
  switch (op) {
    case OP_ADD: flo = alo + blo; fhi = ahi + bhi; return;
    case OP_SUB: flo = alo - bhi; fhi = ahi - blo; return;
    case OP_MUL: b_mul(alo, ahi, blo, bhi, s, 0, flo, fhi); return;
    case OP_DIV: b_div(alo, ahi, blo, bhi, s, 0, flo, fhi); return;
    case OP_MIN: flo = np_min(alo, blo); fhi = np_min(ahi, bhi); return;
    case OP_MAX: flo = np_max(alo, blo); fhi = np_max(ahi, bhi); return;
    default: break;
  }
  bool tr, fa;   // select
  b_cmp(__ldg(t.cmp + k), alo, ahi, blo, bhi, tr, fa);
  double tlo, thi, olo, ohi;
  arg(t, k, 2, lo, hi, tlo, thi);
  arg(t, k, 3, lo, hi, olo, ohi);
  const double jlo = np_min(tlo, olo);
  const double jhi = np_max(thi, ohi);
  flo = tr ? tlo : (fa ? olo : jlo);
  fhi = tr ? thi : (fa ? ohi : jhi);
}

// `_b_backward` of def k, then the meets of its variable slots in order
__device__ void backward(const Table& t, int k, double* lo, double* hi,
                         const Sites* s, bool& alive, bool& changed) {
  const int i = __ldg(t.def_var + k);
  const int op = __ldg(t.opcode + k);
  const int* argv = t.argv + 4 * k;
  const double vlo = lo[i];
  const double vhi = hi[i];
  double alo, ahi, blo = 0.0, bhi = 0.0;
  arg(t, k, 0, lo, hi, alo, ahi);
  int slot[2];
  double clo[2], chi[2];
  int n_out = 0;
  const bool v0 = __ldg(argv) >= 0;
  const bool v1 = __ldg(argv + 1) >= 0;
  switch (op) {
    case OP_POW: {
      const int n = __ldg(t.pow_n + k);
      if (odd(n)) {
        const double rl = copysign(b_root(fabs(vlo), n), vlo);
        const double rh = copysign(b_root(fabs(vhi), n), vhi);
        slot[0] = 0; clo[0] = np_min(rl, rh); chi[0] = np_max(rl, rh);
        n_out = 1;
      } else if (n > 0) {
        const double r = b_root(np_max(vhi, 0.0), n);
        const double rp = b_root(np_max(vlo, 0.0), n);
        slot[0] = 0;
        clo[0] = alo >= 0.0 ? rp : -r;
        chi[0] = alo >= 0.0 ? r : (ahi <= 0.0 ? -rp : r);
        n_out = 1;
      }
      break;
    }
    case OP_ABS:
      slot[0] = 0;
      clo[0] = alo >= 0.0 ? np_max(vlo, 0.0) : -vhi;
      chi[0] = alo >= 0.0 ? vhi : (ahi <= 0.0 ? -np_max(vlo, 0.0) : vhi);
      n_out = 1;
      break;
    case OP_SQRT:
      slot[0] = 0;
      clo[0] = vlo > 0.0 ? vlo * vlo : -INF;
      chi[0] = vhi * vhi;
      n_out = 1;
      break;
    case OP_SELECT: {
      arg(t, k, 1, lo, hi, blo, bhi);
      bool tr, fa;
      b_cmp(__ldg(t.cmp + k), alo, ahi, blo, bhi, tr, fa);
      slot[0] = 2; clo[0] = tr ? vlo : -INF; chi[0] = tr ? vhi : INF;
      slot[1] = 3; clo[1] = fa ? vlo : -INF; chi[1] = fa ? vhi : INF;
      n_out = 2;
      break;
    }
    case OP_MIN:
    case OP_MAX: {
      arg(t, k, 1, lo, hi, blo, bhi);
      for (int sl = 0; sl < 2; ++sl) {
        const double xlo = sl ? blo : alo, xhi = sl ? bhi : ahi;
        const double ylo = sl ? alo : blo, yhi = sl ? ahi : bhi;
        double l, h;
        if (op == OP_MIN) {
          l = vlo + 0.0;
          h = ylo <= vhi ? xhi : np_min(xhi, vhi);
        } else {
          h = vhi + 0.0;
          l = yhi >= vlo ? xlo : np_max(xlo, vlo);
        }
        const bool bad = l > h;
        if (bad) alive = false;
        slot[sl] = sl;
        clo[sl] = bad ? -INF : l;
        chi[sl] = bad ? INF : h;
      }
      n_out = 2;
      break;
    }
    default: {   // the binary arithmetic ops: variable slots only
      arg(t, k, 1, lo, hi, blo, bhi);
      if (v0) {
        slot[n_out] = 0;
        double& l = clo[n_out];
        double& h = chi[n_out];
        switch (op) {
          case OP_ADD: l = vlo - bhi; h = vhi - blo; break;
          case OP_SUB: l = vlo + blo; h = vhi + bhi; break;
          case OP_MUL: b_ext_div(vlo, vhi, blo, bhi, s, 1, l, h); break;
          default: b_mul(vlo, vhi, blo, bhi, s, 1, l, h); break;  // DIV
        }
        ++n_out;
      }
      if (v1) {
        slot[n_out] = 1;
        double& l = clo[n_out];
        double& h = chi[n_out];
        switch (op) {
          case OP_ADD: l = vlo - ahi; h = vhi - alo; break;
          case OP_SUB: l = alo - vhi; h = ahi - vlo; break;
          case OP_MUL: b_ext_div(vlo, vhi, alo, ahi, s, 2, l, h); break;
          default: b_ext_div(alo, ahi, vlo, vhi, s, 2, l, h); break;
        }
        ++n_out;
      }
      break;
    }
  }
  for (int o = 0; o < n_out; ++o) {
    const int ix = __ldg(argv + slot[o]);
    if (ix >= 0) meet(lo, hi, ix, clo[o], chi[o], alive, changed);
  }
}

// one round of `_hc4_rows` on one box: the defs forward in table order,
// then backward
__device__ void hc4_round(const Table& t, double* lo, double* hi, int r,
                          const int* used, int* rec, bool& alive,
                          bool& changed) {
  Sites s{used, rec, 0};
  for (int k = 0; k < t.ndefs; ++k) {
    s.base = (r * t.ndefs + k) * SITES_PER_DEF;
    double flo, fhi;
    forward(t, k, lo, hi, &s, flo, fhi);
    meet(lo, hi, __ldg(t.def_var + k), flo, fhi, alive, changed);
  }
  for (int k = t.ndefs - 1; k >= 0; --k) {
    s.base = (r * t.ndefs + k) * SITES_PER_DEF;
    backward(t, k, lo, hi, &s, alive, changed);
  }
}

// a barrier over the whole grid (every block is resident: the launch is
// cooperative); `gen` counts the arrivals every block expects
__device__ void grid_sync(unsigned* bar, unsigned& gen) {
  gen += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (atomicAdd(bar, 0u) < gen) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

struct Hc4Args {
  double* lo;
  double* hi;
  const uint8_t* alive_in;
  uint8_t* alive_out;
  double* back_lo;     // the frontier as given, for the replays
  double* back_hi;
  int* scratch;        // zeroed: barrier, rounds run, passes, round
                       // flags, two site sets
  Table t;
  int N, nvars, rounds;
};

__global__ void __launch_bounds__(THREADS) hc4_kernel(Hc4Args a) {
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nv = (size_t)a.nvars;
  const int sites = a.rounds * a.t.ndefs * SITES_PER_DEF;
  unsigned* bar = (unsigned*)a.scratch;
  int* round_changed = a.scratch + 3;
  int* used = round_changed + a.rounds;   // stays zero in the first pass
  int* rec = used + sites;
  unsigned gen = 0;

  for (int b = tid; b < a.N; b += stride) {
    for (size_t j = 0; j < nv; ++j) {
      a.back_lo[b * nv + j] = a.lo[b * nv + j];
      a.back_hi[b * nv + j] = a.hi[b * nv + j];
    }
    a.alive_out[b] = a.alive_in[b];
  }
  // first pass: the rounds with the plain version's stopping rule; no
  // site fixed on rows without a NaN of their own
  int rounds = 0;
  for (int r = 0; r < a.rounds; ++r) {
    for (int b = tid; b < a.N; b += stride) {
      bool alive = a.alive_out[b] != 0;
      bool changed = false;
      hc4_round(a.t, a.lo + b * nv, a.hi + b * nv, r, nullptr, rec, alive,
                changed);
      a.alive_out[b] = alive;
      if (changed && alive) __stcg(round_changed + r, 1);
    }
    grid_sync(bar, gen);
    rounds = r + 1;
    if (__ldcg(round_changed + r) == 0) break;
  }
  // replays with the sites the last pass recorded, until a pass records
  // the sites it used
  int passes = 1;
  for (;;) {
    int differ = 0;
    for (int i = threadIdx.x; i < sites; i += blockDim.x)
      differ |= __ldcg(rec + i) != __ldcg(used + i);
    if (!__syncthreads_or(differ)) break;
    int* t = used;
    used = rec;
    rec = t;
    grid_sync(bar, gen);   // every block has read `rec` before it is zeroed
    for (int i = tid; i < sites; i += stride) __stcg(rec + i, 0);
    grid_sync(bar, gen);
    for (int b = tid; b < a.N; b += stride) {
      double* lo = a.lo + b * nv;
      double* hi = a.hi + b * nv;
      for (size_t j = 0; j < nv; ++j) {
        lo[j] = a.back_lo[b * nv + j];
        hi[j] = a.back_hi[b * nv + j];
      }
      bool alive = a.alive_in[b] != 0;
      bool changed = false;
      for (int r = 0; r < rounds; ++r)
        hc4_round(a.t, lo, hi, r, used, rec, alive, changed);
      a.alive_out[b] = alive;
    }
    grid_sync(bar, gen);
    ++passes;
  }
  if (tid == 0) {
    a.scratch[1] = rounds;
    a.scratch[2] = passes;
  }
}

// ---------------------------------------------------------------------
// gradients
// ---------------------------------------------------------------------

// glo += g * p over the adjoint's interval; a NaN sum is -inf / +inf
__device__ __forceinline__ void accumulate(double* glo, double* ghi, int ix,
                                           double gl, double gh, double plo,
                                           double phi) {
  double dlo, dhi;
  b_mul(gl, gh, plo, phi, nullptr, 0, dlo, dhi);
  const double nlo = glo[ix] + dlo;
  const double nhi = ghi[ix] + dhi;
  glo[ix] = nan_(nlo) ? -INF : nlo;
  ghi[ix] = nan_(nhi) ? INF : nhi;
}

__global__ void __launch_bounds__(THREADS) grad_kernel(
    const double* __restrict__ LO, const double* __restrict__ HI,
    double* GLO, double* GHI, Table t, int N, int nvars, int root) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= N) return;
  const size_t nv = (size_t)nvars;
  const double* lo = LO + b * nv;
  const double* hi = HI + b * nv;
  double* glo = GLO + b * nv;
  double* ghi = GHI + b * nv;
  for (size_t j = 0; j < nv; ++j) {
    glo[j] = 0.0;
    ghi[j] = 0.0;
  }
  glo[root] = 1.0;
  ghi[root] = 1.0;
  for (int k = t.ndefs - 1; k >= 0; --k) {
    const int i = __ldg(t.def_var + k);
    const double gl = glo[i];
    const double gh = ghi[i];
    if (gl == 0.0 && gh == 0.0) continue;
    const int op = __ldg(t.opcode + k);
    const int* argv = t.argv + 4 * k;
    double alo, ahi, blo = 0.0, bhi = 0.0;
    arg(t, k, 0, lo, hi, alo, ahi);
    double plo[4], phi[4];
    int nparts = 1;
    switch (op) {
      case OP_POW: {
        const int n = __ldg(t.pow_n + k);
        if (n == 0) {
          plo[0] = phi[0] = 0.0;
        } else {
          double l, h;
          b_pow(alo, ahi, n - 1, l, h);
          plo[0] = (double)n * l;
          phi[0] = (double)n * h;
        }
        break;
      }
      case OP_ABS:
        plo[0] = alo >= 0.0 ? 1.0 : -1.0;
        phi[0] = alo >= 0.0 ? 1.0 : (ahi <= 0.0 ? -1.0 : 1.0);
        break;
      case OP_SQRT: {
        const bool pos = alo > 0.0;
        plo[0] = pos ? 0.5 * (1.0 / sqrt(np_max(ahi, 1e-300))) : 0.0;
        phi[0] = pos ? 0.5 * (1.0 / sqrt(pos ? alo : 1.0)) : INF;
        break;
      }
      case OP_ADD:
        plo[0] = phi[0] = plo[1] = phi[1] = 1.0;
        nparts = 2;
        break;
      case OP_SUB:
        plo[0] = phi[0] = 1.0;
        plo[1] = phi[1] = -1.0;
        nparts = 2;
        break;
      case OP_MUL:
        arg(t, k, 1, lo, hi, blo, bhi);
        plo[0] = blo; phi[0] = bhi;
        plo[1] = alo; phi[1] = ahi;
        nparts = 2;
        break;
      case OP_DIV: {
        arg(t, k, 1, lo, hi, blo, bhi);
        const bool nz = (blo > 0.0) || (bhi < 0.0);
        const double ivlo = 1.0 / (nz ? bhi : 1.0);
        const double ivhi = 1.0 / (nz ? blo : 1.0);
        double i2lo, i2hi, q0lo, q0hi;
        b_pow(ivlo, ivhi, 2, i2lo, i2hi);
        b_mul(-ahi, -alo, i2lo, i2hi, nullptr, 0, q0lo, q0hi);
        plo[0] = nz ? ivlo : -INF; phi[0] = nz ? ivhi : INF;
        plo[1] = nz ? q0lo : -INF; phi[1] = nz ? q0hi : INF;
        nparts = 2;
        break;
      }
      case OP_MIN:
      case OP_MAX:
        plo[0] = plo[1] = 0.0;
        phi[0] = phi[1] = 1.0;
        nparts = 2;
        break;
      default: {   // select
        arg(t, k, 1, lo, hi, blo, bhi);
        bool tr, fa;
        b_cmp(__ldg(t.cmp + k), alo, ahi, blo, bhi, tr, fa);
        const bool und = !tr && !fa;
        plo[0] = plo[1] = und ? -INF : 0.0;
        phi[0] = phi[1] = und ? INF : 0.0;
        plo[2] = tr ? 1.0 : 0.0;
        phi[2] = (tr || und) ? 1.0 : 0.0;
        plo[3] = fa ? 1.0 : 0.0;
        phi[3] = (fa || und) ? 1.0 : 0.0;
        nparts = 4;
        break;
      }
    }
    for (int p = 0; p < nparts; ++p) {
      const int ix = __ldg(argv + p);
      if (ix >= 0) accumulate(glo, ghi, ix, gl, gh, plo[p], phi[p]);
    }
  }
}

int coop_blocks(int N) {
  static int per_sm[64] = {0}, sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev],
                                                      hc4_kernel, THREADS, 0);
    if (e != cudaSuccess) return -(int)e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm[dev] <= 0) return -(int)cudaErrorLaunchOutOfResources;
  }
  const long long want = ((long long)N + THREADS - 1) / THREADS;
  const long long most = (long long)per_sm[dev] * sms[dev];
  return (int)(want < most ? want : most);
}

}  // namespace

// The ints hc4's scratch needs: the barrier, the rounds the call ran and
// its passes (read back by measurements), a flag a round, and two site
// sets of rounds x ndefs x 3.
extern "C" int smt_hc4_scratch_ints(int ndefs, int rounds) {
  return 3 + rounds + 2 * rounds * ndefs * SITES_PER_DEF;
}

// hc4 on the frontier (lo, hi) in place; alive_out[b] is box b's alive
// flag after it (alive_in is read only).  back_lo/back_hi: N x nvars f64
// scratch; scratch: smt_hc4_scratch_ints int32, zeroed here.
extern "C" int smt_hc4_launch(void* lo, void* hi, const void* alive_in,
                              void* alive_out, void* back_lo, void* back_hi,
                              void* scratch, const void* def_var,
                              const void* opcode, const void* argv,
                              const void* argc, const void* pow_n,
                              const void* cmp, int N, int nvars, int ndefs,
                              int rounds, void* stream) {
  if (N < 0 || nvars <= 0 || ndefs < 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  auto st = (cudaStream_t)stream;
  const size_t ints = (size_t)smt_hc4_scratch_ints(ndefs, rounds);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * ints, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = coop_blocks(N);
  if (blocks <= 0) return -blocks;
  Hc4Args a{(double*)lo, (double*)hi, (const uint8_t*)alive_in,
            (uint8_t*)alive_out, (double*)back_lo, (double*)back_hi,
            (int*)scratch,
            Table{(const int*)def_var, (const int*)opcode, (const int*)argv,
                  (const double*)argc, (const int*)pow_n, (const int*)cmp,
                  ndefs},
            N, nvars, rounds};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)hc4_kernel, dim3(blocks),
                                  dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// glo, ghi (N x nvars f64): the interval gradient of variable `root`
// over each box of (lo, hi).
extern "C" int smt_grad_launch(const void* lo, const void* hi, void* glo,
                               void* ghi, const void* def_var,
                               const void* opcode, const void* argv,
                               const void* argc, const void* pow_n,
                               const void* cmp, int N, int nvars, int ndefs,
                               int root, void* stream) {
  if (N < 0 || nvars <= 0 || ndefs < 0 || root < 0 || root >= nvars)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  grad_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)lo, (const double*)hi, (double*)glo, (double*)ghi,
      Table{(const int*)def_var, (const int*)opcode, (const int*)argv,
            (const double*)argc, (const int*)pow_n, (const int*)cmp, ndefs},
      N, nvars, root);
  return (int)cudaGetLastError();
}
