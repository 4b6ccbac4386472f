// Gray flux-limited-diffusion (FLD) operator kernels for Hopper (sm_90a).
//
// What they replace: the two TPU Pallas kernels of
// artemis_tpu/ops/pallas_fld.py,
//   fld_coeffs -> _coeffs_kernel (:146, :88): the operator setup
//   fld_matvec -> _matvec_kernel (:200, :188): the 7-point operator applied
//                 once per conjugate-gradient iteration
// On the TPU both are BlockSpec pipelines over z-blocks that take their z
// halo from the (i +/- 1 mod nzb) neighbour blocks and rotate x/y in VMEM.
// Here every neighbour is wrapped by index (jnp.roll semantics, the
// reference's), so there is no even-nz rule and any extent is taken, down
// to two cells, where a cell's two neighbours along an axis coincide.
//
// fld_coeffs, per cell: the Levermore-Pomraning limiter from |grad E|
// (central differences over wrapped neighbours, also across the physical
// edges, as the reference does), the capped diffusivity
//   Dcell = min(c lam / (chi + tiny), c ext),
// the face averages 0.5 (Dcell + Dcell_nb) masked at the physical edges
// (zero flux, or the one-sided Dcell at a Dirichlet edge, whose wrapped
// neighbour coefficient is then 0), the off-diagonal rows
// A = [AL1, AH1, AL2, AH2, AL3, AH3] with dt / w_d^2 folded in, and the
// geometric Jacobi diagonal 1 + dt sum_d (D_hi + D_lo) / w_d^2.  A cell's
// face coefficients need Dcell at the cell and its six neighbours, and
// each of those needs E at its own six neighbours.
//
// fld_matvec, per cell: (diag + sf) E - sum_d (AH_d E_+d + AL_d E_-d),
// the terms subtracted in the kernel's order (x, y, z; hi before lo).
//
// The node axis (the counterpart of the JAX tree's vmap over a level's
// same-shape patches, artemis_tpu/amr.py:1968-1984): one launch takes nn
// same-shape nodes stacked on a leading axis, the fields as
// [nn, nz, ny, nx] and A as [nn, 6, nz, ny, nx], so that A[n] is node n's
// one-node layout.  The node is the grid's y index (blockIdx.y) in both
// kernels; node_params moves every pointer to that node's fields, and the
// node's cells then run the one-node code unchanged, so every neighbour
// wraps inside the node's own box and a node-axis launch is bitwise equal
// to nn one-node launches.  (The stack read as one [nn nz, ny, nx] box
// would give a node's edge cell its z neighbour from the next node, and
// the limiter's gradient there is not masked: a wrong answer, not a
// harmless one.)
//
// What bounds them on the H100: bytes.  fld_coeffs reads E and chi and
// writes A (6 fields), diag and Dcell: 10 fields, 4 B each in float32, one
// square root and three divisions per cell; fld_matvec reads E, A (6),
// diag and sf and writes one field: 10 fields, 13 flops per cell.  At
// 512x512x64 both move 671 MB in float32, 0.20 ms at 3.35 TB/s.
//
// Two bodies of fld_coeffs.  The per-cell body (coeffs_cell, one thread per
// cell in flat 256-thread blocks) computes Dcell seven times per cell, once
// for the cell and once for each neighbour: a 25-point stencil of E and 7
// of chi, 7 square roots and 21 divisions, every neighbour found through
// 64-bit index arithmetic with wrap tests, every load through L1/L2.  It
// is reached only through the wrapper's measurement switch.  The tiled
// body (coeffs_tiled_kernel), which every launch takes: a block owns a
// TX x TY = 32 x 8 footprint of columns and marches up a chunk of TZ = 16
// planes.  Each plane of E is staged once by cp.async into a ring of NE
// planes in shared memory with an x/y halo of two, chi with a halo of
// one, every index wrapped (a footprint row inside [0, nx) is one run,
// copied 16 bytes at a time where aligned); the copies run AHEAD planes
// ahead of the plane they feed.  Dcell is made once per cell and plane
// over the footprint and its 1-wide ring into a ring of four Dcell planes
// (planes k - 1 .. k + 1 are read while k + 2 is made), and each cell's
// faces, masks and diagonal are formed from shared memory and stored as
// whole rows.  One barrier per plane.  Both bodies evaluate the same
// functions (dcell_of, coeffs_store) on the same values, and the source
// builds with -fmad=false (_build.SOURCE_FLAGS), so the two agree bitwise.
//
// Binding: plain C entry points called through ctypes.  Each launches on
// the caller's stream, reads dt from device memory, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "stage_common.cuh"

namespace {

using artemis::copy_async;
using artemis::copy_async16;
using artemis::copy_commit;
using artemis::copy_wait;

struct FldInts {
  int count;                // sizeof(FldInts) / sizeof(int), from the caller
  int nx, ny, nz;
  int lo_dir[3], hi_dir[3]; // per direction: Dirichlet (1) or zero-flux (0) edge
  int nn;                   // nodes on the leading axis (1: one [nz, ny, nx] node)
};

struct FldReals {
  double count;             // sizeof(FldReals) / sizeof(double)
  double half_idx[3];       // 0.5 / w_d (central-difference factor)
  double iw2[3];            // 1 / w_d^2
  double dcap;              // c * ext, the diffusivity cap
  double c_code;
  double tiny;              // finfo(dtype).tiny
};

struct FldParams {
  FldInts n;
  FldReals r;
  // per node (each pointer leads an [nn, ...] stack of these)
  const void* E;            // [nz, ny, nx]
  const void* chi;          // [nz, ny, nx] (coeffs) or the coefficients A [6, nz, ny, nx] (matvec)
  const void* dt;           // one element (coeffs), shared by the nodes
  const void* diag;         // [nz, ny, nx] (matvec)
  const void* sf;           // [nz, ny, nx] (matvec)
  void* out0;               // coeffs: A [6, nz, ny, nx]; matvec: the product [nz, ny, nx]
  void* out1;               // coeffs: diag
  void* out2;               // coeffs: Dcell
};

// Unpacks the caller's arrays; false when their layout differs from this
// build's.
inline bool make_params(const int* ints, const double* reals, FldParams* p) {
  if (ints[0] != int(sizeof(FldInts) / sizeof(int)) ||
      reals[0] != double(sizeof(FldReals) / sizeof(double)))
    return false;
  memcpy(&p->n, ints, sizeof(FldInts));
  memcpy(&p->r, reals, sizeof(FldReals));
  return p->n.nn >= 1 && p->n.nn <= 65535;
}

template <typename T>
__device__ __forceinline__ T fmaxt(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T fmint(T a, T b) { return a < b ? a : b; }

// wrapped neighbour indices (jnp.roll)
__device__ __forceinline__ int up(int i, int n) { return i + 1 == n ? 0 : i + 1; }
__device__ __forceinline__ int dn(int i, int n) { return i == 0 ? n - 1 : i - 1; }

struct Cell {
  int i, j, k;
};

__device__ __forceinline__ Cell cell_of(const FldInts& n, int64_t cell) {
  Cell c;
  c.i = int(cell % n.nx);
  c.j = int((cell / n.nx) % n.ny);
  c.k = int(cell / (int64_t(n.nx) * n.ny));
  return c;
}

__device__ __forceinline__ int64_t at(const FldInts& n, int k, int j, int i) {
  return (int64_t(k) * n.ny + j) * n.nx + i;
}

// The neighbour of (k, j, i) one cell along direction d (0: x, 1: y, 2: z)
// on side s (+1 / -1), wrapped.
__device__ __forceinline__ Cell step(const FldInts& n, Cell c, int d, int s) {
  if (d == 0) c.i = s > 0 ? up(c.i, n.nx) : dn(c.i, n.nx);
  else if (d == 1) c.j = s > 0 ? up(c.j, n.ny) : dn(c.j, n.ny);
  else c.k = s > 0 ? up(c.k, n.nz) : dn(c.k, n.nz);
  return c;
}

// The capped FLD diffusivity of a cell from E at its neighbours above
// (xp, yp, zp) and below (xm, ym, zm) along x, y, z, its own E (e0) and chi
// (x): the limiter of _coeffs_kernel.  Both bodies of fld_coeffs call it.
template <typename T>
__device__ __forceinline__ T dcell_of(const FldReals& r, T xp, T xm, T yp, T ym, T zp, T zm,
                                      T e0, T x) {
  const T g[3] = {(xp - xm) * T(r.half_idx[0]), (yp - ym) * T(r.half_idx[1]),
                  (zp - zm) * T(r.half_idx[2])};
  const T g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
  const T tiny = T(r.tiny);
  const T R = sqrt(g2) / (x * fmaxt(e0, tiny) + tiny);
  const T lam = (T(2) + R) / (T(6) + T(3) * R + R * R);  // Levermore-Pomraning
  return fmint(T(r.c_code) * lam / (x + tiny), T(r.dcap));
}

// The capped FLD diffusivity at cell c (the limiter on wrapped neighbours).
template <typename T>
__device__ __forceinline__ T dcell(const FldParams& p, const T* E, const T* chi, Cell c) {
  const FldInts& n = p.n;
  T e[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const Cell a = step(n, c, d, 1), b = step(n, c, d, -1);
    e[d][0] = E[at(n, a.k, a.j, a.i)];
    e[d][1] = E[at(n, b.k, b.j, b.i)];
  }
  const int64_t q = at(n, c.k, c.j, c.i);
  return dcell_of(p.r, e[0][0], e[0][1], e[1][0], e[1][1], e[2][0], e[2][1], E[q], chi[q]);
}

// fld_coeffs' outputs at cell ``cell`` (flat index into [nz, ny, nx]) at
// grid position pos (x, y, z) from its diffusivity D0 and its neighbours'
// above (Dp[d]) and below (Dm[d]) along d: the face averages, the edge
// masks, the A rows and the diagonal.  Both bodies call it.
template <typename T>
__device__ __forceinline__ void coeffs_store(const FldParams& p, T dt, int64_t cell,
                                             const int (&pos)[3], T D0, const T (&Dp)[3],
                                             const T (&Dm)[3]) {
  const FldInts& n = p.n;
  T* A = static_cast<T*>(p.out0);
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const int ext[3] = {n.nx, n.ny, n.nz};
  T diag = T(1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool first = pos[d] == 0, last = pos[d] == ext[d] - 1;
    T D_hi = T(0.5) * (D0 + Dp[d]);
    T D_lo = T(0.5) * (D0 + Dm[d]);
    T A_hi, A_lo;
    if (n.hi_dir[d]) {
      D_hi = last ? D0 : D_hi;
      A_hi = last ? T(0) : D_hi;
    } else {
      D_hi = last ? T(0) : D_hi;
      A_hi = D_hi;
    }
    if (n.lo_dir[d]) {
      D_lo = first ? D0 : D_lo;
      A_lo = first ? T(0) : D_lo;
    } else {
      D_lo = first ? T(0) : D_lo;
      A_lo = D_lo;
    }
    const T iw2 = T(p.r.iw2[d]);
    diag = diag + dt * ((D_hi + D_lo) * iw2);
    const T s = dt * iw2;
    A[(2 * d) * ncell + cell] = s * A_lo;
    A[(2 * d + 1) * ncell + cell] = s * A_hi;
  }
  static_cast<T*>(p.out1)[cell] = diag;
  static_cast<T*>(p.out2)[cell] = D0;
}

// fld_coeffs at one cell (flat index into [nz, ny, nx]): the per-cell body.
template <typename T>
__device__ __forceinline__ void coeffs_cell(const FldParams& p, int64_t cell) {
  const FldInts& n = p.n;
  const T* E = static_cast<const T*>(p.E);
  const T* chi = static_cast<const T*>(p.chi);
  const Cell c = cell_of(n, cell);
  const int pos[3] = {c.i, c.j, c.k};
  const T dt = static_cast<const T*>(p.dt)[0];
  T Dp[3], Dm[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    Dp[d] = dcell(p, E, chi, step(n, c, d, 1));
    Dm[d] = dcell(p, E, chi, step(n, c, d, -1));
  }
  coeffs_store(p, dt, cell, pos, dcell(p, E, chi, c), Dp, Dm);
}

// ---- the tiled body of fld_coeffs

// A block's footprint (TX x TY columns), the planes of its z chunk (TZ),
// how many planes ahead of the one they feed its copies run (AHEAD), the
// blocks an SM is to hold (MINB, the launch bound: in f32 six, at 40
// registers a thread, 5% faster than the four that 58 registers allow;
// in f64 four, as its shared memory allows), and its rings of planes in
// shared memory: E (a halo of two) and chi (a halo of one), whose slots
// hold the prologue's planes and those in flight behind them (E z0 - 2 ..
// z0 + 1 + AHEAD: NE >= 4 + AHEAD; chi z0 - 1 .. z0 + AHEAD: NC >= 2 +
// AHEAD), and Dcell (ND = 4: planes k - 1 .. k + 1 read while k + 2 is
// made, over the footprint and its 1-wide ring).  A staged row of E or chi
// is RX wide with footprint column 0 at column 4, 16-byte aligned.
template <typename T>
struct FldTile {
  static constexpr int TX = 32, TY = 8, TZ = 16, NT = TX * TY, AHEAD = 2;
  static constexpr int MINB = sizeof(T) == 4 ? 6 : 4;
  static constexpr int NE = 8, NC = 4, ND = 4, VEC = 16 / int(sizeof(T));
  static constexpr int RX = TX + 8, EPL = (TY + 4) * RX, CPL = (TY + 2) * RX;
  static constexpr int DX = TX + 2, DY = TY + 2, DPL = DY * DX;
  static constexpr int ELEMS = NE * EPL + NC * CPL + ND * DPL;
  static constexpr int BYTES = ELEMS * int(sizeof(T));
  static_assert(NE >= 4 + AHEAD && NC >= 2 + AHEAD && (NE & (NE - 1)) == 0 &&
                    (NC & (NC - 1)) == 0 && RX % VEC == 0 && EPL % VEC == 0 && CPL % VEC == 0,
                "ring sizes and 16-byte rows");
};

template <typename T>
struct FldMem {
  using L = FldTile<T>;
  T *e, *x, *d;
  __device__ __forceinline__ explicit FldMem(T* s)
      : e(s), x(s + L::NE * L::EPL), d(x + L::NC * L::CPL) {}
  // E of ring slot s at footprint row y (-2 .. TY + 1), column i (-2 .. TX + 1)
  __device__ __forceinline__ T& E(int s, int y, int i) const {
    return e[s * L::EPL + (y + 2) * L::RX + i + 4];
  }
  // chi of ring slot s at footprint row y (-1 .. TY), column i (-1 .. TX)
  __device__ __forceinline__ T& X(int s, int y, int i) const {
    return x[s * L::CPL + (y + 1) * L::RX + i + 4];
  }
  // Dcell of ring slot s at footprint row y (-1 .. TY), column i (-1 .. TX)
  __device__ __forceinline__ T& D(int s, int y, int i) const {
    return d[s * L::DPL + (y + 1) * L::DX + i + 1];
  }
};

struct FldPos {
  int x0, y0, z0, z1;       // footprint origin and the chunk's planes [z0, z1)
};

// Blocks: x tiles fastest, then y tiles, then z chunks.
template <typename T>
__host__ __device__ __forceinline__ int64_t fld_tiles(const FldInts& n) {
  using L = FldTile<T>;
  return int64_t((n.nx + L::TX - 1) / L::TX) * ((n.ny + L::TY - 1) / L::TY) *
         ((n.nz + L::TZ - 1) / L::TZ);
}

template <typename T>
__device__ __forceinline__ FldPos fld_pos(const FldInts& n, int64_t blk) {
  using L = FldTile<T>;
  const int nbx = (n.nx + L::TX - 1) / L::TX, nby = (n.ny + L::TY - 1) / L::TY;
  FldPos t;
  t.x0 = int(blk % nbx) * L::TX;
  t.y0 = int((blk / nbx) % nby) * L::TY;
  t.z0 = int(blk / (int64_t(nbx) * nby)) * L::TZ;
  t.z1 = t.z0 + L::TZ < n.nz ? t.z0 + L::TZ : n.nz;
  return t;
}

// i wrapped into [0, n) (jnp.roll), the division only for an index outside
__device__ __forceinline__ int wrap_near(int i, int n) {
  return unsigned(i) < unsigned(n) ? i : artemis::wrap(i, n);
}

// Stages plane kk (wrapped) of field f [nz, ny, nx] into a ring slot at
// dst: rows -H .. TY + H - 1, columns -H .. TX + H - 1 of the footprint,
// every index wrapped.  Per row, the footprint's columns go by 16-byte
// chunks where they lie inside [0, nx) and the chunk is aligned, else
// element by element; the 2H halo columns element by element.
template <typename T, int H>
__device__ __forceinline__ void fld_stage(const FldInts& n, const T* f, T* dst, const FldPos& tp,
                                          int kk, int tid) {
  using L = FldTile<T>;
  constexpr int NV = L::TX / L::VEC, NI = NV + 2 * H;   // a row's items: chunks, halo columns
  const T* plane = f + int64_t(wrap_near(kk, n.nz)) * n.ny * n.nx;
  const bool whole = tp.x0 + L::TX <= n.nx;
  for (int e = tid; e < (L::TY + 2 * H) * NI; e += L::NT) {
    const int y = e / NI - H, q = e % NI;
    const T* row = plane + int64_t(wrap_near(tp.y0 + y, n.ny)) * n.nx;
    T* d = dst + (y + H) * L::RX + 4;
    if (q < NV) {
      const int x = q * L::VEC;
      const T* g = row + tp.x0 + x;
      if (whole && reinterpret_cast<uintptr_t>(g) % 16 == 0) {
        copy_async16(d + x, g);
      } else {
#pragma unroll
        for (int v = 0; v < L::VEC; ++v) copy_async(d + x + v, row + wrap_near(tp.x0 + x + v, n.nx));
      }
    } else {
      const int h = q - NV, x = h < H ? h - H : L::TX + h - H;
      copy_async(d + x, row + wrap_near(tp.x0 + x, n.nx));
    }
  }
}

// One block of the tiled body, phase by phase: ``ex.each(f)`` runs f(tid)
// for every thread of the block and then synchronises it (on the card each
// thread runs its own call between __syncthreads; the host build of the
// tests loops over the threads).  ``smem`` holds FldTile<T>::ELEMS
// elements.
template <typename T, class Exec>
__device__ __forceinline__ void coeffs_block(const FldParams& p, int64_t blk, T* smem, Exec& ex) {
  using L = FldTile<T>;
  const FldInts& n = p.n;
  const FldMem<T> m(smem);
  const FldPos tp = fld_pos<T>(n, blk);
  const T* E = static_cast<const T*>(p.E);
  const T* chi = static_cast<const T*>(p.chi);
  const auto se = [&](int kk) { return (kk - tp.z0 + 2) & (L::NE - 1); };
  const auto sc = [&](int kk) { return (kk - tp.z0 + 1) & (L::NC - 1); };
  const auto sd = [&](int kk) { return (kk - tp.z0 + 1) & (L::ND - 1); };
  const auto stage_e = [&](int kk, int tid) {
    fld_stage<T, 2>(n, E, m.e + se(kk) * L::EPL, tp, kk, tid);
  };
  // the copy stage ``k`` commits: E plane k + 2 + AHEAD and chi plane
  // k + 1 + AHEAD, as far as the chunk reads them (E to z1 + 1, chi to z1);
  // committed even when empty, so the waits count stages
  const auto prefetch = [&](int k, int tid) {
    if (k + 2 + L::AHEAD <= tp.z1 + 1) stage_e(k + 2 + L::AHEAD, tid);
    const int kc = k + 1 + L::AHEAD;
    if (kc <= tp.z1) fld_stage<T, 1>(n, chi, m.x + sc(kc) * L::CPL, tp, kc, tid);
    copy_commit();
  };
  // Dcell of plane kk over the footprint and its ring, from E planes
  // kk - 1 .. kk + 1 and chi plane kk
  const auto dplane = [&](int kk, int tid) {
    const int s0 = se(kk), sm = se(kk - 1), sp = se(kk + 1), c = sc(kk), o = sd(kk);
    for (int e = tid; e < L::DPL; e += L::NT) {
      const int y = e / L::DX - 1, x = e % L::DX - 1;
      m.D(o, y, x) = dcell_of(p.r, m.E(s0, y, x + 1), m.E(s0, y, x - 1), m.E(s0, y + 1, x),
                              m.E(s0, y - 1, x), m.E(sp, y, x), m.E(sm, y, x), m.E(s0, y, x),
                              m.X(c, y, x));
    }
  };
  // the outputs of the thread's cell of plane k
  const auto outputs = [&](int k, int tid, T dt) {
    const int tx = tid % L::TX, ty = tid / L::TX, i = tp.x0 + tx, j = tp.y0 + ty;
    if (i >= n.nx || j >= n.ny) return;
    const int s0 = sd(k), sm = sd(k - 1), sp = sd(k + 1);
    const T Dp[3] = {m.D(s0, ty, tx + 1), m.D(s0, ty + 1, tx), m.D(sp, ty, tx)};
    const T Dm[3] = {m.D(s0, ty, tx - 1), m.D(s0, ty - 1, tx), m.D(sm, ty, tx)};
    const int pos[3] = {i, j, k};
    coeffs_store(p, dt, (int64_t(k) * n.ny + j) * n.nx + i, pos, m.D(s0, ty, tx), Dp, Dm);
  };

  // prologue: E planes z0 - 2 .. z0 + 1 and chi z0 - 1, z0, then the copy
  // stages z0 - AHEAD .. z0 - 1; Dcell of planes z0 - 1 and z0
  ex.each([&](int tid) {
    for (int kk = tp.z0 - 2; kk <= tp.z0 + 1; ++kk) stage_e(kk, tid);
    for (int kk = tp.z0 - 1; kk <= tp.z0; ++kk)
      fld_stage<T, 1>(n, chi, m.x + sc(kk) * L::CPL, tp, kk, tid);
    copy_commit();
    for (int k = tp.z0 - L::AHEAD; k < tp.z0; ++k) prefetch(k, tid);
    copy_wait<L::AHEAD>();
  });
  ex.each([&](int tid) {
    dplane(tp.z0 - 1, tid);
    dplane(tp.z0, tid);
    copy_wait<L::AHEAD - 1>();
  });
  // one phase per plane k: the cells of plane k - 1 (from Dcell planes
  // k - 2 .. k), the copy stage k, and Dcell of plane k + 1 into the slot
  // of plane k - 3
  const T dt = static_cast<const T*>(p.dt)[0];
  for (int k = tp.z0; k < tp.z1; ++k)
    ex.each([&](int tid) {
      if (k > tp.z0) outputs(k - 1, tid, dt);
      prefetch(k, tid);
      dplane(k + 1, tid);
      copy_wait<L::AHEAD - 1>();
    });
  ex.each([&](int tid) { outputs(tp.z1 - 1, tid, dt); });
}

// The parameters of node ``node`` of a node-axis launch: every field
// pointer moved to that node's fields (A, six fields a node, as fld_coeffs'
// output and as fld_matvec's input), the one-node launch's parameters.
template <typename T, bool COEFFS>
__device__ __forceinline__ FldParams node_params(const FldParams& p, int node) {
  const int64_t off = int64_t(p.n.nx) * p.n.ny * p.n.nz * node;
  FldParams q = p;
  q.E = static_cast<const T*>(p.E) + off;
  if (COEFFS) {
    q.chi = static_cast<const T*>(p.chi) + off;
    q.out0 = static_cast<T*>(p.out0) + 6 * off;
    q.out1 = static_cast<T*>(p.out1) + off;
    q.out2 = static_cast<T*>(p.out2) + off;
  } else {
    q.chi = static_cast<const T*>(p.chi) + 6 * off;
    q.diag = static_cast<const T*>(p.diag) + off;
    q.sf = static_cast<const T*>(p.sf) + off;
    q.out0 = static_cast<T*>(p.out0) + off;
  }
  return q;
}

// fld_matvec at one cell.
template <typename T>
__device__ __forceinline__ void matvec_cell(const FldParams& p, int64_t cell) {
  const FldInts& n = p.n;
  const T* E = static_cast<const T*>(p.E);
  const T* A = static_cast<const T*>(p.chi);
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const Cell c = cell_of(n, cell);
  T out = (static_cast<const T*>(p.diag)[cell] + static_cast<const T*>(p.sf)[cell]) * E[cell];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const Cell a = step(n, c, d, 1), b = step(n, c, d, -1);
    out = out - A[(2 * d + 1) * ncell + cell] * E[at(n, a.k, a.j, a.i)] -
          A[(2 * d) * ncell + cell] * E[at(n, b.k, b.j, b.i)];
  }
  static_cast<T*>(p.out0)[cell] = out;
}

// ---- CUDA-only below: the kernels, their launch and the C entry points.
// Everything above also compiles as host C++: tests/test_torch_radiation.py
// builds it with g++ behind a few macros, loops the per-cell functions over
// the cells (or coeffs_block over the blocks, phase by phase) and holds the
// result against the plain versions on the CPU.

constexpr int kBlock = 256;

// One thread per cell of node blockIdx.y.
template <typename T, bool COEFFS>
__global__ void __launch_bounds__(kBlock) fld_kernel(const __grid_constant__ FldParams p) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const FldParams q = node_params<T, COEFFS>(p, int(blockIdx.y));
  if (COEFFS)
    coeffs_cell<T>(q, cell);
  else
    matvec_cell<T>(q, cell);
}

template <bool COEFFS>
int launch(int dtype, const FldParams& p, void* stream) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const dim3 grid(unsigned((n + kBlock - 1) / kBlock), unsigned(p.n.nn));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fld_kernel<float, COEFFS><<<grid, kBlock, 0, s>>>(p);
  else if (dtype == 1)
    fld_kernel<double, COEFFS><<<grid, kBlock, 0, s>>>(p);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// The tiled body: one block per footprint and z chunk of node blockIdx.y.
struct DeviceExec {
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(int(threadIdx.x));
    __syncthreads();
  }
};

template <typename T>
__global__ void __launch_bounds__(FldTile<T>::NT, FldTile<T>::MINB)
coeffs_tiled_kernel(const __grid_constant__ FldParams p) {
  extern __shared__ __align__(16) unsigned char fld_smem[];
  DeviceExec ex;
  coeffs_block<T>(node_params<T, true>(p, int(blockIdx.y)), int64_t(blockIdx.x),
                  reinterpret_cast<T*>(fld_smem), ex);
}

template <typename T>
int launch_tiled_t(const FldParams& p, cudaStream_t s) {
  // above 48 KB (f64) a block's dynamic shared memory is asked for, once;
  // the carveout leaves room for several blocks on an SM
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(coeffs_tiled_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FldTile<T>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(coeffs_tiled_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
    return e;
  }();
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(unsigned(fld_tiles<T>(p.n)), unsigned(p.n.nn));
  coeffs_tiled_kernel<T><<<grid, FldTile<T>::NT, FldTile<T>::BYTES, s>>>(p);
  return int(cudaGetLastError());
}

int launch_tiled(int dtype, const FldParams& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tiled_t<float>(p, s);
  if (dtype == 1) return launch_tiled_t<double>(p, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 float64.  tiled: 1 the tiled body of fld_coeffs, 0
// its per-cell body.  ints/reals: FldInts/FldReals, led by their counts
// (ints' nn: the nodes on the fields' leading axis, at most 65535).
// Returns a cudaError_t (0 on success).
extern "C" int artemis_fld_coeffs(int dtype, int tiled, const int* ints, const double* reals,
                                  const void* E, const void* chi, const void* dt,
                                  void* A, void* diag, void* dcell, void* stream) {
  FldParams p;
  if (!make_params(ints, reals, &p)) return int(cudaErrorInvalidValue);
  p.E = E;
  p.chi = chi;
  p.dt = dt;
  p.diag = p.sf = nullptr;
  p.out0 = A;
  p.out1 = diag;
  p.out2 = dcell;
  return tiled ? launch_tiled(dtype, p, stream) : launch<true>(dtype, p, stream);
}

extern "C" int artemis_fld_matvec(int dtype, const int* ints, const double* reals,
                                  const void* E, const void* A, const void* diag,
                                  const void* sf, void* out, void* stream) {
  FldParams p;
  if (!make_params(ints, reals, &p)) return int(cudaErrorInvalidValue);
  p.E = E;
  p.chi = A;
  p.dt = nullptr;
  p.diag = diag;
  p.sf = sf;
  p.out0 = out;
  p.out1 = p.out2 = nullptr;
  return launch<false>(dtype, p, stream);
}
