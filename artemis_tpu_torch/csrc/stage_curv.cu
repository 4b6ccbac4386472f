// Fused curvilinear gas-hydro RK stage for Hopper (sm_90a).
//
// What it replaces: four TPU Pallas kernels of
// artemis_tpu/ops/pallas_stage_curv.py,
//   stage_curv_gather -> _stage_kernel_curv_gather (:1525, :1405): halos
//                        gathered from the unpadded interior, x3 wrapped by
//                        index, x1/x2 ghosts from ic strips  (GATHER=true)
//   stage_curv        -> _stage_kernel_curv        (:1647, :604): halos
//                        read from ghost-padded primitives   (GATHER=false)
//   _stage_curv_gather6_v1 -> _stage_kernel_curv_gather6  (:1998, :1783)
//   _stage_curv_gather6_v2 -> _stage_kernel_curv_gather6b (:2106, :1867):
//                        all six faces from strips (GATHER=true with the
//                        x3 strips given: the all-ic Cartesian disk of the
//                        radiation-hydro configuration, with or without
//                        diffusion)
//   stage_curv_gather6_batched -> _stage_kernel_curv_gather6n (:2303, :2209):
//                        K5b for N same-shape mesh-refinement nodes in one
//                        launch (the node axis, gridDim.y, over a per-node
//                        pointer table; each node's arrays are read where
//                        they lie, nothing is stacked, so a launch moves
//                        only its nodes' own compulsory bytes, without the
//                        TPU path's stacked copies of w, u0 and u1)
// All compute the body _curv_body (:631-1402), with _plm_g (:518) and the
// shared _hllc/_hlle/rk_blend (stage_common.cuh); every stage, full (K3,
// K4, K5a, K5b and K6) or partial (K4's partial mode), through the tiled
// body below.  On the TPU the
// frontends exist because of how Mosaic's DMAs fetch a halo; here a thread
// reads its halo by index, so one kernel templated on the halo source
// covers them (the x3 strips are a runtime switch of the gather variant,
// which keeps the instantiation count and the build time flat), and
// FULL=false is K4's partial mode.
//
// What it computes, per interior cell: PLM_G (Mignone limiter on x1-/x2-
// dependent axes, the uniform limiter elsewhere) or PCM face states, HLLC
// or HLLE fluxes with momentum fluxes scaled by the separable face scale
// factors; the two-register update gam0*u0 + gam1*u1 + bdt*divF with exact
// area/volume factors (u0 unread when gam0 == 0); pressure-gradient and
// PdV sources; connection sources with the rotation velocity; the
// rotating-frame torque and centrifugal work; point gravity (modes sph,
// cart, xyz, with a host 0/1 factor for the tstart/tstop window); the
// viscous stress and conduction with their connection terms and heating
// (four coefficient models, arithmetic or harmonic face averages).  FULL:
// the dual-energy sync, C2P/P2C with scale factors and floors, and the
// per-block maximum of the CFL denominator with the diffusive limit folded
// in (dtden).  Partial: only the conserved state after the flux sources.
// All geometry enters as per-axis coefficient rows (CurvCoeffs.pack: CX
// [k, n1+2g], CY, CZ), read through an index struct.
//
// What bounds it on the H100: compulsory HBM traffic per zone-stage is w
// (6 fields), u0 and u1 (6 each, u0 skipped when gam0 == 0) in, u and w
// (6 each) out: 24-30 fields, 96-120 B in f32.  At 256x64x64 that is
// 101-126 MB, 30-38 us at 3.35 TB/s.  The arithmetic per cell is several
// thousand floating-point operations on the disk configuration (counted in
// chip_smoke.py, which states the bound it prints): 2 x ndim Riemann
// solves, 2 x ndim viscous face stresses each needing the velocity
// divergence, contravariant velocities, transverse gradients and the
// viscosity model at two cells, plus some 60 divisions and square roots.
//
// Two bodies.  The tiled body (stage_tiled_kernel<T, DIFF, FULL>) runs
// every launch on a ghost width of two: K3 (x1/x2 strips, x3 wrapped) and
// K5a (six strips) with the viscous stencil, K5b without it, K6 as K5b's
// node axis, and K4 (a padded array: disk_cyl, disk_axi) with or without
// it, full or partial (FULL = false: the alpha_disk, binary_cyl and N-body
// decks, 2-D cylindrical f64).  The per-cell body (stage_curv_kernel, one
// thread per cell in flat 128-thread blocks) is reached only through the
// wrapper's measurement switch: each thread recomputes every face it
// touches, so each face (hydro and viscous) is solved twice, identically,
// by the two threads that share it, the viscous stress re-derives each
// cell quantity for every face that needs it, and every stencil read of a
// gather variant makes up to four range tests to pick its strip; stencil
// and coefficient-row loads go through L1/L2.
//
// The tiled body: a block owns a TX x TY footprint of columns (32 x 8; 32
// x 4 for f64 without diffusion) and marches up a chunk of TZ planes of one
// node.  Each plane of primitives, with its x/y halo of two, is staged once
// into a ring of kRing planes in shared memory, every element read from
// the interior or from exactly one strip (the precedence of Ctx::src; with
// x3 wrapped, a plane past either end is another plane of the interior),
// by cp.async while the planes below are computed: a footprint row is one
// contiguous run of its source, copied 16 bytes at a time past L1 where
// aligned, the halo columns 4 or 8 bytes.  From a padded array (K4) a
// footprint row with its x halo is one run, placed in shared memory at the
// array's 16-byte phase and copied 16 bytes at a time too; the halo source
// is a runtime switch of the staging alone (one instantiation per dtype
// and body, as before).  Without diffusion, in f32, the
// registers u0, u1 of the plane are staged the same way, so the update
// waits on no device-memory load.  Each cell's face values are
// reconstructed once per axis, each x and y face is solved once into shared
// memory (fluxes, face pressure and velocity), and each z face once by its
// column's thread, carried in registers to the next plane; the update,
// sources, C2P/P2C and CFL denominator (flux_update, cell_finish) are the
// per-cell body's own code.  Two barriers per plane: the faces (B), then
// the cells and the next plane's face values (C).  The ring holds four
// planes, not the five the z stencil spans: the upper z face value of the
// plane below is carried in registers, so plane k reads planes k..k+2
// while k+3 lands.
//
// With diffusion (the DIFF instantiation) the viscous stencil rides the
// same planes.  The ring also holds the four 1-wide xy corners, whose v1
// and v2 the stress reads.  Each cell quantity is made once per plane into
// shared memory (QCell: the contravariant velocities, the coefficients of
// viscosity and conduction, the velocity divergence, the x3 gradients of
// v^1 and v^2) over cells -1..TX x -1..TY; the x and y diffusive faces are
// solved once beside the hydro ones in B (rows m1, m2, m3, energy), and
// the z one once per column in C, from the column's cell of plane k in
// QCell and of plane k + 1 made there, whose rows then replace k's (the
// rim's are made by the block), with the face below carried in registers.
// Its reach is the hydro z face's, planes k..k+2, so the ring keeps four
// planes.  The diffusive update (diff_update, diff_den) is the per-cell
// body's own code too; its f32 variant spends the room of u0, u1 on QCell
// and the diffusive faces (114,592 B a block, two per SM), its f64 one
// holds one block per SM.  What bounds the tiled body is latency, not
// bytes or operations: at 128 registers per thread two 256-thread blocks
// fill an SM's register file (16 warps), and each plane's solves and
// update are long chains of IEEE divisions and roots (PERF.md has the
// measured split).  The stage has no matrix product, so the tensor cores
// (wgmma) have nothing to do.
//
// K4's partial mode (FULL = false) is the same body: it writes u alone
// (cell_finish) and makes neither the diffusive CFL limit nor the dtden
// maximum.  Its decks run 2-D f64 nodes (alpha_disk 512 x 1024, binary_cyl
// and the N-body decks 96-128 x 192-256).  ptxas -v on the H100 build: the
// f64 diffusive partial instantiation takes 231 registers without spills
// and 229,184 B of shared memory a block, so registers and shared memory
// both cap an SM at one 256-thread block (8 warps, as the per-cell body's
// two 128-thread blocks at 194); the inviscid one 186 registers and
// 111,616 B, two 128-thread blocks.  A 2-D node keeps the 3-D layout: a
// ring sized for its one plane (160 KB at 32 x 8; at 32 x 4, 91,200 B and
// two blocks per SM) ran within 3% of it, and three 32 x 4 blocks an SM
// (168 registers, with spills) 5% slower (tools/tile_probe.py partial*,
// PERF.md): at ~230 registers the register file holds 8 warps whatever
// the footprint, and the body is latency-bound on its chains of f64
// divisions and roots.  Each dtype and mode (-DARTEMIS_CURV_DTYPE,
// -DARTEMIS_CURV_FULL) is a library of its own, built by its own nvcc run
// in parallel with the others.
//
// Built with -fmad=false (_build.SOURCE_FLAGS): the GATHER, padded and
// tiled kernels are compiled separately, and with multiply-add contraction
// each may fuse different products, parting in the last bit; without it
// they make the same IEEE operations and agree bitwise on the disk layout.
//
// Binding: a plain C entry point (artemis_stage_curv) called through
// ctypes with three packed arrays (ints, reals, pointers: dt, then one row
// per node) whose layout is checked by the ints' and reals' leading counts,
// the node count and the pointer count.  It launches on the caller's stream,
// reads dt from device memory (bdt = beta * dt[0] is formed here),
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "stage_common.cuh"

namespace {

using namespace artemis;

// Row indices into CX / CY / CZ (-1: the row does not exist), in the order
// of ops/stage_curv.py's _flat_ix.
struct CurvIdx {
  // x rows
  int recon1[4], upd1_face, upd1_facep, upd1_iv, idx1;
  int upd_t1[3];            // upd{d}_t1, d = 1..3
  int fh_1[3][3];           // fh{d}_1[c]
  int hv_1[3], conn1[3], vrot_1[3], invw_1[3];
  int rfw_lo_1[3][2], rfw_hi_1[3][2];
  int phihat_1[3], rhat_1[3], zhat_1[3];
  int rcyl_1, zc_1, gx_1;
  int d1_1[3], d2_1[3];     // neighbour-distance rows along d = 1..3
  // y rows
  int recon2[4], upd2_face, upd2_facep, upd2_iv, idx2;
  int upd_t2[3];            // upd{d}_t2, d = 1, 3
  int fh_2[3][3];
  int hv_2[3], conn2, vrot_2[3], invw_2[3];
  int rfw_lo_2[3][2], rfw_hi_2[3][2];
  int phihat_2[3], rhat_2[3], zhat_2[3];
  int rcyl_2, zc_2, gy_2;
  int d1_2[3], d2_2[3];
  // z rows
  int recon3[4], upd3_face, upd3_facep, upd3_iv, idx3;
  int upd_t3[3];            // upd{d}_t3, d = 1, 2
  int inv_dx3, zc_3, gz_3;
  int d1_3[3], d2_3[3];
};

// diffusion coefficient models (mu_model in _curv_body)
constexpr int kViscPlaw = 0;
constexpr int kViscAlpha = 1;
constexpr int kCondPlaw = 2;
constexpr int kThermalDiff = 3;

struct CurvInts {
  int count;                // sizeof(CurvInts) / sizeof(int), from the caller
  int nx, ny, nz, g1, g2, g3;
  int n1p, n2p, n3p;        // coefficient row lengths
  int pcm, hlle, x1dep, x2dep, has_rot;
  int grav;                 // -1 none, 0 sph, 1 cart, 2 xyz
  int visc, visc_harm;      // visc: -1 none, kViscPlaw, kViscAlpha
  int cond, cond_harm;      // cond: -1 none, kCondPlaw, kThermalDiff
  CurvIdx ix;
};

struct CurvReals {
  double count;             // sizeof(CurvReals) / sizeof(double)
  double gam0, gam1, beta;
  double gamma, cv, dfloor, siefloor, de_switch;
  double rf_omega;
  double gm, soft2, gpos[3], gfac;
  // visc: plaw (nu_s, eta, r_exp, 1/R0); alpha (alpha*gamma*(gamma-1), eta,
  // 1/R0^2, 1/Omega0).  cond: (coef, -, temp_exp, rho_exp, 1/T0, 1/d0)
  double visc_p[6], cond_p[6];
  double tiny;
};

// One node's tensors: a launch advances up to kMaxNodes nodes of one grid
// shape (the TPU's node-batched K6), each read and written where it lies.
struct NodePtrs {
  const void* w;            // GATHER: [6, nz, ny, nx]; else [6, nz+2g3, ny+2g2, nx+2g1]
  const void* u0;           // [6, nz, ny, nx] (unused when gam0 == 0)
  const void* u1;           // [6, nz, ny, nx] (unused when gam1 == 0)
  void* u_out;              // [6, nz, ny, nx]
  void* w_out;              // [6, nz, ny, nx] (FULL only)
  void* dmax;               // [gridDim.x] (FULL only)
  const void* cx;           // [*, n1p]
  const void* cy;           // [*, n2p]
  const void* cz;           // [*, n3p]
  const void* sx_lo;        // GATHER: [6, nz+2g3, ny+2g2, g1]
  const void* sx_hi;
  const void* sy_lo;        // GATHER: [6, nz+2g3, g2, nx]
  const void* sy_hi;
  const void* sz_lo;        // GATHER six-face: [6, g3, ny, nx]; null: x3 wrapped
  const void* sz_hi;
};

constexpr int kMaxNodes = 16;
constexpr int kNodePtrs = int(sizeof(NodePtrs) / sizeof(void*));

// The shared scalars once, then the node table (gridDim.y entries used);
// about 3 KB, inside the 4 KB a kernel parameter may take.
struct CurvParams {
  CurvInts n;
  CurvReals r;
  const void* dt;           // one element, shared by the nodes
  int nnodes;
  int halo;                 // the halo source (kPadded, kGather, kGather6)
  NodePtrs node[kMaxNodes];
};

// halo sources (the entry point's ``halo`` argument)
constexpr int kPadded = 0;
constexpr int kGather = 1;    // x1/x2 strips, x3 wrapped
constexpr int kGather6 = 2;   // x1/x2/x3 strips

// Unpacks the caller's arrays (ptrs: dt, then kNodePtrs pointers per node
// in NodePtrs order); false when their layout differs from this build's,
// the node count is out of range, or a node's x3 strips disagree with the
// halo source (a 2-D six-face node, nz = 1, has empty x3 strips: no z
// face reads them).
inline bool make_params(int halo, const int* ints, const double* reals,
                        const void* const* ptrs, int nptrs, int nnodes, CurvParams* p) {
  if (ints[0] != int(sizeof(CurvInts) / sizeof(int)) ||
      reals[0] != double(sizeof(CurvReals) / sizeof(double)) || nnodes < 1 ||
      nnodes > kMaxNodes || nptrs != 1 + kNodePtrs * nnodes)
    return false;
  memset(p, 0, sizeof(CurvParams));
  memcpy(&p->n, ints, sizeof(CurvInts));
  memcpy(&p->r, reals, sizeof(CurvReals));
  p->dt = ptrs[0];
  p->nnodes = nnodes;
  p->halo = halo;
  for (int k = 0; k < nnodes; ++k) {
    memcpy(&p->node[k], ptrs + 1 + kNodePtrs * k, sizeof(NodePtrs));
    const NodePtrs& nd = p->node[k];
    const bool sz = nd.sz_lo != nullptr && nd.sz_hi != nullptr;
    if (halo == kGather6 ? !sz && p->n.nz > 1 : nd.sz_lo != nullptr || nd.sz_hi != nullptr)
      return false;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T sq(T a) { return a * a; }

// Everything one thread reads: primitives at interior-relative (k, j, i),
// halo included, and the coefficient rows at padded indices (I, J, K).
template <typename T, bool GATHER>
struct Ctx {
  const CurvInts& n;
  const CurvReals& r;
  const CurvIdx& ix;
  const NodePtrs& nd;

  __device__ __forceinline__ Ctx(const CurvParams& p, const NodePtrs& node)
      : n(p.n), r(p.r), ix(p.n.ix), nd(node) {}

  // The node's arrays are read from its row of the parameter table where
  // they are used.  Copied into members up front, the ten pointers of a row
  // picked by blockIdx.y held 20 more registers through the whole stage (148
  // in the f32 six-face kernel, three blocks per SM instead of four) and the
  // gather variants ran 26-29% slower on the H100; read in place, they stay
  // at 128 registers without spills.
  __device__ __forceinline__ static const T* at(const void* q) {
    return static_cast<const T*>(q);
  }

  // Where primitive c at (k, j, i) lies.  GATHER sources every halo cell as
  // stage_curv_gather and _stage_kernel_curv_gather6 assemble their slabs,
  // by precedence x1 strip > x2 strip > x3 strip > interior: x1 ghosts (any
  // y, z) from the x1 strips over the padded y and z extents; x2 ghosts
  // (interior x, any z) from the x2 strips over the padded z extent; x3
  // ghosts (interior x and y) from the x3 strips when they are given, else
  // from the interior with x3 wrapped (nz >= g3).  Corners read by the
  // viscous stencil thus come from the higher-precedence strip; the ic
  // caches the strips are cut from agree wherever two of them overlap.
  // The tiled body reads each element once through src, the per-cell body
  // every stencil element through W.
  __device__ __forceinline__ const T* src(int c, int k, int j, int i) const {
    const int nx = n.nx, ny = n.ny, nz = n.nz;
    if (GATHER) {
      const int64_t zp = nz + 2 * n.g3, yp = ny + 2 * n.g2;
      if (i < 0 || i >= nx) {
        const T* s = at(i < 0 ? nd.sx_lo : nd.sx_hi);
        const int ii = i < 0 ? i + n.g1 : i - nx;
        return s + ((c * zp + (k + n.g3)) * yp + (j + n.g2)) * n.g1 + ii;
      }
      if (j < 0 || j >= ny) {
        const T* s = at(j < 0 ? nd.sy_lo : nd.sy_hi);
        const int jj = j < 0 ? j + n.g2 : j - ny;
        return s + ((c * zp + (k + n.g3)) * n.g2 + jj) * nx + i;
      }
      if (k < 0 || k >= nz) {
        if (nd.sz_lo != nullptr) {
          const T* s = at(k < 0 ? nd.sz_lo : nd.sz_hi);
          const int kk = k < 0 ? k + n.g3 : k - nz;
          return s + ((int64_t(c) * n.g3 + kk) * ny + j) * nx + i;
        }
        k = k < 0 ? k + nz : k - nz;
      }
      return at(nd.w) + ((int64_t(c) * nz + k) * ny + j) * nx + i;
    }
    const int64_t xp = nx + 2 * n.g1, yp = ny + 2 * n.g2, zp = nz + 2 * n.g3;
    return at(nd.w) + ((c * zp + (k + n.g3)) * yp + (j + n.g2)) * xp + (i + n.g1);
  }
  __device__ __forceinline__ T W(int c, int k, int j, int i) const { return *src(c, k, j, i); }

  __device__ __forceinline__ T X(int row, int I) const {
    return at(nd.cx)[int64_t(row) * n.n1p + I];
  }
  __device__ __forceinline__ T Y(int row, int J) const {
    return at(nd.cy)[int64_t(row) * n.n2p + J];
  }
  __device__ __forceinline__ T Z(int row, int K) const {
    return at(nd.cz)[int64_t(row) * n.n3p + K];
  }

  // 1/h_c at the cell, from row-level reciprocals
  __device__ __forceinline__ T inv_h(int c, int I, int J) const {
    return (T(1) / X(ix.hv_1[c], I)) * (T(1) / Y(ix.hv_2[c], J));
  }
  // contravariant velocity v^c = v_c / h_c
  __device__ __forceinline__ T vcon(int c, int k, int j, int i) const {
    return W(1 + c, k, j, i) * inv_h(c, i + n.g1, j + n.g2);
  }
  // reciprocal neighbour distance (rows d1 or d2 along d), clamped at 1/tiny
  __device__ __forceinline__ T inv_dist(const int (&r1)[3], const int (&r2)[3],
                                        const int (&r3)[3], int d, int k,
                                        int j, int i) const {
    const T v = (T(1) / X(r1[d - 1], i + n.g1)) * (T(1) / Y(r2[d - 1], j + n.g2)) *
                (T(1) / Z(r3[d - 1], k + n.g3));
    return vmin(v, T(1.0 / r.tiny));
  }
};

// ---------------------------------------------------------------------------
// hydro fluxes
// ---------------------------------------------------------------------------

// Mignone PLM face values of the centre cell of (qm, q0, qp): ql on its
// upper face, qr on its lower face (_plm_g).  g = (rl, rr, cl, cr, fl, fr)
// are the cell's coordinate ratios.
template <typename T>
__device__ __forceinline__ void plm_g(T qm, T q0, T qp, const T (&g)[6], T& ql,
                                      T& qr) {
  const T dql = (q0 - qm) * g[0];
  const T dqr = (qp - q0) * g[1];
  const T dq2 = dql * dqr;
  const T denom = dql * dql + dqr * dqr + dq2 * (g[2] + g[3] - T(2));
  const T dqm = dq2 > T(0) ? dq2 * (g[3] * dql + g[2] * dqr) / denom : T(0);
  ql = q0 + dqm * g[4];
  qr = q0 - dqm * g[5];
}

template <typename T, bool GATHER>
__device__ __forceinline__ void plm_g_ratios(const Ctx<T, GATHER>& C, const int (&rec)[4],
                                             bool on_x, int P, T (&g)[6]) {
  auto row = [&](int q, int at) { return on_x ? C.X(rec[q], at) : C.Y(rec[q], at); };
  const T xvm = row(0, P - 1), xv0 = row(0, P), xvp = row(0, P + 1);
  const T xlo0 = row(1, P), xhi0 = row(2, P), dx0 = row(3, P);
  g[0] = dx0 / (xv0 - xvm);
  g[1] = dx0 / (xvp - xv0);
  g[2] = (xv0 - xvm) / (xv0 - xlo0);
  g[3] = (xvp - xv0) / (xhi0 - xv0);
  g[4] = (xhi0 - xv0) / dx0;
  g[5] = (xv0 - xlo0) / dx0;
}

// A cell's upper (up) and lower (lo) face values along an axis from its
// neighbours there (q0 the cell, g its ratios for the Mignone limiter), in
// axis_flux's operations.  (axis_flux keeps its own copy: routed through
// this function and solve_face, the per-cell kernels compiled slower.)
template <typename T>
__device__ __forceinline__ void face_values(bool pcm, bool mignone, T qm, T q0, T qp,
                                            const T (&g)[6], T& up, T& lo) {
  if (pcm) {
    up = q0;
    lo = q0;
  } else if (mignone) {
    plm_g(qm, q0, qp, g, up, lo);
  } else {
    const T s = plm_slope(qm, q0, qp);
    up = q0 + s;
    lo = q0 - s;
  }
}

// Solves the face along D between states wl and wr into q[0..7] (6 fluxes,
// momentum scaled by the face scale factors at padded (I, J), pressure,
// velocity), in axis_flux's operations.
template <typename T, bool GATHER, int D>
__device__ __forceinline__ void solve_face(const Ctx<T, GATHER>& C, const T (&wl)[6],
                                           const T (&wr)[6], int I, int J, T (&q)[8]) {
  T F[6];
  if (C.n.hlle)
    hlle<T, D>(wl, wr, C.r.gamma, F, q[6], q[7]);
  else
    hllc<T, D>(wl, wr, C.r.gamma, F, q[6], q[7]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    F[1 + c] = F[1 + c] * (C.X(C.ix.fh_1[D - 1][c], I) * C.Y(C.ix.fh_2[D - 1][c], J));
#pragma unroll
  for (int c = 0; c < 6; ++c) q[c] = F[c];
}

// Fluxes through the lower (F[0]) and upper (F[1]) faces of the cell along
// D, momentum fluxes scaled by the face scale factors, with the face
// pressures and velocities.
template <typename T, bool GATHER, int D>
__device__ __forceinline__ void axis_flux(const Ctx<T, GATHER>& C, int k, int j, int i,
                                          T (&F)[2][6], T (&pf)[2], T (&vf)[2]) {
  const CurvInts& n = C.n;
  constexpr int di = D == 1, dj = D == 2, dk = D == 3;
  const int I = i + n.g1, J = j + n.g2;
  const bool mignone = !n.pcm && ((D == 1 && n.x1dep) || (D == 2 && n.x2dep));
  T g[3][6];
  if (mignone) {
    const int P = D == 1 ? I : J;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      plm_g_ratios(C, D == 1 ? C.ix.recon1 : C.ix.recon2, D == 1, P + m - 1, g[m]);
  }
  T wl[2][6], wr[2][6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T q[5];
#pragma unroll
    for (int o = -2; o <= 2; ++o) q[o + 2] = C.W(c, k + o * dk, j + o * dj, i + o * di);
    if (n.pcm) {
      wl[0][c] = q[1];
      wr[0][c] = q[2];
      wl[1][c] = q[2];
      wr[1][c] = q[3];
    } else if (mignone) {
      T ql[3], qr[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) plm_g(q[m], q[m + 1], q[m + 2], g[m], ql[m], qr[m]);
      wl[0][c] = ql[0];
      wr[0][c] = qr[1];
      wl[1][c] = ql[1];
      wr[1][c] = qr[2];
    } else {
      T s[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) s[m] = plm_slope(q[m], q[m + 1], q[m + 2]);
      wl[0][c] = q[1] + s[0];
      wr[0][c] = q[2] - s[1];
      wl[1][c] = q[2] + s[1];
      wr[1][c] = q[3] - s[2];
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    if (n.hlle)
      hlle<T, D>(wl[f], wr[f], C.r.gamma, F[f], pf[f], vf[f]);
    else
      hllc<T, D>(wl[f], wr[f], C.r.gamma, F[f], pf[f], vf[f]);
  }
  // ScaleMomentumFlux: h_c at the face centroid, separable rows
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int r1 = C.ix.fh_1[D - 1][c], r2 = C.ix.fh_2[D - 1][c];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const T h = C.X(r1, I + f * di) * C.Y(r2, J + f * dj);
      F[f][1 + c] = F[f][1 + c] * h;
    }
  }
}

// ---------------------------------------------------------------------------
// viscous stress and conduction (Diffusion.fluxes/update, ops/diffusion.py)
// ---------------------------------------------------------------------------

// The diffusion coefficient (mu_model) of model ``kind`` for a cell of
// density rho and specific internal energy sie at padded (I, J, K).
template <typename T, bool GATHER>
__device__ __forceinline__ T mu_of(const Ctx<T, GATHER>& C, int kind, const double (&q)[6], T rho,
                                   T sie, int I, int J, int K) {
  const CurvIdx& ix = C.ix;
  if (kind == kViscPlaw) {
    T out = T(q[0]) * rho;
    if (q[2] != 0.0) {
      const T Rc = C.X(ix.rcyl_1, I) * C.Y(ix.rcyl_2, J);
      out = out * pow(Rc * T(q[3]), T(q[2]));
    }
    return out;
  }
  if (kind == kViscAlpha) {
    const T Rc = C.X(ix.rcyl_1, I) * C.Y(ix.rcyl_2, J);
    const T zc = C.X(ix.zc_1, I) * C.Y(ix.zc_2, J) * C.Z(ix.zc_3, K);
    const T r2 = (Rc * Rc + zc * zc) * T(q[2]);
    // 1/Omega_K = (1/Om0) (r/R0)^1.5 = (1/Om0) r2 * rsqrt(sqrt(r2))
    const T iOmk = T(q[3]) * r2 * rsqrt_t(sqrt(r2));
    return T(q[0]) * rho * sie * iOmk;
  }
  const T Tg = sie * T(1.0 / C.r.cv);
  T base = T(1);
  if (q[2] != 0.0) base = base * pow(Tg * T(q[4]), T(q[2]));
  if (q[3] != 0.0) base = base * pow(rho * T(q[5]), T(q[3]));
  if (kind == kCondPlaw) return T(q[0]) * base;
  return T(q[0]) * base * rho * T(C.r.cv);
}

// The coefficient of model ``kind`` at cell (k, j, i).
template <typename T, bool GATHER>
__device__ __forceinline__ T mu_model(const Ctx<T, GATHER>& C, int kind, const double (&q)[6],
                                      int k, int j, int i) {
  return mu_of(C, kind, q, C.W(0, k, j, i), C.W(5, k, j, i), i + C.n.g1, j + C.n.g2,
               k + C.n.g3);
}

// Velocity divergence at padded (I, J, K) (jnp _divu, factored A/V):
// ``v(d, o)`` reads the velocity along axis d = 0..2 at the cell (o = 0)
// and its neighbours below (o = -1) and above (o = 1) along d, each where
// the expression needs it (the x3 ones only when nz > 1).
template <typename T, bool GATHER, class V>
__device__ __forceinline__ T div_of(const Ctx<T, GATHER>& C, int I, int J, int K, const V& v) {
  const CurvIdx& ix = C.ix;
  const T v1 = v(0, 0);
  T dv = (C.X(ix.upd1_facep, I) * (v1 + v(0, 1)) - C.X(ix.upd1_face, I) * (v1 + v(0, -1))) *
         C.X(ix.upd1_iv, I) * (C.Y(ix.upd_t2[0], J) * C.Z(ix.upd_t3[0], K));
  const T v2 = v(1, 0);
  dv = dv + (C.Y(ix.upd2_facep, J) * (v2 + v(1, 1)) - C.Y(ix.upd2_face, J) * (v2 + v(1, -1))) *
                C.Y(ix.upd2_iv, J) * (C.X(ix.upd_t1[1], I) * C.Z(ix.upd_t3[1], K));
  if (C.n.nz > 1) {
    const T v3 = v(2, 0);
    dv = dv + (C.Z(ix.upd3_facep, K) * (v3 + v(2, 1)) - C.Z(ix.upd3_face, K) * (v3 + v(2, -1))) *
                  C.Z(ix.upd3_iv, K) * (C.X(ix.upd_t1[2], I) * C.Y(ix.upd_t2[2], J));
  }
  return dv * T(0.5);
}

// Velocity divergence at cell (k, j, i).
template <typename T, bool GATHER>
__device__ __forceinline__ T divv(const Ctx<T, GATHER>& C, int k, int j, int i) {
  return div_of(C, i + C.n.g1, j + C.n.g2, k + C.n.g3, [&](int d, int o) {
    return C.W(1 + d, k + (d == 2) * o, j + (d == 1) * o, i + (d == 0) * o);
  });
}

// Diagonal connection source src_d = v^k dh_d/dx_k at padded (I, J) from the
// cell's contravariant velocity v^1 (v0) and, read where needed, v^2 (v1()).
template <typename T, bool GATHER, int D, class V1>
__device__ __forceinline__ T conn_of(const Ctx<T, GATHER>& C, T v0, const V1& v1, int I, int J) {
  if (D == 1) return T(0);
  const T s = v0 * C.X(C.ix.conn1[D - 1], I);
  if (D == 2) return s;
  return s + v1() * C.Y(C.ix.conn2, J);
}

template <typename T, bool GATHER, int D>
__device__ __forceinline__ T conn_src(const Ctx<T, GATHER>& C, int k, int j, int i) {
  if (D == 1) return T(0);
  return conn_of<T, GATHER, D>(C, C.vcon(0, k, j, i), [&] { return C.vcon(1, k, j, i); },
                               i + C.n.g1, j + C.n.g2);
}

// Transverse gradient along COMP at cell (k, j, i) from a contravariant
// velocity at the neighbours above (vp) and below (vm) along COMP.
template <typename T, bool GATHER>
__device__ __forceinline__ T tgrad(const Ctx<T, GATHER>& C, T vp, T vm, int comp, int k, int j,
                                   int i) {
  const CurvIdx& ix = C.ix;
  return (vp - vm) * C.inv_dist(ix.d2_1, ix.d2_2, ix.d2_3, comp, k, j, i);
}

// Transverse gradient of v^(D) along COMP at a cell.
template <typename T, bool GATHER, int D, int COMP>
__device__ __forceinline__ T trans_grad(const Ctx<T, GATHER>& C, int k, int j, int i) {
  constexpr int ci = COMP == 1, cj = COMP == 2, ck = COMP == 3;
  return tgrad(C, C.vcon(D - 1, k + ck, j + cj, i + ci), C.vcon(D - 1, k - ck, j - cj, i - ci),
               COMP, k, j, i);
}

template <typename T>
__device__ __forceinline__ T face_avg(bool harmonic, T lo, T hi) {
  return harmonic ? T(2) * lo * hi / (lo + hi) : T(0.5) * (lo + hi);
}

// A cell of the viscous stencil as the per-cell body sees it: each
// quantity derived from the primitives where asked for.  The tiled body
// hands visc_face its own kinds of cell (QCell, ZCell), which read the
// same quantities from where it computed them once.
template <typename T, bool GATHER, int D>
struct LazyCell {
  const Ctx<T, GATHER>& C;
  int k, j, i;
  __device__ __forceinline__ T muv() const { return mu_model(C, C.n.visc, C.r.visc_p, k, j, i); }
  __device__ __forceinline__ T muc() const { return mu_model(C, C.n.cond, C.r.cond_p, k, j, i); }
  __device__ __forceinline__ T vcon(int c) const { return C.vcon(c, k, j, i); }
  __device__ __forceinline__ T conn() const { return conn_src<T, GATHER, D>(C, k, j, i); }
  __device__ __forceinline__ T div() const { return divv(C, k, j, i); }
  template <int COMP>
  __device__ __forceinline__ T tg() const { return trans_grad<T, GATHER, D, COMP>(C, k, j, i); }
  __device__ __forceinline__ T w5() const { return C.W(5, k, j, i); }
};

// Off-diagonal stress row COMP of the viscous flux through the face along D
// whose upper cell b is (k, j, i) and lower cell a.
template <typename T, bool GATHER, int D, int COMP, class CA, class CB>
__device__ __forceinline__ T visc_offdiag(const Ctx<T, GATHER>& C, int j, int i, const CA& a,
                                          const CB& b, T i1r, T hdfmus) {
  const CurvIdx& ix = C.ix;
  const int I = i + C.n.g1, J = j + C.n.g2;
  const T t = (b.vcon(COMP - 1) - a.vcon(COMP - 1)) * i1r;
  const T ratio = sq(C.X(ix.fh_1[D - 1][COMP - 1], I) / C.X(ix.fh_1[D - 1][D - 1], I)) *
                  sq(C.Y(ix.fh_2[D - 1][COMP - 1], J) / C.Y(ix.fh_2[D - 1][D - 1], J));
  T tt = T(0);
  if (COMP != 3 || C.n.nz > 1)
    tt = T(0.5) * (b.template tg<COMP>() + a.template tg<COMP>());
  return hdfmus * (tt + ratio * t);
}

// Diffusive flux rows (m1, m2, m3, energy) through the face along D whose
// upper cell b is (k, j, i) and lower cell a: the one expression of both
// bodies.
template <typename T, bool GATHER, int D, class CA, class CB>
__device__ __forceinline__ void visc_face(const Ctx<T, GATHER>& C, int k, int j, int i,
                                          const CA& a, const CB& b, T (&F)[4]) {
  const CurvIdx& ix = C.ix;
  const int I = i + C.n.g1, J = j + C.n.g2;
  const T i1r = C.inv_dist(ix.d1_1, ix.d1_2, ix.d1_3, D, k, j, i);
  F[0] = F[1] = F[2] = F[3] = T(0);
  if (C.n.visc >= 0) {
    const T mus = face_avg(C.n.visc_harm != 0, a.muv(), b.muv());
    const T hdf = C.X(ix.fh_1[D - 1][D - 1], I) * C.Y(ix.fh_2[D - 1][D - 1], J);
    const T hdfmus = hdf * mus;
    // diagonal: 2 dv^d/dx_d + <v^k dh_d/dx_k> - (1/3)(1 - eta) div v
    const T t = T(2) * (b.vcon(D - 1) - a.vcon(D - 1)) * i1r + T(0.5) * (b.conn() + a.conn());
    const T bulk = T((1.0 / 3.0) * (1.0 - C.r.visc_p[1]));
    F[D - 1] = hdfmus * (t - bulk * (b.div() + a.div()));
    constexpr int o1 = D == 1 ? 2 : 1;
    constexpr int o2 = D == 3 ? 2 : 3;
    F[o1 - 1] = visc_offdiag<T, GATHER, D, o1>(C, j, i, a, b, i1r, hdfmus);
    F[o2 - 1] = visc_offdiag<T, GATHER, D, o2>(C, j, i, a, b, i1r, hdfmus);
    // energy: v.T with face-averaged contravariant velocities
    T fen = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) fen = fen + T(0.5) * (b.vcon(c) + a.vcon(c)) * F[c];
    F[3] = fen;
  }
  if (C.n.cond >= 0) {
    const T kc = face_avg(C.n.cond_harm != 0, a.muc(), b.muc());
    const T icv = T(1.0 / C.r.cv);
    F[3] = F[3] + kc * (b.w5() * icv - a.w5() * icv) * i1r;
  }
}

// The per-cell body's face along D whose upper cell is (k, j, i).  Not
// inlined: each thread calls it twice per direction, and one body per
// direction keeps the build short.
template <typename T, bool GATHER, int D>
__device__ __noinline__ void diff_face(const Ctx<T, GATHER>& C, int k, int j, int i,
                                       T (&F)[4]) {
  const LazyCell<T, GATHER, D> a{C, k - (D == 3), j - (D == 2), i - (D == 1)}, b{C, k, j, i};
  visc_face<T, GATHER, D>(C, k, j, i, a, b, F);
}

// ---------------------------------------------------------------------------
// the whole stage for one cell
// ---------------------------------------------------------------------------

// The fluxes of one cell's six faces, momentum fluxes scaled, with the face
// pressures and velocities (the per-cell body's, in registers).
template <typename T>
struct CellFluxes {
  T F[3][2][6], P[3][2], V[3][2];
  __device__ __forceinline__ T f(int d, int s, int c) const { return F[d][s][c]; }
  __device__ __forceinline__ T pf(int d, int s) const { return P[d][s]; }
  __device__ __forceinline__ T vf(int d, int s) const { return V[d][s]; }
};

// A cell's lower/upper face areas and A/V factors per axis, and beta * dt.
template <typename T>
struct CellGeom {
  T af1, af1p, c1, af2, af2p, c2, af3, af3p, c3, bdt;
};

// The update of interior cell (k, j, i) (flat index ``cell``) through its
// folded sources: u = gam0 u0 + gam1 u1 + bdt divF, the pressure-gradient
// and PdV, connection, rotating-frame and point-gravity terms.  ``fl``
// gives the cell's face fluxes (f, pf, vf of axis d = 0..2, side s = 0
// lower, 1 upper), ``wc(c)`` its own primitive c, and the registers hold
// its field c at u0[c * us + uo], u1[c * us + uo] (read where gam0, gam1 !=
// 0).
template <typename T, bool GATHER, class Fl, class Wc>
__device__ __forceinline__ void flux_update(const Ctx<T, GATHER>& C, const CurvParams& p, int k,
                                            int j, int i, const Fl& fl, const Wc& wc,
                                            const T* u0, const T* u1, int64_t us, int64_t uo,
                                            T (&u)[6], CellGeom<T>& gm) {
  const CurvInts& n = p.n;
  const CurvReals& r = p.r;
  const CurvIdx& ix = n.ix;
  const bool az = n.nz > 1;
  const int I = i + n.g1, J = j + n.g2, K = k + n.g3;
  const T half = T(0.5);

  // ---- update: divF with exact A/V factors
  const T af1 = C.X(ix.upd1_face, I), af1p = C.X(ix.upd1_facep, I);
  const T c1 = C.X(ix.upd1_iv, I) * C.Y(ix.upd_t2[0], J) * C.Z(ix.upd_t3[0], K);
  const T af2 = C.Y(ix.upd2_face, J), af2p = C.Y(ix.upd2_facep, J);
  const T c2 = C.Y(ix.upd2_iv, J) * C.X(ix.upd_t1[1], I) * C.Z(ix.upd_t3[1], K);
  T af3 = T(0), af3p = T(0), c3 = T(0);
  if (az) {
    af3 = C.Z(ix.upd3_face, K);
    af3p = C.Z(ix.upd3_facep, K);
    c3 = C.Z(ix.upd3_iv, K) * C.X(ix.upd_t1[2], I) * C.Y(ix.upd_t2[2], J);
  }
  const T bdt = T(r.beta) * static_cast<const T*>(p.dt)[0];
  gm = CellGeom<T>{af1, af1p, c1, af2, af2p, c2, af3, af3p, c3, bdt};
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T dv = (fl.f(0, 0, c) * af1 - fl.f(0, 1, c) * af1p) * c1;
    dv = dv + (fl.f(1, 0, c) * af2 - fl.f(1, 1, c) * af2p) * c2;
    if (az) dv = dv + (fl.f(2, 0, c) * af3 - fl.f(2, 1, c) * af3p) * c3;
    u[c] = rk_blend(r.gam0, r.gam1, u0, u1, c * us + uo, bdt * dv);
  }

  // ---- pressure-gradient + PdV flux sources
  u[1] = u[1] + bdt * C.X(ix.idx1, I) * (fl.pf(0, 0) - fl.pf(0, 1));
  u[2] = u[2] + bdt * C.Y(ix.idx2, J) * (fl.pf(1, 0) - fl.pf(1, 1));
  u[5] = u[5] - bdt * half * (fl.pf(0, 0) + fl.pf(0, 1)) *
                    (fl.vf(0, 1) * af1p - fl.vf(0, 0) * af1) * c1;
  u[5] = u[5] - bdt * half * (fl.pf(1, 0) + fl.pf(1, 1)) *
                    (fl.vf(1, 1) * af2p - fl.vf(1, 0) * af2) * c2;
  if (az) {
    u[3] = u[3] + bdt * C.Z(ix.idx3, K) * (fl.pf(2, 0) - fl.pf(2, 1));
    u[5] = u[5] - bdt * half * (fl.pf(2, 0) + fl.pf(2, 1)) *
                      (fl.vf(2, 1) * af3p - fl.vf(2, 0) * af3) * c3;
  }

  // ---- connection sources (curvilinear momenta), rotation velocity included
  if (n.x1dep || n.x2dep) {
    const T rho_w = wc(0);
    T vt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vt[c] = wc(1 + c);
      if (n.has_rot) vt[c] = vt[c] + C.X(ix.vrot_1[c], I) * C.Y(ix.vrot_2[c], J);
    }
    const T rdt = rho_w * bdt;
    if (n.x1dep)
      u[1] = u[1] + rdt * (C.X(ix.conn1[0], I) * sq(vt[0]) + C.X(ix.conn1[1], I) * sq(vt[1]) +
                           C.X(ix.conn1[2], I) * sq(vt[2]));
    if (n.x2dep) u[2] = u[2] + rdt * C.Y(ix.conn2, J) * sq(vt[2]);
  }

  // ---- rotating-frame conservative torque and centrifugal work
  // (rotating_frame_impl.hpp:96-170): mass-flux divergence weighted by
  // +/-(<R^2>_pm - <R^2>), work from the averaged mass fluxes
  if (r.rf_omega != 0.0) {
    const T omdt = T(r.rf_omega) * bdt;
    const T om2dt = T(r.rf_omega * r.rf_omega) * bdt;
    auto wrow = [&](int dd, bool hi) {
      const int(&t1)[3][2] = hi ? ix.rfw_hi_1 : ix.rfw_lo_1;
      const int(&t2)[3][2] = hi ? ix.rfw_hi_2 : ix.rfw_lo_2;
      return C.X(t1[dd][0], I) * C.Y(t2[dd][0], J) + C.X(t1[dd][1], I) * C.Y(t2[dd][1], J);
    };
    T rdivf = (fl.f(0, 0, 0) * af1 * wrow(0, false) + fl.f(0, 1, 0) * af1p * wrow(0, true)) * c1;
    rdivf = rdivf +
            (fl.f(1, 0, 0) * af2 * wrow(1, false) + fl.f(1, 1, 0) * af2p * wrow(1, true)) * c2;
    T favg[3] = {half * (fl.f(0, 0, 0) + fl.f(0, 1, 0)), half * (fl.f(1, 0, 0) + fl.f(1, 1, 0)),
                 T(0)};
    if (az) {
      rdivf = rdivf +
              (fl.f(2, 0, 0) * af3 * wrow(2, false) + fl.f(2, 1, 0) * af3p * wrow(2, true)) * c3;
      favg[2] = half * (fl.f(2, 0, 0) + fl.f(2, 1, 0));
    }
    T fdotr = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[1 + c] = u[1 + c] - omdt * rdivf * (C.X(ix.phihat_1[c], I) * C.Y(ix.phihat_2[c], J));
      if (c < 2 || az) fdotr = fdotr + favg[c] * (C.X(ix.rhat_1[c], I) * C.Y(ix.rhat_2[c], J));
    }
    u[4] = u[4] + om2dt * (C.X(ix.rcyl_1, I) * C.Y(ix.rcyl_2, J)) * fdotr;
  }

  // ---- central point-mass gravity (Gravity gtype=point, no sink): the
  // acceleration -gm r_vec / norm on the problem basis; gfac carries the
  // tstart/tstop window
  if (n.grav >= 0) {
    const T gdt = T(r.gfac) * bdt;
    const T gm = T(r.gm);
    T rv[3], Rc = T(0), zc = T(0), r2;
    if (n.grav == 2) {
      rv[0] = C.X(ix.gx_1, I) - T(r.gpos[0]);
      rv[1] = C.Y(ix.gy_2, J) - T(r.gpos[1]);
      rv[2] = C.Z(ix.gz_3, K) - T(r.gpos[2]);
      r2 = rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2];
    } else {
      Rc = C.X(ix.rcyl_1, I) * C.Y(ix.rcyl_2, J);
      zc = C.X(ix.zc_1, I) * C.Y(ix.zc_2, J) * C.Z(ix.zc_3, K);
      r2 = Rc * Rc + zc * zc;
    }
    const T inv_r = rsqrt_t(r2);
    T gmag;
    if (r.soft2 == 0.0) {
      gmag = (-gm) * inv_r * inv_r * inv_r;
    } else if (n.grav == 0) {
      gmag = -gm / (r2 + T(r.soft2)) * inv_r;
    } else {
      const T irs = rsqrt_t(r2 + T(r.soft2));
      gmag = (-gm) * irs * irs * irs;
    }
    const T rho_g = wc(0);
    T vdotg = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (n.grav == 2) {
        const T g_c = gmag * rv[c];
        u[1 + c] = u[1 + c] + gdt * rho_g * g_c;
        vdotg = vdotg + wc(1 + c) * g_c;
      } else {
        const T hx = C.X(ix.hv_1[c], I) * C.Y(ix.hv_2[c], J);
        const T rh = C.X(ix.rhat_1[c], I) * C.Y(ix.rhat_2[c], J);
        const T zh = C.X(ix.zhat_1[c], I) * C.Y(ix.zhat_2[c], J);
        const T g_c = gmag * (Rc * rh + zc * zh);
        u[1 + c] = u[1 + c] + gdt * rho_g * hx * g_c;
        vdotg = vdotg + wc(1 + c) * g_c;
      }
    }
    u[4] = u[4] + gdt * rho_g * vdotg;
  }
}

// Writes node ``nd``'s u_out (and, FULL, w_out) at interior cell ``cell``
// from the updated conserved state ``u``; returns its CFL denominator, the
// diffusive one ``den_diff`` folded in when ``diff`` (FULL), or 0.
template <typename T, bool GATHER, bool FULL>
__device__ __forceinline__ T cell_finish(const Ctx<T, GATHER>& C, const CurvParams& p,
                                         const NodePtrs& nd, int k, int j, int i,
                                         int64_t cell, const T (&u)[6], bool diff,
                                         T den_diff) {
  const CurvInts& n = p.n;
  const CurvReals& r = p.r;
  const CurvIdx& ix = n.ix;
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const bool az = n.nz > 1;
  const int I = i + n.g1, J = j + n.g2, K = k + n.g3;
  const T half = T(0.5);
  T* uo = static_cast<T*>(nd.u_out);
  if (!FULL) {
#pragma unroll
    for (int c = 0; c < 6; ++c) uo[c * ncell + cell] = u[c];
    return T(0);
  }

  // ---- dual energy + C2P/P2C with scale factors and floors
  T hx[3], ihx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    hx[c] = C.X(ix.hv_1[c], I) * C.Y(ix.hv_2[c], J);
    ihx[c] = C.inv_h(c, I, J);
  }
  const T rho = vmax(u[0], T(r.dfloor));
  const T irho = T(1) / rho;
  const T m1 = u[1] * ihx[0], m2 = u[2] * ihx[1], m3 = u[3] * ihx[2];
  const T ke = half * (m1 * m1 + m2 * m2 + m3 * m3) * irho;
  const T ue = u[4] - ke;
  const T siefloor = T(r.siefloor);
  T sie = ue > T(r.de_switch) * u[4] ? ue * irho : u[5] * irho;
  sie = vmax(sie, siefloor);
  const T eint0 = vmax(sie * rho, siefloor * rho);
  const T v1 = m1 * irho, v2 = m2 * irho, v3 = m3 * irho;
  sie = vmax(eint0 * irho, siefloor);
  const T pres = T(r.gamma - 1.0) * rho * sie;
  const T eint = sie * rho;
  const T etot = eint + half * rho * (v1 * v1 + v2 * v2 + v3 * v3);
  T* wo = static_cast<T*>(nd.w_out);
  uo[0 * ncell + cell] = rho;
  uo[1 * ncell + cell] = rho * v1 * hx[0];
  uo[2 * ncell + cell] = rho * v2 * hx[1];
  uo[3 * ncell + cell] = rho * v3 * hx[2];
  uo[4 * ncell + cell] = etot;
  uo[5 * ncell + cell] = eint;
  wo[0 * ncell + cell] = rho;
  wo[1 * ncell + cell] = v1;
  wo[2 * ncell + cell] = v2;
  wo[3 * ncell + cell] = v3;
  wo[4 * ncell + cell] = pres;
  wo[5 * ncell + cell] = sie;

  // ---- CFL denominator (physical widths from the invw rows)
  const T cs = sqrt(T(r.gamma * (r.gamma - 1.0)) * sie);
  T den = (fabs(v1) + cs) * (C.X(ix.invw_1[0], I) * C.Y(ix.invw_2[0], J)) +
          (fabs(v2) + cs) * (C.X(ix.invw_1[1], I) * C.Y(ix.invw_2[1], J));
  if (az)
    den = den + (fabs(v3) + cs) *
                    (C.X(ix.invw_1[2], I) * C.Y(ix.invw_2[2], J) * C.Z(ix.inv_dx3, K));
  return diff ? vmax(den, den_diff) : den;
}

// The viscous/thermal diffusion of interior cell (k, j, i) (DiffusionUpdateImpl),
// after flux_update: ``faces(d, lo, hi)`` gives the diffusive flux rows (m1,
// m2, m3, energy) through its lower and upper faces along axis d = 0..2,
// ``wc(c)`` its own primitive c; adds the stress divergence with its
// connection terms and the heating to ``u``.  Both bodies run it.
template <typename T, bool GATHER, class Faces, class Wc>
__device__ __forceinline__ void diff_update(const Ctx<T, GATHER>& C, const CurvParams& p, int k,
                                            int j, int i, const Faces& faces, const Wc& wc,
                                            const CellGeom<T>& gm, T (&u)[6]) {
  const CurvInts& n = p.n;
  const CurvIdx& ix = n.ix;
  const bool az = n.nz > 1;
  const bool visc = n.visc >= 0;
  const int I = i + n.g1, J = j + n.g2;
  const T bdt = gm.bdt;
  T ddv[4] = {T(0), T(0), T(0), T(0)};
  // one axis: ddv += (F_lo A_lo - F_hi A_hi) / V; returns the cell average
  // of its diagonal row
  const auto axis = [&](int d, T af_lo, T af_hi, T cfac) {
    T lo[4], hi[4];
    faces(d, lo, hi);
#pragma unroll
    for (int q = 0; q < 4; ++q) ddv[q] = ddv[q] + (lo[q] * af_lo - hi[q] * af_hi) * cfac;
    return T(0.5) * (lo[d] + hi[d]);
  };
  axis(0, gm.af1, gm.af1p, gm.c1);
  const T diag2 = axis(1, gm.af2, gm.af2p, gm.c2);
  T diag3 = T(0);
  if (az) diag3 = axis(2, gm.af3, gm.af3p, gm.c3);
  if (visc && n.x1dep) {
    ddv[0] = ddv[0] + C.X(ix.conn1[1], I) * diag2;
    if (az) ddv[0] = ddv[0] + C.X(ix.conn1[2], I) * diag3;
  }
  if (visc && n.x2dep && az) ddv[1] = ddv[1] + C.Y(ix.conn2, J) * diag3;
  if (visc) {
    u[1] = u[1] - bdt * ddv[0];
    u[2] = u[2] - bdt * ddv[1];
    u[3] = u[3] - bdt * ddv[2];
  }
  u[4] = u[4] - bdt * ddv[3];
  T heat = -bdt * ddv[3];
  if (visc)
    heat = heat + bdt * (ddv[0] * wc(1) * C.inv_h(0, I, J) + ddv[1] * wc(2) * C.inv_h(1, I, J) +
                         ddv[2] * wc(3) * C.inv_h(2, I, J));
  u[5] = u[5] + heat;
}

// The diffusive CFL denominator 2 ndim nu_eff / min_dx^2 of cell (k, j, i)
// of density rho_i and coefficients own.muv(), own.muc().
template <typename T, bool GATHER, class Own>
__device__ __forceinline__ T diff_den(const Ctx<T, GATHER>& C, const CurvParams& p, int k, int j,
                                      int i, T rho_i, const Own& own) {
  const CurvInts& n = p.n;
  const CurvReals& r = p.r;
  const CurvIdx& ix = n.ix;
  const bool az = n.nz > 1;
  const int I = i + n.g1, J = j + n.g2, K = k + n.g3;
  T imd = vmax(C.X(ix.invw_1[0], I) * C.Y(ix.invw_2[0], J),
               C.X(ix.invw_1[1], I) * C.Y(ix.invw_2[1], J));
  if (az) imd = vmax(imd, C.X(ix.invw_1[2], I) * C.Y(ix.invw_2[2], J) * C.Z(ix.inv_dx3, K));
  const T ndim2 = T(az ? 6 : 4);
  T den_diff = T(0);
  if (n.visc >= 0) {
    const double eta = r.visc_p[1];
    const T m = own.muv() * T(1.0 + (eta > 1.0 ? eta - 1.0 : 0.0)) / rho_i;
    den_diff = vmax(den_diff, ndim2 * m * imd * imd);
  }
  if (n.cond >= 0) {
    T m = own.muc();
    if (n.cond == kCondPlaw) m = m / (rho_i * T(r.cv));
    den_diff = vmax(den_diff, ndim2 * m * imd * imd);
  }
  return den_diff;
}

// The per-cell body: writes node ``nd``'s u_out (and, FULL, w_out) at
// interior cell ``cell`` (flat index into [nz, ny, nx]); returns its CFL
// denominator (FULL) or 0.
template <typename T, bool GATHER, bool FULL>
__device__ __forceinline__ T curv_cell(const CurvParams& p, const NodePtrs& nd, int64_t cell) {
  const Ctx<T, GATHER> C(p, nd);
  const CurvInts& n = p.n;
  const int nx = n.nx, ny = n.ny, nz = n.nz;
  const bool az = nz > 1;
  const int i = int(cell % nx);
  const int j = int((cell / nx) % ny);
  const int k = int(cell / (int64_t(nx) * ny));

  // ---- fluxes
  CellFluxes<T> fl;
  fl.P[2][0] = fl.P[2][1] = fl.V[2][0] = fl.V[2][1] = T(0);
  axis_flux<T, GATHER, 1>(C, k, j, i, fl.F[0], fl.P[0], fl.V[0]);
  axis_flux<T, GATHER, 2>(C, k, j, i, fl.F[1], fl.P[1], fl.V[1]);
  if (az) axis_flux<T, GATHER, 3>(C, k, j, i, fl.F[2], fl.P[2], fl.V[2]);

  // ---- update and the folded flux, connection, frame and gravity sources
  T u[6];
  CellGeom<T> gm;
  flux_update(C, p, k, j, i, fl, [&](int c) { return C.W(c, k, j, i); },
              static_cast<const T*>(nd.u0), static_cast<const T*>(nd.u1),
              int64_t(nx) * ny * nz, cell, u, gm);

  // ---- viscous/thermal diffusion (DiffusionUpdateImpl)
  const bool diff = n.visc >= 0 || n.cond >= 0;
  T den_diff = T(0);
  if (diff) {
    const auto faces = [&](int d, T(&lo)[4], T(&hi)[4]) {
      if (d == 0) {
        diff_face<T, GATHER, 1>(C, k, j, i, lo);
        diff_face<T, GATHER, 1>(C, k, j, i + 1, hi);
      } else if (d == 1) {
        diff_face<T, GATHER, 2>(C, k, j, i, lo);
        diff_face<T, GATHER, 2>(C, k, j + 1, i, hi);
      } else {
        diff_face<T, GATHER, 3>(C, k, j, i, lo);
        diff_face<T, GATHER, 3>(C, k + 1, j, i, hi);
      }
    };
    diff_update(C, p, k, j, i, faces, [&](int c) { return C.W(c, k, j, i); }, gm, u);
    if (FULL)
      den_diff = diff_den(C, p, k, j, i, C.W(0, k, j, i), LazyCell<T, GATHER, 1>{C, k, j, i});
  }
  return cell_finish<T, GATHER, FULL>(C, p, nd, k, j, i, cell, u, diff, den_diff);
}

// ---------------------------------------------------------------------------
// the tiled body (every launch on a ghost width of two: K3, K4 full and
// partial, K5a, K5b, and K6 as its node axis)
// ---------------------------------------------------------------------------

// A block's footprint of columns per dtype and body (DIFF: the viscous and
// conductive stage), whether it stages the registers u0, u1 (UREG), the
// planes of its z chunk (TZ) and the blocks an SM is to hold (MINB, the
// launch bound).  Without diffusion f64 halves the footprint in y and
// drops UREG, so two blocks still fit an SM's shared memory; the
// diffusive body spends UREG's room on its cell quantities and faces, and
// in f64 holds one block per SM.
template <typename T, bool DIFF>
struct TileDims;
template <>
struct TileDims<float, false> {
  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 2;
  static constexpr bool UREG = true;
};
template <>
struct TileDims<double, false> {
  static constexpr int TX = 32, TY = 4, TZ = 16, MINB = 2;
  static constexpr bool UREG = false;
};
template <>
struct TileDims<float, true> {
  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 2;
  static constexpr bool UREG = false;
};
template <>
struct TileDims<double, true> {
  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 1;
  static constexpr bool UREG = false;
};
constexpr int kRing = 4;

// Rows of the diffusive body's cell quantities (QCell): the three
// contravariant velocities, the coefficients of viscosity and conduction,
// the velocity divergence and the x3 gradients of v^1 and v^2 (the kQCell
// rows of every cell the plane's faces read), then, at the tile's own
// cells only, the x1 and x2 gradients of v^3 for the x3 face above.
constexpr int kQmuv = 3, kQmuc = 4, kQdiv = 5, kQtg13 = 6, kQtg23 = 7, kQCell = 8;
constexpr int kQtg31 = 8, kQtg32 = 9, kQRows = 10;

// Shared-memory layout of a block, in elements of T: the ring of primitive
// planes [kRing][6][RY][RX] (the footprint with its halo of two), the x
// face values of cells -1..TX of each row, upper (xl) and lower (xr)
// [6][TY][TX + 2], the y face values [6][TY + 2][TX] (yl, yr), the solved
// x faces [NF][TY][TX + 1] and y faces [NF][TY + 1][TX] (6 fluxes, the face
// pressure, the face velocity; DIFF: the four diffusive rows m1, m2, m3,
// energy), (UREG) the plane's registers u0, u1 [12][TY][TX], and (DIFF)
// the cell quantities of one plane [kQRows][TY + 2][TX + 2] over cells
// -1..TX x -1..TY (QCell).
template <typename T, bool DIFF>
struct TileLayout {
  static constexpr int TX = TileDims<T, DIFF>::TX, TY = TileDims<T, DIFF>::TY, NT = TX * TY;
  // a plane row holds the footprint's TX columns 16-byte aligned, with
  // two halo columns on each side and two more of padding
  static constexpr int RX = TX + 8, RY = TY + 4, VEC = 16 / int(sizeof(T));
  static constexpr int PLANE = 6 * RY * RX;
  static constexpr int NF = DIFF ? 12 : 8;
  static constexpr int XV = 6 * TY * (TX + 2), YV = 6 * (TY + 2) * TX;
  static constexpr int XF = NF * TY * (TX + 1), YF = NF * (TY + 1) * TX;
  static constexpr bool UREG = TileDims<T, DIFF>::UREG;
  static constexpr int UR = UREG ? 12 * NT : 0;
  static constexpr int QX = TX + 2, QY = TY + 2, QR = DIFF ? kQRows * QY * QX : 0;
  static constexpr int ELEMS = kRing * PLANE + 2 * XV + 2 * YV + XF + YF + UR + QR;
  static_assert((kRing * PLANE + 2 * XV + 2 * YV + XF + YF) % VEC == 0 && PLANE % VEC == 0,
                "16-byte copies need aligned planes and registers");
  static constexpr int BYTES = ELEMS * int(sizeof(T));
};

// Blocks of one node: x tiles fastest, then y tiles, then z chunks.
template <typename T, bool DIFF>
__host__ __device__ __forceinline__ int64_t tile_count(int nx, int ny, int nz) {
  using D = TileDims<T, DIFF>;
  return int64_t((nx + D::TX - 1) / D::TX) * ((ny + D::TY - 1) / D::TY) *
         ((nz + D::TZ - 1) / D::TZ);
}

struct TilePos {
  int x0, y0, z0, z1;       // footprint origin and the chunk's planes [z0, z1)
};

template <typename T, bool DIFF>
__device__ __forceinline__ TilePos tile_pos(const CurvInts& n, int64_t blk) {
  using D = TileDims<T, DIFF>;
  const int nbx = (n.nx + D::TX - 1) / D::TX, nby = (n.ny + D::TY - 1) / D::TY;
  TilePos t;
  t.x0 = int(blk % nbx) * D::TX;
  t.y0 = int((blk / nbx) % nby) * D::TY;
  t.z0 = int(blk / (int64_t(nbx) * nby)) * D::TZ;
  t.z1 = t.z0 + D::TZ < n.nz ? t.z0 + D::TZ : n.nz;
  return t;
}

// The ring's rows hold halo-relative columns 0 .. TX + 3 at shared-memory
// columns a - 2 .. a + TX + 1 of an RX-wide row, footprint column 0 at a:
// a = 4 for a gather halo, whose footprint rows start 16-byte aligned in
// the interior, and a = 6 for a padded array, where a footprint row with
// its x halo is one run starting g1 = 2 cells before the footprint, so
// that halo column 0 lands on a 16-byte chunk (the padded-row placement of
// stage_cart.cu's tile_col0).
template <typename T, bool DIFF>
struct TileMem {
  using L = TileLayout<T, DIFF>;
  T *ring, *xl, *xr, *yl, *yr, *xf, *yf, *ureg, *qs;
  __device__ __forceinline__ TileMem(T* s, bool padded)
      : ring(s + (padded ? 2 : 0)), xl(s + kRing * L::PLANE), xr(xl + L::XV), yl(xr + L::XV),
        yr(yl + L::YV), xf(yr + L::YV), yf(xf + L::XF), ureg(yf + L::YF), qs(ureg + L::UR) {}
  // primitive c in ring slot s at halo-relative row jj and column ii
  __device__ __forceinline__ T& w(int s, int c, int jj, int ii) const {
    return ring[((s * 6 + c) * L::RY + jj) * L::RX + ii + 2];
  }
  // face values of cell-row jj (x: tile row; y: tile row + 1), cell-column ii
  __device__ __forceinline__ int xv(int c, int jj, int ii) const {
    return (c * L::TY + jj) * (L::TX + 2) + ii;
  }
  __device__ __forceinline__ int yv(int c, int jj, int ii) const {
    return (c * (L::TY + 2) + jj) * L::TX + ii;
  }
  // quantity q of x face fi (the lower face of tile column fi) of tile row jj,
  // and of y face fj of tile column ii
  __device__ __forceinline__ T& fx(int q, int jj, int fi) const {
    return xf[(q * L::TY + jj) * (L::TX + 1) + fi];
  }
  __device__ __forceinline__ T& fy(int q, int fj, int ii) const {
    return yf[(q * (L::TY + 1) + fj) * L::TX + ii];
  }
  // (DIFF) cell quantity q of the cell at tile row r - 1, column c - 1
  __device__ __forceinline__ T& q(int row, int r, int c) const {
    return qs[(row * L::QY + r) * L::QX + c];
  }
};

// What a thread carries from plane to plane: the upper z face value of its
// column's cell below the next z face, the z faces below (bot) and above
// (top) the current plane, and its running CFL maximum; DIFF: the
// diffusive z face below (vbot), unused otherwise.
template <typename T, bool DIFF>
struct TileThread {
  T zup[6], bot[8], top[8], den;
  T vbot[4];
};

// Stages plane kk of a padded array [6, nz + 2g3, ny + 2g2, nx + 2g1] (K4)
// into ring slot s: every row jj of the footprint with its halo, columns
// -2 .. TX + 1, is one run of the array, copied by 16-byte chunks of
// shared memory (halo column 0 on a chunk, TileMem), 16 bytes at a time
// where the run is aligned there too, element by element where it is not
// or where the run crosses the ghost layer's end (columns from nx + 2, rows
// from ny + 2 are not read).  The corners come with their rows.
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_load_padded(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                                 const TilePos& tp, int s, int kk, int tid) {
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = C.n;
  constexpr int NQ = (L::TX + 4) / L::VEC;
  static_assert((L::TX + 4) % L::VEC == 0, "a padded row is whole 16-byte chunks");
  const int64_t xp = n.nx + 2 * n.g1, yp = n.ny + 2 * n.g2, zp = n.nz + 2 * n.g3;
  const T* w = Ctx<T, true>::at(C.nd.w) + (kk + n.g3) * yp * xp;
  for (int e = tid; e < 6 * (L::TY + 4) * NQ; e += L::NT) {
    const int c = e / ((L::TY + 4) * NQ), jj = (e / NQ) % (L::TY + 4), q = e % NQ;
    const int j = tp.y0 + jj - 2, i = tp.x0 + q * L::VEC - 2;   // the chunk's first cell
    if (j >= n.ny + 2 || i >= n.nx + 2) continue;
    const T* g = w + (c * zp * yp + (j + n.g2)) * xp + (i + n.g1);
    T* dst = &m.w(s, c, jj, q * L::VEC);
    if (i + L::VEC <= n.nx + 2 && reinterpret_cast<uintptr_t>(g) % 16 == 0) {
      copy_async16(dst, g);
    } else {
#pragma unroll
      for (int v = 0; v < L::VEC; ++v)
        if (i + v < n.nx + 2) copy_async(dst + v, g + v);
    }
  }
}

// Stages plane kk into ring slot s: the footprint's rows with the x halo,
// and the y halo rows over the footprint's columns, each element read once
// from the interior or from one strip; elements past the ghost layer are
// not read.  The corners, which no hydro face reads, are left out, but for
// DIFF's four of width one, whose v1 and v2 the viscous stencil reads.
// Over the footprint's columns, where they all lie inside [0, nx), a row
// is one contiguous run of its source (the interior, an x2 strip, an x3
// strip or, x3 wrapped, another plane of the interior is chosen by j and k
// alone), copied 16 bytes at a time where aligned.  A padded array (K4)
// goes through tile_load_padded: the halo source is a runtime switch of
// the staging alone, and everything after it reads shared memory.
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_load(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                          const TilePos& tp, int s, int kk, int tid,
                                          bool padded) {
  if (padded) return tile_load_padded(C, m, tp, s, kk, tid);
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = C.n;
  constexpr int NV = L::TX / L::VEC;
  const bool whole = tp.x0 + L::TX <= n.nx;
  for (int e = tid; e < 6 * (L::TY + 4) * NV; e += L::NT) {
    const int c = e / ((L::TY + 4) * NV), jj = (e / NV) % (L::TY + 4), v = e % NV;
    const int j = tp.y0 + jj - 2;
    if (j >= n.ny + 2) continue;
    if (whole) {
      const T* row = C.src(c, kk, j, tp.x0) + v * L::VEC;
      if (reinterpret_cast<uintptr_t>(row) % 16 == 0) {
        copy_async16(&m.w(s, c, jj, 2 + v * L::VEC), row);
      } else {
#pragma unroll
        for (int q = 0; q < L::VEC; ++q) copy_async(&m.w(s, c, jj, 2 + v * L::VEC + q), row + q);
      }
    } else {
#pragma unroll
      for (int q = 0; q < L::VEC; ++q) {
        const int i = tp.x0 + v * L::VEC + q;
        if (i < n.nx + 2) copy_async(&m.w(s, c, jj, 2 + v * L::VEC + q), C.src(c, kk, j, i));
      }
    }
  }
  // the x halo columns of the footprint's rows
  for (int e = tid; e < 6 * L::TY * 4; e += L::NT) {
    const int c = e / (L::TY * 4), jj = 2 + (e / 4) % L::TY, h = e % 4;
    const int ii = h < 2 ? h : L::TX + h, i = tp.x0 + ii - 2, j = tp.y0 + jj - 2;
    if (i < n.nx + 2 && j < n.ny + 2) copy_async(&m.w(s, c, jj, ii), C.src(c, kk, j, i));
  }
  // DIFF: v1 and v2 at the corner cells (-1 | TY, -1 | TX)
  if (DIFF && tid < 8) {
    const int c = 1 + tid / 4, jj = tid & 2 ? L::TY + 2 : 1, ii = tid & 1 ? L::TX + 2 : 1;
    const int i = tp.x0 + ii - 2, j = tp.y0 + jj - 2;
    if (i < n.nx + 2 && j < n.ny + 2) copy_async(&m.w(s, c, jj, ii), C.src(c, kk, j, i));
  }
}

// The registers u0, u1 of plane k over the footprint into ureg[c * NT +
// r * TX + x] and ureg[(6 + c) * NT + ...] (those read: gam0, gam1 != 0),
// 16 bytes at a time where a row is whole and aligned.
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_load_u(const CurvParams& p, const NodePtrs& nd,
                                            const TileMem<T, DIFF>& m, const TilePos& tp, int k,
                                            int tid) {
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = p.n;
  constexpr int NV = L::TX / L::VEC;
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const bool whole = tp.x0 + L::TX <= n.nx;
  for (int e = tid; e < 12 * L::TY * NV; e += L::NT) {
    const int f = e / (L::TY * NV), r = (e / NV) % L::TY, v = e % NV;
    const int j = tp.y0 + r;
    if (j >= n.ny || (f < 6 ? p.r.gam0 : p.r.gam1) == 0.0) continue;
    const T* row = static_cast<const T*>(f < 6 ? nd.u0 : nd.u1) + (f % 6) * ncell +
                   (int64_t(k) * n.ny + j) * n.nx + tp.x0 + v * L::VEC;
    T* dst = &m.ureg[f * L::NT + r * L::TX + v * L::VEC];
    if (whole && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
      copy_async16(dst, row);
    } else {
#pragma unroll
      for (int q = 0; q < L::VEC; ++q)
        if (tp.x0 + v * L::VEC + q < n.nx) copy_async(dst + q, row + q);
    }
  }
}

// The x and y face values of every cell of ring slot s whose faces the
// footprint needs (cells -1..TX along x, -1..TY along y).
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_face_values(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                                 const TilePos& tp, int s, int tid) {
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = C.n;
  const bool migx = !n.pcm && n.x1dep, migy = !n.pcm && n.x2dep;
  T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int e = tid; e < L::TY * (L::TX + 2); e += L::NT) {
    const int jj = e / (L::TX + 2), ci = e % (L::TX + 2);   // cell column ci - 1
    const int i = tp.x0 + ci - 1, j = tp.y0 + jj;
    if (i > n.nx || j >= n.ny) continue;
    if (migx) plm_g_ratios(C, C.ix.recon1, true, i + n.g1, g);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      face_values(bool(n.pcm), migx, m.w(s, c, jj + 2, ci), m.w(s, c, jj + 2, ci + 1),
                  m.w(s, c, jj + 2, ci + 2), g, m.xl[m.xv(c, jj, ci)], m.xr[m.xv(c, jj, ci)]);
  }
  for (int e = tid; e < (L::TY + 2) * L::TX; e += L::NT) {
    const int cj = e / L::TX, ii = e % L::TX;               // cell row cj - 1
    const int i = tp.x0 + ii, j = tp.y0 + cj - 1;
    if (i >= n.nx || j > n.ny) continue;
    if (migy) plm_g_ratios(C, C.ix.recon2, false, j + n.g2, g);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      face_values(bool(n.pcm), migy, m.w(s, c, cj, ii + 2), m.w(s, c, cj + 1, ii + 2),
                  m.w(s, c, cj + 2, ii + 2), g, m.yl[m.yv(c, cj, ii)], m.yr[m.yv(c, cj, ii)]);
  }
}

// The z face above plane k - 1 of the thread's column (ring slots sm, s0,
// sp hold planes k - 1, k, k + 1): solved from the carried upper value of
// cell k - 1 into ``q``, cell k's upper value carried on.
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_zface(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                           int sm, int s0, int sp, int tx, int ty, int I, int J,
                                           TileThread<T, DIFF>& st, T (&q)[8]) {
  const T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T wr[6], up[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    face_values(bool(C.n.pcm), false, m.w(sm, c, ty + 2, tx + 2), m.w(s0, c, ty + 2, tx + 2),
                m.w(sp, c, ty + 2, tx + 2), g, up[c], wr[c]);
  solve_face<T, true, 3>(C, st.zup, wr, I, J, q);
#pragma unroll
  for (int c = 0; c < 6; ++c) st.zup[c] = up[c];
}

// ---- the diffusive body's cells: each quantity computed once per plane

// A cell of plane k in the viscous stencil, the lower or upper cell of an
// x or y face (D = 1, 2) or the lower one of the thread's x3 face (D = 3):
// its quantities from the plane's QCell rows at (r, c) (the tile cell
// (r - 1, c - 1), global (k, j, i)), its energy from ring slot s; the
// in-plane transverse gradient from its neighbours' rows.
template <typename T, bool DIFF, int D>
struct QCell {
  const Ctx<T, true>& C;
  const TileMem<T, DIFF>& m;
  int s, r, c, k, j, i;
  __device__ __forceinline__ T muv() const { return m.q(kQmuv, r, c); }
  __device__ __forceinline__ T muc() const { return m.q(kQmuc, r, c); }
  __device__ __forceinline__ T vcon(int cc) const { return m.q(cc, r, c); }
  __device__ __forceinline__ T conn() const {
    return conn_of<T, true, D>(C, m.q(0, r, c), [&] { return m.q(1, r, c); }, i + C.n.g1,
                               j + C.n.g2);
  }
  __device__ __forceinline__ T div() const { return m.q(kQdiv, r, c); }
  template <int COMP>
  __device__ __forceinline__ T tg() const {
    if (D == 3) return m.q(COMP == 1 ? kQtg31 : kQtg32, r, c);
    if (COMP == 3) return m.q(D == 1 ? kQtg13 : kQtg23, r, c);
    constexpr int dr = COMP == 2, dc = COMP == 1;
    return tgrad(C, m.q(D - 1, r + dr, c + dc), m.q(D - 1, r - dr, c - dc), COMP, k, j, i);
  }
  __device__ __forceinline__ T w5() const { return m.w(s, 5, r + 1, c + 1); }
};

// A cell of the thread's column for the x3 face (D = 3), in registers.
template <typename T>
struct ZCell {
  T v[3], mv, mc, dv, cn, t1, t2, e5;
  __device__ __forceinline__ T muv() const { return mv; }
  __device__ __forceinline__ T muc() const { return mc; }
  __device__ __forceinline__ T vcon(int c) const { return v[c]; }
  __device__ __forceinline__ T conn() const { return cn; }
  __device__ __forceinline__ T div() const { return dv; }
  template <int COMP>
  __device__ __forceinline__ T tg() const { return COMP == 1 ? t1 : t2; }
  __device__ __forceinline__ T w5() const { return e5; }
};

// The QCell rows of cell (k, j, i) at tile cell (r - 1, c - 1) into q, from
// ring slots sm, s0, sp (planes k - 1, k, k + 1), in the per-cell body's
// operations (Ctx::vcon, mu_model, divv, trans_grad); a corner cell gets
// its v^1 and v^2 only.
template <typename T, bool DIFF>
__device__ __forceinline__ void cell_q(const Ctx<T, true>& C, const TileMem<T, DIFF>& m, int sm,
                                       int s0, int sp, int r, int c, int k, int j, int i,
                                       bool corner, T (&q)[kQCell]) {
  const CurvInts& n = C.n;
  const int I = i + n.g1, J = j + n.g2, K = k + n.g3;
  const int rr = r + 1, cc = c + 1;
  const bool az = n.nz > 1;
  const T ih0 = C.inv_h(0, I, J), ih1 = C.inv_h(1, I, J);
  q[0] = m.w(s0, 1, rr, cc) * ih0;
  q[1] = m.w(s0, 2, rr, cc) * ih1;
  if (corner) return;
  q[2] = m.w(s0, 3, rr, cc) * C.inv_h(2, I, J);
  const T rho = m.w(s0, 0, rr, cc), sie = m.w(s0, 5, rr, cc);
  q[kQmuv] = n.visc >= 0 ? mu_of(C, n.visc, C.r.visc_p, rho, sie, I, J, K) : T(0);
  q[kQmuc] = n.cond >= 0 ? mu_of(C, n.cond, C.r.cond_p, rho, sie, I, J, K) : T(0);
  q[kQdiv] = div_of(C, I, J, K, [&](int d, int o) {
    return d == 0 ? m.w(s0, 1, rr, cc + o)
                  : d == 1 ? m.w(s0, 2, rr + o, cc) : m.w(o < 0 ? sm : o > 0 ? sp : s0, 3, rr, cc);
  });
  q[kQtg13] = q[kQtg23] = T(0);
  if (az) {
    q[kQtg13] = tgrad(C, m.w(sp, 1, rr, cc) * ih0, m.w(sm, 1, rr, cc) * ih0, 3, k, j, i);
    q[kQtg23] = tgrad(C, m.w(sp, 2, rr, cc) * ih1, m.w(sm, 2, rr, cc) * ih1, 3, k, j, i);
  }
}

// The thread's column cell (k, j, i) at tile cell (r - 1, c - 1) for the
// x3 face, from its QCell rows q and ring slot s0 (plane k): the
// connection term and the x1/x2 gradients of v^3.
template <typename T, bool DIFF>
__device__ __forceinline__ ZCell<T> zcell(const Ctx<T, true>& C, const TileMem<T, DIFF>& m, int s0,
                                          int r, int c, int k, int j, int i,
                                          const T (&q)[kQCell]) {
  const int I = i + C.n.g1, J = j + C.n.g2, rr = r + 1, cc = c + 1;
  ZCell<T> z;
  z.v[0] = q[0];
  z.v[1] = q[1];
  z.v[2] = q[2];
  z.mv = q[kQmuv];
  z.mc = q[kQmuc];
  z.dv = q[kQdiv];
  z.cn = conn_of<T, true, 3>(C, q[0], [&] { return q[1]; }, I, J);
  z.t1 = tgrad(C, m.w(s0, 3, rr, cc + 1) * C.inv_h(2, I + 1, J),
               m.w(s0, 3, rr, cc - 1) * C.inv_h(2, I - 1, J), 1, k, j, i);
  z.t2 = tgrad(C, m.w(s0, 3, rr + 1, cc) * C.inv_h(2, I, J + 1),
               m.w(s0, 3, rr - 1, cc) * C.inv_h(2, I, J - 1), 2, k, j, i);
  z.e5 = m.w(s0, 5, rr, cc);
  return z;
}

// The QCell rows of plane k (ring slots sm, s0, sp: planes k - 1, k,
// k + 1) at the cells its faces read, tile cells -1..TX x -1..TY up to the
// ghost cells nx, ny; only those of the rectangle's rim when ``rim`` (the
// threads hold their own cells).
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_q(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                       const TilePos& tp, int sm, int s0, int sp, int k, int tid,
                                       bool rim) {
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = C.n;
  const int nrim = 2 * L::QX + 2 * L::TY;
  for (int e = tid; e < (rim ? nrim : L::QX * L::QY); e += L::NT) {
    int r, c;
    if (!rim) {
      r = e / L::QX;
      c = e % L::QX;
    } else if (e < 2 * L::QX) {
      r = e < L::QX ? 0 : L::TY + 1;
      c = e % L::QX;
    } else {
      r = 1 + (e - 2 * L::QX) / 2;
      c = (e & 1) ? L::TX + 1 : 0;
    }
    const int i = tp.x0 + c - 1, j = tp.y0 + r - 1;
    if (i > n.nx || j > n.ny) continue;
    T q[kQCell];
    const bool corner = (r == 0 || r == L::TY + 1) && (c == 0 || c == L::TX + 1);
    cell_q(C, m, sm, s0, sp, r, c, k, j, i, corner, q);
#pragma unroll
    for (int w = 0; w < kQCell; ++w)
      if (!corner || w < 2) m.q(w, r, c) = q[w];
  }
}

// Phase B: every x and y face of the footprint's plane k in ring slot s,
// once each, into shared memory (the extra x face column falls to the
// first warp, the extra y face row to the last; DIFF: the diffusive rows
// beside the hydro ones, from plane k's QCell rows), and the thread's z
// face above the plane into its registers (slots of planes k + 1 and
// k + 2: s1, s2).
template <typename T, bool DIFF>
__device__ __forceinline__ void tile_solve(const Ctx<T, true>& C, const TileMem<T, DIFF>& m,
                                           const TilePos& tp, int k, int s, int s1, int s2,
                                           int tid, TileThread<T, DIFF>& st) {
  using L = TileLayout<T, DIFF>;
  const CurvInts& n = C.n;
  for (int e = tid; e < L::TY * (L::TX + 1); e += L::NT) {
    const int jj = e / (L::TX + 1), fi = e % (L::TX + 1);
    const int i = tp.x0 + fi, j = tp.y0 + jj;
    if (i > n.nx || j >= n.ny) continue;
    T wl[6], wr[6], q[8];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      wl[c] = m.xl[m.xv(c, jj, fi)];
      wr[c] = m.xr[m.xv(c, jj, fi + 1)];
    }
    solve_face<T, true, 1>(C, wl, wr, i + n.g1, j + n.g2, q);
#pragma unroll
    for (int c = 0; c < 8; ++c) m.fx(c, jj, fi) = q[c];
    if (DIFF) {
      T F[4];
      visc_face<T, true, 1>(C, k, j, i, QCell<T, DIFF, 1>{C, m, s, jj + 1, fi, k, j, i - 1},
                            QCell<T, DIFF, 1>{C, m, s, jj + 1, fi + 1, k, j, i}, F);
#pragma unroll
      for (int c = 0; c < 4; ++c) m.fx(8 + c, jj, fi) = F[c];
    }
  }
  for (int e = L::NT - 1 - tid; e < (L::TY + 1) * L::TX; e += L::NT) {
    const int fj = e / L::TX, ii = e % L::TX;
    const int i = tp.x0 + ii, j = tp.y0 + fj;
    if (i >= n.nx || j > n.ny) continue;
    T wl[6], wr[6], q[8];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      wl[c] = m.yl[m.yv(c, fj, ii)];
      wr[c] = m.yr[m.yv(c, fj + 1, ii)];
    }
    solve_face<T, true, 2>(C, wl, wr, i + n.g1, j + n.g2, q);
#pragma unroll
    for (int c = 0; c < 8; ++c) m.fy(c, fj, ii) = q[c];
    if (DIFF) {
      T F[4];
      visc_face<T, true, 2>(C, k, j, i, QCell<T, DIFF, 2>{C, m, s, fj, ii + 1, k, j - 1, i},
                            QCell<T, DIFF, 2>{C, m, s, fj + 1, ii + 1, k, j, i}, F);
#pragma unroll
      for (int c = 0; c < 4; ++c) m.fy(8 + c, fj, ii) = F[c];
    }
  }
  const int tx = tid % L::TX, ty = tid / L::TX, i = tp.x0 + tx, j = tp.y0 + ty;
  if (n.nz > 1 && i < n.nx && j < n.ny)
    tile_zface(C, m, s, s1, s2, tx, ty, i + n.g1, j + n.g2, st, st.top);
}

// The fluxes of the thread's cell for flux_update: x and y faces from
// shared memory, z faces from the thread's registers.
template <typename T, bool DIFF>
struct TileFluxes {
  const TileMem<T, DIFF>& m;
  const TileThread<T, DIFF>& st;
  int tx, ty;
  __device__ __forceinline__ T q(int d, int s, int c) const {
    if (d == 0) return m.fx(c, ty, tx + s);
    if (d == 1) return m.fy(c, ty + s, tx);
    return s == 0 ? st.bot[c] : st.top[c];
  }
  __device__ __forceinline__ T f(int d, int s, int c) const { return q(d, s, c); }
  __device__ __forceinline__ T pf(int d, int s) const { return q(d, s, 6); }
  __device__ __forceinline__ T vf(int d, int s) const { return q(d, s, 7); }
};

// One block of the tiled body, phase by phase: ``ex.each(f)`` runs f(tid,
// state) for every thread of the block and then synchronises it (on the
// card, each thread runs its own call between __syncthreads; the host
// build of the tests loops over the threads).  ``smem`` holds
// TileLayout<T, DIFF>::ELEMS elements.  FULL: the whole stage; otherwise
// K4's partial mode, which writes u alone (cell_finish) and skips the
// diffusive CFL limit and the block's dtden maximum.
template <typename T, bool DIFF, bool FULL, class Exec>
__device__ __forceinline__ void tile_block(const CurvParams& p, const NodePtrs& nd, int64_t blk,
                                           T* smem, Exec& ex) {
  using L = TileLayout<T, DIFF>;
  using St = TileThread<T, DIFF>;
  const Ctx<T, true> C(p, nd);
  const CurvInts& n = p.n;
  const bool padded = p.halo == kPadded;
  const TileMem<T, DIFF> m(smem, padded);
  const TilePos tp = tile_pos<T, DIFF>(n, blk);
  const bool az = n.nz > 1;
  auto slot = [&](int kk) { return (kk - tp.z0 + 2) & (kRing - 1); };

  // prologue: planes z0 - 2 .. z0 + 1; each column's z face below z0
  // (DIFF: its diffusive rows too, from the column's cells z0 - 1 and z0);
  // then plane z0 + 2 lands in the slot of z0 - 2 while plane z0's face
  // values (DIFF: and QCell rows) are made
  ex.each([&](int tid, St& st) {
    st.den = T(0);
    for (int kk = az ? tp.z0 - 2 : 0; kk < (az ? tp.z0 + 2 : 1); ++kk)
      tile_load(C, m, tp, slot(kk), kk, tid, padded);
    copy_commit();
    copy_wait<0>();
  });
  if (az)
    ex.each([&](int tid, St& st) {
      const int tx = tid % L::TX, ty = tid / L::TX, i = tp.x0 + tx, j = tp.y0 + ty;
      if (i >= n.nx || j >= n.ny) return;
      const T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T lo[6];
#pragma unroll
      for (int c = 0; c < 6; ++c)
        face_values(bool(n.pcm), false, m.w(slot(tp.z0 - 2), c, ty + 2, tx + 2),
                    m.w(slot(tp.z0 - 1), c, ty + 2, tx + 2), m.w(slot(tp.z0), c, ty + 2, tx + 2),
                    g, st.zup[c], lo[c]);
      tile_zface(C, m, slot(tp.z0 - 1), slot(tp.z0), slot(tp.z0 + 1), tx, ty, i + n.g1,
                 j + n.g2, st, st.bot);
      if (DIFF) {
        const int z0 = tp.z0;
        T qa[kQCell], qb[kQCell];
        cell_q(C, m, slot(z0 - 2), slot(z0 - 1), slot(z0), ty + 1, tx + 1, z0 - 1, j, i, false,
               qa);
        cell_q(C, m, slot(z0 - 1), slot(z0), slot(z0 + 1), ty + 1, tx + 1, z0, j, i, false, qb);
        const ZCell<T> a = zcell(C, m, slot(z0 - 1), ty + 1, tx + 1, z0 - 1, j, i, qa);
        const ZCell<T> b = zcell(C, m, slot(z0), ty + 1, tx + 1, z0, j, i, qb);
        visc_face<T, true, 3>(C, z0, j, i, a, b, st.vbot);
        m.q(kQtg31, ty + 1, tx + 1) = b.t1;
        m.q(kQtg32, ty + 1, tx + 1) = b.t2;
      }
    });
  ex.each([&](int tid, St&) {
    if (az) tile_load(C, m, tp, slot(tp.z0 + 2), tp.z0 + 2, tid, padded);
    copy_commit();
    tile_face_values(C, m, tp, slot(tp.z0), tid);
    if (DIFF)
      tile_q(C, m, tp, slot(tp.z0 - 1), slot(tp.z0), slot(tp.z0 + 1), tp.z0, tid, false);
    copy_wait<0>();
  });

  // Two phases per plane k.  B: its faces, while plane k + 3 lands in the
  // slot of plane k - 1 and (UREG) its registers in ureg.  C: its cells
  // (DIFF: first each column's diffusive z face above k, from its cell of
  // plane k in the QCell rows and its cell of k + 1, whose rows it then
  // writes in place of k's), and the face values (DIFF: and the rim's
  // QCell rows) of plane k + 1.
  for (int k = tp.z0; k < tp.z1; ++k) {
    ex.each([&](int tid, St& st) {
      if (az && k + 3 <= tp.z1 + 1) tile_load(C, m, tp, slot(k + 3), k + 3, tid, padded);
      if (L::UREG) tile_load_u(p, nd, m, tp, k, tid);
      copy_commit();
      tile_solve(C, m, tp, k, slot(k), slot(k + 1), slot(k + 2), tid, st);
      copy_wait<0>();
    });
    ex.each([&](int tid, St& st) {
      const int tx = tid % L::TX, ty = tid / L::TX, i = tp.x0 + tx, j = tp.y0 + ty;
      const int s = slot(k);
      const bool own = i < n.nx && j < n.ny;
      // the column's cell of plane k, read from its QCell rows until the
      // rows of plane k + 1 replace them
      const QCell<T, DIFF, 3> za{C, m, s, ty + 1, tx + 1, k, j, i};
      T vtop[4], den_diff = T(0);
      if (FULL && DIFF && own) den_diff = diff_den(C, p, k, j, i, m.w(s, 0, ty + 2, tx + 2), za);
      if (DIFF && az && i <= n.nx && j <= n.ny && (own || k + 1 < tp.z1)) {
        T qb[kQCell];
        cell_q(C, m, s, slot(k + 1), slot(k + 2), ty + 1, tx + 1, k + 1, j, i, false, qb);
        if (own) {
          const ZCell<T> zb = zcell(C, m, slot(k + 1), ty + 1, tx + 1, k + 1, j, i, qb);
          visc_face<T, true, 3>(C, k + 1, j, i, za, zb, vtop);
          m.q(kQtg31, ty + 1, tx + 1) = zb.t1;
          m.q(kQtg32, ty + 1, tx + 1) = zb.t2;
        }
#pragma unroll
        for (int w = 0; w < kQCell; ++w) m.q(w, ty + 1, tx + 1) = qb[w];
      }
      if (own) {
        const int64_t cell = (int64_t(k) * n.ny + j) * n.nx + i;
        T u[6];
        CellGeom<T> gm;
        const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
        const auto wc = [&](int c) { return m.w(s, c, ty + 2, tx + 2); };
        flux_update(C, p, k, j, i, TileFluxes<T, DIFF>{m, st, tx, ty}, wc,
                    L::UREG ? m.ureg : static_cast<const T*>(nd.u0),
                    L::UREG ? m.ureg + 6 * L::NT : static_cast<const T*>(nd.u1),
                    L::UREG ? int64_t(L::NT) : ncell, L::UREG ? int64_t(tid) : cell, u, gm);
        if (DIFF) {
          const auto faces = [&](int d, T(&lo)[4], T(&hi)[4]) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              lo[c] = d == 0 ? m.fx(8 + c, ty, tx) : d == 1 ? m.fy(8 + c, ty, tx) : st.vbot[c];
              hi[c] = d == 0 ? m.fx(8 + c, ty, tx + 1) : d == 1 ? m.fy(8 + c, ty + 1, tx) : vtop[c];
            }
          };
          diff_update(C, p, k, j, i, faces, wc, gm, u);
        }
        st.den = vmax(st.den, cell_finish<T, true, FULL>(C, p, nd, k, j, i, cell, u, DIFF,
                                                         den_diff));
#pragma unroll
        for (int q = 0; q < 8; ++q) st.bot[q] = st.top[q];
        if (DIFF && az)
#pragma unroll
          for (int q = 0; q < 4; ++q) st.vbot[q] = vtop[q];
      }
      if (k + 1 < tp.z1) {
        tile_face_values(C, m, tp, slot(k + 1), tid);
        if (DIFF) tile_q(C, m, tp, s, slot(k + 1), slot(k + 2), k + 1, tid, true);
      }
    });
  }

  // the block's maximum of the CFL denominator (the x face area is free)
  if (!FULL) return;
  T* red = m.xf;
  ex.each([&](int tid, St& st) { red[tid] = st.den; });
  for (int h = L::NT / 2; h > 0; h >>= 1)
    ex.each([&](int tid, St&) {
      if (tid < h) red[tid] = vmax(red[tid], red[tid + h]);
    });
  ex.each([&](int tid, St&) {
    if (tid == 0) static_cast<T*>(nd.dmax)[blk] = red[0];
  });
}

// Threads per block of the per-cell body, one cell each, and the blocks an
// SM is to hold: in f32 four, at 128 registers a thread (left free, the
// compiler gives the padded f32 kernel, K4, 134 registers and three blocks
// per SM, and it runs ~25% slower: PERF.md), in f64 no bound.
constexpr int kBlock = 128;
template <typename T>
struct CellDims {
  static constexpr int MINB = sizeof(T) == 4 ? 4 : 1;
};

// May a launch take the tiled body?  Full and partial stages of every
// halo source (six strips, the x1/x2 strips with x3 wrapped, or a padded
// array), with or without diffusion, on a ghost width of two (none along
// x3 for a 2-D node).
inline bool tiled_ok(const CurvParams& p) {
  const CurvInts& n = p.n;
  return n.g1 == 2 && n.g2 == 2 && n.g3 == (n.nz > 1 ? 2 : 0);
}

// Does a tiled launch take the diffusive body?
inline bool tiled_diff(const CurvParams& p) { return p.n.visc >= 0 || p.n.cond >= 0; }

// Entries of a node's dtden output: one per block of the launch's body.
inline int64_t dtden_len(const CurvParams& p, int dtype, int tiled) {
  const CurvInts& n = p.n;
  if (tiled) {
    const bool d = tiled_diff(p);
    if (dtype == 0)
      return d ? tile_count<float, true>(n.nx, n.ny, n.nz) : tile_count<float, false>(n.nx, n.ny, n.nz);
    return d ? tile_count<double, true>(n.nx, n.ny, n.nz) : tile_count<double, false>(n.nx, n.ny, n.nz);
  }
  return (int64_t(n.nx) * n.ny * n.nz + kBlock - 1) / kBlock;
}

// ---- CUDA-only below: the kernels, their launches and the C entry point.
// Everything above also compiles as host C++: tests/test_torch_stage_curv.py
// builds it with g++ behind a few macros, loops curv_cell over the cells
// (the per-cell body) or tile_block over the blocks (the tiled body) and
// holds the result against the plain version on the CPU.

// The launch's parameters are a __grid_constant__ kernel argument: uniform
// across threads, read from the constant bank, and addressable in place
// (diff_face takes references into them, and blockIdx.y picks the node's
// row of the table) without a per-thread copy.  blockIdx.x walks one
// node's cells, blockIdx.y the nodes: a one-node launch is the N = 1 case.
template <typename T, bool GATHER, bool FULL>
__global__ void __launch_bounds__(kBlock, (CellDims<T>::MINB))
stage_curv_kernel(const __grid_constant__ CurvParams p) {
  __shared__ T red[kBlock];
  const NodePtrs& nd = p.node[blockIdx.y];
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const T den = cell < n ? curv_cell<T, GATHER, FULL>(p, nd, cell) : T(0);
  if (!FULL) return;
  // block maximum of the denominator (masked threads contribute 0)
  red[threadIdx.x] = den;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = vmax(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) static_cast<T*>(nd.dmax)[blockIdx.x] = red[0];
}

template <typename T, bool GATHER, bool FULL>
cudaError_t launch(const CurvParams& p, cudaStream_t stream) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const dim3 grid(unsigned((n + kBlock - 1) / kBlock), unsigned(p.nnodes));
  stage_curv_kernel<T, GATHER, FULL><<<grid, kBlock, 0, stream>>>(p);
  return cudaGetLastError();
}

// The tiled body: one block per footprint and z chunk (blockIdx.x), the
// node on blockIdx.y; each thread keeps its TileThread in registers.
template <typename T, bool DIFF>
struct DeviceExec {
  TileThread<T, DIFF> st;
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(int(threadIdx.x), st);
    __syncthreads();
  }
};

template <typename T, bool DIFF, bool FULL>
__global__ void __launch_bounds__((TileLayout<T, DIFF>::NT), (TileDims<T, DIFF>::MINB))
stage_tiled_kernel(const __grid_constant__ CurvParams p) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  DeviceExec<T, DIFF> ex;
  tile_block<T, DIFF, FULL>(p, p.node[blockIdx.y], int64_t(blockIdx.x),
                            reinterpret_cast<T*>(tile_smem), ex);
}

template <typename T, bool DIFF, bool FULL>
cudaError_t launch_tiled(const CurvParams& p, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory is asked for, once; the
  // carveout leaves room for MINB blocks on an SM
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(stage_tiled_kernel<T, DIFF, FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TileLayout<T, DIFF>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stage_tiled_kernel<T, DIFF, FULL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(unsigned(tile_count<T, DIFF>(p.n.nx, p.n.ny, p.n.nz)), unsigned(p.nnodes));
  stage_tiled_kernel<T, DIFF, FULL>
      <<<grid, TileLayout<T, DIFF>::NT, TileLayout<T, DIFF>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool FULL>
cudaError_t launch_mode(const CurvParams& p, int gather, int tiled, cudaStream_t s) {
  if (tiled)
    return tiled_diff(p) ? launch_tiled<T, true, FULL>(p, s) : launch_tiled<T, false, FULL>(p, s);
  return gather ? launch<T, true, FULL>(p, s) : launch<T, false, FULL>(p, s);
}

template <typename T>
cudaError_t launch_t(const CurvParams& p, int gather, int full, int tiled, cudaStream_t s) {
#if !defined(ARTEMIS_CURV_FULL) || ARTEMIS_CURV_FULL == 1
  if (full) return launch_mode<T, true>(p, gather, tiled, s);
#endif
#if !defined(ARTEMIS_CURV_FULL) || ARTEMIS_CURV_FULL == 0
  if (!full) return launch_mode<T, false>(p, gather, tiled, s);
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float64 (a build with -DARTEMIS_CURV_DTYPE=0 or 1
// carries that type only, and with -DARTEMIS_CURV_FULL=1 or 0 the full or
// the partial stage only; the wrapper builds the four in parallel).  halo:
// kPadded (a padded array), kGather (interior + x1/x2 strips, x3 wrapped)
// or kGather6 (interior + the six face strips).  full: 1 whole stage, 0
// partial.  tiled: 1 the tiled body (tiled_ok), 0 the per-cell body.
// ptrs: dt, then kNodePtrs pointers per node in NodePtrs order, the x3
// strips (the last two) given exactly for kGather6 (empty for a 2-D
// node).  nnodes: 1..kMaxNodes nodes of one grid shape sharing ints, reals
// and dt.  ndmax: the dtden entries the caller gave each node (full; 0 in
// partial mode), which must be the body's block count (dtden_len).
// Returns a cudaError_t (0 on success).
extern "C" int artemis_stage_curv(int dtype, int halo, int full, int tiled,
                                  const int* ints, const double* reals,
                                  const void* const* ptrs, int nptrs, int nnodes,
                                  int ndmax, void* stream) {
  CurvParams p;
  if (halo < kPadded || halo > kGather6 ||
      !make_params(halo, ints, reals, ptrs, nptrs, nnodes, &p) ||
      (tiled && !tiled_ok(p)) || ndmax != (full ? dtden_len(p, dtype, tiled) : 0))
    return int(cudaErrorInvalidValue);
  const int gather = halo != kPadded;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(ARTEMIS_CURV_DTYPE) || ARTEMIS_CURV_DTYPE == 0
  if (dtype == 0) return int(launch_t<float>(p, gather, full, tiled, s));
#endif
#if !defined(ARTEMIS_CURV_DTYPE) || ARTEMIS_CURV_DTYPE == 1
  if (dtype == 1) return int(launch_t<double>(p, gather, full, tiled, s));
#endif
  return int(cudaErrorInvalidValue);
}
