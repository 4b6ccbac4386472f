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
// All run the body _curv_body (:631-1402), with _plm_g (:518) and the
// shared _hllc/_hlle/rk_blend (stage_common.cuh).  On the TPU the
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
// The design's first cost is that one thread per cell recomputes every
// face it touches, so each face (hydro and viscous) is solved twice,
// identically, by the two threads that share it, and the viscous stress
// re-derives each cell quantity for every face that needs it.  Stencil and
// coefficient-row loads go through L1/L2.  Shared-memory face caching and
// tiling are later work.
//
// Built with -fmad=false (_build.SOURCE_FLAGS): the GATHER and padded
// kernels are compiled separately, and with multiply-add contraction each
// may fuse different products, parting in the last bit; without it they
// make the same IEEE operations and agree bitwise on the disk layout.
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
  NodePtrs node[kMaxNodes];
};

// halo sources (the entry point's ``halo`` argument)
constexpr int kPadded = 0;
constexpr int kGather = 1;    // x1/x2 strips, x3 wrapped
constexpr int kGather6 = 2;   // x1/x2/x3 strips

// Unpacks the caller's arrays (ptrs: dt, then kNodePtrs pointers per node
// in NodePtrs order); false when their layout differs from this build's,
// the node count is out of range, or a node's x3 strips disagree with the
// halo source.
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
  for (int k = 0; k < nnodes; ++k) {
    memcpy(&p->node[k], ptrs + 1 + kNodePtrs * k, sizeof(NodePtrs));
    const NodePtrs& nd = p->node[k];
    if ((halo == kGather6) != (nd.sz_lo != nullptr && nd.sz_hi != nullptr)) return false;
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

  // Primitive c at (k, j, i).  GATHER sources every halo cell as
  // stage_curv_gather and _stage_kernel_curv_gather6 assemble their slabs,
  // by precedence x1 strip > x2 strip > x3 strip > interior: x1 ghosts (any
  // y, z) from the x1 strips over the padded y and z extents; x2 ghosts
  // (interior x, any z) from the x2 strips over the padded z extent; x3
  // ghosts (interior x and y) from the x3 strips when they are given, else
  // from the interior with x3 wrapped (nz >= g3).  Corners read by the
  // viscous stencil thus come from the higher-precedence strip; the ic
  // caches the strips are cut from agree wherever two of them overlap.
  __device__ __forceinline__ T W(int c, int k, int j, int i) const {
    const int nx = n.nx, ny = n.ny, nz = n.nz;
    if (GATHER) {
      const int64_t zp = nz + 2 * n.g3, yp = ny + 2 * n.g2;
      if (i < 0 || i >= nx) {
        const T* s = at(i < 0 ? nd.sx_lo : nd.sx_hi);
        const int ii = i < 0 ? i + n.g1 : i - nx;
        return s[((c * zp + (k + n.g3)) * yp + (j + n.g2)) * n.g1 + ii];
      }
      if (j < 0 || j >= ny) {
        const T* s = at(j < 0 ? nd.sy_lo : nd.sy_hi);
        const int jj = j < 0 ? j + n.g2 : j - ny;
        return s[((c * zp + (k + n.g3)) * n.g2 + jj) * nx + i];
      }
      if (k < 0 || k >= nz) {
        if (nd.sz_lo != nullptr) {
          const T* s = at(k < 0 ? nd.sz_lo : nd.sz_hi);
          const int kk = k < 0 ? k + n.g3 : k - nz;
          return s[((int64_t(c) * n.g3 + kk) * ny + j) * nx + i];
        }
        k = k < 0 ? k + nz : k - nz;
      }
      return at(nd.w)[((int64_t(c) * nz + k) * ny + j) * nx + i];
    }
    const int64_t xp = nx + 2 * n.g1, yp = ny + 2 * n.g2, zp = nz + 2 * n.g3;
    return at(nd.w)[((c * zp + (k + n.g3)) * yp + (j + n.g2)) * xp + (i + n.g1)];
  }

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

// The diffusion coefficient (mu_model) of model ``kind`` at cell (k, j, i).
template <typename T, bool GATHER>
__device__ __forceinline__ T mu_model(const Ctx<T, GATHER>& C, int kind, const double (&q)[6],
                                      int k, int j, int i) {
  const CurvIdx& ix = C.ix;
  const int I = i + C.n.g1, J = j + C.n.g2, K = k + C.n.g3;
  const T rho = C.W(0, k, j, i);
  const T sie = C.W(5, k, j, i);
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

// Velocity divergence at cell (k, j, i) (jnp _divu, factored A/V).
template <typename T, bool GATHER>
__device__ __forceinline__ T divv(const Ctx<T, GATHER>& C, int k, int j, int i) {
  const CurvIdx& ix = C.ix;
  const int I = i + C.n.g1, J = j + C.n.g2, K = k + C.n.g3;
  const T v1 = C.W(1, k, j, i);
  T dv = (C.X(ix.upd1_facep, I) * (v1 + C.W(1, k, j, i + 1)) -
          C.X(ix.upd1_face, I) * (v1 + C.W(1, k, j, i - 1))) *
         C.X(ix.upd1_iv, I) * (C.Y(ix.upd_t2[0], J) * C.Z(ix.upd_t3[0], K));
  const T v2 = C.W(2, k, j, i);
  dv = dv + (C.Y(ix.upd2_facep, J) * (v2 + C.W(2, k, j + 1, i)) -
             C.Y(ix.upd2_face, J) * (v2 + C.W(2, k, j - 1, i))) *
                C.Y(ix.upd2_iv, J) * (C.X(ix.upd_t1[1], I) * C.Z(ix.upd_t3[1], K));
  if (C.n.nz > 1) {
    const T v3 = C.W(3, k, j, i);
    dv = dv + (C.Z(ix.upd3_facep, K) * (v3 + C.W(3, k + 1, j, i)) -
               C.Z(ix.upd3_face, K) * (v3 + C.W(3, k - 1, j, i))) *
                  C.Z(ix.upd3_iv, K) * (C.X(ix.upd_t1[2], I) * C.Y(ix.upd_t2[2], J));
  }
  return dv * T(0.5);
}

// Diagonal connection source src_d = v^k dh_d/dx_k at a cell.
template <typename T, bool GATHER, int D>
__device__ __forceinline__ T conn_src(const Ctx<T, GATHER>& C, int k, int j, int i) {
  if (D == 1) return T(0);
  const T s = C.vcon(0, k, j, i) * C.X(C.ix.conn1[D - 1], i + C.n.g1);
  if (D == 2) return s;
  return s + C.vcon(1, k, j, i) * C.Y(C.ix.conn2, j + C.n.g2);
}

// Transverse gradient of v^(D) along COMP at a cell.
template <typename T, bool GATHER, int D, int COMP>
__device__ __forceinline__ T trans_grad(const Ctx<T, GATHER>& C, int k, int j, int i) {
  constexpr int ci = COMP == 1, cj = COMP == 2, ck = COMP == 3;
  const CurvIdx& ix = C.ix;
  return (C.vcon(D - 1, k + ck, j + cj, i + ci) - C.vcon(D - 1, k - ck, j - cj, i - ci)) *
         C.inv_dist(ix.d2_1, ix.d2_2, ix.d2_3, COMP, k, j, i);
}

template <typename T>
__device__ __forceinline__ T face_avg(bool harmonic, T lo, T hi) {
  return harmonic ? T(2) * lo * hi / (lo + hi) : T(0.5) * (lo + hi);
}

// Off-diagonal stress row COMP of the viscous flux through the face along D
// between A = (ka, ja, ia) (below) and B = (k, j, i) (above).
template <typename T, bool GATHER, int D, int COMP>
__device__ __forceinline__ T visc_offdiag(const Ctx<T, GATHER>& C, int k, int j, int i,
                                          int ka, int ja, int ia, T i1r, T hdfmus) {
  const CurvIdx& ix = C.ix;
  const int I = i + C.n.g1, J = j + C.n.g2;
  const T t = (C.vcon(COMP - 1, k, j, i) - C.vcon(COMP - 1, ka, ja, ia)) * i1r;
  const T ratio = sq(C.X(ix.fh_1[D - 1][COMP - 1], I) / C.X(ix.fh_1[D - 1][D - 1], I)) *
                  sq(C.Y(ix.fh_2[D - 1][COMP - 1], J) / C.Y(ix.fh_2[D - 1][D - 1], J));
  T tt = T(0);
  if (COMP != 3 || C.n.nz > 1)
    tt = T(0.5) * (trans_grad<T, GATHER, D, COMP>(C, k, j, i) +
                   trans_grad<T, GATHER, D, COMP>(C, ka, ja, ia));
  return hdfmus * (tt + ratio * t);
}

// Diffusive flux rows (m1, m2, m3, energy) through the face along D whose
// upper cell is (k, j, i).  Not inlined: each thread calls it twice per
// direction, and one body per direction keeps the build short.
template <typename T, bool GATHER, int D>
__device__ __noinline__ void diff_face(const Ctx<T, GATHER>& C, int k, int j, int i,
                                          T (&F)[4]) {
  const CurvIdx& ix = C.ix;
  const int ka = k - (D == 3), ja = j - (D == 2), ia = i - (D == 1);
  const int I = i + C.n.g1, J = j + C.n.g2;
  const T i1r = C.inv_dist(ix.d1_1, ix.d1_2, ix.d1_3, D, k, j, i);
  F[0] = F[1] = F[2] = F[3] = T(0);
  if (C.n.visc >= 0) {
    const T mus = face_avg(C.n.visc_harm != 0, mu_model(C, C.n.visc, C.r.visc_p, ka, ja, ia),
                           mu_model(C, C.n.visc, C.r.visc_p, k, j, i));
    const T hdf = C.X(ix.fh_1[D - 1][D - 1], I) * C.Y(ix.fh_2[D - 1][D - 1], J);
    const T hdfmus = hdf * mus;
    // diagonal: 2 dv^d/dx_d + <v^k dh_d/dx_k> - (1/3)(1 - eta) div v
    const T t = T(2) * (C.vcon(D - 1, k, j, i) - C.vcon(D - 1, ka, ja, ia)) * i1r +
                T(0.5) * (conn_src<T, GATHER, D>(C, k, j, i) +
                          conn_src<T, GATHER, D>(C, ka, ja, ia));
    const T bulk = T((1.0 / 3.0) * (1.0 - C.r.visc_p[1]));
    F[D - 1] = hdfmus * (t - bulk * (divv(C, k, j, i) + divv(C, ka, ja, ia)));
    constexpr int o1 = D == 1 ? 2 : 1;
    constexpr int o2 = D == 3 ? 2 : 3;
    F[o1 - 1] = visc_offdiag<T, GATHER, D, o1>(C, k, j, i, ka, ja, ia, i1r, hdfmus);
    F[o2 - 1] = visc_offdiag<T, GATHER, D, o2>(C, k, j, i, ka, ja, ia, i1r, hdfmus);
    // energy: v.T with face-averaged contravariant velocities
    T fen = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      fen = fen + T(0.5) * (C.vcon(c, k, j, i) + C.vcon(c, ka, ja, ia)) * F[c];
    F[3] = fen;
  }
  if (C.n.cond >= 0) {
    const T kc = face_avg(C.n.cond_harm != 0, mu_model(C, C.n.cond, C.r.cond_p, ka, ja, ia),
                          mu_model(C, C.n.cond, C.r.cond_p, k, j, i));
    const T icv = T(1.0 / C.r.cv);
    F[3] = F[3] + kc * (C.W(5, k, j, i) * icv - C.W(5, ka, ja, ia) * icv) * i1r;
  }
}

// Accumulates the diffusive divergence of direction D into ddv (rows m1,
// m2, m3, energy) and returns the cell average of its diagonal row.
template <typename T, bool GATHER, int D>
__device__ __forceinline__ T diff_axis(const Ctx<T, GATHER>& C, int k, int j, int i,
                                       T af_lo, T af_hi, T cfac, T (&ddv)[4]) {
  T Flo[4], Fhi[4];
  diff_face<T, GATHER, D>(C, k, j, i, Flo);
  diff_face<T, GATHER, D>(C, k + (D == 3), j + (D == 2), i + (D == 1), Fhi);
#pragma unroll
  for (int q = 0; q < 4; ++q) ddv[q] = ddv[q] + (Flo[q] * af_lo - Fhi[q] * af_hi) * cfac;
  return T(0.5) * (Flo[D - 1] + Fhi[D - 1]);
}

// ---------------------------------------------------------------------------
// the whole stage for one cell
// ---------------------------------------------------------------------------

// Writes node ``nd``'s u_out (and, FULL, w_out) at interior cell ``cell``
// (flat index into [nz, ny, nx]); returns its CFL denominator (FULL) or 0.
template <typename T, bool GATHER, bool FULL>
__device__ __forceinline__ T curv_cell(const CurvParams& p, const NodePtrs& nd, int64_t cell) {
  const Ctx<T, GATHER> C(p, nd);
  const CurvInts& n = p.n;
  const CurvReals& r = p.r;
  const CurvIdx& ix = n.ix;
  const int nx = n.nx, ny = n.ny, nz = n.nz;
  const int64_t ncell = int64_t(nx) * ny * nz;
  const bool az = nz > 1;
  const int i = int(cell % nx);
  const int j = int((cell / nx) % ny);
  const int k = int(cell / (int64_t(nx) * ny));
  const int I = i + n.g1, J = j + n.g2, K = k + n.g3;
  const T half = T(0.5);

  // ---- fluxes
  T Fx[2][6], Fy[2][6], Fz[2][6];
  T px[2], vx[2], py[2], vy[2], pz[2] = {T(0), T(0)}, vz[2] = {T(0), T(0)};
  axis_flux<T, GATHER, 1>(C, k, j, i, Fx, px, vx);
  axis_flux<T, GATHER, 2>(C, k, j, i, Fy, py, vy);
  if (az) axis_flux<T, GATHER, 3>(C, k, j, i, Fz, pz, vz);

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
  const T* u0 = static_cast<const T*>(nd.u0);
  const T* u1 = static_cast<const T*>(nd.u1);
  T u[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T dv = (Fx[0][c] * af1 - Fx[1][c] * af1p) * c1;
    dv = dv + (Fy[0][c] * af2 - Fy[1][c] * af2p) * c2;
    if (az) dv = dv + (Fz[0][c] * af3 - Fz[1][c] * af3p) * c3;
    u[c] = rk_blend(r.gam0, r.gam1, u0, u1, c * ncell + cell, bdt * dv);
  }

  // ---- pressure-gradient + PdV flux sources
  u[1] = u[1] + bdt * C.X(ix.idx1, I) * (px[0] - px[1]);
  u[2] = u[2] + bdt * C.Y(ix.idx2, J) * (py[0] - py[1]);
  u[5] = u[5] - bdt * half * (px[0] + px[1]) * (vx[1] * af1p - vx[0] * af1) * c1;
  u[5] = u[5] - bdt * half * (py[0] + py[1]) * (vy[1] * af2p - vy[0] * af2) * c2;
  if (az) {
    u[3] = u[3] + bdt * C.Z(ix.idx3, K) * (pz[0] - pz[1]);
    u[5] = u[5] - bdt * half * (pz[0] + pz[1]) * (vz[1] * af3p - vz[0] * af3) * c3;
  }

  // ---- connection sources (curvilinear momenta), rotation velocity included
  if (n.x1dep || n.x2dep) {
    const T rho_w = C.W(0, k, j, i);
    T vt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vt[c] = C.W(1 + c, k, j, i);
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
    T rdivf = (Fx[0][0] * af1 * wrow(0, false) + Fx[1][0] * af1p * wrow(0, true)) * c1;
    rdivf = rdivf + (Fy[0][0] * af2 * wrow(1, false) + Fy[1][0] * af2p * wrow(1, true)) * c2;
    T favg[3] = {half * (Fx[0][0] + Fx[1][0]), half * (Fy[0][0] + Fy[1][0]), T(0)};
    if (az) {
      rdivf = rdivf + (Fz[0][0] * af3 * wrow(2, false) + Fz[1][0] * af3p * wrow(2, true)) * c3;
      favg[2] = half * (Fz[0][0] + Fz[1][0]);
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
    const T rho_g = C.W(0, k, j, i);
    T vdotg = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (n.grav == 2) {
        const T g_c = gmag * rv[c];
        u[1 + c] = u[1 + c] + gdt * rho_g * g_c;
        vdotg = vdotg + C.W(1 + c, k, j, i) * g_c;
      } else {
        const T hx = C.X(ix.hv_1[c], I) * C.Y(ix.hv_2[c], J);
        const T rh = C.X(ix.rhat_1[c], I) * C.Y(ix.rhat_2[c], J);
        const T zh = C.X(ix.zhat_1[c], I) * C.Y(ix.zhat_2[c], J);
        const T g_c = gmag * (Rc * rh + zc * zh);
        u[1 + c] = u[1 + c] + gdt * rho_g * hx * g_c;
        vdotg = vdotg + C.W(1 + c, k, j, i) * g_c;
      }
    }
    u[4] = u[4] + gdt * rho_g * vdotg;
  }

  // ---- viscous/thermal diffusion (DiffusionUpdateImpl)
  const bool visc = n.visc >= 0;
  const bool diff = visc || n.cond >= 0;
  T den_diff = T(0);
  if (diff) {
    T ddv[4] = {T(0), T(0), T(0), T(0)};
    diff_axis<T, GATHER, 1>(C, k, j, i, af1, af1p, c1, ddv);
    const T diag2 = diff_axis<T, GATHER, 2>(C, k, j, i, af2, af2p, c2, ddv);
    T diag3 = T(0);
    if (az) diag3 = diff_axis<T, GATHER, 3>(C, k, j, i, af3, af3p, c3, ddv);
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
      heat = heat + bdt * (ddv[0] * C.W(1, k, j, i) * C.inv_h(0, I, J) +
                           ddv[1] * C.W(2, k, j, i) * C.inv_h(1, I, J) +
                           ddv[2] * C.W(3, k, j, i) * C.inv_h(2, I, J));
    u[5] = u[5] + heat;

    if (FULL) {
      // diffusive CFL denominator 2 ndim nu_eff / min_dx^2
      T imd = vmax(C.X(ix.invw_1[0], I) * C.Y(ix.invw_2[0], J),
                   C.X(ix.invw_1[1], I) * C.Y(ix.invw_2[1], J));
      if (az)
        imd = vmax(imd, C.X(ix.invw_1[2], I) * C.Y(ix.invw_2[2], J) * C.Z(ix.inv_dx3, K));
      const T rho_i = C.W(0, k, j, i);
      const T ndim2 = T(az ? 6 : 4);
      if (visc) {
        const double eta = r.visc_p[1];
        const T m = mu_model(C, n.visc, r.visc_p, k, j, i) *
                    T(1.0 + (eta > 1.0 ? eta - 1.0 : 0.0)) / rho_i;
        den_diff = vmax(den_diff, ndim2 * m * imd * imd);
      }
      if (n.cond >= 0) {
        T m = mu_model(C, n.cond, r.cond_p, k, j, i);
        if (n.cond == kCondPlaw) m = m / (rho_i * T(r.cv));
        den_diff = vmax(den_diff, ndim2 * m * imd * imd);
      }
    }
  }

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

// ---- CUDA-only below: the kernel, its launch and the C entry point.
// Everything above also compiles as host C++: tests/test_torch_stage_curv.py
// builds it with g++ behind a few macros, loops curv_cell over the cells
// and holds the result against the plain version on the CPU.

constexpr int kBlock = 128;

// The launch's parameters are a __grid_constant__ kernel argument: uniform
// across threads, read from the constant bank, and addressable in place
// (diff_face takes references into them, and blockIdx.y picks the node's
// row of the table) without a per-thread copy.  blockIdx.x walks one
// node's cells, blockIdx.y the nodes: a one-node launch is the N = 1 case.
template <typename T, bool GATHER, bool FULL>
__global__ void __launch_bounds__(kBlock)
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

template <typename T>
cudaError_t launch_t(const CurvParams& p, int gather, int full, cudaStream_t s) {
  if (gather) return full ? launch<T, true, true>(p, s) : launch<T, true, false>(p, s);
  return full ? launch<T, false, true>(p, s) : launch<T, false, false>(p, s);
}

}  // namespace

// dtype: 0 float32, 1 float64 (a build with -DARTEMIS_CURV_DTYPE=0 or 1
// carries that type only; the wrapper builds the two in parallel).  halo:
// kPadded (a padded array), kGather (interior + x1/x2 strips, x3 wrapped)
// or kGather6 (interior + the six face strips).  nnodes: 1..kMaxNodes
// nodes of one grid shape sharing ints, reals and dt.  ptrs: dt, then
// kNodePtrs pointers per node in NodePtrs order, the x3 strips (the last
// two) given exactly for kGather6.  full: 1 whole stage, 0 partial.
// block must equal the kernel's block size (one dtden entry per block and
// node).  Returns a cudaError_t (0 on success).
extern "C" int artemis_stage_curv(int dtype, int halo, int full,
                                  const int* ints, const double* reals,
                                  const void* const* ptrs, int nptrs, int nnodes,
                                  int block, void* stream) {
  CurvParams p;
  if (block != kBlock || halo < kPadded || halo > kGather6 ||
      !make_params(halo, ints, reals, ptrs, nptrs, nnodes, &p))
    return int(cudaErrorInvalidValue);
  const int gather = halo != kPadded;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(ARTEMIS_CURV_DTYPE) || ARTEMIS_CURV_DTYPE == 0
  if (dtype == 0) return int(launch_t<float>(p, gather, full, s));
#endif
#if !defined(ARTEMIS_CURV_DTYPE) || ARTEMIS_CURV_DTYPE == 1
  if (dtype == 1) return int(launch_t<double>(p, gather, full, s));
#endif
  return int(cudaErrorInvalidValue);
}
