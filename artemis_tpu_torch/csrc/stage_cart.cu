// Fused Cartesian gas-hydro RK stage for Hopper (sm_90a).
//
// What it replaces: the two TPU Pallas kernels of
// artemis_tpu/ops/pallas_stage.py,
//   stage_periodic -> _stage_kernel_periodic (:452, :337), halos wrapped
//                     in-kernel from the unpadded interior   (PERIODIC=true)
//   stage          -> _stage_kernel          (:232, :132), halos read from
//                     ghost-padded primitives                (PERIODIC=false)
// with _lr_faces (pallas_stage.py:91); the helpers _plm/_hllc
// (pallas_sweeps.py:26,34) and rk_blend (:47) live in stage_common.cuh.
// On the TPU the two variants
// differ only in how Mosaic's DMA rules let a block fetch its halo; here a
// thread reads its halo by index, so one kernel templated on the halo
// source covers both.
//
// What it computes, per interior cell: PCM/PLM/PPM4 face states and HLLC
// fluxes on its 2*ndim faces; the two-register update
// gam0*u0 + gam1*u1 + bdt*divF (u0 is not read when gam0 == 0, u1 not when
// gam1 == 0); the Cartesian pressure-gradient and PdV sources; the
// dual-energy sync; C2P/P2C with floors; and the per-block maximum of the
// CFL denominator sum_d (|v_d| + cs) / dx_d (dtden).
//
// What bounds it on the H100: per zone-stage it reads w, u0, u1 and writes
// u, w: about 100 B in f32 (200 B in f64) of compulsory HBM traffic, 24 B
// less when gam0 == 0 (0.27 ms for the 256x256x128 f32 flagship at 3.35
// TB/s).  It does of order 1e3 floating-point operations per cell, some
// twenty of them IEEE divisions and square roots that cost several
// instructions each, so it is bound by instruction issue and latency
// rather than by HBM; PERF.md records what the card measured.
//
// Two bodies.  The per-cell body (stage_cart_kernel, one thread per cell
// in flat 256-thread blocks) solves every face twice, identically, by the
// two threads that share it, and loads its (2R+1)-point stencil per axis
// through L1/L2.  It is reached only through the wrapper's measurement
// switch.  Every launch of the wrapper takes the tiled body
// (stage_cart_tiled_kernel): a block owns a TX x TY footprint of columns
// (32 x 8; 32 x 4 in f64) and marches up a chunk of TZ = 16 planes.  Each
// plane of primitives, with its x/y halo of R (1, 2, 3 for PCM, PLM, PPM),
// is staged once into a ring of planes in shared memory by cp.async while
// the plane below is computed: a row of the footprint is one run of its
// source (the padded array; the interior, where it does not wrap),
// copied 16 bytes at a time where aligned, the wrapped halo by element.
// But in f32 PPM, the registers u0, u1 of the plane are staged the same
// way, so the update waits on no load from device memory.  Each cell's
// face values are reconstructed once per axis, each x and y face solved
// once into shared memory (fluxes, face pressure and velocity), and each z
// face once by its column's thread, carried in registers as the lower face
// of the plane above.  The update, sources, C2P/P2C and CFL denominator
// (cell_finish), the reconstruction (cell_faces) and the Riemann solver
// are the per-cell body's own code, summed in its order, so the two agree
// bitwise (both build with -fmad=false: _build.SOURCE_FLAGS).  Two
// barriers per plane: the faces (B), then the cells and the next plane's
// face values (C).  The ring holds the 2R - 1 planes the z stencil spans
// (the upper face value of the cell below is carried in registers), and
// where shared memory allows one more, so that the next plane lands during
// B and C, not C alone.  The shared memory of a block (TileLayout::BYTES)
// lets two blocks share an SM in f32 and, but for PPM, in f64; the launch
// bound holds the registers to that.  So an SM holds 16 warps (8 in f64,
// 4 in f64 PPM), and the body is bound by the latency of each plane's
// chains of divisions and roots (PERF.md has the measured split).
//
// Binding: a plain C entry point (artemis_stage_cart) called through
// ctypes.  It launches on the caller's stream, reads dt from device memory
// (bdt = beta * dt[0] is formed here, so the stage needs no host sync),
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_common.cuh"

namespace {

using namespace artemis;

constexpr int kPCM = 0;
constexpr int kPLM = 1;
constexpr int kPPM = 2;

struct Params {
  const void* w;     // PERIODIC: [6, nz, ny, nx]; else [6, nz+2g3, ny+2g2, nx+2g1]
  const void* u0;    // [6, nz, ny, nx] (unused when gam0 == 0)
  const void* u1;    // [6, nz, ny, nx] (unused when gam1 == 0)
  const void* dt;    // one element
  void* u_out;       // [6, nz, ny, nx]
  void* w_out;       // [6, nz, ny, nx]
  void* dmax;        // [gridDim.x]
  int nx, ny, nz;
  int g1, g2, g3;
  double gam0, gam1, beta;
  double idx, idy, idz;
  double gamma, dfloor, siefloor, de_switch;
};

// Primitive source: interior array with periodic wrap, or padded array.
template <typename T, bool PERIODIC>
struct Src {
  const T* __restrict__ w;
  int nx, ny, nz, g1, g2, g3;
  int64_t sy, sz, sc;
  __device__ __forceinline__ explicit Src(const Params& p)
      : w(static_cast<const T*>(p.w)), nx(p.nx), ny(p.ny), nz(p.nz), g1(p.g1), g2(p.g2),
        g3(p.g3) {
    const int64_t xs = PERIODIC ? nx : nx + 2 * g1;
    const int64_t ys = PERIODIC ? ny : ny + 2 * g2;
    const int64_t zs = PERIODIC ? nz : nz + 2 * g3;
    sy = xs;
    sz = xs * ys;
    sc = xs * ys * zs;
  }
  __device__ __forceinline__ int64_t at(int c, int k, int j, int i) const {
    if (PERIODIC) {
      i = wrap(i, nx);
      j = wrap(j, ny);
      k = wrap(k, nz);
    } else {
      i += g1;
      j += g2;
      k += g3;
    }
    return c * sc + k * sz + j * sy + i;
  }
  __device__ __forceinline__ T operator()(int c, int k, int j, int i) const {
    return w[at(c, k, j, i)];
  }
  // at() for the tiled body's staging, whose periodic indices mostly lie
  // inside the box: the wrap's division only for those that do not
  __device__ __forceinline__ int64_t at_near(int c, int k, int j, int i) const {
    if (!PERIODIC) return at(c, k, j, i);
    const auto near = [](int q, int n) { return unsigned(q) < unsigned(n) ? q : wrap(q, n); };
    return c * sc + near(k, nz) * sz + near(j, ny) * sy + near(i, nx);
  }
  // Are cells i .. i + n - 1 of a row one run of the array (no wrap, no
  // step past the row's end)?
  __device__ __forceinline__ bool run(int i, int n) const {
    return PERIODIC ? (i >= 0 && i + n <= nx) : (i + g1 >= 0 && i + n <= nx + g1);
  }
};

// The lower (lo) and upper (up) face values of one component of the cell
// whose stencil ``q(o)`` gives at offsets o = -(R-1)..R-1 (the _lr_faces
// reconstruction of one cell): both bodies reconstruct through here.
template <typename T, int METHOD, class Q>
__device__ __forceinline__ void cell_faces(const Q& q, T& lo, T& up) {
  if (METHOD == kPCM) {
    lo = up = q(0);
  } else if (METHOD == kPLM) {
    const T q0 = q(0);
    const T dq = plm_slope(q(-1), q0, q(1));
    lo = q0 - dq;
    up = q0 + dq;
  } else {
    // PPM4 (Colella & Woodward): limited left/right interface values
    const T qm2 = q(-2), qm1 = q(-1), q0 = q(0), qp1 = q(1), qp2 = q(2);
    T l = (T(7) * (q0 + qm1) - (qm2 + qp1)) / T(12);
    T r = (T(7) * (q0 + qp1) - (qm1 + qp2)) / T(12);
    l = vmin(vmax(l, vmin(q0, qm1)), vmax(q0, qm1));
    r = vmin(vmax(r, vmin(q0, qp1)), vmax(q0, qp1));
    const T qc = r - q0;
    const T qd = l - q0;
    const bool flat = (qc * qd) >= T(0);
    const T aqc = fabs(qc), aqd = fabs(qd);
    up = flat ? q0 : (aqc >= T(2) * aqd ? q0 - T(2) * qd : r);
    lo = flat ? q0 : (aqd >= T(2) * aqc ? q0 - T(2) * qc : l);
  }
}

// Face states of one component on the lower and upper faces of the centre
// cell of the stencil line q[0..2R] (centre at q[R]).  Face f sits between
// cells f-1 and f: wl is the upper value of the cell below, wr the lower
// value of the cell above (the _lr_faces convention).
template <typename T, int METHOD, int R>
__device__ __forceinline__ void face_states(const T (&q)[2 * R + 1], T& wl_lo,
                                            T& wr_lo, T& wl_hi, T& wr_hi) {
  T lo[3], up[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    cell_faces<T, METHOD>([&](int o) { return q[R + m - 1 + o]; }, lo[m], up[m]);
  wl_lo = up[0];
  wr_lo = lo[1];
  wl_hi = up[1];
  wr_hi = lo[2];
}

// Fluxes through the lower and upper faces of cell (k, j, i) along D;
// accumulates (F_lo - F_hi) * id into divf and returns the face pressures
// and velocities for the flux sources.
template <typename T, int METHOD, bool PERIODIC, int D>
__device__ __forceinline__ void axis_fluxes(const Src<T, PERIODIC>& src, int k,
                                            int j, int i, double gamma, T id,
                                            bool first, T (&divf)[6],
                                            T (&pf)[2], T (&vf)[2]) {
  constexpr int R = METHOD == kPPM ? 3 : (METHOD == kPLM ? 2 : 1);
  constexpr int di = D == 1, dj = D == 2, dk = D == 3;
  T wl_lo[6], wr_lo[6], wl_hi[6], wr_hi[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T q[2 * R + 1];
#pragma unroll
    for (int o = -R; o <= R; ++o) q[o + R] = src(c, k + o * dk, j + o * dj, i + o * di);
    face_states<T, METHOD, R>(q, wl_lo[c], wr_lo[c], wl_hi[c], wr_hi[c]);
  }
  T Flo[6], Fhi[6];
  hllc<T, D>(wl_lo, wr_lo, gamma, Flo, pf[0], vf[0]);
  hllc<T, D>(wl_hi, wr_hi, gamma, Fhi, pf[1], vf[1]);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T t = (Flo[c] - Fhi[c]) * id;
    divf[c] = first ? t : divf[c] + t;
  }
}

// The rest of the stage for one interior cell (flat index ``cell`` into
// [nz, ny, nx]) from its flux divergence and the pressures and velocities
// of its faces (pf, vf [axis][lower, upper]): the two-register RK blend
// (u0, u1 read at c * ustride + o), the pressure-gradient and PdV sources,
// the dual-energy sync, C2P/P2C with floors; writes u_out and w_out there
// and returns the cell's CFL denominator.  Both bodies finish a cell here.
template <typename T>
__device__ __forceinline__ T cell_finish(const Params& p, int64_t cell, const T (&divf)[6],
                                         const T (&pf)[3][2], const T (&vf)[3][2],
                                         const T* u0, const T* u1, int64_t ustride,
                                         int64_t o) {
  const int64_t n = int64_t(p.nx) * p.ny * p.nz;
  const bool active_z = p.nz > 1;
  const T idx = T(p.idx), idy = T(p.idy), idz = T(p.idz);

  // two-register RK blend (rk_blend): statically-zero registers unread
  const T bdt = T(p.beta) * static_cast<const T*>(p.dt)[0];
  T u[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) u[c] = rk_blend(p.gam0, p.gam1, u0, u1, c * ustride + o, bdt * divf[c]);

  // pressure-gradient force + PdV work (FluxSourceImpl, Cartesian)
  const T half = T(0.5);
  u[1] = u[1] + (bdt * idx) * (pf[0][0] - pf[0][1]);
  u[2] = u[2] + (bdt * idy) * (pf[1][0] - pf[1][1]);
  u[5] = u[5] - (bdt * idx) * half * (pf[0][0] + pf[0][1]) * (vf[0][1] - vf[0][0]);
  u[5] = u[5] - (bdt * idy) * half * (pf[1][0] + pf[1][1]) * (vf[1][1] - vf[1][0]);
  if (active_z) {
    u[3] = u[3] + (bdt * idz) * (pf[2][0] - pf[2][1]);
    u[5] = u[5] - (bdt * idz) * half * (pf[2][0] + pf[2][1]) * (vf[2][1] - vf[2][0]);
  }

  // dual-energy sync (SetAuxillaryFields)
  const T dfloor = T(p.dfloor), siefloor = T(p.siefloor);
  const T rho = vmax(u[0], dfloor);
  const T irho = T(1) / rho;
  const T ke = half * (u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) * irho;
  const T ue = u[4] - ke;
  T sie = ue > T(p.de_switch) * u[4] ? ue * irho : u[5] * irho;
  sie = vmax(sie, siefloor);
  u[5] = vmax(sie * rho, siefloor * rho);

  // C2P + P2C floor re-sync (fill_derived.cpp)
  const T v1 = u[1] * irho;
  const T v2 = u[2] * irho;
  const T v3 = u[3] * irho;
  sie = vmax(u[5] * irho, siefloor);
  const T pres = T(p.gamma - 1.0) * rho * sie;
  const T eint = sie * rho;
  const T etot = eint + half * rho * (v1 * v1 + v2 * v2 + v3 * v3);

  T* uo = static_cast<T*>(p.u_out);
  T* wo = static_cast<T*>(p.w_out);
  uo[0 * n + cell] = rho;
  uo[1 * n + cell] = rho * v1;
  uo[2 * n + cell] = rho * v2;
  uo[3 * n + cell] = rho * v3;
  uo[4 * n + cell] = etot;
  uo[5 * n + cell] = eint;
  wo[0 * n + cell] = rho;
  wo[1 * n + cell] = v1;
  wo[2 * n + cell] = v2;
  wo[3 * n + cell] = v3;
  wo[4 * n + cell] = pres;
  wo[5 * n + cell] = sie;

  // CFL denominator (EstimateTimestepMesh): dt = cfl / global max
  const T cs = sqrt(T(p.gamma * (p.gamma - 1.0)) * sie);
  T den = (fabs(v1) + cs) * idx + (fabs(v2) + cs) * idy;
  if (active_z) den = den + (fabs(v3) + cs) * idz;
  return den;
}

// The per-cell body: the whole stage for one interior cell (flat index
// ``cell`` into [nz, ny, nx]), its faces solved from stencil loads.
template <typename T, int METHOD, bool PERIODIC>
__device__ __forceinline__ T stage_cell(const Params& p, int64_t cell) {
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int64_t n = int64_t(nx) * ny * nz;
  const T idx = T(p.idx), idy = T(p.idy), idz = T(p.idz);
  const int i = int(cell % nx);
  const int j = int((cell / nx) % ny);
  const int k = int(cell / (int64_t(nx) * ny));
  const Src<T, PERIODIC> src(p);

  T divf[6];
  T pf[3][2], vf[3][2];
  axis_fluxes<T, METHOD, PERIODIC, 1>(src, k, j, i, p.gamma, idx, true, divf, pf[0], vf[0]);
  axis_fluxes<T, METHOD, PERIODIC, 2>(src, k, j, i, p.gamma, idy, false, divf, pf[1], vf[1]);
  if (nz > 1)
    axis_fluxes<T, METHOD, PERIODIC, 3>(src, k, j, i, p.gamma, idz, false, divf, pf[2], vf[2]);
  return cell_finish<T>(p, cell, divf, pf, vf, static_cast<const T*>(p.u0),
                        static_cast<const T*>(p.u1), n, cell);
}

// ---------------------------------------------------------------------------
// the tiled body (every main-path launch of K1 and K2)
// ---------------------------------------------------------------------------

// A block's footprint of columns (TX x TY), the planes of its z chunk (TZ),
// the blocks an SM is to hold (MINB, the launch bound), whether it stages
// the registers u0, u1 (UREG) and whether its ring has a slot more than
// the z stencil spans, so that a plane is asked for a phase earlier
// (AHEAD), per dtype and method, as the shared memory of MINB blocks
// allows (TileLayout).  f64 halves the footprint in y; f32 PPM's deeper
// ring leaves room for neither UREG nor AHEAD, and f64 PPM holds one block
// per SM, with both.
template <typename T, int METHOD>
struct TileDims {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int TX = 32, TY = F32 ? 8 : 4, TZ = 16;
  static constexpr int MINB = (!F32 && METHOD == kPPM) ? 1 : 2;
  static constexpr bool UREG = !(F32 && METHOD == kPPM);
  static constexpr bool AHEAD = METHOD == kPCM || (F32 ? METHOD == kPLM : METHOD == kPPM);
};

// Shared-memory layout of a block, in elements of T: the ring of NR
// primitive planes [NR][6][RY][RX] (the footprint's rows with a halo of
// H = R rows, each row the footprint's columns with H halo columns on
// either side, at a launch-wide column shift: TileMem::w), the x face
// values of cells -1..TX of each row, lower (xr) and upper (xl) [6][TY][TX
// + 2], the y face values [6][TY + 2][TX] (yr, yl), the solved x faces
// [8][TY][TX + 1] and y faces [8][TY + 1][TX] (6 fluxes, the face
// pressure, the face velocity), and (UREG) the plane's registers u0, u1
// [12][TY][TX].  The z face above plane k reads planes k + 1 - Q .. k + 1
// + Q (Q = R - 1, the reach of a cell's face values; the upper value of
// cell k is carried in registers), so the ring holds those 2Q + 1 planes,
// the next one landing in the slot of the lowest while the cells are
// updated (PCM: two slots, the plane read and the one landing), or with
// AHEAD one slot more, in which the next plane lands while the faces are
// solved and the cells updated.
template <typename T, int METHOD>
struct TileLayout {
  using D = TileDims<T, METHOD>;
  static constexpr int TX = D::TX, TY = D::TY, NT = TX * TY;
  static constexpr int H = METHOD == kPPM ? 3 : (METHOD == kPLM ? 2 : 1), Q = H - 1;
  static constexpr int NR = (2 * Q + 1 > 2 ? 2 * Q + 1 : 2) + (D::AHEAD ? 1 : 0);
  static constexpr int VEC = 16 / int(sizeof(T));
  static constexpr int RX = TX + 8, RY = TY + 2 * H, PLANE = 6 * RY * RX;
  static constexpr int XV = 6 * TY * (TX + 2), YV = 6 * (TY + 2) * TX;
  static constexpr int XF = 8 * TY * (TX + 1), YF = 8 * (TY + 1) * TX;
  static constexpr int UR = D::UREG ? 12 * NT : 0;
  static constexpr int ELEMS = NR * PLANE + 2 * XV + 2 * YV + XF + YF + UR;
  static constexpr int BYTES = ELEMS * int(sizeof(T));
  // MINB blocks on an SM's 228 KB, each with the 1 KB the runtime keeps
  static_assert(D::MINB * (BYTES + 1024) <= 233472, "MINB blocks do not fit an SM");
  static_assert(RX % VEC == 0 && PLANE % VEC == 0 &&
                    (NR * PLANE + 2 * XV + 2 * YV + XF + YF) % VEC == 0,
                "16-byte copies need aligned rows, planes and registers");
};

// Blocks of a launch: x tiles fastest, then y tiles, then z chunks.
template <typename T, int METHOD>
__host__ __device__ __forceinline__ int64_t tile_count(int nx, int ny, int nz) {
  using D = TileDims<T, METHOD>;
  return int64_t((nx + D::TX - 1) / D::TX) * ((ny + D::TY - 1) / D::TY) *
         ((nz + D::TZ - 1) / D::TZ);
}

struct TilePos {
  int x0, y0, z0, z1;  // footprint origin and the chunk's planes [z0, z1)
};

template <typename T, int METHOD>
__device__ __forceinline__ TilePos tile_pos(const Params& p, int64_t blk) {
  using D = TileDims<T, METHOD>;
  const int nbx = (p.nx + D::TX - 1) / D::TX, nby = (p.ny + D::TY - 1) / D::TY;
  TilePos t;
  t.x0 = int(blk % nbx) * D::TX;
  t.y0 = int((blk / nbx) % nby) * D::TY;
  t.z0 = int(blk / (int64_t(nbx) * nby)) * D::TZ;
  t.z1 = t.z0 + D::TZ < p.nz ? t.z0 + D::TZ : p.nz;
  return t;
}

// The shared-memory column of footprint column 0: at least H and, where
// the row's room allows, congruent to the source's column modulo a 16-byte
// chunk, so that a row's aligned 16-byte runs (a padded row starts g1
// cells before its interior) land on 16-byte chunks of shared memory.
template <typename T, int METHOD, bool PERIODIC>
__device__ __forceinline__ int tile_col0(int g1) {
  using L = TileLayout<T, METHOD>;
  const int s = PERIODIC ? 0 : g1 % L::VEC;
  const int a = L::H + ((s - L::H) % L::VEC + L::VEC) % L::VEC;
  return a + L::TX + L::H <= L::RX ? a : L::H;
}

template <typename T, int METHOD>
struct TileMem {
  using L = TileLayout<T, METHOD>;
  T *ring, *xl, *xr, *yl, *yr, *xf, *yf, *ureg;
  int a;  // tile_col0
  __device__ __forceinline__ TileMem(T* s, int a_)
      : ring(s), xl(s + L::NR * L::PLANE), xr(xl + L::XV), yl(xr + L::XV), yr(yl + L::YV),
        xf(yr + L::YV), yf(xf + L::XF), ureg(yf + L::YF), a(a_) {}
  // primitive c in ring slot s at footprint row y (-H..TY+H-1), column x
  __device__ __forceinline__ T& w(int s, int c, int y, int x) const {
    return ring[((s * 6 + c) * L::RY + y + L::H) * L::RX + a + x];
  }
  // face values of the cell at footprint row y, column ci - 1 (x faces),
  // and of the cell at row cj - 1, column x (y faces)
  __device__ __forceinline__ int xv(int c, int y, int ci) const {
    return (c * L::TY + y) * (L::TX + 2) + ci;
  }
  __device__ __forceinline__ int yv(int c, int cj, int x) const {
    return (c * (L::TY + 2) + cj) * L::TX + x;
  }
  // quantity q of x face f (the lower face of footprint column f) of row y,
  // and of y face f (the lower face of row f) of column x
  __device__ __forceinline__ T& fx(int q, int y, int f) const {
    return xf[(q * L::TY + y) * (L::TX + 1) + f];
  }
  __device__ __forceinline__ T& fy(int q, int f, int x) const {
    return yf[(q * (L::TY + 1) + f) * L::TX + x];
  }
};

// What a thread carries from plane to plane: the upper z face value of its
// column's cell below the next z face, the z faces below (bot) and above
// (top) the current plane (6 fluxes, pressure, velocity), and its running
// CFL maximum.
template <typename T>
struct TileThread {
  T zup[6], bot[8], top[8], den;
};

// Stages plane kk into ring slot s: the footprint's rows with their x halo
// and the y halo rows over the footprint's columns, each element read
// once; the corners, which no face reads, and cells past those the faces
// need (columns from nx + H, rows from ny + H) are left out.  The copies go
// by 16-byte chunks of a shared-memory row: a chunk whose cells are one run
// of the source row (no wrap) and 16-byte aligned there is one cp.async of
// 16 bytes past L1; any other is copied element by element (the wrapped
// halo, a misaligned row).
template <typename T, int METHOD, bool PERIODIC>
__device__ __forceinline__ void tile_load(const Src<T, PERIODIC>& src, const TileMem<T, METHOD>& m,
                                          const TilePos& tp, int s, int kk, int tid) {
  using L = TileLayout<T, METHOD>;
  constexpr int NQ = L::RX / L::VEC;
  const int xe = tp.x0 + L::TX < src.nx ? L::TX + L::H : src.nx + L::H - tp.x0;
  const int xi = tp.x0 + L::TX < src.nx ? L::TX : src.nx - tp.x0;
  const int ye = tp.y0 + L::TY < src.ny ? L::TY + L::H : src.ny + L::H - tp.y0;
  for (int e = tid; e < 6 * L::RY * NQ; e += L::NT) {
    const int c = e / (L::RY * NQ), y = (e / NQ) % L::RY - L::H, q = e % NQ;
    const bool foot = y >= 0 && y < L::TY;
    const int xa = foot ? -L::H : 0, xb = foot ? xe : xi;
    const int x = q * L::VEC - m.a;  // footprint column of the chunk's first element
    if (y >= ye || x + L::VEC <= xa || x >= xb) continue;
    T* dst = &m.w(s, c, y, x);
    const int j = tp.y0 + y;
    if (src.run(tp.x0 + x, L::VEC)) {
      const T* g = src.w + src.at_near(c, kk, j, tp.x0 + x);
      if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
        copy_async16(dst, g);
        continue;
      }
    }
#pragma unroll
    for (int v = 0; v < L::VEC; ++v)
      if (x + v >= xa && x + v < xb)
        copy_async(dst + v, src.w + src.at_near(c, kk, j, tp.x0 + x + v));
  }
}

// The registers u0, u1 of plane k over the footprint into ureg[f * NT + y *
// TX + x] (f = c for u0, 6 + c for u1; those read: gam0, gam1 != 0), 16
// bytes at a time where a row's chunk is whole and aligned.
template <typename T, int METHOD>
__device__ __forceinline__ void tile_load_u(const Params& p, const TileMem<T, METHOD>& m,
                                            const TilePos& tp, int k, int tid) {
  using L = TileLayout<T, METHOD>;
  constexpr int NV = L::TX / L::VEC;
  const int64_t n = int64_t(p.nx) * p.ny * p.nz;
  for (int e = tid; e < 12 * L::TY * NV; e += L::NT) {
    const int f = e / (L::TY * NV), y = (e / NV) % L::TY, v = e % NV;
    const int j = tp.y0 + y, i = tp.x0 + v * L::VEC;
    if (j >= p.ny || i >= p.nx || (f < 6 ? p.gam0 : p.gam1) == 0.0) continue;
    const T* row = static_cast<const T*>(f < 6 ? p.u0 : p.u1) + (f % 6) * n +
                   (int64_t(k) * p.ny + j) * p.nx + i;
    T* dst = &m.ureg[f * L::NT + y * L::TX + v * L::VEC];
    if (i + L::VEC <= p.nx && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
      copy_async16(dst, row);
    } else {
#pragma unroll
      for (int q = 0; q < L::VEC; ++q)
        if (i + q < p.nx) copy_async(dst + q, row + q);
    }
  }
}

// The x and y face values of every cell of ring slot s whose faces the
// footprint needs (cells -1..TX along x, -1..TY along y, up to the ghost
// cells nx, ny); the cells past one per thread fall to the first warp
// along x, to the last ones along y.
template <typename T, int METHOD>
__device__ __forceinline__ void tile_face_values(const Params& p, const TileMem<T, METHOD>& m,
                                                 const TilePos& tp, int s, int tid) {
  using L = TileLayout<T, METHOD>;
  for (int e = tid; e < L::TY * (L::TX + 2); e += L::NT) {
    const int y = e / (L::TX + 2), ci = e % (L::TX + 2), x = ci - 1;
    if (tp.x0 + x > p.nx || tp.y0 + y >= p.ny) continue;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      cell_faces<T, METHOD>([&](int o) { return m.w(s, c, y, x + o); }, m.xr[m.xv(c, y, ci)],
                            m.xl[m.xv(c, y, ci)]);
  }
  for (int e = L::NT - 1 - tid; e < (L::TY + 2) * L::TX; e += L::NT) {
    const int cj = e / L::TX, x = e % L::TX, y = cj - 1;
    if (tp.x0 + x >= p.nx || tp.y0 + y > p.ny) continue;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      cell_faces<T, METHOD>([&](int o) { return m.w(s, c, y + o, x); }, m.yr[m.yv(c, cj, x)],
                            m.yl[m.yv(c, cj, x)]);
  }
}

// Every x and y face of the footprint's plane, once each, from the staged
// face values into fx, fy (the extra x face column falls to the first
// warp, the extra y face row to the last).
template <typename T, int METHOD>
__device__ __forceinline__ void tile_solve(const Params& p, const TileMem<T, METHOD>& m,
                                           const TilePos& tp, int tid) {
  using L = TileLayout<T, METHOD>;
  for (int e = tid; e < L::TY * (L::TX + 1); e += L::NT) {
    const int y = e / (L::TX + 1), f = e % (L::TX + 1);
    if (tp.x0 + f > p.nx || tp.y0 + y >= p.ny) continue;
    T wl[6], wr[6], F[6], pf, vf;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      wl[c] = m.xl[m.xv(c, y, f)];
      wr[c] = m.xr[m.xv(c, y, f + 1)];
    }
    hllc<T, 1>(wl, wr, p.gamma, F, pf, vf);
#pragma unroll
    for (int c = 0; c < 6; ++c) m.fx(c, y, f) = F[c];
    m.fx(6, y, f) = pf;
    m.fx(7, y, f) = vf;
  }
  for (int e = L::NT - 1 - tid; e < (L::TY + 1) * L::TX; e += L::NT) {
    const int f = e / L::TX, x = e % L::TX;
    if (tp.x0 + x >= p.nx || tp.y0 + f > p.ny) continue;
    T wl[6], wr[6], F[6], pf, vf;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      wl[c] = m.yl[m.yv(c, f, x)];
      wr[c] = m.yr[m.yv(c, f + 1, x)];
    }
    hllc<T, 2>(wl, wr, p.gamma, F, pf, vf);
#pragma unroll
    for (int c = 0; c < 6; ++c) m.fy(c, f, x) = F[c];
    m.fy(6, f, x) = pf;
    m.fy(7, f, x) = vf;
  }
}

// The z face below the thread's column cell kk (at footprint column x, row
// y), whose lower neighbour's upper value is ``zup``: cell kk's face
// values from its planes in the ring (``slot``), the face solved into q (6
// fluxes, pressure, velocity), cell kk's upper value carried on in zup.
template <typename T, int METHOD, class Slot>
__device__ __forceinline__ void tile_zface(const Params& p, const TileMem<T, METHOD>& m,
                                           const Slot& slot, int kk, int x, int y, T (&zup)[6],
                                           T (&q)[8]) {
  T lo[6], up[6], F[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    cell_faces<T, METHOD>([&](int o) { return m.w(slot(kk + o), c, y, x); }, lo[c], up[c]);
  hllc<T, 3>(zup, lo, p.gamma, F, q[6], q[7]);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    q[c] = F[c];
    zup[c] = up[c];
  }
}

// One block of the tiled body, phase by phase: ``ex.each(f)`` runs f(tid,
// state) for every thread of the block and then synchronises it (on the
// card, each thread runs its own call between __syncthreads; the host
// build of the tests loops over the threads).  ``smem`` holds
// TileLayout<T, METHOD>::ELEMS elements.  A thread owns the column at
// footprint column tid % TX, row tid / TX.
template <typename T, int METHOD, bool PERIODIC, class Exec>
__device__ __forceinline__ void tile_block(const Params& p, int64_t blk, T* smem, Exec& ex) {
  using L = TileLayout<T, METHOD>;
  using St = TileThread<T>;
  const Src<T, PERIODIC> src(p);
  const TileMem<T, METHOD> m(smem, tile_col0<T, METHOD, PERIODIC>(p.g1));
  const TilePos tp = tile_pos<T, METHOD>(p, blk);
  const bool az = p.nz > 1;
  const int z0 = tp.z0;
  const auto slot = [&](int kk) { return (kk - z0 + L::H) % L::NR; };
  const auto own = [&](int tid) {
    return tp.x0 + tid % L::TX < p.nx && tp.y0 + tid / L::TX < p.ny;
  };

  // prologue: planes z0 - H .. z0 - H + NR - 1 (a 2-D grid: its plane);
  // the upper value of each column's cell z0 - 1; (without AHEAD: PLM,
  // PPM) plane z0 + Q in the slot of z0 - H; the z face below z0; then
  // plane z0 + H, unless it is there, lands while plane z0's face values
  // are made
  ex.each([&](int tid, St& st) {
    st.den = T(0);
    if (az) {
      for (int kk = z0 - L::H; kk < z0 - L::H + L::NR; ++kk) tile_load(src, m, tp, slot(kk), kk, tid);
    } else {
      tile_load(src, m, tp, slot(0), 0, tid);
    }
    copy_commit();
    copy_wait<0>();
  });
  if (az) {
    ex.each([&](int tid, St& st) {
      if (!own(tid)) return;
      T lo[6];
#pragma unroll
      for (int c = 0; c < 6; ++c)
        cell_faces<T, METHOD>(
            [&](int o) { return m.w(slot(z0 - 1 + o), c, tid / L::TX, tid % L::TX); }, lo[c],
            st.zup[c]);
    });
    if (L::NR < 2 * L::H)
      ex.each([&](int tid, St&) {
        tile_load(src, m, tp, slot(z0 + L::Q), z0 + L::Q, tid);
        copy_commit();
        copy_wait<0>();
      });
    ex.each([&](int tid, St& st) {
      if (own(tid)) tile_zface(p, m, slot, z0, tid % L::TX, tid / L::TX, st.zup, st.bot);
    });
  }
  ex.each([&](int tid, St&) {
    if (az && L::NR < 2 * L::H + 1) tile_load(src, m, tp, slot(z0 + L::H), z0 + L::H, tid);
    copy_commit();
    tile_face_values(p, m, tp, slot(z0), tid);
    copy_wait<0>();
  });

  // Two phases per plane k.  B: its x and y faces, and each column's z face
  // above it (from cell k + 1's planes), while (UREG) its registers land
  // in ureg.  C: its cells; then the face values of plane k + 1.  Plane k
  // + H + 1 lands in the slot of plane k + H + 1 - NR, during C (read last
  // in B) or, with AHEAD, during B and C (read last in the B before): the
  // registers and the plane are copy groups of their own, and B waits for
  // the registers only.
  for (int k = z0; k < tp.z1; ++k) {
    const bool next = az && k + 1 < tp.z1;
    ex.each([&](int tid, St& st) {
      if (L::D::UREG) tile_load_u(p, m, tp, k, tid);
      copy_commit();
      if (L::D::AHEAD && next) tile_load(src, m, tp, slot(k + L::H + 1), k + L::H + 1, tid);
      copy_commit();
      tile_solve(p, m, tp, tid);
      if (az && own(tid)) tile_zface(p, m, slot, k + 1, tid % L::TX, tid / L::TX, st.zup, st.top);
      copy_wait<1>();
    });
    ex.each([&](int tid, St& st) {
      if (!L::D::AHEAD && next) tile_load(src, m, tp, slot(k + L::H + 1), k + L::H + 1, tid);
      copy_commit();
      if (own(tid)) {
        const int x = tid % L::TX, y = tid / L::TX;
        const T idx = T(p.idx), idy = T(p.idy), idz = T(p.idz);
        T divf[6], pf[3][2], vf[3][2];
        // the per-cell body's sums in its order: x, then y, then z
#pragma unroll
        for (int c = 0; c < 6; ++c) divf[c] = (m.fx(c, y, x) - m.fx(c, y, x + 1)) * idx;
#pragma unroll
        for (int c = 0; c < 6; ++c) divf[c] = divf[c] + (m.fy(c, y, x) - m.fy(c, y + 1, x)) * idy;
        pf[0][0] = m.fx(6, y, x);
        pf[0][1] = m.fx(6, y, x + 1);
        vf[0][0] = m.fx(7, y, x);
        vf[0][1] = m.fx(7, y, x + 1);
        pf[1][0] = m.fy(6, y, x);
        pf[1][1] = m.fy(6, y + 1, x);
        vf[1][0] = m.fy(7, y, x);
        vf[1][1] = m.fy(7, y + 1, x);
        if (az) {
#pragma unroll
          for (int c = 0; c < 6; ++c) divf[c] = divf[c] + (st.bot[c] - st.top[c]) * idz;
          pf[2][0] = st.bot[6];
          pf[2][1] = st.top[6];
          vf[2][0] = st.bot[7];
          vf[2][1] = st.top[7];
        }
        const int64_t cell = (int64_t(k) * p.ny + tp.y0 + y) * p.nx + tp.x0 + x;
        const int64_t n = int64_t(p.nx) * p.ny * p.nz;
        const T den = L::D::UREG
            ? cell_finish<T>(p, cell, divf, pf, vf, m.ureg, m.ureg + 6 * L::NT, L::NT, tid)
            : cell_finish<T>(p, cell, divf, pf, vf, static_cast<const T*>(p.u0),
                             static_cast<const T*>(p.u1), n, cell);
        st.den = vmax(st.den, den);
#pragma unroll
        for (int q = 0; q < 8; ++q) st.bot[q] = st.top[q];
      }
      if (k + 1 < tp.z1) tile_face_values(p, m, tp, slot(k + 1), tid);
      copy_wait<0>();
    });
  }

  // the block's maximum of the CFL denominator (the x face area is free)
  T* red = m.xf;
  ex.each([&](int tid, St& st) { red[tid] = st.den; });
  for (int h = L::NT / 2; h > 0; h >>= 1)
    ex.each([&](int tid, St&) {
      if (tid < h) red[tid] = vmax(red[tid], red[tid + h]);
    });
  ex.each([&](int tid, St&) {
    if (tid == 0) static_cast<T*>(p.dmax)[blk] = red[0];
  });
}

// Entries of the dtden output: one per block of the body.
template <typename T>
inline int64_t dtden_len_t(int method, int tiled, int nx, int ny, int nz, int block) {
  if (!tiled) return (int64_t(nx) * ny * nz + block - 1) / block;
  if (method == kPCM) return tile_count<T, kPCM>(nx, ny, nz);
  if (method == kPLM) return tile_count<T, kPLM>(nx, ny, nz);
  return tile_count<T, kPPM>(nx, ny, nz);
}

// Does the launch describe a stage that both bodies take?  A padded array
// needs R ghost cells on each active axis (R = 1, 2, 3 for PCM, PLM, PPM),
// the per-cell body a power-of-two block of at most 256 threads, and the
// caller's dtden length must be the body's block count.
inline bool args_ok(int dtype, int method, int periodic, int tiled, int64_t ndmax, int nx, int ny,
                    int nz, int g1, int g2, int g3, int block) {
  if ((dtype != 0 && dtype != 1) || method < kPCM || method > kPPM || nx < 1 || ny < 1 ||
      nz < 1 || block <= 0 || block > 256 || (block & (block - 1)) != 0)
    return false;
  const int r = method + 1;
  if (!periodic && (g1 < r || g2 < r || (nz > 1 && g3 < r))) return false;
  return ndmax == (dtype == 0 ? dtden_len_t<float>(method, tiled, nx, ny, nz, block)
                              : dtden_len_t<double>(method, tiled, nx, ny, nz, block));
}

// ---- CUDA-only below: the kernels, their launches and the C entry point.
// Everything above also compiles as host C++: tests/test_torch_kernel.py
// builds it with g++ behind a few macros, loops stage_cell over the cells
// (the per-cell body) or tile_block over the blocks (the tiled body) and
// holds the two against each other and the plain version on the CPU.

template <typename T, int METHOD, bool PERIODIC>
__global__ void __launch_bounds__(256)
stage_cart_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int64_t n = int64_t(p.nx) * p.ny * p.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const T den = cell < n ? stage_cell<T, METHOD, PERIODIC>(p, cell) : T(0);

  // block maximum of the denominator (masked threads contribute 0)
  red[threadIdx.x] = den;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = vmax(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) static_cast<T*>(p.dmax)[blockIdx.x] = red[0];
}

template <typename T, int METHOD, bool PERIODIC>
cudaError_t launch(const Params& p, int block, cudaStream_t stream) {
  const int64_t n = int64_t(p.nx) * p.ny * p.nz;
  const unsigned nblk = unsigned((n + block - 1) / block);
  stage_cart_kernel<T, METHOD, PERIODIC>
      <<<nblk, block, size_t(block) * sizeof(T), stream>>>(p);
  return cudaGetLastError();
}

// The tiled body: one block per footprint and z chunk; each thread keeps
// its TileThread in registers.  The parameters are a __grid_constant__
// argument, addressable in place (the phases take them by reference)
// without a per-thread copy.
template <typename T>
struct DeviceExec {
  TileThread<T> st;
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f(int(threadIdx.x), st);
    __syncthreads();
  }
};

template <typename T, int METHOD, bool PERIODIC>
__global__ void __launch_bounds__((TileLayout<T, METHOD>::NT), (TileDims<T, METHOD>::MINB))
stage_cart_tiled_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  DeviceExec<T> ex;
  tile_block<T, METHOD, PERIODIC>(p, int64_t(blockIdx.x), reinterpret_cast<T*>(tile_smem), ex);
}

template <typename T, int METHOD, bool PERIODIC>
cudaError_t launch_tiled(const Params& p, cudaStream_t stream) {
  using L = TileLayout<T, METHOD>;
  // above 48 KB a block's dynamic shared memory is asked for, once; the
  // carveout leaves room for MINB blocks on an SM
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(stage_cart_tiled_kernel<T, METHOD, PERIODIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stage_cart_tiled_kernel<T, METHOD, PERIODIC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const unsigned nblk = unsigned(tile_count<T, METHOD>(p.nx, p.ny, p.nz));
  stage_cart_tiled_kernel<T, METHOD, PERIODIC><<<nblk, L::NT, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int METHOD, bool PERIODIC>
cudaError_t launch_body(const Params& p, int tiled, int block, cudaStream_t s) {
  return tiled ? launch_tiled<T, METHOD, PERIODIC>(p, s) : launch<T, METHOD, PERIODIC>(p, block, s);
}

template <typename T>
cudaError_t launch_t(const Params& p, int method, int periodic, int tiled, int block,
                     cudaStream_t s) {
  if (periodic) {
    if (method == kPCM) return launch_body<T, kPCM, true>(p, tiled, block, s);
    if (method == kPLM) return launch_body<T, kPLM, true>(p, tiled, block, s);
    return launch_body<T, kPPM, true>(p, tiled, block, s);
  }
  if (method == kPCM) return launch_body<T, kPCM, false>(p, tiled, block, s);
  if (method == kPLM) return launch_body<T, kPLM, false>(p, tiled, block, s);
  return launch_body<T, kPPM, false>(p, tiled, block, s);
}

}  // namespace

// dtype: 0 float32, 1 float64.  method: 0 pcm, 1 plm, 2 ppm.  periodic: 1
// the unpadded interior with its halo wrapped, 0 a padded array.  tiled: 1
// the tiled body, 0 the per-cell body in blocks of ``block`` threads (a
// power of two <= 256).  ndmax: the dtden entries the caller gave, which
// must be the body's block count.  Returns a cudaError_t (0 on success).
extern "C" int artemis_stage_cart(
    int dtype, int method, int periodic, int tiled, const void* w, const void* u0,
    const void* u1, const void* dt, void* u_out, void* w_out, void* dmax, int64_t ndmax,
    int nx, int ny, int nz, int g1, int g2, int g3, double gam0, double gam1,
    double beta, double idx, double idy, double idz, double gamma,
    double dfloor, double siefloor, double de_switch, int block,
    void* stream) {
  if (!args_ok(dtype, method, periodic, tiled, ndmax, nx, ny, nz, g1, g2, g3, block))
    return int(cudaErrorInvalidValue);
  Params p{w, u0, u1, dt, u_out, w_out, dmax, nx, ny, nz, g1, g2, g3,
           gam0, gam1, beta, idx, idy, idz, gamma, dfloor, siefloor,
           de_switch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_t<float>(p, method, periodic, tiled, block, s)
                                     : launch_t<double>(p, method, periodic, tiled, block, s);
  return int(err);
}
