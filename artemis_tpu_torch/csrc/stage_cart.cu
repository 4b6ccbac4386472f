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
// u, w — about 100 B in f32 (200 B in f64) of compulsory HBM traffic, 24 B
// less when gam0 == 0 — and does of order 1e3 floating-point operations,
// some twenty of them IEEE divisions and square roots that cost several
// instructions each.  At 3.35 TB/s against 67 TFLOP/s (f32) the ridge is
// about 20 flop/B, so the kernel is expected to be bound by instruction
// issue rather than by HBM; PERF.md records what the card measured.  The
// design's first cost is that one thread per cell recomputes its own
// faces, so every face is solved twice, identically, by the two threads
// that share it (conservation stays exact because both run the same code
// on the same inputs).  Stencil loads go through L1/L2, neighbouring
// threads reading neighbouring x cells.  Shared-memory face caching,
// tiling and TMA are later work.
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
  __device__ __forceinline__ T operator()(int c, int k, int j, int i) const {
    if (PERIODIC) {
      i = wrap(i, nx);
      j = wrap(j, ny);
      k = wrap(k, nz);
    } else {
      i += g1;
      j += g2;
      k += g3;
    }
    return w[c * sc + k * sz + j * sy + i];
  }
};

// Face states of one component on the lower and upper faces of the centre
// cell of the stencil line q[0..2R] (centre at q[R]).  Face f sits between
// cells f-1 and f: wl comes from the cell below, wr from the cell above
// (the _lr_faces convention).
template <typename T, int METHOD, int R>
__device__ __forceinline__ void face_states(const T (&q)[2 * R + 1], T& wl_lo,
                                            T& wr_lo, T& wl_hi, T& wr_hi) {
  if (METHOD == kPCM) {
    wl_lo = q[R - 1];
    wr_lo = q[R];
    wl_hi = q[R];
    wr_hi = q[R + 1];
  } else if (METHOD == kPLM) {
    T dqm[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) dqm[m] = plm_slope(q[R + m - 2], q[R + m - 1], q[R + m]);
    wl_lo = q[R - 1] + dqm[0];
    wr_lo = q[R] - dqm[1];
    wl_hi = q[R] + dqm[1];
    wr_hi = q[R + 1] - dqm[2];
  } else {
    // PPM4 (Colella & Woodward): limited left/right interface values of
    // cells -1, 0, +1; wl = qrv of the cell below, wr = qlv of the cell above
    T qlv[3], qrv[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int c = R + m - 1;
      const T qm2 = q[c - 2], qm1 = q[c - 1], q0 = q[c], qp1 = q[c + 1],
              qp2 = q[c + 2];
      T l = (T(7) * (q0 + qm1) - (qm2 + qp1)) / T(12);
      T r = (T(7) * (q0 + qp1) - (qm1 + qp2)) / T(12);
      l = vmin(vmax(l, vmin(q0, qm1)), vmax(q0, qm1));
      r = vmin(vmax(r, vmin(q0, qp1)), vmax(q0, qp1));
      const T qc = r - q0;
      const T qd = l - q0;
      const bool flat = (qc * qd) >= T(0);
      const T aqc = fabs(qc), aqd = fabs(qd);
      qrv[m] = flat ? q0 : (aqc >= T(2) * aqd ? q0 - T(2) * qd : r);
      qlv[m] = flat ? q0 : (aqd >= T(2) * aqc ? q0 - T(2) * qc : l);
    }
    wl_lo = qrv[0];
    wr_lo = qlv[1];
    wl_hi = qrv[1];
    wr_hi = qlv[2];
  }
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

// The whole stage for one interior cell (flat index ``cell`` into
// [nz, ny, nx]): writes u_out and w_out there and returns the cell's CFL
// denominator.
template <typename T, int METHOD, bool PERIODIC>
__device__ __forceinline__ T stage_cell(const Params& p, int64_t cell) {
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int64_t n = int64_t(nx) * ny * nz;
  const bool active_z = nz > 1;
  const T idx = T(p.idx), idy = T(p.idy), idz = T(p.idz);
  const int i = int(cell % nx);
  const int j = int((cell / nx) % ny);
  const int k = int(cell / (int64_t(nx) * ny));

  Src<T, PERIODIC> src;
  src.w = static_cast<const T*>(p.w);
  src.nx = nx;
  src.ny = ny;
  src.nz = nz;
  src.g1 = p.g1;
  src.g2 = p.g2;
  src.g3 = p.g3;
  const int64_t xs = PERIODIC ? nx : nx + 2 * p.g1;
  const int64_t ys = PERIODIC ? ny : ny + 2 * p.g2;
  const int64_t zs = PERIODIC ? nz : nz + 2 * p.g3;
  src.sy = xs;
  src.sz = xs * ys;
  src.sc = xs * ys * zs;

  T divf[6];
  T pf[3][2], vf[3][2];
  axis_fluxes<T, METHOD, PERIODIC, 1>(src, k, j, i, p.gamma, idx, true, divf, pf[0], vf[0]);
  axis_fluxes<T, METHOD, PERIODIC, 2>(src, k, j, i, p.gamma, idy, false, divf, pf[1], vf[1]);
  if (active_z)
    axis_fluxes<T, METHOD, PERIODIC, 3>(src, k, j, i, p.gamma, idz, false, divf, pf[2], vf[2]);

  // two-register RK blend (rk_blend): statically-zero registers unread
  const T bdt = T(p.beta) * static_cast<const T*>(p.dt)[0];
  const T* u0 = static_cast<const T*>(p.u0);
  const T* u1 = static_cast<const T*>(p.u1);
  T u[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) u[c] = rk_blend(p.gam0, p.gam1, u0, u1, c * n + cell, bdt * divf[c]);

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

// ---- CUDA-only below: the kernel, its launch and the C entry point.
// Everything above also compiles as host C++: tests/test_torch_kernel.py
// builds it with g++ behind a few macros, loops stage_cell over the cells
// and holds the result against the plain version on the CPU.

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

template <typename T>
cudaError_t launch_t(const Params& p, int method, int periodic, int block,
                     cudaStream_t s) {
  if (periodic) {
    if (method == kPCM) return launch<T, kPCM, true>(p, block, s);
    if (method == kPLM) return launch<T, kPLM, true>(p, block, s);
    return launch<T, kPPM, true>(p, block, s);
  }
  if (method == kPCM) return launch<T, kPCM, false>(p, block, s);
  if (method == kPLM) return launch<T, kPLM, false>(p, block, s);
  return launch<T, kPPM, false>(p, block, s);
}

}  // namespace

// dtype: 0 float32, 1 float64.  method: 0 pcm, 1 plm, 2 ppm.  block must be
// a power of two <= 256.  Returns a cudaError_t (0 on success).
extern "C" int artemis_stage_cart(
    int dtype, int method, int periodic, const void* w, const void* u0,
    const void* u1, const void* dt, void* u_out, void* w_out, void* dmax,
    int nx, int ny, int nz, int g1, int g2, int g3, double gam0, double gam1,
    double beta, double idx, double idy, double idz, double gamma,
    double dfloor, double siefloor, double de_switch, int block,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || method < 0 || method > 2 || block <= 0 ||
      block > 256 || (block & (block - 1)) != 0)
    return int(cudaErrorInvalidValue);
  Params p{w, u0, u1, dt, u_out, w_out, dmax, nx, ny, nz, g1, g2, g3,
           gam0, gam1, beta, idx, idy, idz, gamma, dfloor, siefloor,
           de_switch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_t<float>(p, method, periodic, block, s)
                                     : launch_t<double>(p, method, periodic, block, s);
  return int(err);
}
