// Device helpers shared by the fused stage kernels (stage_cart.cu,
// stage_curv.cu; sweep.cu): the uniform PLM slope, the HLLC and HLLE
// Riemann solvers and the two-register RK blend, ports of _plm, _hllc,
// _hlle (artemis_tpu/ops/pallas_sweeps.py:26,34,100) and rk_blend
// (artemis_tpu/ops/pallas_stage.py:47); and the cp.async copies with which
// the tiled bodies of both stages, and fld.cu's tiled fld_coeffs, stage
// their planes in shared memory.
//
// Everything here also compiles as host C++ (the tests build the kernels'
// device code with g++ behind a few macros), so it includes nothing of CUDA
// (the copies are plain copies there).

#pragma once

#include <stdint.h>
#include <string.h>

namespace artemis {

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }

// Limited slope of the uniform-spacing PLM (_plm): dq2 / (dql + dqr) where
// dq2 = dql * dqr > 0, else 0.  The cell's face values are q0 +/- slope.
template <typename T>
__device__ __forceinline__ T plm_slope(T qm, T q0, T qp) {
  const T dql = q0 - qm;
  const T dqr = qp - q0;
  const T dq2 = dql * dqr;
  return dq2 > T(0) ? dq2 / (dql + dqr) : T(0);
}

// HLLC flux along direction D (1..3) from L/R primitive states, the
// reciprocal-sharing form of _hllc.  F is in global component order (rho,
// m1, m2, m3, E, eint), without the pressure in the momentum flux; also
// returns the face pressure and the upwinded normal face velocity.
template <typename T, int D>
__device__ __forceinline__ void hllc(const T (&wl)[6], const T (&wr)[6],
                                     double gamma, T (&F)[6], T& pface,
                                     T& vface) {
  constexpr int ivx = D;
  constexpr int ivy = (D % 3) + 1;
  constexpr int ivz = ((D + 1) % 3) + 1;
  const T TINY = T(1.0e-20);
  const T igm1 = T(1.0 / (gamma - 1.0));
  const T alpha = T((gamma + 1.0) / (2.0 * gamma));
  const T g = T(gamma);
  const T half = T(0.5);
  const T dl = wl[0], dr = wr[0];
  const T vxl = wl[ivx], vxr = wr[ivx];
  const T vyl = wl[ivy], vyr = wr[ivy];
  const T vzl = wl[ivz], vzr = wr[ivz];
  const T pl = wl[4], pr = wr[4];
  const T sel = wl[5], ser = wr[5];

  const T isq_l = rsqrt_t(dl);
  const T isq_r = rsqrt_t(dr);
  const T al = sqrt(g * pl) * isq_l;
  const T ar = sqrt(g * pr) * isq_r;
  const T el = pl * igm1 + half * dl * (vxl * vxl + vyl * vyl + vzl * vzl);
  const T er = pr * igm1 + half * dr * (vxr * vxr + vyr * vyr + vzr * vzr);
  const T cbar = T(0.25) * (dl + dr) * (al + ar);
  const T pmid = half * (pl + pr + (vxl - vxr) * cbar);
  const T ql = pmid <= pl ? T(1) : sqrt(T(1) + alpha * (pmid / pl - T(1)));
  const T qr = pmid <= pr ? T(1) : sqrt(T(1) + alpha * (pmid / pr - T(1)));
  const T sl = vxl - al * ql;
  const T sr = vxr + ar * qr;
  const T bp = sr > T(0) ? sr : TINY;
  const T bm = sl < T(0) ? sl : -TINY;
  const T tl = pl + (vxl - sl) * dl * vxl;
  const T tr = pr + (vxr - sr) * dr * vxr;
  const T ml = dl * (vxl - sl);
  const T mr = -(dr * (vxr - sr));
  const T imlr = T(1) / (ml + mr);
  const T am = (tl - tr) * imlr;
  const T cp = vmax((ml * tr + mr * tl) * imlr, T(0));
  const T qe = dl * (vxl - bm);
  const T qf = dr * (vxr - bp);
  const T fle = el * (vxl - bm) + pl * vxl;
  const T fre = er * (vxr - bp) + pr * vxr;
  const bool pos = am >= T(0);
  const T iamb = T(1) / (am - bm);
  const T ibpa = T(1) / (bp - am);
  const T wc_l = pos ? am * iamb : T(0);
  const T wc_r = pos ? T(0) : -am * ibpa;
  const T wc_c = pos ? -bm * iamb : bp * ibpa;
  pface = wc_l * pl + wc_r * pr + wc_c * cp;
  const T frho = wc_l * qe + wc_r * qf;
  F[0] = frho;
  F[ivx] = wc_l * qe * vxl + wc_r * qf * vxr;
  F[ivy] = wc_l * qe * vyl + wc_r * qf * vyr;
  F[ivz] = wc_l * qe * vzl + wc_r * qf * vzr;
  F[4] = wc_l * fle + wc_r * fre + wc_c * cp * am;
  const bool upw = frho >= T(0);
  F[5] = frho * (upw ? sel : ser);
  vface = frho * (upw ? isq_l * isq_l : isq_r * isq_r);
}

// HLLE flux along direction D with Roe-averaged wave speeds, the form of
// _hlle (hlle.hpp:95-220); same outputs as hllc.
template <typename T, int D>
__device__ __forceinline__ void hlle(const T (&wl)[6], const T (&wr)[6],
                                     double gamma, T (&F)[6], T& pface,
                                     T& vface) {
  constexpr int ivx = D;
  constexpr int ivy = (D % 3) + 1;
  constexpr int ivz = ((D + 1) % 3) + 1;
  const T TINY = T(1.0e-20);
  const T gm1 = T(gamma - 1.0);
  const T igm1 = T(1.0 / (gamma - 1.0));
  const T g = T(gamma);
  const T half = T(0.5);
  const T dl = wl[0], dr = wr[0];
  const T vxl = wl[ivx], vxr = wr[ivx];
  const T vyl = wl[ivy], vyr = wr[ivy];
  const T vzl = wl[ivz], vzr = wr[ivz];
  const T pl = wl[4], pr = wr[4];
  const T sel = wl[5], ser = wr[5];

  const T isq_l = rsqrt_t(dl);
  const T isq_r = rsqrt_t(dr);
  const T sqrtdl = dl * isq_l;
  const T sqrtdr = dr * isq_r;
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T wroe_vx = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr;
  const T wroe_vy = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr;
  const T wroe_vz = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr;
  const T el = pl * igm1 + half * dl * (vxl * vxl + vyl * vyl + vzl * vzl);
  const T er = pr * igm1 + half * dr * (vxr * vxr + vyr * vyr + vzr * vzr);
  const T hroe = ((el + pl) * isq_l + (er + pr) * isq_r) * isdlpdr;
  const T qa = sqrt(g * pl) * isq_l;
  const T qb = sqrt(g * pr) * isq_r;
  const T a2 = hroe - half * (wroe_vx * wroe_vx + wroe_vy * wroe_vy + wroe_vz * wroe_vz);
  const T a = sqrt(gm1 * vmax(a2, T(0)));
  const T sl = vmin(wroe_vx - a, vxl - qa);
  const T sr = vmax(wroe_vx + a, vxr + qb);
  const T bp = sr > T(0) ? sr : TINY;
  const T bm = sl < T(0) ? sl : -TINY;
  const T qa_ = vxl - bm;
  const T qb_ = vxr - bp;
  const T fl_d = dl * qa_;
  const T fr_d = dr * qb_;
  const T w = bp != bm ? half * (bp + bm) / (bp - bm) : T(0);
  const T frho = half * (fl_d + fr_d) + w * (fl_d - fr_d);
  F[0] = frho;
  F[ivx] = half * (fl_d * vxl + fr_d * vxr) + w * (fl_d * vxl - fr_d * vxr);
  F[ivy] = half * (fl_d * vyl + fr_d * vyr) + w * (fl_d * vyl - fr_d * vyr);
  F[ivz] = half * (fl_d * vzl + fr_d * vzr) + w * (fl_d * vzl - fr_d * vzr);
  const T fl_e = el * qa_ + pl * vxl;
  const T fr_e = er * qb_ + pr * vxr;
  F[4] = half * (fl_e + fr_e) + w * (fl_e - fr_e);
  const bool upw = frho >= T(0);
  F[5] = frho * (upw ? sel : ser);
  vface = frho * (upw ? isq_l * isq_l : isq_r * isq_r);
  pface = half * (pl + pr) + w * (pl - pr);
}

// gam0*u0[o] + gam1*u1[o] + t with zero registers unread and unit
// coefficients elided (rk_blend: bit-identical to the dense form for
// finite inputs).
template <typename T>
__device__ __forceinline__ T rk_blend(double gam0, double gam1,
                                      const T* __restrict__ u0,
                                      const T* __restrict__ u1, int64_t o,
                                      T t) {
  T acc = T(0);
  bool have = false;
  if (gam0 != 0.0) {
    acc = gam0 == 1.0 ? u0[o] : T(gam0) * u0[o];
    have = true;
  }
  if (gam1 != 0.0) {
    const T v = gam1 == 1.0 ? u1[o] : T(gam1) * u1[o];
    acc = have ? acc + v : v;
    have = true;
  }
  return have ? acc + t : t;
}

// ---- staging copies of the tiled bodies (stage_cart.cu, stage_curv.cu, fld.cu)

// One element copied global -> shared: cp.async on the card (committed and
// waited for by group), a plain copy in the host build of the tests.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// 16 bytes copied global -> shared (both 16-byte aligned), past L1.
template <typename T>
__device__ __forceinline__ void copy_async16(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

}  // namespace artemis
