// Gray flux-limited-diffusion (FLD) operator kernels for Hopper (sm_90a).
//
// What they replace: the two TPU Pallas kernels of
// artemis_tpu/ops/pallas_fld.py,
//   fld_coeffs -> _coeffs_kernel (:146, :88): the operator setup
//   fld_matvec -> _matvec_kernel (:200, :188): the 7-point operator applied
//                 once per conjugate-gradient iteration
// On the TPU both are BlockSpec pipelines over z-blocks that take their z
// halo from the (i +/- 1 mod nzb) neighbour blocks and rotate x/y in VMEM.
// Here one thread owns one cell and reads its neighbours by index, wrapped
// (jnp.roll semantics, the reference's), so there is no z tiling and no
// even-nz rule.
//
// fld_coeffs, per cell: the Levermore-Pomraning limiter from |grad E|
// (central differences over wrapped neighbours, also across the physical
// edges, as the reference does), the capped diffusivity
//   Dcell = min(c lam / (chi + tiny), c ext),
// the face averages 0.5 (Dcell + Dcell_nb) masked at the physical edges
// (zero flux, or the one-sided Dcell at a Dirichlet edge, whose wrapped
// neighbour coefficient is then 0), the off-diagonal rows
// A = [AL1, AH1, AL2, AH2, AL3, AH3] with dt / w_d^2 folded in, and the
// geometric Jacobi diagonal 1 + dt sum_d (D_hi + D_lo) / w_d^2.  A face
// coefficient needs Dcell at the cell and its six neighbours, and each of
// those needs E at its own six neighbours: a 25-point stencil of E and 7
// of chi per cell, the limiter recomputed 7 times (neighbouring threads
// share the loads through L1).
//
// fld_matvec, per cell: (diag + sf) E - sum_d (AH_d E_+d + AL_d E_-d),
// the terms subtracted in the kernel's order (x, y, z; hi before lo).
//
// What bounds them on the H100: bytes.  fld_coeffs reads E and chi and
// writes A (6 fields), diag and Dcell: 10 fields, 4 B each in float32, some
// 100 flops per cell after the recomputation; fld_matvec reads E, A (6),
// diag and sf and writes one field: 10 fields, 13 flops per cell.  At
// 512x512x64 both move 671 MB in float32, 0.20 ms at 3.35 TB/s.
//
// Binding: plain C entry points called through ctypes.  Each launches on
// the caller's stream, reads dt from device memory, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct FldInts {
  int count;                // sizeof(FldInts) / sizeof(int), from the caller
  int nx, ny, nz;
  int lo_dir[3], hi_dir[3]; // per direction: Dirichlet (1) or zero-flux (0) edge
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
  const void* E;            // [nz, ny, nx]
  const void* chi;          // [nz, ny, nx] (coeffs) or the coefficients A [6, nz, ny, nx] (matvec)
  const void* dt;           // one element (coeffs)
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
  return true;
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

// The capped FLD diffusivity at cell c (the limiter on wrapped neighbours).
template <typename T>
__device__ __forceinline__ T dcell(const FldParams& p, const T* E, const T* chi, Cell c) {
  const FldInts& n = p.n;
  T g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const Cell a = step(n, c, d, 1), b = step(n, c, d, -1);
    g[d] = (E[at(n, a.k, a.j, a.i)] - E[at(n, b.k, b.j, b.i)]) * T(p.r.half_idx[d]);
  }
  const T g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
  const T tiny = T(p.r.tiny);
  const int64_t q = at(n, c.k, c.j, c.i);
  const T x = chi[q];
  const T R = sqrt(g2) / (x * fmaxt(E[q], tiny) + tiny);
  const T lam = (T(2) + R) / (T(6) + T(3) * R + R * R);  // Levermore-Pomraning
  return fmint(T(p.r.c_code) * lam / (x + tiny), T(p.r.dcap));
}

// fld_coeffs at one cell (flat index into [nz, ny, nx]).
template <typename T>
__device__ __forceinline__ void coeffs_cell(const FldParams& p, int64_t cell) {
  const FldInts& n = p.n;
  const T* E = static_cast<const T*>(p.E);
  const T* chi = static_cast<const T*>(p.chi);
  T* A = static_cast<T*>(p.out0);
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const Cell c = cell_of(n, cell);
  const int pos[3] = {c.i, c.j, c.k};
  const int ext[3] = {n.nx, n.ny, n.nz};
  const T dt = static_cast<const T*>(p.dt)[0];
  const T D0 = dcell(p, E, chi, c);
  T diag = T(1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool first = pos[d] == 0, last = pos[d] == ext[d] - 1;
    T D_hi = T(0.5) * (D0 + dcell(p, E, chi, step(n, c, d, 1)));
    T D_lo = T(0.5) * (D0 + dcell(p, E, chi, step(n, c, d, -1)));
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
// the cells and holds the result against the plain versions on the CPU.

constexpr int kBlock = 256;

template <typename T, bool COEFFS>
__global__ void __launch_bounds__(kBlock) fld_kernel(const __grid_constant__ FldParams p) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  if (COEFFS)
    coeffs_cell<T>(p, cell);
  else
    matvec_cell<T>(p, cell);
}

template <bool COEFFS>
int launch(int dtype, const FldParams& p, void* stream) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const unsigned nblk = unsigned((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fld_kernel<float, COEFFS><<<nblk, kBlock, 0, s>>>(p);
  else if (dtype == 1)
    fld_kernel<double, COEFFS><<<nblk, kBlock, 0, s>>>(p);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  ints/reals: FldInts/FldReals, led by their
// counts.  Returns a cudaError_t (0 on success).
extern "C" int artemis_fld_coeffs(int dtype, const int* ints, const double* reals,
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
  return launch<true>(dtype, p, stream);
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
