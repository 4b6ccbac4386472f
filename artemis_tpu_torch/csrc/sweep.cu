// Fused PLM/PCM + HLLC flux sweep of one direction for Hopper (sm_90a).
//
// What it replaces: the TPU Pallas kernel of
// artemis_tpu/ops/pallas_sweeps.py, sweep (:210) -> _sweep_kernel (:162),
// with _plm (:26) and _hllc (:34); plm_slope and hllc live in
// stage_common.cuh, shared bit for bit with the fused stage kernels.  The
// TPU wrapper DMAs pencils into VMEM, runs x and y only (a ghosted z
// extent did not fit VMEM) and transposes for z; here every direction is a
// template instance that reads its stencil by index, with no transpose.
//
// What it computes, per interior face of direction D: the PLM (or PCM)
// face states from the two cells on either side, the HLLC flux rows in
// global component order (rho, m1, m2, m3, E, eint; no pressure in the
// momentum flux), the face pressure and the upwinded face velocity, as
// Hydro.compute_fluxes returns them for D.
//
// What bounds it on the H100: per face it reads 6 primitives of the cells
// it needs (each padded cell is shared by four faces along D, so the
// compulsory traffic is one read of the padded primitives cut to the
// interior across D) and writes 8 values, about 56 B per face in float32
// against some 150 floating-point operations, a few of them divisions and
// square roots: bytes-bound at the card's 3.35 TB/s if the stencil
// re-reads hit L1/L2.  One thread per face, the flat face index x-fastest
// in every direction, so a warp's loads and stores are coalesced along x
// for the y and z sweeps too; neighbouring faces along D re-read the
// same cells through the caches.  Shared-memory pencils and TMA are later
// work.
//
// Binding: a plain C entry point (artemis_sweep) called through ctypes.
// It launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_common.cuh"

namespace {

using namespace artemis;

struct SweepParams {
  const void* w;  // [6, nz+2g3, ny+2g2, nx+2g1] padded primitives
  void* F;        // [6, oz, oy, ox] flux rows on the interior faces of D
  void* pf;       // [oz, oy, ox] face pressure
  void* vf;       // [oz, oy, ox] upwinded face velocity
  int nx, ny, nz;
  int g1, g2, g3;
  double gamma;
};

// The fluxes through one interior face of direction D (flat index ``face``
// into [oz, oy, ox], x fastest), where the face array is the interior cell
// array grown by one along D.  Face f along D sits between the ghosted
// cells g+f-1 and g+f; wl comes from the cell below, wr from the cell above.
template <typename T, int D, bool PLM>
__device__ __forceinline__ void sweep_face(const SweepParams& p, int64_t face) {
  const int ox = p.nx + (D == 1), oy = p.ny + (D == 2), oz = p.nz + (D == 3);
  const int i = int(face % ox);
  const int j = int((face / ox) % oy);
  const int k = int(face / (int64_t(ox) * oy));
  const int64_t xs = p.nx + 2 * p.g1;
  const int64_t sy = xs;
  const int64_t sz = xs * (p.ny + 2 * p.g2);
  const int64_t sc = sz * (p.nz + 2 * p.g3);
  const int64_t sd = D == 1 ? 1 : (D == 2 ? sy : sz);
  // the cell above the face, in the padded array
  const int64_t c0 = int64_t(k + p.g3) * sz + int64_t(j + p.g2) * sy + (i + p.g1);
  const T* __restrict__ w = static_cast<const T*>(p.w);

  T wl[6], wr[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T* q = w + c * sc + c0;
    if (PLM) {
      const T qm2 = q[-2 * sd], qm1 = q[-sd], q0 = q[0], qp1 = q[sd];
      wl[c] = qm1 + plm_slope(qm2, qm1, q0);
      wr[c] = q0 - plm_slope(qm1, q0, qp1);
    } else {
      wl[c] = q[-sd];
      wr[c] = q[0];
    }
  }
  T Fc[6], pface, vface;
  hllc<T, D>(wl, wr, p.gamma, Fc, pface, vface);

  const int64_t nf = int64_t(ox) * oy * oz;
  T* F = static_cast<T*>(p.F);
#pragma unroll
  for (int c = 0; c < 6; ++c) F[c * nf + face] = Fc[c];
  static_cast<T*>(p.pf)[face] = pface;
  static_cast<T*>(p.vf)[face] = vface;
}

template <int D>
__host__ __device__ __forceinline__ int64_t sweep_faces(const SweepParams& p) {
  return int64_t(p.nx + (D == 1)) * (p.ny + (D == 2)) * (p.nz + (D == 3));
}

// ---- CUDA-only below: the kernel, its launch and the C entry point.
// Everything above also compiles as host C++: tests/test_torch_sweep.py
// builds it with g++ behind a few macros, loops sweep_face over the faces
// and holds the result against the plain version on the CPU.

template <typename T, int D, bool PLM>
__global__ void __launch_bounds__(256) sweep_kernel(const SweepParams p) {
  const int64_t face = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (face < sweep_faces<D>(p)) sweep_face<T, D, PLM>(p, face);
}

template <typename T, int D, bool PLM>
cudaError_t launch(const SweepParams& p, int block, cudaStream_t stream) {
  const int64_t n = sweep_faces<D>(p);
  const unsigned nblk = unsigned((n + block - 1) / block);
  sweep_kernel<T, D, PLM><<<nblk, block, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool PLM>
cudaError_t launch_d(const SweepParams& p, int dir, int block, cudaStream_t s) {
  if (dir == 1) return launch<T, 1, PLM>(p, block, s);
  if (dir == 2) return launch<T, 2, PLM>(p, block, s);
  return launch<T, 3, PLM>(p, block, s);
}

}  // namespace

// dtype: 0 float32, 1 float64.  dir: 1, 2 or 3.  method: 0 pcm, 1 plm.
// block: threads per block, at most 256.  Returns a cudaError_t (0 on
// success).
extern "C" int artemis_sweep(int dtype, int dir, int method, const void* w,
                             void* F, void* pf, void* vf, int nx, int ny,
                             int nz, int g1, int g2, int g3, double gamma,
                             int block, void* stream) {
  if ((dtype != 0 && dtype != 1) || dir < 1 || dir > 3 || method < 0 ||
      method > 1 || block <= 0 || block > 256)
    return int(cudaErrorInvalidValue);
  const SweepParams p{w, F, pf, vf, nx, ny, nz, g1, g2, g3, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = method == 1 ? launch_d<float, true>(p, dir, block, s)
                      : launch_d<float, false>(p, dir, block, s);
  else
    err = method == 1 ? launch_d<double, true>(p, dir, block, s)
                      : launch_d<double, false>(p, dir, block, s);
  return int(err);
}
