"""The fused stage kernel (``artemis_tpu_torch/csrc/stage_cart.cu``) against
its plain version, ``stage_reference``.

Two ways, neither needing JAX:

* on the CPU, the kernel's device code (everything above the source's
  "CUDA-only below" line, with the shared ``stage_common.cuh``) is compiled
  as host C++ with g++ behind a few macros, and a serial loop calls its
  per-cell function for every cell.
  The real wrapper (``ops.stage._launch``) marshals the arguments, so the
  arithmetic, the stencil indexing, both halo sources and the C interface
  are all checked here, on every run;
* on the card, the ``cuda``-marked tests launch the real kernel.  They
  skip without a GPU.  Run them there with (``tests/conftest.py`` imports
  jax, which the card's machine lacks)

      python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu_torch import bc as bc_mod  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import stage as S  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402

DECK = os.path.join(os.path.dirname(__file__), "..", "inputs", "linwave.in")
CSRC = os.path.join(os.path.dirname(S.__file__), "..", "csrc")
SOURCE = os.path.join(CSRC, "stage_cart.cu")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
SHAPES = [(48, 20, 12), (40, 24, 1)]  # ragged 3-D, 2-D

HOST_SHIM = r"""
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::sqrt;
using std::fabs;
"""

HOST_ENTRY = r"""
template <typename T, int M, bool P>
void run(const Params& p, int block) {
  const int64_t n = int64_t(p.nx) * p.ny * p.nz;
  T* dmax = static_cast<T*>(p.dmax);
  for (int64_t b = 0; b * block < n; ++b) {
    T m = T(0);
    for (int64_t cell = b * block; cell < n && cell < (b + 1) * block; ++cell)
      m = vmax(m, stage_cell<T, M, P>(p, cell));
    dmax[b] = m;
  }
}
template <typename T>
void run_t(const Params& p, int method, int periodic, int block) {
  if (periodic) {
    if (method == kPCM) return run<T, kPCM, true>(p, block);
    if (method == kPLM) return run<T, kPLM, true>(p, block);
    return run<T, kPPM, true>(p, block);
  }
  if (method == kPCM) return run<T, kPCM, false>(p, block);
  if (method == kPLM) return run<T, kPLM, false>(p, block);
  return run<T, kPPM, false>(p, block);
}
}  // namespace
extern "C" int artemis_stage_cart(
    int dtype, int method, int periodic, const void* w, const void* u0,
    const void* u1, const void* dt, void* u_out, void* w_out, void* dmax,
    int nx, int ny, int nz, int g1, int g2, int g3, double gam0, double gam1,
    double beta, double idx, double idy, double idz, double gamma,
    double dfloor, double siefloor, double de_switch, int block, void*) {
  Params p{w, u0, u1, dt, u_out, w_out, dmax, nx, ny, nz, g1, g2, g3, gam0,
           gam1, beta, idx, idy, idz, gamma, dfloor, siefloor, de_switch};
  if (dtype == 0) run_t<float>(p, method, periodic, block);
  else run_t<double>(p, method, periodic, block);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's device code built for the host, as a ctypes function
    with the C entry point's signature."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = open(SOURCE).read()
    device_part = src[:src.index("// ---- CUDA-only below")]
    device_part = device_part.replace("#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp("host_kernel")
    cpp, so = out / "stage_cart_host.cpp", out / "libstage_cart_host.so"
    cpp.write_text(HOST_SHIM + device_part + HOST_ENTRY)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-w", "-shared",
                          "-fPIC", "-I", CSRC, "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(so)).artemis_stage_cart
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.restype = i
    fn.argtypes = [i, i, i] + [p] * 7 + [i] * 6 + [d] * 10 + [i, p]
    return fn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def setup(shape, recon, bc, dtype, device):
    nx, ny, nz = shape
    pin = ParameterInput.from_file(DECK)
    ov = [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}", f"parthenon/mesh/nx3={nz}",
          f"parthenon/mesh/nghost={3 if recon == 'ppm' else 2}"]
    for d in (1, 2, 3):
        ov += [f"parthenon/mesh/ix{d}_bc={bc}", f"parthenon/mesh/ox{d}_bc={bc}"]
    pin.apply_overrides(ov)
    grid = grid_from_input(pin)
    cfg = FluidCfg(fluid="gas", recon=recon, rsolver="hllc",
                   gamma=pin.get_real("gas", "gamma"), cfl=pin.get_real("gas", "cfl"))
    hyd = Hydro(grid, cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(1)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = (cfg.gamma - 1) * w[:, 0] * w[:, 5]
    u, w = hyd.prim_to_cons(torch.as_tensor(w, dtype=dtype, device=device), cfg)
    return hyd, u, w


def check_against_plain(hyd, u, w, dtype, launch):
    """Both RK register patterns (gam0 = 0 and != 0): u, w within TOL abs,
    the dtden maximum within TOL relative; one launch per call."""
    tol = TOL[dtype]
    dt = torch.full((), 2e-3, dtype=dtype, device=u.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        n0 = S.stage_launches
        uk, wk, dk = launch(hyd, w, u, u.clone(), gam0, gam1, beta, dt, False)
        ur, wr, dr = S.stage_reference(hyd, w, u, u.clone(), gam0, gam1, beta, dt, False)
        assert S.stage_launches == n0 + 1
        assert float((uk - ur).abs().max()) <= tol
        assert float((wk - wr).abs().max()) <= tol
        assert float((dk.max() - dr.max()).abs() / dr.max()) <= tol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_host_compiled_kernel_matches_plain(host_kernel, monkeypatch, bc, recon, shape):
    monkeypatch.setattr(S, "_lib", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))

    def launch(hyd, w, *args):
        periodic = S.all_periodic(hyd.grid)
        src = w if periodic else bc_mod.pad_and_fill(w, hyd.grid, "gas")
        return S._launch(hyd, src, *args, periodic=periodic)

    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, "cpu")
        check_against_plain(hyd, u, w, dtype, launch)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_kernel_matches_plain(cuda, bc, recon, shape):
    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, cuda)
        check_against_plain(hyd, u, w, dtype, S.stage)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    """A config outside the envelope raises instead of running elsewhere."""
    hyd, u, w = setup((16, 8, 8), "plm", "periodic", torch.float64, cuda)
    bad = Hydro(hyd.grid, FluidCfg(fluid="gas", recon="plm", rsolver="hlle"),
                device=cuda, dtype=torch.float64)
    dt = torch.full((), 1e-3, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="envelope"):
        S.stage(bad, w, u, u, 0.5, 0.5, 0.5, dt, False)
