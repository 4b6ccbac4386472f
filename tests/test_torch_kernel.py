"""The fused stage kernel (``artemis_tpu_torch/csrc/stage_cart.cu``) against
its plain version, ``stage_reference``.

Two ways, neither needing JAX:

* on the CPU, the kernel's device code (everything above the source's
  "CUDA-only below" line, with the shared ``stage_common.cuh``) is compiled
  as host C++ with g++ behind a few macros; a serial loop calls its
  per-cell function for every cell (the per-cell body) or runs each block
  of the tiled body phase by phase, every thread per phase, with shared
  memory starting as NaN.  The real wrapper (``ops.stage._launch``)
  marshals the arguments, so the arithmetic, the stencil indexing, both
  halo sources, both bodies and the C interface are all checked here, on
  every run: the tiled body bitwise against the per-cell body, both
  against the plain version;
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
#include <cstring>
#include <limits>
#include <vector>
#define __host__
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
// The tiled body's block, phase by phase: each phase runs for every thread
// before the next starts (what __syncthreads gives on the card).
template <typename T, int M>
struct HostExec {
  std::vector<TileThread<T>> st = std::vector<TileThread<T>>(TileLayout<T, M>::NT);
  template <class Fn>
  void each(Fn&& f) {
    for (int t = 0; t < TileLayout<T, M>::NT; ++t) f(t, st[t]);
  }
};
// Shared memory starts as NaN in every block: a read of an element no
// phase wrote would show in the outputs.
template <typename T, int M, bool P>
void run_tiled(const Params& p) {
  const int64_t nb = tile_count<T, M>(p.nx, p.ny, p.nz);
  for (int64_t b = 0; b < nb; ++b) {
    std::vector<T> smem(TileLayout<T, M>::ELEMS, std::numeric_limits<T>::quiet_NaN());
    HostExec<T, M> ex;
    tile_block<T, M, P>(p, b, smem.data(), ex);
  }
}
template <typename T, int M, bool P>
void run_body(const Params& p, int tiled, int block) {
  if (tiled) run_tiled<T, M, P>(p);
  else run<T, M, P>(p, block);
}
template <typename T>
void run_t(const Params& p, int method, int periodic, int tiled, int block) {
  if (periodic) {
    if (method == kPCM) return run_body<T, kPCM, true>(p, tiled, block);
    if (method == kPLM) return run_body<T, kPLM, true>(p, tiled, block);
    return run_body<T, kPPM, true>(p, tiled, block);
  }
  if (method == kPCM) return run_body<T, kPCM, false>(p, tiled, block);
  if (method == kPLM) return run_body<T, kPLM, false>(p, tiled, block);
  return run_body<T, kPPM, false>(p, tiled, block);
}
}  // namespace
extern "C" int artemis_stage_cart(
    int dtype, int method, int periodic, int tiled, const void* w, const void* u0,
    const void* u1, const void* dt, void* u_out, void* w_out, void* dmax, int64_t ndmax,
    int nx, int ny, int nz, int g1, int g2, int g3, double gam0, double gam1,
    double beta, double idx, double idy, double idz, double gamma,
    double dfloor, double siefloor, double de_switch, int block, void*) {
  if (!args_ok(dtype, method, periodic, tiled, ndmax, nx, ny, nz, g1, g2, g3, block)) return 1;
  Params p{w, u0, u1, dt, u_out, w_out, dmax, nx, ny, nz, g1, g2, g3, gam0,
           gam1, beta, idx, idy, idz, gamma, dfloor, siefloor, de_switch};
  if (dtype == 0) run_t<float>(p, method, periodic, tiled, block);
  else run_t<double>(p, method, periodic, tiled, block);
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
    fn.argtypes = [i] * 4 + [p] * 7 + [ctypes.c_int64] + [i] * 6 + [d] * 10 + [i, p]
    return fn


@pytest.fixture
def on_host(host_kernel, monkeypatch):
    """Route the wrapper's launches to the host build (CPU tensors); the
    returned launch pads the prims unless the box is periodic."""
    monkeypatch.setattr(S, "_lib", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))

    def launch(hyd, w, *args):
        periodic = S.all_periodic(hyd.grid)
        src = w if periodic else bc_mod.pad_and_fill(w, hyd.grid, "gas")
        return S._launch(hyd, src, *args, periodic=periodic)

    return launch


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
def test_host_compiled_kernel_matches_plain(on_host, bc, recon, shape):
    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, "cpu")
        check_against_plain(hyd, u, w, dtype, on_host)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_kernel_matches_plain(cuda, bc, recon, shape):
    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, cuda)
        check_against_plain(hyd, u, w, dtype, S.stage)
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the tiled body (every launch of the wrapper) against the per-cell body
# ---------------------------------------------------------------------------

# the ragged shapes, and one with a short footprint in x and y (36 = 32 + 4
# columns, 10 rows) and two z chunks, the second partial (20 = 16 + 4)
TILED_SHAPES = SHAPES + [(36, 10, 20)]
# a periodic box narrower than the halo along y (PPM's three rows wrap onto
# a four-row box) and z
NARROW = (24, 4, 4)


def check_tiled(hyd, u, w, dtype, launch):
    """Both RK register patterns (gam0 = 0 and != 0): a launch takes the
    tiled body, bitwise equal (u, w, the dtden maximum) to the per-cell body
    on the same state (the wrapper's private switch), and within TOL of the
    plain version (u, w absolute, the dtden maximum relative); dtden has one
    entry per block of each body."""
    tol = TOL[dtype]
    nx, ny, nz = hyd.grid.nx
    dt = torch.full((), 2e-3, dtype=dtype, device=u.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        args = (u, u.clone(), gam0, gam1, beta, dt, False)
        n0, t0 = S.stage_launches, S.tiled_launches
        ut, wt, dtt = launch(hyd, w, *args)
        with S._percell_body():
            uc, wc, dc = launch(hyd, w, *args)
        assert (S.stage_launches, S.tiled_launches) == (n0 + 2, t0 + 1)
        assert dtt.numel() == S.dtden_blocks(nx, ny, nz, dtype)
        assert dc.numel() == S.dtden_blocks(nx, ny, nz, dtype, tiled=False)
        assert torch.equal(ut, uc) and torch.equal(wt, wc) and torch.equal(dtt.amax(), dc.amax())
        assert bool(torch.isfinite(ut).all()) and bool(torch.isfinite(wt).all())
        ur, wr, dr = S.stage_reference(hyd, w, *args)
        assert float((ut - ur).abs().max()) <= tol
        assert float((wt - wr).abs().max()) <= tol
        assert float((dtt.max() - dr.max()).abs() / dr.max()) <= tol


@pytest.mark.parametrize("shape", TILED_SHAPES)
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_host_compiled_tiled_matches_percell(on_host, bc, recon, shape):
    """The tiled body compiled for the host, block by block and phase by
    phase with shared memory starting as NaN: the periodic halo (K1) and
    the padded one (K2), f64 and f32."""
    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, "cpu")
        check_tiled(hyd, u, w, dtype, on_host)


@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
def test_host_compiled_tiled_narrow_periodic(on_host, recon):
    for dtype in TOL:
        hyd, u, w = setup(NARROW, recon, "periodic", dtype, "cpu")
        check_tiled(hyd, u, w, dtype, on_host)


def test_host_compiled_tiled_refusal_raises(on_host, monkeypatch):
    """No fallback: a launch the kernel refuses (a dtden length that is not
    the body's block count) returns an error, and the wrapper raises
    instead of running another body."""
    hyd, u, w = setup((40, 24, 12), "plm", "periodic", torch.float64, "cpu")
    monkeypatch.setitem(S.TILE, torch.float64, (32, 8, 16))
    dt = torch.full((), 2e-3, dtype=torch.float64)
    n0 = S.stage_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        on_host(hyd, w, u, u, 0.5, 0.5, 0.5, dt, False)
    assert S.stage_launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TILED_SHAPES)
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_kernel_tiled_matches_percell(cuda, bc, recon, shape):
    for dtype in TOL:
        hyd, u, w = setup(shape, recon, bc, dtype, cuda)
        check_tiled(hyd, u, w, dtype, S.stage)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("recon", ["pcm", "plm", "ppm"])
def test_kernel_tiled_narrow_periodic(cuda, recon):
    for dtype in TOL:
        hyd, u, w = setup(NARROW, recon, "periodic", dtype, cuda)
        check_tiled(hyd, u, w, dtype, S.stage)
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
