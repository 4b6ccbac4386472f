"""The fused flux sweep (``artemis_tpu_torch/ops/sweeps.py``, its CUDA
kernel ``csrc/sweep.cu``) against the TPU kernel it replaces, the JAX
package's jnp fluxes and its own plain version.

* ``sweep_reference`` against ``artemis_tpu.ops.pallas_sweeps.sweep`` run on
  the CPU: the module's ``pl`` is replaced by a stand-in whose
  ``pallas_call`` runs the kernel body once over whole arrays through ref
  objects, so the TPU kernel's own arithmetic, its wrapper's slicing and
  the z sweep's transposes run unchanged (float64, <= 1e-12 relative);
* ``sweep_reference`` against the JAX package's jnp ``Hydro.compute_fluxes``
  (float64, <= 1e-12 relative): the two solve the same HLLC problem, one
  with shared reciprocals and one with divisions;
* the kernel's device code compiled as host C++ with g++ and driven through
  the real wrapper against ``sweep_reference`` (float64 <= 1e-12, float32
  <= 1e-5 absolute on O(1) states), and ``cuda``-marked twins that launch
  the kernel on the card:

      python -m pytest tests/test_torch_sweep.py -m cuda --noconftest -q

Every case covers the three directions, PLM and PCM, a ragged 3-D shape
(nx2 not a multiple of 8) and a 2-D one.  The module level imports no JAX;
the JAX comparisons import it inside their tests and run with x64 on.
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

from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import sweeps as SW  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402

DECK = os.path.join(os.path.dirname(__file__), "..", "inputs", "linwave.in")
SOURCE = os.path.join(os.path.dirname(SW.__file__), "..", "csrc", "sweep.cu")
CSRC = os.path.dirname(SOURCE)
GAMMA = 5.0 / 3.0
SHAPES = [(13, 10, 7), (12, 9, 1)]  # ragged 3-D, 2-D (nx, ny, nz)
CASES = [(shape, d) for shape in SHAPES for d in (1, 2, 3) if d < 3 or shape[2] > 1]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def overrides(shape):
    nx, ny, nz = shape
    return [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
            f"parthenon/mesh/nx3={nz}", "parthenon/mesh/nghost=2"]


def port_grid(shape):
    pin = ParameterInput.from_file(DECK)
    pin.apply_overrides(overrides(shape))
    return grid_from_input(pin)


def random_padded(grid, seed=3):
    """Random smooth primitives on the whole padded grid (ghosts included),
    numpy float64 [1, 6, zp, yp, xp]."""
    nx, ny, nz = grid.nx
    g1, g2, g3 = grid.ng
    shape = (nz + 2 * g3, ny + 2 * g2, nx + 2 * g1)
    rng = np.random.default_rng(seed)
    w = np.empty((1, 6) + shape)
    w[0, 0] = 1.0 + 0.2 * rng.random(shape)
    w[0, 1:4] = 0.3 * (rng.random((3,) + shape) - 0.5)
    w[0, 5] = 1.0 + 0.2 * rng.random(shape)
    w[0, 4] = (GAMMA - 1.0) * w[0, 0] * w[0, 5]
    return w


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def check_layout(outs, grid, d):
    fshape = SW.face_shape(grid, d)
    F, pF, vF = outs
    assert tuple(F.shape) == (1, 6) + fshape
    assert tuple(pF.shape) == tuple(vF.shape) == (1,) + fshape


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

class _Ref:
    """A Pallas ref over a whole array: ``ref[...]`` reads it, ``ref[...] =``
    replaces it."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, x):
        assert idx is Ellipsis and x.shape == self.value.shape
        self.value = x.astype(self.value.dtype)


class _PlStandIn:
    """``pallas``'s two names that ``pallas_sweeps.sweep`` calls: the block
    specs are no-ops and ``pallas_call`` runs the kernel once over the whole
    arrays (one grid step whose block is everything)."""

    @staticmethod
    def BlockSpec(*args, **kwargs):
        return None

    @staticmethod
    def pallas_call(kern, out_shape, **_):
        import jax.numpy as jnp

        def run(*args):
            outs = [_Ref(jnp.zeros(s.shape, s.dtype)) for s in out_shape]
            kern(*[_Ref(a) for a in args], *outs)
            return tuple(o.value for o in outs)

        return run


def jax_grid(shape):
    from artemis_tpu.config import ParameterInput as JPin
    from artemis_tpu.grid import grid_from_input as jgrid_from_input

    pin = JPin.from_file(DECK)
    pin.apply_overrides(overrides(shape))
    return jgrid_from_input(pin)


@pytest.mark.parametrize("recon", ["plm", "pcm"])
@pytest.mark.parametrize("shape,d", CASES)
def test_plain_matches_tpu_kernel(monkeypatch, shape, d, recon):
    """sweep_reference vs the TPU kernel body (pallas_sweeps._sweep_kernel
    through its wrapper), float64: <= 1e-12 relative per output."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from artemis_tpu.ops import pallas_sweeps

    monkeypatch.setattr(pallas_sweeps, "pl", _PlStandIn)
    grid = port_grid(shape)
    w = random_padded(grid)
    with jax.enable_x64(True):
        jout = pallas_sweeps.sweep(jnp.asarray(w, dtype=jnp.float64), d, jax_grid(shape),
                                   GAMMA, recon=recon)
        jout = [np.asarray(o) for o in jout]
    assert all(o.dtype == np.float64 for o in jout)
    pout = SW.sweep_reference(torch.as_tensor(w), d, grid, GAMMA, recon)
    check_layout(pout, grid, d)
    for name, p, j in zip(("F", "pface", "vface"), pout, jout):
        assert p.shape == j.shape, name
        r = rel(p.numpy(), j)
        assert r <= 1e-12, f"{name}: rel {r:.3e}"


@pytest.mark.parametrize("recon", ["plm", "pcm"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jnp_fluxes(shape, recon):
    """sweep_reference in every direction vs the JAX package's jnp
    Hydro.compute_fluxes (PLM/PCM + the dividing hllc), float64: <= 1e-12
    relative; and the port's compute_fluxes(kernel=True) takes the sweep,
    in the same layout as its tensor chain (kernel=False)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro

    grid = port_grid(shape)
    w = random_padded(grid, seed=5)
    cfg = FluidCfg(fluid="gas", recon=recon, rsolver="hllc", gamma=GAMMA)
    with jax.enable_x64(True):
        jcfg = JCfg(fluid="gas", recon=recon, rsolver="hllc", gamma=GAMMA)
        jfx = JHydro(jax_grid(shape), jcfg).compute_fluxes(
            jnp.asarray(w, dtype=jnp.float64), jcfg, False)
        jfx = {d: [np.asarray(o) for o in outs] for d, outs in jfx.items()}
    hyd = Hydro(grid, cfg, device="cpu", dtype=torch.float64)
    tw = torch.as_tensor(w)
    chain = hyd.compute_fluxes(tw, cfg, False)
    n0 = SW.sweep_launches
    fused = hyd.compute_fluxes(tw, cfg, False, kernel=True)
    assert SW.sweep_launches == n0  # a CPU tensor runs the plain version
    assert sorted(jfx) == sorted(fused) == sorted(chain) == hyd.dims
    for d in hyd.dims:
        for name, p, c, j in zip(("F", "pface", "vface"), fused[d], chain[d], jfx[d]):
            assert j.dtype == np.float64
            assert p.shape == c.shape == j.shape, (d, name)
            r = rel(p.numpy(), j)
            assert r <= 1e-12, f"d={d} {name}: rel {r:.3e}"
            assert rel(p.numpy(), c.numpy()) <= 1e-12


def test_outside_the_envelope_keeps_the_chain():
    """kernel=True is a request, not a mandate: dust, HLLE and PPM stay on
    the tensor chain (sweep_supported is false)."""
    grid = port_grid(SHAPES[0])
    assert SW.sweep_supported(grid, FluidCfg("gas", "plm", "hllc"), torch.float32)
    assert SW.sweep_supported(grid, FluidCfg("gas", "ppm", "hllc"), torch.float64,
                              force_pcm=True)
    for cfg in (FluidCfg("dust", "plm", "hlle"), FluidCfg("gas", "plm", "hlle"),
                FluidCfg("gas", "ppm", "hllc"), FluidCfg("gas", "plm", "hllc", nspecies=2)):
        assert not SW.sweep_supported(grid, cfg, torch.float64)
    assert not SW.sweep_supported(grid, FluidCfg("gas", "plm", "hllc"), torch.float16)


# ---------------------------------------------------------------------------
# the kernel's device code
# ---------------------------------------------------------------------------

HOST_SHIM = r"""
#include <cmath>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::sqrt;
using std::fabs;
"""

HOST_ENTRY = r"""
template <typename T, int D, bool PLM>
void run(const SweepParams& p) {
  const int64_t n = sweep_faces<D>(p);
  for (int64_t face = 0; face < n; ++face) sweep_face<T, D, PLM>(p, face);
}
template <typename T, bool PLM>
void run_d(const SweepParams& p, int dir) {
  if (dir == 1) return run<T, 1, PLM>(p);
  if (dir == 2) return run<T, 2, PLM>(p);
  return run<T, 3, PLM>(p);
}
}  // namespace
extern "C" int artemis_sweep(int dtype, int dir, int method, const void* w,
                             void* F, void* pf, void* vf, int nx, int ny,
                             int nz, int g1, int g2, int g3, double gamma,
                             int block, void*) {
  const SweepParams p{w, F, pf, vf, nx, ny, nz, g1, g2, g3, gamma};
  if (dtype == 0) {
    if (method == 1) run_d<float, true>(p, dir); else run_d<float, false>(p, dir);
  } else {
    if (method == 1) run_d<double, true>(p, dir); else run_d<double, false>(p, dir);
  }
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
    out = tmp_path_factory.mktemp("host_sweep")
    cpp, so = out / "sweep_host.cpp", out / "libsweep_host.so"
    cpp.write_text(HOST_SHIM + device_part + HOST_ENTRY)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-w", "-shared",
                          "-fPIC", "-I", CSRC, "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(so)).artemis_sweep
    p, i, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.restype = i
    fn.argtypes = [i, i, i] + [p] * 4 + [i] * 6 + [dbl, i, p]
    return fn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def check_against_plain(grid, d, recon, dtype, device, launch):
    """One launch of the kernel on the random padded state against
    sweep_reference on the same tensor: every output within TOL."""
    w = torch.as_tensor(random_padded(grid), dtype=dtype, device=device)
    n0 = SW.sweep_launches
    kout = launch(w, d, grid, GAMMA, recon)
    assert SW.sweep_launches == n0 + 1
    check_layout(kout, grid, d)
    pout = SW.sweep_reference(w, d, grid, GAMMA, recon)
    for name, k, p in zip(("F", "pface", "vface"), kout, pout):
        err = float((k - p).abs().max())
        assert err <= TOL[dtype], f"d={d} {recon} {dtype} {name}: {err:.3e}"


@pytest.mark.parametrize("recon", ["plm", "pcm"])
@pytest.mark.parametrize("shape,d", CASES)
def test_host_compiled_kernel_matches_plain(host_kernel, monkeypatch, shape, d, recon):
    monkeypatch.setattr(SW, "_lib", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    grid = port_grid(shape)
    for dtype in TOL:
        check_against_plain(grid, d, recon, dtype, "cpu", SW._launch)


@pytest.mark.cuda
@pytest.mark.parametrize("recon", ["plm", "pcm"])
@pytest.mark.parametrize("shape,d", CASES)
def test_kernel_matches_plain(cuda, shape, d, recon):
    grid = port_grid(shape)
    for dtype in TOL:
        check_against_plain(grid, d, recon, dtype, cuda, SW.sweep)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    """A tensor the kernel cannot read raises instead of running elsewhere."""
    grid = port_grid(SHAPES[0])
    w = torch.as_tensor(random_padded(grid), device=cuda)
    with pytest.raises(ValueError, match="padded prims"):
        SW.sweep(w[..., 1:], 1, grid, GAMMA, "plm")
    with pytest.raises(ValueError, match="pcm or plm"):
        SW.sweep(w, 1, grid, GAMMA, "ppm")
    with pytest.raises(TypeError, match="float32 or float64"):
        SW.sweep(w.half(), 1, grid, GAMMA, "plm")
