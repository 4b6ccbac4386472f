"""Gray FLD radiation in the port: the FLD operator's plain versions against
the JAX package's TPU kernels (interpret mode), ``Radiation.step`` against
the JAX package's jnp solve, the radiation decks and the single-level disk
RHD slice against the JAX package's runs, and the CUDA kernels
``csrc/fld.cu`` against the plain versions.

* ``fld_coeffs_reference`` / ``fld_matvec_reference`` vs
  ``pallas_fld.fld_coeffs`` / ``fld_matvec`` in interpret mode on
  tests/test_pallas_fld.py's 32x16x32 setup, Dirichlet flags off, on and
  mixed: <= 1e-12 relative (float64; the two make the same operations);
* ``Radiation.step`` (tensor operations) vs the JAX package's jnp path in
  float64, with and without ghost planes: the same CG iteration counts per
  Newton outer iteration, Er and u <= 1e-11 relative, gas + radiation
  energy <= 1e-10 relative; the kernel operator (``fld_coeffs`` +
  ``fld_matvec``, on the CPU their plain versions) against the tensor one;
* thermalization to its analytic equilibrium (tests/test_radiation.py's
  thresholds) and rad_shock over 20 cycles vs the JAX run <= 1e-11;
* the single-level disk RHD slice (``inputs/disk_rhd_amr.in`` with
  refinement none, 32x32x8 over [-1.5, 1.5]^2 x [-0.5, 0.5], float64) for
  3 cycles vs the JAX run from the same initial state: u, w, Er <= 1e-11
  relative;
* the kernels' device code compiled as host C++ with g++ and driven through
  the real wrappers vs the plain versions (float64 <= 1e-13 relative,
  float32 <= 1e-6), the tiled body of fld_coeffs (which every launch
  takes: its blocks run phase by phase with shared memory starting as
  NaN) bitwise equal to the per-cell body (the wrapper's private switch
  ``_percell_body``) on every shape and flag set and on a shape ragged
  across the footprint and the z chunks, both kernels over a node axis of
  three nodes (one launch, bitwise equal to three one-node launches, within
  the tolerance of the plain versions on the stack), and ``cuda``-marked
  twins that run on the card:

      python -m pytest tests/test_torch_radiation.py -m cuda --noconftest -q

The module level imports no JAX (the card's machine has none); the JAX
comparisons import it inside their tests.
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

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import fld as FLD  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.radiation import Radiation, RadiationCfg  # noqa: E402
from artemis_tpu_torch.state import state_from_numpy, state_to_numpy  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "..", "inputs")
RHD = os.path.join(INPUTS, "disk_rhd_amr.in")
THERM = os.path.join(INPUTS, "thermalization.in")
SHOCK = os.path.join(INPUTS, "rad_shock.in")
CSRC = os.path.join(os.path.dirname(FLD.__file__), "..", "csrc")
NZ, NY, NX = 32, 16, 32
FLAGS = {"zero-flux": ((False, False),) * 3, "dirichlet": ((True, True),) * 3,
         "mixed": ((True, False), (False, True), (True, True))}
# the slice test's domain: the deck's x1/x2 range narrowed to keep the
# resolution near the deck's at 32 cells
RHD_OVERRIDES = ["parthenon/mesh/refinement=none", "parthenon/mesh/nx1=32",
                 "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8",
                 "parthenon/mesh/x1min=-1.5", "parthenon/mesh/x1max=1.5",
                 "parthenon/mesh/x2min=-1.5", "parthenon/mesh/x2max=1.5",
                 "parthenon/time/nlim=3"]


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def random_fields(seed=1, shape=(NZ, NY, NX)):
    """The random state of tests/test_pallas_fld.py (numpy, float64): rho,
    sie and Er in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + rng.random((1,) + shape)
    sie = 1.0 + rng.random((1,) + shape)
    Er = 0.5 + rng.random((1,) + shape)
    return rho, sie, Er


def numpy_state(rho, sie, Er):
    nz, ny, nx = rho.shape[1:]
    u = np.zeros((1, 6, nz, ny, nx))
    u[:, 0] = rho
    u[:, 5] = rho * sie
    u[:, 4] = rho * sie
    return {"gas": {"u": u, "w": u * 0}, "rad": {"Er": Er}}


def deck_pin(shape=(NZ, NY, NX)):
    nz, ny, nx = shape
    pin = ParameterInput.from_file(RHD)
    pin.apply_overrides([f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
                         f"parthenon/mesh/nx3={nz}"])
    return pin


RAD_CFG = dict(opacity_model="constant", kappa_a=3.0, c_code=10.0, arad=2.0)


def port_radiation(device="cpu", dtype=torch.float64, shape=(NZ, NY, NX)):
    pin = deck_pin(shape)
    grid = grid_from_input(pin)
    gas = FluidCfg(fluid="gas", recon="plm", rsolver="hllc",
                   gamma=pin.get_real("gas", "gamma"), cfl=0.9)
    hyd = Hydro(grid, gas, device=device, dtype=dtype)
    return Radiation(RadiationCfg(**RAD_CFG), grid, hyd, gas)


def operator_inputs(dtype, device, shape=(NZ, NY, NX), seed=1):
    """E, chi, a one-element dt and sf for the operator, as tensors."""
    rho, _, Er = random_fields(seed, shape)
    rng = np.random.default_rng(seed + 10)
    chi = RAD_CFG["kappa_a"] * rho[0]
    sf = 0.5 * rng.random(shape)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return t(Er[0]), t(chi), t(np.array([1e-3])), t(sf)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", list(FLAGS))
def test_plain_operator_matches_interpret_kernels(flags):
    """fld_coeffs_reference / fld_matvec_reference vs the TPU kernels in
    interpret mode: every output <= 1e-12 relative (float64).  x64 is
    turned on around the JAX calls and their outputs asserted float64: a
    float32 JAX Simulation elsewhere in the process turns x64 off."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from artemis_tpu.ops import pallas_fld as pf

    rad = port_radiation()
    E, chi, dt, sf = operator_inputs(torch.float64, "cpu")
    fl = FLAGS[flags]
    f64 = lambda t: jnp.asarray(t.numpy(), dtype=jnp.float64)
    with jax.enable_x64(True):
        ja = pf.fld_coeffs(f64(E), f64(chi), 1e-3, rad._wuni, RAD_CFG["c_code"], rad._ext,
                           fl, interpret=True)
        jm = pf.fld_matvec(f64(E), ja[0], ja[1], f64(sf), interpret=True)
        ja = [np.asarray(j) for j in ja]
        jm = np.asarray(jm)
    assert all(j.dtype == np.float64 for j in ja + [jm])
    pa = FLD.fld_coeffs_reference(E, chi, dt, rad._wuni, RAD_CFG["c_code"], rad._ext, fl)
    for name, j, p in zip(("A", "diag_geo", "Dcell"), ja, pa):
        r = rel(p.numpy(), j)
        assert r <= 1e-12, f"fld_coeffs {name}: rel {r:.3e}"
    pm = FLD.fld_matvec_reference(E, pa[0], pa[1], sf)
    r = rel(pm.numpy(), jm)
    assert r <= 1e-12, f"fld_matvec: rel {r:.3e}"


def test_grad_norm_is_the_ieee_root():
    """The plain versions' gradient magnitude (``grad_norm``) is the IEEE
    square root of g_1^2 + g_2^2 + g_3^2 summed in that order: bitwise
    numpy's, in float64 on tensors large enough to be split across the two
    threads (torch.sqrt there goes through a vector library that is not
    correctly rounded)."""
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal((NZ, NY, NX)) * 10.0 ** rng.uniform(-5, 5, (NZ, NY, NX))
          for _ in range(3)]
    want = np.sqrt((gs[0] * gs[0] + gs[1] * gs[1]) + gs[2] * gs[2])
    got = FLD.grad_norm([torch.as_tensor(g) for g in gs])
    assert got.dtype == torch.float64 and np.array_equal(got.numpy(), want)


def jax_radiation():
    """The JAX package's Radiation on the same grid and configuration."""
    from artemis_tpu.config import ParameterInput as JPin
    from artemis_tpu.grid import grid_from_input as jgrid
    from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro
    from artemis_tpu.radiation import Radiation as JRad, RadiationCfg as JRadCfg

    pin = JPin.from_file(RHD)
    pin.apply_overrides([f"parthenon/mesh/nx1={NX}", f"parthenon/mesh/nx2={NY}",
                         f"parthenon/mesh/nx3={NZ}"])
    grid = jgrid(pin)
    gas = JCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=pin.get_real("gas", "gamma"),
               cfl=0.9)
    return JRad(JRadCfg(**RAD_CFG), grid, JHydro(grid, gas), gas)


def ghost_planes(Er):
    return {1: (0.7 + 0 * Er[..., :1], 0.9 + 0 * Er[..., :1])}


@pytest.mark.parametrize("with_ghosts", [False, True], ids=["no-ghosts", "ghosts"])
def test_step_matches_jnp_solve(with_ghosts):
    """Radiation.step (tensor operator) vs the JAX jnp solve, float64: the
    same CG iteration counts, Er and u <= 1e-11 relative, total energy
    <= 1e-10 relative."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    st = numpy_state(*random_fields())
    jrad = jax_radiation()
    jst = {f: {k: jnp.asarray(v) for k, v in kinds.items()} for f, kinds in st.items()}
    jghosts = ghost_planes(jst["rad"]["Er"]) if with_ghosts else None
    jout, jit = jrad.step(jst, 1e-3, ghosts=jghosts, with_iters=True)

    rad = port_radiation()
    assert not rad.use_kernels
    tst = state_from_numpy(st, "cpu", torch.float64)
    tghosts = ghost_planes(tst["rad"]["Er"]) if with_ghosts else None
    tout, tit = rad.step(tst, 1e-3, ghosts=tghosts, with_iters=True)

    assert list(tit) == [int(i) for i in np.asarray(jit)]
    assert tit[0] > 1
    Er_j, u_j = np.asarray(jout["rad"]["Er"]), np.asarray(jout["gas"]["u"])
    assert rel(tout["rad"]["Er"].numpy(), Er_j) <= 1e-11
    assert rel(tout["gas"]["u"].numpy(), u_j) <= 1e-11
    tot_t = float(tout["rad"]["Er"].sum() + tout["gas"]["u"][:, 4].sum())
    tot_j = float(Er_j.sum() + u_j[:, 4].sum())
    assert abs(tot_t - tot_j) <= 1e-10 * abs(tot_j)


@pytest.mark.parametrize("with_ghosts", [False, True], ids=["edges", "ghosts"])
def test_kernel_operator_matches_tensor_operator(with_ghosts):
    """The kernel operator path (fld_coeffs + fld_matvec; on the CPU their
    plain versions) vs the tensor operator, with deck Dirichlet edges on x2
    and x3: Er and u <= 1e-11 relative, the same CG counts, and the same
    gas + radiation total to 1e-12 relative."""
    st = state_from_numpy(numpy_state(*random_fields()), "cpu", torch.float64)
    ghosts = ghost_planes(st["rad"]["Er"]) if with_ghosts else None
    outs = []
    for kernels in (False, True):
        rad = port_radiation()
        rad.set_edge_dirichlet(2, lo=0.8)
        rad.set_edge_dirichlet(3, lo=1.1, hi=0.6)
        rad.use_kernels = kernels
        outs.append(rad.step(st, 1e-3, ghosts=ghosts, with_iters=True))
    (a, ia), (b, ib) = outs
    assert ia == ib
    assert rel(b["rad"]["Er"], a["rad"]["Er"]) <= 1e-11
    assert rel(b["gas"]["u"], a["gas"]["u"]) <= 1e-11
    tot = [float(o["rad"]["Er"].sum() + o["gas"]["u"][:, 4].sum()) for o in (a, b)]
    assert abs(tot[1] - tot[0]) <= 1e-12 * abs(tot[0])


def test_sync_gas_is_the_energy_resync():
    """sync_gas equals a full C2P + P2C of the state after the radiation
    step, with dtden dropped."""
    rho, sie, Er = random_fields(shape=(4, 6, 8))
    rad = port_radiation(shape=(4, 6, 8))
    hyd, cfg = rad.hyd, rad.gas
    u, w = hyd.prim_to_cons(torch.as_tensor(np.stack(
        [rho[0], 0.1 * sie[0], -0.1 * rho[0], 0 * rho[0], 0.4 * rho[0] * sie[0], sie[0]])[None]),
        cfg)
    st = {"gas": {"u": u, "w": w, "dtden": torch.ones(1, dtype=torch.float64)},
          "rad": {"Er": torch.as_tensor(Er)}}
    out = rad.sync_gas(rad.step(st, 1e-3))
    assert "dtden" not in out["gas"]
    u2, w2 = hyd.prim_to_cons(hyd.cons_to_prim(out["gas"]["u"], cfg), cfg)
    assert rel(out["gas"]["u"], u2) <= 1e-14
    assert rel(out["gas"]["w"], w2) <= 1e-14


def test_state_carries_radiation():
    """artemis_tpu_torch.state carries ``state["rad"]["Er"]`` both ways,
    bitwise in float64, beside the gas keys."""
    st = numpy_state(*random_fields(shape=(4, 6, 8)))
    st["gas"]["dtden"] = np.array([2.5])
    back = state_to_numpy(state_from_numpy(st, "cpu", torch.float64))
    assert back.keys() == st.keys() and back["rad"].keys() == {"Er"}
    for name in st:
        for k in st[name]:
            assert np.array_equal(back[name][k], st[name][k])


# ---------------------------------------------------------------------------
# decks and the slice
# ---------------------------------------------------------------------------

def test_thermalization(tmp_path):
    """tests/test_radiation.py's thresholds: energy conserved to 1e-12,
    gas and radiation temperatures at the analytic equilibrium to 1e-5."""
    from scipy.optimize import brentq

    sim = Simulation(THERM, [], str(tmp_path), device="cpu")
    sim.run()
    cv = sim.gas_cfg.cv
    u = sim.state["gas"]["u"][0].numpy()
    Er = sim.state["rad"]["Er"][0].numpy()
    E0 = cv * 2.0 + 1.0**4
    Teq = brentq(lambda T: cv * T + T**4 - E0, 0.1, 5.0)
    assert abs(u[5].mean() + Er.mean() - E0) / E0 < 1e-12
    assert abs((u[5] / cv).mean() - Teq) / Teq < 1e-5
    assert abs(Er.mean() ** 0.25 - Teq) / Teq < 1e-5


def jax_then_port(tmp_path, deck, overrides):
    """The JAX run and the port's run from the JAX run's initial state
    (after checking that the port's own initial state is the same)."""
    pytest.importorskip("jax")
    from artemis_tpu.simulation import Simulation as JSimulation

    jsim = JSimulation(deck, overrides, str(tmp_path / "jax"))
    j0 = {f: {k: np.asarray(v) for k, v in kinds.items()} for f, kinds in jsim.state.items()}
    jsim.run()
    tsim = Simulation(deck, overrides, str(tmp_path / "port"), device="cpu")
    t0 = state_to_numpy(tsim.state)
    assert t0.keys() == j0.keys()
    for f in j0:
        for k in j0[f]:
            assert float(np.abs(t0[f][k] - j0[f][k]).max()) <= 1e-12 * np.abs(j0[f][k]).max()
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle == tsim.tm.nlim
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14 * jsim.tm.time
    end = state_to_numpy(tsim.state)
    for f, k in (("gas", "u"), ("gas", "w"), ("rad", "Er")):
        assert end[f][k].dtype == np.float64
        assert rel(end[f][k], jsim.state[f][k]) <= 1e-11, (f, k)
    return tsim, end


def test_rad_shock_slice(tmp_path):
    """rad_shock (1-D, ic edges, shocktube_a opacity) for 20 cycles."""
    tsim, end = jax_then_port(tmp_path, SHOCK, ["parthenon/time/nlim=20"])
    assert np.isfinite(end["rad"]["Er"]).all()


def test_disk_rhd_slice(tmp_path):
    """The single-level disk RHD slice for 3 cycles: the port runs its
    tensor path on the CPU, as the JAX package its jnp path."""
    tsim, end = jax_then_port(tmp_path, RHD, RHD_OVERRIDES)
    rad = tsim.driver.radiation
    assert set(rad._edge_dirichlet) == {1, 2, 3}
    assert all(lo is not None and hi is not None for lo, hi in rad._edge_dirichlet.values())
    d0 = np.asarray(tsim.problem.prims["gas"][0][0])
    d = end["gas"]["w"][0, 0]
    assert float(np.sqrt((d0 * (d - d0) ** 2).sum()) / d0.sum()) <= 3e-4


# ---------------------------------------------------------------------------
# the kernels against the plain versions
# ---------------------------------------------------------------------------

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
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::sqrt;
"""

HOST_ENTRY = r"""
// Every node of the launch (blockIdx.y on the card) through node_params.
template <typename T, bool COEFFS>
void run(const FldParams& p) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  for (int node = 0; node < p.n.nn; ++node) {
    const FldParams q = node_params<T, COEFFS>(p, node);
    for (int64_t cell = 0; cell < n; ++cell) {
      if (COEFFS) coeffs_cell<T>(q, cell);
      else matvec_cell<T>(q, cell);
    }
  }
}
// The tiled body's block, phase by phase: each phase runs for every thread
// before the next starts (what __syncthreads gives on the card).
template <typename T>
struct HostExec {
  template <class Fn>
  void each(Fn&& f) {
    for (int t = 0; t < FldTile<T>::NT; ++t) f(t);
  }
};
// Shared memory starts as NaN in every block: a read of an element no
// phase wrote would show in the outputs.
template <typename T>
void run_tiled(const FldParams& p) {
  for (int node = 0; node < p.n.nn; ++node) {
    const FldParams q = node_params<T, true>(p, node);
    for (int64_t b = 0; b < fld_tiles<T>(p.n); ++b) {
      std::vector<T> smem(FldTile<T>::ELEMS, std::numeric_limits<T>::quiet_NaN());
      HostExec<T> ex;
      coeffs_block<T>(q, b, smem.data(), ex);
    }
  }
}
}  // namespace
extern "C" int artemis_fld_coeffs(int dtype, int tiled, const int* ints, const double* reals,
                                  const void* E, const void* chi, const void* dt,
                                  void* A, void* diag, void* dcell, void*) {
  FldParams p;
  if (!make_params(ints, reals, &p)) return 1;
  p.E = E; p.chi = chi; p.dt = dt; p.out0 = A; p.out1 = diag; p.out2 = dcell;
  if (tiled) {
    if (dtype == 0) run_tiled<float>(p); else run_tiled<double>(p);
  } else {
    if (dtype == 0) run<float, true>(p); else run<double, true>(p);
  }
  return 0;
}
extern "C" int artemis_fld_matvec(int dtype, const int* ints, const double* reals,
                                  const void* E, const void* A, const void* diag,
                                  const void* sf, void* out, void*) {
  FldParams p;
  if (!make_params(ints, reals, &p)) return 1;
  p.E = E; p.chi = A; p.diag = diag; p.sf = sf; p.out0 = out;
  if (dtype == 0) run<float, false>(p); else run<double, false>(p);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_fld(tmp_path_factory):
    """fld.cu's device code built for the host, as a ctypes library with
    the C entry points' signatures."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = open(os.path.join(CSRC, "fld.cu")).read()
    device_part = src[:src.index("// ---- CUDA-only below")].replace(
        "#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp("host_fld")
    cpp, so = out / "fld_host.cpp", out / "libfld_host.so"
    cpp.write_text(HOST_SHIM + device_part + HOST_ENTRY)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-w", "-shared",
                          "-fPIC", "-I", CSRC, "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.artemis_fld_coeffs.argtypes = [i, i, p, p] + [p] * 6 + [p]
    lib.artemis_fld_matvec.argtypes = [i, p, p] + [p] * 5 + [p]
    lib.artemis_fld_coeffs.restype = lib.artemis_fld_matvec.restype = i
    return lib


@pytest.fixture
def on_host(host_fld, monkeypatch):
    """Route the wrappers' launches to the host build (CPU tensors); returns
    the launch functions (coeffs, matvec) behind ``fld_coeffs`` and
    ``fld_matvec``'s CUDA branch."""
    monkeypatch.setattr(FLD, "_lib", lambda: host_fld)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    return FLD._launch_coeffs, FLD._launch_matvec


TOL_REL = {torch.float64: 1e-13, torch.float32: 1e-6}
# (nz, ny, nx): the 32x16x32 setup, an odd nz with ragged widths, and the
# smallest extents where a cell's two neighbours coincide
SHAPES = [(NZ, NY, NX), (5, 7, 9), (2, 2, 3)]


def check_kernels(launch_coeffs, launch_matvec, dtype, device, shape, flags, tol):
    """Both kernels against the plain versions on the same inputs; returns
    the worst relative error and the launch counts' increase."""
    rad = port_radiation(shape=(NZ, NY, NX))
    E, chi, dt, sf = operator_inputs(dtype, device, shape)
    n0 = (FLD.fld_coeffs_launches, FLD.fld_matvec_launches)
    args = (E, chi, dt, rad._wuni, RAD_CFG["c_code"], rad._ext, flags)
    kc = launch_coeffs(*args)
    pc = FLD.fld_coeffs_reference(*args)
    km = launch_matvec(E, pc[0], pc[1], sf)
    pm = FLD.fld_matvec_reference(E, pc[0], pc[1], sf)
    worst = max(rel(k.double().cpu().numpy(), p.double().cpu().numpy())
                for k, p in zip((*kc, km), (*pc, pm)))
    assert worst <= tol
    return worst, (FLD.fld_coeffs_launches - n0[0], FLD.fld_matvec_launches - n0[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=["32x16x32", "5x7x9", "2x2x3"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_host_compiled_kernels_match_plain(on_host, dtype, shape, flags):
    _, launches = check_kernels(*on_host, dtype, "cpu", shape, FLAGS[flags], TOL_REL[dtype])
    assert launches == (1, 1)


# a shape ragged across the tiled body's footprint (32 x 8) and its z
# chunks (16 planes): (nz, ny, nx)
RAGGED = (17, 9, 33)


def check_tiled_coeffs(launch_coeffs, dtype, device, shape, flags, tol):
    """fld_coeffs on the tiled body (every launch's) bitwise equal to the
    per-cell body (the private switch) and within ``tol`` of the plain
    version (each output relative to its max |plain|); one tiled launch."""
    rad = port_radiation(shape=(NZ, NY, NX))
    E, chi, dt, _ = operator_inputs(dtype, device, shape)
    args = (E, chi, dt, rad._wuni, RAD_CFG["c_code"], rad._ext, flags)
    n0 = (FLD.fld_coeffs_launches, FLD.fld_coeffs_tiled_launches)
    kt = launch_coeffs(*args)
    with FLD._percell_body():
        kc = launch_coeffs(*args)
    assert (FLD.fld_coeffs_launches - n0[0], FLD.fld_coeffs_tiled_launches - n0[1]) == (2, 1)
    pc = FLD.fld_coeffs_reference(*args)
    for t, c, p in zip(kt, kc, pc):
        assert torch.equal(t, c)
        assert torch.isfinite(t).all()
        assert rel(t.double().cpu().numpy(), p.double().cpu().numpy()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES + [RAGGED], ids=["32x16x32", "5x7x9", "2x2x3", "17x9x33"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_host_compiled_tiled_coeffs_matches_percell(on_host, dtype, shape, flags):
    check_tiled_coeffs(on_host[0], dtype, "cpu", shape, FLAGS[flags], TOL_REL[dtype])


NODES = 3
# the node axis: shapes ragged within a node and across the tiled body's
# footprint and z chunks
NODE_SHAPES = [(5, 7, 9), RAGGED]


def check_node_axis(launch_coeffs, launch_matvec, dtype, device, shape, flags, tol):
    """Both kernels over a node axis of NODES nodes with distinct fields:
    one launch each, bitwise equal to the NODES one-node launches stacked
    (fld_coeffs on its tiled and on its per-cell body), and within ``tol``
    of the plain versions on the stack (each output relative to its max
    |plain|)."""
    rad = port_radiation(shape=(NZ, NY, NX))
    ins = [operator_inputs(dtype, device, shape, seed=s) for s in range(1, NODES + 1)]
    E, chi, sf = (torch.stack([i[k] for i in ins]) for k in (0, 1, 3))
    dt = ins[0][2]
    const = (rad._wuni, RAD_CFG["c_code"], rad._ext, flags)
    n0 = (FLD.fld_coeffs_launches, FLD.fld_coeffs_node_launches, FLD.fld_matvec_launches,
          FLD.fld_matvec_node_launches)
    kc = launch_coeffs(E, chi, dt, *const)
    km = launch_matvec(E, kc[0], kc[1], sf)
    assert (FLD.fld_coeffs_launches - n0[0], FLD.fld_coeffs_node_launches - n0[1],
            FLD.fld_matvec_launches - n0[2], FLD.fld_matvec_node_launches - n0[3]) == (1, 1, 1, 1)
    assert kc[0].shape == (NODES, 6) + shape
    with FLD._percell_body():
        kp = launch_coeffs(E, chi, dt, *const)
    one = [launch_coeffs(E[n], chi[n], dt, *const) for n in range(NODES)]
    for k, p, o in zip(kc, kp, zip(*one)):
        assert torch.equal(k, torch.stack(o)) and torch.equal(k, p)
    assert torch.equal(km, torch.stack([launch_matvec(E[n], *one[n][:2], sf[n])
                                        for n in range(NODES)]))
    pc = FLD.fld_coeffs_reference(E, chi, dt, *const)
    pm = FLD.fld_matvec_reference(E, pc[0], pc[1], sf)
    for k, p in zip((*kc, km), (*pc, pm)):
        assert torch.isfinite(k).all()
        assert rel(k.double().cpu().numpy(), p.double().cpu().numpy()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", NODE_SHAPES, ids=["5x7x9", "17x9x33"])
def test_host_compiled_node_axis(on_host, dtype, shape):
    check_node_axis(*on_host, dtype, "cpu", shape, FLAGS["mixed"], TOL_REL[dtype])


def test_cpu_tensor_runs_the_plain_version():
    """On the CPU, fld_coeffs and fld_matvec are their plain versions and
    launch nothing."""
    rad = port_radiation()
    E, chi, dt, sf = operator_inputs(torch.float64, "cpu")
    n0 = (FLD.fld_coeffs_launches, FLD.fld_matvec_launches)
    args = (E, chi, dt, rad._wuni, 10.0, rad._ext, FLAGS["mixed"])
    for a, b in zip(FLD.fld_coeffs(*args), FLD.fld_coeffs_reference(*args)):
        assert torch.equal(a, b)
    A, dg, _ = FLD.fld_coeffs_reference(*args)
    assert torch.equal(FLD.fld_matvec(E, A, dg, sf), FLD.fld_matvec_reference(E, A, dg, sf))
    assert (FLD.fld_coeffs_launches, FLD.fld_matvec_launches) == n0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=["32x16x32", "5x7x9", "2x2x3"])
def test_kernels_match_plain(cuda, dtype, shape):
    """On the card: f64 <= 1e-12 relative, f32 <= 1e-5 relative."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    for flags in FLAGS.values():
        _, launches = check_kernels(FLD.fld_coeffs, FLD.fld_matvec, dtype, cuda, shape,
                                    flags, tol)
        torch.cuda.synchronize()
        assert launches == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_coeffs_matches_percell(cuda, dtype):
    """On the card: fld_coeffs' tiled body bitwise equal to its per-cell
    body, within 1e-12 (f64) / 1e-5 (f32) relative of the plain version."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    for shape in SHAPES + [RAGGED]:
        for flags in FLAGS.values():
            check_tiled_coeffs(FLD.fld_coeffs, dtype, cuda, shape, flags, tol)
            torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_node_axis_matches_one_node_launches(cuda, dtype):
    """On the card: node-axis launches of both kernels bitwise equal to
    one-node launches, within 1e-12 (f64) / 1e-5 (f32) relative of the
    plain versions on the stack."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    for shape in NODE_SHAPES + [(NZ, NY, NX)]:
        for flags in FLAGS.values():
            check_node_axis(FLD.fld_coeffs, FLD.fld_matvec, dtype, cuda, shape, flags, tol)
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_step_matches_tensor_step(cuda):
    """Radiation.step on the card through the kernels vs the tensor
    operator on the same card (float64): Er and u <= 1e-11 relative."""
    st = state_from_numpy(numpy_state(*random_fields()), cuda, torch.float64)
    outs = []
    for kernels in (True, False):
        rad = port_radiation(device=cuda)
        assert rad.use_kernels
        rad.use_kernels = kernels
        rad.set_edge_dirichlet(1, lo=0.7, hi=0.9)
        n0 = FLD.fld_matvec_launches
        outs.append(rad.step(st, 1e-3, with_iters=True))
        assert (FLD.fld_matvec_launches > n0) == kernels
    (a, ia), (b, ib) = outs
    assert ia == ib
    assert rel(a["rad"]["Er"].cpu(), b["rad"]["Er"].cpu()) <= 1e-11
    assert rel(a["gas"]["u"].cpu(), b["gas"]["u"].cpu()) <= 1e-11
