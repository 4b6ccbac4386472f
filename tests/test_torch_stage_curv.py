"""The curvilinear stage: the port's plain version ``stage_curv_reference``
against the JAX package's composable jnp sequences and its interpret-mode
gather kernel, and the CUDA kernel ``csrc/stage_curv.cu`` against the plain
version.

* ``stage_curv_reference`` vs the jnp sequences that
  ``tests/test_pallas_curv.py`` holds the TPU kernels to (full; full +
  diffusion; full + point gravity; partial + rotating frame) at 1e-11 in
  float64: the two make the same IEEE operations up to the order of the
  folded sources;
* one interpret-mode call of the JAX gather kernel (K3) on the disk_sph
  layout with viscosity, gravity and the rotating frame vs the plain version
  at 1e-10 (the kernel folds its sources in another order);
* the kernel's device code (everything above the source's "CUDA-only
  below" line, with ``stage_common.cuh``) compiled as host C++ with g++
  behind a few macros, driven through the real wrapper (``_launch``), vs
  the plain version at 1e-12 in float64 (1e-5 in float32) over {gather,
  padded} x {full, partial} x {hllc, hlle} x {pcm, plm} and the diffusion,
  gravity and rotating-frame variants, with the gather and padded halo
  sources bitwise equal on the disk layout;
* the six-face strip halo (K5a/K5b) on all-``ic`` layouts: the Cartesian
  disk of the radiation-hydro deck without diffusion (K5b) and the
  spherical disk with x3 ``ic`` and alpha viscosity (K5a, whose stencil
  reads the corners between ghost regions), bitwise equal to the padded
  halo and within the tolerances of the plain version;
* the node axis (TPU kernel K6): N = 1, 2, 3 Cartesian nodes with their
  own rows and six strips in one launch of the host-compiled device code,
  bitwise equal to N one-node launches and within 1e-13 (f64) / 1e-5 (f32)
  of ``stage_curv_batched_reference``;
* the tiled body, which every launch on a ghost width of two takes, full
  and partial (K3 and K5a with the viscous stencil, K5b and K6 without, K4
  from a padded array with and without it, K4's partial mode): its blocks
  run on the host phase by phase with shared memory starting as NaN,
  bitwise equal to the per-cell body on the same
  halo (the wrapper's private switch ``_percell_body``) and to the padded
  halo (u, w, and the dtden maxima: the bodies' block counts differ),
  within the plain version's tolerances, on the all-ic Cartesian disk, the all-ic spherical disk with
  and without viscosity and disk_sph (x3 wrapped), PLM/PCM x HLLC/HLLE;
  power-law and alpha viscosity with arithmetic and harmonic averages and
  conduction on the disk_sph layout, random diffusive nodes (conduction,
  thermal diffusion, a 2-D one), N = 1, 2, 3 nodes, ragged shapes with one
  and two z chunks (x3 wrapping across a chunk edge), and a 2-D node; the
  padded halo (K4) on every padded case and on the disk_cyl (x2 periodic
  through its ghosts) and disk_axi (2-D) states, f32 and f64, bitwise
  equal to the per-cell padded body; power-law viscosity on disk_sph's own
  float64 state, held relative to each component's maximum (cells at the
  density floor); a launch that the kernel's tiled_ok refuses (a ghost
  width of three) raises, full or partial;
* partial stages on the tiled body, bitwise equal in u to the per-cell
  body: the 2-D cylindrical decks (alpha_disk behind its viscous x1 fill,
  with gravity and cooling left to the chain; binary_cyl with the rotating
  frame folded, its binary gravity and damping left to the chain) within
  TOL_DISK of the plain version, and random partial
  nodes (a ragged 2-D viscous one, a 3-D one with two z chunks, a 2-D one
  with the rotating frame) within TOL in f64 and f32;
* the ``cuda``-marked tests run the same checks on the card.  They skip
  without a GPU; run them there with (``tests/conftest.py`` imports jax,
  which the card's machine lacks; the JAX comparisons import it only
  inside their tests)

      python -m pytest tests/test_torch_stage_curv.py -m cuda --noconftest -q
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
from artemis_tpu_torch.driver import curv_point_grav  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import stage_curv as SC  # noqa: E402
from artemis_tpu_torch.ops.diffusion import DiffParams, Diffusion  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.sources import Gravity, RotatingFrame  # noqa: E402
from artemis_tpu_torch.units import Constants, Units  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DISK_SPH = os.path.join(HERE, "..", "inputs", "disk_sph.in")
DISK_RHD = os.path.join(HERE, "..", "inputs", "disk_rhd_amr.in")
PADDED_DECKS = {d: os.path.join(HERE, "..", "inputs", f"{d}.in") for d in ("disk_cyl", "disk_axi")}
CSRC = os.path.join(os.path.dirname(SC.__file__), "..", "csrc")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the disk state: cells at the density floor (1e-10) amplify the two
# versions' different operation orders to ~150 ulps of the O(1) azimuthal
# velocity (3e-14 in float64, measured), so float32 is held to 150 ulps
# there too
TOL_DISK = {torch.float64: 1e-12, torch.float32: 1e-4}

# small ragged meshes (no multiple of any tile); the JAX comparisons use
# the same coordinate ranges as tests/test_pallas_curv.py
MESHES = {
    "cylindrical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                        x2min=-3.14159, x2max=3.14159, x3min=-0.3, x3max=0.3),
    "cartesian": dict(nx1=20, nx2=12, nx3=6, x1min=-2.0, x1max=2.0,
                      x2min=-1.0, x2max=1.0, x3min=-0.25, x3max=0.25),
    "spherical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                      x2min=0.8, x2max=2.3, x3min=-3.14159, x3max=3.14159),
    "axisymmetric": dict(nx1=20, nx2=12, nx3=1, x1min=0.4, x1max=2.0,
                         x2min=-0.6, x2max=0.6, x3min=-3.14, x3max=3.14),
}

VISC = {
    "plaw": DiffParams(kind="viscosity_plaw", nu_s=2.0e-3, eta=0.2, r_exp=0.5, R0=1.0),
    "alpha": DiffParams(kind="viscosity_alpha", alpha=1.0e-3, eta=0.0, R0=1.0, Omega0=1.0),
    "plaw_harm": DiffParams(kind="viscosity_plaw", avg="harmonic", nu_s=2.0e-3, eta=1.5,
                            r_exp=0.0, R0=1.0),
    "alpha_harm": DiffParams(kind="viscosity_alpha", avg="harmonic", alpha=2.0e-3, eta=0.3,
                             R0=1.0, Omega0=1.0),
}
COND = {
    "cond": DiffParams(kind="conductivity_plaw", hcond_0=1.0e-3, temp_exp=0.5, rho_exp=0.3,
                       T0=1.0, d0=1.0),
    "tdiff": DiffParams(kind="thermaldiff_plaw", avg="harmonic", kappa_0=1.0e-3,
                        temp_exp=0.4, rho_exp=0.0, T0=1.2, d0=1.0),
}


def deck_text(coords, rotating, nx=None):
    mesh = dict(MESHES[coords])
    if nx is not None:
        mesh.update(nx1=nx[0], nx2=nx[1], nx3=nx[2])
    return f"""
<artemis>
problem = constant
coordinates = {coords}
<parthenon/time>
tlim = 1.0
<parthenon/mesh>
nghost = 2
""" + "\n".join(f"{k} = {v}" for k, v in mesh.items()) + f"""
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = outflow
ox2_bc = outflow
ix3_bc = periodic
ox3_bc = periodic
<physics>
rotating_frame = {"true" if rotating else "false"}
<rotating_frame>
omega = 1.0
<gas>
gamma = 1.4
<gravity/point>
mass = 1.0
soft = 0.05
"""


def random_prims(grid, seed=2):
    """Smooth positive random primitives, as tests/test_pallas_curv.py makes
    them (numpy, float64)."""
    nz, ny, nx = tuple(reversed(grid.nx))
    rng = np.random.default_rng(seed)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = 0.4 * w[:, 0] * w[:, 5]
    return w


def port_setup(coords, rsolver="hllc", recon="plm", dtype=torch.float64, device="cpu",
               rotating=False, pos=None, nx=None):
    """Grid, Hydro, sources and a random state of the port (``nx``
    overrides the mesh's cell counts)."""
    pin = ParameterInput.from_string(deck_text(coords, rotating, nx))
    if pos is not None:
        pin.apply_overrides([f"gravity/point/{k}={v}" for k, v in zip("xyz", pos)])
    grid = grid_from_input(pin)
    cfg = FluidCfg(fluid="gas", recon=recon, rsolver=rsolver, gamma=1.4, cfl=0.3)
    hyd = Hydro(grid, cfg, device=device, dtype=dtype)
    u, w = hyd.prim_to_cons(torch.as_tensor(random_prims(grid), dtype=dtype, device=device),
                            cfg)
    constants = Constants.from_units(Units.from_input(pin))
    gsrc = Gravity(pin, grid, constants).place(device, dtype)
    rf = RotatingFrame(pin, grid).place(device, dtype)
    return types.SimpleNamespace(pin=pin, grid=grid, cfg=cfg, hyd=hyd, u=u, w=w, grav=gsrc,
                                 rf=rf)


def curv_stage(s, *, omf=0.0, visc=None, cond=None, grav=False, rf=False, full=True,
               strips=None, bc_custom=None):
    diff = (Diffusion(s.grid, s.hyd, s.cfg, visc, cond)
            if visc is not None or cond is not None else None)
    gmode = curv_point_grav(s.grid, s.grav) if grav else None
    return SC.CurvStage(s.hyd, omf=omf, rotating=s.rf if rf else None,
                        gravity=s.grav if grav else None, gmode=gmode, diffusion=diff,
                        full=full, strips=strips, bc_custom=bc_custom)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

def jax_side(coords, rotating, rsolver="hllc"):
    """The JAX package's grid, Hydro and the same random state."""
    jnp = pytest.importorskip("jax.numpy")

    from artemis_tpu.config import ParameterInput as JPin
    from artemis_tpu.grid import grid_from_input as jgrid
    from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro

    pin = JPin.from_string(deck_text(coords, rotating))
    grid = jgrid(pin)
    cfg = JCfg(fluid="gas", recon="plm", rsolver=rsolver, gamma=1.4, cfl=0.3)
    hyd = JHydro(grid, cfg)
    u, w = hyd.prim_to_cons(jnp.asarray(random_prims(grid)), cfg)
    return pin, grid, cfg, hyd, u, w


def jnp_stage(coords, *, pcm=False, rsolver="hllc", omf=0.0, diff=None, grav=False,
              rf=False, full=True):
    """The jnp sequence of tests/test_pallas_curv.py (bc -> fluxes -> update
    -> flux sources -> diffusion -> gravity -> rotating frame [-> aux ->
    C2P -> P2C]); returns numpy u, w and the CFL dt."""
    jnp = pytest.importorskip("jax.numpy")

    from artemis_tpu import bc as jbc
    from artemis_tpu.ops.diffusion import Diffusion as JDiffusion
    from artemis_tpu.sources import Gravity as JGravity, RotatingFrame as JRF
    from artemis_tpu.units import Constants as JConst, Units as JUnits

    pin, grid, cfg, hyd, u, w = jax_side(coords, rf, rsolver)
    gam0, gam1, bdt = 0.5, 0.5, 1e-3
    wp = jbc.pad_and_fill(w, grid, "gas", {})
    fx = hyd.compute_fluxes(wp, cfg, pcm)
    ur = hyd.apply_update(u, u * 1.0, fx, gam0, gam1, bdt)
    ur = hyd.flux_source(ur, w, fx, bdt, omf=omf)
    jd = None
    if diff is not None:
        jd = JDiffusion(grid, hyd, cfg, *diff)
        ur = jd.update(ur, w, jd.fluxes(wp), bdt)
    st = {"gas": {"u": ur, "w": w}}
    if grav:
        g = JGravity(pin, grid, JConst.from_units(JUnits.from_input(pin)))
        st = g.apply(st, {"gas": fx}, jnp.asarray(0.0), jnp.asarray(bdt), hyd)
    if rf:
        st = JRF(pin, grid).apply(st, {"gas": fx}, 0.0, bdt, hyd)
    ur = st["gas"]["u"]
    if not full:
        return np.asarray(ur), np.asarray(w), None
    ur = hyd.set_auxiliary(ur, cfg)
    ur, wr = hyd.prim_to_cons(hyd.cons_to_prim(ur, cfg), cfg)
    dt = float(hyd.estimate_dt(wr, cfg))
    if jd is not None:
        dt = min(dt, float(cfg.cfl * jd.estimate_dt(wr)))
    return np.asarray(ur), np.asarray(wr), dt


# the 3-D meshes only: JAX compiles its eager ops once per shape, and the
# 2-D axisymmetric chain is held to JAX by tests/test_torch_disk.py's
# disk_axi slice (and its sources and diffusion by their own files)
JNP_CASES = {
    # name: (coords, options)
    **{f"full-{c}": (c, dict(omf=0.7)) for c in ("cylindrical", "spherical", "cartesian")},
    "full-pcm-spherical": ("spherical", dict(pcm=True, omf=0.7)),
    "full-hlle-spherical": ("spherical", dict(rsolver="hlle")),
    **{f"diff-{m}-{c}": (c, dict(diff=(VISC[m], COND["cond"])))
       for c in ("cylindrical", "spherical") for m in ("plaw", "alpha")},
    **{f"grav-{c}": (c, dict(grav=True)) for c in ("cylindrical", "spherical", "cartesian")},
    **{f"partial-rf-{c}": (c, dict(omf=1.0, rf=True, full=False))
       for c in ("cylindrical", "spherical")},
}


@pytest.mark.parametrize("case", list(JNP_CASES))
def test_reference_matches_jnp_sequence(case):
    """stage_curv_reference vs the jnp sequence: u, w <= 1e-11 abs and the
    CFL dt <= 1e-11 relative (float64)."""
    coords, opt = JNP_CASES[case]
    opt = dict(opt)
    pcm = opt.pop("pcm", False)
    rsolver = opt.pop("rsolver", "hllc")
    ur, wr, dt_ref = jnp_stage(coords, pcm=pcm, rsolver=rsolver, **opt)
    s = port_setup(coords, rsolver=rsolver, rotating=opt.get("rf", False))
    diff = opt.get("diff")
    cs = curv_stage(s, omf=opt.get("omf", 0.0), visc=diff[0] if diff else None,
                    cond=diff[1] if diff else None, grav=opt.get("grav", False),
                    rf=opt.get("rf", False), full=opt.get("full", True))
    dt = torch.full((), 2e-3, dtype=torch.float64)
    u, w, den = SC.stage_curv_reference(cs, s.w, s.u, s.u * 1.0, 0.5, 0.5, 0.5, dt, 0.0, pcm)
    assert float(np.abs(u.numpy() - ur).max()) <= 1e-11
    assert float(np.abs(w.numpy() - wr).max()) <= 1e-11
    if dt_ref is not None:
        assert abs(s.cfg.cfl / float(den[0]) - dt_ref) <= 1e-11 * dt_ref


def test_reference_matches_interpret_gather_kernel(tmp_path):
    """The JAX gather kernel (K3, interpret mode) on disk_sph at 128x32x16
    with alpha viscosity, point gravity and the rotating frame vs the plain
    version: u, w <= 1e-10 abs, dtden maximum <= 1e-10 relative (float64)."""
    jnp = pytest.importorskip("jax.numpy")

    from artemis_tpu.ops import pallas_stage_curv as psc
    from artemis_tpu.simulation import Simulation as JSimulation

    ov = ["parthenon/time/nlim=0", "parthenon/mesh/nx1=128", "parthenon/mesh/nx2=32",
          "parthenon/mesh/nx3=16", "parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4"]
    jsim = JSimulation(DISK_SPH, ov, str(tmp_path / "jax"))
    drv = jsim.driver
    grid, cfg = jsim.grid, jsim.gas_cfg
    co = psc.CurvCoeffs(grid, drv.omf, dtype=np.float64, diff=drv.diffusion)
    strips = psc.prepare_gather_strips(grid, drv.bc_custom["ic"].shard_caches[0])
    gsrc = [s for s in drv.sources if hasattr(s, "gtype")][0]
    u, w = jsim.state["gas"]["u"], jsim.state["gas"]["w"]
    uk, wk, dk = psc.stage_curv_gather(
        w, u, u, grid, cfg, 0.5, 0.5, 1e-4, False, co, co.pack(), strips,
        rf_omega=drv.omf, grav=(gsrc.gm, gsrc.soft2, "cart", (0.0, 0.0, 0.0)),
        grav_dt=1e-4, interpret=True)

    tsim = Simulation(DISK_SPH, ov, str(tmp_path / "port"), device="cpu")
    td = tsim.driver
    grav = [s for s in td.sources if isinstance(s, Gravity)][0]
    rf = [s for s in td.sources if isinstance(s, RotatingFrame)][0]
    cs = SC.CurvStage(td.hydro, omf=td.omf, rotating=rf, gravity=grav,
                      gmode=curv_point_grav(tsim.grid, grav), diffusion=td.diffusion,
                      bc_custom=td.bc_custom)
    tu = torch.as_tensor(np.array(u))
    tw = torch.as_tensor(np.array(w))
    dt = torch.full((), 2e-4, dtype=torch.float64)
    ur, wr, dr = SC.stage_curv_reference(cs, tw, tu, tu, 0.5, 0.5, 0.5, dt, 0.0, False)
    assert float(np.abs(ur.numpy() - np.asarray(uk)).max()) <= 1e-10
    assert float(np.abs(wr.numpy() - np.asarray(wk)).max()) <= 1e-10
    dmax = float(jnp.max(dk))
    assert abs(float(dr[0]) - dmax) <= 1e-10 * dmax


def test_cpu_tensor_runs_the_plain_version():
    """On the CPU, stage_curv is stage_curv_reference and launches nothing."""
    s = port_setup("spherical", rotating=True)
    cs = curv_stage(s, omf=1.0, visc=VISC["alpha"], grav=True, rf=True)
    dt = torch.full((), 2e-3, dtype=torch.float64)
    n0 = SC.stage_curv_launches
    a = SC.stage_curv(cs, s.w, s.u, s.u, 0.5, 0.5, 0.5, dt, 0.0, False)
    b = SC.stage_curv_reference(cs, s.w, s.u, s.u, 0.5, 0.5, 0.5, dt, 0.0, False)
    assert SC.stage_curv_launches == n0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the kernel against the plain version
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
#define __noinline__
#define __launch_bounds__(x)
#define __align__(x)
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::sqrt;
using std::fabs;
using std::pow;
"""

HOST_ENTRY = r"""
template <typename T, bool G, bool F>
void run(const CurvParams& p) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  for (int k = 0; k < p.nnodes; ++k) {
    const NodePtrs& nd = p.node[k];
    T* dmax = static_cast<T*>(nd.dmax);
    for (int64_t b = 0; b * kBlock < n; ++b) {
      T m = T(0);
      for (int64_t cell = b * kBlock; cell < n && cell < (b + 1) * kBlock; ++cell)
        m = vmax(m, curv_cell<T, G, F>(p, nd, cell));
      if (F) dmax[b] = m;
    }
  }
}
// The tiled body's block, phase by phase: each phase runs for every thread
// before the next starts (what __syncthreads gives on the card).
template <typename T, bool D>
struct HostExec {
  std::vector<TileThread<T, D>> st = std::vector<TileThread<T, D>>(TileLayout<T, D>::NT);
  template <class Fn>
  void each(Fn&& f) {
    for (int t = 0; t < TileLayout<T, D>::NT; ++t) f(t, st[t]);
  }
};
// Shared memory starts as NaN in every block: a read of an element no
// phase wrote would show in the outputs.
template <typename T, bool D, bool F>
void run_tiled(const CurvParams& p) {
  const int64_t nb = tile_count<T, D>(p.n.nx, p.n.ny, p.n.nz);
  for (int k = 0; k < p.nnodes; ++k)
    for (int64_t b = 0; b < nb; ++b) {
      std::vector<T> smem(TileLayout<T, D>::ELEMS, std::numeric_limits<T>::quiet_NaN());
      HostExec<T, D> ex;
      tile_block<T, D, F>(p, p.node[k], b, smem.data(), ex);
    }
}
template <typename T, bool F>
void run_mode(const CurvParams& p, int gather, int tiled) {
  if (tiled) return tiled_diff(p) ? run_tiled<T, true, F>(p) : run_tiled<T, false, F>(p);
  return gather ? run<T, true, F>(p) : run<T, false, F>(p);
}
template <typename T>
void run_t(const CurvParams& p, int gather, int full, int tiled) {
  return full ? run_mode<T, true>(p, gather, tiled) : run_mode<T, false>(p, gather, tiled);
}
}  // namespace
extern "C" int artemis_stage_curv(int dtype, int halo, int full, int tiled, const int* ints,
                                  const double* reals, const void* const* ptrs,
                                  int nptrs, int nnodes, int ndmax, void*) {
  CurvParams p;
  if (!make_params(halo, ints, reals, ptrs, nptrs, nnodes, &p) ||
      (tiled && !tiled_ok(p)) || ndmax != (full ? dtden_len(p, dtype, tiled) : 0))
    return 1;
  const int gather = halo != kPadded;
  if (dtype == 0) run_t<float>(p, gather, full, tiled);
  else run_t<double>(p, gather, full, tiled);
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
    src = open(os.path.join(CSRC, "stage_curv.cu")).read()
    device_part = src[:src.index("// ---- CUDA-only below")]
    device_part = device_part.replace("#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp("host_curv")
    cpp, so = out / "stage_curv_host.cpp", out / "libstage_curv_host.so"
    cpp.write_text(HOST_SHIM + device_part + HOST_ENTRY)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-w", "-shared",
                          "-fPIC", "-I", CSRC, "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(so)).artemis_stage_curv
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [i, i, i, i, p, p, p, i, i, i, p]
    return fn


@pytest.fixture
def on_host(host_kernel, monkeypatch):
    """Route the wrapper's launch to the host build (CPU tensors)."""
    monkeypatch.setattr(SC, "_lib", lambda dtype, full=True: host_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))

    def launch(cs, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm, padded=False):
        from artemis_tpu_torch import bc as bc_mod

        if cs.strips is not None and not padded:
            return SC._launch(cs, w, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
                              cs.halo)
        w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
        return SC._launch(cs, w_pad, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
                          "padded")

    return launch


def check_against_plain(cs, w, u, dtype, launch, padded=False, time=0.0, tols=TOL):
    """Both RK register patterns (gam0 = 0 and != 0): u, w within tols[dtype]
    abs, the dtden maximum within tols[dtype] relative; one launch per call.
    Returns the kernel's outputs of the second pattern."""
    tol = tols[dtype]
    dt = torch.full((), 2e-3, dtype=dtype, device=u.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        n0 = SC.stage_curv_launches
        uk, wk, dk = launch(cs, w, u, u.clone(), gam0, gam1, beta, dt, time, False,
                            padded=padded)
        ur, wr, dr = SC.stage_curv_reference(cs, w, u, u.clone(), gam0, gam1, beta, dt,
                                             time, False)
        assert SC.stage_curv_launches == n0 + 1
        assert torch.isfinite(uk).all() and torch.isfinite(wk).all()
        assert float((uk - ur).abs().max()) <= tol
        assert float((wk - wr).abs().max()) <= tol
        if cs.full:
            assert float((dk.max() - dr.max()).abs() / dr.max()) <= tol
    return uk, wk, dk


# padded-halo variants on random states: (coords, options)
PADDED_CASES = {
    "cyl-plaw+cond-grav-rf": ("cylindrical", dict(visc="plaw", cond="cond", grav=True,
                                                  rf=True, omf=1.0)),
    "sph-alpha-grav-rf": ("spherical", dict(visc="alpha", grav=True, rf=True, omf=1.0)),
    "sph-harmonic-visc+tdiff": ("spherical", dict(visc="plaw_harm", cond="tdiff")),
    "axi-alpha-grav-rf": ("axisymmetric", dict(visc="alpha", grav=True, rf=True, omf=1.0)),
    "axi-tdiff": ("axisymmetric", dict(cond="tdiff")),
    "cart-grav-xyz": ("cartesian", dict(grav=True, pos=(0.3, -0.2, 0.1))),
    "cyl-hydro-only": ("cylindrical", dict(omf=0.7)),
}


def padded_case_stage(case, scheme, full=True, dtype=torch.float64, device="cpu"):
    """A PADDED_CASES case's CurvStage on its random state: (stage, w, u)."""
    coords, opt = PADDED_CASES[case]
    rsolver, recon = scheme.split("-")
    s = port_setup(coords, rsolver=rsolver, recon=recon, dtype=dtype, device=device,
                   rotating=opt.get("rf", False), pos=opt.get("pos"))
    cs = curv_stage(s, omf=opt.get("omf", 0.0), visc=VISC.get(opt.get("visc")),
                    cond=COND.get(opt.get("cond")), grav=opt.get("grav", False),
                    rf=opt.get("rf", False), full=full)
    return cs, s.w, s.u


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("scheme", ["hllc-plm", "hlle-pcm", "hlle-plm", "hllc-pcm"])
@pytest.mark.parametrize("case", list(PADDED_CASES))
def test_host_compiled_padded_kernel_matches_plain(on_host, case, scheme, full):
    """Full and partial stages, both on the tiled body."""
    cs, w, u = padded_case_stage(case, scheme, full)
    assert cs.tiled("padded")
    n0 = SC.tiled_launches
    check_against_plain(cs, w, u, torch.float64, on_host)
    assert SC.tiled_launches == n0 + 2


def disk_stage(dtype, device, rsolver="hlle", recon="plm", full=True, nx=(20, 12, 6),
               data_dir=None, diff=None):
    """The disk_sph deck at a small ragged size over r in [0.4, 2.4] (alpha
    viscosity, point gravity, rotating frame; x1/x2 ic, x3 periodic): its
    initial state and a CurvStage with the ic strips; ``diff`` (viscosity,
    conduction) replaces the deck's diffusion."""
    sim = Simulation(DISK_SPH, [f"parthenon/mesh/nx1={nx[0]}", f"parthenon/mesh/nx2={nx[1]}",
                                f"parthenon/mesh/nx3={nx[2]}", "parthenon/time/nlim=0",
                                "parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4",
                                f"gas/riemann={rsolver}", f"gas/reconstruct={recon}",
                                "artemis/precision=" + str(dtype).removeprefix("torch.")],
                     data_dir, device=device, fused_stage=False)
    d = sim.driver
    grav = [s for s in d.sources if isinstance(s, Gravity)][0]
    rf = [s for s in d.sources if isinstance(s, RotatingFrame)][0]
    assert SC.gather_supported(sim.grid, sim.gas_cfg, d.bc_custom)
    strips = SC.prepare_gather_strips(sim.grid, d.bc_custom["ic"].shard_caches[0])
    diffusion = (d.diffusion if diff is None
                 else Diffusion(sim.grid, d.hydro, sim.gas_cfg, *diff))
    cs = SC.CurvStage(d.hydro, omf=d.omf, rotating=rf, gravity=grav,
                      gmode=curv_point_grav(sim.grid, grav), diffusion=diffusion,
                      full=full, strips=strips, bc_custom=d.bc_custom)
    return cs, sim.state["gas"]["w"], sim.state["gas"]["u"]


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("scheme", ["hlle-plm", "hllc-plm", "hlle-pcm", "hllc-pcm"])
def test_host_compiled_disk_kernel_gather_and_padded(on_host, tmp_path, scheme, full):
    """The disk layout through both halo sources: each against the plain
    version, and the two bitwise equal (the gather sources every halo cell,
    corners included, as stage_curv_gather does; full and partial stages
    take the tiled body, and the full ones' dtden outputs are compared by
    their maxima)."""
    rsolver, recon = scheme.split("-")
    cs, w, u = disk_stage(torch.float64, "cpu", rsolver, recon, full, data_dir=str(tmp_path))
    assert cs.tiled("gather") and cs.tiled("padded")
    n0 = SC.tiled_launches
    ug, wg, dg = check_against_plain(cs, w, u, torch.float64, on_host, tols=TOL_DISK)
    up, wp, dp = check_against_plain(cs, w, u, torch.float64, on_host, padded=True,
                                     tols=TOL_DISK)
    assert SC.tiled_launches == n0 + 4
    assert torch.equal(ug, up) and torch.equal(wg, wp)
    if full:
        assert torch.equal(dg.amax(), dp.amax())


def test_host_compiled_kernel_float32(on_host, tmp_path):
    """Float32 through both halo sources on the disk layout (<= 1e-4 abs
    against the float32 plain version, TOL_DISK) and one padded curvilinear
    case on a random state (<= 1e-5)."""
    cs, w, u = disk_stage(torch.float32, "cpu", data_dir=str(tmp_path))
    check_against_plain(cs, w, u, torch.float32, on_host, tols=TOL_DISK)
    check_against_plain(cs, w, u, torch.float32, on_host, padded=True, tols=TOL_DISK)
    s = port_setup("cylindrical", dtype=torch.float32, rotating=True)
    cs = curv_stage(s, omf=1.0, visc=VISC["plaw"], cond=COND["cond"], grav=True, rf=True)
    check_against_plain(cs, s.w, s.u, torch.float32, on_host)


def allic_stage(dtype, device, deck, data_dir, nx=(20, 12, 6), scheme=None):
    """An all-``ic`` disk at a small ragged size through the user entry
    point (plain path), and its CurvStage with the six face strips, as the
    driver makes it on the card: ``deck`` "cartesian" is the radiation-hydro
    deck without refinement and radiation (point gravity, no diffusion:
    K5b); "spherical" is disk_sph with x3 ``ic`` over r in [0.4, 2.4]
    (alpha viscosity, point gravity, rotating frame: K5a); "spherical-
    inviscid" the same without viscosity (a six-face launch of the tiled
    body with Mignone PLM on x1 and x2, connection and frame terms).
    ``scheme`` ("hllc-plm", ...) overrides the deck's solver and
    reconstruction.  Returns the stage, the initial w and u, and the
    driver."""
    ov = [f"parthenon/mesh/nx1={nx[0]}", f"parthenon/mesh/nx2={nx[1]}",
          f"parthenon/mesh/nx3={nx[2]}", "parthenon/time/nlim=0",
          "artemis/precision=" + str(dtype).removeprefix("torch.")]
    if scheme is not None:
        rsolver, recon = scheme.split("-")
        ov += [f"gas/riemann={rsolver}", f"gas/reconstruct={recon}"]
    if deck == "cartesian":
        path = DISK_RHD
        ov += ["parthenon/mesh/refinement=none", "physics/radiation=false"]
    else:
        path = DISK_SPH
        ov += ["parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4",
               "parthenon/mesh/ix3_bc=ic", "parthenon/mesh/ox3_bc=ic"]
        if deck == "spherical-inviscid":
            ov += ["physics/viscosity=false"]
    sim = Simulation(path, ov, data_dir, device=device, fused_stage=False)
    d = sim.driver
    grav = [s for s in d.sources if isinstance(s, Gravity)][0]
    rf = [s for s in d.sources if isinstance(s, RotatingFrame)]
    assert SC.gather6_supported(sim.grid) and not SC.gather_supported(
        sim.grid, sim.gas_cfg, d.bc_custom)
    strips = SC.prepare_gather6_root_strips(sim.grid, d.bc_custom["ic"].shard_caches[0])
    cs = SC.CurvStage(d.hydro, omf=d.omf, rotating=rf[0] if rf else None, gravity=grav,
                      gmode=curv_point_grav(sim.grid, grav), diffusion=d.diffusion,
                      strips=strips, bc_custom=d.bc_custom)
    assert cs.halo == "gather6" and (d.diffusion is not None) == (deck == "spherical")
    return cs, sim.state["gas"]["w"], sim.state["gas"]["u"], d


@pytest.mark.parametrize("deck", ["cartesian", "spherical"], ids=["K5b-cart", "K5a-sph-visc"])
def test_host_compiled_gather6_equals_padded(on_host, tmp_path, deck):
    """The six-face strip halo against the plain version and bitwise equal
    to the padded halo (float64; the viscous stencil of the spherical case
    reads every kind of ghost corner)."""
    cs, w, u, _ = allic_stage(torch.float64, "cpu", deck, str(tmp_path))
    ug, wg, dg = check_against_plain(cs, w, u, torch.float64, on_host, tols=TOL_DISK)
    up, wp, dp = check_against_plain(cs, w, u, torch.float64, on_host, padded=True,
                                     tols=TOL_DISK)
    # K5b takes the tiled body, whose dtden holds one maximum per tile
    assert torch.equal(ug, up) and torch.equal(wg, wp) and torch.equal(dg.amax(), dp.amax())


def test_host_compiled_gather6_float32(on_host, tmp_path):
    """Float32 on the Cartesian all-ic disk: six-face == padded bitwise,
    both within TOL_DISK of the float32 plain version."""
    cs, w, u, _ = allic_stage(torch.float32, "cpu", "cartesian", str(tmp_path))
    ug, wg, _ = check_against_plain(cs, w, u, torch.float32, on_host, tols=TOL_DISK)
    up, wp, _ = check_against_plain(cs, w, u, torch.float32, on_host, padded=True,
                                    tols=TOL_DISK)
    assert torch.equal(ug, up) and torch.equal(wg, wp)


def test_gather6_strips_cover_the_ghost_faces(tmp_path):
    """The x3 strips hold the padded array's x3 ghost slabs over the
    interior x and y ranges, and the driver of a card run picks the
    six-face halo for the all-ic layouts (its gate, checked on the CPU)."""
    cs, w, _, d = allic_stage(torch.float64, "cpu", "cartesian", str(tmp_path))
    assert d._make_curv_stage(cs.grid, cs.cfg).halo == "gather6"
    from artemis_tpu_torch import bc as bc_mod

    ng = cs.grid.nghost
    nx, ny, nz = cs.grid.nx
    wp = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)[0]
    assert torch.equal(cs.strips[("x3", 0)], wp[:, :ng, ng:ng + ny, ng:ng + nx])
    assert torch.equal(cs.strips[("x3", 1)], wp[:, nz + ng:, ng:ng + ny, ng:ng + nx])
    assert tuple(cs.strips[("x1", 0)].shape) == (6, nz + 2 * ng, ny + 2 * ng, ng)


def test_launch_refuses_a_halo_the_stage_lacks(tmp_path):
    """A gather6 launch of a stage with the x1/x2 strips only raises before
    reaching the kernel."""
    cs, w, u = disk_stage(torch.float64, "cpu", data_dir=str(tmp_path))
    dt = torch.full((), 1e-3, dtype=torch.float64)
    with pytest.raises(ValueError, match="gather6"):
        SC._launch(cs, w, w, u, u, 0.5, 0.5, 0.5, dt, 0.0, False, "gather6")


def test_host_compiled_kernel_gravity_window(on_host):
    """Outside the gravity source's tstart/tstop window the kernel adds no
    gravity, as Gravity.apply does."""
    s = port_setup("spherical")
    s.grav.tstart, s.grav.tstop = 1.0, 2.0
    cs = curv_stage(s, grav=True)
    check_against_plain(cs, s.w, s.u, torch.float64, on_host, time=0.5)
    check_against_plain(cs, s.w, s.u, torch.float64, on_host, time=1.5)


# ---------------------------------------------------------------------------
# the node axis (K6): N nodes of one shape in one launch
# ---------------------------------------------------------------------------

def random_strips(grid, rng, dtype, device):
    """Six-face strips of smooth positive random primitives."""
    out = {}
    for key, shp in zip(SC.STRIP_KEYS, SC.strip_shapes(grid)):
        a = np.empty(shp)
        a[0] = 1 + 0.2 * rng.random(shp[1:])
        a[1:4] = 0.3 * (rng.random((3,) + shp[1:]) - 0.5)
        a[5] = 1 + 0.2 * rng.random(shp[1:])
        a[4] = 0.4 * a[0] * a[5]
        out[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return out


def batch_nodes(n, dtype, device, seed=4):
    """``n`` Cartesian nodes of one shape (20x12x6) over different boxes, so
    each has its own coefficient rows, with the same folded point mass
    (xyz mode), random states and random six-face strips: (stages, ws, us,
    strips)."""
    rng = np.random.default_rng(seed)
    stages, ws, us, strips = [], [], [], []
    for k in range(n):
        s = port_setup("cartesian", dtype=dtype, device=device, pos=(0.3, -0.2, 0.1))
        pin = s.pin
        pin.apply_overrides([f"parthenon/mesh/x1min={-2.0 + 0.25 * k}",
                             f"parthenon/mesh/x1max={2.0 + 0.5 * k}",
                             f"parthenon/mesh/x2min={-1.0 - 0.125 * k}"])
        grid = grid_from_input(pin)
        hyd = Hydro(grid, s.cfg, device=device, dtype=dtype)
        u, w = hyd.prim_to_cons(torch.as_tensor(random_prims(grid, seed + k), dtype=dtype,
                                                device=device), s.cfg)
        grav = Gravity(pin, grid, Constants.from_units(Units.from_input(pin))).place(device,
                                                                                     dtype)
        stages.append(SC.CurvStage(hyd, gravity=grav, gmode=curv_point_grav(grid, grav)))
        ws.append(w)
        us.append(u)
        strips.append(random_strips(grid, rng, dtype, device))
    return stages, ws, us, strips


def check_batched(stages, ws, us, strips, dtype, batched, single, tol):
    """Both RK register patterns: the N-node launch bitwise equal to N
    one-node launches of the same nodes, each node within ``tol`` (u, w
    absolute; dtden maximum relative) of the plain version."""
    dt = torch.full((1,), 2e-3, dtype=dtype, device=ws[0].device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        u1s = [u.clone() for u in us]
        args = (gam0, gam1, beta, dt, 0.0, False)
        nb = SC.stage_curv_batched_launches
        out = batched(stages, ws, us, u1s, strips, *args)
        one = [single(cs, w, u, u1, st, *args) for cs, w, u, u1, st in zip(stages, ws, us, u1s,
                                                                          strips)]
        ref = SC.stage_curv_batched_reference(stages, ws, us, u1s, strips, *args)
        assert SC.stage_curv_batched_launches == nb + (batched is SC.stage_curv_batched)
        for (ub, wb, db), (uo, wo, do), (ur, wr, dr) in zip(out, one, ref):
            assert torch.equal(ub, uo) and torch.equal(wb, wo) and torch.equal(db, do)
            assert torch.isfinite(ub).all() and torch.isfinite(wb).all()
            assert float((ub - ur).abs().max()) <= tol
            assert float((wb - wr).abs().max()) <= tol
            assert float((db.max() - dr.max()).abs() / dr.max()) <= tol


def host_batched(stages, ws, us, u1s, strips, *args):
    return SC._launch_nodes(stages, ws, us, u1s, *args, "gather6", strips)


def host_single(cs, w, u, u1, strips, *args):
    return SC._launch_nodes([cs], [w], [u], [u1], *args, "gather6", [strips])[0]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_host_compiled_batched_kernel(on_host, n, dtype, tol):
    """The kernel's node axis, compiled for the host: N = 1, 2, 3 nodes with
    their own rows and strips, bitwise equal to N one-node launches, within
    1e-13 (f64) / 1e-5 (f32) of stage_curv_batched_reference."""
    stages, ws, us, strips = batch_nodes(n, dtype, "cpu")
    assert SC.gather6_batch_ok(stages) == (n >= 2)
    assert all(not torch.equal(stages[0].rows[0], cs.rows[0]) for cs in stages[1:])
    check_batched(stages, ws, us, strips, dtype, host_batched, host_single, tol)


def test_batched_launch_refuses_mixed_nodes(on_host):
    """Nodes of two grid shapes, or strips of the wrong shape, raise before
    the launch; the gate refuses a node with diffusion or a rotating frame."""
    stages, ws, us, strips = batch_nodes(2, torch.float64, "cpu")
    dt = torch.full((1,), 1e-3, dtype=torch.float64)
    args = (0.5, 0.5, 0.5, dt, 0.0, False, "gather6")
    other = port_setup("cartesian")
    odd = SC.CurvStage(other.hyd)
    with pytest.raises(ValueError, match="share the grid shape"):
        SC._launch_nodes([stages[0], odd], ws, us, us, *args, strips)
    bad = dict(strips[1])
    bad[("x3", 0)] = bad[("x3", 0)][:, :1].contiguous()
    with pytest.raises(ValueError, match="wrong shape"):
        SC._launch_nodes(stages, ws, us, us, *args, [strips[0], bad])
    s = port_setup("spherical", rotating=True)
    assert not SC.gather6_batch_ok([curv_stage(s), curv_stage(s, omf=1.0, rf=True)])
    assert not SC.gather6_batch_ok([curv_stage(s), curv_stage(s, visc=VISC["alpha"])])


def test_cpu_batched_stage_runs_the_plain_version():
    """On the CPU, stage_curv_batched is its plain version and launches
    nothing."""
    stages, ws, us, strips = batch_nodes(2, torch.float64, "cpu")
    dt = torch.full((1,), 1e-3, dtype=torch.float64)
    n0 = SC.stage_curv_batched_launches
    a = SC.stage_curv_batched(stages, ws, us, us, strips, 0.5, 0.5, 0.5, dt, 0.0, False)
    b = SC.stage_curv_batched_reference(stages, ws, us, us, strips, 0.5, 0.5, 0.5, dt, 0.0,
                                        False)
    assert SC.stage_curv_batched_launches == n0
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


# ---------------------------------------------------------------------------
# the tiled body (K5b, and K6 as its node axis)
# ---------------------------------------------------------------------------

def check_tiled(cs, w, u, dtype, tol, rel=False):
    """A gather launch of ``cs`` (with its strips: six, or x1/x2 with x3
    wrapped) takes the tiled body: bitwise equal (u, w, the dtden maximum)
    to the per-cell body on the same halo (the wrapper's private switch)
    and to the padded halo made from the same strips, and within ``tol`` of
    the plain version (u, w absolute, or with ``rel`` relative to each
    component's maximum |plain|; the dtden maximum relative), both RK
    register patterns; dtden has one entry per block of each body."""
    halo = cs.halo
    assert halo in ("gather", "gather6") and cs.tiled(halo)
    if halo == "gather6":
        w_pad = SC.pad_from_strips(w, cs.grid, cs.strips)
    else:
        from artemis_tpu_torch import bc as bc_mod

        w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    dt = torch.full((1,), 2e-3, dtype=dtype, device=w.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        args = (u, u.clone(), gam0, gam1, beta, dt, 0.0, False)
        ut, wt, dt_ = SC._launch(cs, w, w, *args, halo)
        with SC._percell_body():
            uc, wc, dc = SC._launch(cs, w, w, *args, halo)
        up, wp, dp = SC._launch(cs, w_pad, w, *args, "padded")
        ur, wr, dr = SC.stage_curv_reference(cs, w, *args, w_pad=w_pad)
        assert dt_.numel() == cs.dtden_blocks(True) and dc.numel() == cs.dtden_blocks()
        assert torch.equal(ut, uc) and torch.equal(wt, wc) and torch.equal(dt_.amax(), dc.amax())
        assert torch.equal(ut, up) and torch.equal(wt, wp) and torch.equal(dt_.amax(), dp.amax())
        assert torch.isfinite(ut).all() and torch.isfinite(wt).all()
        err = component_rel_err if rel else (lambda a, b: float((a - b).abs().max()))
        assert err(ut, ur) <= tol and err(wt, wr) <= tol
        assert float((dt_.max() - dr.max()).abs() / dr.max()) <= tol


def component_rel_err(a, b):
    """max |a - b| / max |b| over each component (axis 1) of a stage output."""
    dims = (0,) + tuple(range(2, a.ndim))
    return float(((a - b).abs().amax(dim=dims) / b.abs().amax(dim=dims)).max())


SCHEMES = ["hllc-plm", "hlle-plm", "hllc-pcm", "hlle-pcm"]
# the decks' gather stages: the all-ic Cartesian disk and the all-ic
# spherical disk without viscosity (K5b), disk_sph with x3 ic (K5a) and
# disk_sph itself (K3: x1/x2 ic strips, x3 wrapped), both with alpha
# viscosity, point gravity and the rotating frame
TILED_DECKS = ["cartesian", "spherical-inviscid", "spherical", "disk_sph"]
TILED_IDS = ["K5b-cart", "K5b-sph", "K5a-sph-visc", "K3-sph-visc"]


def tiled_stage(deck, dtype, device, data_dir, scheme=None, nx=(20, 12, 6), diff=None):
    """A TILED_DECKS deck's gather stage with its strips, the initial w and
    u (``diff`` replaces disk_sph's diffusion)."""
    if deck == "disk_sph":
        rsolver, recon = (scheme or "hlle-plm").split("-")
        return disk_stage(dtype, device, rsolver, recon, nx=nx, data_dir=data_dir, diff=diff)
    cs, w, u, _ = allic_stage(dtype, device, deck, data_dir, nx=nx, scheme=scheme)
    return cs, w, u


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("deck", TILED_DECKS, ids=TILED_IDS)
def test_host_compiled_tiled_matches_percell(on_host, tmp_path, deck, scheme):
    """The tiled body compiled for the host (float64), block by block and
    phase by phase, with shared memory starting as NaN, on each deck's
    gather stage (the viscous ones through the diffusive body), PLM and
    PCM x HLLC and HLLE."""
    cs, w, u = tiled_stage(deck, torch.float64, "cpu", str(tmp_path), scheme)
    assert cs.diffusive == (deck in ("spherical", "disk_sph"))
    check_tiled(cs, w, u, torch.float64, TOL_DISK[torch.float64])


@pytest.mark.parametrize("deck", TILED_DECKS, ids=TILED_IDS)
def test_host_compiled_tiled_float32(on_host, tmp_path, deck):
    cs, w, u = tiled_stage(deck, torch.float32, "cpu", str(tmp_path))
    check_tiled(cs, w, u, torch.float32, TOL_DISK[torch.float32])


def strip_node(coords, dtype, device, nx=None, seed=5):
    """A node of ``coords`` (``nx`` cells, default the mesh's) with point
    gravity, a random state and random six-face strips: its CurvStage, w
    and u."""
    s = port_setup(coords, dtype=dtype, device=device, nx=nx)
    strips = random_strips(s.grid, np.random.default_rng(seed), torch.float64, "cpu")
    cs = SC.CurvStage(s.hyd, gravity=s.grav, gmode=curv_point_grav(s.grid, s.grav),
                      strips={k: v.numpy() for k, v in strips.items()})
    return cs, s.w, s.u


# shapes off the footprint in x and y: one z chunk shorter than the ring's
# reach, and two z chunks with a short second one
RAGGED = [(40, 12, 6), (36, 10, 18)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nx", RAGGED, ids=["40x12x6", "36x10x18"])
def test_host_compiled_tiled_ragged(on_host, nx, dtype):
    """Cartesian nodes with random states and strips at ragged shapes."""
    cs, w, u = strip_node("cartesian", dtype, "cpu", nx=nx)
    tx, ty, tz = SC.TILE[(dtype, False)]
    assert cs.dtden_blocks(True) == -(-nx[0] // tx) * -(-nx[1] // ty) * -(-nx[2] // tz)
    check_tiled(cs, w, u, dtype, TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_host_compiled_tiled_batched_matches_percell(on_host, n, dtype, tol):
    """K6 on the tiled body: N = 1, 2, 3 nodes with their own rows and
    random strips in one launch, bitwise equal to the same launch on the
    per-cell body (dtden by maximum) and to N one-node tiled launches, and
    within tol of the plain version."""
    stages, ws, us, strips = batch_nodes(n, dtype, "cpu")
    check_batched(stages, ws, us, strips, dtype, host_batched, host_single, tol)
    dt = torch.full((1,), 2e-3, dtype=dtype)
    args = (0.5, 0.5, 0.5, dt, 0.0, False)
    tiled = host_batched(stages, ws, us, us, strips, *args)
    with SC._percell_body():
        percell = host_batched(stages, ws, us, us, strips, *args)
    for (ut, wt, dt_), (uc, wc, dc) in zip(tiled, percell):
        assert torch.equal(ut, uc) and torch.equal(wt, wc) and torch.equal(dt_.amax(), dc.amax())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_host_compiled_tiled_two_d(on_host, dtype):
    """A 2-D axisymmetric node (20x12x1: Mignone PLM on x1 and x2, no z
    faces, empty x3 strips)."""
    cs, w, u = strip_node("axisymmetric", dtype, "cpu")
    assert cs.strips[("x3", 0)].numel() == 0
    check_tiled(cs, w, u, dtype, TOL[dtype])


# the K3 layout's diffusion models on a random interior state (the deck's
# ic strips, x3 wrapped): power-law viscosity with conduction, power-law and
# alpha viscosity with harmonic face averages
K3_MODELS = {"plaw+cond": ("plaw", "cond"), "plaw_harm": ("plaw_harm", None),
             "alpha_harm": ("alpha_harm", None)}


def k3_model_stage(model, dtype, device, data_dir):
    cs, _, _ = tiled_stage("disk_sph", dtype, device, data_dir,
                           diff=tuple(d.get(k) for d, k in zip((VISC, COND), K3_MODELS[model])))
    u, w = cs.hyd.prim_to_cons(torch.as_tensor(random_prims(cs.grid), dtype=dtype,
                                               device=device), cs.cfg)
    return cs, w, u


@pytest.mark.parametrize("model", list(K3_MODELS))
def test_host_compiled_tiled_viscosity_models(on_host, tmp_path, model):
    """The K3 layout with power-law viscosity and conduction, and power-law
    and alpha viscosity with harmonic averages, on a random state (float64,
    TOL: the deck's state, with cells at the density floor, is the alpha
    cases' above)."""
    cs, w, u = k3_model_stage(model, torch.float64, "cpu", str(tmp_path))
    check_tiled(cs, w, u, torch.float64, TOL[torch.float64])


def test_host_compiled_tiled_plaw_on_the_deck_state(on_host, tmp_path):
    """Power-law viscosity on disk_sph's own state (float64): cells at the
    density floor (rho 1.3e-10, v3 -212) part the kernel and the plain
    version by ~1e-11 absolute, 6e-14 of the field, so the outputs are held
    relative to each component's maximum at 1e-12, as the FLD kernels are."""
    cs, w, u = tiled_stage("disk_sph", torch.float64, "cpu", str(tmp_path),
                           diff=(VISC["plaw"], None))
    assert cs.diffusive and cs.diffusion.visc.kind == "viscosity_plaw"
    check_tiled(cs, w, u, torch.float64, TOL[torch.float64], rel=True)


def diffusive_strip_node(coords, visc, cond, dtype, device, seed=6):
    """A node of ``coords`` with random six-face strips, a random state,
    point gravity and the given diffusion: its CurvStage, w and u."""
    s = port_setup(coords, dtype=dtype, device=device)
    strips = random_strips(s.grid, np.random.default_rng(seed), torch.float64, "cpu")
    cs = SC.CurvStage(s.hyd, gravity=s.grav, gmode=curv_point_grav(s.grid, s.grav),
                      diffusion=Diffusion(s.grid, s.hyd, s.cfg, VISC.get(visc), COND.get(cond)),
                      strips={k: v.numpy() for k, v in strips.items()})
    return cs, s.w, s.u


# random-state diffusive nodes: (coords, viscosity, conduction); the 2-D
# axisymmetric node has no x3 faces
RANDOM_DIFF = {"cyl-cond": ("cylindrical", None, "cond"),
               "sph-plaw_harm+tdiff": ("spherical", "plaw_harm", "tdiff"),
               "axi-alpha": ("axisymmetric", "alpha", None)}


@pytest.mark.parametrize("case", list(RANDOM_DIFF))
def test_host_compiled_tiled_random_diffusion(on_host, case):
    """Random states and strips with conduction alone, harmonic viscosity
    with thermal diffusion, and a 2-D viscous node (float64)."""
    cs, w, u = diffusive_strip_node(*RANDOM_DIFF[case], torch.float64, "cpu")
    check_tiled(cs, w, u, torch.float64, TOL[torch.float64])


def test_host_compiled_tiled_viscous_ragged(on_host, tmp_path):
    """The K3 layout at 33x15x18 (float64): a one-column x tile, a y tile one
    row short and two z chunks, across whose edges x3 wraps."""
    cs, w, u = tiled_stage("disk_sph", torch.float64, "cpu", str(tmp_path), nx=(33, 15, 18))
    assert cs.dtden_blocks(True) == 2 * 2 * 2
    check_tiled(cs, w, u, torch.float64, TOL_DISK[torch.float64])


# ---- the padded halo (K4) on the tiled body

def check_tiled_padded(cs, w, u, dtype, tol):
    """A full padded launch of ``cs`` takes the tiled body: bitwise equal
    (u, w, the dtden maximum) to the per-cell padded body (the wrapper's
    private switch) and within ``tol`` of the plain version (u, w
    absolute, the dtden maximum relative), both RK register patterns;
    dtden has one entry per block of each body."""
    from artemis_tpu_torch import bc as bc_mod

    assert cs.tiled("padded")
    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    dt = torch.full((1,), 2e-3, dtype=dtype, device=w.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        args = (u, u.clone(), gam0, gam1, beta, dt, 0.0, False)
        n0 = SC.tiled_launches
        ut, wt, dt_ = SC._launch(cs, w_pad, w, *args, "padded")
        assert SC.tiled_launches == n0 + 1
        with SC._percell_body():
            uc, wc, dc = SC._launch(cs, w_pad, w, *args, "padded")
        ur, wr, dr = SC.stage_curv_reference(cs, w, *args, w_pad=w_pad)
        assert SC.tiled_launches == n0 + 1
        assert dt_.numel() == cs.dtden_blocks(True) and dc.numel() == cs.dtden_blocks()
        assert torch.equal(ut, uc) and torch.equal(wt, wc) and torch.equal(dt_.amax(), dc.amax())
        assert torch.isfinite(ut).all() and torch.isfinite(wt).all()
        assert float((ut - ur).abs().max()) <= tol and float((wt - wr).abs().max()) <= tol
        assert float((dt_.max() - dr.max()).abs() / dr.max()) <= tol


@pytest.mark.parametrize("case", list(PADDED_CASES))
def test_host_compiled_tiled_padded_matches_percell(on_host, case):
    """K4 on the tiled body on every padded case (random states, 20x12x6
    and the 2-D 20x12; the diffusive body and, for cyl-hydro-only and
    cart-grav-xyz, the inviscid one), float64, two schemes."""
    for scheme in ("hllc-plm", "hlle-pcm"):
        cs, w, u = padded_case_stage(case, scheme)
        assert cs.diffusive == any(k in PADDED_CASES[case][1] for k in ("visc", "cond"))
        check_tiled_padded(cs, w, u, torch.float64, TOL[torch.float64])


# the padded decks: disk_cyl (x1/x3 ic, x2 periodic through its ghosts)
# ragged in x and y with two z chunks, and disk_axi (2-D, x1/x2 ic) with
# a one-column second x tile
PADDED_DECK_SHAPES = {"disk_cyl": (40, 12, 18), "disk_axi": (33, 20, 1)}


def padded_deck_stage(deck, dtype, device, data_dir):
    """A PADDED_DECKS deck at its PADDED_DECK_SHAPES size through the user
    entry point (plain path): the CurvStage its driver makes on the card
    (full, padded, with the deck's alpha viscosity, point gravity and
    rotating frame), the initial w and u."""
    nx = PADDED_DECK_SHAPES[deck]
    sim = Simulation(PADDED_DECKS[deck], [f"parthenon/mesh/nx1={nx[0]}",
                                          f"parthenon/mesh/nx2={nx[1]}",
                                          f"parthenon/mesh/nx3={nx[2]}", "parthenon/time/nlim=0",
                                          "artemis/precision=" + str(dtype).removeprefix("torch.")],
                     data_dir, device=device, fused_stage=False)
    cs = sim.driver._make_curv_stage(sim.grid, sim.gas_cfg)
    assert cs.halo == "padded" and cs.full and cs.diffusive
    return cs, sim.state["gas"]["w"], sim.state["gas"]["u"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("deck", list(PADDED_DECK_SHAPES))
def test_host_compiled_tiled_padded_disk_decks(on_host, tmp_path, deck, dtype):
    """K4 on the tiled body on the disk_cyl and disk_axi states (TOL_DISK:
    cells at the density floor)."""
    cs, w, u = padded_deck_stage(deck, dtype, "cpu", str(tmp_path))
    check_tiled_padded(cs, w, u, dtype, TOL_DISK[dtype])


# the decks that run partial stages: alpha_disk (viscous x1 fills, cooling
# and point gravity left to the chain) and binary_cyl (ic x1, the rotating
# frame folded, binary gravity and damping left to the chain), 2-D
# cylindrical with x2 periodic over the full circle
PARTIAL_DECKS = {"alpha_disk": ((16, 24, 1), ["Gravity", "BetaCooling"]),
                 "binary_cyl": ((20, 32, 1), ["Gravity", "Drag"])}


def partial_deck_stage(deck, dtype, device, data_dir):
    """A PARTIAL_DECKS deck through the user entry point (plain path): the
    partial CurvStage its driver makes on the card (padded, tiled body,
    the deck's alpha viscosity folded), the initial w and u."""
    nx, chain = PARTIAL_DECKS[deck]
    sim = Simulation(os.path.join(HERE, "..", "inputs", f"{deck}.in"),
                     [f"parthenon/mesh/nx1={nx[0]}", f"parthenon/mesh/nx2={nx[1]}",
                      "parthenon/time/nlim=0",
                      "artemis/precision=" + str(dtype).removeprefix("torch.")],
                     data_dir, device=device, fused_stage=False)
    cs = sim.driver._make_curv_stage(sim.grid, sim.gas_cfg)
    assert cs.halo == "padded" and not cs.full and cs.diffusive and cs.tiled("padded")
    assert [type(s).__name__ for s in sim.driver._curv_srcs] == chain
    assert sim.grid.ng[2] == 0
    return cs, sim.state["gas"]["w"], sim.state["gas"]["u"]


def check_partial(cs, w, u, dtype, tol):
    """A partial padded launch of ``cs`` takes the tiled body: bitwise equal
    in u to the per-cell body on the same padded array (the wrapper's
    private switch), w passed through and dtden zero, and within ``tol``
    (absolute) of the plain version, both RK register patterns."""
    from artemis_tpu_torch import bc as bc_mod

    assert not cs.full and cs.tiled("padded")
    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    dt = torch.full((1,), 2e-3, dtype=dtype, device=w.device)
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        args = (u, u.clone(), gam0, gam1, beta, dt, 0.0, False)
        n0 = SC.tiled_launches
        ut, wt, dt_ = SC._launch(cs, w_pad, w, *args, "padded")
        assert SC.tiled_launches == n0 + 1
        with SC._percell_body():
            uc, wc, dc = SC._launch(cs, w_pad, w, *args, "padded")
        ur, _, _ = SC.stage_curv_reference(cs, w, *args, w_pad=w_pad)
        assert SC.tiled_launches == n0 + 1
        assert torch.equal(ut, uc) and wt is w and wc is w
        assert not dt_.any() and not dc.any()
        assert torch.isfinite(ut).all() and float((ut - ur).abs().max()) <= tol


@pytest.mark.parametrize("deck", list(PARTIAL_DECKS))
def test_host_compiled_partial_deck_stages(on_host, tmp_path, deck):
    """K4's partial mode on the tiled body on the alpha_disk and binary_cyl
    states (float64, TOL_DISK), the ghost fill of each deck's walls
    (alpha_disk's viscous inflow) in front of the kernel: bitwise equal to
    the per-cell body and within TOL_DISK of the plain version."""
    cs, w, u = partial_deck_stage(deck, torch.float64, "cpu", str(tmp_path))
    n0 = SC.tiled_launches
    check_against_plain(cs, w, u, torch.float64, on_host, padded=True, tols=TOL_DISK)
    assert SC.tiled_launches == n0 + 2
    check_partial(cs, w, u, torch.float64, TOL_DISK[torch.float64])


# partial nodes on random states: (coords, cells, options); a 2-D
# cylindrical node ragged in x and y (the decks' layout: no x3 ghosts,
# gravity left to the chain) with alpha viscosity, a 3-D one with two z
# chunks (the second of two planes) with power-law viscosity, conduction
# and point gravity, and a 2-D one with the rotating frame folded (as
# binary_cyl folds it)
PARTIAL_NODES = {
    "cyl2d-alpha-36x10": ("cylindrical", (36, 10, 1), dict(visc="alpha", omf=1.0)),
    "cyl3d-plaw+cond-20x6x18": ("cylindrical", (20, 6, 18),
                                dict(visc="plaw", cond="cond", grav=True, omf=0.7)),
    "cyl2d-rf-20x12": ("cylindrical", (20, 12, 1), dict(visc="alpha", rf=True, omf=1.0)),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(PARTIAL_NODES))
def test_host_compiled_tiled_partial(on_host, case, dtype):
    """Partial stages on the tiled body, block by block with shared memory
    starting as NaN: bitwise equal to the per-cell body, within TOL (1e-12
    f64, 1e-5 f32) of the plain version."""
    coords, nx, opt = PARTIAL_NODES[case]
    s = port_setup(coords, dtype=dtype, rotating=opt.get("rf", False), nx=nx)
    assert s.grid.ng[2] == (2 if nx[2] > 1 else 0)
    cs = curv_stage(s, omf=opt["omf"], visc=VISC[opt["visc"]], cond=COND.get(opt.get("cond")),
                    grav=opt.get("grav", False), rf=opt.get("rf", False), full=False)
    assert cs.diffusive and (cs.gravity is not None) == opt.get("grav", False)
    check_partial(cs, s.w, s.u, dtype, TOL[dtype])


def test_host_compiled_tiled_refusal_raises(on_host, monkeypatch):
    """No fallback: a tiled launch that the kernel's tiled_ok refuses (a
    ghost width of three, full and partial, from a padded array, with the
    wrapper's envelope opened to it) returns an error, and the wrapper
    raises instead of running another body; the per-cell body takes the
    same stages, within TOL of the plain version."""
    s = port_setup("cylindrical")
    s.pin.apply_overrides(["parthenon/mesh/nghost=3"])
    s.grid = grid_from_input(s.pin)
    s.hyd = Hydro(s.grid, s.cfg, device="cpu", dtype=torch.float64)
    assert not SC.supported_curv(s.grid, s.cfg)
    monkeypatch.setattr(SC, "supported_curv", lambda grid, cfg: True)
    dt = torch.full((1,), 2e-3, dtype=torch.float64)
    for full in (True, False):
        cs = curv_stage(s, visc=VISC["alpha"], full=full)
        assert s.grid.ng == (3, 3, 3) and not cs.tiled("padded")
        with SC._percell_body():
            check_against_plain(cs, s.w, s.u, torch.float64, on_host)
        with monkeypatch.context() as m:
            m.setattr(SC.CurvStage, "tiled", lambda self, halo: True)
            n0 = SC.stage_curv_launches, SC.tiled_launches
            with pytest.raises(RuntimeError, match="launch failed"):
                on_host(cs, s.w, s.u, s.u, 0.5, 0.5, 0.5, dt, 0.0, False, padded=True)
            assert (SC.stage_curv_launches, SC.tiled_launches) == n0


def test_tiled_body_choice():
    """Which launches take the tiled body: full and partial stages of every
    halo source (six strips, the x1/x2 strips with x3 wrapped, a padded
    array), with or without diffusion, 3-D and 2-D, on a ghost width of
    two, unless the private switch is on.  The dtden length follows the
    body (the diffusive one has a 32 x 8 footprint in both dtypes)."""
    s = port_setup("cartesian")
    cs = SC.CurvStage(s.hyd)
    assert cs.tiled("gather6") and cs.tiled("gather") and cs.tiled("padded")
    part = SC.CurvStage(s.hyd, full=False)
    assert part.tiled("gather6") and part.tiled("padded")
    with SC._percell_body():
        assert not cs.tiled("gather6") and not cs.tiled("gather") and not cs.tiled("padded")
        assert not part.tiled("padded")
    assert cs.tiled("gather6")
    sp = port_setup("spherical")
    cv = curv_stage(sp, visc=VISC["alpha"])
    assert cv.tiled("gather6") and cv.tiled("gather") and cv.tiled("padded")
    assert curv_stage(sp, visc=VISC["alpha"], full=False).tiled("gather")
    axi = curv_stage(port_setup("axisymmetric"), visc=VISC["alpha"])
    assert axi.grid.ng[2] == 0 and axi.tiled("padded")
    assert curv_stage(port_setup("axisymmetric"), full=False).tiled("padded")
    assert cs.dtden_blocks() == -(-20 * 12 * 6 // 128) and cs.dtden_blocks(True) == 1 * 3 * 1
    c32 = SC.CurvStage(port_setup("cartesian", dtype=torch.float32).hyd)
    assert c32.dtden_blocks(True) == 1 * 2 * 1
    assert cv.diffusive and cv.dtden_blocks(True) == 1 * 2 * 1
    assert curv_stage(sp, cond=COND["cond"]).dtden_blocks(True) == 1 * 2 * 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("case", list(PADDED_CASES))
def test_kernel_matches_plain(cuda, case, full, dtype):
    """On the card: full and partial padded stages on the tiled body
    against the plain version; the partial ones bitwise equal in u to the
    per-cell body."""
    for scheme in ("hllc-plm", "hlle-pcm"):
        cs, w, u = padded_case_stage(case, scheme, full, dtype, cuda)
        assert cs.tiled("padded")
        n0 = SC.tiled_launches
        check_against_plain(cs, w, u, dtype, SC.stage_curv)
        assert SC.tiled_launches == n0 + 2
        if not full:
            check_partial(cs, w, u, dtype, TOL[dtype])
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_partial(cuda, dtype):
    """On the card: the partial nodes of test_host_compiled_tiled_partial."""
    for coords, nx, opt in PARTIAL_NODES.values():
        s = port_setup(coords, dtype=dtype, device=cuda, rotating=opt.get("rf", False), nx=nx)
        cs = curv_stage(s, omf=opt["omf"], visc=VISC[opt["visc"]],
                        cond=COND.get(opt.get("cond")), grav=opt.get("grav", False),
                        rf=opt.get("rf", False), full=False)
        check_partial(cs, s.w, s.u, dtype, TOL[dtype])
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_padded_matches_percell(cuda, tmp_path, dtype):
    """On the card: K4 on the tiled body bitwise equal to the per-cell
    padded body on every padded case and on the disk_cyl and disk_axi
    states."""
    for case in PADDED_CASES:
        for scheme in ("hllc-plm", "hlle-pcm"):
            check_tiled_padded(*padded_case_stage(case, scheme, True, dtype, cuda), dtype,
                               TOL[dtype])
    for deck in PADDED_DECK_SHAPES:
        check_tiled_padded(*padded_deck_stage(deck, dtype, cuda, str(tmp_path)), dtype,
                           TOL_DISK[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_disk_gather_and_padded(cuda, tmp_path, dtype):
    cs, w, u = disk_stage(dtype, cuda, data_dir=str(tmp_path))
    ug, wg, dg = check_against_plain(cs, w, u, dtype, SC.stage_curv, tols=TOL_DISK)
    up, wp, dp = check_against_plain(cs, w, u, dtype, SC.stage_curv, padded=True,
                                     tols=TOL_DISK)
    torch.cuda.synchronize()
    assert torch.equal(ug, up) and torch.equal(wg, wp) and torch.equal(dg.amax(), dp.amax())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("deck", ["cartesian", "spherical"], ids=["K5b-cart", "K5a-sph-visc"])
def test_kernel_gather6_equals_padded(cuda, tmp_path, deck, dtype):
    cs, w, u, d = allic_stage(dtype, cuda, deck, str(tmp_path))
    assert d._make_curv_stage(cs.grid, cs.cfg).halo == "gather6"
    ug, wg, dg = check_against_plain(cs, w, u, dtype, SC.stage_curv, tols=TOL_DISK)
    up, wp, dp = check_against_plain(cs, w, u, dtype, SC.stage_curv, padded=True,
                                     tols=TOL_DISK)
    torch.cuda.synchronize()
    assert torch.equal(ug, up) and torch.equal(wg, wp) and torch.equal(dg.amax(), dp.amax())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    """A tensor of another dtype than the rows raises instead of running."""
    s = port_setup("spherical", device=cuda)
    cs = curv_stage(s)
    dt = torch.full((), 1e-3, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        SC.stage_curv(cs, s.w.float(), s.u.float(), s.u.float(), 0.5, 0.5, 0.5, dt, 0.0,
                      False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_kernel_batched_matches_single_launches(cuda, n, dtype, tol):
    """On the card: N = 1, 2, 3 nodes in one launch, bitwise equal to N
    one-node six-face launches, within tol of the plain version."""
    stages, ws, us, strips = batch_nodes(n, dtype, cuda)

    def single(cs, w, u, u1, st, *args):
        return SC.stage_curv(cs, w, u, u1, *args, strips=st)

    check_batched(stages, ws, us, strips, dtype, SC.stage_curv_batched, single, tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("deck", TILED_DECKS, ids=TILED_IDS)
def test_kernel_tiled_matches_percell(cuda, tmp_path, deck, dtype):
    """On the card: the tiled body against the plain version and bitwise
    equal to the per-cell gather and the padded launches, four schemes."""
    for scheme in SCHEMES:
        check_tiled(*tiled_stage(deck, dtype, cuda, str(tmp_path), scheme), dtype,
                    TOL_DISK[dtype])
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_ragged(cuda, dtype):
    for nx in RAGGED:
        check_tiled(*strip_node("cartesian", dtype, cuda, nx=nx), dtype, TOL[dtype])
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_kernel_tiled_batched_matches_percell(cuda, n, dtype):
    stages, ws, us, strips = batch_nodes(n, dtype, cuda)
    dt = torch.full((1,), 2e-3, dtype=dtype, device=cuda)
    args = (0.5, 0.5, 0.5, dt, 0.0, False)
    tiled = SC.stage_curv_batched(stages, ws, us, us, strips, *args)
    with SC._percell_body():
        percell = SC.stage_curv_batched(stages, ws, us, us, strips, *args)
    torch.cuda.synchronize()
    for (ut, wt, dt_), (uc, wc, dc) in zip(tiled, percell):
        assert torch.equal(ut, uc) and torch.equal(wt, wc) and torch.equal(dt_.amax(), dc.amax())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_two_d(cuda, dtype):
    check_tiled(*strip_node("axisymmetric", dtype, cuda), dtype, TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_tiled_viscous_models_and_ragged(cuda, tmp_path, dtype):
    for model in K3_MODELS:
        check_tiled(*k3_model_stage(model, dtype, cuda, str(tmp_path)), dtype, TOL[dtype])
    check_tiled(*tiled_stage("disk_sph", dtype, cuda, str(tmp_path), nx=(33, 15, 18)), dtype,
                TOL_DISK[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(RANDOM_DIFF))
def test_kernel_tiled_random_diffusion(cuda, case, dtype):
    check_tiled(*diffusive_strip_node(*RANDOM_DIFF[case], dtype, cuda), dtype, TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_plaw_on_the_deck_state_and_partial_decks(cuda, tmp_path, dtype):
    """On the card: power-law viscosity on disk_sph's float64 state
    (relative to each component's maximum, as on the host) and the partial
    stages of the alpha_disk and binary_cyl states on the tiled body,
    bitwise equal to the per-cell body."""
    if dtype == torch.float64:
        cs, w, u = tiled_stage("disk_sph", dtype, cuda, str(tmp_path),
                               diff=(VISC["plaw"], None))
        check_tiled(cs, w, u, dtype, TOL[dtype], rel=True)
    for deck in PARTIAL_DECKS:
        cs, w, u = partial_deck_stage(deck, dtype, cuda, str(tmp_path))
        check_against_plain(cs, w, u, dtype, SC.stage_curv, padded=True, tols=TOL_DISK)
        check_partial(cs, w, u, dtype, TOL_DISK[dtype])
    torch.cuda.synchronize()
