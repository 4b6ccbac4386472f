"""N-body coupling in the port (``artemis_tpu_torch.nbody``, the
``NBodyGravity`` source, cooling with ``tref = nbody``, the nbody_temp disk
and the host-coupled step) against the JAX package's.

* ``NBodyGravity`` (softened gravity per particle, sink accretion, the
  ``[npart, 7]`` back-reaction rows) and ``BetaCooling`` with ``tref =
  nbody`` on the same seeded state and particles, float64, on the
  cylindrical (rotating frame: the accreted gas's frame velocity) and the
  Cartesian N-body decks: gas u and the force rows within 1e-12 abs (u and
  the rows are O(1); measured 1.3e-18 and 2.1e-15);
* the nbody_temp disk's initial state (the potential-radius proxy) from
  both packages' problem generators within 1e-12 of each field's maximum;
* ``NBodySystem.advance`` of both packages over 20 calls on the
  binary_nbody_cyl system with the same seeded force rows, for ias15,
  whfast and janus: the same native integrator, built twice from
  ``native/nbody.cpp`` (the port's into ``artemis_tpu_torch/_build/``),
  gives positions and velocities within 1e-14 abs (measured: equal);
* twins of tests/test_nbody.py's test_nbody_smoke (binary_nbody_cyl as
  written, 20 cycles), test_disk_nbody_temp and test_disk_collision_merge
  (disk_nbody_cyl at 48x64): their checks, the end states within 1e-10 of
  each field's maximum of the JAX run's and the particles within 1e-12 abs
  (measured after 20 binary_nbody_cyl cycles: 8.6e-13 of a field's
  maximum and 3.9e-18 in the particles, so IAS15 took the same substeps),
  and the ``.reb`` columns within 1e-12;
* the cross-package restart on binary_nbody_cyl (the ``nbody`` payload):
  a JAX checkpoint at cycle 9 resumes in the port to cycle 20 within 1e-12
  of the JAX straight run, and a port checkpoint resumes in the JAX package
  within 1e-12 of the port's straight run (each field's maximum; the
  particles abs; measured 4.3e-13 both ways).

Both packages run their composable path on the CPU (the port's plain
tensor chain, the JAX package's jnp path), so they make the same IEEE
operations up to the order of reductions.
"""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu import nbody as JN, sources as J  # noqa: E402
from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.driver import nbody_coeffs as j_coeffs, Integrator as JInteg  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro  # noqa: E402
from artemis_tpu.pgen import build_problem as jbuild  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402
from artemis_tpu.units import Constants as JConst, Units as JUnits  # noqa: E402

from artemis_tpu_torch import Simulation, nbody as TN, sources as T  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.driver import Integrator, nbody_coeffs  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.pgen import build_problem  # noqa: E402
from artemis_tpu_torch.state import state_to_numpy  # noqa: E402
from artemis_tpu_torch.units import Constants, Units  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
INPUTS = os.path.join(REPO, "inputs")
BINARY = os.path.join(INPUTS, "binary_nbody_cyl.in")
DISK_NBODY = os.path.join(INPUTS, "disk_nbody_cyl.in")
CB_DISK = os.path.join(INPUTS, "cb_disk.in")
SMALL = ["parthenon/mesh/nx1=24", "parthenon/mesh/nx2=32"]
SMOKE_CYCLES = 20
RESTART_AT = 9


def field_err(a, b):
    """max |a - b| over each component's max |b| (axis 1), the largest."""
    axes = (0,) + tuple(range(2, b.ndim))
    scale = np.maximum(np.abs(b).max(axis=axes), np.finfo(b.dtype).tiny)
    return float((np.abs(a - b).max(axis=axes) / scale).max())


def jax_state(sim):
    return {f: {k: np.asarray(v) for k, v in kinds.items()} for f, kinds in sim.state.items()}


def end_errs(tsim, jsim):
    """(largest field error of gas u and w, max |particle pos/vel diff|)."""
    te, je = state_to_numpy(tsim.state), jax_state(jsim)
    ferr = max(field_err(te["gas"][k], je["gas"][k]) for k in ("u", "w"))
    perr = max(float(np.abs(getattr(tsim.nbody, k) - getattr(jsim.nbody, k)).max())
               for k in ("pos", "vel"))
    return ferr, perr


# ---------------------------------------------------------------------------
# the sources and the disk IC on seeded states
# ---------------------------------------------------------------------------

def both_sources(deck):
    """Each package's deck (cut to 24x32), grid, hydro, N-body system and
    sources, and a seeded state: the disk IC with its density, velocity
    and internal energy perturbed by up to 10%; the last particle moved
    next to a cell centre at the gas's velocity there, so its sink
    accretes."""
    jpin, pin = JPin.from_file(deck), ParameterInput.from_file(deck)
    jpin.apply_overrides(SMALL)
    pin.apply_overrides(SMALL)
    jg, g = jgrid(jpin), grid_from_input(pin)
    kw = dict(fluid="gas", recon="plm", rsolver="hllc",
              gamma=pin.get_real("gas", "gamma"), dfloor=1e-10, siefloor=1e-10)
    kw["cv"] = 1.0 / (kw["gamma"] - 1.0)
    jcfg, cfg = JCfg(**kw), FluidCfg(**kw)
    omf = pin.get_or_add_real("rotating_frame", "omega", 0.0) \
        if pin.get_or_add_bool("physics", "rotating_frame", False) else 0.0
    jconst, const = JConst.from_units(JUnits.from_input(jpin)), Constants.from_units(
        Units.from_input(pin))
    jnb, tnb = JN.NBodySystem(jpin, jconst, omf=omf), TN.NBodySystem(pin, const, omf=omf)
    w = np.array(build_problem("disk", pin, g, cfg).prims["gas"], dtype=np.float64)
    rng = np.random.default_rng(7)
    for c in (0, 1, 2, 3, 5):
        w[:, c] *= 1.0 + 0.1 * (rng.random(w[:, c].shape) - 0.5)
    w[:, 4] = (kw["gamma"] - 1.0) * w[:, 0] * w[:, 5]
    # the last particle next to cell (0, ny/2, nx/2), moving with its gas
    x1v, x2v, x3v = g.cell_centers()
    k, j, i = 0, g.nx[1] // 2, g.nx[0] // 2
    from artemis_tpu_torch.geometry import geometry as geo

    cart = [np.broadcast_to(c, w.shape[2:]) for c in geo.convert_to_cart(
        g.coords, x1v, x2v, x3v)]
    ex = geo.vec_to_cart(g.coords, x1v, x2v, x3v)
    vcart = [sum(np.broadcast_to(ex[a][m], w.shape[2:]) * w[0, 1 + a] for a in range(3))
             for m in range(3)]
    with jax.enable_x64(True):
        jh = JHydro(jg, jcfg)
        u = np.array(jh.prim_to_cons(jnp.asarray(w), jcfg)[0])
        jsrcs = J.sources_from_input(jpin, jg, jcfg, None, jconst, nbody_sys=jnb)
    h = Hydro(g, cfg, device="cpu", dtype=torch.float64)
    tsrcs = [s.place("cpu", torch.float64)
             for s in T.sources_from_input(pin, g, cfg, None, const, nbody_sys=tnb)]
    # the gas's inertial velocity there: its own plus the frame's
    vb = tsrcs[0].vb or (0.0, 0.0, 0.0)
    for nb in (jnb, tnb):
        nb.pos[-1] = [cart[m][k, j, i] + 1e-3 for m in range(3)]
        nb.vel[-1] = [vcart[m][k, j, i] + np.broadcast_to(vb[m], w.shape[2:])[k, j, i]
                      for m in range(3)]
        nb.racc[-1] = max(nb.racc[-1], 0.05)
        nb.sink_gamma[-1] = max(nb.sink_gamma[-1], 1.0)
        nb.sink_beta[-1] = 0.5
    return (jsrcs, jh, jnb), (tsrcs, h, tnb), w, u


@pytest.mark.parametrize("deck", [BINARY, CB_DISK, DISK_NBODY],
                         ids=["binary_nbody_cyl", "cb_disk", "disk_nbody_cyl"])
def test_nbody_sources_match_jax(deck):
    """Each source that reads the particles (N-body gravity on every deck;
    tref = nbody cooling on cb_disk and disk_nbody_cyl), applied once with
    dt = 0.01: u within 1e-12 abs, gravity's force rows within 1e-12 abs,
    the sink's mass row non-zero (it accreted)."""
    (jsrcs, jh, jnb), (tsrcs, th, tnb), w, u = both_sources(deck)
    jctx_srcs = [s for s in jsrcs if getattr(s, "needs_ctx", False)]
    tctx_srcs = [s for s in tsrcs if getattr(s, "needs_ctx", False)]
    assert [type(s).__name__ for s in jctx_srcs] == [type(s).__name__ for s in tctx_srcs]
    assert isinstance(tctx_srcs[0], T.NBodyGravity)
    assert (len(tctx_srcs) == 2) == (deck != BINARY)
    dt = 0.01
    for js, ts in zip(jctx_srcs, tctx_srcs):
        with jax.enable_x64(True):
            jctx = {"particles": jnb.particle_pytree()}
            jstate = {"gas": {"u": jnp.asarray(u), "w": jnp.asarray(w)}}
            ju = np.asarray(js.apply(jstate, None, jnp.asarray(0.0), jnp.asarray(dt), jh,
                                     ctx=jctx)["gas"]["u"])
        tctx = {"particles": tnb.particle_pytree("cpu", torch.float64)}
        tstate = {"gas": {"u": torch.as_tensor(u), "w": torch.as_tensor(w)}}
        tu = ts.apply(tstate, None, 0.0, torch.tensor(dt, dtype=torch.float64), th,
                      ctx=tctx)["gas"]["u"].numpy()
        assert float(np.abs(tu - ju).max()) <= 1e-12
        assert float(np.abs(tu - u).max()) > 1e-8  # it acted
        if isinstance(ts, T.NBodyGravity):
            jrows, trows = np.asarray(jctx["pforce"]), tctx["pforce"].numpy()
            assert trows.shape == (tnb.npart, 7)
            assert float(np.abs(trows - jrows).max()) <= 1e-12
            assert abs(trows[-1, 0]) > 0.0  # the sink accreted


@pytest.mark.parametrize("deck", [DISK_NBODY, CB_DISK], ids=["disk_nbody_cyl", "cb_disk"])
def test_nbody_temp_disk_ic_matches_jax(deck):
    """The nbody_temp disk (temperature from the particles' potential-radius
    proxy) at 24x32: both problem generators' primitives within 1e-12 of
    each field's maximum."""
    jpin, pin = JPin.from_file(deck), ParameterInput.from_file(deck)
    jpin.apply_overrides(SMALL)
    pin.apply_overrides(SMALL)
    assert pin.get_bool("problem", "nbody_temp")
    kw = dict(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cv=2.5)
    with jax.enable_x64(True):
        jw = np.asarray(jbuild("disk", jpin, jgrid(jpin), JCfg(**kw)).prims["gas"])
    tw = np.asarray(build_problem("disk", pin, grid_from_input(pin), FluidCfg(**kw)).prims["gas"])
    assert field_err(tw, jw) <= 1e-12


# ---------------------------------------------------------------------------
# the particle system alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["ias15", "whfast", "janus"])
def test_nbody_system_matches_jax(integrator):
    """20 coupling stages (10 rk2 cycles of dt = 0.01) of the
    binary_nbody_cyl system with the same seeded force rows: positions and
    velocities within 1e-14 abs, the accumulated rows equal."""
    over = [f"nbody/integrator={integrator}"]
    jpin, pin = JPin.from_file(BINARY), ParameterInput.from_file(BINARY)
    jpin.apply_overrides(over)
    pin.apply_overrides(over)
    jnb = JN.NBodySystem(jpin, JConst.from_units(JUnits.from_input(jpin)), omf=1.0)
    tnb = TN.NBodySystem(pin, Constants.from_units(Units.from_input(pin)), omf=1.0)
    assert tnb.itype == jnb.itype == JN.INTEGRATORS[integrator]
    rng = np.random.default_rng(3)
    jc, tc = j_coeffs(JInteg.make("rk2"), 0.01), nbody_coeffs(Integrator.make("rk2"), 0.01)
    assert (tc.gam0, tc.gam1, tc.beta) == (jc.gam0, jc.gam1, jc.beta)
    t = 0.0
    for _ in range(10):
        jnb.begin_step()
        tnb.begin_step()
        for stage in (1, 2):
            pf = 1e-5 * (rng.random((2, 7)) - 0.5)
            jnb.advance(pf, stage, 2, t, jc)
            tnb.advance(pf.copy(), stage, 2, t, tc)
        t += 0.01
    for k in ("pos", "vel"):
        assert float(np.abs(getattr(tnb, k) - getattr(jnb, k)).max()) <= 1e-14
    np.testing.assert_array_equal(tnb.pforce_tot, jnb.pforce_tot)
    assert abs(np.linalg.norm(tnb.pos[1] - tnb.pos[0]) - 1.0) < 1e-3


def test_nbody_library_builds_outside_native():
    """The port loads native/nbody.cpp's build from artemis_tpu_torch/_build/,
    under a name carrying a hash of the source and the flags; no build of
    the port's sits in native/ (tests/test_torch_sim.py watches a fresh
    build write nothing there)."""
    TN._LIB = None
    lib = TN._lib()
    assert lib.nb_integrate.restype is not None
    path = TN.library_path()
    assert path.exists() and path.parent == TN.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "artemis_tpu_torch"
    assert path.name.startswith("libnbody-") and path.suffix == ".so"
    assert not any(f.startswith("libnbody-") for f in os.listdir(os.path.join(REPO, "native")))


# ---------------------------------------------------------------------------
# whole decks through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def binary_runs(tmp_path_factory):
    """binary_nbody_cyl as written for SMOKE_CYCLES cycles through both
    packages, each straight and to RESTART_AT with its rst checkpoint."""
    out = {}
    rst = ["parthenon/output9/file_type=rst", "parthenon/output9/dt=100.0"]
    for name, make in (("jax", lambda ov, d: JSimulation(BINARY, ov, d)),
                       ("port", lambda ov, d: Simulation(BINARY, ov, d, device="cpu"))):
        straight = make([f"parthenon/time/nlim={SMOKE_CYCLES}"],
                        str(tmp_path_factory.mktemp(name + "_straight")))
        straight.run()
        part_dir = str(tmp_path_factory.mktemp(name + "_part"))
        part = make(rst + [f"parthenon/time/nlim={RESTART_AT}"], part_dir)
        part.run()
        out[name] = (straight, os.path.join(part_dir, "nbody.out9.final.rst.npz"))
    return out


def test_nbody_smoke(binary_runs):
    """test_nbody_smoke's checks on the port's run, and its end state
    against the JAX package's run."""
    tsim, _ = binary_runs["port"]
    jsim, _ = binary_runs["jax"]
    assert tsim.tm.ncycle == jsim.tm.ncycle == SMOKE_CYCLES
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-13 * jsim.tm.time
    assert tsim.nbody.alive.all()
    w = state_to_numpy(tsim.state)["gas"]["w"][0]
    assert np.isfinite(w).all() and (w[0] > 0).all()
    a = np.linalg.norm(tsim.nbody.pos[1] - tsim.nbody.pos[0])
    assert abs(a - 1.0) < 1e-3, f"planet separation drifted to {a:g}"
    ferr, perr = end_errs(tsim, jsim)
    assert ferr <= 1e-10 and perr <= 1e-12


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_nbody_restart_across_packages(binary_runs, tmp_path, direction):
    """A checkpoint at cycle RESTART_AT (the gas and the nbody payload)
    written by one package resumes in the other to SMOKE_CYCLES, within
    1e-12 of the writer's straight run."""
    src, dst = direction.split("_to_")
    straight, rst = binary_runs[src]
    ov = [f"parthenon/time/nlim={SMOKE_CYCLES}"]
    if dst == "port":
        sim = Simulation(BINARY, ov, str(tmp_path), device="cpu", restart=rst)
    else:
        sim = JSimulation(BINARY, ov, str(tmp_path), restart=rst)
    assert sim.tm.ncycle == RESTART_AT
    sim.run()
    assert sim.tm.ncycle == SMOKE_CYCLES
    assert abs(sim.tm.time - straight.tm.time) <= 1e-13 * straight.tm.time
    tsim, jsim = (sim, straight) if dst == "port" else (straight, sim)
    ferr, perr = end_errs(tsim, jsim)
    assert ferr <= 1e-12 and perr <= 1e-12


def reb_columns(path):
    sys.path.insert(0, os.path.join(REPO, "analysis"))
    from anbody import areb

    return areb(path)


def both_decks(tmp_path, deck, overrides, pid):
    """The deck through both packages; returns (port sim, JAX sim, port
    .reb, JAX .reb)."""
    jsim = JSimulation(deck, overrides, str(tmp_path / "jax"))
    jsim.run()
    tsim = Simulation(deck, overrides, str(tmp_path / "port"), device="cpu")
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle
    ferr, perr = end_errs(tsim, jsim)
    assert ferr <= 1e-10 and perr <= 1e-12
    tr = reb_columns(str(tmp_path / "port" / f"{pid}.reb"))
    jr = reb_columns(str(tmp_path / "jax" / f"{pid}.reb"))
    assert tr.N == jr.N
    for col in ("time", "active", "mass", "x", "y", "z", "vx", "vy", "vz", "dm"):
        np.testing.assert_allclose(tr.col(col), jr.col(col), rtol=0.0, atol=1e-12)
    return tsim, jsim, tr, jr


def test_disk_nbody_temp(tmp_path):
    """disk_nbody_cyl at 48x64 to t = 0.25 (planet-file system, nbody_temp
    IC, tref = nbody cooling): all 5 particles active, total GM 1 + 4 2e-4,
    and the run and its .reb against the JAX package's."""
    _, _, r, _ = both_decks(tmp_path, DISK_NBODY, [
        "parthenon/time/tlim=0.25", "parthenon/mesh/nx1=48", "parthenon/mesh/nx2=64",
        "nbody/dt_output=0.25"], "disk_nbody")
    assert r.N == 5
    assert r.col("active")[-1].sum() == 5
    assert np.isclose(r.col("mass")[-1].sum(), 1.0 + 4 * 2.0e-4, rtol=1e-8)


def test_disk_collision_merge(tmp_path):
    """test_disk_collision_merge's overlapping bound pair in the
    disk_nbody_cyl stack at 48x64: the pair merges (the active count drops
    by one) with the total mass conserved to 1e-12, and the run and its
    .reb against the JAX package's."""
    _, _, r, _ = both_decks(tmp_path, DISK_NBODY, [
        "parthenon/time/tlim=0.2", "parthenon/mesh/nx1=48",
        "parthenon/mesh/nx2=64", "nbody/dt_output=0.1",
        "nbody/particle2/mass=1e-3",
        "nbody/particle2/radius=0.01",
        "nbody/particle2/couple=1",
        "nbody/particle2/initialize/x=1.9",
        "nbody/particle2/initialize/vy=0.725",
        "nbody/particle3/mass=1e-3",
        "nbody/particle3/radius=0.01",
        "nbody/particle3/couple=1",
        "nbody/particle3/initialize/x=1.905",
        "nbody/particle3/initialize/vy=0.725",
    ], "disk_nbody")
    assert r.N == 7
    active0 = r.col("active")[0].sum()
    active1 = r.col("active")[-1].sum()
    assert active1 == active0 - 1, f"{active0} -> {active1}"
    m0 = r.col("mass")[0].sum()
    m1 = (r.col("mass")[-1] * r.col("active")[-1]).sum()
    assert abs(m1 - m0) < 1e-12 * m0
