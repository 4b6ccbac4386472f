"""Drag and damping zones in the port (``artemis_tpu_torch.sources``:
``DampingParams``, ``dust_sizes_from_input``, ``Drag``) against the JAX
package's, and the drag decks through both packages.

* the damping ramps, and the grain sizes of all four ``size_input`` modes
  (``file`` from a file the test writes), equal to the JAX package's;
* one application of ``Drag`` (``self``, and ``simple_dust`` with constant
  and Stokes stopping times) to the same random gas + 3-species dust state
  with damping zones on both fluids in all three directions, with and
  without ``damp_to_visc`` (power-law and alpha viscosity targets), on a
  cylindrical and a Cartesian mesh: u of both fluids within 1e-12 abs
  (float64);
* ``damp_to_visc`` without gas viscosity is refused by both packages,
  and on a static refinement tree every node's drag gets the viscosity
  model;
* ``inputs/simple_drag.in`` cut to 16 cells and t = 0.05 (gas + 4 dust
  species, HLLE, the implicit coupling) against JAX at 1e-12, its total
  x1 momentum conserved to 1e-13 in the port;
* the port twin of tests/test_drag.py::test_damp_to_visc, its 32x8 deck
  as written and its thresholds;
* ``inputs/binary_cyl.in`` cut to 32x64 for 5 cycles (binary gravity,
  rotating frame, alpha viscosity, damping zones on x1): end states within
  1e-11 of each component's scale, max |port - JAX| / max(1, max |JAX|)
  (the energies are ~1e5 at gamma = 1.00001).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu import sources as J  # noqa: E402
from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid  # noqa: E402
from artemis_tpu.ops.diffusion import DiffParams as JDiff  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

import artemis_tpu_torch  # noqa: E402
from artemis_tpu_torch import sources as T  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.diffusion import DiffParams  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.state import state_from_numpy, state_to_numpy  # noqa: E402

from .test_torch_strat import scaled_err  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "..", "inputs")
SIMPLE_DRAG = os.path.join(INPUTS, "simple_drag.in")
BINARY_CYL = os.path.join(INPUTS, "binary_cyl.in")

MESHES = {
    "cylindrical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                        x2min=-3.14159, x2max=3.14159, x3min=-0.3, x3max=0.3),
    "cartesian": dict(nx1=20, nx2=12, nx3=6, x1min=-2.0, x1max=2.0,
                      x2min=-1.0, x2max=1.0, x3min=-0.25, x3max=0.25),
}
# damping zones on both fluids in every direction, inside each mesh
DAMPING = {
    "cylindrical": ("inner_x1 = 0.7\ninner_x1_rate = 30.0\nouter_x1 = 1.7\n"
                    "outer_x1_rate = 20.0\ninner_x2 = -2.0\ninner_x2_rate = 5.0\n"
                    "outer_x3 = 0.1\nouter_x3_rate = 8.0\n"),
    "cartesian": ("inner_x1 = -1.2\ninner_x1_rate = 30.0\nouter_x1 = 1.5\n"
                  "outer_x1_rate = 20.0\nouter_x2 = 0.4\nouter_x2_rate = 5.0\n"
                  "inner_x3 = -0.1\ninner_x3_rate = 8.0\n"),
}
STOPPING = {
    "constant": "<dust/stopping_time>\ntype = constant\ntau = 0.02, 0.3, 0.0\nscale = 1.5\n",
    "stokes": ("<dust/stopping_time>\ntype = stokes\nscale = 1.2\n<dust>\nnspecies = 3\n"
               "size_input = direct\nsizes = 0.01, 0.1, 1.0\ngrain_density = 2.0\n"),
}
GAMMA = 1.4
VISC = {"plaw": dict(kind="viscosity_plaw", nu_s=2.0e-3, r_exp=0.5, R0=1.0),
        "alpha": dict(kind="viscosity_alpha", alpha=1.0e-3, R0=1.0, Omega0=1.0)}


def deck(coords, coupling, stopping="constant", damp_to_visc=False):
    mesh = MESHES[coords]
    dtv = f"damp_to_visc = {'true' if damp_to_visc else 'false'}\n"
    text = ("<artemis>\nproblem = constant\ncoordinates = " + coords + "\n"
            "<parthenon/time>\ntlim = 1.0\n<parthenon/mesh>\nnghost = 2\n"
            + "\n".join(f"{k} = {v}" for k, v in mesh.items()) + "\n"
            "<physics>\ndust = true\ndrag = true\n<gas>\ngamma = 1.4\n"
            f"<drag>\ntype = {coupling}\n"
            "<gas/damping>\n" + DAMPING[coords] + dtv
            + "<dust/damping>\n" + DAMPING[coords])
    if coupling == "simple_dust":
        text += STOPPING[stopping]
    return text


def both(coords, coupling, stopping="constant", visc=None):
    """(JAX side, port side): the Drag source, Hydro and the same random
    gas + 3-species dust state."""
    text = deck(coords, coupling, stopping, damp_to_visc=visc is not None)
    jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
    jg, g = jgrid(jpin), grid_from_input(pin)
    kw = dict(fluid="gas", recon="plm", rsolver="hllc", gamma=GAMMA, cv=1.0 / (GAMMA - 1.0),
              dfloor=1e-10, siefloor=1e-10, de_switch=0.1)
    dkw = dict(fluid="dust", recon="plm", rsolver="hlle", dfloor=1e-10, nspecies=3)
    jcfg, cfg, jdcfg, dcfg = JCfg(**kw), FluidCfg(**kw), JCfg(**dkw), FluidCfg(**dkw)
    nz, ny, nx = tuple(reversed(g.nx))
    rng = np.random.default_rng(13)
    wg = np.empty((1, 6, nz, ny, nx))
    wg[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    wg[:, 1:4] = 0.6 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    wg[:, 5] = 1 + 0.2 * rng.random((nz, ny, nx))
    wg[:, 4] = (GAMMA - 1.0) * wg[:, 0] * wg[:, 5]
    wd = np.empty((3, 4, nz, ny, nx))
    wd[:, 0] = 0.01 + 0.05 * rng.random((3, nz, ny, nx))
    wd[:, 1:4] = 0.6 * (rng.random((3, 3, nz, ny, nx)) - 0.5)
    with jax.enable_x64(True):
        jh = JHydro(jg, jcfg, jdcfg)
        ug = np.array(jh.prim_to_cons(jnp.asarray(wg), jcfg)[0])
        ud = np.array(jh.prim_to_cons(jnp.asarray(wd), jdcfg)[0])
        jsrc = J.Drag(jpin, jg, jcfg, jdcfg)
    tsrc = T.Drag(pin, g, cfg, dcfg)
    if visc is not None:
        jsrc.set_viscosity(JDiff(**VISC[visc]))
        tsrc.set_viscosity(DiffParams(**VISC[visc]))
    tsrc.place("cpu", torch.float64)
    h = Hydro(g, cfg, dcfg, device="cpu", dtype=torch.float64)
    state = {"gas": {"u": ug, "w": wg}, "dust": {"u": ud, "w": wd}}
    tstate = {f: {k: torch.as_tensor(v) for k, v in d.items()} for f, d in state.items()}
    return (jpin, jg, jsrc, jh, state), (pin, g, tsrc, h, tstate)


def test_damping_ramps_match_jax():
    """Inner and outer ramps per direction, an inactive direction zeroed."""
    for coords in MESHES:
        for nx3 in (6, 1):
            text = deck(coords, "self").replace("nx3 = 6", f"nx3 = {nx3}")
            jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
            jr = J.DampingParams("gas/damping", jpin).ramps(jgrid(jpin))
            tr = T.DampingParams("gas/damping", pin).ramps(grid_from_input(pin))
            for a, b in zip(jr, tr):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert all(float(np.abs(r).max()) > 0.0 for r in tr[:2])
            assert (float(np.abs(tr[2]).max()) > 0.0) == (nx3 > 1)


DRAG_CASES = [("cylindrical", "self", "constant", None),
              ("cartesian", "self", "constant", None),
              ("cylindrical", "self", "constant", "plaw"),
              ("cylindrical", "self", "constant", "alpha"),
              ("cylindrical", "simple_dust", "constant", None),
              ("cartesian", "simple_dust", "constant", None),
              ("cylindrical", "simple_dust", "stokes", None),
              ("cartesian", "simple_dust", "stokes", "alpha"),
              ("cylindrical", "simple_dust", "constant", "plaw")]


@pytest.mark.parametrize("coords,coupling,stopping,visc", DRAG_CASES,
                         ids=["-".join(str(x) for x in c) for c in DRAG_CASES])
def test_drag_matches_jax(coords, coupling, stopping, visc):
    """One application with dt = 0.05 (a zero stopping time included): u
    of gas and dust within 1e-12 abs (float64)."""
    (_, _, jsrc, jh, js), (_, _, tsrc, th, ts) = both(coords, coupling, stopping, visc)
    dt = 0.05
    with jax.enable_x64(True):
        jstate = {f: {k: jnp.asarray(v) for k, v in d.items()} for f, d in js.items()}
        jout = jsrc.apply(jstate, None, jnp.asarray(0.0), jnp.asarray(dt), jh)
        jout = {f: np.asarray(jout[f]["u"]) for f in jout}
    tout = tsrc.apply(ts, None, 0.0, torch.tensor(dt, dtype=torch.float64), th)
    for f in ("gas", "dust"):
        tu = tout[f]["u"].numpy()
        assert float(np.abs(tu - jout[f]).max()) <= 1e-12, f
        assert float(np.abs(tu - js[f]["u"]).max()) > 1e-3, f  # it did act


@pytest.mark.parametrize("mode", ["linspace", "logspace", "direct", "file"])
def test_dust_sizes_match_jax(tmp_path, mode):
    """All four size_input modes with a cgs length unit of 10 (the sizes
    are divided by it); the file mode reads a column with comments."""
    path = tmp_path / "sizes.txt"
    path.write_text("# grain sizes\n0.5  9\n1.5 # second\n\n4.0\n8.0\n")
    text = ("<artemis>\nphysical_units = cgs\nlength = 10.0\n<dust>\n"
            f"size_input = {mode}\nmin_size = 0.1\nmax_size = 30.0\n"
            f"sizes = 0.2, 0.4, 3.0, 7.0\nsize_file = {path}\n")
    for n in (3, 4):
        j = J.dust_sizes_from_input(JPin.from_string(text), n)
        t = T.dust_sizes_from_input(ParameterInput.from_string(text), n)
        np.testing.assert_array_equal(t, j)
        assert t.shape == (n,)
    one_row = tmp_path / "row.txt"
    one_row.write_text("0.5 1.5 4.0\n")
    row = text.replace(str(path), str(one_row))
    np.testing.assert_array_equal(T.dust_sizes_from_input(ParameterInput.from_string(row), 3),
                                  J.dust_sizes_from_input(JPin.from_string(row), 3))


DAMP_DECK = """
<artemis>
problem = constant
coordinates = cylindrical

<parthenon/time>
tlim = 1.0
nlim = 2
integrator = rk2

<parthenon/mesh>
nghost = 2
nx1 = 32
x1min = 0.5
x1max = 2.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 8
x2min = -3.141592653589793
x2max = 3.141592653589793
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = -0.5
x3max = 0.5

<physics>
gas = true
viscosity = true
drag = true

<gas>
gamma = 1.4
cfl = 0.5

<gas/viscosity>
type = constant
nu = 1.0e-3

<drag>
type = self

<gas/damping>
inner_x1 = 10.0
inner_x1_rate = 1.0e4
damp_to_visc = %s

<problem>
rho = 1.0
pres = 1.0
"""


def test_damp_to_visc_deck(tmp_path):
    """The port twin of tests/test_drag.py::test_damp_to_visc: with a
    domain-wide strong damping zone, two cycles land the radial velocity
    on the viscous inflow v_R = -1.5 nu / R (rel err < 2e-2); without the
    option the gas damps to rest."""
    sim = artemis_tpu_torch.Simulation(DAMP_DECK % "true", data_dir=str(tmp_path / "visc"),
                                       is_path=False, device="cpu")
    sim.run()
    w = sim.state["gas"]["w"].numpy()
    g = sim.grid.geom
    s3, s2, s1 = sim.grid.int_slices
    R = g.xv1[s1][None, None, :]
    v_target = -1.5e-3 / R
    err = np.max(np.abs(w[0, 1] - v_target) / np.abs(v_target))
    assert err < 2e-2, f"viscous-inflow target missed: rel err {err:g}"
    sim0 = artemis_tpu_torch.Simulation(DAMP_DECK % "false", data_dir=str(tmp_path / "zero"),
                                        is_path=False, device="cpu")
    sim0.run()
    assert np.max(np.abs(sim0.state["gas"]["w"].numpy()[0, 1])) < 0.02 * np.max(np.abs(v_target))


def test_damp_to_visc_needs_viscosity(tmp_path):
    """Both packages refuse damp_to_visc without gas viscosity (with no
    diffusion, and with conduction alone)."""
    text = DAMP_DECK % "true"
    for ov in (["physics/viscosity=false"],
               ["physics/viscosity=false", "physics/conduction=true",
                "gas/conductivity/type=conductivity", "gas/conductivity/cond=1e-3"]):
        with pytest.raises(ValueError):
            JSimulation(text, ov, str(tmp_path / "jax"), is_path=False)
        with pytest.raises(ValueError):
            artemis_tpu_torch.Simulation(text, ov, str(tmp_path / "port"), is_path=False,
                                         device="cpu")


# the damp_to_visc deck on a Cartesian box with a static refinement patch
TREE = ["artemis/coordinates=cartesian", "parthenon/mesh/x1min=-1.0",
        "parthenon/mesh/x1max=1.0", "parthenon/mesh/x2min=-1.0", "parthenon/mesh/x2max=1.0",
        "parthenon/mesh/refinement=static", "parthenon/mesh/nx1=32", "parthenon/mesh/nx2=16",
        "parthenon/meshblock/nx1=16", "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=1",
        "parthenon/static_refinement0/x1min=-0.5", "parthenon/static_refinement0/x1max=0.5",
        "parthenon/static_refinement0/x2min=-0.5", "parthenon/static_refinement0/x2max=0.5",
        "parthenon/static_refinement0/level=1"]


def test_damp_to_visc_on_a_static_tree(tmp_path):
    """Every node of a static tree gets the deck's drag with the viscosity
    model attached (each patch builds its own sources), and two cycles
    run; without viscosity the tree is refused."""
    sim = artemis_tpu_torch.Simulation(DAMP_DECK % "true", TREE, str(tmp_path / "tree"),
                                       is_path=False, device="cpu")
    nodes = sim.driver.smr.nodes
    assert len(nodes) == 2
    for nd in nodes:
        drags = [s for s in nd.sources if isinstance(s, T.Drag)]
        assert len(drags) == 1 and drags[0].visc_dp is not None
    assert nodes[1].sources[0] is not nodes[0].sources[0]
    sim.run()
    assert sim.tm.ncycle == 2 and bool(torch.isfinite(sim.state["gas"]["u"]).all())
    with pytest.raises(ValueError):
        artemis_tpu_torch.Simulation(DAMP_DECK % "true", TREE + ["physics/viscosity=false"],
                                     str(tmp_path / "none"), is_path=False, device="cpu")


def slice_pair(tmp_path, deck, ov):
    """The deck through both packages on the CPU from the JAX run's
    initial state (the port's own checked equal first): (JAX sim, its end
    state as numpy, port sim)."""
    with jax.enable_x64(True):
        jsim = JSimulation(deck, ov, str(tmp_path / "jax"))
        j0 = {f: {k: np.asarray(v) for k, v in kinds.items()} for f, kinds in jsim.state.items()}
        jsim.run()
        jend = {f: {k: np.asarray(v) for k, v in kinds.items()}
                for f, kinds in jsim.state.items()}
    tsim = artemis_tpu_torch.Simulation(deck, ov, str(tmp_path / "port"), device="cpu")
    t0 = state_to_numpy(tsim.state)
    for f in t0:
        for k in ("u", "w"):
            assert float(np.abs(t0[f][k] - j0[f][k]).max()) == 0.0
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    return jsim, jend, tsim


def test_simple_drag_slice_matches_jax(tmp_path):
    """simple_drag.in at 16 cells to t = 0.05: gas and dust within 1e-12
    abs of JAX, and the port's total x1 momentum (gas + 4 species)
    conserved to 1e-13 at every cycle."""
    ov = ["parthenon/mesh/nx1=16", "parthenon/time/tlim=0.05"]
    jsim, jend, tsim = slice_pair(tmp_path, SIMPLE_DRAG, ov)
    assert [type(s).__name__ for s in tsim.driver.sources] == ["Drag"]
    moms = []

    def momentum(state, tm):
        moms.append(float(state["gas"]["u"][0, 1].sum() + state["dust"]["u"][:, 1].sum()))

    momentum(tsim.state, tsim.tm)
    tsim.run(extra_observers=[momentum])
    assert tsim.tm.ncycle == jsim.tm.ncycle and len(moms) == tsim.tm.ncycle + 1 > 3
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14
    end = state_to_numpy(tsim.state)
    for f in ("gas", "dust"):
        for k in ("u", "w"):
            assert float(np.abs(end[f][k] - jend[f][k]).max()) <= 1e-12, (f, k)
    moms = np.array(moms)
    assert float(np.abs(moms / moms[0] - 1.0).max()) <= 1e-13
    # the dust has picked up speed from the gas
    assert float(end["dust"]["w"][0, 1].mean()) > 0.5


def test_binary_cyl_slice_matches_jax(tmp_path):
    """binary_cyl.in at 32x64 for 5 cycles."""
    ov = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=64", "parthenon/time/nlim=5"]
    jsim, jend, tsim = slice_pair(tmp_path, BINARY_CYL, ov)
    assert [type(s).__name__ for s in tsim.driver.sources] \
        == ["Gravity", "RotatingFrame", "Drag"]
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle == 5
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-13 * jsim.tm.time
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert scaled_err(end[k], jend["gas"][k]) <= 1e-11
