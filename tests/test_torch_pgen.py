"""The problem generators ported last (``constant``, ``conduction``,
``blast``, ``gaussian_bump``) against the JAX package's, and the
conduction and gaussian_bump decks through both packages.

* the initial prims of each generator equal to the JAX package's (both
  build them with the same numpy operations): ``constant`` in the mesh's
  own basis and projected from another, with dust; ``conduction`` in
  hydrostatic balance with uniform gravity; ``blast``'s sub-sampled
  cylindrical (2-D Cartesian) and spherical (axisymmetric and 3-D
  Cartesian) deposits and its unsampled one; ``gaussian_bump`` with
  temperature, density and velocity bumps;
* the ``conductive`` boundary fill (torch in the port, ``.at[].set`` in the
  JAX package) on the same random padded prims, both sides, Cartesian and
  spherical: within 1e-12 abs;
* ``inputs/conduction.in`` (1-D, 32 cells: gravity, conduction and damping
  zones on the composable path) for 20 cycles and
  ``inputs/gaussian_bump.in`` (16x16, conduction) for 10: end states within
  1e-11 of each component's scale, max |port - JAX| / max(1, max |JAX|)
  (gaussian_bump's energies are ~1e6 at gamma = 1.000001).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg  # noqa: E402
from artemis_tpu.pgen import build_problem as jbuild  # noqa: E402

from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg  # noqa: E402
from artemis_tpu_torch.pgen import build_problem  # noqa: E402
from artemis_tpu_torch.state import state_to_numpy  # noqa: E402

from .test_torch_drag import slice_pair  # noqa: E402
from .test_torch_strat import scaled_err  # noqa: E402

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")

MESHES = {
    "cartesian": "nx1 = 20\nnx2 = 12\nnx3 = 6\nx1min = -1.0\nx1max = 1.0\nx2min = -0.6\n"
                 "x2max = 0.6\nx3min = -0.3\nx3max = 0.3\n",
    "cartesian2d": "nx1 = 24\nnx2 = 20\nnx3 = 1\nx1min = -1.0\nx1max = 1.0\nx2min = -1.0\n"
                   "x2max = 1.0\nx3min = -0.5\nx3max = 0.5\n",
    "cylindrical": "nx1 = 20\nnx2 = 12\nnx3 = 6\nx1min = 0.4\nx1max = 2.0\nx2min = -3.14159\n"
                   "x2max = 3.14159\nx3min = -0.3\nx3max = 0.3\n",
    "axisymmetric": "nx1 = 20\nnx2 = 24\nnx3 = 1\nx1min = 0.0\nx1max = 1.0\nx2min = -0.5\n"
                    "x2max = 0.5\nx3min = -3.14\nx3max = 3.14\n",
    "spherical": "nx1 = 20\nnx2 = 12\nnx3 = 1\nx1min = 0.2\nx1max = 1.2\nx2min = 1.07\n"
                 "x2max = 2.07\nx3min = -0.5\nx3max = 0.5\n",
}
GAMMA = 1.4
CV = 1.0 / (GAMMA - 1.0)

# problem name, mesh, <problem> block (and any other), dust species
PGEN_CASES = {
    "constant-own-basis": ("constant", "cartesian",
                           "system = cartesian\ngas_rho = 2.0\ngas_vx1 = 0.3\ngas_vx2 = -0.2\n"
                           "gas_vx3 = 0.1\ngas_temp = 1.5\ndust_rho = 0.01\ndust_vx1 = 0.4\n", 2),
    "constant-projected": ("constant", "cylindrical",
                           "system = cartesian\ngas_vx1 = 0.3\ngas_vx2 = -0.2\ngas_vx3 = 0.1\n"
                           "dust_vx2 = 0.5\n", 3),
    "constant-from-cyl": ("constant", "cartesian",
                          "system = cylindrical\ngas_vx1 = 0.3\ngas_vx2 = 0.7\n", 0),
    "conduction": ("conduction", "cartesian",
                   "gas_temp = 0.05\ngas_dens = 1.0\nflux = 0.01\n<physics>\ngravity = true\n"
                   "<gravity/uniform>\ngx1 = -0.3\n<gas/conductivity>\ntype = conductivity\n"
                   "cond = 0.1\n", 0),
    "blast-cyl-cart2d": ("blast", "cartesian2d",
                         "radius = 0.33\nsymmetry = cylindrical\nsamples = 10\np0 = 1e-3\n"
                         "x1 = 0.05\nx2 = -0.1\n", 1),
    "blast-sph-axi": ("blast", "axisymmetric",
                      "radius = 0.27\nsymmetry = spherical\nsamples = 8\np0 = 1e-3\n", 0),
    "blast-sph-cart3d": ("blast", "cartesian",
                         "radius = 0.26\nsymmetry = spherical\nsamples = 6\nx1 = 0.1\n"
                         "p0 = 1e-3\n", 0),
    "blast-unsampled": ("blast", "spherical", "radius = 0.5\nsymmetry = spherical\np0 = 1e-3\n", 0),
    "bump-temperature": ("gaussian_bump", "cartesian2d",
                         "temperature_bump = 5.0\nsigma = 0.2\nx1c = 0.1\n", 0),
    "bump-density-velocity": ("gaussian_bump", "cylindrical",
                              "density_bump = 0.5\nvx3_bump = 0.2\nvx1_bump = -0.1\nsigma = 0.3\n"
                              "gas_vx2 = 0.05\nx1c = 1.0\n", 2),
}


def deck(name, mesh, problem, ndust):
    coords = "cartesian" if mesh.startswith("cartesian") else mesh
    text = (f"<artemis>\nproblem = {name}\ncoordinates = {coords}\n<parthenon/time>\n"
            "tlim = 1.0\n<parthenon/mesh>\nnghost = 2\n" + MESHES[mesh]
            + "ix1_bc = outflow\nox1_bc = outflow\n<gas>\ngamma = 1.4\n")
    if ndust:
        text += f"<dust>\nnspecies = {ndust}\n"
    return text + "<problem>\n" + problem


def configs(ndust):
    kw = dict(fluid="gas", recon="plm", rsolver="hllc", gamma=GAMMA, cv=CV)
    dkw = dict(fluid="dust", recon="plm", rsolver="hlle", nspecies=ndust)
    return ((JCfg(**kw), JCfg(**dkw) if ndust else None),
            (FluidCfg(**kw), FluidCfg(**dkw) if ndust else None))


def build_both(case):
    name, mesh, problem, ndust = PGEN_CASES[case]
    text = deck(name, mesh, problem, ndust)
    jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
    (jcfg, jdcfg), (cfg, dcfg) = configs(ndust)
    with jax.enable_x64(True):
        jp = jbuild(name, jpin, jgrid(jpin), jcfg, jdcfg)
    return jp, build_problem(name, pin, grid_from_input(pin), cfg, dcfg)


@pytest.mark.parametrize("case", list(PGEN_CASES))
def test_initial_prims_match_jax(case):
    jp, tp = build_both(case)
    assert sorted(tp.prims) == sorted(jp.prims) == (["dust", "gas"] if PGEN_CASES[case][3]
                                                     else ["gas"])
    for f in tp.prims:
        a, b = np.asarray(tp.prims[f]), np.asarray(jp.prims[f])
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    w = np.asarray(tp.prims["gas"])
    assert np.isfinite(w).all() and (w[:, 0] > 0).all() and (w[:, 5] > 0).all()
    if case.startswith("blast"):  # the deposit heated some cells and not others
        assert w[0, 5].max() > 10.0 * w[0, 5].min()


@pytest.mark.parametrize("coords", ["cartesian", "spherical"])
def test_conductive_fill_matches_jax(coords):
    """The conductive x1 fill on both sides of random padded prims (the
    inner side imposes the flux through the edge cell's conductivity with
    power-law exponents, the outer the temperature), other fluids and axes
    left alone."""
    problem = ("gas_temp = 0.05\nflux = 0.01\n<physics>\ngravity = true\n"
               "<gravity/uniform>\ngx1 = -0.3\n<gas/conductivity>\ntype = conductivity\n"
               "cond = 0.1\ntemp_exp = 0.5\nrho_exp = -0.3\nT_ref = 0.04\n")
    text = deck("conduction", coords, problem, 0)
    jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
    (jcfg, _), (cfg, _) = configs(0)
    jg, g = jgrid(jpin), grid_from_input(pin)
    with jax.enable_x64(True):
        jfill = jbuild("conduction", jpin, jg, jcfg).bc_custom["conductive"]
    tfill = build_problem("conduction", pin, g, cfg).bc_custom["conductive"]
    rng = np.random.default_rng(17)
    shape = (1, 6) + tuple(g.shape_entire)
    w = np.empty(shape)
    w[:, 0] = 0.5 + rng.random(shape[2:])
    w[:, 1:4] = rng.random((1, 3) + shape[2:]) - 0.5
    w[:, 5] = 0.05 + 0.1 * rng.random(shape[2:])
    w[:, 4] = (GAMMA - 1.0) * w[:, 0] * w[:, 5]
    for side in (0, 1):
        with jax.enable_x64(True):
            jw = np.asarray(jfill(jnp.asarray(w), jg, "gas", 1, side))
        tin = torch.as_tensor(w)
        tw = tfill(tin, g, "gas", 1, side)
        assert float(np.abs(tw.numpy() - jw).max()) <= 1e-12
        assert float(np.abs(tw.numpy() - w).max()) > 0.0
        np.testing.assert_array_equal(tin.numpy(), w)  # the input is left alone
    tin = torch.as_tensor(w)
    assert tfill(tin, g, "gas", 2, 0) is tin and tfill(tin, g, "dust", 1, 0) is tin


SLICES = {
    "conduction": ("conduction.in", ["parthenon/mesh/nx1=32", "parthenon/time/nlim=20"],
                   ["Gravity", "Drag"]),
    "gaussian_bump": ("gaussian_bump.in", ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=16",
                                           "parthenon/time/nlim=10"], []),
}


@pytest.mark.parametrize("case", list(SLICES))
def test_deck_slice_matches_jax(tmp_path, case):
    fname, ov, sources = SLICES[case]
    jsim, jend, tsim = slice_pair(tmp_path, os.path.join(INPUTS, fname), ov)
    assert [type(s).__name__ for s in tsim.driver.sources] == sources
    assert tsim.driver.diffusion is not None
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-13 * jsim.tm.time
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert scaled_err(end[k], jend["gas"][k]) <= 1e-11
