"""Beta cooling in the port (``artemis_tpu_torch.sources.BetaCooling``)
against the JAX package's, and the alpha_disk deck through both packages.

* ``BetaCooling.apply`` (``tref = powerlaw``) on the same random state in
  float64 on cylindrical, spherical and axisymmetric meshes, with
  ``exp_scale`` zero and non-zero and ``de_switch`` zero and non-zero
  (both branches of the dual-energy internal energy taken): the port's u
  within 1e-12 abs of the JAX package's;
* ``inputs/alpha_disk.in`` cut to 64x128 (cylindrical 2-D, viscous x1
  walls, alpha viscosity, point gravity, cooling with beta = beta_min =
  1e-12, so an almost instantaneous relaxation) for 5 cycles: both run
  their composable path on the CPU, end states within 1e-11 of each
  component's scale, max |port - JAX| / max(1, max |JAX|);
* ``tref = nbody`` without the N-body package raises, as the JAX
  package's does (with it, tests/test_torch_nbody.py holds it to JAX).
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
from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro  # noqa: E402

from artemis_tpu_torch import sources as T  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.state import state_to_numpy  # noqa: E402

from .test_torch_drag import slice_pair  # noqa: E402
from .test_torch_strat import scaled_err  # noqa: E402

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")
ALPHA_DISK = os.path.join(INPUTS, "alpha_disk.in")

# the meshes of tests/test_torch_sources.py
MESHES = {
    "cylindrical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                        x2min=-3.14159, x2max=3.14159, x3min=-0.3, x3max=0.3),
    "spherical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                      x2min=0.8, x2max=2.3, x3min=-3.14159, x3max=3.14159),
    "axisymmetric": dict(nx1=20, nx2=12, nx3=1, x1min=0.4, x1max=2.0,
                         x2min=-0.6, x2max=0.6, x3min=-3.14, x3max=3.14),
}
COOLING = ("<cooling>\ntype = beta\ntref = powerlaw\nbeta0 = 0.5\ntfloor = 0.01\n"
           "tcyl = 0.3\ncyl_plaw = -1.0\ntsph = 0.1\nsph_plaw = -0.5\n")
GAMMA = 1.4


def deck(coords, exp_scale, tref="powerlaw"):
    mesh = MESHES[coords]
    return ("<artemis>\nproblem = disk\ncoordinates = " + coords + "\n"
            "<parthenon/time>\ntlim = 1.0\n<parthenon/mesh>\nnghost = 2\n"
            + "\n".join(f"{k} = {v}" for k, v in mesh.items()) + "\n"
            "<physics>\ncooling = true\n<gas>\ngamma = 1.4\n"
            + COOLING.replace("powerlaw", tref) + f"exp_scale = {exp_scale}\n")


def both(coords, exp_scale, de_switch):
    """(JAX source, its Hydro, its state), (port source, Hydro, state): the
    same random state, its internal energy off the total's by up to 10%
    and its kinetic share up to ~80%, so a de_switch of 0.5 takes both
    branches."""
    text = deck(coords, exp_scale)
    jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
    jg, g = jgrid(jpin), grid_from_input(pin)
    kw = dict(fluid="gas", recon="plm", rsolver="hllc", gamma=GAMMA, cv=1.0 / (GAMMA - 1.0),
              dfloor=1e-10, siefloor=1e-10, de_switch=de_switch)
    jcfg, cfg = JCfg(**kw), FluidCfg(**kw)
    nz, ny, nx = tuple(reversed(g.nx))
    rng = np.random.default_rng(11)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 2.0 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 0.5 + 0.5 * rng.random((nz, ny, nx))
    w[:, 4] = (GAMMA - 1.0) * w[:, 0] * w[:, 5]
    with jax.enable_x64(True):
        jh = JHydro(jg, jcfg)
        u = np.array(jh.prim_to_cons(jnp.asarray(w), jcfg)[0])
    u[:, 5] *= 1.0 + 0.1 * (rng.random((nz, ny, nx)) - 0.5)
    h = Hydro(g, cfg, device="cpu", dtype=torch.float64)
    jsrc = J.BetaCooling(jpin, jg, jcfg, 1.0, cv=jcfg.cv)
    tsrc = T.BetaCooling(pin, g, cfg, 1.0, cv=cfg.cv).place("cpu", torch.float64)
    return ((jsrc, jh, {"gas": {"u": u, "w": w}}),
            (tsrc, h, {"gas": {"u": torch.as_tensor(u), "w": torch.as_tensor(w)}}))


CASES = [(c, e, s) for c in MESHES for e in (0.0, 2.0) for s in (0.0, 0.5)]


@pytest.mark.parametrize("coords,exp_scale,de_switch", CASES,
                         ids=[f"{c}-escale{e:g}-de{s:g}" for c, e, s in CASES])
def test_cooling_matches_jax(coords, exp_scale, de_switch):
    """One application with dt = 0.05: u within 1e-12 abs (float64)."""
    (jsrc, jh, js), (tsrc, th, ts) = both(coords, exp_scale, de_switch)
    u = ts["gas"]["u"]
    hx = th.hxv_int
    ke = 0.5 * sum((u[:, 1 + d] / hx[d]) ** 2 for d in range(3)) / u[:, 0]
    if de_switch > 0.0:  # the branch on u[5] is taken somewhere, and the other too
        small = (u[:, 4] - ke) <= de_switch * u[:, 4]
        assert bool(small.any()) and not bool(small.all())
    dt = 0.05
    with jax.enable_x64(True):
        jstate = {"gas": {k: jnp.asarray(v) for k, v in js["gas"].items()}}
        ju = np.asarray(jsrc.apply(jstate, None, jnp.asarray(0.0), jnp.asarray(dt), jh)
                        ["gas"]["u"])
    tu = tsrc.apply(ts, None, 0.0, torch.tensor(dt, dtype=torch.float64), th)["gas"]["u"]
    assert float(np.abs(tu.numpy() - ju).max()) <= 1e-12
    du = (tu - u).numpy()
    assert float(np.abs(du[:, 4]).max()) > 1e-3  # it did act, on both energies alike
    np.testing.assert_allclose(du[:, 4], du[:, 5], rtol=0.0, atol=1e-14)
    np.testing.assert_array_equal(du[:, :4], 0.0)


def test_cooling_tref_nbody_raises():
    """Cooling toward the particles' temperature needs the N-body package:
    without a particle system both packages refuse it."""
    text = deck("cylindrical", 0.0, tref="nbody")
    pin, jpin = ParameterInput.from_string(text), JPin.from_string(text)
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=GAMMA)
    jcfg = JCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=GAMMA)
    with pytest.raises(ValueError, match="requires <physics> nbody"):
        T.BetaCooling(pin, grid_from_input(pin), cfg, 1.0)
    with pytest.raises(ValueError, match="requires <physics> nbody"):
        J.BetaCooling(jpin, jgrid(jpin), jcfg, 1.0)


def test_alpha_disk_slice_matches_jax(tmp_path):
    """alpha_disk.in at 64x128 for 5 cycles: the same cycle count, times
    to 1e-13 relative and end states within 1e-11 of each component's
    scale; cooling held the temperature on its profile (the relaxation is
    almost instantaneous)."""
    ov = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=128", "parthenon/time/nlim=5"]
    jsim, jend, tsim = slice_pair(tmp_path, ALPHA_DISK, ov)
    assert [type(s).__name__ for s in tsim.driver.sources] == ["Gravity", "BetaCooling"]
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle == 5
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-13 * jsim.tm.time
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert scaled_err(end[k], jend["gas"][k]) <= 1e-11
    cool = tsim.driver.sources[1]
    T_end = end["w"][0, 5] / tsim.gas_cfg.cv
    assert float(np.abs(T_end / cool.T0 - 1.0).max()) <= 1e-6
