"""The port's source terms (``artemis_tpu_torch.sources``) against the JAX
package's (``artemis_tpu.sources``): point gravity (softened, and with a
sink), uniform and binary gravity, and the curvilinear rotating-frame torque
on cylindrical, spherical and axisymmetric meshes, applied to the same
random state and mass fluxes in float64 (<= 1e-12 abs);
``sources_from_input`` building the same list from a deck; and the two
sources that read the N-body particles refused without a particle system,
as the JAX package refuses them (with one, tests/test_torch_nbody.py holds
them to JAX).  Beta cooling and drag have their own files
(tests/test_torch_cooling.py, tests/test_torch_drag.py).
"""

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
from artemis_tpu.units import Constants as JConst, Units as JUnits  # noqa: E402

from artemis_tpu_torch import sources as T  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402
from artemis_tpu_torch.units import Constants, Units  # noqa: E402

# the meshes of tests/test_pallas_curv.py:17-26, cut to a small ragged size
MESHES = {
    "cylindrical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                        x2min=-3.14159, x2max=3.14159, x3min=-0.3, x3max=0.3),
    "spherical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                      x2min=0.8, x2max=2.3, x3min=-3.14159, x3max=3.14159),
    "axisymmetric": dict(nx1=20, nx2=12, nx3=1, x1min=0.4, x1max=2.0,
                         x2min=-0.6, x2max=0.6, x3min=-3.14, x3max=3.14),
}
GRAVITY = {
    "point": "<gravity/point>\nmass = 1.0\nsoft = 0.05\n",
    "point-sink": "<gravity/point>\nmass = 1.0\nsoft = 0.05\nsink = 0.9\nsink_rate = 2.0\n",
    "uniform": "<gravity/uniform>\ngx1 = 0.3\ngx2 = -0.2\ngx3 = 0.1\n",
    "binary": ("<gravity/binary>\ntotal_mass = 1.0\nq = 0.5\na = 0.3\ne = 0.1\n"
               "soft1 = 0.05\nsoft2 = 0.04\nsink1 = 0.6\nsink_rate1 = 1.0\n"),
}


def deck(coords, gravity="point"):
    mesh = MESHES[coords]
    return ("<artemis>\nproblem = disk\ncoordinates = " + coords + "\n"
            "<parthenon/time>\ntlim = 1.0\n<parthenon/mesh>\nnghost = 2\n"
            + "\n".join(f"{k} = {v}" for k, v in mesh.items()) + "\n"
            "ix1_bc = outflow\nox1_bc = outflow\nix2_bc = outflow\nox2_bc = outflow\n"
            "ix3_bc = periodic\nox3_bc = periodic\n"
            "<physics>\ngravity = true\nrotating_frame = true\n"
            "<rotating_frame>\nomega = 0.8\n<gas>\ngamma = 1.4\n" + GRAVITY[gravity])


def both(coords, gravity="point"):
    """(JAX side, port side): grid, Hydro, the same random state and the
    same random fluxes (the rotating frame reads the mass flux of each
    interior face)."""
    text = deck(coords, gravity)
    jpin, pin = JPin.from_string(text), ParameterInput.from_string(text)
    jg, g = jgrid(jpin), grid_from_input(pin)
    jcfg = JCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4)
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4)
    jh, h = JHydro(jg, jcfg), Hydro(g, cfg, device="cpu", dtype=torch.float64)
    nz, ny, nx = tuple(reversed(g.nx))
    rng = np.random.default_rng(7)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = 0.4 * w[:, 0] * w[:, 5]
    u = np.array(jh.prim_to_cons(jnp.asarray(w), jcfg)[0])
    fx = {}
    for d in (1, 2, 3):
        if g.active(d):
            shape = [1, 6, nz, ny, nx]
            shape[-d] += 1
            fx[d] = (0.1 * (rng.random(shape) - 0.5), None, None)
    jside = dict(pin=jpin, grid=jg, hyd=jh,
                 state={"gas": {"u": jnp.asarray(u), "w": jnp.asarray(w)}},
                 fluxes={"gas": {d: (jnp.asarray(f[0]), None, None) for d, f in fx.items()}})
    tside = dict(pin=pin, grid=g, hyd=h,
                 state={"gas": {"u": torch.as_tensor(u), "w": torch.as_tensor(w)}},
                 fluxes={"gas": {d: (torch.as_tensor(f[0]), None, None)
                                 for d, f in fx.items()}})
    return jside, tside


CASES = [(c, k) for c in MESHES for k in ("point", "point-sink", "uniform", "binary",
                                           "rotating")]


@pytest.mark.parametrize("coords,kind", CASES, ids=[f"{c}-{k}" for c, k in CASES])
def test_source_matches_jax(coords, kind):
    """One application of the source at t = 0.2 with dt = 1e-3: the port's
    u within 1e-12 abs of the JAX package's (float64)."""
    js, ts = both(coords, "point" if kind == "rotating" else kind)
    time, dt = 0.2, 1e-3
    if kind == "rotating":
        jsrc = J.RotatingFrame(js["pin"], js["grid"])
        tsrc = T.RotatingFrame(ts["pin"], ts["grid"])
        assert not tsrc.shearing_box and tsrc.uses_fluxes
    else:
        jsrc = J.Gravity(js["pin"], js["grid"], JConst.from_units(JUnits.from_input(js["pin"])))
        tsrc = T.Gravity(ts["pin"], ts["grid"], Constants.from_units(Units.from_input(ts["pin"])))
        if kind == "binary":
            jsrc.omf = tsrc.omf = 0.8
    tsrc.place("cpu", torch.float64)
    jout = jsrc.apply(js["state"], js["fluxes"], jnp.asarray(time), jnp.asarray(dt), js["hyd"])
    tout = tsrc.apply(ts["state"], ts["fluxes"], time, torch.tensor(dt, dtype=torch.float64),
                      ts["hyd"])
    ju, tu = np.asarray(jout["gas"]["u"]), tout["gas"]["u"].numpy()
    assert float(np.abs(tu - ju).max()) <= 1e-12
    assert float(np.abs(tu - ts["state"]["gas"]["u"].numpy()).max()) > 0.0  # it did act


def test_gravity_window_matches_jax():
    """Outside the tstart/tstop window both add nothing."""
    js, ts = both("spherical")
    for pin in (js["pin"], ts["pin"]):
        pin.apply_overrides(["gravity/tstart=1.0", "gravity/tstop=2.0"])
    jsrc = J.Gravity(js["pin"], js["grid"], JConst.from_units(JUnits.from_input(js["pin"])))
    tsrc = T.Gravity(ts["pin"], ts["grid"], Constants.from_units(Units.from_input(ts["pin"])))
    tsrc.place("cpu", torch.float64)
    for time in (0.5, 1.5):
        jout = jsrc.apply(js["state"], None, jnp.asarray(time), jnp.asarray(1e-3), js["hyd"])
        tout = tsrc.apply(ts["state"], None, time, torch.tensor(1e-3, dtype=torch.float64),
                          ts["hyd"])
        assert float(np.abs(tout["gas"]["u"].numpy()
                            - np.asarray(jout["gas"]["u"])).max()) <= 1e-12


@pytest.mark.parametrize("coords", list(MESHES))
def test_sources_from_input_matches_jax(coords):
    """The same ordered list, with the same gm, soft2, pos and omega."""
    js, ts = both(coords)
    jl = J.sources_from_input(js["pin"], js["grid"], None, None,
                              JConst.from_units(JUnits.from_input(js["pin"])))
    tl = T.sources_from_input(ts["pin"], ts["grid"], None, None,
                              Constants.from_units(Units.from_input(ts["pin"])))
    assert [type(s).__name__ for s in tl] == [type(s).__name__ for s in jl] \
        == ["Gravity", "RotatingFrame"]
    assert (tl[0].gm, tl[0].soft2, tl[0].pos, tl[0].gtype) \
        == (jl[0].gm, jl[0].soft2, jl[0].pos, jl[0].gtype)
    assert tl[1].omega == jl[1].omega == 0.8


def test_unported_sources_raise():
    """N-body gravity, and beta cooling toward the particles' temperature
    (tref = nbody), need <physics> nbody: without a particle system
    sources_from_input refuses both, with the JAX package's errors."""
    js, ts = both("spherical")
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc")
    const = Constants.from_units(Units.from_input(ts["pin"]))
    for extra, msg in ((["physics/cooling=true", "cooling/type=beta", "cooling/beta0=1.0",
                         "cooling/tref=nbody"], "requires <physics> nbody"),
                       (["physics/gravity=true", "gravity/nbody/mtot=1.0"],
                        "requires physics/nbody = true")):
        pin = ParameterInput.from_string(repr(ts["pin"]))
        pin.apply_overrides(extra)
        with pytest.raises(ValueError, match=msg):
            T.sources_from_input(pin, ts["grid"], cfg, None, const)
        jpin = JPin.from_string(repr(ts["pin"]))
        jpin.apply_overrides(extra)
        with pytest.raises(ValueError, match=msg):
            J.sources_from_input(jpin, js["grid"], JCfg(fluid="gas", recon="plm",
                                                         rsolver="hllc"), None,
                                 JConst.from_units(JUnits.from_input(jpin)))
