"""The port's viscous/thermal diffusion (``artemis_tpu_torch.ops.diffusion``)
against the JAX package's (``artemis_tpu.ops.diffusion``): face fluxes,
the update and the diffusive timestep for alpha and power-law viscosity,
power-law conductivity and thermal diffusivity (arithmetic and harmonic
face averages) on cylindrical, spherical and axisymmetric meshes, from the
same padded state, in float64 (<= 1e-12: the two make the same IEEE
operations).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu import bc as jbc  # noqa: E402
from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid  # noqa: E402
from artemis_tpu.ops import diffusion as JD  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg, Hydro as JHydro  # noqa: E402

from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import diffusion as TD  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro  # noqa: E402

MESHES = {
    "cylindrical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                        x2min=-3.14159, x2max=3.14159, x3min=-0.3, x3max=0.3),
    "spherical": dict(nx1=20, nx2=12, nx3=6, x1min=0.4, x1max=2.0,
                      x2min=0.8, x2max=2.3, x3min=-3.14159, x3max=3.14159),
    "axisymmetric": dict(nx1=20, nx2=12, nx3=1, x1min=0.4, x1max=2.0,
                         x2min=-0.6, x2max=0.6, x3min=-3.14, x3max=3.14),
}
# model name -> (viscosity, conduction) DiffParams keyword arguments
MODELS = {
    "alpha": (dict(kind="viscosity_alpha", alpha=1.0e-3, eta=0.0, R0=1.0, Omega0=1.0), None),
    "plaw": (dict(kind="viscosity_plaw", nu_s=2.0e-3, eta=0.2, r_exp=0.5, R0=1.0), None),
    "conduction": (None, dict(kind="conductivity_plaw", hcond_0=1.0e-3, temp_exp=0.5,
                              rho_exp=0.3, T0=1.0, d0=1.0)),
    "harmonic-plaw+tdiff": (dict(kind="viscosity_plaw", avg="harmonic", nu_s=2.0e-3,
                                 eta=1.5, R0=1.0),
                            dict(kind="thermaldiff_plaw", avg="harmonic", kappa_0=1.0e-3,
                                 temp_exp=0.4, T0=1.2)),
}


def setup(coords, model):
    text = ("<artemis>\nproblem = constant\ncoordinates = " + coords + "\n"
            "<parthenon/time>\ntlim = 1.0\n<parthenon/mesh>\nnghost = 2\n"
            + "\n".join(f"{k} = {v}" for k, v in MESHES[coords].items()) + "\n"
            "ix1_bc = outflow\nox1_bc = outflow\nix2_bc = outflow\nox2_bc = outflow\n"
            "ix3_bc = periodic\nox3_bc = periodic\n<gas>\ngamma = 1.4\n")
    jg, g = jgrid(JPin.from_string(text)), grid_from_input(ParameterInput.from_string(text))
    jcfg = JCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cv=2.5)
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cv=2.5)
    jh, h = JHydro(jg, jcfg), Hydro(g, cfg, device="cpu", dtype=torch.float64)
    visc, cond = MODELS[model]
    jdiff = JD.Diffusion(jg, jh, jcfg, visc and JD.DiffParams(**visc),
                         cond and JD.DiffParams(**cond))
    tdiff = TD.Diffusion(g, h, cfg, visc and TD.DiffParams(**visc),
                         cond and TD.DiffParams(**cond))
    nz, ny, nx = tuple(reversed(g.nx))
    rng = np.random.default_rng(3)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = 0.4 * w[:, 0] * w[:, 5]
    ju, jw = jh.prim_to_cons(jnp.asarray(w), jcfg)
    jwp = jbc.pad_and_fill(jw, jg, "gas", {})
    return jdiff, tdiff, ju, jw, jwp


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("coords", list(MESHES))
def test_diffusion_matches_jax(coords, model):
    """fluxes (every direction), update and estimate_dt within 1e-12 (abs,
    and relative for the timestep)."""
    jdiff, tdiff, ju, jw, jwp = setup(coords, model)
    jf = jdiff.fluxes(jwp)
    tf = tdiff.fluxes(t(jwp))
    assert sorted(tf) == sorted(jf)
    for d in jf:
        assert float(np.abs(tf[d].numpy() - np.asarray(jf[d])).max()) <= 1e-12
    bdt = 1e-3
    jn = np.asarray(jdiff.update(ju, jw, jf, bdt))
    tn = tdiff.update(t(ju), t(jw), tf, torch.tensor(bdt, dtype=torch.float64)).numpy()
    assert float(np.abs(tn - jn).max()) <= 1e-12
    assert float(np.abs(tn - np.asarray(ju)).max()) > 0.0  # it did act
    jdt = float(jdiff.estimate_dt(jw))
    assert abs(float(tdiff.estimate_dt(t(jw))) - jdt) <= 1e-12 * jdt
