"""The shearing box in the port: ``artemis_tpu_torch.Simulation`` on the
strat and ssheet decks (``problem = strat``) against ``artemis_tpu``'s, the
strat problem's custom boundary fills against the JAX package's, and the
regression thresholds of tests/test_strat.py on the port.

Both packages run their composable Cartesian path on the CPU (the shearing
box's rotating frame consumes the stage fluxes, so no fused stage takes
it), with the strat problem's ``extrap`` and ``inflow`` fills, so they make
the same IEEE operations.  End states are held to 1e-11 of each
component's scale, max |port - JAX| / max(1, max |JAX|) per component
(the energies are ~6e4 at gamma = 1.000001), and times to 1e-11 relative:
gamma - 1 = 1e-6 carries a relative rounding of ~1e-10 into the sound
speed, so the two dt reductions part in the 12th digit (measured 4e-12).
The port starts from the JAX run's initial state after checking that its
own is the same.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid_from_input  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg  # noqa: E402
from artemis_tpu.pgen import strat as jstrat  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

import artemis_tpu_torch  # noqa: E402
from artemis_tpu_torch.config import ParameterInput as TPin  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input as tgrid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg as TCfg  # noqa: E402
from artemis_tpu_torch.pgen import strat as tstrat  # noqa: E402
from artemis_tpu_torch.state import state_from_numpy, state_to_numpy  # noqa: E402

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")
STRAT = os.path.join(INPUTS, "strat.in")
SSHEET = os.path.join(INPUTS, "ssheet.in")
CASES = {
    "strat": (STRAT, ["parthenon/time/nlim=4"]),
    "ssheet": (SSHEET, ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32",
                        "parthenon/time/nlim=3"]),
}


def scaled_err(a, b):
    """max |a - b| / max(1, max |b|) over each component (axis 1)."""
    ax = (0,) + tuple(range(2, a.ndim))
    return float((np.abs(a - b).max(axis=ax) / np.maximum(1.0, np.abs(b).max(axis=ax))).max())


@pytest.mark.parametrize("case", list(CASES))
def test_slice_matches_jax_float64(tmp_path, case):
    path, ov = CASES[case]
    with jax.enable_x64(True):
        jsim = JSimulation(path, ov, str(tmp_path / "jax"))
        j0 = {f: {k: np.asarray(v) for k, v in kinds.items()}
              for f, kinds in jsim.state.items()}
        jsim.run()
        jend = {f: {k: np.asarray(v) for k, v in kinds.items()}
                for f, kinds in jsim.state.items()}
    assert jend["gas"]["u"].dtype == np.float64

    tsim = artemis_tpu_torch.Simulation(path, ov, str(tmp_path / "port"), device="cpu")
    assert tsim.driver.stage_kernel == "none"
    t0 = state_to_numpy(tsim.state)
    for k in ("u", "w"):
        assert float(np.max(np.abs(t0["gas"][k] - j0["gas"][k]))) == 0.0
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    tsim.run()

    assert tsim.tm.ncycle == jsim.tm.ncycle == tsim.tm.nlim
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-11 * jsim.tm.time
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert end[k].dtype == np.float64
        err = scaled_err(end[k], jend["gas"][k])
        assert err <= 1e-11, f"{case} {k}: {err:.3e}"


def test_strat_equilibrium_on_the_port(tmp_path):
    """tests/test_strat.py::test_strat_equilibrium's thresholds on the port
    (strat.in as written, to t = 1): density within 3% of the initial
    profile inside ~3 scale heights, |vz| <= 0.1, no NaN."""
    sim = artemis_tpu_torch.Simulation(STRAT, [], str(tmp_path), device="cpu")
    sim.run()
    assert sim.status == "complete" and abs(sim.tm.time - 1.0) <= 1e-12
    w = sim.state["gas"]["w"][0].numpy()
    d, vz = w[0], w[3]
    _, _, x3v = sim.grid.cell_centers()
    h = 0.25
    rho_eq = np.broadcast_to(np.maximum(1e-5, np.exp(-(x3v**2) / (2 * h * h))), d.shape)
    rel = np.abs(d - rho_eq) / rho_eq
    body = rho_eq > 1e-2
    assert rel[body].max() <= 0.03, f"density drift {rel[body].max():g}"
    assert np.abs(vz).max() <= 0.1, f"vertical flow {np.abs(vz).max():g}"
    assert not np.isnan(w).any()


def test_strat_dust_smoke_on_the_port(tmp_path):
    """tests/test_strat.py::test_strat_dust_smoke on the port: the dust
    branch of the strat IC and fills loads dust at dust_to_gas and keeps it
    finite through the boundaries."""
    sim = artemis_tpu_torch.Simulation(
        STRAT, ["parthenon/time/tlim=0.1", "physics/dust=true", "dust/nspecies=1",
                "problem/dust_to_gas=0.01"], str(tmp_path), device="cpu")
    sim.run()
    wd = sim.state["dust"]["w"].numpy()
    assert wd.shape[0] == 1 and not np.isnan(wd).any()
    assert wd[0, 0].max() <= 0.02


def fill_pair(deck):
    """The JAX and the port strat problems on one deck, with two dust
    species."""
    out = []
    for pin_cls, build_grid, cfg_cls, mod in ((JPin, jgrid_from_input, JCfg, jstrat),
                                              (TPin, tgrid_from_input, TCfg, tstrat)):
        pin = pin_cls.from_file(deck)
        grid = build_grid(pin)
        gas = cfg_cls(fluid="gas", recon="plm", rsolver="hllc",
                      gamma=pin.get_real("gas", "gamma"))
        dust = cfg_cls(fluid="dust", recon="plm", rsolver="hlle", nspecies=2)
        out.append((grid, mod.build(pin, grid, gas, dust)))
    return out


@pytest.mark.parametrize("deck,fills", [
    (STRAT, [("extrap", 1), ("extrap", 3)]),
    (SSHEET, [("extrap", 1), ("inflow", 2)]),
], ids=["strat", "ssheet"])
def test_custom_fills_match_jax(deck, fills):
    """extrap_bc and inflow_bc on a random padded state (gas and two dust
    species, both sides) against the JAX fills: <= 1e-14 relative (the
    geometric density extrapolation is a pow, the rest copies)."""
    (jgrid, jprob), (tgrid, tprob) = fill_pair(deck)
    nx, ny, nz = tgrid.nx
    g1, g2, g3 = tgrid.ng
    rng = np.random.default_rng(7)
    for fluid, nc, ns in (("gas", 6, 1), ("dust", 4, 2)):
        w = 0.5 + rng.random((ns, nc, nz + 2 * g3, ny + 2 * g2, nx + 2 * g1))
        w[:, 1:4] -= 1.0
        for name, d in fills:
            for side in (0, 1):
                with jax.enable_x64(True):
                    jw = np.asarray(jprob.bc_custom[name](
                        jnp.asarray(w, dtype=jnp.float64), jgrid, fluid, d, side))
                assert jw.dtype == np.float64
                tw = tprob.bc_custom[name](torch.as_tensor(w), tgrid, fluid, d, side)
                assert tw.dtype == torch.float64
                err = float(np.abs(tw.numpy() - jw).max() / np.abs(jw).max())
                assert err <= 1e-14, f"{name} x{d} side {side} {fluid}: {err:.3e}"
                assert not np.array_equal(jw, w)  # the fill wrote its ghosts
