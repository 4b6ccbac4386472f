"""The port's slice as a whole: ``artemis_tpu_torch.Simulation`` on the
disk decks against ``artemis_tpu.Simulation`` with the same overrides, in
float64 on the CPU.

Both run their composable path (gravity and the rotating frame as sources,
alpha viscosity as the diffusion pass), so they make the same IEEE
operations: equal cycle counts, times to 1e-14 relative and end states to
1e-11, with the density-weighted L2 deviation from the initial condition
under the reference's regression threshold, 6e-3 (tests/test_disk.py:39-40).
The port starts from the JAX run's initial state, carried over through
``artemis_tpu_torch.state``, after checking that its own is the same.

The cases: disk_sph at 64x32x32 (the deck's spherical 3-D disk with ic/ic/
periodic boundaries; at 64x32x16 both packages exceed the L2 threshold,
8.2e-3), disk_axi at 64x32 with extrap boundaries, and disk_cyl at 64x32x16
with extrap on x1 and x3 over 3 cycles: from the fourth cycle the JAX
package's own jitted and eager runs part by 4e-4 in v_z at a low-density
cell next to the inner x1 boundary (a 1e-15 relative perturbation of the
state moves it by 6e-4 in one cycle), so no other implementation can be
held to 1e-11 there.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

import artemis_tpu_torch  # noqa: E402
from artemis_tpu_torch.state import state_from_numpy, state_to_numpy  # noqa: E402

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")


def extrap(*dirs):
    return [f"parthenon/mesh/{s}{d}_bc=extrap" for d in dirs for s in ("i", "o")]


CASES = {
    "disk_sph": ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=32",
                 "parthenon/time/nlim=5", "gas/de_switch=1e-2"],
    "disk_axi": ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/time/nlim=5",
                 "problem/polytropic_index=1.4", "gas/de_switch=0.0"] + extrap("x1", "x2"),
    "disk_cyl": ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=16",
                 "parthenon/time/nlim=3", "problem/polytropic_index=1.0",
                 "gas/de_switch=0.0"] + extrap("x1", "x3"),
}


def l2_vs_ic(w0, w):
    d0, d = w0[0], w[0]
    return float(np.sqrt((d0 * (d - d0) ** 2).sum()) / d0.sum())


@pytest.mark.parametrize("deck", list(CASES))
def test_disk_slice_float64(tmp_path, deck):
    path = os.path.join(INPUTS, f"{deck}.in")
    ov = CASES[deck]
    jsim = JSimulation(path, ov, str(tmp_path / "jax"))
    j0 = {f: {k: np.asarray(v) for k, v in kinds.items()} for f, kinds in jsim.state.items()}
    jsim.run()

    tsim = artemis_tpu_torch.Simulation(path, ov, str(tmp_path / "port"), device="cpu")
    t0 = state_to_numpy(tsim.state)
    for k in ("u", "w"):
        assert float(np.max(np.abs(t0["gas"][k] - j0["gas"][k]))) <= 1e-12
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    tsim.run()

    assert tsim.tm.ncycle == jsim.tm.ncycle == tsim.tm.nlim
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14 * jsim.tm.time
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert end[k].dtype == np.float64
        assert float(np.max(np.abs(end[k] - np.asarray(jsim.state["gas"][k])))) <= 1e-11
    w0 = np.asarray(tsim.problem.prims["gas"][0])
    assert np.isfinite(end["w"]).all()
    assert l2_vs_ic(w0, end["w"][0]) <= 6e-3
