"""Gas+dust runs in the port: ``artemis_tpu_torch.Simulation`` on the
advection deck (gas on HLLC, two counter-propagating dust species on HLLE
or LLF) against ``artemis_tpu``'s, and tests/test_advection.py's
regression thresholds on the port.

On the CPU both packages run their composable path, so the float64 runs
make the same IEEE operations: equal cycle counts, times to 1e-14
relative, every fluid's end state to 1e-11 and the same ``errs.dat`` row.
The port starts from the JAX run's initial state after checking that its
own is the same.
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

DECK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs",
                    "advection.in")
SLICE = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
         "parthenon/time/nlim=3"]


def errs(path):
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def test_advection_slice_matches_jax_float64(tmp_path):
    with jax.enable_x64(True):
        jsim = JSimulation(DECK, SLICE, str(tmp_path / "jax"))
        j0 = {f: {k: np.asarray(v) for k, v in kinds.items()}
              for f, kinds in jsim.state.items()}
        jsim.run()
        jend = {f: {k: np.asarray(v) for k, v in kinds.items()}
                for f, kinds in jsim.state.items()}
    assert sorted(jend) == ["dust", "gas"] and jend["dust"]["u"].dtype == np.float64

    tsim = artemis_tpu_torch.Simulation(DECK, SLICE, str(tmp_path / "port"), device="cpu")
    assert tsim.dust_cfg.nspecies == 2 and tsim.dust_cfg.rsolver == "hlle"
    t0 = state_to_numpy(tsim.state)
    for f in ("gas", "dust"):
        for k in ("u", "w"):
            assert float(np.max(np.abs(t0[f][k] - j0[f][k]))) == 0.0
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    tsim.run()

    assert tsim.tm.ncycle == jsim.tm.ncycle == 3
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14 * jsim.tm.time
    end = state_to_numpy(tsim.state)
    for f in ("gas", "dust"):
        for k in ("u", "w"):
            assert end[f][k].dtype == np.float64
            err = float(np.max(np.abs(end[f][k] - jend[f][k])))
            assert err <= 1e-11, f"{f} {k}: {err:.3e}"
    # the problem's errs.dat: the reference's layout (Nx1 Nx2 Nx3 Ncycle,
    # one RMS per fluid, 13 component L1 columns), the JAX file's row
    te = errs(tmp_path / "port" / "advection-errs.dat")
    je = errs(tmp_path / "jax" / "advection-errs.dat")
    assert te.shape == je.shape == (1, 20)
    assert list(te[0, :4]) == [16, 8, 8, 3]
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=0.0)
    with open(tmp_path / "port" / "advection-errs.dat") as fh:
        head = fh.readline()
    with open(tmp_path / "jax" / "advection-errs.dat") as fh:
        assert head == fh.readline()


def test_advection_hlle_thresholds_on_the_port(tmp_path):
    """tests/test_advection.py::test_advection[hlle] on the port: N = 16 and
    32, one period, nghost 4, amp 1e-6; L1 RMS <= 2.21e-7 at N = 32 and
    N16 -> N32 ratio <= 0.30 for the gas and both dust species."""
    data = str(tmp_path)
    for res in (16, 32):
        sim = artemis_tpu_torch.Simulation(DECK, [
            "parthenon/job/problem_id=advection", "problem/nperiod=1",
            "parthenon/time/nlim=1000", "parthenon/time/integrator=rk2",
            "parthenon/mesh/nghost=4", f"parthenon/mesh/nx1={res}",
            f"parthenon/mesh/nx2={res // 2}", f"parthenon/mesh/nx3={res // 2}",
            "problem/amp=1.0e-6", "gas/reconstruct=plm", "dust/reconstruct=plm",
            "gas/riemann=hlle", "dust/riemann=hlle"], data, device="cpu")
        sim.run()
        assert sim.status == "complete"
    e = errs(os.path.join(data, "advection-errs.dat"))
    assert e.shape == (2, 20) and not np.isnan(e).any()
    for si in range(3):  # gas, dust1, dust2
        n16, n32 = e[0, 4 + si], e[1, 4 + si]
        assert n32 <= 2.21e-7, f"species {si} err {n32:g}"
        assert n32 / n16 <= 0.30, f"species {si} conv {n32 / n16:g}"
