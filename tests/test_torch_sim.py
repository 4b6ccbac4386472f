"""The port's slice as a whole: ``artemis_tpu_torch.Simulation`` on the
linear-wave deck against ``artemis_tpu.Simulation`` with the same overrides.

On the CPU the port runs its plain tensor path, as the JAX package runs
its jnp path, so the two float64 runs make the same IEEE operations: equal
cycle counts, times to 1e-14 relative, end states to 1e-11 and the same
.hst rows to 1e-12 relative; a float32 port run stays within 1e-5 of the
JAX float64 run.  The JAX run's initial state is carried into the port
through ``artemis_tpu_torch.state``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

import artemis_tpu_torch  # noqa: E402
from artemis_tpu_torch import cli, nbody  # noqa: E402
from artemis_tpu_torch.state import state_from_numpy, state_to_numpy  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DECK = os.path.join(REPO, "inputs", "linwave.in")
OVERRIDES = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
             "parthenon/mesh/nghost=4", "parthenon/time/nlim=5",
             "parthenon/output1/file_type=hst", "parthenon/output1/dt=0.05"]


def jax_numpy_state(sim):
    return {f: {k: np.asarray(v) for k, v in kinds.items()} for f, kinds in sim.state.items()}


def hst_rows(path):
    return np.loadtxt(path, ndmin=2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's float64 run, and its initial state as numpy."""
    jsim = JSimulation(DECK, OVERRIDES, str(tmp_path_factory.mktemp("jax")))
    j0 = jax_numpy_state(jsim)
    jsim.run()
    return jsim, j0


def port_run(tmp_path, j0, precision):
    """The port's run on the CPU, started from the JAX run's initial state
    (after checking that its own initial state is the same)."""
    tsim = artemis_tpu_torch.Simulation(DECK, OVERRIDES + [f"artemis/precision={precision}"],
                                        str(tmp_path), device="cpu")
    t0 = state_to_numpy(tsim.state)
    tol = 1e-15 if precision == "float64" else 1e-6
    assert max(float(np.max(np.abs(t0["gas"][k] - j0["gas"][k]))) for k in ("u", "w")) <= tol
    tsim.state = state_from_numpy(j0, "cpu", tsim.dtype)
    tsim.run()
    return tsim


def test_linwave_slice_float64(tmp_path, jax_run):
    jsim, j0 = jax_run
    tsim = port_run(tmp_path, j0, "float64")
    assert tsim.tm.ncycle == jsim.tm.ncycle == 5
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14 * jsim.tm.time
    assert abs(tsim.tm.dt - jsim.tm.dt) <= 1e-14 * jsim.tm.dt
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert end[k].dtype == np.float64
        assert float(np.max(np.abs(end[k] - np.asarray(jsim.state["gas"][k])))) <= 1e-11
    jh = hst_rows(os.path.join(jsim.data_dir, "linear_wave.out1.hst"))
    th = hst_rows(tmp_path / "linear_wave.out1.hst")
    assert jh.shape == th.shape and jh.shape[0] >= 3
    np.testing.assert_allclose(th, jh, rtol=1e-12, atol=0.0)
    # the problem's L1-error file, written by the ported after_loop
    assert np.loadtxt(tmp_path / "linear_wave-errs.dat").shape == (10,)


def test_linwave_slice_float32(tmp_path, jax_run):
    """A float32 port run stays within 1e-5 of the JAX float64 run (the
    float32 rounding of O(1) fields over 5 cycles is ~1e-6)."""
    jsim, j0 = jax_run
    tsim = port_run(tmp_path, j0, "float32")
    assert tsim.tm.ncycle == jsim.tm.ncycle == 5
    end = state_to_numpy(tsim.state)["gas"]
    for k in ("u", "w"):
        assert end[k].dtype == np.float32
        assert float(np.max(np.abs(end[k] - np.asarray(jsim.state["gas"][k])))) <= 1e-5


def test_package_imports_no_jax(tmp_path):
    """artemis_tpu_torch runs where JAX is absent: importing it (its CLI,
    sources, diffusion, curvilinear stage, radiation, FLD operator, flux
    sweep, the disk, radiation, shearing-box, advection, constant, blast,
    gaussian-bump and conduction problems, mesh refinement, the dumps and
    restart files, the N-body package, the profiler, the sharded driver and
    the sharded tree included) pulls in neither jax
    nor artemis_tpu; and building the N-body library (here into a fresh
    build directory, so g++ runs) writes nothing under native/ (whose
    libnbody.so the JAX package's own make may write meanwhile)."""
    code = ("import sys, artemis_tpu_torch, artemis_tpu_torch.cli, artemis_tpu_torch.state, "
            "artemis_tpu_torch.sources, artemis_tpu_torch.ops.diffusion, "
            "artemis_tpu_torch.ops.stage_curv, artemis_tpu_torch.pgen.disk, "
            "artemis_tpu_torch.radiation, artemis_tpu_torch.ops.fld, "
            "artemis_tpu_torch.pgen.shock, artemis_tpu_torch.pgen.thermalization, "
            "artemis_tpu_torch.amr, artemis_tpu_torch.ops.sweeps, "
            "artemis_tpu_torch.pgen.strat, artemis_tpu_torch.pgen.advection, "
            "artemis_tpu_torch.pgen.constant, artemis_tpu_torch.pgen.blast, "
            "artemis_tpu_torch.pgen.gaussian_bump, artemis_tpu_torch.pgen.conduction, "
            "artemis_tpu_torch.io.dumps, artemis_tpu_torch.nbody, "
            "artemis_tpu_torch.profiling, artemis_tpu_torch.parallel.mesh, "
            "artemis_tpu_torch.parallel.amr, pathlib; "
            f"artemis_tpu_torch.nbody.BUILD_DIR = pathlib.Path({str(tmp_path)!r}); "
            "artemis_tpu_torch.nbody._lib(); "
            "assert artemis_tpu_torch.nbody.library_path().exists(); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'artemis_tpu' or m.startswith('artemis_tpu.')]; "
            "assert not bad, bad; print('clean')")
    native = os.path.join(REPO, "native")

    def sources():
        return {f: os.path.getmtime(os.path.join(native, f)) for f in os.listdir(native)
                if f != "libnbody.so"}

    before = sources()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    assert sources() == before
    assert [f.name for f in tmp_path.iterdir()] == [nbody.library_path().name]


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-i", DECK, "-d", str(tmp_path)])


def test_cli_cpu_runs(tmp_path, capsys):
    rc = cli.main(["-i", DECK, "-d", str(tmp_path), "--device", "cpu",
                   "parthenon/mesh/nx1=8", "parthenon/mesh/nx2=4", "parthenon/mesh/nx3=4",
                   "parthenon/time/nlim=2"])
    assert rc == 0
    assert "walltime-rate" in capsys.readouterr().out
    assert (tmp_path / "linear_wave-errs.dat").exists()


SMALL = ["parthenon/mesh/nx1=8", "parthenon/mesh/nx2=4", "parthenon/mesh/nx3=4"]


@pytest.mark.parametrize("overrides,item", [
    (["parthenon/output2/file_type=hdf5", "parthenon/output2/dt=0.1"], None),
    (["physics/nbody=true", "nbody/particle1/mass=1.0",
      "parthenon/mesh/refinement=static"], 10),
    (["physics/dust=true", "parthenon/mesh/refinement=adaptive"], 10),
    (["physics/dust=true", "parthenon/mesh/refinement=static"], 10),
], ids=["hdf5-output", "nbody", "adaptive", "dust-on-a-static-tree"])
def test_unported_physics_raises(tmp_path, overrides, item):
    """Switches that once waited on a ROADMAP item now run: hdf5 outputs
    write their numbered and final dumps, and item 10's N-body coupling on
    a refinement tree, dust on an adaptive tree ("adaptive") and dust on a
    static tree build their tree and run two cycles with finite states."""
    if item is None:
        artemis_tpu_torch.Simulation(DECK, SMALL + overrides, str(tmp_path), device="cpu").run()
        assert (tmp_path / "linear_wave.out2.00000.npz").exists()
        assert (tmp_path / "linear_wave.out2.final.npz").exists()
        return
    deck, small = DECK, SMALL
    if "physics/dust=true" in overrides:
        # the linear wave has no dust: the advection deck's gas and two
        # dust species, cut to a 16x8x8 root
        deck = os.path.join(os.path.dirname(DECK), "advection.in")
        small = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8"]
    sim = artemis_tpu_torch.Simulation(deck, small + overrides + ["parthenon/time/nlim=2"],
                                       str(tmp_path), device="cpu")
    sim.run()
    assert sim.tm.ncycle == 2 and len(sim.driver.smr.nodes) == 2
    for st in sim.driver._states:
        for fl in st:
            assert torch.isfinite(st[fl]["w"]).all()
    if "physics/dust=true" in overrides:
        assert "dust" in sim.driver._states[1]
