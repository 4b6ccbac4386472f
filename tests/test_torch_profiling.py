"""Profiling in the port (``artemis_tpu_torch.profiling``): twins of
tests/test_profiling.py, the kernel table on the CPU and the CLI's
``--profile`` / ``--profile-kernels``.

``phase_table`` returns the JAX package's phase names on the same
configuration (the single-level driver on the linear wave at 32x8x8,
nghost 2; the static tree with radiation, ``disk_rhd_amr.in`` at 32x32x8),
a single ``step`` on a host-coupled N-body run (single-level, and a
tracking-patch tree whose profiled cycles move the patch), and the same
names on a sharded run; every phase takes a positive time, and the
caller's state, the tree's node states and topology and the particles are
bitwise what they were.
``kernel_table`` on the CPU reports only ``plain`` rows (no kernel runs
there), one per call of the dispatch points that ran a plain version.
"""

import io
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu.profiling import phase_table as j_phase_table  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation, cli  # noqa: E402
from artemis_tpu_torch.amr import MultiLevelSMR  # noqa: E402
from artemis_tpu_torch.ops.hydro import Hydro  # noqa: E402
from artemis_tpu_torch.profiling import kernel_table, phase_table  # noqa: E402
from artemis_tpu_torch.radiation import Radiation  # noqa: E402
from artemis_tpu_torch.state import state_to_numpy, tree_rows  # noqa: E402

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
LINWAVE = os.path.join(INP, "linwave.in")
RHD = os.path.join(INP, "disk_rhd_amr.in")
LINWAVE_ARGS = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
                "parthenon/mesh/nghost=2"]
RHD_ARGS = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8"]


def snapshot(state):
    return state_to_numpy(state)


def assert_same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            assert np.array_equal(a[name][k], b[name][k]), (name, k)


def port_and_jax_phases(tmp_path, deck, args, ncycles):
    sim = Simulation(deck, args, str(tmp_path / "t"), device="cpu")
    before = snapshot(sim.state)
    buf = io.StringIO()
    totals = phase_table(sim, ncycles=ncycles, out=buf)
    assert_same(snapshot(sim.state), before)
    jsim = JSimulation(deck, overrides=args, data_dir=str(tmp_path / "j"))
    jtotals = j_phase_table(jsim, ncycles=1, out=io.StringIO())
    assert set(totals) == set(jtotals)
    assert all(v > 0.0 for v in totals.values())
    text = buf.getvalue()
    assert "stage1" in text and "%" in text and "total" in text
    return sim, totals


def test_phase_table_driver(tmp_path):
    sim, totals = port_and_jax_phases(tmp_path, LINWAVE, LINWAVE_ARGS, 3)
    assert set(totals) == {"stage1", "stage2", "dt_estimate"}
    assert sim.tm.ncycle == 0


def test_phase_table_smr_radiation(tmp_path):
    sim, totals = port_and_jax_phases(tmp_path, RHD, RHD_ARGS, 2)
    assert set(totals) == {"stage1", "stage2", "radiation", "dt_estimate"}
    # the tree's own node states are untouched too (profiling evolves copies)
    drv = sim.driver
    nodes = [snapshot(st) for st in drv._states]
    phase_table(sim, ncycles=1, out=io.StringIO())
    for a, b in zip(nodes, drv._states):
        assert_same(snapshot(b), a)


def test_phase_table_host_coupled_nbody(tmp_path):
    sim = Simulation(os.path.join(INP, "binary_nbody_cyl.in"),
                     ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=64"], str(tmp_path),
                     device="cpu")
    before = snapshot(sim.state)
    pos, vel = sim.nbody.pos.copy(), sim.nbody.vel.copy()
    totals = phase_table(sim, ncycles=1, out=io.StringIO())
    assert set(totals) == {"step"} and totals["step"] > 0.0
    assert_same(snapshot(sim.state), before)
    assert np.array_equal(sim.nbody.pos, pos) and np.array_equal(sim.nbody.vel, vel)


TRACK = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/refinement=static",
         "parthenon/mesh/numlevel=1", "parthenon/refinement/check_interval=1",
         "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0", "nbody/planet1/f=0.0",
         "nbody/planet1/refine_distance=0.3", "nbody/disable_outputs=true"]


def tree_snapshot(sim):
    drv = sim.driver
    return dict(rows=tree_rows(drv.smr.nodes), xmin=[nd.grid.xmin for nd in drv.smr.nodes],
                states=[snapshot(st) for st in drv._states], ncycle=drv._ncycle,
                pos=sim.nbody.pos.copy(), vel=sim.nbody.vel.copy())


def assert_same_tree(a, b):
    assert np.array_equal(a["rows"], b["rows"]) and a["xmin"] == b["xmin"]
    assert a["ncycle"] == b["ncycle"] and len(a["states"]) == len(b["states"])
    for x, y in zip(a["states"], b["states"]):
        assert_same(x, y)
    assert np.array_equal(a["pos"], b["pos"]) and np.array_equal(a["vel"], b["vel"])


def test_phase_table_host_coupled_tree(tmp_path, monkeypatch):
    """The disk_nbody_cyl tracking patch (tests/test_torch_amr_nbody_dust.py's
    tree, retagged every cycle): 16 cycles bring the planet near a cell
    edge, and the profiled cycles move the patch (a curvilinear rebuild).
    Afterwards the node rows, grids and states, the retag cycle and the
    particles are what they were, and the run resumed from there ends
    bitwise equal to a run that was never profiled."""
    def sim_at(nlim, name):
        s = Simulation(os.path.join(INP, "disk_nbody_cyl.in"),
                       TRACK + [f"parthenon/time/nlim={nlim}"], str(tmp_path / name),
                       device="cpu")
        s.run()
        return s

    sim = sim_at(16, "profiled")
    before = tree_snapshot(sim)
    moves = count_calls(monkeypatch, MultiLevelSMR, "_move_patch")
    totals = phase_table(sim, ncycles=8, out=io.StringIO())
    assert set(totals) == {"step"} and moves
    assert_same_tree(tree_snapshot(sim), before)
    sim.tm.nlim = 24
    sim.run()
    straight = sim_at(24, "straight")
    assert tree_rows(straight.driver.smr.nodes)[0, 3] != before["rows"][0, 3]
    assert_same_tree(tree_snapshot(sim), tree_snapshot(straight))


def test_phase_table_sharded(tmp_path):
    """A sharded run has the single-level driver's phases, each over every
    shard."""
    sim = Simulation(LINWAVE, LINWAVE_ARGS, str(tmp_path), device="cpu", nshards=4)
    before = snapshot(sim.state)
    totals = phase_table(sim, ncycles=2, out=io.StringIO())
    assert set(totals) == {"stage1", "stage2", "dt_estimate"}
    assert all(v > 0.0 for v in totals.values())
    assert_same(snapshot(sim.state), before)


def count_calls(monkeypatch, cls, name):
    calls = []
    orig = getattr(cls, name)

    def counted(self, *args, **kwargs):
        calls.append(name)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(cls, name, counted)
    return calls


@pytest.mark.parametrize("deck,args,ncycles", [(LINWAVE, LINWAVE_ARGS, 2),
                                               (RHD, RHD_ARGS, 1)], ids=["linwave", "rhd_tree"])
def test_kernel_table_plain_on_the_cpu(tmp_path, monkeypatch, deck, args, ncycles):
    """No kernel runs on the CPU: every row is a plain version, and its
    count is the calls of its dispatch point over the timed cycles (the
    flux chain once per fluid per node per stage; the tensor FLD operator's
    set-up once per radiation solve and its matvec once per CG matvec)."""
    sim = Simulation(deck, args, str(tmp_path), device="cpu")
    before = snapshot(sim.state)
    fluxes = count_calls(monkeypatch, Hydro, "compute_fluxes")
    setups = count_calls(monkeypatch, Radiation, "_tensor_operator")
    buf = io.StringIO()
    calls = {}
    secs = kernel_table(sim, ncycles=ncycles, out=buf, calls=calls)
    assert secs and all(k.endswith("(plain)") for k in secs)
    assert all(v > 0.0 for v in secs.values())
    # the warm-up cycle's calls are not recorded: take the timed cycles' share
    per_cycle = len(fluxes) // (ncycles + 1)
    assert calls["fluxes (plain)"] == per_cycle * ncycles
    if deck == RHD:
        assert calls["fld_coeffs (plain)"] == len(setups) // (ncycles + 1) * ncycles
        assert calls["fld_matvec (plain)"] >= 2 * calls["fld_coeffs (plain)"]
    else:
        assert set(calls) == {"fluxes (plain)"}
    text = buf.getvalue()
    assert "all kernels" in text and "residual" in text
    assert_same(snapshot(sim.state), before)


def test_cli_profile_flags(tmp_path, capsys):
    """``--profile N`` and ``--profile-kernels N`` print their tables
    before the run, as the JAX CLI's do; the CLI has no flag the JAX CLI
    lacks."""
    rc = cli.main(["-i", LINWAVE, "-d", str(tmp_path), "--device", "cpu", "--profile", "2",
                   "--profile-kernels", "1", *LINWAVE_ARGS, "parthenon/time/nlim=2"])
    assert rc == 0
    out = capsys.readouterr()
    assert "# phase timings (2 cycles" in out.err and "dt_estimate" in out.err
    assert "# kernel timings (1 cycles" in out.err and "fluxes (plain)" in out.err
    assert "walltime-rate" in out.out
    with pytest.raises(SystemExit):
        cli.main(["-i", LINWAVE, "--device", "cpu", "--nshards", "4"])
