"""Outputs, checkpoints and restarts in the port (``artemis_tpu_torch.io``,
``Simulation(restart=...)``, the CLI's ``-r``) and across the two
packages.

* twins of tests/test_restart.py (linwave 16x8x8: a run interrupted at
  cycle 9 and resumed from its checkpoint ends bitwise equal to the
  straight run) and of both tests of tests/test_outputs_restart.py
  (outputs continue across a restart; the restored dt is not regrown);
* the cross-package restart on linwave, both ways: a JAX checkpoint at
  cycle 9 resumes in the port to tlim within 1e-12 of the JAX straight
  run, and a port checkpoint resumes in the JAX package within 1e-12 of
  the port's straight run (binary_nbody_cyl, with the ``nbody`` payload,
  is in tests/test_torch_nbody.py);
* the port's ``hdf5`` dumps, read by ``analysis/adump.py``, against the
  JAX package's dumps of the same run at 1e-12;
* the fused stages' CFL maxima (``dtden``) go to ``payload.dtden``, come
  back into ``gas.dtden`` in the port, and a checkpoint carrying them still
  resumes in the JAX package (whose jnp loop refuses a ``gas.dtden``);
* a static refinement tree (``inputs/disk_rhd_amr.in`` at a 32x32x8 root
  with its 32x32x8 patch and gray FLD on both levels, the ``amr.*``
  payloads) resumes bitwise; a checkpoint in another dtype is refused;
* the CLI: ``-t`` with a tiny walltime exits 2 after writing the walltime
  checkpoint, and ``-r`` on it runs to nlim and exits 0.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu.io.dumps import load_restart as j_load_restart  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation, cli  # noqa: E402
from artemis_tpu_torch.driver import SimTime, evolve  # noqa: E402
from artemis_tpu_torch.io.dumps import load_restart  # noqa: E402
from artemis_tpu_torch.state import tree_to_numpy  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DECK = os.path.join(REPO, "inputs", "linwave.in")
RHD = os.path.join(REPO, "inputs", "disk_rhd_amr.in")
# tests/test_restart.py's and tests/test_outputs_restart.py's runs
ARGS = ["parthenon/mesh/nghost=4", "parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8",
        "parthenon/mesh/nx3=8", "problem/amp=1.0e-6"]
OUTPUTS = ["parthenon/output1/file_type=hst", "parthenon/output1/dt=0.25",
           "parthenon/output2/file_type=hdf5", "parthenon/output2/dt=0.25",
           "parthenon/output9/file_type=rst", "parthenon/output9/dt=0.25"]
RST = "linear_wave.out9.final.rst.npz"


def port(overrides, data, **kw):
    return Simulation(DECK, overrides, str(data), device="cpu", **kw)


def gas(sim):
    """The gas u and w of either package's run, as numpy."""
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in sim.state["gas"].items() if k in ("u", "w")}


def rel_err(a, b):
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in ("u", "w"))


def hst_times(path):
    return np.loadtxt(path, ndmin=2)[:, 0]


def test_restart_roundtrip(tmp_path):
    """A port run interrupted at cycle 9 and resumed from its checkpoint
    ends on the straight run's cycle, time and dt, and its u and w equal
    the straight run's bitwise."""
    s1 = port(ARGS, tmp_path / "straight")
    s1.run()
    d2 = tmp_path / "chunked"
    s2 = port(ARGS + OUTPUTS[4:] + ["parthenon/time/nlim=9"], d2)
    s2.run()
    assert s2.tm.ncycle == 9
    s3 = port(ARGS, d2, restart=str(d2 / RST))
    assert s3.tm.ncycle == 9 and s3.state["gas"]["u"].dtype == torch.float64
    s3.run()
    assert (s3.tm.ncycle, s3.tm.time, s3.tm.dt) == (s1.tm.ncycle, s1.tm.time, s1.tm.dt)
    for k in ("u", "w"):
        assert torch.equal(s3.state["gas"][k], s1.state["gas"][k])


def test_outputs_resume_across_restart(tmp_path):
    """A restart in the same data directory appends to the .hst (strictly
    increasing times, every epoch of the straight run) and continues the
    dump numbering, so the resumed run holds the straight run's dumps."""
    d1, d2 = tmp_path / "straight", tmp_path / "resumed"
    port(ARGS + OUTPUTS, d1).run()
    port(ARGS + OUTPUTS + ["parthenon/time/nlim=9"], d2).run()
    port(ARGS + OUTPUTS, d2, restart=str(d2 / RST)).run()
    t_straight = hst_times(d1 / "linear_wave.out1.hst")
    t_resumed = hst_times(d2 / "linear_wave.out1.hst")
    assert np.all(np.diff(t_resumed) > 0), "duplicate/out-of-order .hst rows"
    for t in t_straight:
        assert np.isclose(t_resumed, t, rtol=1e-12, atol=1e-12).any(), f"missing epoch {t}"
    assert len(t_resumed) <= len(t_straight) + 1
    dumps = [sorted(os.path.basename(f) for f in glob.glob(str(d / "*.out2.*.npz")))
             for d in (d1, d2)]
    assert dumps[0] == dumps[1] and len(dumps[0]) >= 5


class _FakeDriver:
    """Minimal driver for pinning evolve()'s dt semantics."""

    sources = ()

    class grid:
        nx = (4, 4, 4)

    def __init__(self, est):
        self.est = est
        self.dts = []

    def step(self, state, dt, time):
        self.dts.append(float(dt))
        return state

    def estimate_dt(self, state):
        return self.est


def test_restored_dt_not_regrown():
    """The first resumed cycle uses the checkpointed dt as is; growth
    resumes after it; a fresh run grows at once."""
    drv = _FakeDriver(est=1.0)
    evolve(drv, {}, SimTime(time=0.0, dt=0.1, tlim=0.5, nlim=3, restored=True))
    assert drv.dts[:2] == [0.1, 0.2]
    drv2 = _FakeDriver(est=1.0)
    evolve(drv2, {}, SimTime(time=0.0, dt=0.1, tlim=0.5, nlim=3, restored=False))
    assert drv2.dts[0] == 0.2


@pytest.fixture(scope="module")
def linwave_runs(tmp_path_factory):
    """Each package's straight run (with the hst, hdf5 and rst outputs)
    and its checkpoint at cycle 9."""
    out = {}
    for name, make in (("jax", lambda ov, d: JSimulation(DECK, ov, d)),
                       ("port", lambda ov, d: port(ov, d))):
        straight = make(ARGS + OUTPUTS, str(tmp_path_factory.mktemp(name + "_straight")))
        straight.run()
        d = tmp_path_factory.mktemp(name + "_part")
        make(ARGS + OUTPUTS[4:] + ["parthenon/time/nlim=9"], str(d)).run()
        out[name] = (straight, str(d / RST))
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_restart_across_packages(linwave_runs, tmp_path, direction):
    """A linwave checkpoint at cycle 9 written by one package resumes in the
    other to tlim: the writer's straight run's cycle count and time, and
    its u and w within 1e-12 of each array's maximum."""
    src, dst = direction.split("_to_")
    straight, rst = linwave_runs[src]
    sim = port(ARGS, tmp_path, restart=rst) if dst == "port" else \
        JSimulation(DECK, ARGS, str(tmp_path), restart=rst)
    assert sim.tm.ncycle == 9
    sim.run()
    assert sim.tm.ncycle == straight.tm.ncycle
    assert abs(sim.tm.time - straight.tm.time) <= 1e-14
    assert rel_err(gas(sim), gas(straight)) <= 1e-12


def test_hdf5_dumps_match_jax(linwave_runs):
    """The port's field dumps, read by analysis/adump.py, against the JAX
    package's dumps of the same run: the same files, times, coordinates and
    primitive fields within 1e-12 of each field's maximum; the final dump
    equal to the port's end state."""
    sys.path.insert(0, os.path.join(REPO, "analysis"))
    from adump import adump

    dirs = {name: sim.data_dir for name, (sim, _) in linwave_runs.items()}
    files = {name: sorted(os.path.basename(f) for f in glob.glob(os.path.join(d, "*.out2.*npz")))
             for name, d in dirs.items()}
    assert files["port"] == files["jax"] and "linear_wave.out2.final.npz" in files["port"]
    for f in files["port"]:
        t, j = (adump(os.path.join(dirs[n], f)) for n in ("port", "jax"))
        assert abs(t.time - j.time) <= 1e-14 and t.coords == j.coords and t.nx == j.nx
        assert sorted(t.keys()) == sorted(j.keys())
        for x in ("x1f", "x2f", "x3f", "x1v", "x2v", "x3v"):
            np.testing.assert_array_equal(getattr(t, x), getattr(j, x))
        for k in t.keys():
            a, b = t.Get(k), j.Get(k)
            assert float(np.abs(a - b).max()) <= 1e-12 * max(float(np.abs(b).max()), 1e-300)
    final = adump(os.path.join(dirs["port"], "linear_wave.out2.final.npz"))
    w = gas(linwave_runs["port"][0])["w"]
    np.testing.assert_array_equal(final.Get("gas.prim.density")[0], w[0, 0])


def test_dtden_payload_loads_in_both_packages(tmp_path):
    """A state carrying the fused stages' CFL maxima writes them as
    payload.dtden (no gas.dtden); the port reads them back into gas.dtden
    and takes its first resumed dt from them, and the JAX package resumes
    the same checkpoint."""
    s = port(ARGS + ["parthenon/time/nlim=4"], tmp_path)
    s.run()
    dtden = torch.full((3,), 2.0 * s.gas_cfg.cfl / s.tm.dt, dtype=torch.float64)
    s.state["gas"]["dtden"] = dtden
    path = s.write_restart(str(tmp_path / "ck"))
    with np.load(path) as f:
        assert "payload.dtden" in f.files and "gas.dtden" not in f.files
    arrays, _, payloads = load_restart(path)
    assert "dtden" not in payloads
    np.testing.assert_array_equal(arrays["gas"]["dtden"], dtden.numpy())
    jarrays, _, _ = j_load_restart(path)
    assert sorted(jarrays["gas"]) == ["u", "w"]
    r = port(ARGS + ["parthenon/time/nlim=5"], tmp_path, restart=path)
    assert torch.equal(r.state["gas"]["dtden"], dtden)
    assert r.driver.estimate_dt(r.state) == pytest.approx(0.5 * s.tm.dt, rel=1e-15)
    r.run()
    j = JSimulation(DECK, ARGS + ["parthenon/time/nlim=5"], str(tmp_path), restart=path)
    j.run()
    assert j.tm.ncycle == r.tm.ncycle == 5


def test_static_tree_restart_bitwise(tmp_path):
    """disk_rhd_amr.in at a 32x32x8 root (its 32x32x8 patch, gray FLD on
    both levels): 4 cycles straight, and 2 + checkpoint + 2 with the fine
    level from the amr.* payloads, end bitwise equal, every node's gas and
    Er; the payloads are the JAX package's keys."""
    small = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8"]
    rst = ["parthenon/output9/file_type=rst", "parthenon/output9/dt=100.0"]
    s1 = Simulation(RHD, small + ["parthenon/time/nlim=4"], str(tmp_path / "a"), device="cpu")
    s1.run()
    d = tmp_path / "b"
    Simulation(RHD, small + rst + ["parthenon/time/nlim=2"], str(d), device="cpu").run()
    path = str(d / "disk_rhd_amr.out9.final.rst.npz")
    _, _, payloads = load_restart(path)
    assert sorted(payloads) == ["amr.n1.gas.u", "amr.n1.gas.w", "amr.n1.lo", "amr.n1.rad.Er"]
    s3 = Simulation(RHD, small + ["parthenon/time/nlim=4"], str(d), device="cpu", restart=path)
    s3.run()
    assert (s3.tm.ncycle, s3.tm.time, s3.tm.dt) == (s1.tm.ncycle, s1.tm.time, s1.tm.dt)
    for a, b in zip(tree_to_numpy(s3.driver._states), tree_to_numpy(s1.driver._states)):
        for fl, kind in (("gas", "u"), ("gas", "w"), ("rad", "Er")):
            np.testing.assert_array_equal(a[fl][kind], b[fl][kind])
    with pytest.raises(ValueError, match="float64"):
        Simulation(RHD, small + ["artemis/precision=float32"], str(d), device="cpu",
                   restart=path)


def test_cli_walltime_checkpoint_and_restart(tmp_path, capsys):
    """-t with a tiny walltime stops after the first cycle with exit code 2
    and leaves {problem_id}.walltime.final.rst.npz; -r on it runs to nlim
    and exits 0."""
    small = ["parthenon/mesh/nx1=8", "parthenon/mesh/nx2=4", "parthenon/mesh/nx3=4",
             "parthenon/time/nlim=4"]
    base = ["-i", DECK, "-d", str(tmp_path), "--device", "cpu"]
    assert cli.main(base + ["-t", "1e-9"] + small) == 2
    ck = tmp_path / "linear_wave.walltime.final.rst.npz"
    assert ck.exists()
    with np.load(ck) as f:
        assert 0 < json.loads(str(f["__meta__"]))["ncycle"] < 4
    assert cli.main(base + ["-r", str(ck)] + small) == 0
    out = capsys.readouterr().out
    assert "ncycle=4" in out and "complete" in out
